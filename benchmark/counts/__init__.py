"""The work a step needs, counted from its shapes: the floating-point
operations of the step (``flops``) and the bytes the fused norm must move
(``norm_bytes``), with the card's published peaks (``peaks``).
"""
