"""The benchmark's plain reference of the SR-GAN step, in float32.

Plain PyTorch written from the published description of the models and
the loss stack (SURVEY.md), frozen beside the benchmark: the layers
(``layers``), the models (``models``), the patch sampler (``sampler``)
and the fused D + G + DNN step with the gradient penalty's double
backward and Adam (``step``). It imports nothing of the program: the
benchmark hands it the same weights and inputs it hands the program, and
it works out every result again. ``quant`` holds the lower precisions of
the control.
"""
