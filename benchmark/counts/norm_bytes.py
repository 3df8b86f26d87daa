"""The bytes that the fused norm of one step must move through device
memory.

A configuration's ``norm_shapes`` lists every GroupNorm of its step as
(B, H·W, C, forward launches, backward launches): each forward reads x
and writes y, each backward reads x and dy and writes dx, once each, in
the compute dtype. The per-example statistics, scales and biases are
thousands of times smaller and are left out. The flagship's shapes and
launch counts are those ``chip_smoke.py`` keeps (``NORM_SHAPES``,
30 forward and 25 backward launches a step).
"""

from __future__ import annotations

from typing import Iterable, Sequence


def step_bytes(shapes: Iterable[Sequence[int]], itemsize: int) -> int:
    total = 0
    for b, hw, c, forward, backward in shapes:
        elements = b * hw * c
        total += elements * itemsize * (2 * forward + 3 * backward)
    return total


def launches(shapes: Iterable[Sequence[int]]) -> tuple:
    """(forward, backward) launches a step."""
    shapes = list(shapes)
    return (sum(s[3] for s in shapes), sum(s[4] for s in shapes))
