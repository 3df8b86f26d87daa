"""Rounding to a lower precision, for the control of the comparison.

The control is the reference computed one precision below what the
configuration states, in its matrix products as a lower-precision
training path computes them: for a bfloat16 configuration fp8 with one
scale per tensor, e4m3 for the operands of the forward product (every
input of a convolution or a dense layer, and its weight) and e5m2 for
the gradient that flows back into the product; TF32 for a float32 one,
the operands alone. The sums stay float32, as the tensor cores keep
them; what lies between the products (norms, activations, losses) is the
reference's float32.

Each rounding is the identity to autograd on the way that it does not
round (a straight-through estimator), so that the penalty's double
backward runs through both.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round_tf32(x: Tensor) -> Tensor:
    """float32 with its mantissa rounded to TF32's 10 bits (to nearest,
    ties away from zero, as the card's conversion does)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32).view_as(x)


def _fp8(dtype) -> Callable[[Tensor], Tensor]:
    """Rounding to ``dtype`` with one scale for the whole tensor, its
    largest value mapped to the largest finite value of the format."""
    def rounded(x: Tensor) -> Tensor:
        scale = FP8_MAX[dtype] / x.abs().max().clamp_min(1e-30)
        return (x * scale).to(dtype).to(torch.float32) / scale
    return rounded


def _straight_through(rounder: Callable, x: Tensor) -> Tensor:
    x = x.float()
    return x + (rounder(x.detach()) - x).detach()


class _RoundGradient(torch.autograd.Function):
    """The identity forward; backward, the incoming gradient rounded
    (itself differentiable as the identity, for the double backward)."""

    @staticmethod
    def forward(ctx, x, rounder):
        ctx.rounder = rounder
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _straight_through(ctx.rounder, grad), None


class Rounding:
    """``q(x)`` rounds an operand of a product; ``q.out(y)`` rounds the
    gradient that flows back into the product's output ``y``."""

    def __init__(self, operand: Optional[Callable] = None,
                 gradient: Optional[Callable] = None):
        self.operand = operand
        self.gradient = gradient

    def __call__(self, x: Tensor) -> Tensor:
        return x if self.operand is None else _straight_through(
            self.operand, x)

    def out(self, y: Tensor) -> Tensor:
        return y if self.gradient is None else _RoundGradient.apply(
            y, self.gradient)


EXACT = Rounding()

_ROUNDINGS = {
    "float32": EXACT,
    "tf32": Rounding(_round_tf32),
    "fp8": Rounding(_fp8(torch.float8_e4m3fn), _fp8(torch.float8_e5m2)),
}


def quantizer(precision: str) -> Rounding:
    """The rounding of ``precision`` ("float32": none, "tf32", "fp8")."""
    try:
        return _ROUNDINGS[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}; choose from "
                         f"{sorted(_ROUNDINGS)}") from None


# The precision below each one a configuration may state.
CONTROL_PRECISION = {"bfloat16": "fp8", "float32": "tf32"}
