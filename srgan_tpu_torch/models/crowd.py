"""Crowd-counting models: the two-head JointCNN and the patch generator.

The port of ``srgan_tpu.models.crowd`` (``JointCNN`` and
``CrowdDCGenerator``). ``JointDCNN`` and ``SpatialPyramidCNN`` are not
ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from srgan_tpu_torch.models.dcgan import (Conv, DCGANGenerator, group_norm,
                                          norm_act)


def _conv_stage(x: torch.Tensor, conv: Conv, norm: nn.Module | None
                ) -> torch.Tensor:
    """One crowd-model stage: 3×3 conv [+ GroupNorm] + LeakyReLU(0.2)."""
    x = conv(x)
    if norm is not None:
        return norm_act(x, norm, negative_slope=0.2)
    return F.leaky_relu(x, 0.2)


def _joint_heads(head_input: torch.Tensor, trunk: torch.Tensor,
                 density_head: Conv, count_head: Conv
                 ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The two 1×1-conv heads (density map, count map) and the globally
    pooled trunk features, all float32."""
    density = density_head(head_input).squeeze(1)
    count = count_head(head_input).squeeze(1)
    features = trunk.mean(dim=(2, 3))
    return (density.float(), count.float()), features.float()


class JointCNN(nn.Module):
    """Patch → (density map, count map) + features.

    Input: [B, 3, P, P] float32. The heads emit maps at 1/4 resolution;
    ``features`` is the globally pooled [B, 4w] trunk.

    ``zero_init_heads`` zero-initializes the head kernels and sets their
    biases to the given per-cell targets, so that the step-0 prediction
    is the dataset-mean map and count. ``norm_impl`` picks the norm layers
    (``models.dcgan.group_norm``).
    """

    def __init__(self, base_width: int = 64, *,
                 dtype: torch.dtype = torch.float32, norm_impl: str = "xla",
                 use_norm: bool = True,
                 zero_init_heads: bool = True,
                 density_head_bias: float = 0.0,
                 count_head_bias: float = 0.0, rng: torch.Generator):
        super().__init__()
        w = base_width
        stages = ((3, w, 2), (w, 2 * w, 2), (2 * w, 4 * w, 1),
                  (4 * w, 4 * w, 1))
        self.convs = nn.ModuleList(
            Conv(cin, cout, 3, stride, dtype=dtype, rng=rng)
            for cin, cout, stride in stages)
        self.norms = nn.ModuleList(
            group_norm(cout, dtype, norm_impl) for _, cout, _ in stages
        ) if use_norm else None
        self.density_head = Conv(4 * w, 1, 1, dtype=dtype, rng=rng,
                                 zero_init=zero_init_heads,
                                 bias_value=density_head_bias)
        self.count_head = Conv(4 * w, 1, 1, dtype=dtype, rng=rng,
                               zero_init=zero_init_heads,
                               bias_value=count_head_bias)

    def forward(self, patches: torch.Tensor
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        x = patches
        for i, conv in enumerate(self.convs):
            x = _conv_stage(x, conv,
                            self.norms[i] if self.norms is not None
                            else None)
        return _joint_heads(x, x, self.density_head, self.count_head)


class CrowdDCGenerator(DCGANGenerator):
    """DCGAN generator emitting crowd image patches (3 channels)."""
