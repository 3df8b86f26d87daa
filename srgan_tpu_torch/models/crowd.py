"""Crowd-counting models: the two-head crowd networks and the patch
generator.

The port of ``srgan_tpu.models.crowd``: ``JointCNN``, ``JointDCNN``,
``SpatialPyramidCNN``, ``CROWD_MODELS`` and ``CrowdDCGenerator``; and
``CSRNet``, which the JAX package does not have. Every crowd network maps
an image patch to a (density map, count map) pair at 1/``OUTPUT_STRIDE``
resolution (4 for the JointCNN family, 8 for CSRNet) and globally pooled
trunk features.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from srgan_tpu_torch.models.dcgan import (Conv, DCGANGenerator,
                                          gather_channels, group_norm,
                                          norm_act)


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

    Input: [B, 3, P, P] float32. The trunk's 3×3 conv stages (each
    [+ GroupNorm] + LeakyReLU(0.2)) take widths ``w, 2w`` at stride 2,
    then ``TRUNK`` at stride 1, in multiples of the base width; the heads
    emit maps at 1/4 resolution, and ``features`` is the globally pooled
    trunk.

    ``zero_init_heads`` zero-initializes the head kernels and sets their
    biases to the given per-cell targets, so that the step-0 prediction
    is the dataset-mean map and count. ``norm_impl`` picks the norm layers
    (``models.dcgan.group_norm``).
    """

    TRUNK: Tuple[int, ...] = (4, 4)
    OUTPUT_STRIDE = 4  # the heads' maps are 1/4 of the patch's side
    TENSOR_PARALLEL = True  # parallel/tp.py shards its layers

    def __init__(self, base_width: int = 64, *,
                 dtype: torch.dtype = torch.float32, norm_impl: str = "xla",
                 use_norm: bool = True,
                 zero_init_heads: bool = True,
                 density_head_bias: float = 0.0,
                 count_head_bias: float = 0.0, rng: torch.Generator):
        super().__init__()
        w = base_width
        widths = [w, 2 * w] + [m * w for m in self.TRUNK]
        self.trunk_width = widths[-1]
        strides = [2, 2] + [1] * len(self.TRUNK)
        self.convs = nn.ModuleList(
            Conv(cin, cout, 3, stride, dtype=dtype, rng=rng)
            for cin, cout, stride in zip([3] + widths, widths, strides))
        self.norms = nn.ModuleList(
            group_norm(cout, dtype, norm_impl) for cout in widths
        ) if use_norm else None
        heads_in = self._make_context(widths[-1], dtype=dtype, rng=rng)
        self.density_head = Conv(heads_in, 1, 1, dtype=dtype, rng=rng,
                                 zero_init=zero_init_heads,
                                 bias_value=density_head_bias)
        self.count_head = Conv(heads_in, 1, 1, dtype=dtype, rng=rng,
                               zero_init=zero_init_heads,
                               bias_value=count_head_bias)

    def _make_context(self, channels: int, *, dtype: torch.dtype,
                      rng: torch.Generator) -> int:
        """Make the layers between the trunk of ``channels`` channels and
        the heads (none here); returns the heads' input channels."""
        return channels

    def context(self, trunk: torch.Tensor) -> torch.Tensor:
        """The heads' input from the trunk (the trunk itself here)."""
        return trunk

    def forward(self, patches: torch.Tensor
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        x = patches
        for i, conv in enumerate(self.convs):
            x = conv(x)
            x = (norm_act(x, self.norms[i], negative_slope=0.2)
                 if self.norms is not None else F.leaky_relu(x, 0.2))
        # The heads, the pyramid and the features take all channels.
        x = gather_channels(self, x, self.trunk_width)
        return _joint_heads(self.context(x), x, self.density_head,
                            self.count_head)


class JointDCNN(JointCNN):
    """The deeper two-head network: JointCNN's contract with a trunk of
    ``4w, 4w, 4w, 8w`` at 1/4 resolution."""

    TRUNK = (4, 4, 4, 8)


class SpatialPyramidCNN(JointCNN):
    """JointCNN's trunk and spatial-pyramid context before the heads.

    The trunk is average-pooled at each of ``pyramid_levels`` (a level
    that does not divide the map is skipped), projected to ``c // 3``
    channels by a 1×1 conv without a norm (``pyramid.<level>``), upsampled
    back by nearest repetition and concatenated with the trunk. The
    features stay pooled from the trunk. The skipped levels depend on the
    map, so the model takes the patch size (``image_size``).
    """

    def __init__(self, base_width: int = 64, *, image_size: int,
                 pyramid_levels: Sequence[int] = (1, 2, 4), **kwargs):
        self.pyramid_levels = tuple(pyramid_levels)
        side = image_size
        for _ in range(2):  # the two stride-2 SAME stages
            side = -(-side // 2)
        self.levels = tuple(level for level in self.pyramid_levels
                            if side % level == 0)
        super().__init__(base_width, **kwargs)

    def _make_context(self, channels: int, *, dtype: torch.dtype,
                      rng: torch.Generator) -> int:
        out = channels // len(self.pyramid_levels)
        self.pyramid_width = out
        self.pyramid = nn.ModuleDict(
            {str(level): Conv(channels, out, 1, dtype=dtype, rng=rng)
             for level in self.levels})
        return channels + len(self.levels) * out

    def context(self, trunk: torch.Tensor) -> torch.Tensor:
        h, w = trunk.shape[-2:]
        parts = [trunk]
        for level in self.levels:
            pooled = F.avg_pool2d(trunk, (h // level, w // level))
            proj = gather_channels(self, self.pyramid[str(level)](pooled),
                                   self.pyramid_width)
            parts.append(proj.repeat_interleave(h // level, dim=2)
                         .repeat_interleave(w // level, dim=3))
        return torch.cat(parts, dim=1)


class CSRNet(nn.Module):
    """CSRNet (Li, Zhang and Chen, CVPR 2018, arXiv:1802.10062;
    configuration B), with the port's two-head crowd contract.

    Input: [B, 3, P, P] float32. The frontend is VGG-16's first ten 3×3
    convolutions, ``FRONTEND`` (``"M"``: a 2×2 max-pool of stride 2), the
    backend six 3×3 convolutions of dilation 2, ``BACKEND``; each
    convolution pads ``SAME`` (the published padding 1 and 2 at stride 1)
    and is followed by a ReLU. Widths are the published ones at base
    width 64, scaled by ``base_width / 64``. The density and count heads
    are 1×1 convolutions on the last backend layer, at 1/8 resolution;
    ``features`` is that layer's global mean. The published model has no
    norm: ``norm_impl`` and ``use_norm`` are taken and have no effect.
    ``zero_init_heads`` as :class:`JointCNN`'s.
    """

    FRONTEND: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                       512, 512, 512)
    BACKEND: Tuple[int, ...] = (512, 512, 512, 256, 128, 64)
    OUTPUT_STRIDE = 8
    TENSOR_PARALLEL = False  # not laid out for parallel/tp.py

    def __init__(self, base_width: int = 64, *,
                 dtype: torch.dtype = torch.float32, norm_impl: str = "xla",
                 use_norm: bool = True, zero_init_heads: bool = True,
                 density_head_bias: float = 0.0,
                 count_head_bias: float = 0.0, rng: torch.Generator):
        super().__init__()
        del norm_impl, use_norm  # no norm layers
        width = lambda c: c * base_width // 64  # noqa: E731
        cin, convs, self.pool_after = 3, [], []
        for item in self.FRONTEND:
            if item == "M":
                self.pool_after.append(len(convs) - 1)
                continue
            convs.append(Conv(cin, width(item), 3, dtype=dtype, rng=rng))
            cin = width(item)
        self.frontend = nn.ModuleList(convs)
        backend = []
        for c in self.BACKEND:
            backend.append(Conv(cin, width(c), 3, dtype=dtype, rng=rng,
                                dilation=2))
            cin = width(c)
        self.backend = nn.ModuleList(backend)
        self.density_head = Conv(cin, 1, 1, dtype=dtype, rng=rng,
                                 zero_init=zero_init_heads,
                                 bias_value=density_head_bias)
        self.count_head = Conv(cin, 1, 1, dtype=dtype, rng=rng,
                               zero_init=zero_init_heads,
                               bias_value=count_head_bias)

    def forward(self, patches: torch.Tensor
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        x = patches
        for i, conv in enumerate(self.frontend):
            x = F.relu(conv(x))
            if i in self.pool_after:
                x = F.max_pool2d(x, 2, 2)
        for conv in self.backend:
            x = F.relu(conv(x))
        return _joint_heads(x, x, self.density_head, self.count_head)


CROWD_MODELS = {
    "jointcnn": JointCNN,
    "jointdcnn": JointDCNN,
    "pyramid": SpatialPyramidCNN,
    "csrnet": CSRNet,
}


class CrowdDCGenerator(DCGANGenerator):
    """DCGAN generator emitting crowd image patches (3 channels)."""
