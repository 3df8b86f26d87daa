"""Latent-noise sampling: the device-side ±offset normal mixture
(``srgan_tpu.utils.mixture.sample_offset_normal``)."""

from __future__ import annotations

import torch


def sample_offset_normal(generator: torch.Generator, shape, mean_offset: float,
                         dtype=torch.float32) -> torch.Tensor:
    """z ~ equal mixture of N(−offset·1, I) and N(+offset·1, I), per example.

    Drawn on the generator's device. Offset 0 reduces exactly to N(0, I);
    the component choice is per example (axis 0).
    """
    device = generator.device
    z = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    if mean_offset == 0.0:
        return z
    sign_shape = (shape[0],) + (1,) * (len(shape) - 1)
    sign = torch.randint(0, 2, sign_shape, generator=generator,
                         device=device).to(dtype) * 2 - 1
    return z + sign * mean_offset
