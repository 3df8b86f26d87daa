"""The crowd patch sampler, plainly: gather, crop, flip, normalize.

Each example takes image ``indices[b]``, the P×P window whose top-left
corner is ``offsets[b]`` (y, x), mirrored left to right where
``flips[b]`` is set; images are uint8 and map to [-1, 1] as
``x · 2/255 − 1``, label maps are cropped as they are.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def crop(source: Tensor, indices: Tensor, offsets: Tensor, flips: Tensor,
         patch: int) -> Tensor:
    """[N, H, W, ...] → [B, P, P, ...], one window per example."""
    out = []
    for i, (y, x), f in zip(indices.tolist(), offsets.tolist(),
                            flips.tolist()):
        window = source[i, y:y + patch, x:x + patch]
        out.append(window.flip(1) if f else window)
    return torch.stack(out)


def image_patches(images: Tensor, indices: Tensor, offsets: Tensor,
                  flips: Tensor, patch: int) -> Tensor:
    """uint8 images [N, H, W, 3] → float32 patches [B, 3, P, P]."""
    pixels = crop(images, indices, offsets, flips, patch).float()
    return (pixels * (2.0 / 255.0) - 1.0).permute(0, 3, 1, 2)


def label_patches(density: Tensor, indices: Tensor, offsets: Tensor,
                  flips: Tensor, patch: int) -> Tensor:
    """Density maps [N, H, W] → [B, P, P] float32."""
    return crop(density, indices, offsets, flips, patch).float()
