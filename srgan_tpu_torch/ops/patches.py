"""Random patch extraction + normalization for crowd training batches.

The port of ``srgan_tpu.ops.patches.extract_patches``: for each output
example, gather image ``indices[i]`` from the device-resident dataset,
cut the P×P window at ``offsets[i]``, flip it horizontally where
``flips[i]``, cast to float32 and apply ``x * scale + shift``.

* :func:`extract_patches` — the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/patches.cu`` (built at first use) or raises;
  on a CPU tensor, and only there, it runs the plain version.
* :func:`extract_patches_plain` — the same function in plain PyTorch, on
  any device. The CPU tests use it; ``chip_smoke.py`` holds the kernel
  against it on the card.
* :func:`extract_patches_reference` — the NumPy golden model.

The output keeps the JAX package's [B, P, P, C] layout. Its
``.permute(0, 3, 1, 2)`` is an NCHW tensor in ``channels_last`` memory
format, which the models take without a copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from srgan_tpu_torch.ops import _build

_DTYPE_CODES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load_library("patches")
    fn = lib.srgan_extract_patches
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.srgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.srgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def extract_patches(images: torch.Tensor, offsets: torch.Tensor,
                    flips: torch.Tensor, *, patch_size: int,
                    scale: float = 1.0, shift: float = 0.0,
                    indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Extract per-example patches with flip + affine normalization.

    Args:
      images:  [N, H, W, C] uint8, float32 or bfloat16, contiguous: the
        whole resident dataset when ``indices`` is given.
      offsets: [B, 2] int32 top-left (y, x); the caller guarantees that
        every window lies inside its image.
      flips:   [B] int32 horizontal-flip flags.
      patch_size: the patch side P.
      scale, shift: ``out = x * scale + shift``.
      indices: optional [B] int32 source image per example; defaults to
        ``arange(N)`` (B == N).

    Returns: [B, P, P, C] float32 on the device of ``images``.

    Every launch of the CUDA kernel adds one to ``extract_patches.launches``.
    """
    if images.device.type == "cpu":
        return extract_patches_plain(images, offsets, flips,
                                     patch_size=patch_size, scale=scale,
                                     shift=shift, indices=indices)
    if images.device.type != "cuda":
        raise ValueError(f"extract_patches runs on CUDA or CPU tensors, "
                         f"got {images.device}")
    if images.dtype not in _DTYPE_CODES:
        raise TypeError(f"images dtype {images.dtype} is not one of "
                        f"{sorted(map(str, _DTYPE_CODES))}")
    if images.dim() != 4 or not images.is_contiguous():
        raise ValueError(f"images must be a contiguous [N, H, W, C] tensor, "
                         f"got shape {tuple(images.shape)}")
    n, h, w, c = images.shape
    p = int(patch_size)
    if not 0 < p <= min(h, w):
        raise ValueError(f"patch_size {p} does not fit {h}x{w} images")
    if indices is None:
        indices = torch.arange(n, dtype=torch.int32, device=images.device)
    b = indices.shape[0]
    for name, t, shape in (("indices", indices, (b,)),
                           ("offsets", offsets, (b, 2)),
                           ("flips", flips, (b,))):
        if (t.device != images.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous int32 {list(shape)} tensor on "
                f"{images.device}, got {t.dtype} {list(t.shape)} on "
                f"{t.device}")
    out = torch.empty((b, p, p, c), dtype=torch.float32, device=images.device)
    lib = _library()
    stream = torch.cuda.current_stream(images.device).cuda_stream
    code = lib.srgan_extract_patches(
        images.data_ptr(), indices.data_ptr(), offsets.data_ptr(),
        flips.data_ptr(), out.data_ptr(), _DTYPE_CODES[images.dtype],
        b, h, w, c, p, scale, shift, stream)
    if code != 0:
        raise RuntimeError(f"patches kernel launch failed: "
                           f"{lib.srgan_cuda_error_string(code).decode()}")
    extract_patches.launches += 1
    return out


extract_patches.launches = 0


def extract_patches_plain(images: torch.Tensor, offsets: torch.Tensor,
                          flips: torch.Tensor, *, patch_size: int,
                          scale: float = 1.0, shift: float = 0.0,
                          indices: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The same function in plain PyTorch (advanced indexing), on any
    device. Raises on a window outside its image."""
    n, h, w, _ = images.shape
    p = int(patch_size)
    device = images.device
    if indices is None:
        indices = torch.arange(n, device=device)
    idx = indices.to(device=device, dtype=torch.long)
    oy = offsets[:, 0].to(device=device, dtype=torch.long)
    ox = offsets[:, 1].to(device=device, dtype=torch.long)
    if bool(((idx < 0) | (idx >= n) | (oy < 0) | (oy > h - p)
             | (ox < 0) | (ox > w - p)).any()):
        raise ValueError(f"patch window out of bounds for {n} images of "
                         f"{h}x{w} at patch size {p}")
    ar = torch.arange(p, device=device)
    flip = flips.to(device=device).reshape(-1, 1) != 0
    rows = oy[:, None] + ar                                  # [B, P]
    cols = ox[:, None] + torch.where(flip, p - 1 - ar, ar)   # [B, P]
    patch = images[idx[:, None, None], rows[:, :, None], cols[:, None, :]]
    return patch.float() * scale + shift


def extract_patches_reference(images: np.ndarray, offsets: np.ndarray,
                              flips: np.ndarray, patch_size: int,
                              scale: float = 1.0, shift: float = 0.0,
                              indices: np.ndarray | None = None
                              ) -> np.ndarray:
    """NumPy golden model (``srgan_tpu.ops.patches`` keeps the same)."""
    if indices is None:
        indices = np.arange(images.shape[0])
    b = len(indices)
    p = patch_size
    out = np.empty((b, p, p, images.shape[3]), np.float32)
    for i in range(b):
        oy, ox = int(offsets[i, 0]), int(offsets[i, 1])
        patch = images[int(indices[i]),
                       oy:oy + p, ox:ox + p].astype(np.float32)
        if flips[i]:
            patch = patch[:, ::-1]
        out[i] = patch * scale + shift
    return out
