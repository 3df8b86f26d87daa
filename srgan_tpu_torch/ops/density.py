"""Gaussian density maps from padded head lists.

The port of ``srgan_tpu.ops.density``: for each image, the sum over its
valid heads of a unit-mass Gaussian ``exp(−r²/2σ²)`` on the H×W canvas, so
that each map integrates to its head count even where a splat is clipped
by the border. Two functions:

* :func:`density_maps`, the wrapper. On a CUDA tensor it launches the
  hand-written kernel of ``csrc/density.cu`` (built at first use) or
  raises; on a CPU tensor, and only there, it runs the plain version.
  Every launch adds one to ``density_maps.launches``;
* :func:`density_maps_plain`, the same function in plain PyTorch on any
  device: a loop over chunks of head slots, vectorised over the canvas.
  The CPU tests use it; ``chip_smoke.py`` holds the kernel against it.

Both divide each splat by ``max(Σg, 1e-12)``, as the JAX package's
kernel does. Its NumPy reference (``data/crowd.py``
``density_maps_reference``) instead skips a head whose mass is ≤ 1e-12,
so a head far enough outside the canvas that its mass there falls below
1e-12 (about 16 px at σ = 2) adds up to 1 of mass here and 0 there. Slots ``j ≥ count`` never contribute, whatever they hold.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from srgan_tpu_torch.ops import _build

# Elements of one [B, J, H, W] temporary of the plain version.
_PLAIN_ELEMENTS = 1 << 25


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = _build.load_library("density")
    fn = lib.srgan_density_maps
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.srgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.srgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _inv_two_sigma_sq(sigma: float) -> float:
    """``0.5 / σ²`` in float32, as the JAX kernel computes it."""
    s = np.float32(sigma)
    return float(np.float32(0.5) / (s * s))


def density_maps(head_positions: torch.Tensor, head_counts: torch.Tensor,
                 sigma: float, *, height: int, width: int) -> torch.Tensor:
    """Render a batch of Gaussian density maps.

    Args:
      head_positions: [B, N, 2] float32 (y, x) padded head coordinates,
        contiguous.
      head_counts: [B] int32 number of valid heads per image (clamped to
        [0, N]).
      sigma: Gaussian standard deviation in pixels.
      height, width: the output map size.

    Returns: [B, H, W] float32 on the device of ``head_positions``; each
    map sums to its head count.
    """
    if head_positions.device.type == "cpu":
        return density_maps_plain(head_positions, head_counts, sigma,
                                  height=height, width=width)
    device = head_positions.device
    if device.type != "cuda":
        raise ValueError(f"density_maps runs on CUDA or CPU tensors, got "
                         f"{device}")
    if (head_positions.dtype != torch.float32 or head_positions.dim() != 3
            or head_positions.shape[2] != 2
            or not head_positions.is_contiguous()):
        raise ValueError(f"head_positions must be a contiguous float32 "
                         f"[B, N, 2] tensor, got {head_positions.dtype} "
                         f"{list(head_positions.shape)}")
    b, n, _ = head_positions.shape
    if (head_counts.device != device or head_counts.dtype != torch.int32
            or tuple(head_counts.shape) != (b,)
            or not head_counts.is_contiguous()):
        raise ValueError(f"head_counts must be a contiguous int32 [{b}] "
                         f"tensor on {device}, got {head_counts.dtype} "
                         f"{list(head_counts.shape)} on {head_counts.device}")
    h, w = int(height), int(width)
    if h < 1 or w < 1:
        raise ValueError(f"map size must be positive, got {h}x{w}")
    out = torch.empty((b, h, w), dtype=torch.float32, device=device)
    weights = torch.empty((b, n), dtype=torch.float32, device=device)
    lib = _library()
    code = lib.srgan_density_maps(
        head_positions.data_ptr(), head_counts.data_ptr(),
        weights.data_ptr(), out.data_ptr(), b, n, h, w,
        _inv_two_sigma_sq(sigma), torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"density kernel launch failed: "
                           f"{lib.srgan_cuda_error_string(code).decode()}")
    density_maps.launches += 1
    return out


density_maps.launches = 0


def density_maps_plain(head_positions: torch.Tensor,
                       head_counts: torch.Tensor, sigma: float, *,
                       height: int, width: int) -> torch.Tensor:
    """The same function in plain PyTorch, on any device: per chunk of
    head slots, every splat on the whole canvas, divided by
    ``max(Σg, 1e-12)``, masked to the valid slots and summed."""
    device = head_positions.device
    heads = head_positions.to(torch.float32)
    b, n, _ = heads.shape
    counts = head_counts.to(device=device, dtype=torch.long).clamp(0, n)
    k = _inv_two_sigma_sq(sigma)
    yy = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)
    out = torch.zeros((b, height, width), dtype=torch.float32, device=device)
    chunk = max(1, _PLAIN_ELEMENTS // max(1, b * height * width))
    last = int(counts.max()) if b else 0
    for j0 in range(0, last, chunk):
        hy = heads[:, j0:j0 + chunk, 0, None, None]          # [B, J, 1, 1]
        hx = heads[:, j0:j0 + chunk, 1, None, None]
        g = torch.exp(-((yy - hy) ** 2 + (xx - hx) ** 2) * k)  # [B, J, H, W]
        g = g / g.sum(dim=(2, 3), keepdim=True).clamp_min(1e-12)
        slots = torch.arange(j0, j0 + g.shape[1], device=device)
        valid = (slots < counts[:, None])[..., None, None]
        out += torch.where(valid, g, 0.0).sum(dim=1)
    return out
