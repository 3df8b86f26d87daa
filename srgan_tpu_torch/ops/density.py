"""Gaussian density maps from padded head lists.

The port of ``srgan_tpu.ops.density``: for each image, the sum over its
valid heads of a unit-mass Gaussian ``exp(−r²/2σ²)`` on the H×W canvas, so
that each map integrates to its head count even where a splat is clipped
by the border. Two functions:

* :func:`density_maps`, the wrapper. On a CUDA tensor it launches the
  hand-written kernel of ``csrc/density.cu`` (built at first use) on the
  launch plan of :func:`density_plan`, or raises; on a CPU tensor, and
  only there, it runs the plain version. Every launch adds one to
  ``density_maps.launches``;
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
import math
from typing import NamedTuple

import numpy as np
import torch

from srgan_tpu_torch.ops import _build

# Elements of one [B, J, H, W] temporary of the plain version.
_PLAIN_ELEMENTS = 1 << 25
# 150 ln 2: float32 exp(-x) rounds to 0 for x above it (2^-150 is half the
# least subnormal). The same double literal as csrc/density.cu.
ZERO_EXPONENT = 103.97207708399179
# The render kernel's tile side (csrc/density.cu kTile).
TILE = 64
# A plan cuts each map's valid slots into runs, one block per tile and
# run, until the launch has _PLAN_MIN_BLOCKS blocks (the H100's 132 SMs
# hold 528 of 256 threads) and no run has more than _PLAN_RUN_MAX slots;
# but keeps at least _PLAN_RUN_MIN slots a run, at most _PLAN_MAX_BLOCKS
# blocks (each run writes a partial map) and at most the kernel's 64 runs.
# Chosen by tools/density_sweep.py on an H100 (PERF.md).
_PLAN_MIN_BLOCKS = 384
_PLAN_MAX_BLOCKS = 4096
_PLAN_RUN_MIN = 256
_PLAN_RUN_MAX = 1536
_MAX_SPLITS = 64


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = _build.load_library("density")
    fn = lib.srgan_density_maps
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.srgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.srgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _inv_two_sigma_sq(sigma: float) -> float:
    """``0.5 / σ²`` in float32, as the JAX kernel computes it."""
    s = np.float32(sigma)
    return float(np.float32(0.5) / (s * s))


def cull_radius(sigma: float) -> int:
    """R, the least integer with k·R² > 150·ln 2 for k = ``0.5 / σ²`` in
    float32: a (pixel, head) pair more than R pixels apart along y or x
    has a float32 term of exactly 0. R = 116 at σ = 8, 29 at σ = 2."""
    with np.errstate(divide="ignore", over="ignore"):
        k = _inv_two_sigma_sq(sigma)
    if not (math.isfinite(k) and k > 0):
        raise ValueError(f"sigma must be positive and finite, got {sigma}")
    r = max(1, math.isqrt(int(ZERO_EXPONENT / k)))
    while k * r * r <= ZERO_EXPONENT:
        r += 1
    while r > 1 and k * (r - 1) * (r - 1) > ZERO_EXPONENT:
        r -= 1
    if r >= 1 << 24:
        raise ValueError(f"sigma {sigma} is too wide for the kernel's cull "
                         f"radius")
    return r


class DensityPlan(NamedTuple):
    """How the render kernel cuts the maps: a block of 256 threads per
    :data:`TILE` × :data:`TILE` tile of one map (a 4×4 micro-tile of
    pixels a thread) and per one of ``splits`` runs of its valid slots,
    heads culled at ``radius`` pixels along y or x."""
    radius: int
    splits: int


@functools.lru_cache(maxsize=None)
def density_plan(height: int, width: int, sigma: float, batch: int,
                 slots: int) -> DensityPlan:
    """The render kernel's launch plan for ``batch`` maps of
    ``height``×``width`` at ``sigma`` from ``slots`` head slots each:
    :func:`cull_radius`, and the runs of slots that the constants above
    give. Raises ValueError on what the kernel does not take. A pure
    function of its arguments."""
    if height < 1 or width < 1:
        raise ValueError(f"map size must be positive, got {height}x{width}")
    if not 0 <= batch <= 65535:
        raise ValueError(f"the density kernel takes at most 65535 maps, "
                         f"got {batch}")
    radius = cull_radius(sigma)
    blocks = max(1, batch * -(-height // TILE) * -(-width // TILE))
    want = max(-(-_PLAN_MIN_BLOCKS // blocks), -(-slots // _PLAN_RUN_MAX))
    cap = min(slots // _PLAN_RUN_MIN, _PLAN_MAX_BLOCKS // blocks, _MAX_SPLITS)
    return DensityPlan(radius, max(1, min(want, cap)))


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
    plan = density_plan(h, w, float(sigma), b, n)
    return _launch_density(head_positions, head_counts, sigma, h, w, plan)


density_maps.launches = 0


def _launch_density(head_positions: torch.Tensor, head_counts: torch.Tensor,
                    sigma: float, h: int, w: int, plan: DensityPlan
                    ) -> torch.Tensor:
    """The kernel on checked arguments at ``plan``."""
    b, n, _ = head_positions.shape
    device = head_positions.device
    out = torch.empty((b, h, w), dtype=torch.float32, device=device)
    weights = torch.empty((b, n), dtype=torch.float32, device=device)
    partial = (torch.empty((plan.splits, b, h, w), dtype=torch.float32,
                           device=device) if plan.splits > 1 else out)
    lib = _library()
    code = lib.srgan_density_maps(
        head_positions.data_ptr(), head_counts.data_ptr(),
        weights.data_ptr(), partial.data_ptr(), out.data_ptr(), b, n, h, w,
        _inv_two_sigma_sq(sigma), *plan,
        torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"density kernel launch failed: "
                           f"{lib.srgan_cuda_error_string(code).decode()}")
    density_maps.launches += 1
    return out


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
