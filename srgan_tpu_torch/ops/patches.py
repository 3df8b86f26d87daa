"""Random patch extraction + normalization for crowd training batches.

The port of ``srgan_tpu.ops.patches``:

* ``extract_patches``: for each output example, gather image
  ``indices[i]`` from the device-resident dataset, cut the P×P window at
  ``offsets[i]``, flip it horizontally where ``flips[i]``, cast to float32
  and apply ``x * scale + shift``.
* ``extract_rescaled_patches``: the same with a per-example source window
  of side ``window_sizes[scale_idx[i]]``, normalized, then resized to P×P
  with JAX's antialiased bilinear weights (:func:`resize_weights`),
  optionally renormalized by ``(window / P)²`` to keep the density mass,
  then flipped.

Each comes in three functions:

* the wrapper (:func:`extract_patches`, :func:`extract_rescaled_patches`).
  On a CUDA tensor it launches its hand-written kernel of
  ``csrc/patches.cu`` (built at first use) on the launch plan of
  :func:`sampler_plan`, or raises; on a CPU tensor, and only there, it runs
  the plain version. Every launch adds one to the wrapper's ``launches``
  (a replay of a captured training chunk adds the launches its capture
  made: ``utils/cuda_graph.py``);
* the same function in plain PyTorch (``*_plain``), on any device. The CPU
  tests use it; ``chip_smoke.py`` holds the kernel against it on the card.
  It synchronizes (a bounds check), so it raises under CUDA graph capture;
* the NumPy golden model (``*_reference``).

The output keeps the JAX package's [B, P, P, C] layout. Its
``.permute(0, 3, 1, 2)`` is an NCHW tensor in ``channels_last`` memory
format, which the models take without a copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from srgan_tpu_torch.ops import _build

_DTYPE_CODES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load_library("patches")
    fn = lib.srgan_extract_patches
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.srgan_extract_rescaled_patches
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.srgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.srgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(name: str, images: torch.Tensor,
                  indices: Optional[torch.Tensor], **per_example
                  ) -> torch.Tensor:
    """Raise on what a kernel of ``csrc/patches.cu`` does not take;
    returns ``indices`` (``arange(N)`` when None)."""
    if images.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{images.device}")
    if images.dtype not in _DTYPE_CODES:
        raise TypeError(f"images dtype {images.dtype} is not one of "
                        f"{sorted(map(str, _DTYPE_CODES))}")
    if images.dim() != 4 or not images.is_contiguous():
        raise ValueError(f"images must be a contiguous [N, H, W, C] tensor, "
                         f"got shape {tuple(images.shape)}")
    if indices is None:
        indices = torch.arange(images.shape[0], dtype=torch.int32,
                               device=images.device)
    b = indices.shape[0]
    for arg, t in (("indices", indices),) + tuple(per_example.items()):
        shape = (b, 2) if arg == "offsets" else (b,)
        if (t.device != images.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{arg} must be a contiguous int32 {list(shape)} tensor on "
                f"{images.device}, got {t.dtype} {list(t.shape)} on "
                f"{t.device}")
    return indices


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
    indices = _check_launch("extract_patches", images, indices,
                            offsets=offsets, flips=flips)
    _, h, w, c = images.shape
    p = int(patch_size)
    plan = sampler_plan(indices.shape[0], h, w, c, p, images.element_size())
    return _launch_patches(images, indices, offsets, flips, p, scale, shift,
                           plan)


extract_patches.launches = 0


def _launch_patches(images: torch.Tensor, indices: torch.Tensor,
                    offsets: torch.Tensor, flips: torch.Tensor, p: int,
                    scale: float, shift: float, plan: SamplerPlan
                    ) -> torch.Tensor:
    """The fixed sampler's kernel on checked arguments at ``plan``."""
    _, h, w, c = images.shape
    b = indices.shape[0]
    out = torch.empty((b, p, p, c), dtype=torch.float32, device=images.device)
    lib = _library()
    stream = torch.cuda.current_stream(images.device).cuda_stream
    code = lib.srgan_extract_patches(
        images.data_ptr(), indices.data_ptr(), offsets.data_ptr(),
        flips.data_ptr(), out.data_ptr(), _DTYPE_CODES[images.dtype],
        b, h, w, c, p, *plan, scale, shift, stream)
    if code != 0:
        raise RuntimeError(f"patches kernel launch failed: "
                           f"{lib.srgan_cuda_error_string(code).decode()}")
    extract_patches.launches += 1
    return out


def _refuse_capture(name: str) -> None:
    """A plain version reads values back to the host; under CUDA graph
    capture that read would fail and end the capture, so it raises here
    first."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name} synchronizes with the card and cannot "
                           f"run under CUDA graph capture")


def extract_patches_plain(images: torch.Tensor, offsets: torch.Tensor,
                          flips: torch.Tensor, *, patch_size: int,
                          scale: float = 1.0, shift: float = 0.0,
                          indices: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The same function in plain PyTorch (advanced indexing), on any
    device. Raises on a window outside its image, and under CUDA graph
    capture."""
    _refuse_capture("extract_patches_plain")
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


# ---------------------------------------------------------------------------
# Random-rescale patches.
# ---------------------------------------------------------------------------

def _xla_column_sum(w: np.ndarray, window: int = 32) -> np.ndarray:
    """Σ over axis 0 in float32, in the order of XLA's CPU reduction: the
    rows, padded evenly on both sides to a multiple of 32, summed in order
    within each run of 32 rows, then the runs' sums in order."""
    if len(w) <= window:
        total = np.zeros(w.shape[1:], np.float32)
        for row in w:
            total = total + row
        return total
    pad = -len(w) % window
    padded = np.pad(w, ((pad // 2, pad - pad // 2), (0, 0)))
    return _xla_column_sum(np.stack(
        [_xla_column_sum(padded[i:i + window])
         for i in range(0, len(padded), window)]), window)


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The [out, in] float32 weights of ``jax.image.resize(...,
    method="bilinear")`` along one axis: the port of
    ``jax._src.image.scale.compute_weight_mat`` with the triangle kernel
    and antialiasing, computed in float32 as JAX computes it (the scale
    ``out/in`` and its inverse in Python floats, every array op in
    float32; the column sum in XLA's CPU order). Equal, bit for bit, to
    the weights JAX's resize applies when run op by op; its compiled CPU
    program contracts some multiply-adds into FMAs, within one float32
    rounding of these. Read-only (cached)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))       # the antialias
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
              - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]
               ) / kernel_scale
    w = np.maximum(f32(0), f32(1) - x)            # [in, out]
    total = _xla_column_sum(w)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    out = np.ascontiguousarray(np.where(inside[None, :], w, f32(0)).T,
                               dtype=f32)
    out.flags.writeable = False
    return out


def _check_windows(window_sizes: Tuple[int, ...], h: int, w: int) -> None:
    if min(window_sizes) < 1:
        raise ValueError(f"window_sizes must be ≥ 1, got {window_sizes}")
    if max(window_sizes) > min(h, w):
        raise ValueError(f"largest rescale window {max(window_sizes)} "
                         f"exceeds image size {h}x{w}")


def _mass_factor(window: int, patch: int) -> float:
    """``(window / P)²`` rounded to float32, as JAX multiplies by it."""
    return float(np.float32((window / patch) ** 2))


@functools.lru_cache(maxsize=None)
def _tap_table(window_sizes: Tuple[int, ...], patch: int
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The kernel's resize taps: per window size s and output coordinate
    o, a first source index ``first[s, o]`` and K weights
    ``weights[s, o, k]`` for sources ``first + k`` (zero past the window),
    K the widest run of nonzero weights (3 for 280 → 224)."""
    mats = [resize_weights(ws, patch) for ws in window_sizes]
    runs = []
    for m in mats:
        nz = m != 0
        lo = np.where(nz.any(1), nz.argmax(1), 0)
        hi = np.where(nz.any(1), m.shape[1] - nz[:, ::-1].argmax(1), 0)
        runs.append((lo, hi))
    taps = max(1, max(int((hi - lo).max()) for lo, hi in runs))
    first = np.zeros((len(mats), patch), np.int32)
    weights = np.zeros((len(mats), patch, taps), np.float32)
    for s, (m, (lo, _)) in enumerate(zip(mats, runs)):
        ws = m.shape[1]
        first[s] = np.clip(lo, 0, max(ws - taps, 0))
        for k in range(taps):
            j = first[s] + k
            ok = j < ws
            weights[s, ok, k] = m[np.arange(patch)[ok], j[ok]]
    return first, weights, taps


@functools.lru_cache(maxsize=None)
def _device_tap_table(window_sizes: Tuple[int, ...], patch: int,
                      device: torch.device):
    """(window sizes, first, weights, mass factors, K) on ``device``,
    built once per (window sizes, P)."""
    first, weights, taps = _tap_table(window_sizes, patch)
    mass = [_mass_factor(ws, patch) for ws in window_sizes]
    return (torch.tensor(window_sizes, dtype=torch.int32, device=device),
            torch.from_numpy(first).to(device),
            torch.from_numpy(weights).to(device),
            torch.tensor(mass, dtype=torch.float32, device=device), taps)


# ---------------------------------------------------------------------------
# The kernels' launch plan.
# ---------------------------------------------------------------------------

# A block of csrc/patches.cu: 128 threads, and at most 227 KB of shared
# memory (the C side checks both again). Its tile: the largest of
# _ROW_CHOICES rows that leaves at least _PLAN_MIN_BLOCKS blocks (16 for
# each of the H100's 132 SMs) and keeps a block within a quarter of the
# shared-memory limit; else one row. At the flagship's calls that is 8
# rows: on the H100, 8 rows of 128 threads measured the fastest of 2 to 16
# rows of 128 to 512 threads for both samplers (PERF.md).
_PLAN_THREADS = 128
_PLAN_SMEM_LIMIT = 232448
_ROW_CHOICES = (16, 8, 4, 2)
_PLAN_MIN_BLOCKS = 16 * 132
_PLAN_SMEM_TARGET = _PLAN_SMEM_LIMIT // 4
# The rescale contracts a tile's rows along y and then x this many at a
# time (kVrowRows in csrc/patches.cu).
_VROW_ROWS = 4


class SamplerPlan(NamedTuple):
    """How a sampler kernel cuts its output: blocks of ``threads`` threads,
    each writing ``tile_rows`` consecutive output rows of one example
    (the last tile of an example may hold fewer) from at most
    ``staged_rows`` source rows held in ``smem_bytes`` of shared memory."""
    tile_rows: int
    threads: int
    staged_rows: int
    smem_bytes: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _row_stride(elems: int, itemsize: int) -> int:
    """Shared-memory bytes of one staged source row (``row_stride`` in
    csrc/patches.cu): the 16-byte vectors over a span that may start
    anywhere within one."""
    return _align16(elems * itemsize + 15)


def tile_source_rows(first: np.ndarray, window: int, taps: int, y0: int,
                     y1: int) -> Tuple[int, int]:
    """The window rows ``[j0, j1]`` that the rescale kernel stages for
    output rows ``y0 .. y1 - 1`` of a window of side ``window`` whose tap
    table row is ``first`` (``_tap_table``): from their least first tap to
    their greatest last tap, inside the window."""
    f = first[y0:y1]
    return int(f.min()), min(int(f.max()) + taps - 1, window - 1)


def _sampler_layout(rows: int, c: int, p: int, itemsize: int,
                   window_sizes: Optional[Tuple[int, ...]] = None
                   ) -> Tuple[int, int]:
    """(staged rows, shared-memory bytes) of a block whose tile is ``rows``
    output rows (the layout of csrc/patches.cu). The fixed sampler stages
    its tile's rows of P·C elements. The rescale sampler holds its scale's
    tap table (P first indices, P·K weights) and up to ``_VROW_ROWS`` of
    its tile's rows contracted along y (float32, at most the widest window
    wide), and stages the source rows its tile reads
    (:func:`tile_source_rows`; a tile of a window of side P, which is
    copied, its own rows): at most the returned count of the widest
    window."""
    if window_sizes is None:
        return rows, rows * _row_stride(p * c, itemsize)
    first, _, taps = _tap_table(window_sizes, p)
    widest = max(window_sizes)
    staged = rows if p in window_sizes else 1
    for s, ws in enumerate(window_sizes):
        if ws == p:
            continue
        for y0 in range(0, p, rows):
            j0, j1 = tile_source_rows(first[s], ws, taps, y0,
                                      min(y0 + rows, p))
            staged = max(staged, j1 - j0 + 1)
    return staged, (_align16(4 * p) + _align16(4 * p * taps)
                    + _align16(4 * min(rows, _VROW_ROWS) * widest * c)
                    + staged * _row_stride(widest * c, itemsize))


@functools.lru_cache(maxsize=None)
def sampler_plan(b: int, h: int, w: int, c: int, p: int, itemsize: int,
                 window_sizes: Optional[Tuple[int, ...]] = None
                 ) -> SamplerPlan:
    """The launch plan of the fixed sampler (``window_sizes`` None) or of
    the rescale sampler over ``window_sizes``, for B examples of P×P from
    [N, H, W, C] sources of ``itemsize`` bytes an element: the rows a
    tile, and what :func:`_sampler_layout` stages for them. Raises
    ValueError, with the wrapper's message, on what the kernels do not
    take. A pure function of its arguments.
    """
    if window_sizes is None:
        if not 0 < p <= min(h, w):
            raise ValueError(f"patch_size {p} does not fit {h}x{w} images")
        what = f"a {p}-wide patch"
    else:
        _check_windows(window_sizes, h, w)
        if p < 1:
            raise ValueError(f"patch_size must be ≥ 1, got {p}")
        what = f"a {max(window_sizes)}-wide window"
    if not 0 <= b <= 65535:
        raise ValueError(f"the patch kernels take at most 65535 examples, "
                         f"got {b}")
    for rows in [r for r in _ROW_CHOICES if r <= p] + [1]:
        staged, smem = _sampler_layout(rows, c, p, itemsize, window_sizes)
        if (rows == 1 or (b * -(-p // rows) >= _PLAN_MIN_BLOCKS
                          and smem <= _PLAN_SMEM_TARGET)):
            break
    if smem > _PLAN_SMEM_LIMIT:
        raise ValueError(f"{what} of {c} channels exceeds the kernel's "
                         f"{_PLAN_SMEM_LIMIT} bytes of shared memory")
    return SamplerPlan(rows, _PLAN_THREADS, staged, smem)


def extract_rescaled_patches(images: torch.Tensor, offsets: torch.Tensor,
                             flips: torch.Tensor, scale_idx: torch.Tensor, *,
                             patch_size: int,
                             window_sizes: Tuple[int, ...],
                             scale: float = 1.0, shift: float = 0.0,
                             preserve_mass: bool = False,
                             indices: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Random-rescale patch extraction: per-example source windows of side
    ``window_sizes[scale_idx[i]]``, normalized, resized to ``patch_size``
    with JAX's antialiased bilinear weights, then flipped.

    Args:
      images, indices, flips, scale, shift: as :func:`extract_patches`.
      offsets: [B, 2] int32 (y, x); the caller guarantees
        ``0 ≤ o ≤ dim − window_sizes[scale_idx[i]]`` per example.
      scale_idx: [B] int32 index into ``window_sizes``.
      window_sizes: source window sides, e.g. ``(168, 224, 280)`` around a
        224 patch. A window of side P is copied exactly, as JAX skips the
        resize there.
      preserve_mass: multiply by ``(window / patch_size)²`` so that each
        patch keeps the density mass (head count) of its window.

    Returns: [B, P, P, C] float32 on the device of ``images``.

    Every launch of the CUDA kernel adds one to
    ``extract_rescaled_patches.launches``.
    """
    window_sizes = tuple(int(v) for v in window_sizes)
    if images.device.type == "cpu":
        return extract_rescaled_patches_plain(
            images, offsets, flips, scale_idx, patch_size=patch_size,
            window_sizes=window_sizes, scale=scale, shift=shift,
            preserve_mass=preserve_mass, indices=indices)
    indices = _check_launch("extract_rescaled_patches", images, indices,
                            offsets=offsets, flips=flips, scale_idx=scale_idx)
    _, h, w, c = images.shape
    p = int(patch_size)
    plan = sampler_plan(indices.shape[0], h, w, c, p, images.element_size(),
                        window_sizes)
    return _launch_rescaled(images, indices, offsets, flips, scale_idx, p,
                            window_sizes, scale, shift, preserve_mass, plan)


extract_rescaled_patches.launches = 0


def _launch_rescaled(images: torch.Tensor, indices: torch.Tensor,
                     offsets: torch.Tensor, flips: torch.Tensor,
                     scale_idx: torch.Tensor, p: int,
                     window_sizes: Tuple[int, ...], scale: float,
                     shift: float, preserve_mass: bool, plan: SamplerPlan
                     ) -> torch.Tensor:
    """The rescale sampler's kernel on checked arguments at ``plan``."""
    _, h, w, c = images.shape
    b = indices.shape[0]
    windows, first, weights, mass, taps = _device_tap_table(
        window_sizes, p, images.device)
    out = torch.empty((b, p, p, c), dtype=torch.float32, device=images.device)
    lib = _library()
    stream = torch.cuda.current_stream(images.device).cuda_stream
    code = lib.srgan_extract_rescaled_patches(
        images.data_ptr(), indices.data_ptr(), offsets.data_ptr(),
        flips.data_ptr(), scale_idx.data_ptr(), windows.data_ptr(),
        first.data_ptr(), weights.data_ptr(), mass.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[images.dtype], b, h, w, c, p,
        len(window_sizes), taps, max(window_sizes), *plan, scale, shift,
        int(bool(preserve_mass)), stream)
    if code != 0:
        raise RuntimeError(f"rescaled patches kernel launch failed: "
                           f"{lib.srgan_cuda_error_string(code).decode()}")
    extract_rescaled_patches.launches += 1
    return out


def extract_rescaled_patches_plain(images: torch.Tensor,
                                   offsets: torch.Tensor,
                                   flips: torch.Tensor,
                                   scale_idx: torch.Tensor, *,
                                   patch_size: int,
                                   window_sizes: Tuple[int, ...],
                                   scale: float = 1.0, shift: float = 0.0,
                                   preserve_mass: bool = False,
                                   indices: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """The same function in plain PyTorch, on any device: per window size,
    the examples that use it are cropped and normalized
    (:func:`extract_patches_plain`), contracted with the resize weights
    along y and x, and scaled by the mass factor; then all are flipped.
    Raises on a window outside its image, and under CUDA graph capture."""
    _refuse_capture("extract_rescaled_patches_plain")
    window_sizes = tuple(int(v) for v in window_sizes)
    n, h, w, c = images.shape
    _check_windows(window_sizes, h, w)
    p = int(patch_size)
    device = images.device
    if indices is None:
        indices = torch.arange(n, device=device)
    sidx = scale_idx.to(device=device, dtype=torch.long)
    out = torch.zeros((indices.shape[0], p, p, c), dtype=torch.float32,
                      device=device)
    for s, ws in enumerate(window_sizes):
        sel = (sidx == s).nonzero().flatten()
        if sel.numel() == 0:
            continue
        win = extract_patches_plain(
            images, offsets.to(device)[sel], torch.zeros_like(sel),
            patch_size=ws, scale=scale, shift=shift,
            indices=indices.to(device)[sel])
        if ws != p:  # JAX skips the resize of an identity window
            wt = torch.from_numpy(resize_weights(ws, p).copy()).to(device)
            win = torch.einsum("yi,kijc,xj->kyxc", wt, win, wt)
        if preserve_mass:
            win = win * _mass_factor(ws, p)
        out[sel] = win
    flip = flips.to(device=device).reshape(-1, 1, 1, 1) != 0
    return torch.where(flip, out.flip(2), out)


def extract_rescaled_patches_reference(images: np.ndarray,
                                       offsets: np.ndarray,
                                       flips: np.ndarray,
                                       scale_idx: np.ndarray,
                                       patch_size: int,
                                       window_sizes: Tuple[int, ...],
                                       scale: float = 1.0,
                                       shift: float = 0.0,
                                       preserve_mass: bool = False,
                                       indices: np.ndarray | None = None
                                       ) -> np.ndarray:
    """NumPy golden model: per example, crop → normalize → resize with
    :func:`resize_weights` → mass factor → flip (``srgan_tpu.ops.patches``
    keeps the same, resizing with ``jax.image.resize``)."""
    if indices is None:
        indices = np.arange(images.shape[0])
    p = patch_size
    out = np.empty((len(indices), p, p, images.shape[3]), np.float32)
    for i in range(len(indices)):
        ws = int(window_sizes[int(scale_idx[i])])
        oy, ox = int(offsets[i, 0]), int(offsets[i, 1])
        win = images[int(indices[i]),
                     oy:oy + ws, ox:ox + ws].astype(np.float32)
        win = win * np.float32(scale) + np.float32(shift)
        if ws != p:
            m = resize_weights(ws, p)
            win = np.einsum("yi,ijc,xj->yxc", m, win, m)
        if preserve_mass:
            win = win * np.float32(_mass_factor(ws, p))
        out[i] = win[:, ::-1] if flips[i] else win
    return out
