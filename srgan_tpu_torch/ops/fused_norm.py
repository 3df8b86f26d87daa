"""Fused GroupNorm + LeakyReLU, forward and backward, with the second
derivative that the gradient penalty takes through it.

The port of ``srgan_tpu.ops.fused_norm`` (``Settings.norm_impl="pallas"``):

* :func:`group_norm_act_fwd_plain` and :func:`group_norm_act_bwd_plain` —
  line-for-line ports of ``_reference_fwd`` and ``_reference_bwd`` over
  ``[B, HW, C]``: float32 statistics E[x²] − E[x]² with no clamp of the
  variance, ``where(y0 > 0, 1, slope)`` for the activation's derivative
  (float64 throughout on float64 inputs). The CPU tests use them;
  ``chip_smoke.py`` holds the kernels against them on the card.
* :func:`group_norm_act_bwd_vjp_plain` — the VJP of the backward map
  (x, scale, bias, dy) ↦ (dx, dscale, dbias) in closed form: what
  ``torch.func.vjp`` of ``group_norm_act_bwd_plain`` (mean and rstd
  recomputed from x) gives, from seven sums per (example, group). JAX has
  no kernel for it (its ``custom_jvp`` rule differentiates
  ``_reference_bwd``); this is the spec of the second-order kernel.
* :func:`_launch_fwd`, :func:`_launch_bwd` and
  :func:`_launch_second_order` — the hand-written CUDA kernels of
  ``csrc/fused_norm.cu`` (built at first use): a thread-block cluster per
  example holds its rows in shared memory, so x (and dy, and the
  cotangent of dx) are read from device memory once. :func:`norm_tiling`
  chooses the cluster and what it holds. Each launch adds one to the
  counter ``fused_norm.<launcher>.launches`` (``utils/trace.py``).
* Two ``torch.autograd.Function``s, the ``custom_vjp``-over-``custom_jvp``
  structure of JAX's ``_make_gn_act``: :class:`_GroupNormActFwd` runs the
  forward kernel, and its backward is :class:`_GroupNormActBwd`, which
  runs the backward kernel and is differentiable once more, by the
  second-order kernel. So every first-order backward (the D, G and DNN
  updates, and the penalty's inner gradient w.r.t. the interpolates) runs
  the backward kernel, and the penalty's outer gradient the second-order
  kernel.
* :func:`group_norm_act` and :class:`FusedGroupNormAct` — the entry points
  over the port's NCHW tensors in ``channels_last`` memory.

On a CPU tensor, and only there, the Functions call the plain versions in
place of the kernels, so the CPU tests run the same autograd structure
that runs on the card. On a CUDA tensor they launch the kernels or raise.

Left out, as VMEM workarounds that the CUDA kernels do not need:
``_fold_factor``, ``_pick_chunk``, ``_MAX_SLICE_BYTES`` and the XLA
fallback of JAX's ``group_norm_act`` (its math is the same either way).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from srgan_tpu_torch.ops import _build
from srgan_tpu_torch.utils import trace

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
# The kernels hold 2·C float32 partial sums in shared memory.
_MAX_CHANNELS = 6144
# The H100 SXM's SMs. A constant, not read from the card, so that the
# tiling stays a pure function of shape and dtype; on a card with fewer
# SMs a small batch's cluster may grow past one wave.
_SMS = 132
# The shared memory a block of the kernels takes at most: all a block may
# have (227 KB), one block per SM. Its layout (csrc/fused_norm.cu): the
# chunks' mbarriers, three [2, C] float32 vectors, and the row-lane
# scratch of 512 threads × 8 floats, then the resident rows.
_SMEM_BUDGET = 232448
_BARRIER_BYTES = 128
_SCRATCH_BYTES = 512 * 8 * 4
# Clusters of up to 16 blocks (above 8 a non-portable size); see
# norm_tiling. A small batch's cluster grows to fill the card only while
# its blocks keep _MIN_ROWS rows each.
_CLUSTER_LIMIT = 16
_MIN_ROWS = 16
# The backward folds its blocks' per-channel sums into dscale/dbias (the
# second order into g_scale) through this many rows of partial sums
# (kFoldRuns in csrc/fused_norm.cu).
_FOLD_RUNS = 32
# The second order's sums per (example, group, block) (kGroupSums).
_GROUP_SUMS = 7
# Each kernel's inputs, held resident, and outputs of [B, HW, C]; its code
# for the occupancy query.
_DIRECTIONS = {"fwd": (1, 1, 0), "bwd": (2, 1, 1), "second_order": (3, 2, 2)}


# ---------------------------------------------------------------------------
# Plain versions: the ports of _reference_fwd and _reference_bwd.
# ---------------------------------------------------------------------------

def _wide(t: Tensor) -> Tensor:
    """t in the plain versions' compute dtype: float32, or float64 for a
    float64 tensor."""
    return t if t.dtype == torch.float64 else t.float()


def _group_stats(x: Tensor, groups: int, eps: float
                 ) -> Tuple[Tensor, Tensor]:
    """Group mean and rstd [B, G] of x [B, HW, C], float32 (float64 for
    float64 x)."""
    b, hw, c = x.shape
    xf = _wide(x).reshape(b, hw, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    sq = xf.square().mean(dim=(1, 3))
    return mean, torch.rsqrt(sq - mean.square() + eps)


def group_norm_act_fwd_plain(x: Tensor, scale: Tensor, bias: Tensor,
                             groups: int, negative_slope: float, eps: float
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """GroupNorm + activation returning (y, group mean, group rstd).

    x: [B, HW, C]; scale/bias: [C]; y in x's dtype; mean/rstd: [B, G]
    float32.
    """
    cg = x.shape[2] // groups
    mean, rstd = _group_stats(x, groups, eps)                 # [B, G]
    mean_c = mean.repeat_interleave(cg, dim=1)                # [B, C]
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    y0 = ((_wide(x) - mean_c[:, None, :]) * rstd_c[:, None, :]
          * _wide(scale) + _wide(bias))
    y = torch.where(y0 > 0, y0, negative_slope * y0)
    return y.to(x.dtype), mean, rstd


def group_norm_act_bwd_plain(x: Tensor, scale: Tensor, bias: Tensor,
                             mean: Tensor, rstd: Tensor, dy: Tensor,
                             groups: int, negative_slope: float
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """GroupNorm + activation backward: (dx in x's dtype, dscale, dbias
    float32 [C])."""
    b, hw, c = x.shape
    cg = c // groups
    mean_c = mean.repeat_interleave(cg, dim=1)[:, None, :]    # [B, 1, C]
    rstd_c = rstd.repeat_interleave(cg, dim=1)[:, None, :]
    xhat = (_wide(x) - mean_c) * rstd_c
    y0 = xhat * _wide(scale) + _wide(bias)
    dy0 = _wide(dy) * torch.where(y0 > 0, 1.0, negative_slope)
    dbias = dy0.sum(dim=(0, 1))
    dscale = (dy0 * xhat).sum(dim=(0, 1))
    dxhat = dy0 * _wide(scale)
    n = hw * cg
    g1 = dxhat.reshape(b, hw, groups, cg)
    g2 = (dxhat * xhat).reshape(b, hw, groups, cg)
    m1 = (g1.sum(dim=(1, 3)) / n).repeat_interleave(cg, dim=1)[:, None, :]
    m2 = (g2.sum(dim=(1, 3)) / n).repeat_interleave(cg, dim=1)[:, None, :]
    dx = (rstd_c * (dxhat - m1 - xhat * m2)).to(x.dtype)
    return dx, dscale, dbias


def group_norm_act_bwd_vjp_plain(x: Tensor, scale: Tensor, bias: Tensor,
                                 mean: Tensor, rstd: Tensor, dy: Tensor,
                                 g_dx: Tensor, g_dscale: Tensor,
                                 g_dbias: Tensor, groups: int,
                                 negative_slope: float
                                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The VJP of (x, scale, bias, dy) ↦ (dx, dscale, dbias) of
    :func:`group_norm_act_bwd_plain` at the cotangents (g_dx, g_dscale,
    g_dbias): (g_x and g_dy in x's dtype, g_scale and g_bias float32 [C]).

    mean and rstd are those of x (the forward's), differentiated through
    as functions of x; the activation's mask is a constant, so g_bias is
    0. With x̂ = (x − μ)·r, e = dy·mask and a = e·scale, over each
    (example, group) of n elements, L = Σ g_dx·dx + Σ (g_dscale·x̂ +
    g_dbias)·e and dx = r·(a − Σa/n − x̂·Σa·x̂/n), so that

    * ∂L/∂a = α = r·(g_dx − u − x̂·v), u = Σg_dx/n, v = Σg_dx·x̂/n;
      g_dy = mask·(g_dscale·x̂ + g_dbias + scale·α), g_scale = Σ_{b,rows}
      e·α;
    * ∂L/∂r = ρ = Σg_dx·a − Σa·u − Σa·x̂·v, ∂L/∂x̂ = h = −r·(a·v + g_dx·
      Σa·x̂/n) + g_dscale·e, and through x̂ and r(x) g_x = r·(h − Σh/n)
      − x̂·r·(Σh·x̂ + ρ·r)/n.

    Seven sums of each group carry it: Σa, Σa·x̂, Σg_dx, Σg_dx·x̂,
    Σg_dx·a, Σg_dscale·e and Σg_dscale·e·x̂ (Σh = Σg_dscale·e − r·(Σa·v +
    Σa·x̂·u), Σh·x̂ = Σg_dscale·e·x̂ − 2·r·Σa·x̂·v). Float32 (float64 on
    float64 inputs), as the composite it stands for.
    """
    b, hw, c = x.shape
    cg = c // groups
    n = hw * cg

    def per_channel(t):  # [B, G] → [B, 1, C]
        return t.repeat_interleave(cg, dim=1)[:, None, :]

    def group_sum(t):  # [B, HW, C] → [B, G]
        return t.reshape(b, hw, groups, cg).sum(dim=(1, 3))

    r = _wide(rstd)
    r_c = per_channel(r)
    gamma, p, q = _wide(scale), _wide(g_dscale), _wide(g_dbias)
    xhat = (_wide(x) - per_channel(_wide(mean))) * r_c
    mask = torch.where(xhat * gamma + _wide(bias) > 0, 1.0, negative_slope)
    e = _wide(dy) * mask
    a = e * gamma
    gdx = _wide(g_dx)
    sa, sax = group_sum(a), group_sum(a * xhat)
    sg, sgx, sga = group_sum(gdx), group_sum(gdx * xhat), group_sum(gdx * a)
    spe, spex = group_sum(p * e), group_sum(p * e * xhat)
    u, v = sg / n, sgx / n
    rho = sga - sa * u - sax * v
    h0 = spe - r * (sa * v + sax * u)
    h1 = spex - 2 * r * sax * v
    alpha = r_c * (gdx - per_channel(u) - xhat * per_channel(v))
    g_dy = mask * (p * xhat + q + gamma * alpha)
    g_x = (r_c * (p - gamma * per_channel(r * v)) * e
           - per_channel(r * r * sax / n) * gdx
           - per_channel(r * h0 / n)
           - per_channel(r * (h1 + rho * r) / n) * xhat)
    g_scale = (e * alpha).sum(dim=(0, 1))
    return (g_x.to(x.dtype), g_scale.to(scale.dtype),
            torch.zeros_like(g_scale).to(bias.dtype), g_dy.to(dy.dtype))


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load_library("fused_norm")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srgan_group_norm_act_fwd.argtypes = (
        [ptr] * 6 + [i32] * 9 + [f32, f32, ptr])
    lib.srgan_group_norm_act_fwd.restype = i32
    lib.srgan_group_norm_act_bwd.argtypes = (
        [ptr] * 10 + [i32] * 9 + [f32, ptr])
    lib.srgan_group_norm_act_bwd.restype = i32
    lib.srgan_group_norm_act_second_order.argtypes = (
        [ptr] * 15 + [i32] * 9 + [f32, ptr])
    lib.srgan_group_norm_act_second_order.restype = i32
    lib.srgan_group_norm_act_max_clusters.argtypes = [i32] * 4 + [ptr]
    lib.srgan_group_norm_act_max_clusters.restype = i32
    lib.srgan_cuda_error_string.argtypes = [i32]
    lib.srgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


class NormTiling(NamedTuple):
    """How the kernels cut an example of ``hw`` rows: a cluster of
    ``cluster`` blocks, each owning ``rows_per_block`` rows (the last
    block may own fewer, none owns none), of which the first
    ``resident_rows`` are held in shared memory; ``smem_bytes`` of
    dynamic shared memory a block."""
    cluster: int
    rows_per_block: int
    resident_rows: int
    smem_bytes: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _smem_bytes(c: int, resident: int, elem: int, tensors: int) -> int:
    """A block's shared memory: the kernels' fixed layout, then
    ``tensors`` runs of ``resident`` rows (``fixed_smem`` and ``Smem`` in
    csrc/fused_norm.cu)."""
    fixed = _BARRIER_BYTES + 3 * _align16(8 * c) + _SCRATCH_BYTES
    return fixed + tensors * _align16(resident * c * elem)


@functools.cache
def norm_tiling(b: int, hw: int, c: int, dtype: torch.dtype,
                direction: str) -> NormTiling:
    """The tiling of the forward (``direction="fwd"``, x resident),
    backward (``"bwd"``, x and dy resident) or second-order
    (``"second_order"``, x, dy and g_dx resident) kernel for x [b, hw, c].

    The cluster is the smallest power of two (up to 16) whose blocks hold
    the example's rows within ``_SMEM_BUDGET`` bytes of shared memory
    each. Rows a cluster of 16 cannot hold are streamed (read twice). A
    cluster also grows while twice its blocks still fit the card's SMs in
    one wave and keep ``_MIN_ROWS`` rows each. A pure function of shape
    and dtype: the same shape always takes the same tiling.
    """
    if direction not in _DIRECTIONS:
        raise ValueError(f"direction is one of {sorted(_DIRECTIONS)}, got "
                         f"{direction!r}")
    elem = dtype.itemsize
    tensors = _DIRECTIONS[direction][0]
    fits = ((_SMEM_BUDGET - _smem_bytes(c, 0, elem, tensors))
            // (tensors * c * elem))
    cluster = 1
    while cluster < _CLUSTER_LIMIT and (
            -(-hw // cluster) > fits
            or (2 * b * cluster <= _SMS and hw // (2 * cluster) >= _MIN_ROWS)):
        cluster *= 2
    # No block without rows: halve the cluster until the last one has some.
    while cluster > 1 and (cluster - 1) * -(-hw // cluster) >= hw:
        cluster //= 2
    rows = -(-hw // cluster)
    resident = max(0, min(rows, fits))
    return NormTiling(cluster, rows, resident,
                      _smem_bytes(c, resident, elem, tensors))


def norm_traffic_bytes(b: int, hw: int, c: int, dtype: torch.dtype,
                       direction: str, tiling: NormTiling) -> int:
    """Bytes of [B, HW, C] tensors that a launch at ``tiling`` moves
    through device memory: the inputs (x; dy; g_dx) read once and the
    outputs (y; dx; g_x and g_dy) written once, plus the streamed rows of
    the inputs read again."""
    elem = dtype.itemsize
    inputs, outputs, _ = _DIRECTIONS[direction]
    rows = tiling.rows_per_block
    reread = sum(max(0, min(rows, hw - q * rows) - tiling.resident_rows)
                 for q in range(tiling.cluster))
    return b * c * elem * (hw * (inputs + outputs) + reread * inputs)


@functools.cache
def max_active_clusters(dtype: torch.dtype, direction: str,
                        tiling: NormTiling) -> int:
    """How many clusters of the kernel at ``tiling`` the card runs at once
    (``cudaOccupancyMaxActiveClusters``). It asks about the kernel of
    vectors, which every flagship shape takes; a launch whose rows are not
    whole 16-byte vectors runs the element kernel, whose registers may
    differ."""
    out = ctypes.c_int(0)
    _raise_on(_library().srgan_group_norm_act_max_clusters(
        _DTYPE_CODES[dtype], _DIRECTIONS[direction][2], tiling.cluster,
        tiling.smem_bytes, ctypes.addressof(out)), "occupancy query")
    return out.value


def _check_launch(x: Tensor, groups: int, **others: Tensor) -> None:
    """Raise on anything the kernels do not take. ``others`` maps a name
    to a tensor whose dtype and shape follow from its name."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused norm kernels run on CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} is not one of "
                        f"{sorted(map(str, _DTYPE_CODES))}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, HW, C] tensor, got "
                         f"shape {tuple(x.shape)}, strides {x.stride()}")
    b, _, c = x.shape
    if groups <= 0 or c % groups or c > _MAX_CHANNELS or not 0 < b <= 65535:
        raise ValueError(f"the kernels take C % groups == 0, C <= "
                         f"{_MAX_CHANNELS} and 0 < B <= 65535; got "
                         f"B={b}, C={c}, groups={groups}")
    shapes = {"dy": (tuple(x.shape), x.dtype),
              "g_dx": (tuple(x.shape), x.dtype),
              "scale": ((c,), torch.float32), "bias": ((c,), torch.float32),
              "g_dscale": ((c,), torch.float32),
              "g_dbias": ((c,), torch.float32),
              "mean": ((b, groups), torch.float32),
              "rstd": ((b, groups), torch.float32)}
    for name, t in others.items():
        shape, dtype = shapes[name]
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} {list(shape)} tensor "
                f"on {x.device}, got {t.dtype} {list(t.shape)} on "
                f"{t.device} (contiguous: {t.is_contiguous()})")


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"fused norm {what} kernel launch failed: "
                           f"{_library().srgan_cuda_error_string(code).decode()}")


def _tiling(x: Tensor, direction: str, tiling: Optional[NormTiling]
            ) -> NormTiling:
    b, hw, c = x.shape
    return tiling or norm_tiling(b, hw, c, x.dtype, direction)


def _launch_fwd(x: Tensor, scale: Tensor, bias: Tensor, groups: int,
                negative_slope: float, eps: float,
                tiling: Optional[NormTiling] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """The forward kernel: (y, mean, rstd) as the plain version returns
    them. ``tiling`` defaults to :func:`norm_tiling`'s."""
    _check_launch(x, groups, scale=scale, bias=bias)
    b, hw, c = x.shape
    t = _tiling(x, "fwd", tiling)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), **f32)
    rstd = torch.empty((b, groups), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_library().srgan_group_norm_act_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), _DTYPE_CODES[x.dtype], b, hw, c,
        groups, *t, negative_slope, eps, stream), "forward")
    trace.count("fused_norm._launch_fwd.launches")
    return y, mean, rstd


trace.declare("fused_norm._launch_fwd.launches")


def _launch_bwd(x: Tensor, scale: Tensor, bias: Tensor, mean: Tensor,
                rstd: Tensor, dy: Tensor, groups: int, negative_slope: float,
                tiling: Optional[NormTiling] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward kernel: (dx, dscale, dbias) as the plain version
    returns them. ``tiling`` defaults to :func:`norm_tiling`'s."""
    _check_launch(x, groups, scale=scale, bias=bias, mean=mean, rstd=rstd,
                  dy=dy)
    b, hw, c = x.shape
    t = _tiling(x, "bwd", tiling)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dscale = torch.empty((c,), **f32)
    dbias = torch.empty((c,), **f32)
    # Each block's per-channel sums, then the fold's partial sums.
    sums = torch.empty((b * t.cluster + _FOLD_RUNS, 2, c), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_library().srgan_group_norm_act_bwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr(), sums.data_ptr(), _DTYPE_CODES[x.dtype], b, hw, c,
        groups, *t, negative_slope, stream), "backward")
    trace.count("fused_norm._launch_bwd.launches")
    return dx, dscale, dbias


trace.declare("fused_norm._launch_bwd.launches")


def _launch_second_order(x: Tensor, scale: Tensor, bias: Tensor,
                         mean: Tensor, rstd: Tensor, dy: Tensor, g_dx: Tensor,
                         g_dscale: Tensor, g_dbias: Tensor, groups: int,
                         negative_slope: float,
                         tiling: Optional[NormTiling] = None
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The second-order kernel: (g_x, g_scale, g_bias, g_dy) as
    :func:`group_norm_act_bwd_vjp_plain` returns them, mean and rstd the
    forward's. ``tiling`` defaults to :func:`norm_tiling`'s."""
    _check_launch(x, groups, scale=scale, bias=bias, mean=mean, rstd=rstd,
                  dy=dy, g_dx=g_dx, g_dscale=g_dscale, g_dbias=g_dbias)
    b, hw, c = x.shape
    t = _tiling(x, "second_order", tiling)
    f32 = dict(dtype=torch.float32, device=x.device)
    g_x = torch.empty_like(x)
    g_dy = torch.empty_like(x)
    g_scale = torch.empty((c,), **f32)
    g_bias = torch.empty((c,), **f32)
    # Each block's per-channel Σe·α, then the fold's partial sums; each
    # block's group sums.
    sums = torch.empty((b * t.cluster + _FOLD_RUNS, c), **f32)
    group_sums = torch.empty((b, t.cluster, _GROUP_SUMS, groups), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_library().srgan_group_norm_act_second_order(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dy.data_ptr(), g_dx.data_ptr(), g_dscale.data_ptr(),
        g_dbias.data_ptr(), g_x.data_ptr(), g_scale.data_ptr(),
        g_bias.data_ptr(), g_dy.data_ptr(), sums.data_ptr(),
        group_sums.data_ptr(), _DTYPE_CODES[x.dtype], b, hw, c, groups, *t,
        negative_slope, stream), "second-order")
    trace.count("fused_norm._launch_second_order.launches")
    return g_x, g_scale, g_bias, g_dy


trace.declare("fused_norm._launch_second_order.launches")


# ---------------------------------------------------------------------------
# Autograd.
# ---------------------------------------------------------------------------

def _fwd(x, scale, bias, groups, negative_slope, eps):
    if x.device.type == "cpu":
        return group_norm_act_fwd_plain(x, scale, bias, groups,
                                        negative_slope, eps)
    return _launch_fwd(x, scale, bias, groups, negative_slope, eps)


def _bwd(x, scale, bias, mean, rstd, dy, groups, negative_slope):
    if x.device.type == "cpu":
        return group_norm_act_bwd_plain(x, scale, bias, mean, rstd, dy,
                                        groups, negative_slope)
    return _launch_bwd(x, scale, bias, mean, rstd, dy, groups,
                       negative_slope)


def _second_order(x, scale, bias, mean, rstd, dy, g_dx, g_dscale, g_dbias,
                  groups, negative_slope):
    args = (x, scale, bias, mean, rstd, dy, g_dx, g_dscale, g_dbias, groups,
            negative_slope)
    if x.device.type == "cpu":
        return group_norm_act_bwd_vjp_plain(*args)
    return _launch_second_order(*args)


class _NoThirdOrder(torch.autograd.Function):
    """The second order's outputs, passed through and tied to the tensors
    they were computed from, so that differentiating them raises whichever
    of those tensors the gradient is taken for."""

    @staticmethod
    def forward(ctx, count, *tensors):
        return tuple(t.view_as(t) for t in tensors[:count])

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the fused norm is differentiable twice: its "
                           "second order has no derivative")


class _GroupNormActBwd(torch.autograd.Function):
    """(x, scale, bias, mean, rstd, dy) ↦ (dx, dscale, dbias) by the
    backward kernel; differentiable once more, by the second-order
    kernel, for the gradient penalty, and no further: a third order of
    the norm raises (the composite ``torch.func.vjp`` it replaced, like
    JAX's ``custom_jvp`` rule, could be differentiated again; nothing in
    the port takes a third order)."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, rstd, dy, groups, negative_slope):
        ctx.save_for_backward(x, scale, bias, mean, rstd, dy)
        ctx.config = (groups, negative_slope)
        return _bwd(x, scale, bias, mean, rstd, dy, groups, negative_slope)

    @staticmethod
    def backward(ctx, g_dx, g_dscale, g_dbias):
        """The VJP of the whole map (x, scale, bias, dy) ↦ (dx, dscale,
        dbias), mean and rstd differentiated as functions of x; none for
        mean and rstd. The port of JAX's ``custom_jvp`` rule
        ``bwd_op_jvp`` (``srgan_tpu/ops/fused_norm.py``), which
        differentiates the same references and has no TPU kernel."""
        x, scale, bias, mean, rstd, dy = ctx.saved_tensors
        if not g_dx.is_contiguous():
            trace.count("group_norm_act.layout_copies")
            g_dx = g_dx.contiguous()
        with torch.no_grad():
            out = _second_order(x, scale, bias, mean, rstd, dy, g_dx,
                                g_dscale.contiguous(), g_dbias.contiguous(),
                                *ctx.config)
        sources = [t for t in (x, scale, bias, dy, g_dx, g_dscale, g_dbias)
                   if t.requires_grad]
        if torch.is_grad_enabled() and sources:  # under create_graph
            out = _NoThirdOrder.apply(len(out), *out, *sources)
        g_x, g_scale, g_bias, g_dy = out
        return g_x, g_scale, g_bias, None, None, g_dy, None, None


class _GroupNormActFwd(torch.autograd.Function):
    """(x, scale, bias) ↦ y by the forward kernel; its backward is
    :class:`_GroupNormActBwd`, so it stays differentiable."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, negative_slope, eps):
        y, mean, rstd = _fwd(x, scale, bias, groups, negative_slope, eps)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.config = (groups, negative_slope)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        if not dy.is_contiguous():
            # The kernels take [B, HW, C] contiguous, i.e. channels_last.
            trace.count("group_norm_act.layout_copies")
            dy = dy.contiguous()
        dx, dscale, dbias = _GroupNormActBwd.apply(x, scale, bias, mean,
                                                   rstd, dy, *ctx.config)
        return dx, dscale, dbias, None, None, None


def group_norm_act(x: Tensor, scale: Tensor, bias: Tensor, *, groups: int,
                   negative_slope: float = 0.0, eps: float = 1e-6) -> Tensor:
    """Fused GroupNorm + LeakyReLU(``negative_slope``) over NCHW ``x``;
    slope 0 is ReLU.

    Matches JAX's ``group_norm_act``: float32 statistics whatever x's
    dtype, the activation applied in float32, y in x's dtype. ``x`` should
    be in ``channels_last`` memory, where its [B, H·W, C] view needs no
    copy; an input or an incoming gradient in another layout is copied,
    and each copy adds one to ``group_norm_act.layout_copies``.

    Differentiable exactly twice, on every device: the second order (the
    gradient penalty's) is one closed-form map, and a third order raises.
    """
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    rows = x.permute(0, 2, 3, 1)
    if not rows.is_contiguous():
        trace.count("group_norm_act.layout_copies")
        rows = rows.contiguous()
    y = _GroupNormActFwd.apply(rows.view(b, h * w, c), scale, bias, groups,
                               float(negative_slope), float(eps))
    return y.view(b, h, w, c).permute(0, 3, 1, 2)


trace.declare("group_norm_act.layout_copies")


class FusedGroupNormAct(nn.Module):
    """GroupNorm + LeakyReLU through the fused kernels; the port of JAX's
    ``FusedGroupNormAct``.

    Parameters ``scale`` (ones) and ``bias`` (zeros), as a ``GroupNorm``
    has. The group count follows JAX: ``min(num_groups, channels)``,
    lowered until it divides ``channels``. Returns x's dtype, which is the
    compute dtype where the models call it.
    """

    def __init__(self, channels: int, num_groups: int = 32,
                 epsilon: float = 1e-6):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        self.num_groups = groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: Tensor, negative_slope: float = 0.0) -> Tensor:
        return group_norm_act(x, self.scale, self.bias,
                              groups=self.num_groups,
                              negative_slope=negative_slope,
                              eps=self.epsilon)
