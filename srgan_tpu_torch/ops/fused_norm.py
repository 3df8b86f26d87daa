"""Fused GroupNorm + LeakyReLU, forward and backward, with the second
derivative that the gradient penalty takes through it.

The port of ``srgan_tpu.ops.fused_norm`` (``Settings.norm_impl="pallas"``):

* :func:`group_norm_act_fwd_plain` and :func:`group_norm_act_bwd_plain` —
  line-for-line ports of ``_reference_fwd`` and ``_reference_bwd`` over
  ``[B, HW, C]``: float32 statistics E[x²] − E[x]² with no clamp of the
  variance, ``where(y0 > 0, 1, slope)`` for the activation's derivative.
  The CPU tests use them; ``chip_smoke.py`` holds the kernels against them
  on the card.
* :func:`_launch_fwd` and :func:`_launch_bwd` — the hand-written CUDA
  kernels of ``csrc/fused_norm.cu`` (built at first use). Each launch
  adds one to the launcher's ``launches``.
* Two ``torch.autograd.Function``s, the ``custom_vjp``-over-``custom_jvp``
  structure of JAX's ``_make_gn_act``: :class:`_GroupNormActFwd` runs the
  forward kernel, and its backward is :class:`_GroupNormActBwd`, which
  runs the backward kernel and is itself differentiable. So every
  first-order backward (the D, G and DNN updates, and the penalty's inner
  gradient w.r.t. the interpolates) runs the backward kernel, and only the
  penalty's outer gradient runs composite PyTorch, as in JAX.
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
from typing import Tuple

import torch
from torch import nn

from srgan_tpu_torch.ops import _build

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
# Elements of one example that one block of a pass takes (a slab of
# rows); the kernels take any slab size, this one keeps the card busy at
# every flagship shape with small partial sums.
_SLAB_ELEMENTS = 16384
# The fold kernels hold 2·C float32 sums in 48 KB of shared memory.
_MAX_CHANNELS = 6144


# ---------------------------------------------------------------------------
# Plain versions: the ports of _reference_fwd and _reference_bwd.
# ---------------------------------------------------------------------------

def _group_stats(x: Tensor, groups: int, eps: float
                 ) -> Tuple[Tensor, Tensor]:
    """Float32 group mean and rstd [B, G] of x [B, HW, C]."""
    b, hw, c = x.shape
    xf = x.float().reshape(b, hw, groups, c // groups)
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
    y0 = ((x.float() - mean_c[:, None, :]) * rstd_c[:, None, :]
          * scale.float() + bias.float())
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
    xf = x.float()
    xhat = (xf - mean_c) * rstd_c
    y0 = xhat * scale.float() + bias.float()
    dy0 = dy.float() * torch.where(y0 > 0, 1.0, negative_slope)
    dbias = dy0.sum(dim=(0, 1))
    dscale = (dy0 * xhat).sum(dim=(0, 1))
    dxhat = dy0 * scale.float()
    n = hw * cg
    g1 = dxhat.reshape(b, hw, groups, cg)
    g2 = (dxhat * xhat).reshape(b, hw, groups, cg)
    m1 = (g1.sum(dim=(1, 3)) / n).repeat_interleave(cg, dim=1)[:, None, :]
    m2 = (g2.sum(dim=(1, 3)) / n).repeat_interleave(cg, dim=1)[:, None, :]
    dx = (rstd_c * (dxhat - m1 - xhat * m2)).to(x.dtype)
    return dx, dscale, dbias


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load_library("fused_norm")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srgan_group_norm_act_fwd.argtypes = (
        [ptr] * 7 + [i32] * 7 + [f32, f32, ptr])
    lib.srgan_group_norm_act_fwd.restype = i32
    lib.srgan_group_norm_act_bwd.argtypes = (
        [ptr] * 12 + [i32] * 7 + [f32, ptr])
    lib.srgan_group_norm_act_bwd.restype = i32
    lib.srgan_cuda_error_string.argtypes = [i32]
    lib.srgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _slabs(hw: int, c: int) -> Tuple[int, int]:
    """(rows per slab, slabs) for an example of ``hw`` rows of ``c``."""
    rows = min(hw, -(-_SLAB_ELEMENTS // c))
    return rows, -(-hw // rows)


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
              "scale": ((c,), torch.float32), "bias": ((c,), torch.float32),
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


def _launch_fwd(x: Tensor, scale: Tensor, bias: Tensor, groups: int,
                negative_slope: float, eps: float
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """The forward kernel: (y, mean, rstd) as the plain version returns
    them."""
    _check_launch(x, groups, scale=scale, bias=bias)
    b, hw, c = x.shape
    rows, slabs = _slabs(hw, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), **f32)
    rstd = torch.empty((b, groups), **f32)
    partials = torch.empty((b, slabs, 2, c), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_library().srgan_group_norm_act_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), partials.data_ptr(),
        _DTYPE_CODES[x.dtype], b, hw, c, groups, rows, slabs,
        negative_slope, eps, stream), "forward")
    _launch_fwd.launches += 1
    return y, mean, rstd


_launch_fwd.launches = 0


def _launch_bwd(x: Tensor, scale: Tensor, bias: Tensor, mean: Tensor,
                rstd: Tensor, dy: Tensor, groups: int, negative_slope: float
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward kernel: (dx, dscale, dbias) as the plain version
    returns them."""
    _check_launch(x, groups, scale=scale, bias=bias, mean=mean, rstd=rstd,
                  dy=dy)
    b, hw, c = x.shape
    rows, slabs = _slabs(hw, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dscale = torch.empty((c,), **f32)
    dbias = torch.empty((c,), **f32)
    partials = torch.empty((b, slabs, 2, c), **f32)
    sums = torch.empty((b, 2, c), **f32)
    means = torch.empty((b, 2, groups), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_library().srgan_group_norm_act_bwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr(), partials.data_ptr(), sums.data_ptr(),
        means.data_ptr(), _DTYPE_CODES[x.dtype], b, hw, c, groups, rows,
        slabs, negative_slope, stream), "backward")
    _launch_bwd.launches += 1
    return dx, dscale, dbias


_launch_bwd.launches = 0


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


class _GroupNormActBwd(torch.autograd.Function):
    """(x, scale, bias, mean, rstd, dy) ↦ (dx, dscale, dbias) by the
    backward kernel; differentiable for the gradient penalty."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, rstd, dy, groups, negative_slope,
                eps):
        ctx.save_for_backward(x, scale, bias, dy)
        ctx.config = (groups, negative_slope, eps)
        return _bwd(x, scale, bias, mean, rstd, dy, groups, negative_slope)

    @staticmethod
    def backward(ctx, g_dx, g_dscale, g_dbias):
        """The VJP of the whole map (x, scale, bias, dy) ↦ (dx, dscale,
        dbias), mean and rstd recomputed from x, so that the second
        derivative through them is kept; none for mean and rstd.

        Composite PyTorch, on the card too. It is not a fallback for a
        kernel: it is the port of JAX's ``custom_jvp`` rule
        ``bwd_op_jvp`` (``srgan_tpu/ops/fused_norm.py``), which
        differentiates the same references and has no TPU kernel.
        """
        x, scale, bias, dy = ctx.saved_tensors
        groups, negative_slope, eps = ctx.config

        def whole(x, scale, bias, dy):
            mean, rstd = _group_stats(x, groups, eps)
            return group_norm_act_bwd_plain(x, scale, bias, mean, rstd, dy,
                                            groups, negative_slope)

        _, vjp = torch.func.vjp(whole, x, scale, bias, dy)
        g_x, g_scale, g_bias, g_dy = vjp((g_dx, g_dscale, g_dbias))
        return g_x, g_scale, g_bias, None, None, g_dy, None, None, None


class _GroupNormActFwd(torch.autograd.Function):
    """(x, scale, bias) ↦ y by the forward kernel; its backward is
    :class:`_GroupNormActBwd`, so it stays differentiable."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, negative_slope, eps):
        y, mean, rstd = _fwd(x, scale, bias, groups, negative_slope, eps)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.config = (groups, negative_slope, eps)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        if not dy.is_contiguous():
            # The kernels take [B, HW, C] contiguous, i.e. channels_last.
            group_norm_act.layout_copies += 1
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
    """
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    rows = x.permute(0, 2, 3, 1)
    if not rows.is_contiguous():
        group_norm_act.layout_copies += 1
        rows = rows.contiguous()
    y = _GroupNormActFwd.apply(rows.view(b, h * w, c), scale, bias, groups,
                               float(negative_slope), float(eps))
    return y.view(b, h, w, c).permute(0, 3, 1, 2)


group_norm_act.layout_copies = 0


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
