"""Layers with flax semantics, GroupNorm + activation, the DCGAN
generator and the convolutional regressor.

The port of ``srgan_tpu.models.dcgan`` (``FastGroupNorm``, ``norm_act``
with ``impl="xla"``, ``"fast"`` or ``"pallas"``, ``DCGANGenerator`` and
``ConvRegressor``). Tensors are NCHW, and the models
keep them in ``channels_last`` memory, which is the JAX package's NHWC
layout in memory.

What differs from torch's own layers, and is matched here:

* ``SAME`` padding as flax computes it. A stride-2 3×3 conv on an even
  input pads (0, 1), bottom/right only; torch's ``padding=1`` would pad
  (1, 1) and shift the sampling grid.
* A flax ``ConvTranspose`` does not flip its kernel. Its k4 s2 ``SAME``
  form equals ``conv_transpose2d(padding=1)`` with the kernel flipped in
  H and W, which is how :class:`ConvTranspose` stores it.
* GroupNorm uses ε = 1e-6 and flax's single-pass variance E[x²] − E[x]²,
  with the statistics in float32 whatever the compute dtype.
  :class:`FastGroupNorm` (``"fast"``) keeps JAX's: ε = 1e-5 rounded to
  the compute dtype, a two-pass variance, the statistics in the compute
  dtype.
* The bf16 policy mirrors flax ``dtype=``: parameters stay float32; each
  conv and dense layer casts its input and its parameters to the compute
  dtype; GroupNorm computes in float32 and returns the compute dtype. The
  ``"xla"`` path casts before its activation, the fused ``"pallas"`` path
  after it, as in JAX.
* :class:`Conv` runs through :func:`conv`, whose second order (the
  gradient penalty's) is cuDNN's weight- and data-gradient calls, not
  PyTorch's convolution by a filter as large as the feature map; its
  first order is autograd's own call.
* Random init follows flax's defaults: LeCun-normal kernels (a normal
  truncated at ±2σ, σ = 1/√fan_in / 0.8796), zero biases, unit norm
  scales. It draws from an explicit ``torch.Generator`` (``rng``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from srgan_tpu_torch.ops.fused_norm import FusedGroupNormAct
from srgan_tpu_torch.utils import trace

# Standard deviation of a unit normal truncated to [-2, 2]: flax divides
# by it so that the truncated draw keeps the requested variance.
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  rng: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, std=std, a=-2 * std,
                                     b=2 * std, generator=rng)


def same_padding(size: int, kernel: int, stride: int,
                 dilation: int = 1) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) of one spatial dim, for the
    effective kernel ``dilation·(kernel − 1) + 1``."""
    out = -(-size // stride)
    span = dilation * (kernel - 1) + 1
    total = max((out - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


def _engine_wants(ctx, n: int) -> List[bool]:
    """Whether the autograd engine will use the gradient of each of the
    first ``n`` tensor inputs of the Function whose backward ``ctx`` is:
    what ``ConvolutionBackward0`` asks the engine before it picks its
    ``output_mask``. The engine answers for a non-leaf edge only (under
    ``autograd.grad`` it raises on a leaf), so :func:`conv` gives the
    Functions non-leaf inputs."""
    return [bool(ctx.needs_input_grad[i]) and node is not None
            and torch._C._will_engine_execute_node(node)
            for i, (node, _) in enumerate(ctx.next_functions[:n])]


def _non_leaf(t: torch.Tensor) -> torch.Tensor:
    return t.view_as(t) if t.requires_grad and t.grad_fn is None else t


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    if t.is_contiguous(memory_format=torch.channels_last):
        return t
    return t.contiguous(memory_format=torch.channels_last)


def _conv_backward(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                   stride: int, padding: Tuple[int, int], dilation: int,
                   mask: List[bool]):
    """(dx, dw, db) of ``conv2d(x, w, b)`` for the incoming ``dy``, those
    of ``mask`` only: the call autograd's ``ConvolutionBackward0`` makes,
    cuDNN's data- and weight-gradient kernels on the card."""
    return torch.ops.aten.convolution_backward.default(
        dy, x, w, [w.shape[0]], [stride, stride], list(padding),
        [dilation, dilation], False, [0, 0], 1, mask)


class _ConvBwd(torch.autograd.Function):
    """(dy, x, w) ↦ (dx, dw, db) by one ``convolution_backward`` call;
    differentiable for the gradient penalty."""

    @staticmethod
    def forward(ctx, dy, x, w, stride, padding, dilation, mask):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dy, x, w)
        ctx.config = (stride, padding, dilation)
        return _conv_backward(dy, x, w, stride, padding, dilation, mask)

    @staticmethod
    def backward(ctx, g_dx, g_dw, g_db):
        """The second order from the first order's own calls.

        dx = dgrad(dy, w), dw = wgrad(x, dy) and db = Σ dy are linear in
        dy, and dx in w and dw in x, so their VJP is:

        * for dy: conv2d(g_dx, w) + conv2d(x, g_dw) + g_db;
        * for x: dgrad(dy, g_dw);
        * for w: wgrad(g_dx, dy): the weight-gradient call with g_dx as
          its input.

        PyTorch's own rule (``_convolution_double_backward``) takes the
        last as a convolution of x's transpose [C, B, H, W] by dy's
        [O, B, H', W']: a filter as large as the feature map, for which
        cuDNN has only its legacy non-tensor-core kernels. Here every
        call is one that a first-order step makes, on ``channels_last``
        operands.
        Every call keeps the layer's stride, padding and dilation.
        Differentiable torch calls throughout, so a third order holds.
        """
        dy, x, w = ctx.saved_tensors
        stride, padding, dilation = ctx.config
        trace.count("conv.second_order")
        if dilation > 1:
            trace.count("conv.dilated_second_order")
        want_dy, want_x, want_w = _engine_wants(ctx, 3)
        want_x = want_x and g_dw is not None
        want_w = want_w and g_dx is not None
        if g_dx is not None and (want_dy or want_w):
            g_dx = _channels_last(g_dx)
        if want_x or want_w:
            dy = _channels_last(dy)
        g_dy = g_x = g_w = None
        if want_dy:
            if g_dx is not None:
                g_dy = F.conv2d(g_dx, w, stride=stride, padding=padding,
                                dilation=dilation)
            if g_dw is not None:
                term = F.conv2d(x, g_dw, stride=stride, padding=padding,
                                dilation=dilation)
                g_dy = term if g_dy is None else g_dy + term
            if g_db is not None:
                term = g_db.view(1, -1, 1, 1)
                g_dy = (term.expand_as(dy) if g_dy is None
                        else g_dy + term)
        if want_x:
            g_x = _conv_backward(dy, x, g_dw, stride, padding, dilation,
                                 [True, False, False])[0]
        if want_w:
            g_w = _conv_backward(dy, g_dx, w, stride, padding, dilation,
                                 [False, True, False])[1]
        return g_dy, g_x, g_w, None, None, None, None


class _ConvFwd(torch.autograd.Function):
    """(x, w, b) ↦ conv2d(x, w, b); its backward is :class:`_ConvBwd`,
    which asks for the gradients the engine will use, so it stays
    differentiable and first-order users make the calls they always
    made."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.config = (stride, padding, dilation)
        return F.conv2d(x, w, b, stride=stride, padding=padding,
                        dilation=dilation)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        mask = _engine_wants(ctx, 3)
        if torch.is_grad_enabled():  # create_graph: a second order may follow
            dx, dw, db = _ConvBwd.apply(_non_leaf(dy), x, w, *ctx.config,
                                        mask)
        else:
            dx, dw, db = _conv_backward(dy, x, w, *ctx.config, mask)
        return dx, dw, db, None, None, None


def conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
         stride: int, padding: Tuple[int, int],
         dilation: int = 1) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding, dilation)`` with the
    second order of :class:`_ConvBwd`. ``conv.second_order`` counts the
    runs of that second order (the gradient penalty's, one a layer
    between the interpolates and the features), of which
    ``conv.dilated_second_order`` those of a dilated layer."""
    if not torch.is_grad_enabled():
        return F.conv2d(x, weight, bias, stride=stride, padding=padding,
                        dilation=dilation)
    return _ConvFwd.apply(_non_leaf(x), _non_leaf(weight),
                          _non_leaf(bias), stride, padding, dilation)


trace.declare("conv.second_order")
trace.declare("conv.dilated_second_order")


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``padding="SAME"``: weight [out, in, k, k];
    ``dilation`` spaces the kernel's taps (flax's ``kernel_dilation``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, *, dtype: torch.dtype,
                 rng: torch.Generator, zero_init: bool = False,
                 bias_value: float = 0.0, dilation: int = 1):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.full((out_channels,),
                                            float(bias_value)))
        if not zero_init:
            lecun_normal_(self.weight, in_channels * kernel * kernel,
                          rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        (h_lo, h_hi), (w_lo, w_hi) = (
            same_padding(size, k, self.stride, self.dilation)
            for size in x.shape[-2:])
        x = x.to(self.dtype)
        if (h_lo, w_lo) == (h_hi, w_hi):
            padding = (h_lo, w_lo)
        else:
            x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
            padding = (0, 0)
        return conv(x, self.weight.to(self.dtype), self.bias.to(self.dtype),
                    self.stride, padding, self.dilation)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(k=4, strides=2, padding="SAME")``.

    weight is [in, out, 4, 4]: the flax kernel [4, 4, in, out] transposed
    and flipped in H and W (``srgan_tpu_torch.convert``).
    """

    def __init__(self, in_channels: int, out_channels: int, *,
                 dtype: torch.dtype, rng: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(in_channels, out_channels,
                                               4, 4))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        lecun_normal_(self.weight, in_channels * 16, rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype),
                                  self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=2,
                                  padding=1)


class Dense(nn.Module):
    """flax ``nn.Dense``: weight [out, in] (the flax kernel transposed)."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, rng: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        lecun_normal_(self.weight, in_features, rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NCHW: float32 single-pass statistics per
    (example, group), ε = 1e-6, output in the compute dtype."""

    def __init__(self, channels: int, num_groups: int, *,
                 dtype: torch.dtype, epsilon: float = 1e-6):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{channels} channels")
        self.num_groups = num_groups
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_nchw(x, self.scale, self.bias, self.num_groups,
                               self.epsilon, self.dtype)


def group_norm_nchw(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, groups: int, epsilon: float,
                    dtype: torch.dtype) -> torch.Tensor:
    """:class:`GroupNorm`'s computation with the given parameters."""
    b, c, h, w = x.shape
    g = groups
    # Splitting C into (G, C/G) is a view in either memory format.
    xf = x.float().reshape(b, g, c // g, h, w)
    axes = (2, 3, 4)
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf.square().mean(dim=axes, keepdim=True)
           - mean.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + epsilon) * scale.view(1, g, c // g, 1, 1)
    y = (xf - mean) * mul + bias.view(1, g, c // g, 1, 1)
    return y.reshape(b, c, h, w).to(dtype)


class FastGroupNorm(nn.Module):
    """JAX's ``FastGroupNorm`` over NCHW: the statistics in the compute
    dtype, not float32, and the two-pass variance mean((x − mean)²).

    The group count is JAX's: ``min(num_groups, channels)``, lowered until
    it divides the channels, resolved here once (tensor parallelism halves
    ``num_groups``). ε is 1e-5 rounded to the compute dtype, as JAX adds
    ``jnp.asarray(epsilon, dtype)``, and kept as a Python float: forward
    makes no tensor and reads none back, so it captures in a CUDA graph.
    """

    def __init__(self, channels: int, num_groups: int = 32, *,
                 dtype: torch.dtype, epsilon: float = 1e-5):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        self.num_groups = groups
        self.dtype = dtype
        self.epsilon = torch.tensor(epsilon, dtype=dtype).item()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fast_group_norm_nchw(x, self.scale, self.bias,
                                    self.num_groups, self.epsilon,
                                    self.dtype)


def fast_group_norm_nchw(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int, epsilon: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """:class:`FastGroupNorm`'s computation with the given parameters.

    Each elementwise step rounds to ``dtype``, and each mean sums in
    float32 and rounds once, as ``jnp.mean`` of a bfloat16 array does.
    The squares of the variance are float32: XLA leaves out the round
    trip through ``dtype`` between ``jnp.square`` and ``jnp.mean``'s
    float32 sum, and with them the port's output equals JAX's bit for bit
    (``tests/test_torch_port_fast_norm.py``)."""
    b, c, h, w = x.shape
    xg = x.to(dtype).reshape(b, groups, c // groups, h, w)
    axes = (2, 3, 4)
    mean = xg.mean(dim=axes, keepdim=True, dtype=torch.float32).to(dtype)
    centered = xg - mean
    var = centered.float().square().mean(dim=axes, keepdim=True).to(dtype)
    y = (centered * torch.rsqrt(var + epsilon)).reshape(b, c, h, w)
    return (y * scale.to(dtype).view(1, c, 1, 1)
            + bias.to(dtype).view(1, c, 1, 1))


def group_norm(width: int, dtype: torch.dtype, impl: str = "xla",
               max_groups: int = 32) -> nn.Module:
    """The model-wide norm layer of ``Settings.norm_impl``, with
    ``min(max_groups, width)`` groups: the composite :class:`GroupNorm`
    for ``"xla"``, :class:`FastGroupNorm` for ``"fast"``, the fused
    kernels' :class:`FusedGroupNormAct` for ``"pallas"``."""
    if impl == "pallas":
        return FusedGroupNormAct(width, min(max_groups, width))
    if impl == "fast":
        return FastGroupNorm(width, min(max_groups, width), dtype=dtype)
    if impl != "xla":
        raise ValueError(f"unknown norm_impl {impl!r}; "
                         f"choose from ['xla', 'fast', 'pallas']")
    return GroupNorm(width, min(max_groups, width), dtype=dtype)


def activation(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """LeakyReLU(``negative_slope``); slope 0 is ReLU."""
    return (F.leaky_relu(x, negative_slope) if negative_slope
            else F.relu(x))


def norm_act(x: torch.Tensor, norm: nn.Module,
             negative_slope: float = 0.0) -> torch.Tensor:
    """GroupNorm + LeakyReLU(``negative_slope``); slope 0 is ReLU.

    A norm of a tensor-parallel model (``parallel/tp.py``) runs through
    the hook that sharding set on it, which sees whether ``x`` is this
    rank's block of channels or all of them.
    """
    hook = getattr(norm, "model_shard_hook", None)
    if hook is not None:
        return hook(x, negative_slope)
    return run_norm_act(x, norm, negative_slope)


def run_norm_act(x: torch.Tensor, norm: nn.Module,
                 negative_slope: float = 0.0) -> torch.Tensor:
    """:func:`norm_act` of ``norm`` as it stands. A
    :class:`FusedGroupNormAct` applies the activation in its kernel,
    before the cast to the compute dtype; the composite :class:`GroupNorm`
    and :class:`FastGroupNorm` return the compute dtype, and the
    activation follows."""
    if isinstance(norm, FusedGroupNormAct):
        return norm(x, negative_slope)
    return activation(norm(x), negative_slope)


def gather_channels(module: nn.Module, x: torch.Tensor, channels: int,
                    dim: int = 1) -> torch.Tensor:
    """``x`` with all its ``channels`` along ``dim``: where a layer of a
    tensor-parallel model (``parallel/tp.py``) left this rank's block of
    them, the blocks gathered over the model axis; else ``x`` itself. A
    model calls it where it needs all channels of an activation."""
    axis = getattr(module, "model_axis", None)
    if axis is None or x.shape[dim] == channels:
        return x
    return axis.gather(x, dim)


def generator_geometry(image_size: int) -> Tuple[int, int, int]:
    """(seed side, number of doublings, side after the last doubling).

    A seed side that reaches ``image_size`` exactly by doubling (224 =
    7·2⁵) when the odd factor is at most 7; otherwise 4, doubled past the
    target and center-cropped.
    """
    if image_size % 8:
        raise ValueError(f"image_size {image_size} must be divisible by 8")
    start = image_size
    num_ups = 0
    while start % 2 == 0 and start > 7:
        start //= 2
        num_ups += 1
    if start > 7:
        start = 4
        num_ups = 0
        size = start
        while size < image_size:
            size *= 2
            num_ups += 1
    else:
        size = start * (2 ** num_ups)
    return start, num_ups, size


class DCGANGenerator(nn.Module):
    """z → image via stride-2 transposed convolutions; ``tanh``-bounded
    to [-1, 1]. Returns float32 NCHW in ``channels_last`` memory."""

    def __init__(self, image_size: int = 64, channels: int = 3,
                 base_width: int = 64, latent_dimension: int = 100, *,
                 dtype: torch.dtype = torch.float32, norm_impl: str = "xla",
                 rng: torch.Generator):
        super().__init__()
        self.image_size = image_size
        self.channels = channels
        self.dtype = dtype
        self.start, num_ups, self.size = generator_geometry(image_size)
        self.width = base_width * (2 ** (num_ups - 1))
        self.dense = Dense(latent_dimension,
                           self.start * self.start * self.width,
                           dtype=dtype, rng=rng)
        self.norms = nn.ModuleList([group_norm(self.width, dtype,
                                               norm_impl)])
        self.deconvs = nn.ModuleList()
        width = self.width
        for i in range(num_ups):
            out_width = (base_width * (2 ** (num_ups - 2 - i))
                         if i < num_ups - 1 else channels)
            self.deconvs.append(ConvTranspose(width, out_width, dtype=dtype,
                                              rng=rng))
            if i < num_ups - 1:
                self.norms.append(group_norm(out_width, dtype, norm_impl))
            width = out_width

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        # Under tensor parallelism the Dense's (h, w, c) features are
        # sharded in blocks of rows, not of channels: gathered first.
        x = gather_channels(self, self.dense(z),
                            self.start * self.start * self.width, dim=-1)
        # The flax Dense output is reshaped NHWC; the permute makes it NCHW
        # in channels_last memory without a copy.
        x = x.view(x.shape[0], self.start, self.start,
                   self.width).permute(0, 3, 1, 2)
        x = norm_act(x, self.norms[0])
        for i, deconv in enumerate(self.deconvs):
            x = deconv(x)
            if i + 1 < len(self.norms):
                x = norm_act(x, self.norms[i + 1])
        x = gather_channels(self, x, self.channels)
        if self.size != self.image_size:
            m = (self.size - self.image_size) // 2
            x = x[:, :, m:m + self.image_size, m:m + self.image_size]
        return torch.tanh(x).float()


def regressor_widths(image_size: int, base_width: int) -> List[int]:
    """The conv widths of a :class:`ConvRegressor`: one k4 s2 stage per
    halving of ``image_size`` down to 4 (counted as JAX counts it, by
    floor halving), ``base_width · 2^min(i, 3)``."""
    n_down = 0
    size = image_size
    while size > 4:
        size //= 2
        n_down += 1
    return [base_width * (2 ** min(i, 3)) for i in range(n_down)]


class ConvRegressor(nn.Module):
    """Image → (scalar regression [B], features): k4 s2 ``SAME`` convs
    (:func:`regressor_widths`), each followed by GroupNorm +
    LeakyReLU(0.2), then ``Dense(feature_size)`` + LeakyReLU(0.2) (the
    features) and ``Dense(1)``. Both outputs float32.

    Input [B, ``channels``, ``image_size``, ``image_size``]. The flatten
    before the dense layers is in NHWC order, as the JAX model's: then
    ``Dense_0``'s rows are the flax kernel's, and on ``channels_last``
    memory the flatten is a view.
    """

    def __init__(self, image_size: int = 64, channels: int = 3,
                 base_width: int = 64, feature_size: int = 1024, *,
                 dtype: torch.dtype = torch.float32, norm_impl: str = "xla",
                 rng: torch.Generator):
        super().__init__()
        widths = regressor_widths(image_size, base_width)
        self.convs = nn.ModuleList(
            Conv(cin, cout, 4, 2, dtype=dtype, rng=rng)
            for cin, cout in zip([channels] + widths, widths))
        self.norms = nn.ModuleList(group_norm(w, dtype, norm_impl)
                                   for w in widths)
        self.widths = widths
        self.feature_size = feature_size
        side = image_size
        for _ in widths:
            side = -(-side // 2)  # SAME, stride 2
        self.dense = Dense(side * side * widths[-1], feature_size,
                           dtype=dtype, rng=rng)
        self.head = Dense(feature_size, 1, dtype=dtype, rng=rng)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = images
        for conv, norm in zip(self.convs, self.norms):
            x = norm_act(conv(x), norm, negative_slope=0.2)
        x = gather_channels(self, x, self.widths[-1])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        features = gather_channels(self, F.leaky_relu(self.dense(x), 0.2),
                                   self.feature_size, dim=-1)
        return self.head(features).squeeze(-1).float(), features.float()
