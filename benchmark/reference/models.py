"""The SR-GAN models as plain functions of a dict of weights, in float32.

Tensors are NCHW. Weights are named and laid out as the benchmark makes
them for both sides (``<layer>.weight``, ``<layer>.bias``, a norm's
``scale`` and ``bias``; a convolution's kernel ``[out, in, k, k]``, a
transposed convolution's ``[in, out, 4, 4]`` in the form that
``conv_transpose2d`` takes, a dense kernel ``[out, in]``).

* Convolutions pad ``SAME`` as the published models (TensorFlow/flax)
  do: a stride-2 layer on an even input pads the bottom and right only.
* GroupNorm: min(32, C) groups (lowered until they divide C), statistics
  over each example's group, ε = 1e-6.
* JointCNN (the crowd D and DNN): 3×3 convolutions of widths w, 2w at
  stride 2, then 4w, 4w at stride 1, each GroupNorm + LeakyReLU(0.2);
  1×1 density and count heads at 1/4 resolution; features the globally
  pooled trunk.
* DCGAN generator: Dense to a 7×7 (or 4×4) seed, GroupNorm + ReLU, 4×4
  stride-2 transposed convolutions halving the width, GroupNorm + ReLU
  between them, a centre crop to the image size and tanh.

``q`` rounds every input and weight of a convolution or dense layer, and
the gradient that flows back into its output (the control's lower
precision, ``quant.py``); the default leaves them float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.quant import EXACT, Rounding

Tensor = torch.Tensor
Weights = Dict[str, Tensor]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x: Tensor, w: Tensor, b: Tensor, stride: int = 1,
         q: Rounding = EXACT) -> Tensor:
    k = w.shape[-1]
    h_lo, h_hi = same_padding(x.shape[-2], k, stride)
    w_lo, w_hi = same_padding(x.shape[-1], k, stride)
    x = F.pad(q(x), (w_lo, w_hi, h_lo, h_hi))
    return q.out(F.conv2d(x, q(w), b, stride=stride))


def conv_transpose(x: Tensor, w: Tensor, b: Tensor,
                   q: Rounding = EXACT) -> Tensor:
    """4×4 stride-2 ``SAME``: twice the input's side."""
    return q.out(F.conv_transpose2d(q(x), q(w), b, stride=2, padding=1))


def dense(x: Tensor, w: Tensor, b: Tensor, q: Rounding = EXACT
          ) -> Tensor:
    return q.out(F.linear(q(x), q(w), b))


def groups_for(channels: int, most: int = 32) -> int:
    groups = min(most, channels)
    while channels % groups:
        groups -= 1
    return groups


def group_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-6) -> Tensor:
    b, c, h, w = x.shape
    g = groups_for(c)
    xg = x.reshape(b, g, c // g, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return y * scale.view(1, c, 1, 1) + bias.view(1, c, 1, 1)


def _norm_act(p: Weights, name: str, x: Tensor, slope: float) -> Tensor:
    x = group_norm(x, p[f"{name}.scale"], p[f"{name}.bias"])
    return F.leaky_relu(x, slope) if slope else F.relu(x)


# ------------------------------------------------------------------ crowd
def joint_cnn_widths(base: int) -> Tuple[List[int], List[int]]:
    """(widths, strides) of JointCNN's trunk."""
    return [base, 2 * base, 4 * base, 4 * base], [2, 2, 1, 1]


def joint_cnn_shapes(base: int) -> Dict[str, tuple]:
    widths, _ = joint_cnn_widths(base)
    shapes = {}
    for i, (cin, cout) in enumerate(zip([3] + widths, widths)):
        shapes[f"convs.{i}.weight"] = (cout, cin, 3, 3)
        shapes[f"convs.{i}.bias"] = (cout,)
        shapes[f"norms.{i}.scale"] = (cout,)
        shapes[f"norms.{i}.bias"] = (cout,)
    for head in ("density_head", "count_head"):
        shapes[f"{head}.weight"] = (1, widths[-1], 1, 1)
        shapes[f"{head}.bias"] = (1,)
    return shapes


def joint_cnn(p: Weights, x: Tensor, q: Rounding = EXACT):
    """Patches [B, 3, P, P] → ((density [B, P/4, P/4], count [B, P/4,
    P/4]), features [B, 4w])."""
    widths, strides = joint_cnn_widths(p["convs.0.weight"].shape[0])
    for i, stride in enumerate(strides):
        x = conv(x, p[f"convs.{i}.weight"], p[f"convs.{i}.bias"], stride, q)
        x = _norm_act(p, f"norms.{i}", x, 0.2)
    density = conv(x, p["density_head.weight"], p["density_head.bias"],
                   1, q).squeeze(1)
    count = conv(x, p["count_head.weight"], p["count_head.bias"],
                 1, q).squeeze(1)
    return (density, count), x.mean(dim=(2, 3))


def crowd_labeled_loss(predictions, labels: Tensor) -> Tensor:
    """Density-map loss against the 4×4 sum-pooled label patches plus the
    count loss against each patch's total."""
    density, count = predictions
    b, h, w = labels.shape
    target = labels.reshape(b, h // 4, 4, w // 4, 4).sum(dim=(2, 4))
    map_loss = (density - target).square().mean()
    count_loss = (count.sum(dim=(1, 2))
                  - labels.sum(dim=(1, 2))).square().mean()
    return map_loss + count_loss


# -------------------------------------------------------------- generator
def generator_geometry(image_size: int) -> Tuple[int, int, int]:
    """(seed side, doublings, side after them): 7·2^k when the odd factor
    of the size is at most 7, else 4 doubled past it (then cropped)."""
    start, ups = image_size, 0
    while start % 2 == 0 and start > 7:
        start //= 2
        ups += 1
    if start > 7:
        start, ups, size = 4, 0, 4
        while size < image_size:
            size *= 2
            ups += 1
        return start, ups, size
    return start, ups, start * 2 ** ups


def generator_shapes(image_size: int, base: int, latent: int,
                     channels: int = 3) -> Dict[str, tuple]:
    start, ups, _ = generator_geometry(image_size)
    width = base * 2 ** (ups - 1)
    shapes = {"dense.weight": (start * start * width, latent),
              "dense.bias": (start * start * width,),
              "norms.0.scale": (width,), "norms.0.bias": (width,)}
    for i in range(ups):
        out = base * 2 ** (ups - 2 - i) if i < ups - 1 else channels
        shapes[f"deconvs.{i}.weight"] = (width, out, 4, 4)
        shapes[f"deconvs.{i}.bias"] = (out,)
        if i < ups - 1:
            shapes[f"norms.{i + 1}.scale"] = (out,)
            shapes[f"norms.{i + 1}.bias"] = (out,)
        width = out
    return shapes


def generator(p: Weights, z: Tensor, image_size: int,
              q: Rounding = EXACT) -> Tensor:
    """z [B, latent] → images [B, 3, S, S] in [-1, 1]."""
    start, ups, size = generator_geometry(image_size)
    width = p["norms.0.scale"].shape[0]
    x = dense(z, p["dense.weight"], p["dense.bias"], q)
    x = x.view(z.shape[0], start, start, width).permute(0, 3, 1, 2)
    x = _norm_act(p, "norms.0", x, 0.0)
    for i in range(ups):
        x = conv_transpose(x, p[f"deconvs.{i}.weight"],
                           p[f"deconvs.{i}.bias"], q)
        if i < ups - 1:
            x = _norm_act(p, f"norms.{i + 1}", x, 0.0)
    if size != image_size:
        m = (size - image_size) // 2
        x = x[:, :, m:m + image_size, m:m + image_size]
    return torch.tanh(x)
