"""CSRNet as a plain function of a dict of weights, in float32, with the
crowd loss at its 1/8 resolution.

Li, Zhang and Chen, "CSRNet: Dilated Convolutional Neural Networks for
Understanding the Highly Congested Scenes", CVPR 2018 (arXiv:1802.10062),
and the authors' ``model.py`` (github.com/leeyeehoo/CSRNet-pytorch):

* frontend: VGG-16's first ten 3×3 convolutions, padding 1, each with a
  ReLU, ``[64, 64, M, 128, 128, M, 256, 256, 256, M, 512, 512, 512]``,
  ``M`` a 2×2 max-pool of stride 2;
* backend (configuration B): ``[512, 512, 512, 256, 128, 64]``, 3×3
  convolutions of dilation 2 and padding 2, each with a ReLU;
* output: a 1×1 convolution to one channel, the density map at 1/8 of
  the input's side.

Departures from the paper, the same in the program:

* two heads: 1×1 convolutions to a density map and to a count map, both
  on the last backend layer, where the paper has one output;
* features (for the SR-GAN's feature matching and contrasting): the
  global mean of the last backend layer, 64 channels;
* initialisation: the benchmark's LeCun-normal draw for every kernel and
  zero biases (``harness/weights.py``), the heads' kernels zero and their
  biases the dataset-mean cell, in place of ImageNet VGG-16 weights in
  the frontend and N(0, 0.01) in the backend; no pretrained weights;
* widths scaled by ``base / 64`` for the CPU tests' tiny size (64: the
  published widths).

Weights are named ``frontend.<i>``, ``backend.<i>``, ``density_head``
and ``count_head`` (``.weight`` [out, in, k, k], ``.bias``), ``i``
counting convolutions only. ``q`` rounds every input and weight of a
convolution and the gradient that flows back into its output, as in
``models.py`` (the control's lower precision). The products run in
float32 with TF32 off, as in the rest of ``reference/``: the process's
``torch.backends`` flags, which the program's set-up clears.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.quant import EXACT, Rounding

Tensor = torch.Tensor
Weights = Dict[str, Tensor]

FRONTEND = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)
BACKEND = (512, 512, 512, 256, 128, 64)
OUTPUT_STRIDE = 8


def widths(base: int) -> Tuple[List, List[int]]:
    """(frontend, backend) at base width ``base``: the published widths
    times ``base / 64``; ``"M"`` the frontend's pools."""
    scale = lambda c: c * base // 64  # noqa: E731
    return ([c if c == "M" else scale(c) for c in FRONTEND],
            [scale(c) for c in BACKEND])


def csrnet_shapes(base: int) -> Dict[str, tuple]:
    front, back = widths(base)
    shapes, cin = {}, 3
    convs = [c for c in front if c != "M"]
    for part, outs in (("frontend", convs), ("backend", back)):
        for i, cout in enumerate(outs):
            shapes[f"{part}.{i}.weight"] = (cout, cin, 3, 3)
            shapes[f"{part}.{i}.bias"] = (cout,)
            cin = cout
    for head in ("density_head", "count_head"):
        shapes[f"{head}.weight"] = (1, cin, 1, 1)
        shapes[f"{head}.bias"] = (1,)
    return shapes


def _conv(x: Tensor, p: Weights, name: str, q: Rounding, padding: int = 0,
          dilation: int = 1) -> Tensor:
    return q.out(F.conv2d(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"],
                          padding=padding, dilation=dilation))


def csrnet(p: Weights, x: Tensor, q: Rounding = EXACT):
    """Patches [B, 3, P, P] → ((density [B, P/8, P/8], count [B, P/8,
    P/8]), features [B, 64·base/64])."""
    i = 0
    for item in FRONTEND:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = F.relu(_conv(x, p, f"frontend.{i}", q, padding=1))
        i += 1
    for j in range(len(BACKEND)):
        x = F.relu(_conv(x, p, f"backend.{j}", q, padding=2, dilation=2))
    density = _conv(x, p, "density_head", q).squeeze(1)
    count = _conv(x, p, "count_head", q).squeeze(1)
    return (density, count), x.mean(dim=(2, 3))


def labeled_loss(predictions, labels: Tensor) -> Tensor:
    """Density-map loss against the 8×8 sum-pooled label patches plus the
    count loss against each patch's total."""
    density, count = predictions
    b, h, w = labels.shape
    f = OUTPUT_STRIDE
    target = labels.reshape(b, h // f, f, w // f, f).sum(dim=(2, 4))
    map_loss = (density - target).square().mean()
    count_loss = (count.sum(dim=(1, 2))
                  - labels.sum(dim=(1, 2))).square().mean()
    return map_loss + count_loss
