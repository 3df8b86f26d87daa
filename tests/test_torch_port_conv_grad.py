"""The second order of the port's convolution (``models/dcgan.py``
``conv``: ``_ConvFwd`` / ``_ConvBwd``) on the CPU.

* In float64 the rule's gradients of a gradient penalty (the weight's,
  the bias's, and those of the input side: a parameter before the
  convolution and the input) match autograd's own double backward of
  ``F.conv2d`` at rtol 1e-10, over the strides and paddings the models
  use, dilation 1 and 2 (CSRNet's backend) at stride 1 and 2, a zero and
  a non-zero bias, ``channels_last`` and contiguous
  inputs, and a penalty on the input's gradient, on the input's and the
  weight's, and on the bias's alone.
* ``gradgradcheck`` holds the rule to finite differences.
* A dispatch log of one JointCNN penalty step (float32, tiny width):
  no convolution takes a filter as large as its feature map, and the
  backward asks cuDNN only for the gradients the engine uses.
* ``conv.second_order`` counts 4 a crowd SR-GAN step (the JointCNN
  trunk's four convolutions) and 0 a DNN-only step.
* At dilation 1 the rule's calls are those it made before it took a
  dilation: the first order is autograd's own ``convolution_backward``
  call, and every call passes dilation [1, 1]; at dilation 2 every call
  passes [2, 2].
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.models.crowd import JointCNN
from srgan_tpu_torch.models.dcgan import Conv, same_padding
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state
from srgan_tpu_torch.utils import trace

RTOL = 1e-10
# (kernel, stride, input side, dilation): stride 1 with (1, 1) padding;
# the JointCNN's stride-2 3×3 on an even map, SAME's (0, 1) by F.pad; the
# ConvRegressor's 4×4 stride 2; CSRNet's dilated 3×3 at stride 1 (SAME's
# (2, 2)) and a dilated 3×3 at stride 2 (SAME's (1, 2) by F.pad).
GEOMETRIES = {"k3s1": (3, 1, 9, 1), "k3s2_pad01": (3, 2, 10, 1),
              "k4s2": (4, 2, 10, 1), "k3s1_d2": (3, 1, 9, 2),
              "k3s2_d2": (3, 2, 10, 2)}
# The gradients the penalty is taken of: the input's (the SR-GAN's), also
# the weight's (so the second order's dw cotangent is defined), and the
# bias's alone (only its db cotangent).
PENALTIES = {"input": ("x",), "input_weight": ("x", "weight"),
             "bias": ("bias",)}
CASES = [(g, bias, layout, penalty)
         for g in GEOMETRIES
         for bias in ("zero", "nonzero")
         for layout in ("channels_last", "contiguous")
         for penalty in PENALTIES]
CROWD = dict(batch_size=2, labeled_dataset_size=4, unlabeled_dataset_size=4,
             validation_dataset_size=2, test_dataset_size=2,
             crowd_image_height=40, crowd_image_width=40,
             image_patch_size=32, crowd_sigma=3.0,
             crowd_synthetic_max_heads=4, model_base_width=4,
             latent_dimension=8, seed=5)


def _native_conv(m: Conv, x):
    """``Conv.forward`` with autograd's own ``F.conv2d``."""
    k = m.weight.shape[-1]
    (h_lo, h_hi), (w_lo, w_hi) = (same_padding(s, k, m.stride, m.dilation)
                                  for s in x.shape[-2:])
    if (h_lo, w_lo) == (h_hi, w_hi):
        return F.conv2d(x, m.weight, m.bias, stride=m.stride,
                        padding=(h_lo, w_lo), dilation=m.dilation)
    return F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)), m.weight, m.bias,
                    stride=m.stride, dilation=m.dilation)


@pytest.mark.parametrize("geometry,bias,layout,penalty", CASES)
def test_penalty_gradients_match_autograds_double_backward(
        geometry, bias, layout, penalty):
    kernel, stride, side, dilation = GEOMETRIES[geometry]
    gen = torch.Generator().manual_seed(7)
    m = Conv(3, 5, kernel, stride, dtype=torch.float64, rng=gen,
             dilation=dilation).double()
    if bias == "nonzero":
        with torch.no_grad():
            m.bias.normal_(generator=gen)
    scale = torch.randn(3, dtype=torch.float64, generator=gen,
                        requires_grad=True)
    x0 = torch.randn(2, 3, side, side, dtype=torch.float64, generator=gen)
    if layout == "channels_last":
        x0 = x0.contiguous(memory_format=torch.channels_last)
    x0.requires_grad_(True)
    target = torch.randn(2, 5, -(-side // stride), -(-side // stride),
                         dtype=torch.float64, generator=gen)

    def penalty_grads(layer):
        # A parameter before the convolution and a nonlinearity after
        # it, so that every term of the second order is used.
        a = torch.tanh(x0 * scale.view(1, -1, 1, 1))
        out = (torch.tanh(layer(m, a)) * target).square().sum()
        named = {"x": x0, "weight": m.weight, "bias": m.bias}
        wrt = [named[n] for n in PENALTIES[penalty]]
        grads = torch.autograd.grad(out, wrt, create_graph=True)
        gp = sum(g.square().sum() for g in grads)
        return torch.autograd.grad(gp, [m.weight, m.bias, scale, x0])

    names = ("conv.second_order", "conv.dilated_second_order")
    before = [trace.counters()[n] for n in names]
    got = penalty_grads(Conv.forward)
    assert [trace.counters()[n] for n in names] == [
        before[0] + 1, before[1] + (dilation > 1)]
    want = penalty_grads(_native_conv)
    for name, g, w in zip(["weight", "bias", "scale", "input"], got, want):
        torch.testing.assert_close(g, w, rtol=RTOL,
                                   atol=RTOL * w.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_second_order_passes_gradgradcheck(geometry):
    kernel, stride, _, dilation = GEOMETRIES[geometry]
    gen = torch.Generator().manual_seed(3)
    m = Conv(2, 3, kernel, stride, dtype=torch.float64, rng=gen,
             dilation=dilation).double()
    x = torch.randn(1, 2, 6, 6, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = m.weight.detach().clone().requires_grad_(True)
    b = torch.randn(3, dtype=torch.float64, generator=gen,
                    requires_grad=True)

    def f(x, w, b):
        return torch.tanh(torch.func.functional_call(
            m, {"weight": w, "bias": b}, (x,)))

    assert torch.autograd.gradgradcheck(f, (x, w, b))


class _ConvLog(TorchDispatchMode):
    """The aten convolution calls made under it, with their arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.convolution.default,
                    torch.ops.aten.convolution_backward.default):
            self.calls.append((func, args))
        return func(*args, **(kwargs or {}))

    def of(self, func):
        return [args for f, args in self.calls if f is func]


def _crowd(tmp_path, **over):
    exp = CrowdExperiment(Settings(**dict(CROWD, **over),
                                   logs_directory=str(tmp_path)),
                          device="cpu")
    exp.dataset_setup()
    exp.models = exp.model_setup()
    exp.state = init_train_state(exp.settings, exp.models)
    exp.prepare_train_step()
    return exp


@pytest.mark.parametrize("norm_impl", ["xla", "pallas"])
def test_a_penalty_step_takes_no_full_map_filter(tmp_path, norm_impl):
    exp = _crowd(tmp_path, norm_impl=norm_impl)
    batch = next(next(exp.epoch_batch_iterators()))
    log = _ConvLog()
    before = trace.counters()["conv.second_order"]
    with log:
        exp.state, _ = exp._step(*batch)
    convs = log.of(torch.ops.aten.convolution.default)
    assert convs
    for args in convs:
        x, w = args[0], args[1]
        assert max(w.shape[-2:]) <= 4, (tuple(x.shape), tuple(w.shape))
    assert log.of(torch.ops.aten.convolution_backward.default)
    assert trace.counters()["conv.second_order"] - before == 4


def test_the_backward_asks_only_for_the_gradients_the_engine_uses():
    gen = torch.Generator().manual_seed(1)
    d = JointCNN(4, rng=gen)
    x = torch.randn(2, 3, 32, 32, generator=gen).contiguous(
        memory_format=torch.channels_last)

    def masks(wrt, inputs_need_grad):
        xi = x.clone().requires_grad_(inputs_need_grad)
        (density, count), features = d(xi)
        loss = density.sum() + count.sum() + features.square().sum()
        log = _ConvLog()
        with log:
            torch.autograd.grad(loss, wrt(xi))
        return [(args[1].shape[1], list(args[-1])) for args in
                log.of(torch.ops.aten.convolution_backward.default)]

    # With respect to the input: no weight or bias gradient anywhere (the
    # trunk's four layers and the two heads).
    by_input = masks(lambda xi: [xi], True)
    assert len(by_input) == 6 and all(m == [True, False, False]
                                      for _, m in by_input)
    # With respect to the weights (the input needs none): no input
    # gradient of the first layer, whose input is the image.
    params = list(d.parameters())
    by_weights = masks(lambda xi: params, False)
    assert len(by_weights) == 6
    assert all(m[1] and m[2] for _, m in by_weights)
    assert [m[0] for c, m in by_weights if c == 3] == [False]
    # One layer's weight alone.
    layer = d.convs[2]
    only = masks(lambda xi: [layer.weight], True)
    assert [m for c, m in only if c == layer.weight.shape[1]] == [
        [False, True, False]]


def test_a_dnn_only_step_runs_no_second_order(tmp_path):
    exp = _crowd(tmp_path, dnn_only=True)
    batch = next(next(exp.epoch_batch_iterators()))
    before = trace.counters()["conv.second_order"]
    exp.state, _ = exp._step(*batch)
    assert trace.counters()["conv.second_order"] == before


@pytest.mark.parametrize("dilation", [1, 2])
def test_every_call_keeps_the_layers_dilation(dilation):
    """A penalty through one layer: the first order makes the call that
    autograd's own ``ConvolutionBackward0`` makes for ``F.conv2d`` (the
    same arguments but for the mask, which the rule narrows to what the
    engine uses), and every convolution of the first and second order
    passes the layer's dilation; at dilation 1, [1, 1] as before."""
    gen = torch.Generator().manual_seed(11)
    m = Conv(3, 4, 3, 1, dtype=torch.float64, rng=gen,
             dilation=dilation).double()
    x = torch.randn(2, 3, 9, 9, dtype=torch.float64, generator=gen,
                    requires_grad=True)

    def first_order(layer):
        log = _ConvLog()
        with log:
            out = torch.tanh(layer(m, x)).square().sum()
            (g,) = torch.autograd.grad(out, x, create_graph=True)
        return log, g

    ours, g = first_order(Conv.forward)
    native, _ = first_order(_native_conv)
    key = lambda args: [tuple(a.shape) if torch.is_tensor(a) else a  # noqa
                        for a in args[:-1]]
    ours_bwd = ours.of(torch.ops.aten.convolution_backward.default)
    assert [key(a) for a in ours_bwd] == [
        key(a) for a in native.of(torch.ops.aten.convolution_backward.default)]
    log = _ConvLog()
    with log:
        torch.autograd.grad(g.square().sum(), [m.weight, m.bias])
    calls = ours.calls + log.calls
    assert log.of(torch.ops.aten.convolution_backward.default)
    for func, args in calls:
        at = 5 if func is torch.ops.aten.convolution.default else 6
        assert list(args[at]) == [dilation, dilation], (func, args[at])
