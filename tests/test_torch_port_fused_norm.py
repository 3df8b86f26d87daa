"""The port's fused GroupNorm + activation against ``srgan_tpu.ops.fused_norm``.

The same NumPy inputs go through the JAX functions (the Pallas kernels in
interpret mode on the CPU, as ``tests/test_fused_norm.py`` runs them) and
through the port, whose autograd Functions take the plain versions on CPU
tensors. float32 unless stated. Tolerances, each from the JAX package's
own test of the same quantity where it has one:

* plain vs ``_reference_fwd`` / ``_reference_bwd``: rtol 2e-5, with an
  absolute term of 2e-5 × the tensor's largest magnitude for elements
  near zero (sums in another order);
* forward and first-order gradients through the Functions: rtol 5e-4,
  atol 1e-5;
* the gradient penalty's second order: value rtol 1e-4, gradient rtol
  1e-3, atol 1e-6;
* a bfloat16 forward against the float32 plain version: 0.05;
* the second order's closed form against ``torch.func.vjp`` of the
  composite: float64 rtol 1e-9 (the same algebra, rounded otherwise);
  bfloat16 inputs (float32 inside both, outputs in bfloat16): g_dy one
  bfloat16 ulp (2⁻⁷) of each element plus 1e-5 of the largest, g_x the
  same plus 4e-3 of the largest (the composite's own float32 rounding:
  its g_x strays up to 1.9e-3 of the largest from float64 where the
  closed form stays within a bfloat16 ulp, in 120 draws of these
  shapes), g_scale within 1e-5 of its largest.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.models.crowd import CrowdDCGenerator as JaxGenerator
from srgan_tpu.models.crowd import JointCNN as JaxJointCNN
from srgan_tpu.ops import fused_norm as jfn
from srgan_tpu_torch import convert
from srgan_tpu_torch.models.crowd import CrowdDCGenerator, JointCNN
from srgan_tpu_torch.ops import fused_norm as fn
from srgan_tpu_torch.utils.seeding import generator_for

# Shape families of tests/test_fused_norm.py, and G's first stage
# (1024 channels in 32 groups: 32 channels per group).
SHAPES = [
    ((2, 8, 8, 64), 32, 0.2),
    ((3, 4, 4, 128), 32, 0.2),
    ((2, 16, 256), 32, 0.0),
    ((2, 8, 8, 8), 4, 0.2),
    ((2, 7, 7, 1024), 32, 0.0),
]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(0, 1, c)).astype(np.float32)
    bias = (0.1 * rng.normal(0, 1, c)).astype(np.float32)
    return x, scale, bias


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC (or [B, L, C]) NumPy → NCHW torch in channels_last memory."""
    if x.ndim == 3:
        x = x[:, :, None, :]
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor, shape) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).reshape(shape).float().numpy()


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("shape,groups,slope", SHAPES)
def test_plain_versions_match_the_jax_references(shape, groups, slope):
    x, scale, bias = _inputs(shape, 0)
    b, c = shape[0], shape[-1]
    x3 = x.reshape(b, -1, c)
    dy = np.random.default_rng(1).normal(0, 1, x3.shape).astype(np.float32)
    j_y, j_mean, j_rstd = jfn._reference_fwd(
        jnp.asarray(x3), jnp.asarray(scale), jnp.asarray(bias), groups,
        slope, 1e-6)
    t = torch.from_numpy
    y, mean, rstd = fn.group_norm_act_fwd_plain(t(x3), t(scale), t(bias),
                                                groups, slope, 1e-6)
    for got, want in ((y, j_y), (mean, j_mean), (rstd, j_rstd)):
        _close(got.numpy(), want, 2e-5)
    j_grads = jfn._reference_bwd(jnp.asarray(x3), jnp.asarray(scale),
                                 jnp.asarray(bias), j_mean, j_rstd,
                                 jnp.asarray(dy), groups, slope)
    grads = fn.group_norm_act_bwd_plain(
        t(x3), t(scale), t(bias), t(np.array(j_mean)),
        t(np.array(j_rstd)), t(dy), groups, slope)
    for got, want in zip(grads, j_grads):
        _close(got.numpy(), want, 2e-5)


@pytest.mark.parametrize("shape,slope", [((2, 6, 6, 64), 0.2),
                                         ((2, 4, 4, 128), 0.0)])
def test_forward_and_first_order_grads_match_jax(shape, slope):
    x, scale, bias = _inputs(shape, 2)

    def j_loss(x, s, b):
        return jnp.sum(jnp.sin(jfn.group_norm_act(x, s, b, groups=32,
                                                  negative_slope=slope)))

    j_y = jfn.group_norm_act(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(bias), groups=32,
                             negative_slope=slope)
    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    tx = _nchw(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    y = fn.group_norm_act(tx, ts, tb, groups=32, negative_slope=slope)
    grads = torch.autograd.grad(y.sin().sum(), (tx, ts, tb))
    np.testing.assert_allclose(_nhwc(y, shape), np.asarray(j_y), rtol=5e-4,
                               atol=1e-5)
    got = (_nhwc(grads[0], shape), grads[1].numpy(), grads[2].numpy())
    for g, w in zip(got, j_grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=5e-4, atol=1e-5)


def test_gradient_penalty_second_order_matches_jax():
    """∂/∂scale of mean((‖∂/∂x Σ y²‖ − 1)²), the derivative the gradient
    penalty takes (tests/test_fused_norm.py)."""
    shape = (2, 4, 4, 64)
    x, scale, bias = _inputs(shape, 3)

    def j_gp(s):
        def inner(xi):
            return jnp.sum(jfn.group_norm_act(xi, s, jnp.asarray(bias),
                                              groups=32,
                                              negative_slope=0.2) ** 2)
        g = jax.grad(inner)(jnp.asarray(x))
        norms = jnp.sqrt(jnp.sum(g.reshape(g.shape[0], -1) ** 2, axis=1)
                         + 1e-12)
        return jnp.mean((norms - 1.0) ** 2)

    want_v, want_g = jax.value_and_grad(j_gp)(jnp.asarray(scale))

    ts = torch.from_numpy(scale).requires_grad_()
    tx = _nchw(x).requires_grad_()
    y = fn.group_norm_act(tx, ts, torch.from_numpy(bias), groups=32,
                          negative_slope=0.2)
    (g,) = torch.autograd.grad(y.square().sum(), tx, create_graph=True)
    norms = (g.flatten(1).square().sum(1) + 1e-12).sqrt()
    gp = (norms - 1.0).square().mean()
    (got_g,) = torch.autograd.grad(gp, ts)
    np.testing.assert_allclose(float(gp.detach()), float(want_v), rtol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-3,
                               atol=1e-6)


def _composite_second_order(x, scale, bias, dy, cotangents, groups, slope,
                            eps=1e-6):
    """``torch.func.vjp`` of the backward map, mean and rstd recomputed
    from x: the composite the closed form stands for."""
    def whole(x, scale, bias, dy):
        mean, rstd = fn._group_stats(x, groups, eps)
        return fn.group_norm_act_bwd_plain(x, scale, bias, mean, rstd, dy,
                                           groups, slope)

    _, vjp = torch.func.vjp(whole, x, scale, bias, dy)
    return vjp(cotangents)


@pytest.mark.parametrize("zero_params", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("groups,channels", [(1, 64), (4, 64), (32, 64),
                                             (1, 96), (4, 96), (32, 96)])
@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_second_order_closed_form_matches_the_composite_vjp(
        slope, groups, channels, dtype, zero_params):
    """(g_x, g_scale, g_bias, g_dy) of ``group_norm_act_bwd_vjp_plain``
    against ``torch.func.vjp`` of ``group_norm_act_bwd_plain``, the
    penalty's cotangents (zero g_dscale and g_dbias) and nonzero ones."""
    gen = torch.Generator().manual_seed(groups * channels)
    shape = (2, 12, channels)
    wide = torch.float64 if dtype == torch.float64 else torch.float32

    def draw(size, scale=1.0, shift=0.0, to=dtype):
        return (shift + scale * torch.randn(size, generator=gen,
                                            dtype=torch.float64)).to(to)

    x, dy, g_dx = draw(shape, shift=0.5), draw(shape), draw(shape)
    scale, bias = draw(channels, 0.1, 1.0, wide), draw(channels, 0.1, 0.0, wide)
    g_dscale, g_dbias = ((torch.zeros(channels, dtype=wide),) * 2
                         if zero_params else
                         (draw(channels, to=wide), draw(channels, to=wide)))
    mean, rstd = fn._group_stats(x, groups, 1e-6)
    got = fn.group_norm_act_bwd_vjp_plain(x, scale, bias, mean, rstd, dy,
                                          g_dx, g_dscale, g_dbias, groups,
                                          slope)
    want = _composite_second_order(x, scale, bias, dy,
                                   (g_dx, g_dscale, g_dbias), groups, slope)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    assert not got[2].any()
    if dtype == torch.float64:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-9,
                                       atol=1e-12 * float(w.abs().max()))
        return
    for g, w, atol in (got[0], want[0], 4e-3), (got[3], want[3], 1e-5):
        w = w.float()
        bound = 2 ** -7 * w.abs() + atol * float(w.abs().max())
        assert bool(((g.float() - w).abs() <= bound).all())
    _close(got[1].numpy(), want[1].numpy(), 1e-5)


def test_second_order_on_the_cpu_runs_the_closed_form(monkeypatch):
    """The penalty's outer gradient through ``group_norm_act`` on CPU
    tensors calls ``group_norm_act_bwd_vjp_plain`` once, launches no
    kernel, and copies (and counts) a cotangent of dx that is not
    contiguous."""
    calls = []

    def spy(*args):
        calls.append(args[6].is_contiguous())
        return closed_form(*args)

    closed_form = fn.group_norm_act_bwd_vjp_plain
    monkeypatch.setattr(fn, "group_norm_act_bwd_vjp_plain", spy)
    launches = (fn._launch_fwd.launches, fn._launch_bwd.launches,
                fn._launch_second_order.launches)
    x, scale, bias = _inputs((2, 4, 4, 64), 6)
    ts = torch.from_numpy(scale).requires_grad_()
    tx = _nchw(x).requires_grad_()
    y = fn.group_norm_act(tx, ts, torch.from_numpy(bias), groups=32,
                          negative_slope=0.2)
    (g,) = torch.autograd.grad(y.square().sum(), tx, create_graph=True)
    torch.autograd.grad(g.square().sum(), ts)
    assert calls == [True]
    copies = fn.group_norm_act.layout_copies
    dx, _, _ = fn._GroupNormActBwd.apply(
        tx.detach().permute(0, 2, 3, 1).reshape(2, 16, 64), ts,
        torch.from_numpy(bias), torch.zeros(2, 32), torch.ones(2, 32),
        torch.ones(2, 16, 64, requires_grad=True), 32, 0.2)
    torch.autograd.grad(dx, ts, torch.ones(2, 64, 16).mT)
    assert calls == [True, True]
    assert fn.group_norm_act.layout_copies == copies + 1
    assert (fn._launch_fwd.launches, fn._launch_bwd.launches,
            fn._launch_second_order.launches) == launches


@pytest.mark.parametrize("by", ["grad", "backward"])
def test_norm_is_differentiable_exactly_twice(by):
    """The penalty's second order, taken with ``create_graph``, equals the
    one taken without; differentiating it once more raises, by
    ``torch.autograd.grad`` for a parameter or by ``backward``."""
    x, scale, bias = _inputs((2, 4, 4, 64), 7)
    ts = torch.from_numpy(scale).requires_grad_()
    tx = _nchw(x).requires_grad_()

    def second_order(create_graph):
        y = fn.group_norm_act(tx, ts, torch.from_numpy(bias), groups=32,
                              negative_slope=0.2)
        (g,) = torch.autograd.grad(y.square().sum(), tx, create_graph=True)
        return torch.autograd.grad(g.square().sum(), ts,
                                   create_graph=create_graph)[0]

    g2 = second_order(True)
    assert torch.equal(g2.detach(), second_order(False))
    with pytest.raises(RuntimeError, match="differentiable twice"):
        if by == "grad":
            torch.autograd.grad(g2.sum(), ts)
        else:
            g2.sum().backward()


def test_bf16_forward_close_to_f32_plain():
    shape = (2, 8, 8, 64)
    x, scale, bias = _inputs(shape, 4)
    t = torch.from_numpy
    got = fn.group_norm_act(_nchw(x).to(torch.bfloat16), t(scale), t(bias),
                            groups=32, negative_slope=0.2)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    want, _, _ = fn.group_norm_act_fwd_plain(t(x.reshape(2, 64, 64)),
                                             t(scale), t(bias), 32, 0.2,
                                             1e-6)
    np.testing.assert_allclose(_nhwc(got, shape), want.numpy().reshape(shape),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("width,groups", [(8, 8), (16, 16), (48, 24),
                                          (64, 32), (1024, 32)])
def test_group_count_follows_jax(width, groups):
    module = fn.FusedGroupNormAct(width, min(32, width))
    assert module.num_groups == groups
    shape = (2, 2, 2, width)
    x, scale, bias = _inputs(shape, 5)
    jmod = jfn.FusedGroupNormAct(num_groups=min(32, width))
    want = jmod.apply({"params": {"scale": scale, "bias": bias}},
                      jnp.asarray(x))
    module.load_state_dict({"scale": torch.from_numpy(scale),
                            "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(_nhwc(module(_nchw(x)), shape),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


def test_models_with_fused_norm_match_flax():
    """JointCNN and the generator with norm_impl="pallas" on converted
    weights: the flax trees name their norms FusedGroupNormAct_i."""
    p, width, latent, b = 32, 8, 16, 3
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (b, p, p, 3)).astype(np.float32)
    z = rng.normal(0, 1, (b, latent)).astype(np.float32)
    jd = JaxJointCNN(base_width=width, norm_impl="pallas",
                     zero_init_heads=False)
    jg = JaxGenerator(image_size=p, base_width=width,
                      latent_dimension=latent, norm_impl="pallas")
    d_params = jd.init(jax.random.key(1), jnp.zeros((1, p, p, 3)))
    g_params = jg.init(jax.random.key(2), jnp.zeros((1, latent)))
    assert "FusedGroupNormAct_0" in d_params["params"]
    (j_density, _), j_feats = jd.apply(d_params, jnp.asarray(x))
    j_fake = jg.apply(g_params, jnp.asarray(z))

    d = JointCNN(width, norm_impl="pallas", zero_init_heads=False,
                 rng=generator_for(0, "t"))
    g = CrowdDCGenerator(image_size=p, base_width=width,
                         latent_dimension=latent, norm_impl="pallas",
                         rng=generator_for(0, "t"))
    d.load_state_dict(convert.joint_cnn_state_dict(jax.device_get(d_params)))
    g.load_state_dict(convert.generator_state_dict(jax.device_get(g_params)))
    assert all(isinstance(m, fn.FusedGroupNormAct) for m in d.norms)
    (density, _), feats = d(_nchw(x))
    fake = g(torch.from_numpy(z))
    _close(density.detach().numpy(), j_density, 1e-4)
    _close(feats.detach().numpy(), j_feats, 1e-4)
    _close(_nhwc(fake, fake.permute(0, 2, 3, 1).shape), j_fake, 1e-4)


def test_no_fallback_off_the_cpu():
    """Off the CPU the Functions launch the kernels or raise: a tensor on
    another device reaches the launcher, which refuses it; CPU calls run
    the plain versions and launch nothing."""
    fwd, bwd = fn._launch_fwd.launches, fn._launch_bwd.launches
    x = torch.randn(2, 8, 4, 4, requires_grad=True)
    ones, zeros = torch.ones(8), torch.zeros(8)
    fn.group_norm_act(x, ones, zeros, groups=4).sum().backward()
    assert (fn._launch_fwd.launches, fn._launch_bwd.launches) == (fwd, bwd)
    with pytest.raises(ValueError, match="CUDA"):
        rows = torch.zeros(2, 16, 8)
        fn._launch_second_order(rows, ones, zeros, torch.zeros(2, 4),
                                torch.ones(2, 4), rows, rows, zeros, zeros,
                                4, 0.2)
    meta = torch.empty(2, 8, 4, 4, device="meta").contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="CUDA"):
        fn.group_norm_act(meta, ones.to("meta"), zeros.to("meta"), groups=4)
    with pytest.raises(ValueError, match="CUDA"):
        fn._launch_bwd(torch.zeros(2, 16, 8), ones, zeros,
                       torch.zeros(2, 4), torch.ones(2, 4),
                       torch.zeros(2, 16, 8), 4, 0.2)
    with pytest.raises(ValueError, match="divisible"):
        fn.group_norm_act(x, ones, zeros, groups=3)


def test_norm_impl_setting():
    """The port runs the three implementations JAX runs ("xla", "fast"
    and "pallas"), each its own norm module; an unknown one raises JAX's
    ``ValueError`` as the models are built."""
    from srgan_tpu_torch import Settings
    from srgan_tpu_torch.experiment import check_supported
    from srgan_tpu_torch.models.dcgan import (FastGroupNorm, GroupNorm,
                                              group_norm)
    for impl in ("xla", "fast", "pallas"):
        check_supported(Settings(norm_impl=impl))
    assert isinstance(group_norm(64, torch.float32, "xla"), GroupNorm)
    assert isinstance(group_norm(64, torch.float32, "fast"), FastGroupNorm)
    assert isinstance(group_norm(64, torch.float32, "pallas"),
                      fn.FusedGroupNormAct)
    with pytest.raises(ValueError, match="norm_impl 'flax'.*'fast'"):
        group_norm(64, torch.float32, "flax")


# ---------------------------------------------------------------------------
# The kernels' tiling, worked out in Python (the kernels run only on the
# card; csrc/fused_norm.cu checks what it is given).
# ---------------------------------------------------------------------------

# The GroupNorms of the flagship step as [B, HW, C] (chip_smoke.py's
# NORM_SHAPES): D over 3B and over B, G over B.
FLAGSHIP_NORM_SHAPES = [(360, 12544, 64), (360, 3136, 128), (360, 3136, 256),
                        (120, 12544, 64), (120, 3136, 128), (120, 3136, 256),
                        (120, 49, 1024), (120, 196, 512), (120, 784, 256),
                        (120, 3136, 128), (120, 12544, 64)]
# tests/test_torch_port_cuda.py's NORM_CASES, as [B, HW, C].
CUDA_NORM_CASES = [(3, 64, 64), (2, 49, 1024), (4, 100, 8), (2, 300, 384)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLAGSHIP_NORM_SHAPES + CUDA_NORM_CASES)
def test_norm_tiling_covers_every_row_once(shape, dtype):
    b, hw, c = shape
    elem = torch.empty((), dtype=dtype).element_size()
    for direction, tensors, outputs in (("fwd", 1, 1), ("bwd", 2, 1),
                                        ("second_order", 3, 2)):
        t = fn.norm_tiling(b, hw, c, dtype, direction)
        assert t == fn.norm_tiling(b, hw, c, dtype, direction)
        assert t.cluster in (1, 2, 4, 8, 16)
        starts = range(0, t.cluster * t.rows_per_block, t.rows_per_block)
        owned = [range(s, min(s + t.rows_per_block, hw)) for s in starts]
        assert all(len(rows) > 0 for rows in owned)
        assert [r for rows in owned for r in rows] == list(range(hw))
        assert 0 <= t.resident_rows <= t.rows_per_block
        assert t.smem_bytes == fn._smem_bytes(c, t.resident_rows, elem,
                                              tensors)
        assert t.smem_bytes <= 232448
        resident = t.resident_rows == t.rows_per_block
        units = fn.norm_traffic_bytes(b, hw, c, dtype, direction, t) / (
            b * hw * c * elem)
        assert (units == tensors + outputs) == resident
        assert units <= 2 * tensors + outputs
        if shape in FLAGSHIP_NORM_SHAPES and dtype == torch.bfloat16 \
                and direction == "fwd":
            assert resident, t


def test_norm_tiling_streams_what_the_cluster_cannot_hold():
    """float32 at the largest stage, backward: x and dy are 6.4 MB, so a
    cluster of 16 holds part of each block's rows and reads the rest
    twice; a cluster of 8 at the same residency would stream more, and
    the traffic counts each streamed row once more per tensor."""
    t = fn.norm_tiling(2, 12544, 64, torch.float32, "bwd")
    assert t.cluster == 16 and 0 < t.resident_rows < t.rows_per_block
    smaller = t._replace(cluster=8, rows_per_block=1568)
    traffic = [fn.norm_traffic_bytes(2, 12544, 64, torch.float32, "bwd", x)
               for x in (t, smaller)]
    assert 3 * 2 * 12544 * 64 * 4 < traffic[0] < traffic[1]
    streamed = 16 * (t.rows_per_block - t.resident_rows)
    assert traffic[0] == 2 * 64 * 4 * (3 * 12544 + 2 * streamed)
    bf16 = fn.norm_tiling(2, 12544, 64, torch.bfloat16, "bwd")
    assert bf16.cluster == 16 and bf16.resident_rows == bf16.rows_per_block
    # The second order's three sources at the same shape: 558 of each
    # block's 784 rows resident, the rest read twice.
    second = fn.norm_tiling(2, 12544, 64, torch.bfloat16, "second_order")
    assert (second.cluster, second.rows_per_block, second.resident_rows) == (
        16, 784, 558)
    assert fn.norm_traffic_bytes(
        2, 12544, 64, torch.bfloat16, "second_order", second) == (
        2 * 64 * 2 * (5 * 12544 + 3 * 16 * (784 - 558)))
    with pytest.raises(ValueError, match="direction"):
        fn.norm_tiling(2, 16, 8, torch.float32, "both")


def test_every_source_the_port_builds_is_its_own(tmp_path, monkeypatch):
    """The compile commands of every CUDA source (``csrc/*.cu``) and of
    the host tier's library (``csrc/srgan_io.cc``) name only files under
    ``srgan_tpu_torch/``: the port reads nothing of the JAX package's
    tree (``native/``) to build."""
    import subprocess

    import srgan_tpu_torch
    from srgan_tpu_torch.io import native
    from srgan_tpu_torch.ops import _build
    package = os.path.dirname(os.path.abspath(srgan_tpu_torch.__file__))
    commands = []

    def compile_(cmd, **_):
        commands.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "recorded")

    monkeypatch.setattr(subprocess, "run", compile_)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "cuda"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "host"))
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                   if f.endswith(".cu"))
    assert names == ["copy", "density", "fused_norm", "patches"]
    for build in [functools.partial(_build.build, n) for n in names] + [
            native.build_library]:
        with pytest.raises(RuntimeError, match="recorded"):
            build()
    sources = [arg for cmd in commands for arg in cmd
               if arg.endswith((".cu", ".cc"))]
    assert len(sources) == len(names) + 1
    assert sources[-1] == native.SOURCE_PATH
    for source in sources:
        assert os.path.isfile(source)
        assert os.path.commonpath([package, source]) == package, source


def test_built_library_name_follows_the_headers(tmp_path, monkeypatch):
    """An edited csrc header (*.cuh) names a new library, so a stale one
    is never loaded."""
    from srgan_tpu_torch.ops import _build
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    alone = _build.library_path("k")
    (tmp_path / "k.cuh").write_text("constexpr int kA = 1;\n")
    first = _build.library_path("k")
    (tmp_path / "k.cuh").write_text("constexpr int kA = 2;\n")
    second = _build.library_path("k")
    assert len({alone, first, second}) == 3
    assert second == _build.library_path("k")
