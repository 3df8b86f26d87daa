"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped where there is none; imports no JAX, so that it runs on the
machine with the card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m gpu -q

(``--noconftest``: the suite's conftest configures JAX.)
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from srgan_tpu_torch.ops import density
from srgan_tpu_torch.ops import fused_norm as fn
from srgan_tpu_torch.ops import patches
from srgan_tpu_torch.ops.density import density_maps, density_maps_plain
from srgan_tpu_torch.ops.patches import (extract_patches,
                                         extract_patches_plain,
                                         extract_rescaled_patches,
                                         extract_rescaled_patches_plain)
from srgan_tpu_torch.tools import norm_bandwidth_bench as bandwidth

N, H, W, P, B = 3, 80, 96, 32, 6

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="the CUDA kernels need a card and nvcc"),
]


def _inputs(dtype, channels, n=N, h=H, w=W, p=P, b=B):
    """Sources, indices, offsets and flips on the card. The first window
    sits at the origin, the last at the last row and column of the
    tensor's last image, the second (where B > 2) at an odd column, so that
    its rows start inside a 16-byte vector; flips alternate."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.uint8:
        images = torch.randint(0, 256, (n, h, w, channels), generator=gen,
                               device=dev, dtype=torch.uint8)
    else:
        images = torch.randn((n, h, w, channels), generator=gen,
                             device=dev).to(dtype)
    indices = torch.randint(0, n, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    offsets = torch.stack(
        [torch.randint(0, h - p + 1, (b,), generator=gen, device=dev),
         torch.randint(0, w - p + 1, (b,), generator=gen, device=dev)],
        -1).to(torch.int32)
    offsets[0] = torch.tensor([0, 0])
    if b > 2:
        offsets[1] = torch.tensor([1, 1])
    offsets[-1] = torch.tensor([h - p, w - p])
    indices[-1] = n - 1
    flips = (torch.arange(b, device=dev) % 2).to(torch.int32)
    return images, indices, offsets.contiguous(), flips


# (N, H, W, P, B): the tests' default; a source pitch that is not a whole
# number of 16-byte vectors (W = 97); output rows that are not (P = 30);
# one example; and 300 examples, more than the card holds blocks at once,
# whose plan takes several rows a block, also with a partial last tile.
GEOMETRIES = [(N, H, W, P, B), (N, H, 97, P, B), (N, H, W, 30, B),
              (2, H, W, P, 1), (N, H, W, P, 300), (N, H, 97, 30, 300)]
PATCH_CASES = [  # (dtype, channels, scale, shift)
    (torch.uint8, 3, 2.0 / 255.0, -1.0),
    (torch.float32, 1, 1.0, 0.0),
    (torch.bfloat16, 1, 1.0, 0.0),
    (torch.bfloat16, 3, 2.0, -1.0),
    # The kNN/iKNN label tensor: (density, aux) channels.
    (torch.float32, 2, 1.0, 0.0),
    (torch.bfloat16, 2, 1.0, 0.0),
]


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype,channels,scale,shift", PATCH_CASES)
def test_patch_kernel_equals_plain(dtype, channels, scale, shift, geometry):
    n, h, w, p, b = geometry
    images, indices, offsets, flips = _inputs(dtype, channels, n, h, w, p, b)
    before = extract_patches.launches
    got = extract_patches(images, offsets, flips, patch_size=p, scale=scale,
                          shift=shift, indices=indices)
    torch.cuda.synchronize()
    assert extract_patches.launches == before + 1
    want = extract_patches_plain(images, offsets, flips, patch_size=p,
                                 scale=scale, shift=shift, indices=indices)
    # Exact: the kernel rounds the multiply and the add separately.
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_patch_wrapper_rejects_what_the_kernel_does_not_take():
    images, indices, offsets, flips = _inputs(torch.uint8, 3)
    with pytest.raises(ValueError, match="int32"):
        extract_patches(images, offsets, flips, patch_size=P,
                        indices=indices.long())
    with pytest.raises(ValueError, match="contiguous"):
        extract_patches(images[:, :, ::2], offsets, flips, patch_size=P,
                        indices=indices)
    with pytest.raises(TypeError, match="dtype"):
        extract_patches(images.to(torch.int16), offsets, flips,
                        patch_size=P, indices=indices)
    with pytest.raises(ValueError, match="does not fit"):
        extract_patches(images, offsets, flips, patch_size=H + 1,
                        indices=indices)
    # A plan the kernel does not take: too little shared memory for its
    # rows, more rows than the patch, a thread count off the warp size.
    plan = patches.sampler_plan(B, H, W, 3, P, 1)
    for bad in (plan._replace(smem_bytes=plan.smem_bytes - 16),
                plan._replace(tile_rows=P + 1, staged_rows=P + 1),
                plan._replace(threads=100)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            patches._launch_patches(images, indices, offsets, flips, P, 1.0,
                                    0.0, bad)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("windows", [(24, 32, 40), (19, 45)])
@pytest.mark.parametrize("dtype,channels,scale,shift,mass", [
    (torch.uint8, 3, 2.0 / 255.0, -1.0, False),
    (torch.float32, 1, 1.0, 0.0, True),
    (torch.bfloat16, 1, 1.0, 0.0, True),
    (torch.bfloat16, 3, 2.0, -1.0, False),
])
def test_rescale_kernel_equals_plain(windows, dtype, channels, scale, shift,
                                     mass, geometry):
    """Images within 1e-6, labels within 1e-5 of their largest value (the
    same float32 terms in another sum order); windows of side P exactly."""
    n, h, w, p, b = geometry
    images, indices, _, flips = _inputs(dtype, channels, n, h, w, p, b)
    dev = images.device
    sidx = torch.arange(b, device=dev, dtype=torch.int32) % len(windows)
    win = torch.tensor(windows, device=dev)[sidx.long()]
    gen = torch.Generator(device=dev).manual_seed(2)
    offsets = torch.stack(
        [(torch.rand(b, generator=gen, device=dev) * (h - win + 1)).long(),
         (torch.rand(b, generator=gen, device=dev) * (w - win + 1)).long()],
        -1)
    offsets[0] = 0
    if b > 2:
        offsets[1] = 1
    offsets[-1] = torch.stack([h - win[-1], w - win[-1]])
    offsets = offsets.to(torch.int32).contiguous()
    kw = dict(patch_size=p, window_sizes=windows, scale=scale, shift=shift,
              preserve_mass=mass, indices=indices)
    before = extract_rescaled_patches.launches
    got = extract_rescaled_patches(images, offsets, flips, sidx, **kw)
    torch.cuda.synchronize()
    assert extract_rescaled_patches.launches == before + 1
    want = extract_rescaled_patches_plain(images, offsets, flips, sidx, **kw)
    tol = (1e-6 if dtype == torch.uint8
           else 1e-5 * float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    identity = win == p
    torch.testing.assert_close(got[identity], want[identity], rtol=0, atol=0)


def test_samplers_repeat_bit_for_bit():
    """Two launches on the same inputs give the same bits, both samplers,
    with a plan of several rows a block."""
    images, indices, offsets, flips = _inputs(torch.uint8, 3, b=300)
    sidx = torch.arange(300, device=images.device, dtype=torch.int32) % 3
    offsets = torch.minimum(offsets, torch.tensor([H - 40, W - 40],
                                                  device=images.device))
    offsets = offsets.to(torch.int32).contiguous()
    kw = dict(patch_size=P, scale=2.0 / 255.0, shift=-1.0, indices=indices)
    first = extract_patches(images, offsets, flips, **kw)
    again = extract_patches(images, offsets, flips, **kw)
    rescale = dict(kw, window_sizes=(24, 32, 40))
    rescaled = [extract_rescaled_patches(images, offsets, flips, sidx,
                                         **rescale) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(*rescaled)


# The fused norm kernels against their plain versions: small shapes of
# 1 to 32 channels per group, float32 and bfloat16. The two sum in
# different orders: float32 outputs within 1e-5 of the tensor's largest
# magnitude (bfloat16: one bfloat16 ulp, 2⁻⁷, of it), mean and rstd at
# rtol 1e-5, dscale and dbias within 1e-5 of their largest magnitude.
NORM_CASES = [((3, 64, 64), 32, 0.2), ((2, 49, 1024), 32, 0.0),
              ((4, 100, 8), 8, 0.2), ((2, 300, 384), 32, 0.0)]


def _norm_inputs(shape, dtype):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    scale = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
    bias = 0.1 * torch.randn((c,), generator=gen, device=dev)
    return x, scale, bias, dy


def _within(got, want, rel):
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.float().abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,slope", NORM_CASES)
def test_fused_norm_kernels_equal_plain(shape, groups, slope, dtype):
    x, scale, bias, dy = _norm_inputs(shape, dtype)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    before = (fn._launch_fwd.launches, fn._launch_bwd.launches)
    y, mean, rstd = fn._launch_fwd(x, scale, bias, groups, slope, 1e-6)
    dx, dscale, dbias = fn._launch_bwd(x, scale, bias, mean, rstd, dy,
                                       groups, slope)
    torch.cuda.synchronize()
    assert (fn._launch_fwd.launches, fn._launch_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_y, want_mean, want_rstd = fn.group_norm_act_fwd_plain(
        x, scale, bias, groups, slope, 1e-6)
    assert y.dtype == dtype and dx.dtype == dtype
    _within(y, want_y, rel)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
    want = fn.group_norm_act_bwd_plain(x, scale, bias, mean, rstd, dy,
                                       groups, slope)
    _within(dx, want[0], rel)
    _within(dscale, want[1], 1e-5)
    _within(dbias, want[2], 1e-5)


# Shapes beside NORM_CASES that take the kernels' other routes: a cluster
# of 16 blocks fully resident (bfloat16), float32 whose backward streams
# 366 of each block's 784 rows, an explicit tiling whose forward and
# backward stream 1268 of each block's 1568 rows, and channels whose rows
# are not a whole number of 16-byte vectors (C·sizeof(dtype) = 24 or 12
# bytes: element loads, no bulk copies).
ROUTE_CASES = [((2, 12544, 64), 32, 0.2, None),
               ((2, 12544, 64), 32, 0.2, fn.NormTiling(8, 1568, 300, 0)),
               ((3, 40, 6), 3, 0.2, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,slope,tiling", ROUTE_CASES)
def test_fused_norm_kernel_routes_equal_plain(shape, groups, slope, tiling,
                                              dtype):
    x, scale, bias, dy = _norm_inputs(shape, dtype)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    tilings = {}
    for kind in ("fwd", "bwd"):
        t = tiling or fn.norm_tiling(*shape, dtype, kind)
        if tiling is not None:  # the layout's bytes at this residency
            elem = x.element_size()
            t = t._replace(smem_bytes=fn._smem_bytes(
                shape[2], t.resident_rows, elem, 1 if kind == "fwd" else 2))
        tilings[kind] = t
    if shape == (2, 12544, 64) and tiling is None:
        assert tilings["fwd"].cluster > 1
        streams = dtype == torch.float32
        assert (tilings["bwd"].resident_rows
                < tilings["bwd"].rows_per_block) == streams
    y, mean, rstd = fn._launch_fwd(x, scale, bias, groups, slope, 1e-6,
                                   tiling=tilings["fwd"])
    dx, dscale, dbias = fn._launch_bwd(x, scale, bias, mean, rstd, dy,
                                       groups, slope, tiling=tilings["bwd"])
    torch.cuda.synchronize()
    want_y, want_mean, want_rstd = fn.group_norm_act_fwd_plain(
        x, scale, bias, groups, slope, 1e-6)
    _within(y, want_y, rel)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
    want = fn.group_norm_act_bwd_plain(x, scale, bias, mean, rstd, dy,
                                       groups, slope)
    _within(dx, want[0], rel)
    _within(dscale, want[1], 1e-5)
    _within(dbias, want[2], 1e-5)


@pytest.mark.parametrize("shape,groups", [((3, 3136, 256), 32),
                                          ((2, 12544, 64), 32)])
def test_fused_norm_kernels_repeat_bit_for_bit(shape, groups):
    """No atomics: two launches on the same inputs give the same bits,
    bfloat16 and float32 (whose backward streams at the second shape)."""
    for dtype in (torch.bfloat16, torch.float32):
        x, scale, bias, dy = _norm_inputs(shape, dtype)
        first = fn._launch_fwd(x, scale, bias, groups, 0.2, 1e-6)
        again = fn._launch_fwd(x, scale, bias, groups, 0.2, 1e-6)
        grads = [fn._launch_bwd(x, scale, bias, first[1], first[2], dy,
                                groups, 0.2) for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in list(zip(first, again)) + list(zip(*grads)):
            assert torch.equal(a, b)


# Every norm of the age and driving SR-GAN step at 64 px, batch 32, base
# width 64, with its slope: D over the 3B batch and D and the DNN over B
# (LeakyReLU 0.2), G over B (ReLU); down to 16 rows an example.
AGE_NORM_CASES = [((b, hw, c), 0.2) for b in (96, 32)
                  for hw, c in ((1024, 64), (256, 128), (64, 256), (16, 512))
                  ] + [((32, hw, c), 0.0) for hw, c in (
                      (16, 512), (64, 256), (256, 128), (1024, 64))]


@pytest.mark.parametrize("shape,slope", AGE_NORM_CASES + [
    # JointDCNN's last stage: a backward that streams 97 of each block's
    # 196 rows.
    ((8, 3136, 512), 0.2)])
def test_fused_norm_kernels_equal_plain_at_the_age_shapes(shape, slope):
    """bfloat16, the tolerances of chip_smoke.py's flagship check: y and
    dx within one bfloat16 ulp of each element plus 1e-5 of the largest,
    mean and rstd at rtol 1e-5, dscale and dbias within 1e-4 of their
    largest."""
    if shape == (8, 3136, 512):
        tiling = fn.norm_tiling(*shape, torch.bfloat16, "bwd")
        assert tiling.resident_rows < tiling.rows_per_block
    x, scale, bias, dy = _norm_inputs(shape, torch.bfloat16)
    y, mean, rstd = fn._launch_fwd(x, scale, bias, 32, slope, 1e-6)
    dx, dscale, dbias = fn._launch_bwd(x, scale, bias, mean, rstd, dy, 32,
                                       slope)
    torch.cuda.synchronize()
    want_y, want_mean, want_rstd = fn.group_norm_act_fwd_plain(
        x, scale, bias, 32, slope, 1e-6)
    want = fn.group_norm_act_bwd_plain(x, scale, bias, mean, rstd, dy, 32,
                                       slope)
    for got, ref in ((y, want_y), (dx, want[0])):
        ref = ref.float()
        bound = 2 ** -7 * ref.abs() + 1e-5 * float(ref.abs().max())
        assert bool(((got.float() - ref).abs() <= bound).all())
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
    _within(dscale, want[1], 1e-4)
    _within(dbias, want[2], 1e-4)


def test_fused_norm_occupancy_query():
    """Every tiling the flagship's largest shapes take fits the card at
    least once."""
    for kind in ("fwd", "bwd", "second_order"):
        t = fn.norm_tiling(360, 12544, 64, torch.bfloat16, kind)
        assert fn.max_active_clusters(torch.bfloat16, kind, t) >= 1


# The second-order kernel against its closed form
# (``group_norm_act_bwd_vjp_plain``), bfloat16 unless stated: D's norms at
# the flagship's interpolates, batch 120 (the second 256-channel norm has
# the first's shape); JointDCNN's 512-channel stage, whose rows stream;
# rows that are not whole 16-byte vectors (element loads, no bulk
# copies); an explicit tiling that streams 1268 of each block's 1568
# rows; float32, which streams at the largest stage; a group per channel
# at the widest rows the kernels take. (shape, groups, tiling, dtype.)
SECOND_ORDER_CASES = [
    ((120, 12544, 64), 32, None, torch.bfloat16),
    ((120, 3136, 128), 32, None, torch.bfloat16),
    ((120, 3136, 256), 32, None, torch.bfloat16),
    ((8, 3136, 512), 32, None, torch.bfloat16),
    ((3, 40, 6), 3, None, torch.bfloat16),
    ((3, 40, 6), 3, None, torch.float32),
    ((2, 12544, 64), 32, fn.NormTiling(8, 1568, 300, 0), torch.bfloat16),
    ((2, 12544, 64), 32, None, torch.float32),
    ((3, 64, 64), 32, None, torch.float32),
    ((2, 16, 6144), 6144, None, torch.bfloat16),
]


def _second_order_inputs(shape, groups, dtype, zero_params):
    x, scale, bias, dy = _norm_inputs(shape, dtype)
    gen = torch.Generator(device=x.device).manual_seed(2)
    g_dx = torch.randn(shape, generator=gen, device=x.device).to(dtype)
    c = shape[-1]
    params = [torch.zeros(c, device=x.device) if zero_params else
              torch.randn((c,), generator=gen, device=x.device)
              for _ in range(2)]
    _, mean, rstd = fn._launch_fwd(x, scale, bias, groups, 0.2, 1e-6)
    return x, scale, bias, mean, rstd, dy, g_dx, *params


def _second_order_within(got, want):
    """g_x and g_dy within one bfloat16 ulp (float32: 1e-5) of each
    element plus 1e-5 of the tensor's largest magnitude, g_scale within
    1e-5 of its largest, g_bias 0: sums of up to 25 088 terms in another
    order (on an H100 the excess over the ulp stayed under 1.2e-7 of the
    largest, g_scale under 4.2e-7, at every case here)."""
    for g, w in (got[0], want[0]), (got[3], want[3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        w = w.float()
        ulp = 2 ** -7 if g.dtype == torch.bfloat16 else 1e-5
        bound = ulp * w.abs() + 1e-5 * float(w.abs().max())
        assert bool(((g.float() - w).abs() <= bound).all()), float(
            ((g.float() - w).abs() - ulp * w.abs()).max()
            / w.abs().max())
    _within(got[1], want[1], 1e-5)
    assert not got[2].any()


@pytest.mark.parametrize("zero_params", [True, False])
@pytest.mark.parametrize("shape,groups,tiling,dtype", SECOND_ORDER_CASES)
def test_fused_norm_second_order_kernel_equals_closed_form(
        shape, groups, tiling, dtype, zero_params):
    args = _second_order_inputs(shape, groups, dtype, zero_params)
    if tiling is not None:
        tiling = tiling._replace(smem_bytes=fn._smem_bytes(
            shape[2], tiling.resident_rows, args[0].element_size(), 3))
    before = fn._launch_second_order.launches
    got = fn._launch_second_order(*args, groups, 0.2, tiling=tiling)
    torch.cuda.synchronize()
    assert fn._launch_second_order.launches == before + 1
    _second_order_within(
        got, fn.group_norm_act_bwd_vjp_plain(*args, groups, 0.2))


def test_fused_norm_second_order_kernel_captures_and_replays():
    """Captured in a CUDA graph, the kernel (and its fold) replays on new
    inputs copied into the captured ones, and repeats bit for bit."""
    shape, groups = (4, 3136, 128), 32
    static = _second_order_inputs(shape, groups, torch.bfloat16, False)
    fn._launch_second_order(*static, groups, 0.2)  # built, warmed
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn._launch_second_order(*static, groups, 0.2)
    for seed in (5, 6):
        torch.manual_seed(seed)
        for t in (static[0], static[5], static[6]):
            t.copy_(torch.randn_like(t, dtype=torch.float32))
        _, mean, rstd = fn._launch_fwd(static[0], static[1], static[2],
                                       groups, 0.2, 1e-6)
        static[3].copy_(mean)
        static[4].copy_(rstd)
        graph.replay()
        torch.cuda.synchronize()
        first = [t.clone() for t in out]
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, out))
        _second_order_within(
            out, fn.group_norm_act_bwd_vjp_plain(*static, groups, 0.2))


def test_fused_norm_second_order_launcher_rejects_what_it_does_not_take():
    args = list(_second_order_inputs((2, 16, 64), 32, torch.float32, True))
    bad = {5: args[5].bfloat16(), 6: args[6][:, ::2],
           7: args[7].double(), 8: args[8][:32]}
    for index, value in bad.items():
        wrong = list(args)
        wrong[index] = value
        with pytest.raises((TypeError, ValueError)):
            fn._launch_second_order(*wrong, 32, 0.2)
    t = fn.norm_tiling(2, 16, 64, torch.float32, "second_order")
    with pytest.raises(RuntimeError, match="invalid argument"):
        fn._launch_second_order(*args, 32, 0.2, tiling=t._replace(
            smem_bytes=t.smem_bytes - 16))


def test_fused_norm_second_order_through_the_kernels():
    """The gradient penalty's ∂/∂scale through the kernels (the second
    order by its own kernel, launched once) equals autograd through the
    plain forward, float32, rtol 1e-3."""
    b, c, h = 2, 64, 8
    x, scale, bias, _ = _norm_inputs((b, h, h, c), torch.float32)
    x = x.permute(0, 3, 1, 2)  # NCHW in channels_last memory

    def penalty(act):
        s = scale.clone().requires_grad_()
        xi = x.clone().requires_grad_()
        (g,) = torch.autograd.grad(act(xi, s).square().sum(), xi,
                                   create_graph=True)
        value = ((g.flatten(1).square().sum(1) + 1e-12).sqrt() - 1).square()
        return torch.autograd.grad(value.mean(), s)[0]

    def plain(xi, s):
        rows = xi.permute(0, 2, 3, 1).reshape(b, h * h, c)
        y, _, _ = fn.group_norm_act_fwd_plain(rows, s, bias, 32, 0.2, 1e-6)
        return y.view(b, h, h, c).permute(0, 3, 1, 2)

    before = fn._launch_bwd.launches, fn._launch_second_order.launches
    got = penalty(lambda xi, s: fn.group_norm_act(
        xi, s, bias, groups=32, negative_slope=0.2))
    assert fn._launch_bwd.launches >= before[0] + 2
    assert fn._launch_second_order.launches == before[1] + 1
    torch.testing.assert_close(got, penalty(plain), rtol=1e-3, atol=1e-6)


# The flagship JointCNN trunk's four 3×3 convolutions at batch 8: the
# input after SAME padding (F.pad's (0, 1) at stride 2), the output
# channels, the stride and conv2d's own padding.
TRUNK_CONVS = [((8, 3, 225, 225), 64, 2, (0, 0)),
               ((8, 64, 113, 113), 128, 2, (0, 0)),
               ((8, 128, 56, 56), 256, 1, (1, 1)),
               ((8, 256, 56, 56), 256, 1, (1, 1))]


# CSRNet's backend at batch 8: 3×3 convolutions of dilation 2 on 28²
# maps at the flagship's patch, SAME's (2, 2) padding.
DILATED_CONVS = [((8, 512, 28, 28), 512), ((8, 512, 28, 28), 256),
                 ((8, 256, 28, 28), 128), ((8, 128, 28, 28), 64)]


@pytest.mark.parametrize("shape,out,stride,padding", TRUNK_CONVS)
def test_conv_second_order_takes_tensor_core_weight_gradients(
        shape, out, stride, padding):
    """The second order of ``models/dcgan.py``'s conv, bf16 in
    channels_last, against autograd's own double backward of
    ``convolution_backward``: the weight's gradient and dy's within
    bf16 rounding, dy's channels_last, and no legacy
    ``implicit_convolve_sgemm`` kernel in the rule."""
    _check_conv_second_order(shape, out, stride, padding, 1)


@pytest.mark.parametrize("shape,out", DILATED_CONVS)
def test_dilated_conv_second_order_takes_tensor_core_weight_gradients(
        shape, out):
    """The same of CSRNet's dilated backend layers."""
    _check_conv_second_order(shape, out, 1, (2, 2), 2)


def _check_conv_second_order(shape, out, stride, padding, dilation):
    from srgan_tpu_torch.models.dcgan import _ConvBwd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    side = (shape[2] + 2 * padding[0] - 2 * dilation - 1) // stride + 1

    def bf16(*s, scale=1.0):
        t = torch.randn(s, generator=gen, device=dev) * scale
        return t.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    x = bf16(*shape)
    w = bf16(out, shape[1], 3, 3, scale=(9 * shape[1]) ** -0.5)
    w.requires_grad_(True)
    dy = bf16(shape[0], out, side, side).requires_grad_(True)
    g_dx = bf16(*shape)
    mask = [True, False, False]
    dx = _ConvBwd.apply(dy.view_as(dy), x, w.view_as(w), stride, padding,
                        dilation, mask)[0]
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got_dy, got_w = torch.autograd.grad(dx, (dy, w), g_dx)
        torch.cuda.synchronize()
    native = torch.ops.aten.convolution_backward(
        dy, x, w, [out], [stride, stride], list(padding),
        [dilation, dilation], False, [0, 0], 1, mask)[0]
    want_dy, want_w = torch.autograd.grad(native, (dy, w), g_dx)
    for got, want in ((got_w, want_w), (got_dy, want_dy)):
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2 * scale)
    assert got_dy.is_contiguous(memory_format=torch.channels_last)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler recorded no kernel"
    assert not [k for k in kernels if "implicit_convolve_sgemm" in k], \
        kernels


def test_fused_norm_launchers_reject_what_the_kernels_do_not_take():
    x, scale, bias, dy = _norm_inputs((2, 16, 64), torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        fn._launch_fwd(x.half(), scale, bias, 32, 0.2, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        fn._launch_fwd(x[:, ::2], scale, bias, 32, 0.2, 1e-6)
    with pytest.raises(ValueError, match="scale"):
        fn._launch_fwd(x, scale.double(), bias, 32, 0.2, 1e-6)
    _, mean, rstd = fn._launch_fwd(x, scale, bias, 32, 0.2, 1e-6)
    with pytest.raises(ValueError, match="dy"):
        fn._launch_bwd(x, scale, bias, mean, rstd, dy.mT.contiguous().mT,
                       32, 0.2)
    with pytest.raises(ValueError, match="groups"):
        fn._launch_fwd(x, scale, bias, 48, 0.2, 1e-6)
    # A tiling the kernel does not take: too little shared memory for its
    # resident rows, rows that leave a block empty.
    t = fn.norm_tiling(2, 16, 64, torch.float32, "fwd")
    for bad in (t._replace(smem_bytes=t.smem_bytes - 16),
                t._replace(cluster=4, rows_per_block=8)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            fn._launch_fwd(x, scale, bias, 32, 0.2, 1e-6, tiling=bad)


# The density kernel against its plain version: (B, N, H, W, σ). Heads
# over the canvas widened by 16 px on each side; slots past each count
# hold NaN, which neither may read. A single map takes all N heads: the
# preprocessing path's shape (2000 heads on 384×512) and UCF-QNRF's most
# crowded image (12 865). Tolerance 1e-6 + 1e-4·|want| per element (the
# kernel's separable product and sum order against torch.exp of the sum),
# each map's sum within 1e-4·max(count, 1) of its count.
DENSITY_CASES = [(2, 16, 32, 48, 2.0), (3, 300, 61, 77, 4.0),
                 (1, 0, 16, 16, 2.0), (2, 700, 40, 600, 8.0),
                 (1, 2000, 384, 512, 8.0), (1, 12865, 384, 512, 8.0)]


def _assert_density_within(got, want, counts=None):
    assert bool(((got - want).abs() <= 1e-6 + 1e-4 * want.abs()).all())
    if counts is not None:
        sums = got.double().sum(dim=(1, 2)).cpu()
        c = torch.as_tensor(counts, dtype=torch.float64)
        assert bool(((sums - c).abs() <= 1e-4 * c.clamp_min(1.0)).all())


@pytest.mark.parametrize("b,n,h,w,sigma", DENSITY_CASES)
def test_density_kernel_equals_plain(b, n, h, w, sigma):
    dev = torch.device("cuda")
    rng = np.random.default_rng(n + b)
    heads = np.stack([rng.uniform(-16, h + 16, (b, n)),
                      rng.uniform(-16, w + 16, (b, n))], -1).astype(np.float32)
    counts = rng.integers(0, n + 1, b).astype(np.int32)
    if b == 1:
        counts[:] = n
    for i, c in enumerate(counts):
        heads[i, c:] = np.nan
    heads_t = torch.from_numpy(heads).to(dev)
    counts_t = torch.from_numpy(counts).to(dev)
    before = density_maps.launches
    got = density_maps(heads_t, counts_t, sigma, height=h, width=w)
    torch.cuda.synchronize()
    assert density_maps.launches == before + 1
    want = density_maps_plain(heads_t, counts_t, sigma, height=h, width=w)
    assert got.shape == (b, h, w) and bool(torch.isfinite(got).all())
    _assert_density_within(got, want)


def _in_runs(heads, counts, sigma, h, w, splits):
    """The kernel's maps with each map's valid slots in ``splits`` runs."""
    plan = density.DensityPlan(density.cull_radius(sigma), splits)
    return density._launch_density(heads, counts, sigma, h, w, plan)


@pytest.mark.parametrize("sigma", [2.0, 8.0])
def test_density_kernel_culls_at_the_radius(sigma):
    """Heads just inside, at and just outside the cull radius of tile
    edges (the 64 px ones and the canvas's), and 16 px outside the canvas
    (weights up to 1e12 at σ = 2): the maps equal the plain version's
    within the tolerance, with the slots in one run and in 3 runs, summed
    after."""
    dev = torch.device("cuda")
    h, w = 128, 160
    r = density.cull_radius(sigma)
    edges = [0.0, 63.0, 64.0, 127.0, 128.0, 159.0]
    near = [e + s * (r + d) for e in edges for s in (-1, 1)
            for d in (-0.5, 0.0, 0.5)]
    ys = [v for v in near if -17 <= v <= h + 16] + [-16.0, h + 15.0]
    xs = [v for v in near if -17 <= v <= w + 16] + [-16.0, w + 15.0]
    pts = [(y, 40.0) for y in ys] + [(70.0, x) for x in xs]
    heads = torch.tensor([pts], dtype=torch.float32, device=dev)
    counts = torch.tensor([len(pts)], dtype=torch.int32, device=dev)
    want = density_maps_plain(heads, counts, sigma, height=h, width=w)
    for splits in (1, 3):
        got = _in_runs(heads, counts, sigma, h, w, splits)
        assert bool(torch.isfinite(got).all())
        _assert_density_within(got, want)


def test_density_kernel_nan_and_inf_heads_follow_the_plain_version():
    """A NaN coordinate in a valid slot makes its whole map NaN, in the
    kernel as in the plain version, also where the other coordinate lies
    far past the cull radius; a head at ±inf adds 0; the other maps of the
    batch stay as they are."""
    dev = torch.device("cuda")
    h, w, sigma = 40, 70, 2.0
    rng = np.random.default_rng(9)
    heads = np.stack([rng.uniform(0, h, (5, 6)), rng.uniform(0, w, (5, 6))],
                     -1).astype(np.float32)
    heads[0, 2] = [np.nan, 10.0]
    heads[1, 3] = [-1e6, np.nan]
    heads[2, 0] = [np.inf, 10.0]
    heads[2, 1] = [5.0, -np.inf]
    heads[2, 2] = [np.inf, -np.inf]
    heads[3, 4] = [-np.inf, np.inf]
    counts = np.array([6, 6, 6, 6, 6], np.int32)
    heads_t = torch.from_numpy(heads).to(dev)
    counts_t = torch.from_numpy(counts).to(dev)
    want = density_maps_plain(heads_t, counts_t, sigma, height=h, width=w)
    assert bool(want[:2].isnan().all()) and bool(want[2:].isfinite().all())
    for got in (_in_runs(heads_t, counts_t, sigma, h, w, 1),
                _in_runs(heads_t, counts_t, sigma, h, w, 4),
                density_maps(heads_t, counts_t, sigma, height=h, width=w)):
        assert torch.equal(got.isnan(), want.isnan())
        _assert_density_within(got[2:], want[2:], [3, 5, 6])


def test_density_kernel_repeats_bit_for_bit():
    """Two calls, also where the plan cuts the slots into runs (192
    tiles of 64 × 64: 2 runs)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    heads = np.stack([rng.uniform(-16, 400, (4, 3000)),
                      rng.uniform(-16, 528, (4, 3000))],
                     -1).astype(np.float32)
    heads_t = torch.from_numpy(heads).to(dev)
    counts_t = torch.tensor([3000, 1, 0, 2500], dtype=torch.int32, device=dev)
    assert density.density_plan(384, 512, 8.0, 4, 3000).splits == 2
    first = density_maps(heads_t, counts_t, 8.0, height=384, width=512)
    second = density_maps(heads_t, counts_t, 8.0, height=384, width=512)
    assert torch.equal(first, second)
    _assert_density_within(first, density_maps_plain(
        heads_t, counts_t, 8.0, height=384, width=512), [3000, 1, 0, 2500])


def test_density_wrapper_rejects_what_the_kernel_does_not_take():
    dev = torch.device("cuda")
    heads = torch.zeros((2, 4, 2), device=dev)
    counts = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        density_maps(heads, counts.long(), 2.0, height=8, width=8)
    with pytest.raises(ValueError, match="float32"):
        density_maps(heads.double(), counts, 2.0, height=8, width=8)
    with pytest.raises(ValueError, match="sigma"):
        density_maps(heads, counts, 0.0, height=8, width=8)
    # Plans the kernel does not take: a radius that is not σ's, runs of
    # slots outside [1, 64].
    plan = density.density_plan(8, 8, 2.0, 2, 4)
    for bad in (plan._replace(radius=plan.radius - 1),
                plan._replace(radius=plan.radius + 1),
                plan._replace(splits=0), plan._replace(splits=65)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            density._launch_density(heads, counts, 2.0, 8, 8, bad)


# (shape, layout, rows): segments of 24 KB (three 8 KB units), of 8 KB (one),
# of 12, 75 and 37.5 KB (whole units and a part); of exactly 16 bytes,
# shorter than a unit; and 70 000 of them, more than the 65 535 of a grid's
# y dimension.
COPY_CASES = [((3, 192, 64), "per_example", 0),
              ((3, 192, 64), "batch_strided", 64),
              ((3, 192, 64), "batch_strided", 96),
              ((2, 600, 64), "per_example", 0),
              ((2, 600, 64), "batch_strided", 300),
              ((4, 1, 8), "per_example", 0),
              ((2, 4, 8), "batch_strided", 1),
              ((70000, 1, 8), "per_example", 0)]


@pytest.mark.parametrize("shape,layout,rows", COPY_CASES)
def test_copy_kernel_is_exact(shape, layout, rows):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    before = bandwidth.copy.launches
    got = bandwidth.copy(x, layout, rows)
    out = torch.full_like(x, float("nan"))
    into = bandwidth.copy(x, layout, rows, out)
    torch.cuda.synchronize()
    assert bandwidth.copy.launches == before + 2
    assert into.data_ptr() == out.data_ptr()
    assert torch.equal(got, x) and torch.equal(out, x)
    assert torch.equal(bandwidth.copy_plain(x, layout, rows), x)


def test_copy_wrapper_rejects_what_the_kernel_does_not_take():
    dev = torch.device("cuda")
    with pytest.raises(ValueError, match="16-byte"):
        bandwidth.copy(torch.zeros((2, 3, 3), dtype=torch.bfloat16,
                                   device=dev), "per_example")
    with pytest.raises(ValueError, match="divide"):
        bandwidth.copy(torch.zeros((2, 8, 64), dtype=torch.bfloat16,
                                   device=dev), "batch_strided", 5)


def test_window_refresh_on_a_side_stream_keeps_the_samplers_reads():
    """A deterministic window refreshed between sampler calls: every call
    reads the rows resident at its step, and the buffer equals the host
    rows of ``resident_ids`` after each refresh; opportunistic refreshes
    land once their copies finish."""
    from srgan_tpu_torch.data.window import HBMWindow

    host = np.random.default_rng(3).integers(0, 256, (40, H, W, 3)).astype(
        np.uint8)
    dev = torch.device("cuda")
    for period in (1, 0):
        window = HBMWindow(["images"], [lambda ids: torch.from_numpy(
            host[ids])], len(host), 16, 4, seed=[0, 7, 0], device=dev,
            refresh_period=period)
        try:
            offsets = torch.zeros((16, 2), dtype=torch.int32, device=dev)
            flips = torch.zeros(16, dtype=torch.int32, device=dev)
            indices = torch.arange(16, dtype=torch.int32, device=dev)
            outs, ids = [], []
            deadline = time.monotonic() + 60.0
            step = 0
            # Deterministic: 39 refreshes; opportunistic: until 3 copies
            # have landed (each step gives the stager a millisecond).
            while step < 39 if period else window.refresh_count < 3:
                step += 1
                window.maybe_refresh(step)
                outs.append(extract_patches(
                    window.arrays["images"], offsets, flips, patch_size=P,
                    indices=indices))
                ids.append(window.resident_ids())
                if not period:
                    assert time.monotonic() < deadline, "never refreshed"
                    time.sleep(0.001)
            torch.cuda.synchronize()
            for out, resident in zip(outs, ids):
                want = torch.from_numpy(host[resident, :P, :P]).float()
                torch.testing.assert_close(out.cpu(), want, rtol=0, atol=0)
            assert window.refresh_count == (39 if period else 3)
            np.testing.assert_array_equal(
                window.arrays["images"].cpu().numpy(),
                host[window.resident_ids()])
        finally:
            window.close()


# Data parallelism on the card, small versions of chip_smoke.py's phase
# 13: a world of 1 over NCCL and a world of 2 over gloo on cuda:0 (NCCL
# refuses two ranks on one device), float32, 2 steps with validation at
# the second. With the split replicated every world draws the same global
# batches, so its models match one rank without a group (rtol 2e-4, atol
# 2e-5; a conv bias a one-channel GroupNorm cancels has a noise-level
# gradient, whose Adam step of ±lr may take either sign).
DP_TINY = dict(batch_size=4, image_patch_size=P, model_base_width=8,
               latent_dimension=16, labeled_dataset_size=7,
               unlabeled_dataset_size=5, validation_dataset_size=3,
               test_dataset_size=1, crowd_image_height=H,
               crowd_image_width=W, crowd_synthetic_max_heads=12, seed=1,
               zero_init_heads=False, steps_to_run=2, summary_step_period=1,
               validation_step_period=2)


def _dp_train(tmp_path, devices, **over):
    import torch_dp_workers as workers
    from srgan_tpu_torch import CrowdExperiment, Settings
    from srgan_tpu_torch.parallel import launch

    settings = Settings(**dict(DP_TINY, logs_directory=str(tmp_path),
                               data_parallel_devices=len(devices), **over))
    return settings, launch.run_experiment(
        CrowdExperiment, settings, devices, action=workers.trained_models,
        trial_directory=str(tmp_path / f"ranks{len(devices)}"),
        timeout_s=300, collective_timeout_s=120,
        directory=str(tmp_path / "store"))


@pytest.mark.parametrize("devices", [["cuda:0"], ["cuda:0", "cuda:0"]],
                         ids=["nccl-world-1", "gloo-world-2"])
def test_data_parallel_ranks_train_as_one_rank(devices, tmp_path):
    from srgan_tpu_torch import CrowdExperiment

    settings, results = _dp_train(tmp_path, devices)
    state = CrowdExperiment(settings.copy(data_parallel_devices=1),
                            device="cuda").train()
    lr = settings.learning_rate * settings.steps_to_run
    for got in results:
        for name in ("d", "g", "dnn"):
            ours = getattr(state, name).state_dict()
            for k, v in got[name].items():
                want = ours[k].cpu()
                if (name, k) in got["cancelled"]:
                    assert float((v - want).abs().max()) <= 2 * lr, k
                    continue
                torch.testing.assert_close(v, want, rtol=2e-4, atol=2e-5)
    for name in ("d", "g", "dnn"):
        for k, v in results[0][name].items():
            assert torch.equal(v, results[-1][name][k]), (name, k)


def test_data_parallel_sharded_ranks_stay_bit_equal(tmp_path):
    """A sharded odd split (local counts 4 and 3, 3 and 2) on 2 ranks:
    finite models, bit-equal on both ranks."""
    _, (a, b) = _dp_train(tmp_path, ["cuda:0", "cuda:0"],
                          crowd_shard_dataset=True)
    for name in ("d", "g", "dnn"):
        for k, v in a[name].items():
            assert torch.isfinite(v.float()).all(), (name, k)
            assert torch.equal(v, b[name][k]), (name, k)


def test_more_ranks_than_cards_raise():
    from srgan_tpu_torch.parallel.mesh import backend_for, rank_devices

    count = torch.cuda.device_count()
    assert backend_for(rank_devices()) == "nccl"
    assert len(rank_devices()) == count
    with pytest.raises(ValueError, match="exceeds"):
        rank_devices(count + 1)


# steps_per_dispatch on the card: chunks of K steps as CUDA graph replays
# (srgan_tpu_torch/utils/cuda_graph.py), small versions of chip_smoke.py's
# phase 14 (a).
DISPATCH_TINY = dict(DP_TINY, batch_size=8, model_base_width=16,
                     labeled_dataset_size=6, unlabeled_dataset_size=6,
                     mean_offset=0.5, steps_per_dispatch=2,
                     norm_impl="pallas", summary_step_period=2,
                     data_parallel_devices=1)


def _manual_crowd(tmp_path, **over):
    from srgan_tpu_torch import CrowdExperiment, Settings
    from srgan_tpu_torch.train import init_train_state, set_float32_precision

    set_float32_precision()
    settings = Settings(**dict(DISPATCH_TINY, logs_directory=str(tmp_path),
                               **over))
    exp = CrowdExperiment(settings, device="cuda")
    exp.dataset_setup()
    exp.models = exp.model_setup()
    exp.state = init_train_state(settings, exp.models)
    exp.prepare_train_step()
    return exp


def test_chunk_replays_are_their_eager_steps_bit_for_bit(tmp_path,
                                                         monkeypatch):
    """3 chunks of 2 (eager, capture and replay, replay) against 6 single
    eager steps: metrics, models and the generator bit for bit (cuDNN's
    deterministic algorithms in both; a throwaway step first, as in
    chip_smoke.py's phase 14 (a): the first step of a configuration in a
    process may differ from every later one by an ulp, graph or not)."""
    from srgan_tpu_torch.utils.cuda_graph import TrainChunk

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = []
    for chunked in (None, True, False):
        exp = _manual_crowd(tmp_path)
        args = exp._patch_args_stream()
        data = exp._device_data
        metrics = []
        before = (TrainChunk.captures, TrainChunk.replays)
        for _ in range(1 if chunked is None else 3):
            if chunked:
                out = exp.dispatch_chunk(args)
                metrics += [{k: v[i].cpu() for k, v in out.items()}
                            for i in range(2)]
                continue
            for _ in range(2):
                batch = exp._sample_batch(
                    data["labeled_images"], data["labeled_density"],
                    data["unlabeled_images"], *next(args))
                exp.state, m = exp._train_step(exp.state, *batch, exp._rng)
                metrics.append({k: v.cpu() for k, v in m.items()})
        if chunked:
            assert (TrainChunk.captures - before[0],
                    TrainChunk.replays - before[1]) == (1, 2)
        runs.append((metrics, {n: getattr(exp.state, n).state_dict()
                               for n in ("d", "g", "dnn")},
                     exp._rng.get_state(), exp.state.step))
    (a, models_a, rng_a, step_a), (b, models_b, rng_b, step_b) = runs[1:]
    for i, (x, y) in enumerate(zip(a, b)):
        for k in y:
            assert torch.equal(x[k], y[k]), (i, k)
    for name in models_b:
        for k, v in models_b[name].items():
            assert torch.equal(models_a[name][k], v), (name, k)
    assert torch.equal(rng_a, rng_b) and step_a == step_b == 6


def test_spans_leave_chunks_bit_for_bit_and_a_replay_is_one_span(
        tmp_path, monkeypatch):
    """3 chunks of 2 with the program's spans on (a profiler records),
    against the same with no profiler (after a throwaway chunk, as
    above): metrics and models bit for bit. Each chunk is one host-only
    ``loop.chunk`` span; the eager chunk's step phases are timed on the
    card, the capture's are host-only, and a replay has none."""
    from srgan_tpu_torch.utils import trace

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    warm = _manual_crowd(tmp_path)
    warm.dispatch_chunk(warm._patch_args_stream())
    runs = []
    trace.take()
    for on in (False, True):
        profiler = (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) if on
            else contextlib.nullcontext())
        with profiler:
            exp = _manual_crowd(tmp_path)
            args = exp._patch_args_stream()
            metrics = [{k: v.cpu() for k, v in exp.dispatch_chunk(
                args).items()} for _ in range(3)]
            runs.append((metrics, {n: getattr(exp.state, n).state_dict()
                                   for n in ("d", "g", "dnn")}))
            spans = trace.take().spans
    (a, models_a), (b, models_b) = runs
    for x, y in zip(a, b):
        for k in y:
            assert torch.equal(x[k], y[k]), k
    for name in models_b:
        for k, v in models_b[name].items():
            assert torch.equal(models_a[name][k], v), (name, k)
    chunks = [s for s in spans if s.name == "loop.chunk"]
    assert len(chunks) == 3
    assert all(s.device_self_ms is None for s in chunks)
    backward = [s for s in spans if s.name == "step.d.backward"]
    assert len(backward) == 4  # 2 eager steps, 2 captured, 0 replayed
    assert [s.device_self_ms is not None for s in backward] == [
        True, True, False, False]
    assert all(s.device_self_ms > 0 for s in backward[:2])


def test_each_replay_draws_from_where_the_generator_stands():
    """A chunk that draws z: the eager chunk, the capture's replay and a
    replay draw what three eager draws from the same seed do, and leave
    the generator where they leave theirs."""
    from srgan_tpu_torch.utils.cuda_graph import TrainChunk

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(11)
    twin = torch.Generator(dev).manual_seed(11)

    def body(args):
        return {"z": torch.randn((2, 64), generator=gen, device=dev)
                + args.float().sum()}

    chunk = TrainChunk(body, 2, 3, dev, gen)
    zeros = np.zeros((2, 3), np.int32)
    outs = [chunk(zeros)["z"].clone() for _ in range(3)]
    for out in outs:
        torch.testing.assert_close(
            out, torch.randn((2, 64), generator=twin, device=dev),
            rtol=0, atol=0)
    assert not torch.equal(outs[1], outs[2])
    assert torch.equal(gen.get_state(), twin.get_state())


def test_launch_counters_count_what_a_replay_runs():
    """A chunk of 2 sampler calls: 2 launches counted a chunk, eager,
    captured and replayed alike; one capture, two replays."""
    from srgan_tpu_torch.utils.cuda_graph import TrainChunk

    images, indices, offsets, flips = _inputs(torch.uint8, 3)
    dev = images.device

    def body(args):
        rows = [extract_patches(images, offsets, flips, patch_size=P,
                                indices=(indices + r[0]) % N) for r in args]
        return {"patches": torch.stack(rows)}

    chunk = TrainChunk(body, 2, 1, dev, torch.Generator(dev))
    before = (extract_patches.launches, TrainChunk.captures,
              TrainChunk.replays)
    for c in range(3):
        out = chunk(np.array([[c], [c + 1]], np.int32))["patches"]
        torch.cuda.synchronize()
        assert extract_patches.launches - before[0] == 2 * (c + 1)
        for r in range(2):
            want = extract_patches_plain(images, offsets, flips,
                                         patch_size=P,
                                         indices=(indices + c + r) % N)
            torch.testing.assert_close(out[r], want, rtol=0, atol=0)
    assert (TrainChunk.captures - before[1],
            TrainChunk.replays - before[2]) == (1, 2)


def test_a_plain_sampler_under_capture_raises():
    images, indices, offsets, flips = _inputs(torch.uint8, 3)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="cannot run under CUDA graph"):
        with torch.cuda.graph(graph):
            extract_patches_plain(images, offsets, flips, patch_size=P,
                                  indices=indices)


def test_debug_nans_with_chunks_is_refused_on_the_card(tmp_path):
    with pytest.raises(ValueError, match="debug_nans runs on the CPU only"):
        _manual_crowd(tmp_path, debug_nans=True)


def test_a_gloo_world_on_a_card_refuses_chunks(tmp_path):
    """Two ranks on cuda:0 run over gloo, whose collectives a CUDA graph
    cannot capture: K = 2 raises in the ranks."""
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="needs NCCL"):
        _dp_train(tmp_path, ["cuda:0", "cuda:0"], steps_per_dispatch=2)


def test_a_checkpoint_moves_between_k2_and_k1(tmp_path):
    """Saved at K = 2 (Adam's step on the card), resumed at K = 1 (on the
    host) and again at K = 2: each resume trains on from its checkpoint."""
    from srgan_tpu_torch import CrowdExperiment, Settings

    trial = None
    for k, steps in ((2, 2), (1, 4), (2, 6)):
        settings = Settings(**dict(
            DISPATCH_TINY, logs_directory=str(tmp_path), steps_to_run=steps,
            steps_per_dispatch=k, load_model_path=trial))
        exp = CrowdExperiment(settings, device="cuda")
        state = exp.train()
        assert state.step == steps
        where = {s["step"].device.type
                 for opt in (state.d_opt, state.g_opt, state.dnn_opt)
                 for s in opt.adam.state.values()}
        assert where == {"cuda" if k > 1 else "cpu"}
        assert {float(s["step"]) for s in state.d_opt.adam.state.values()
                } == {float(steps)}
        trial = exp.trial_directory


# Tensor parallelism on the card, small versions of chip_smoke.py's phase
# 15: a grid of data 1 × model 2 over gloo on cuda:0 named twice, float32.
# The trained models are held to one rank by JAX's tolerances (the losses
# rtol 5e-4, atol 5e-5; the parameters 2.1·lr a step, Adam's sign noise);
# a sharded conv → fused norm → conv block to its unsharded self, the
# norm kernels launched at the sharded shape.
def test_tensor_parallel_ranks_train_as_one_rank(tmp_path):
    import torch_dp_workers as workers
    from srgan_tpu_torch import CrowdExperiment, Settings
    from srgan_tpu_torch.parallel import launch

    settings = Settings(**dict(DP_TINY, logs_directory=str(tmp_path),
                               data_parallel_devices=1,
                               model_parallel_devices=2))
    results = launch.run_experiment(
        CrowdExperiment, settings, ["cuda:0", "cuda:0"],
        action=workers.tp_trained_models, model=2,
        trial_directory=str(tmp_path / "grid"), timeout_s=300,
        collective_timeout_s=120, directory=str(tmp_path / "store"))
    one = CrowdExperiment(settings.copy(model_parallel_devices=1,
                                        trial_name="one"), device="cuda")
    state = one.train()
    bound = 2.1 * settings.learning_rate * settings.steps_to_run
    for got in results:
        assert got["step"] == settings.steps_to_run
        for name in ("d", "g", "dnn"):
            for k, v in got[name].items():
                want = getattr(state, name).state_dict()[k].cpu()
                assert float((v - want).abs().max()) <= bound, (name, k)
    for name in ("d", "g", "dnn"):
        for k, v in results[0][name].items():
            assert torch.equal(v, results[1][name][k]), (name, k)
    one.close()


def test_tensor_parallel_block_runs_the_kernels_at_sharded_shapes(
        tmp_path):
    import torch_dp_workers as workers
    from srgan_tpu_torch.parallel import launch

    results = launch.launch(
        workers.tp_block, ["cuda:0", "cuda:0"],
        (3, 96, 6, 32, "pallas", 7, "cuda"), model=2, timeout_s=300,
        collective_timeout_s=120, directory=str(tmp_path / "store"))
    for got in results:
        assert (got["local_width"], got["local_groups"]) == (48, 16)
        for key in ("y", "gx", "penalty"):
            torch.testing.assert_close(got["got"][key], got["want"][key],
                                       rtol=1e-5, atol=1e-5)
        for k, g in got["want"]["grads"].items():
            torch.testing.assert_close(got["got"]["grads"][k], g,
                                       rtol=1e-5, atol=1e-5)
    # The kernels at the sharded shape [B, HW, C/2] with G/2 groups
    # against their plain versions.
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((4, 64, 48), generator=gen, device="cuda")
    dy = torch.randn_like(x)
    scale = torch.rand(48, generator=gen, device="cuda") + 0.5
    bias = torch.randn(48, generator=gen, device="cuda")
    y, mean, rstd = fn._launch_fwd(x, scale, bias, 16, 0.2, 1e-6)
    dx, dscale, dbias = fn._launch_bwd(x, scale, bias, mean, rstd, dy, 16,
                                       0.2)
    want = fn.group_norm_act_fwd_plain(x, scale, bias, 16, 0.2, 1e-6)
    for a, b in zip((y, mean, rstd), want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    want = fn.group_norm_act_bwd_plain(x, scale, bias, mean, rstd, dy, 16,
                                       0.2)
    for a, b in zip((dx, dscale, dbias), want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
