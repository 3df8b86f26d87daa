"""The port's density maps (``srgan_tpu_torch.ops.density``, its plain
version on the CPU) against the JAX package's Pallas kernel, run in
interpret mode, and its NumPy reference, at the shapes of
``tests/test_ops.py``. Inputs from a NumPy seed; tolerance rtol 1e-4,
atol 1e-6 (the same float32 formula summed in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.ops.density import density_maps as jax_density_maps
from srgan_tpu.ops.density import density_maps_reference
from srgan_tpu_torch.ops import density
from srgan_tpu_torch.ops.density import density_maps

TOL = dict(rtol=1e-4, atol=1e-6)


def _ours(heads, counts, sigma, h, w):
    return density_maps(torch.from_numpy(heads), torch.from_numpy(counts),
                        sigma, height=h, width=w).numpy()


def _jax(heads, counts, sigma, h, w):
    return np.asarray(jax_density_maps(jnp.asarray(heads),
                                       jnp.asarray(counts), sigma, height=h,
                                       width=w, interpret=True))


def _random_heads(b=2, n=16, h=32, w=48, seed=0):
    rng = np.random.default_rng(seed)
    heads = np.stack([rng.uniform(0, h, (b, n)), rng.uniform(0, w, (b, n))],
                     axis=-1).astype(np.float32)
    counts = rng.integers(0, n + 1, (b,)).astype(np.int32)
    return heads, counts


def test_equals_jax_kernel_and_reference():
    heads, counts = _random_heads()
    got = _ours(heads, counts, 2.0, 32, 48)
    np.testing.assert_allclose(got, _jax(heads, counts, 2.0, 32, 48), **TOL)
    np.testing.assert_allclose(
        got, density_maps_reference(heads, counts, 2.0, 32, 48), **TOL)


@pytest.mark.parametrize("seed", range(4))
def test_random_configs_equal_jax(seed):
    """Odd sizes, σ from 0.8 to 6, heads up to 5 px off the canvas."""
    rng = np.random.default_rng(200 + seed)
    h, w = int(rng.integers(9, 70)), int(rng.integers(9, 70))
    b, cap = int(rng.integers(1, 5)), int(rng.integers(1, 12))
    sigma = float(rng.uniform(0.8, 6.0))
    heads = np.stack([rng.uniform(-5, h + 5, (b, cap)),
                      rng.uniform(-5, w + 5, (b, cap))],
                     axis=-1).astype(np.float32)
    counts = rng.integers(0, cap + 1, (b,)).astype(np.int32)
    got = _ours(heads, counts, sigma, h, w)
    np.testing.assert_allclose(got, _jax(heads, counts, sigma, h, w), **TOL)
    np.testing.assert_allclose(
        got, density_maps_reference(heads, counts, sigma, h, w), **TOL)


def test_integral_equals_head_count_at_the_borders():
    heads = np.array([[[0.0, 0.0], [16.0, 24.0], [31.0, 47.0]]], np.float32)
    counts = np.array([3], np.int32)
    got = _ours(heads, counts, 3.0, 32, 48)
    np.testing.assert_allclose(got.sum(), 3.0, rtol=1e-4)
    np.testing.assert_allclose(got, _jax(heads, counts, 3.0, 32, 48), **TOL)


def test_zero_heads_give_a_zero_map():
    for n in (4, 0):
        heads = np.zeros((1, n, 2), np.float32)
        got = _ours(heads, np.array([0], np.int32), 2.0, 16, 16)
        assert got.shape == (1, 16, 16) and not got.any()


def test_finite_padding_equals_jax():
    """Slots past the count hold other heads: neither side reads them."""
    heads = np.zeros((1, 8, 2), np.float32)
    heads[0, 0] = [8.0, 8.0]
    heads[0, 1:] = [2.0, 2.0]
    counts = np.array([1], np.int32)
    got = _ours(heads, counts, 1.5, 16, 16)
    np.testing.assert_allclose(got, _jax(heads, counts, 1.5, 16, 16), **TOL)
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-4)
    assert got[0, 8, 8] > got[0, 2, 2]


def test_nan_padding_equals_the_reference():
    """JAX's kernel multiplies the padding's NaN by 0 and gives NaN; the
    port, like the NumPy reference, never reads past the count."""
    heads, counts = _random_heads(b=3, n=10, seed=3)
    counts[:] = [0, 4, 10]
    for i, c in enumerate(counts):
        heads[i, c:] = np.nan
    got = _ours(heads, counts, 2.0, 32, 48)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, density_maps_reference(heads, counts, 2.0, 32, 48), **TOL)
    assert np.isnan(_jax(heads, counts, 2.0, 32, 48)[1:]).any()


def test_a_head_far_outside_follows_the_kernel_not_the_reference():
    """The carried-over difference: a head whose mass on the canvas is
    below 1e-12 (15.5 px above a σ = 2 canvas) is divided by 1e-12, as in
    JAX's kernel, where the NumPy reference skips it."""
    heads = np.array([[[-15.5, 10.0], [5.0, 5.0]]], np.float32)
    counts = np.array([2], np.int32)
    got = _ours(heads, counts, 2.0, 16, 16)
    want = _jax(heads, counts, 2.0, 16, 16)
    np.testing.assert_allclose(got, want, **TOL)
    reference = density_maps_reference(heads, counts, 2.0, 16, 16)
    assert abs(float(reference.sum()) - 1.0) < 1e-5
    assert float(got.sum()) - float(reference.sum()) > 0.1


def test_counts_past_the_slots_are_clamped_as_in_jax():
    heads, _ = _random_heads(b=2, n=5, seed=4)
    counts = np.array([9, -1], np.int32)
    got = _ours(heads, counts, 2.5, 32, 48)
    np.testing.assert_allclose(got, _jax(heads, counts, 2.5, 32, 48), **TOL)
    assert not got[1].any()


def test_cpu_tensors_launch_no_kernel():
    heads, counts = _random_heads()
    before = density_maps.launches
    _ours(heads, counts, 2.0, 32, 48)
    assert density_maps.launches == before


# The render kernel's launch plan and its culling, on the CPU: the kernel
# itself runs only on the card (tests/test_torch_port_cuda.py).

@pytest.mark.parametrize("h,w,sigma,b,n,splits,radius", [
    (384, 512, 8.0, 16, 4096, 3, 116),   # 768 blocks, runs of ≤ 1536 slots
    (384, 512, 8.0, 1, 2000, 7, 116),    # 48 blocks; runs of ≥ 256 slots
    (384, 512, 8.0, 1, 12865, 9, 116),   # runs of ≤ 1536 slots
    (384, 512, 8.0, 1, 700, 2, 116),
    (384, 512, 8.0, 1, 100, 1, 116),
    (384, 512, 2.0, 4, 1000, 2, 29),     # 192 blocks
    (384, 512, 8.0, 90, 4096, 1, 116),   # 4320 blocks: no partial maps
    (128, 192, 4.0, 3, 70000, 46, 58),   # 18 blocks, runs of ≤ 1536 slots
    (16, 16, 4.0, 1, 70000, 64, 58),     # 1 block: the kernel's 64 runs
])
def test_density_plan(h, w, sigma, b, n, splits, radius):
    plan = density.density_plan(h, w, sigma, b, n)
    assert plan == density.DensityPlan(radius, splits)
    assert density.density_plan(h, w, sigma, b, n) is plan  # cached


def test_density_plan_refuses_what_the_kernel_does_not_take():
    for sigma in (0.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="sigma"):
            density.density_plan(8, 8, sigma, 1, 4)
    with pytest.raises(ValueError, match="65535"):
        density.density_plan(8, 8, 2.0, 65536, 4)
    with pytest.raises(ValueError, match="positive"):
        density.density_plan(0, 8, 2.0, 1, 4)


@pytest.mark.parametrize("sigma,radius", [(2.0, 29), (4.0, 58), (8.0, 116)])
def test_cull_radius_is_where_float32_exp_reaches_zero(sigma, radius):
    """exp(−k·R²) is 0 in float32 and exp(−k·(R−1)²), one pixel inside,
    is not: past R along y or x every term is exactly 0."""
    k = float(np.float32(0.5) / np.float32(sigma) ** 2)
    assert density.cull_radius(sigma) == radius
    at = torch.exp(torch.tensor(-k * radius ** 2, dtype=torch.float32))
    inside = torch.exp(torch.tensor(-k * (radius - 1) ** 2,
                                    dtype=torch.float32))
    assert float(at) == 0.0 and float(inside) > 0.0


def _culled_separable(heads, counts, sigma, h, w):
    """The render kernel's algorithm in plain torch: per 64 × 64 tile,
    the heads whose ±R box meets the tile (a NaN head always), their
    ey = w·exp(−dy²k) over the tile's rows and ex = exp(−dx²k) over its
    columns, zero past R, summed as outer products. Also asserts that the
    heads the tile drops add exactly 0 there."""
    k = float(np.float32(0.5) / np.float32(sigma) ** 2)
    r = density.cull_radius(sigma)
    tile = density.TILE
    yy = torch.arange(h, dtype=torch.float32)
    xx = torch.arange(w, dtype=torch.float32)
    b, n, _ = heads.shape
    out = torch.zeros((b, h, w))
    for i in range(b):
        c = min(max(int(counts[i]), 0), n)
        hy, hx = heads[i, :c, 0], heads[i, :c, 1]
        mass = (torch.exp(-((yy - hy[:, None]) ** 2) * k).sum(1)
                * torch.exp(-((xx - hx[:, None]) ** 2) * k).sum(1))
        wgt = 1.0 / mass.clamp_min(1e-12)
        for y0 in range(0, h, tile):
            for x0 in range(0, w, tile):
                y1, x1 = min(y0 + tile, h) - 1, min(x0 + tile, w) - 1
                far = ((y0 - hy > r) | (hy - y1 > r) | (x0 - hx > r)
                       | (hx - x1 > r))
                keep = ~far | hy.isnan() | hx.isnan()
                dy = yy[y0:y1 + 1] - hy[:, None]
                dx = xx[x0:x1 + 1] - hx[:, None]
                ey = torch.where(dy.abs() > r, 0.0,
                                 wgt[:, None] * torch.exp(-(dy * dy) * k))
                ex = torch.where(dx.abs() > r, 0.0, torch.exp(-(dx * dx) * k))
                assert not (ey[~keep].T @ ex[~keep]).any()
                out[i, y0:y1 + 1, x0:x1 + 1] = ey[keep].T @ ex[keep]
    return out


@pytest.mark.parametrize("sigma", [2.0, 3.0])
@pytest.mark.parametrize("h,w", [(70, 90), (61, 77), (130, 150)])
def test_culled_separable_form_equals_plain(sigma, h, w):
    """The culling is exact and the separable form within the kernel's
    tolerance: heads inside the canvas, up to 16 px outside (weights up to
    1e12 at σ = 2) and far outside (past R), on canvases of 2 × 2 and
    3 × 3 tiles, none a whole number of tiles."""
    rng = np.random.default_rng(31)
    inside = np.stack([rng.uniform(0, h, 20), rng.uniform(0, w, 20)], -1)
    near = np.stack([rng.uniform(-16, h + 16, 20),
                     rng.uniform(-16, w + 16, 20)], -1)
    far = np.array([[-200.0, 30.0], [35.0, w + 150.0], [-90.0, -90.0],
                    [h + 40.0, 10.0]])
    heads = np.concatenate([inside, near, far])[None].astype(np.float32)
    heads = np.concatenate([heads, heads[:, ::-1]])
    counts = np.array([heads.shape[1], 25], np.int32)
    heads_t, counts_t = torch.from_numpy(heads), torch.from_numpy(counts)
    got = _culled_separable(heads_t, counts_t, sigma, h, w)
    want = density.density_maps_plain(heads_t, counts_t, sigma, height=h,
                                      width=w)
    assert bool(((got - want).abs() <= 1e-6 + 1e-4 * want.abs()).all())
