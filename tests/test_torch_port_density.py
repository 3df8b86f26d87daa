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
