"""The port's random-rescale sampler against the JAX package's.

* ``resize_weights`` against the weights ``jax.image.resize`` applies,
  read back by resizing an identity matrix along one axis;
* ``extract_rescaled_patches_plain`` (what the wrapper runs on the CPU)
  against ``srgan_tpu.ops.patches.extract_rescaled_patches`` (its Pallas
  row kernel in interpret mode, then ``jax.image.resize``) and against the
  port's NumPy reference;
* the crowd app's rescale draws and its sampler against the JAX app's.

Tolerances: both sides compute the same float32 terms, summed in other
orders (the resize is one einsum in XLA, two contractions here), so
images in [−1, 1] agree within 2e-6 and labels within 1e-5 of their
largest value. A window of side P is not resized on either side: it
equals the reference exactly, and JAX's exactly for labels and within one
rounding, 2⁻²³, for images, where XLA on the CPU contracts
x · scale + shift into one FMA (as in ``test_torch_port_patches.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.ops import patches as jax_patches
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.ops.patches import (_tap_table,
                                         extract_rescaled_patches,
                                         extract_rescaled_patches_plain,
                                         extract_rescaled_patches_reference,
                                         resize_weights, sampler_plan,
                                         tile_source_rows)
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state
from srgan_tpu_torch.utils import trace

N, H, W, P = 3, 80, 96, 32
FLOAT32_ULP_OF_ONE = 2.0 ** -23  # also one rounding of a value in [−1, 1]


def _identity_readback(ws):
    return np.asarray(jax.image.resize(jnp.eye(ws, dtype=jnp.float32),
                                       (P, ws), method="bilinear"))


@pytest.mark.parametrize("ws", [24, 32, 40, 19, 45])
def test_resize_weights_are_jax_weights(ws):
    ours = resize_weights(ws, P)
    # Op by op, JAX computes exactly these weights.
    with jax.disable_jit():
        np.testing.assert_array_equal(ours, _identity_readback(ws))
    # Its compiled CPU program contracts some multiply-adds into FMAs:
    # within one float32 rounding of a weight ≤ 1.
    np.testing.assert_allclose(ours, _identity_readback(ws), rtol=0,
                               atol=FLOAT32_ULP_OF_ONE)


def _sampler_inputs(windows, seed=0):
    """Every scale present, both flips, offsets at both bounds."""
    rng = np.random.default_rng(seed)
    b = 4 * len(windows)
    sidx = np.arange(b, dtype=np.int32) % len(windows)
    win = np.asarray(windows)[sidx]
    offs = np.stack([rng.integers(0, H - win + 1),
                     rng.integers(0, W - win + 1)], -1).astype(np.int32)
    offs[0] = 0
    offs[1] = [H - win[1], W - win[1]]
    flips = (np.arange(b) // len(windows) % 2).astype(np.int32)
    idx = rng.integers(0, N, b).astype(np.int32)
    images = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    labels = (rng.random((N, H, W, 1), np.float32) * 2e-2).astype(np.float32)
    return images, labels, offs, flips, sidx, idx


CASES = {  # name: (source, scale, shift, preserve_mass)
    "images uint8": ("images", 2.0 / 255.0, -1.0, False),
    "labels float32": ("labels", 1.0, 0.0, True),
    "labels bfloat16": ("labels_bf16", 1.0, 0.0, True),
}


@pytest.mark.parametrize("factors", [(0.75, 1.0, 1.25), (0.6, 1.4)])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_and_reference(factors, case):
    windows = tuple(int(round(P * f)) for f in factors)
    images, labels, offs, flips, sidx, idx = _sampler_inputs(windows)
    source, scale, shift, mass = CASES[case]
    kw = dict(patch_size=P, window_sizes=windows, scale=scale, shift=shift,
              preserve_mass=mass)
    if source == "images":
        src_np, src_j, src_t = images, jnp.asarray(images), \
            torch.from_numpy(images)
    else:
        src_j = jnp.asarray(labels)
        src_t = torch.from_numpy(labels)
        if source == "labels_bf16":
            src_j = src_j.astype(jnp.bfloat16)
            src_t = src_t.to(torch.bfloat16)
        src_np = src_t.float().numpy()
    want = np.asarray(jax_patches.extract_rescaled_patches(
        src_j, jnp.asarray(offs), jnp.asarray(flips), jnp.asarray(sidx),
        indices=jnp.asarray(idx), **kw))
    got = extract_rescaled_patches_plain(
        src_t, torch.from_numpy(offs), torch.from_numpy(flips),
        torch.from_numpy(sidx), indices=torch.from_numpy(idx), **kw).numpy()
    ref = extract_rescaled_patches_reference(src_np, offs, flips, sidx,
                                             indices=idx, **kw)
    assert got.shape == want.shape == (len(idx), P, P, src_np.shape[-1])
    atol = 2e-6 if source == "images" else 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(ref, want, rtol=0, atol=atol)
    identity = np.asarray(windows)[sidx] == P
    np.testing.assert_array_equal(got[identity], ref[identity])
    np.testing.assert_allclose(
        got[identity], want[identity], rtol=0,
        atol=FLOAT32_ULP_OF_ONE if source == "images" else 0.0)


@pytest.mark.parametrize("ws", [24, 32, 40])
def test_label_patch_keeps_the_mass_of_a_uniform_window(ws):
    # The mass factor undoes the resize's change of area exactly where
    # the density is uniform (the resize weights of each output sum to 1).
    density = torch.full((1, H, W, 1), 0.01)
    out = extract_rescaled_patches(
        density, torch.tensor([[3, 5]], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32),
        torch.tensor([[24, 32, 40].index(ws)], dtype=torch.int32).view(1),
        patch_size=P, window_sizes=(24, 32, 40), preserve_mass=True)
    np.testing.assert_allclose(float(out.double().sum()), 0.01 * ws * ws,
                               rtol=1e-5)


def test_cpu_wrapper_launches_no_kernel():
    windows = (24, 32, 40)
    images, _, offs, flips, sidx, idx = _sampler_inputs(windows)
    before = trace.counters()["extract_rescaled_patches.launches"]
    got = extract_rescaled_patches(
        torch.from_numpy(images), torch.from_numpy(offs),
        torch.from_numpy(flips), torch.from_numpy(sidx), patch_size=P,
        window_sizes=windows, indices=torch.from_numpy(idx))
    assert trace.counters()["extract_rescaled_patches.launches"] == before
    assert got.device.type == "cpu" and got.dtype == torch.float32


@pytest.mark.parametrize("windows,match", [((0, 32), "≥ 1"),
                                           ((32, 81), "exceeds image")])
def test_window_sizes_are_checked(windows, match):
    images, _, offs, flips, sidx, idx = _sampler_inputs((24, 32))
    with pytest.raises(ValueError, match=match):
        extract_rescaled_patches(
            torch.from_numpy(images), torch.from_numpy(offs),
            torch.from_numpy(flips), torch.from_numpy(sidx % 2),
            patch_size=P, window_sizes=windows,
            indices=torch.from_numpy(idx))


# The rescale kernel's launch plan (``sampler_plan``): at the flagship's
# three calls of a step (uint8 images, float32 labels; bfloat16 labels), at
# the tests' windows, at rows that are not whole 16-byte vectors (W = 97,
# P = 30), and at batches of 1 and 300: (B, H, W, C, P, itemsize, windows).
FLAGSHIP_WINDOWS = (168, 224, 280)
PLAN_CASES = [(120, 384, 512, 3, 224, 1, FLAGSHIP_WINDOWS),
              (120, 384, 512, 1, 224, 4, FLAGSHIP_WINDOWS),
              (120, 384, 512, 1, 224, 2, FLAGSHIP_WINDOWS),
              (12, H, W, 3, P, 1, (24, 32, 40)), (8, H, W, 1, P, 4, (19, 45)),
              (300, H, W, 3, P, 1, (24, 32, 40)),
              (300, H, 97, 1, 30, 2, (19, 45)), (1, H, 97, 3, 30, 1, (24, 40))]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_rescale_plan_stages_every_tap_of_each_tile(case):
    """Every output row in exactly one tile; each tile's staged rows hold
    every tap that ``_tap_table`` gives its rows (up to the first past the
    window, where the kernel's sum ends) and every nonzero resize weight,
    inside the window; shared memory within the H100's 227 KB."""
    *shape, windows = case
    b, h, w, c, p, itemsize = shape
    plan = sampler_plan(*shape, windows)
    first, _, taps = _tap_table(windows, p)
    rows = plan.tile_rows
    covered = np.zeros(p, int)
    for y0 in range(0, p, rows):
        y1 = min(y0 + rows, p)
        covered[y0:y1] += 1
        for s, ws in enumerate(windows):
            if ws == p:  # copied: the tile's own rows
                assert y1 - y0 <= plan.staged_rows
                continue
            j0, j1 = tile_source_rows(first[s], ws, taps, y0, y1)
            assert 0 <= j0 <= j1 < ws and j1 - j0 + 1 <= plan.staged_rows
            weights = resize_weights(ws, p)
            for y in range(y0, y1):
                read = [first[s, y] + k for k in range(taps)
                        if first[s, y] + k < ws]
                assert j0 <= min(read) and max(read) <= j1
                nonzero = np.nonzero(weights[y])[0]
                assert j0 <= nonzero.min() and nonzero.max() <= j1
    np.testing.assert_array_equal(covered, 1)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.smem_bytes <= 227 * 1024
    if p == 224:  # the flagship's calls fill the 132 SMs twice over
        assert rows > 1 and b * -(-p // rows) >= 16 * 132


@pytest.mark.parametrize("shape,windows,match", [
    ((12, H, W, 3, P, 1), (0, 32), "≥ 1"),
    ((12, H, W, 3, P, 1), (32, 81), "exceeds image"),
    ((12, H, W, 3, 0, 1), (24, 32), "patch_size must be ≥ 1"),
    ((1, 30000, 30000, 3, 224, 4), (20000,),
     "exceeds the kernel's 232448 bytes"),
    ((65536, H, W, 3, P, 1), (24, 32), "at most 65535 examples"),
])
def test_rescale_plan_refuses_what_the_kernel_does_not_take(shape, windows,
                                                           match):
    """The plan raises the wrapper's error (the wrapper calls it before a
    launch)."""
    with pytest.raises(ValueError, match=match):
        sampler_plan(*shape, windows)


# ---------------------------------------------------------------- the app
TINY = dict(batch_size=4, image_patch_size=P, model_base_width=8,
            latent_dimension=16, labeled_dataset_size=6,
            unlabeled_dataset_size=6, validation_dataset_size=1,
            test_dataset_size=1, crowd_image_height=H, crowd_image_width=W,
            crowd_synthetic_max_heads=12, seed=3, data_parallel_devices=1)


def _prepared(factors):
    """The JAX and the port experiment, ready to sample."""
    kw = dict(TINY, crowd_rescale_factors=factors)
    theirs = JaxCrowdExperiment(JaxSettings(**kw))
    theirs.dataset_setup()
    models, d, g, dnn = theirs.model_setup()
    theirs.models = models
    theirs.state = jax_init_train_state(theirs.settings, d, g, dnn)
    theirs.prepare_mesh()
    theirs.prepare_train_step()
    ours = CrowdExperiment(Settings(**kw), device="cpu")
    ours.dataset_setup()
    ours.models = ours.model_setup()
    ours.state = init_train_state(ours.settings, ours.models)
    ours.prepare_train_step()
    return ours, theirs


@pytest.fixture(scope="module", params=[(), (0.75, 1.0, 1.25)],
                ids=["fixed", "rescale"])
def prepared(request):
    return request.param, _prepared(request.param)


def test_patch_args_stream_equals_jax(prepared):
    factors, (ours, theirs) = prepared
    a, b = ours._patch_args_stream(), theirs._patch_args_stream()
    for _ in range(3):
        x, y = next(a), next(b)
        assert len(x) == len(y) == 8
        for ours_arr, jax_arr in zip(x, y):
            assert ours_arr.dtype == jax_arr.dtype
            np.testing.assert_array_equal(ours_arr, jax_arr)
    if factors:
        assert len(set(np.concatenate([x[3], x[7]]).tolist())) > 1


def test_sample_batch_equals_jax(prepared):
    factors, (ours, theirs) = prepared
    args = next(theirs._patch_args_stream())
    jd = theirs._device_data
    want = [np.asarray(t) for t in theirs._sample_batch(
        jd["labeled_images"], jd["labeled_density"], jd["unlabeled_images"],
        *args)]
    od = ours._device_data
    got = ours._sample_batch(od["labeled_images"], od["labeled_density"],
                             od["unlabeled_images"], *args)
    got = [got[0].permute(0, 2, 3, 1).numpy(), got[1].numpy(),
           got[2].permute(0, 2, 3, 1).numpy()]
    for name, g, w in zip(("images", "labels", "unlabeled"), got, want):
        assert g.shape == w.shape, name
        if not factors:
            atol = 0.0 if name == "labels" else FLOAT32_ULP_OF_ONE
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=name)
        else:
            atol = 1e-5 * float(np.abs(w).max()) if name == "labels" \
                else 2e-6
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=name)


def test_prepare_train_step_rejects_an_oversized_factor():
    exp = CrowdExperiment(Settings(**dict(TINY, crowd_rescale_factors=(
        1.0, 4.0))), device="cpu")
    exp.dataset_setup()
    exp.models = exp.model_setup()
    exp.state = init_train_state(exp.settings, exp.models)
    with pytest.raises(ValueError, match="smallest image dimension"):
        exp.prepare_train_step()
