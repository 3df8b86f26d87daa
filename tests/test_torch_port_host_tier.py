"""The port's host tier against the JAX package's, on the CPU.

``srgan_tpu_torch/io/native.py`` (the port's ctypes wrapper of its own
``srgan_tpu_torch/csrc/srgan_io.cc``, built into
``srgan_tpu_torch/build/``) gives the JAX wrapper's crops bit for bit:
the reader's gathers, and the prefetcher's batches and draws for the
same seed (one worker thread, so that the batch order is the seed's
alone). The crowd app's host tier
(``crowd_host_pipeline``) gives JAX's batches, and one step on them
equals JAX's on the same draws: metrics rtol 1e-3, gradients within
1e-3 of each tensor's largest (``tests/test_torch_port_train_step.py``
sets out why). The metrics' 1e-3: on these batches the gradient penalty
and G's loss differ from JAX's by 2.9e-4 and 3.0e-4 of their value even
when both steps take the same normalized inputs (the double backward's
float32 rounding in a tiny model); JAX's normalization inside its jitted
step rounds the inputs within one ulp of the port's. Also: the refusals
and the library's build.
"""

import concurrent.futures
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.io import NativeDatasetReader as JaxReader
from srgan_tpu.io import NativePrefetcher as JaxPrefetcher
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu.utils.mixture import sample_offset_normal as jax_sample_z
from srgan_tpu_torch import convert
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.io import native
from srgan_tpu_torch.io.native import NativeDatasetReader, NativePrefetcher
from srgan_tpu_torch.ops.patches import extract_patches_reference
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, LATENT = 4, 32, 16
TINY = dict(batch_size=B, image_patch_size=P, model_base_width=8,
            latent_dimension=LATENT, labeled_dataset_size=6,
            unlabeled_dataset_size=6, validation_dataset_size=3,
            test_dataset_size=2, crowd_image_height=80,
            crowd_image_width=96, crowd_synthetic_max_heads=12, seed=3,
            zero_init_heads=False, mean_offset=0.5, number_of_data_workers=1,
            crowd_host_pipeline=True, data_parallel_devices=1)


def _npy(tmp_path, array, name):
    path = str(tmp_path / name)
    np.save(path, array)
    return path


# --------------------------------------------------------------- the wrapper
def test_the_library_builds_into_the_ports_build_directory():
    path = native.build_library()
    assert os.path.dirname(path) == os.path.join(REPO, "srgan_tpu_torch",
                                                 "build")
    assert os.path.basename(path).startswith("libsrgan_io_")
    assert path == native.library_path()


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        paths = set(pool.map(lambda _: native.build_library(), range(3)))
    assert paths == {native.library_path()}
    assert os.listdir(tmp_path) == [os.path.basename(paths.pop())]


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 3), (np.float32, 1),
                                            (np.float32, 2)])
def test_gathers_equal_jax_and_the_reference(tmp_path, dtype, channels):
    rng = np.random.default_rng(channels)
    array = rng.integers(0, 256, (5, 30, 41, channels)).astype(dtype)
    path = _npy(tmp_path, array, "data.npy")
    idx = rng.integers(0, 5, 7).astype(np.int32)
    offs = np.stack([rng.integers(0, 30 - 8 + 1, 7),
                     rng.integers(0, 41 - 8 + 1, 7)], -1).astype(np.int32)
    offs[0] = (22, 33)
    flips = rng.integers(0, 2, 7).astype(np.int32)
    with NativeDatasetReader(path) as ours, JaxReader(path) as theirs:
        assert ours.shape == theirs.shape == array.shape
        assert ours.dtype == theirs.dtype == dtype
        got = ours.gather_crops(idx, offs, flips, 8, 2 / 255.0, -1.0)
        want = theirs.gather_crops(idx, offs, flips, 8, 2 / 255.0, -1.0)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, extract_patches_reference(
            array.astype(np.float32), offs, flips, 8, 2 / 255.0, -1.0,
            indices=idx), rtol=1e-6, atol=1e-6)
        with pytest.raises(ValueError, match="out of bounds"):
            ours.gather_crops(idx, offs + 1, flips, 8)


@pytest.mark.parametrize("output_dtype", ["uint8", "float32"])
def test_prefetcher_batches_equal_jax_for_the_same_seed(tmp_path,
                                                         output_dtype):
    images = np.random.default_rng(9).integers(0, 256, (6, 24, 28, 3)
                                               ).astype(np.uint8)
    path = _npy(tmp_path, images, "img.npy")
    kw = dict(batch_size=5, patch_size=8, num_threads=1, seed=17,
              output_dtype=output_dtype)
    if output_dtype == "float32":
        kw.update(scale=2 / 255.0, shift=-1.0)
    with NativeDatasetReader(path) as r1, JaxReader(path) as r2, \
            NativePrefetcher(r1, **kw) as ours, \
            JaxPrefetcher(r2, **kw) as theirs:
        for _ in range(4):
            got, want = ours.next_with_params(), theirs.next_with_params()
            assert got[0].dtype == np.dtype(output_dtype)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_wrapper_refusals(tmp_path):
    floats = _npy(tmp_path, np.zeros((2, 16, 16, 3), np.float32), "f.npy")
    bytes_ = _npy(tmp_path, np.zeros((2, 16, 16, 3), np.uint8), "u.npy")
    with NativeDatasetReader(floats) as reader:
        with pytest.raises(ValueError, match="uint8"):
            NativePrefetcher(reader, 2, 8, output_dtype="uint8")
        with pytest.raises(ValueError, match="prefetcher creation"):
            NativePrefetcher(reader, 2, 32)
    with NativeDatasetReader(bytes_) as reader:
        with pytest.raises(ValueError, match="scale/shift"):
            NativePrefetcher(reader, 2, 8, scale=2.0, output_dtype="uint8")
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not a numpy file")
    with pytest.raises(OSError):
        NativeDatasetReader(str(bad))
    with pytest.raises(OSError):
        NativeDatasetReader(_npy(tmp_path, np.zeros((4, 4), np.float32),
                                 "flat.npy"))


# ------------------------------------------------------- the crowd host tier
def _jax_host_experiment(kw):
    exp = JaxCrowdExperiment(JaxSettings(**kw))
    exp.dataset_setup()
    models, d, g, dnn = exp.model_setup()
    exp.models = models
    exp.state = jax_init_train_state(exp.settings, d, g, dnn)
    exp.prepare_mesh()
    with pytest.warns(UserWarning, match="crowd_host_pipeline"):
        exp.prepare_train_step()
    return exp, (d, g, dnn)


def _port_host_experiment(kw, params=None):
    exp = CrowdExperiment(Settings(**kw), device="cpu")
    exp.dataset_setup()
    bundle = exp.model_setup()
    if params is not None:
        d, g, dnn = map(jax.device_get, params)
        bundle.d.load_state_dict(convert.joint_cnn_state_dict(d))
        bundle.g.load_state_dict(convert.generator_state_dict(g))
        bundle.dnn.load_state_dict(convert.joint_cnn_state_dict(dnn))
    exp.models = bundle
    exp.state = init_train_state(exp.settings, bundle)
    with pytest.warns(UserWarning, match="crowd_host_pipeline"):
        exp.prepare_train_step()
    return exp


def _first_batches(exp, count):
    batches = (b for epoch in exp.epoch_batch_iterators() for b in epoch)
    return [next(batches) for _ in range(count)]


@pytest.mark.parametrize("label_type", ["density", "iknn"])
def test_host_batches_equal_jax(tmp_path, label_type):
    kw = dict(TINY, crowd_label_type=label_type,
              logs_directory=str(tmp_path))
    theirs, _ = _jax_host_experiment(kw)
    ours = _port_host_experiment(kw)
    try:
        for got, want in zip(_first_batches(ours, 3),
                             _first_batches(theirs, 3)):
            for a, b, what in zip(got, want, ("patches", "labels",
                                              "unlabeled")):
                b = np.asarray(jax.device_get(b))
                assert a.dtype == (torch.uint8 if what != "labels"
                                   else torch.float32), what
                np.testing.assert_array_equal(a.numpy(), b, err_msg=what)
    finally:
        ours.close()


@pytest.fixture(scope="module", params=["density", "iknn"])
def host_steps(request, tmp_path_factory):
    kw = dict(TINY, crowd_label_type=request.param,
              logs_directory=str(tmp_path_factory.mktemp("host")))
    theirs, params = _jax_host_experiment(kw)
    ours = _port_host_experiment(kw, params)
    try:
        (p, y, u), = _first_batches(ours, 1)
        (jp, jy, ju), = _first_batches(theirs, 1)
        key = jax.random.key(11)
        j_state, j_metrics = theirs._train_step(theirs.state, jp, jy, ju,
                                                key)
        k_zd, k_zg, k_alpha = jax.random.split(key, 3)
        draws = dict(
            z_d=jax_sample_z(k_zd, (B, LATENT), 0.5),
            z_g=jax_sample_z(k_zg, (B, LATENT), 0.5),
            alpha=jax.random.uniform(k_alpha, (B,), dtype=jnp.float32))
        state, metrics = ours._train_step(
            ours.state, p, y, u,
            **{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    finally:
        ours.close()
    return (jax.device_get(j_state), jax.device_get(j_metrics), state,
            metrics)


def test_host_step_metrics_equal_jax(host_steps):
    _, j_metrics, _, metrics = host_steps
    assert set(metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["d", "dnn"])
def test_host_step_gradients_equal_jax(host_steps, name):
    j_state, _, state, _ = host_steps
    module = getattr(state, name)
    j_mu = convert.joint_cnn_state_dict(
        getattr(j_state, f"{name}_opt")[0].mu)
    compared = 0
    for k, p in module.named_parameters():
        norms = module.norms
        parts = k.split(".")
        if parts[0] == "convs" and parts[2] == "bias" and \
                norms[int(parts[1])].num_groups == \
                norms[int(parts[1])].scale.numel():
            continue  # cancelled by a one-channel-per-group norm
        want = j_mu[k].numpy() / 0.1  # Adam's first moment, (1 − b1)·g
        scale = float(np.abs(want).max())
        assert np.abs(p.grad.numpy() - want).max() <= 1e-3 * scale, k
        compared += 1
    assert compared > 0


def test_host_tier_trains_and_exports_by_label_type(tmp_path):
    from srgan_tpu_torch.data.crowd import synthetic_crowd_database

    root = tmp_path / "db"
    root.mkdir()
    for i, split in enumerate(("labeled", "unlabeled", "validation")):
        synthetic_crowd_database(5, 64, 72, max_heads=6, seed=i,
                                 label_type="knn").save(
            str(root / f"{split}.npz"))
    kw = dict(TINY, crowd_database_path=str(root), crowd_label_type="knn",
              crowd_label_dtype="bfloat16", steps_to_run=3,
              summary_step_period=1, logs_directory=str(tmp_path / "logs"))
    exp = CrowdExperiment(Settings(**kw), device="cpu")
    with pytest.warns(UserWarning, match="crowd_host_pipeline"):
        assert exp.train().step == 3
    assert sorted(os.listdir(root / "native_cache")) == [
        "labeled.npy", "labels_knn.npy", "unlabeled.npy"]
    assert np.load(root / "native_cache" / "labels_knn.npy",
                   mmap_mode="r").shape == (5, 64, 72, 2)
    assert all(io._handle is None for io in exp._host_io)
    assert np.isfinite(exp.evaluate()["MAE"])


def test_host_tier_refusals_are_jax_errors(tmp_path):
    exp = CrowdExperiment(Settings(**dict(
        TINY, logs_directory=str(tmp_path),
        crowd_rescale_factors=(0.75, 1.0))), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="not supported with "
                                             "crowd_host_pipeline"):
            exp.train()
    exp = CrowdExperiment(Settings(**dict(
        TINY, logs_directory=str(tmp_path), crowd_hbm_window=4)),
        device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        exp.train()
