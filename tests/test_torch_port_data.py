"""The PyTorch port's framework-neutral pieces against the JAX package:
Settings, the synthetic crowd database, the host patch-argument draws, and
the rule that the port never imports JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.data.crowd import CrowdDatabase as JaxCrowdDatabase
from srgan_tpu.data.crowd import \
    synthetic_crowd_database as jax_synthetic_crowd_database
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.data.crowd import CrowdDatabase, synthetic_crowd_database
from srgan_tpu_torch.settings import Settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_settings_fields_and_defaults_equal_jax():
    assert _fields(Settings) == _fields(JaxSettings)
    overrides = dict(trial_name="x", learning_rate=3e-4, batch_size=7,
                     gradient_penalty_multiplier=0.5)
    assert (Settings(**overrides).trial_directory_name()
            == JaxSettings(**overrides).trial_directory_name())


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_database_is_byte_identical(seed):
    kw = dict(count=3, height=80, width=96, max_heads=8, sigma=4.0,
              seed=seed)
    ours, theirs = synthetic_crowd_database(**kw), \
        jax_synthetic_crowd_database(**kw)
    for name in ("images", "density_maps", "head_counts"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name


def test_database_file_loads_in_either_package(tmp_path):
    db = jax_synthetic_crowd_database(2, height=40, width=48, seed=1)
    db.image_statistics()
    path = str(tmp_path / "split.npz")
    db.save(path)
    ours = CrowdDatabase.load(path)
    np.testing.assert_array_equal(ours.images, db.images)
    np.testing.assert_array_equal(ours.density_maps, db.density_maps)
    np.testing.assert_array_equal(ours.image_statistics()[1],
                                  db.image_statistics()[1])
    ours.save(path)
    np.testing.assert_array_equal(JaxCrowdDatabase.load(path).head_counts,
                                  db.head_counts)


def _experiments(batch=5):
    kw = dict(batch_size=batch, image_patch_size=32, seed=3)
    lab = synthetic_crowd_database(6, height=80, width=96, seed=3)
    unl = synthetic_crowd_database(4, height=72, width=88, seed=4)
    ours, theirs = CrowdExperiment(Settings(**kw), device="cpu"), \
        JaxCrowdExperiment(JaxSettings(**kw))
    for exp in (ours, theirs):
        exp.labeled_db, exp.unlabeled_db = lab, unl
        exp._labeled_index_bound, exp._unlabeled_index_bound = 6, 4
    return ours, theirs


def test_random_patch_args_draw_the_same_numbers():
    ours, theirs = _experiments()
    a = ours._random_patch_args(np.random.default_rng(9), 6, (80, 96), 5)
    b = theirs._random_patch_args(np.random.default_rng(9), 6, (80, 96), 5)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[3], 0)  # scale index: rescale is off


def test_patch_args_stream_draws_the_same_numbers():
    ours, theirs = _experiments()
    theirs._labeled_local_counts = None
    a, b = ours._patch_args_stream(), theirs._patch_args_stream()
    for _ in range(3):
        x, y = next(a), next(b)
        # (idx, offs, flips, sidx) labeled + the same unlabeled.
        assert len(x) == len(y) == 8
        for ours_arr, jax_arr in zip(x, y):
            np.testing.assert_array_equal(ours_arr, jax_arr)


def test_port_imports_no_jax():
    code = ("import sys, srgan_tpu_torch, srgan_tpu_torch.convert, "
            "srgan_tpu_torch.ops.patches, srgan_tpu_torch.ops._build, "
            "srgan_tpu_torch.metrics, srgan_tpu_torch.apps.common; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'PIL', "
            "'srgan_tpu')); print(bad); sys.exit(1 if bad else 0)")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr
