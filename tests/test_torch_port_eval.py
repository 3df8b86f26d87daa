"""The port's crowd grid evaluation and validation against the JAX
package's, on the same weights (the flax init, converted) and the same
synthetic databases, for both norm paths ("pallas": JAX's Pallas kernels in
interpret mode, the port's plain versions). float32 on the CPU.

Tolerance: rtol 1e-4, plus an atol of 1e-3 of the largest value. The two
sides run the same convolutions and norms, summed in other orders, and the
tiny models amplify that rounding: their GroupNorms hold one channel of
8×8 to 16×16 cells per group, whose E[x²] − E[x]² statistics cancel. Over
eight seeds the D and DNN outputs on the grid patches differ by 3e-5 to
7e-4 of their largest value (float32, the same on both norm paths).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu import metrics as jax_metrics
from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu_torch import convert, metrics
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state

RTOL = 1e-4
TINY = dict(batch_size=4, image_patch_size=32, model_base_width=8,
            latent_dimension=16, labeled_dataset_size=6,
            unlabeled_dataset_size=6, validation_dataset_size=3,
            test_dataset_size=2, crowd_image_height=80, crowd_image_width=96,
            crowd_synthetic_max_heads=12, seed=4, zero_init_heads=False,
            data_parallel_devices=1)


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=1e-3 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module", params=["xla", "pallas"])
def both(request):
    kw = dict(TINY, norm_impl=request.param)
    theirs = JaxCrowdExperiment(JaxSettings(**kw))
    theirs.dataset_setup()
    models, d, g, dnn = theirs.model_setup()
    theirs.models = models
    theirs.state = jax_init_train_state(theirs.settings, d, g, dnn)
    theirs.prepare_mesh()
    theirs.prepare_train_step()
    ours = CrowdExperiment(Settings(**kw), device="cpu")
    ours.dataset_setup()
    bundle = ours.model_setup()
    host = jax.device_get
    bundle.d.load_state_dict(convert.joint_cnn_state_dict(host(d)))
    bundle.dnn.load_state_dict(convert.joint_cnn_state_dict(host(dnn)))
    bundle.g.load_state_dict(convert.generator_state_dict(host(g)))
    ours.models = bundle
    ours.state = init_train_state(ours.settings, bundle)
    ours.prepare_train_step()
    return ours, theirs


@pytest.mark.parametrize("hw", [(80, 96), (32, 32), (33, 100), (224, 512)])
def test_grid_offsets_equal_jax(hw):
    ours = CrowdExperiment(Settings(image_patch_size=32), device="cpu")
    theirs = JaxCrowdExperiment(JaxSettings(image_patch_size=32))
    np.testing.assert_array_equal(ours._grid_offsets(hw),
                                  theirs._grid_offsets(hw))
    with pytest.raises(ValueError, match="smaller than"):
        ours._grid_offsets((31, 96))


@pytest.mark.parametrize("use_dnn", [False, True])
def test_density_maps_and_counts_equal_jax(both, use_dnn):
    ours, theirs = both
    for kw in (dict(), dict(limit=2)):
        got = ours.predict_density_maps(use_dnn=use_dnn, **kw)
        want = theirs.predict_density_maps(use_dnn=use_dnn, **kw)
        assert got.shape == want.shape == (kw.get("limit", 3), 20, 24)
        _close(got, want, f"maps {kw}")
    _close(ours.predict_image_counts(use_dnn=use_dnn),
           theirs.predict_image_counts(use_dnn=use_dnn), "counts")


def _variants(db):
    """The database with ROI masks, and as tiles of two source images."""
    n, h, w = db.density_maps.shape
    rois = (np.random.default_rng(0).uniform(size=(n, h, w)) < 0.5
            ).astype(np.uint8)
    return {"roi": dataclasses.replace(db, roi_masks=rois),
            "tiled": dataclasses.replace(
                db, image_ids=np.array([0, 0, 1], np.int64))}


def test_count_metrics_on_roi_and_tiled_databases_equal_jax(both):
    ours, theirs = both
    mine, jaxs = _variants(ours.validation_db), _variants(theirs.validation_db)
    for name in mine:
        got = ours._count_metrics(mine[name], ours.predict_image_counts(
            use_dnn=True, db=mine[name]))
        want = theirs._count_metrics(jaxs[name], theirs.predict_image_counts(
            use_dnn=True, db=jaxs[name]))
        assert set(got) == set(want) == {"MAE", "RMSE", "NVE", "NAE"}
        for key in want:
            _close(got[key], want[key], f"{name} {key}")


def test_evaluate_and_test_equal_jax(both):
    ours, theirs = both
    for got, want in ((ours.evaluate(), theirs.evaluate()),
                      (ours.test(use_dnn=True), theirs.test(use_dnn=True))):
        for key in want:
            _close(got[key], want[key], key)


def test_nve_divides_by_the_population_std():
    rng = np.random.default_rng(1)
    pred, labels = rng.normal(size=5), rng.normal(size=5)
    want = float(jax_metrics.nve(pred, labels))
    assert float(metrics.nve(pred, labels)) == pytest.approx(want, rel=1e-6)
    # ddof 1 would differ by sqrt(5/4):
    assert float(metrics.mae(pred, labels)) / np.std(labels, ddof=1) \
        != pytest.approx(want, rel=1e-3)
    for name in ("mae", "rmse", "count_nae"):
        assert float(getattr(metrics, name)(pred, np.abs(labels) * 3)) == \
            pytest.approx(float(getattr(jax_metrics, name)(
                pred, np.abs(labels) * 3)), rel=1e-6)


def _scalars(directory):
    with open(os.path.join(directory, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_with_rescale_writes_per_epoch_validation(tmp_path):
    settings = Settings(**dict(
        TINY, labeled_dataset_size=8, steps_to_run=4, summary_step_period=2,
        crowd_rescale_factors=(0.75, 1.0, 1.25), norm_impl="pallas",
        logs_directory=str(tmp_path)))
    exp = CrowdExperiment(settings, device="cpu")
    assert exp.train().step == 4
    for writer in ("GAN", "DNN"):
        directory = os.path.join(exp.trial_directory, writer)
        records = [r for r in _scalars(directory)
                   if r["tag"].startswith("validation/")]
        # Two steps per epoch: a validation pass after steps 2 and 4.
        assert sorted({r["step"] for r in records}) == [2, 4]
        assert {r["tag"] for r in records} == {
            f"validation/{k}" for k in ("MAE", "RMSE", "NVE", "NAE")}
        assert all(np.isfinite(r["value"]) for r in records)
        names = ["validation_density_0_4.png", "validation_density_1_4.png"]
        if writer == "GAN":
            names.append("generated_sample_3_4.png")
        for name in names:
            with Image.open(os.path.join(directory, "images", name)) as im:
                assert im.mode == "RGB" and im.size[0] > 0
                np.asarray(im)


def test_experiment_without_a_device_raises_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CrowdExperiment(Settings(**TINY))
