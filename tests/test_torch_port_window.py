"""The port's window tier (``srgan_tpu_torch/data/window.py`` and its
wiring in the crowd app) against the JAX package's, on the CPU.

Exact: ``SliceStream``'s ids; ``HBMWindow``'s resident ids and buffer
contents step by step in deterministic mode; the crowd app's windows
(streams 7 and 8, seed ``[seed, stream, start]``) row for row. Also:
a windowed run's losses equal a resident run's when every example is
identical (rtol 1e-5, the counterpart of ``tests/test_window.py``), the
device-memory check's warnings and escape hatches, and the errors of the
window settings.
"""

import json
import os
import re
import time
import warnings

import numpy as np
import pytest
import torch

from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.data.window import HBMWindow as JaxHBMWindow
from srgan_tpu.data.window import SliceStream as JaxSliceStream
from srgan_tpu.data.window import slice_update_factory
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.data.window import HBMWindow, SliceStream
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state


def _settings(tmp_path, **overrides):
    base = dict(
        trial_name="win", logs_directory=str(tmp_path / "logs"),
        batch_size=8, image_patch_size=16, crowd_image_height=32,
        crowd_image_width=32, model_base_width=8, latent_dimension=8,
        labeled_dataset_size=24, unlabeled_dataset_size=24,
        validation_dataset_size=2, test_dataset_size=2,
        crowd_sigma=2.0, steps_to_run=6, summary_step_period=3,
        crowd_hbm_window=8, crowd_window_slices=4,
        crowd_window_refresh_period=1, data_parallel_devices=1)
    base.update(overrides)
    return base


# ------------------------------------------------------------- SliceStream
@pytest.mark.parametrize("n,size,seed", [(10, 3, [0, 7]), (8, 4, 1),
                                         (5, 7, [3, 8, 12]), (1, 1, 0)])
def test_slice_stream_ids_equal_jax(n, size, seed):
    ours, theirs = SliceStream(n, size, seed), JaxSliceStream(n, size, seed)
    for _ in range(12):
        got, want = ours.next_ids(), theirs.next_ids()
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_slice_stream_covers_each_pass_and_validates():
    stream = SliceStream(num_examples=10, slice_size=3, seed=[0, 7])
    seen = np.concatenate([stream.next_ids() for _ in range(10)])
    for p in range(3):
        assert sorted(seen[p * 10:(p + 1) * 10]) == list(range(10))
    with pytest.raises(ValueError):
        SliceStream(0, 2, seed=0)
    with pytest.raises(ValueError):
        SliceStream(4, 0, seed=0)


# --------------------------------------------------------------- HBMWindow
def _images(n, h=6, w=5):
    return np.random.default_rng(n).integers(0, 256, (n, h, w, 3)).astype(
        np.uint8)


def _windows(images, window=6, slices=3, period=2):
    import jax

    n = len(images)
    theirs = JaxHBMWindow(
        ["images"], [lambda ids: images[ids]], n, window, slices,
        seed=[0, 7, 0], put=jax.device_put,
        make_update=slice_update_factory(), refresh_period=period)
    ours = HBMWindow(
        ["images"], [lambda ids: torch.from_numpy(images[ids])], n, window,
        slices, seed=[0, 7, 0], device="cpu", refresh_period=period)
    return ours, theirs


@pytest.mark.parametrize("n,window,slices,period", [
    (12, 6, 3, 2), (12, 6, 3, 1), (7, 4, 2, 3), (30, 8, 8, 1)])
def test_window_schedule_and_contents_equal_jax(n, window, slices, period):
    import jax

    images = _images(n)
    ours, theirs = _windows(images, window, slices, period)
    try:
        for step in range(0, 14):
            assert ours.maybe_refresh(step) == theirs.maybe_refresh(step)
            # Idempotent within a boundary.
            assert not ours.maybe_refresh(step) or period == 0
            np.testing.assert_array_equal(ours.resident_ids(),
                                          theirs.resident_ids(),
                                          err_msg=f"step {step}")
            want = np.asarray(jax.device_get(theirs.arrays["images"]))
            np.testing.assert_array_equal(ours.arrays["images"].numpy(),
                                          want, err_msg=f"step {step}")
            np.testing.assert_array_equal(want, images[ours.resident_ids()])
        assert ours.refresh_count == theirs.refresh_count == 13 // period
    finally:
        ours.close()
        theirs.close()


def test_opportunistic_window_refreshes_without_waiting():
    images = _images(12)
    window = HBMWindow(["images"], [lambda ids: torch.from_numpy(
        images[ids])], 12, 6, 3, seed=[0, 7, 0], device="cpu",
        refresh_period=0)
    try:
        assert window._stager._thread.daemon
        deadline = time.monotonic() + 30.0
        step = 0
        while window.refresh_count < 4:
            step += 1
            window.maybe_refresh(step)
            assert time.monotonic() < deadline, "never refreshed"
            time.sleep(0.01)
        np.testing.assert_array_equal(window.arrays["images"].numpy(),
                                      images[window.resident_ids()])
    finally:
        window.close()


def test_window_validation_errors():
    src = [lambda ids: torch.zeros(len(ids), 2)]
    kw = dict(seed=0, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        HBMWindow(["a"], src, 12, 7, 3, **kw)
    with pytest.raises(ValueError, match="positive"):
        HBMWindow(["a"], src, 12, 6, 0, **kw)
    with pytest.raises(ValueError, match="empty split"):
        HBMWindow(["a"], src, 0, 6, 3, **kw)
    with pytest.raises(ValueError, match="parallel"):
        HBMWindow(["a", "b"], src, 12, 6, 3, **kw)


# ------------------------------------------------------ the crowd app's tier
def _prepared(cls, settings_cls, kw, jax_side=False):
    exp = cls(settings_cls(**kw)) if jax_side else \
        cls(settings_cls(**kw), device="cpu")
    exp.dataset_setup()
    if jax_side:
        models, d, g, dnn = exp.model_setup()
        exp.models = models
        exp.state = jax_init_train_state(exp.settings, d, g, dnn)
        exp.prepare_mesh()
    else:
        exp.models = exp.model_setup()
        exp.state = init_train_state(exp.settings, exp.models)
    exp.prepare_train_step()
    return exp


@pytest.mark.parametrize("label_type,dtype", [("density", "float32"),
                                              ("iknn", "bfloat16")])
def test_crowd_windows_equal_jax_row_for_row(tmp_path, label_type, dtype):
    import jax

    kw = _settings(tmp_path, crowd_label_type=label_type,
                   crowd_label_dtype=dtype, crowd_window_refresh_period=2,
                   unlabeled_dataset_size=20)
    ours = _prepared(CrowdExperiment, Settings, kw)
    theirs = _prepared(JaxCrowdExperiment, JaxSettings, kw, jax_side=True)
    try:
        assert ours._labeled_index_bound == theirs._labeled_index_bound == 8
        for step in range(0, 7):
            ours._refresh_windows(step)
            theirs._refresh_windows(step)
            for mine, jaxs in zip(ours._windows, theirs._windows):
                np.testing.assert_array_equal(mine.resident_ids(),
                                              jaxs.resident_ids())
            for name in ("labeled_images", "labeled_density",
                         "unlabeled_images"):
                got = ours._device_data[name]
                want = np.asarray(jax.device_get(
                    theirs._device_data[name]).astype(np.float32))
                np.testing.assert_array_equal(got.float().numpy(), want,
                                              err_msg=f"{name} {step}")
        lab, unl = ours._windows
        assert not np.array_equal(lab.resident_ids(), unl.resident_ids())
        assert ours._device_data["labeled_density"].shape[-1] == (
            2 if label_type == "iknn" else 1)
        assert ours._device_data["labeled_density"].dtype == getattr(
            torch, dtype)
    finally:
        ours.close()
        theirs.close()


def test_windowed_training_equals_resident_when_content_identical(tmp_path):
    """Every example identical: a windowed ``train()`` (its sampler's
    indices bounded by the window, its windows rotating every step) ends
    with the resident run's parameters, and wrote the same losses."""
    def trained(window):
        exp = CrowdExperiment(Settings(**_settings(
            tmp_path, crowd_hbm_window=window, steps_to_run=4,
            summary_step_period=1, trial_name=f"same{window}")),
            device="cpu")
        load = exp._load_databases

        def identical():
            dbs = load()
            for db in dbs[:2]:
                db.images[:] = db.images[0]
                db.density_maps[:] = db.density_maps[0]
            return dbs

        exp._load_databases = identical
        state = exp.train()
        losses = [json.loads(line)["value"] for line in open(os.path.join(
            exp.trial_directory, "GAN", "scalars.jsonl"))
            if "d_total_loss" in line]
        return exp, state.d.state_dict(), losses

    resident, want, want_losses = trained(0)
    windowed, got, got_losses = trained(8)
    assert resident._windows == [] and len(windowed._windows) == 2
    assert [w.refresh_count for w in windowed._windows] == [3, 3]
    assert len(got_losses) == 4
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_windowed_train_resume_and_bounds(tmp_path):
    first = CrowdExperiment(Settings(**_settings(tmp_path, steps_to_run=4)),
                            device="cpu")
    assert first.train().step == 4
    assert len(first._windows) == 2
    # Period 1 refreshes at the boundaries of steps 1, 2 and 3.
    assert all(w.refresh_count == 3 for w in first._windows)
    assert first._labeled_index_bound == first._unlabeled_index_bound == 8
    resumed = CrowdExperiment(Settings(**_settings(
        tmp_path, steps_to_run=8, load_model_path=first.trial_directory)),
        device="cpu")
    assert resumed.train().step == 8
    # The resumed run rotates from step 4 (4 to 7) in a fresh order.
    assert all(w.refresh_count == 4 for w in resumed._windows)
    assert not np.array_equal(first._windows[0].resident_ids(),
                              resumed._windows[0].resident_ids())
    assert np.isfinite(resumed.evaluate()["MAE"])


def test_evaluation_only_skips_the_training_uploads(tmp_path):
    trained = CrowdExperiment(Settings(**_settings(
        tmp_path, steps_to_run=2, summary_step_period=2)), device="cpu")
    trained.train()
    evaluator = CrowdExperiment(Settings(**_settings(tmp_path)),
                                device="cpu")
    evaluator.prepare_for_evaluation(trained.trial_directory)
    assert evaluator._windows == []
    assert set(evaluator._device_data) == {"validation_images"}
    assert np.isfinite(evaluator.evaluate()["MAE"])
    assert evaluator.train().step == 6
    assert "labeled_images" in evaluator._device_data


def test_window_setting_errors_are_jax_errors(tmp_path):
    for over, match in ((dict(crowd_host_pipeline=True),
                         "mutually exclusive"),
                        (dict(crowd_window_slices=0), "crowd_window_slices"),
                        (dict(crowd_window_slices=3), "must divide")):
        exp = CrowdExperiment(Settings(**_settings(tmp_path, **over)),
                              device="cpu")
        with pytest.raises(ValueError, match=match):
            exp.train()


# ------------------------------------------------------ device-memory check
def _budget_exp(tmp_path, **over):
    exp = CrowdExperiment(Settings(**_settings(tmp_path, **over)),
                          device="cpu")
    exp.dataset_setup()
    return exp


def _hatches(message):
    return re.findall(r"(\w+)=", message.split("consider", 1)[1])


@pytest.mark.parametrize("over", [
    dict(crowd_hbm_window=0), dict(crowd_hbm_window=0,
                                   crowd_label_dtype="bfloat16"),
    dict(crowd_hbm_window=0, crowd_label_type="iknn")])
def test_budget_warnings_and_hatches_follow_jax(tmp_path, over):
    """Assumed capacity 200 KB: the full splits (~252 KB) pass the 60%
    threshold; the hatches, in order, are JAX's."""
    kw = dict(over, device_hbm_gb=2e-4)
    ours = _budget_exp(tmp_path, **kw)
    theirs = JaxCrowdExperiment(JaxSettings(**_settings(tmp_path, **kw)))
    theirs.dataset_setup()
    theirs.prepare_mesh()
    with pytest.warns(UserWarning, match="crowd_hbm_window") as got:
        ours._check_hbm_budget()
    with pytest.warns(UserWarning, match="crowd_hbm_window") as want:
        theirs._check_hbm_budget()
    mine, jaxs = str(got[0].message), str(want[0].message)
    assert "assumed capacity device_hbm_gb=0.0002" in mine
    assert _hatches(mine) == _hatches(jaxs)
    assert re.search(r"needs ([\d.]+) GB", mine).group(1) == re.search(
        r"needs ([\d.]+) GB", jaxs).group(1)


def test_budget_accounts_the_window(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _budget_exp(tmp_path, crowd_hbm_window=8,
                    device_hbm_gb=2e-4)._check_hbm_budget()
        _budget_exp(tmp_path, crowd_hbm_window=0)._check_hbm_budget()


def test_budget_limit_is_the_cards_memory(tmp_path, monkeypatch):
    exp = _budget_exp(tmp_path, crowd_hbm_window=0, device_hbm_gb=1e6)
    exp.device = torch.device("cuda")

    class Props:
        total_memory = 200_000

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    with pytest.warns(UserWarning, match="of the 0.0 GB of device memory;"):
        exp._check_hbm_budget()
    Props.total_memory = 10 ** 9
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        exp._check_hbm_budget()


def test_the_budget_check_runs_before_the_upload(tmp_path):
    exp = CrowdExperiment(Settings(**_settings(
        tmp_path, crowd_hbm_window=0, device_hbm_gb=2e-4, steps_to_run=1)),
        device="cpu")
    with pytest.warns(UserWarning, match="crowd database needs"):
        exp.train()
