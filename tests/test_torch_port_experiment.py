"""The port's generic training path on the CPU at a tiny size: each
app's ``train()`` (summaries, validation scalars, sample PNGs,
checkpoints, resume), ``dnn_only``, ``debug_nans`` and
``profile_step_range``."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from srgan_tpu_torch import checkpoint, losses
from srgan_tpu_torch.apps.age import AgeExperiment
from srgan_tpu_torch.apps.coefficient import CoefficientExperiment
from srgan_tpu_torch.apps.driving import DrivingExperiment
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.utils import trace as spans

TINY = dict(batch_size=4, age_image_size=32, model_base_width=8,
            latent_dimension=16, hidden_size=8, labeled_dataset_size=8,
            unlabeled_dataset_size=8, validation_dataset_size=5,
            test_dataset_size=3, seed=2, summary_step_period=1,
            learning_rate=1e-3)
APPS = {"coefficient": CoefficientExperiment, "age": AgeExperiment,
        "driving": DrivingExperiment}
VALIDATION = {"validation/MAE", "validation/RMSE", "validation/NVE"}


def _train(tmp_path, app="age", **overrides):
    settings = Settings(**dict(TINY, logs_directory=str(tmp_path / "logs"),
                               **overrides))
    exp = APPS[app](settings, device="cpu")
    exp.train()
    return exp


def _scalars(trial, writer):
    """{step: {tag: value}} of one writer's scalars.jsonl."""
    out = {}
    with open(os.path.join(trial, writer, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
    return out


@pytest.mark.parametrize("app", sorted(APPS))
def test_train_writes_summaries_checkpoints_and_resumes(tmp_path, app):
    kw = dict(save_step_period=2, validation_step_period=2)
    if app == "driving":
        kw["driving_frame_stack"] = 2
    first = _train(tmp_path, app, steps_to_run=3, **kw)
    trial = first.trial_directory
    assert first.state.step == 3
    assert sorted(os.listdir(os.path.join(trial, "checkpoints"))) == [
        "step_2", "step_3"]
    gan, dnn = _scalars(trial, "GAN"), _scalars(trial, "DNN")
    for step in range(3):
        assert {"d_total_loss", "d_gradient_penalty", "g_loss"} <= \
            set(gan[step])
        assert np.isfinite(dnn[step]["dnn_loss"])
    assert VALIDATION <= set(gan[2]) and VALIDATION <= set(dnn[2])
    assert all(np.isfinite(v) for v in gan[2].values())
    pngs = glob.glob(os.path.join(trial, "GAN", "images", "*.png"))
    assert len(pngs) == (0 if app == "coefficient" else 4)

    resumed = _train(tmp_path, app, steps_to_run=5, load_model_path=trial,
                     **kw)
    assert resumed._start_step == 3 and resumed.state.step == 5
    assert sorted(os.listdir(os.path.join(resumed.trial_directory,
                                          "checkpoints"))) == [
        "step_4", "step_5"]
    assert sorted(_scalars(resumed.trial_directory, "DNN")) == [3, 4]
    for name in ("d", "g", "dnn"):
        assert not torch.equal(
            next(getattr(first.state, name).parameters()),
            next(getattr(resumed.state, name).parameters())), name


def test_dnn_only_trains_the_dnn_alone(tmp_path):
    """D and G stay at their init and write no validation scalars or
    samples; the checkpoint still records all three models."""
    exp = _train(tmp_path, steps_to_run=3, dnn_only=True,
                 validation_step_period=3, norm_impl="pallas")
    trial = exp.trial_directory
    init = exp.model_setup()
    for name in ("d", "g"):
        for k, v in getattr(init, name).state_dict().items():
            assert torch.equal(getattr(exp.state, name).state_dict()[k], v)
    for k, v in init.dnn.state_dict().items():
        if k.endswith("weight"):
            assert not torch.equal(exp.state.dnn.state_dict()[k], v), k
    gan = _scalars(trial, "GAN")  # the loop's throughput alone
    assert {tag.split("/")[0] for tags in gan.values() for tag in tags} \
        == {"throughput"}
    assert not glob.glob(os.path.join(trial, "GAN", "images", "*"))
    dnn = _scalars(trial, "DNN")
    assert set(dnn[0]) == {"dnn_loss"} and VALIDATION <= set(dnn[3])
    snap = torch.load(os.path.join(trial, "checkpoints", "step_3",
                                   checkpoint.STATE_FILE),
                      weights_only=True)
    assert set(snap["structure"]) == {"d", "g", "dnn"}
    # evaluate() reads the trained model, the DNN.
    assert exp.evaluate() == exp.evaluate(use_dnn=True)


class _InfiniteLoss(CoefficientExperiment):
    """A labeled loss of +inf whose gradient is finite."""

    def labeled_loss_fn(self):
        return lambda pred, labels: (losses.labeled_loss(pred, labels)
                                     + float("inf"))


@pytest.mark.parametrize("anomaly_before", [False, True])
def test_debug_nans_restores_anomaly_mode_and_raises(tmp_path,
                                                     anomaly_before):
    torch.autograd.set_detect_anomaly(anomaly_before)
    try:
        settings = Settings(**dict(TINY, logs_directory=str(tmp_path),
                                   steps_to_run=2, debug_nans=True))
        seen = []

        class Watch(CoefficientExperiment):
            def training_loop(self):
                seen.append(torch.is_anomaly_enabled())
                super().training_loop()

        Watch(settings, device="cpu").train()
        assert seen == [True]
        assert torch.is_anomaly_enabled() == anomaly_before
        with pytest.raises(FloatingPointError,
                           match="step 0: d_labeled_loss is inf"):
            _InfiniteLoss(settings, device="cpu").train()
        assert torch.is_anomaly_enabled() == anomaly_before
        # Without debug_nans the same run goes on.
        _InfiniteLoss(settings.copy(debug_nans=False), device="cpu").train()
    finally:
        torch.autograd.set_detect_anomaly(False)


@pytest.mark.parametrize("steps,window", [(5, (1, 3)), (3, (2, 9))])
def test_profile_step_range_writes_a_trace(tmp_path, steps, window):
    """Steps [start, end) are traced into <trial>/profile/; a run that
    ends inside the window writes its trace at the end. The program's
    spans of those steps are on the trace's timeline."""
    exp = _train(tmp_path, "coefficient", steps_to_run=steps,
                 profile_step_range=window)
    path = os.path.join(exp.trial_directory, "profile",
                        f"steps_{window[0]}_{window[1]}.json")
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert not torch.autograd.profiler._is_profiler_enabled
    traced = [e for e in trace["traceEvents"]
              if e.get("name") == "loop.step" and e.get("ph") == "X"]
    assert len(traced) == min(steps, window[1]) - window[0]
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"step.d.penalty_grad", "step.dnn.adam"} <= names
    assert spans.take().spans == []  # the range's copies were dropped
