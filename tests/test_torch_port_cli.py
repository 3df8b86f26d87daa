"""The port's command line, presets, checkpoints and resume against the
JAX package's, on the CPU at a tiny size: flag parsing field by field,
presets, save → restore (bit for bit), the structure and missing-
checkpoint errors, resume (the step and the patch-argument stream after
it, NumPy, exact), ``--evaluate_only`` with ``--export_density_maps``,
and the raw database → preprocess CLI → training → test chain of
``tests/test_crowd.py``."""

import json
import os
import subprocess
import sys
import typing

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import savemat

from srgan_tpu import __main__ as jax_cli
from srgan_tpu import presets as jax_presets
from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu_torch import __main__ as cli
from srgan_tpu_torch import checkpoint, presets
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.data.crowd import main as preprocess_main
from srgan_tpu_torch.settings import Settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(batch_size=4, image_patch_size=32, model_base_width=8,
            latent_dimension=16, labeled_dataset_size=6,
            unlabeled_dataset_size=6, validation_dataset_size=3,
            test_dataset_size=2, crowd_image_height=80, crowd_image_width=96,
            crowd_synthetic_max_heads=12, seed=4, summary_step_period=2)
TINY_FLAGS = [f"--{k}={v}" for k, v in TINY.items()] + ["--device", "cpu"]


def _samples(field_type):
    """Raw flag values of each kind a field of this type takes."""
    origin = typing.get_origin(field_type)
    if origin is typing.Union:
        inner = [a for a in typing.get_args(field_type)
                 if a is not type(None)][0]
        return ["None", "null"] + _samples(inner)
    if field_type is bool:
        return ["true", "False", "1", "off", "yes"]
    if field_type is int:
        return ["7", "-3"]
    if field_type is float:
        return ["2.5e-3", "4", "-0.5"]
    if origin in (tuple, list):
        return ["[0.75, 1.0, 1.25]", "[]", "[3, 5]"]
    return ["abc", "/data/x y"]


def test_every_settings_field_parses_as_in_jax():
    ours = typing.get_type_hints(Settings)
    theirs = typing.get_type_hints(JaxSettings)
    assert set(ours) == set(theirs)
    for name, field_type in ours.items():
        for raw in _samples(field_type):
            got = cli._parse_value(raw, field_type)
            want = jax_cli._parse_value(raw, theirs[name])
            assert got == want and type(got) is type(want), (name, raw)


class _Captured(Exception):
    pass


def _settings_from_cli(monkeypatch, argv):
    """The Settings ``main`` builds from ``argv``, caught at the
    experiment's construction."""
    seen = {}

    def capture(settings, device=None):
        seen["settings"], seen["device"] = settings, device
        raise _Captured

    monkeypatch.setattr("srgan_tpu_torch.apps.crowd.CrowdExperiment",
                        capture)
    with pytest.raises(_Captured):
        cli.main(argv)
    return seen["settings"], seen["device"]


def test_presets_apply_under_the_flags(monkeypatch):
    assert presets.PRESETS == jax_presets.PRESETS
    over = {"batch_size": 8, "seed": 3}
    assert presets.apply_preset("crowd_flagship", over) == \
        jax_presets.apply_preset("crowd_flagship", over)
    settings, device = _settings_from_cli(monkeypatch, [
        "crowd", "--preset", "crowd_flagship", "--batch_size", "8",
        "--crowd_rescale_factors=[0.75, 1.25]", "--load_model_path", "none",
        "--device", "cpu"])
    want = JaxSettings(**jax_presets.apply_preset(
        "crowd_flagship", {"batch_size": 8,
                           "crowd_rescale_factors": (0.75, 1.25)}))
    assert vars(settings) == vars(want) and device == "cpu"
    with pytest.raises(SystemExit, match="unknown preset"):
        cli.main(["crowd", "--preset", "nope"])
    with pytest.raises(SystemExit, match="unknown setting --nope"):
        cli.main(["crowd", "--nope", "1"])


APP_FLAGS = ["--batch_size=4", "--steps_to_run=2", "--age_image_size=32",
             "--model_base_width=8", "--latent_dimension=16",
             "--hidden_size=8", "--labeled_dataset_size=6",
             "--unlabeled_dataset_size=8", "--validation_dataset_size=5",
             "--test_dataset_size=3", "--seed=1", "--summary_step_period=1",
             "--data_parallel_devices=1"]


@pytest.mark.parametrize("app", ["age", "coefficient", "driving"])
def test_apps_print_the_json_line_of_the_jax_cli(app, tmp_path, capsys):
    """Each app trains and evaluates through the command line on the CPU
    and prints the keys the JAX command line prints, finite; without
    ``--device`` and with no card it raises; density maps are crowd-only."""
    flags = APP_FLAGS + ["--logs_directory", str(tmp_path / "logs")]
    ours = _run_cli(capsys, [app, "--device", "cpu"] + flags)
    # The JAX side only needs its line's keys: no steps, so no step to
    # compile.
    assert jax_cli.main([app] + flags + ["--steps_to_run=0"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(theirs) == {"trial_directory", "validation",
                                        "test"}
    for split in ("validation", "test"):
        assert set(ours[split]) == set(theirs[split]) == {"MAE", "RMSE",
                                                          "NVE"}
        assert all(np.isfinite(v) for v in ours[split].values())
    assert os.listdir(os.path.join(ours["trial_directory"],
                                   "checkpoints")) == ["step_2"]
    with pytest.raises(SystemExit, match="crowd-only"):
        cli.main([app, "--device", "cpu", "--export_density_maps",
                  str(tmp_path / "maps.npz")] + flags)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([app] + flags)


def _state_tensors(state):
    """Every tensor of the train state, by name, on the CPU."""
    out = {"step": torch.tensor(state.step)}
    for name in ("d", "g", "dnn"):
        for key, value in getattr(state, name).state_dict().items():
            out[f"{name}.{key}"] = value
        adam = getattr(state, f"{name}_opt").adam.state_dict()["state"]
        for index, slots in adam.items():
            for slot, value in slots.items():
                out[f"{name}_opt.{index}.{slot}"] = value
    return {k: v.detach().cpu() for k, v in out.items()}


def _train(tmp_path, **overrides):
    settings = Settings(**dict(TINY, logs_directory=str(tmp_path / "logs"),
                               **overrides))
    exp = CrowdExperiment(settings, device="cpu")
    exp.train()
    return exp


@pytest.mark.parametrize("norm_impl", ["xla", "pallas"])
def test_save_then_restore_is_bit_equal(tmp_path, norm_impl):
    trained = _train(tmp_path, steps_to_run=3, save_step_period=2,
                     norm_impl=norm_impl)
    root = os.path.join(trained.trial_directory, "checkpoints")
    assert sorted(os.listdir(root)) == ["step_2", "step_3"]
    fresh = CrowdExperiment(trained.settings, device="cpu")
    fresh.prepare_for_evaluation(trained.trial_directory)
    want, got = _state_tensors(trained.state), _state_tensors(fresh.state)
    assert set(got) == set(want) and int(got["step"]) == 3
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    # Adam's hyperparameters stay the settings', not the checkpoint's.
    again = CrowdExperiment(trained.settings.copy(learning_rate=5e-3),
                            device="cpu")
    again.prepare_for_evaluation(os.path.join(root, "step_2"))
    assert again.state.step == 2
    assert again.state.d_opt.adam.param_groups[0]["lr"] == 5e-3


def test_a_structure_mismatch_raises_value_error(tmp_path):
    trained = _train(tmp_path, steps_to_run=1, norm_impl="xla")
    other = CrowdExperiment(trained.settings.copy(norm_impl="pallas"),
                            device="cpu")
    with pytest.raises(ValueError, match="norm_impl.*FusedGroupNormAct"):
        other.prepare_for_evaluation(trained.trial_directory)
    wider = CrowdExperiment(trained.settings.copy(model_base_width=16),
                            device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        wider.prepare_for_evaluation(trained.trial_directory)


def test_no_checkpoint_raises_file_not_found(tmp_path):
    exp = CrowdExperiment(Settings(**TINY), device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        exp.prepare_for_evaluation(str(tmp_path))
    state = exp.state
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_state(state, str(tmp_path / "missing"))


def test_resume_continues_the_step_and_the_draws_of_jax(tmp_path):
    first = _train(tmp_path, steps_to_run=2, save_step_period=2)
    resumed = _train(tmp_path, steps_to_run=5,
                     load_model_path=first.trial_directory)
    assert resumed.state.step == 5 and resumed._start_step == 2
    assert sorted(os.listdir(os.path.join(resumed.trial_directory,
                                          "checkpoints"))) == ["step_5"]
    theirs = JaxCrowdExperiment(JaxSettings(**TINY))
    theirs.labeled_db, theirs.unlabeled_db = (resumed.labeled_db,
                                              resumed.unlabeled_db)
    theirs._labeled_index_bound = resumed._labeled_index_bound
    theirs._unlabeled_index_bound = resumed._unlabeled_index_bound
    theirs._labeled_local_counts = None
    theirs._start_step = 2
    ours, jaxs = resumed._patch_args_stream(), theirs._patch_args_stream()
    for _ in range(3):
        for a, b in zip(next(ours), next(jaxs), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _run_cli(capsys, argv):
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_evaluate_only_and_export_give_the_keys_and_shapes_of_jax(
        tmp_path, capsys):
    logs = ["--logs_directory", str(tmp_path / "logs")]
    trained = _run_cli(capsys, ["crowd", "--steps_to_run", "2"] + logs
                       + TINY_FLAGS)
    assert set(trained) == {"trial_directory", "validation", "test"}
    maps = str(tmp_path / "out" / "maps.npz")
    result = _run_cli(capsys, ["crowd", "--evaluate_only",
                               "--load_model_path",
                               trained["trial_directory"],
                               "--export_density_maps", maps] + logs
                      + TINY_FLAGS)
    assert set(result) == {"validation", "test"}
    for split in ("validation", "test"):
        assert set(result[split]) == {"MAE", "RMSE", "NVE", "NAE"}
        assert all(np.isfinite(v) for v in result[split].values())
        # The same weights evaluated the same way.
        assert result[split] == trained[split]
    with np.load(maps) as z:
        assert {k: z[k].shape for k in z} == {"validation": (3, 20, 24),
                                              "test": (2, 20, 24)}
    assert os.path.isdir(os.path.join(trained["trial_directory"],
                                      "eval_GAN"))
    with pytest.raises(SystemExit, match="requires --load_model_path"):
        cli.main(["crowd", "--evaluate_only"] + TINY_FLAGS)


def _write_raw_split(raw, n, rng):
    raw.mkdir()
    for i in range(n):
        Image.fromarray(np.random.default_rng(0).integers(
            0, 255, (48, 48, 3)).astype(np.uint8)).save(
            raw / f"img_{i:04d}.jpg")
        heads = rng.uniform(5, 40, size=(int(rng.integers(1, 6)), 2))
        savemat(raw / f"img_{i:04d}_ann.mat", {"annPoints": heads})


def test_full_chain_preprocess_cli_to_training(tmp_path, capsys):
    """Raw directories → the preprocess CLI → {labeled, unlabeled,
    validation, test}.npz → the training CLI → held-out test metrics."""
    rng = np.random.default_rng(0)
    db_dir = tmp_path / "db"
    db_dir.mkdir()
    for split, n in (("labeled", 4), ("unlabeled", 4),
                     ("validation", 2), ("test", 2)):
        raw = tmp_path / f"raw_{split}"
        _write_raw_split(raw, n, rng)
        assert preprocess_main([str(raw), str(db_dir / f"{split}.npz"),
                                "--database", "ucf_qnrf", "--height", "64",
                                "--width", "64", "--sigma", "3.0",
                                "--device", "cpu"]) == 0
    capsys.readouterr()
    result = _run_cli(capsys, [
        "crowd", "--device", "cpu", "--trial_name", "fullchain",
        "--logs_directory", str(tmp_path / "logs"), "--batch_size", "8",
        "--steps_to_run", "2", "--summary_step_period", "2",
        "--crowd_database_path", str(db_dir), "--image_patch_size", "32",
        "--model_base_width", "8", "--latent_dimension", "16",
        "--seed", "0"])
    val, test = result["validation"]["MAE"], result["test"]["MAE"]
    assert np.isfinite(val) and np.isfinite(test)
    assert test != val  # a distinct split
    assert os.listdir(os.path.join(result["trial_directory"],
                                   "checkpoints")) == ["step_2"]


def test_the_new_modules_import_no_jax():
    code = ("import sys, srgan_tpu_torch.__main__, srgan_tpu_torch.checkpoint, "
            "srgan_tpu_torch.presets, srgan_tpu_torch.ops.density, "
            "srgan_tpu_torch.data.crowd, "
            "srgan_tpu_torch.tools.norm_bandwidth_bench, "
            "srgan_tpu_torch.data.core, srgan_tpu_torch.data.coefficient, "
            "srgan_tpu_torch.data.age, srgan_tpu_torch.data.driving, "
            "srgan_tpu_torch.models.mlp, srgan_tpu_torch.apps.common, "
            "srgan_tpu_torch.apps.coefficient, srgan_tpu_torch.apps.age, "
            "srgan_tpu_torch.apps.driving, srgan_tpu_torch.data.window, "
            "srgan_tpu_torch.io.native, srgan_tpu_torch.models.crowd, "
            "srgan_tpu_torch.apps.crowd, srgan_tpu_torch.utils.cuda_graph, "
            "srgan_tpu_torch.parallel.tp, srgan_tpu_torch.io, "
            "srgan_tpu_torch.tools.sweep, srgan_tpu_torch.tools.golden_trace, "
            "srgan_tpu_torch.tools.window_bench, "
            "srgan_tpu_torch.tools.ucf_qnrf_rehearsal, "
            "srgan_tpu_torch.tools.imdb_wiki_rehearsal, "
            "srgan_tpu_torch.tools.real_scale_cli_rehearsal, "
            "srgan_tpu_torch.tools.crowd_win, "
            "srgan_tpu_torch.tools.scale_fidelity_ab; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'PIL', 'scipy', "
            "'srgan_tpu', 'tools')); print(bad); sys.exit(1 if bad else 0)")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr
