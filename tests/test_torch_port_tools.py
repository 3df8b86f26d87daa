"""The port's tools (``srgan_tpu_torch/tools/``) and the fused step's
``hyper`` overrides, on the CPU.

* ``hyper``: one coefficient step and one crowd step (the golden trace's
  tiny crowd configuration) under the overrides ``HYPER`` against
  ``srgan_tpu.train.make_gan_train_step(..., hyper=...)``, from the same
  converted weights and JAX's draws, under
  ``tests/test_torch_port_train_step.py``'s tolerances: metrics rtol
  1e-4; after the step every parameter within 2·lr of JAX's, and where
  the gradient is above 1e-2 of its tensor's largest, within 1e-3·lr and
  moved by about lr (Adam's first update is ±lr: the overridden lr of
  3e-3, not the settings' 1e-4, is what moved it).
* the sweep: JAX's row keys, and a lane equal bit for bit to a run
  through the shipped step outside the tool.
* the golden traces: JAX's initial parameters and per-step draws,
  computed here as ``srgan_tpu``'s init and ``KeySequence(seed,
  "train")`` with the step's ``split(key, 3)`` give them, fed to the
  port's ``run_trace``, which replays the committed ``traces/*.json``.
  Tolerance: JAX's own cross-environment one, rtol 1e-4 and atol 1e-5,
  for every trace but the driving one, which takes atol 5e-5: its
  ``dnn_loss`` falls to ~0.006 by step 17 and drifts by up to 2.6e-5
  absolute (1.7e-3 relative) with the CPU's thread count; the port
  against itself under another convolution algorithm (oneDNN off)
  drifts as much, so it is rounding that the DNN's Adam updates
  amplify, not a fault, and every other metric stays within 1.5e-5
  relative.

The window bench, the rehearsals and the science re-runs are in
``tests/test_torch_port_tools_rehearsals.py``.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.apps.coefficient import \
    CoefficientExperiment as JaxCoefficientExperiment
from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.apps.age import AgeExperiment as JaxAgeExperiment
from srgan_tpu.apps.driving import DrivingExperiment as JaxDrivingExperiment
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu.train import make_gan_train_step as jax_make_gan_train_step
from srgan_tpu.utils.mixture import sample_offset_normal as jax_sample_z
from srgan_tpu.utils.seeding import KeySequence
from srgan_tpu_torch.experiment import model_layout
from srgan_tpu_torch.io import native
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.tools import golden_trace, sweep
from srgan_tpu_torch.train import init_train_state, make_gan_train_step
from srgan_tpu_torch.utils.seeding import generator_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_APPS = {"coefficient": JaxCoefficientExperiment,
            "crowd": JaxCrowdExperiment, "age": JaxAgeExperiment,
            "driving": JaxDrivingExperiment}
HYPER = {"unlabeled_loss_multiplier": 0.1, "fake_loss_multiplier": 10.0,
         "gradient_penalty_multiplier": 1.0, "learning_rate": 3e-3}
RTOL = 1e-4  # metrics, as in test_torch_port_train_step.py
# The committed traces by name, each of its app.
TRACES = {"coefficient_h10_s0": "coefficient", "crowd_tiny_s0": "crowd",
          "age_dcgan_s0": "age", "driving_stack2_s0": "driving"}
# tools/sweep.py run_grid's row keys, one combo of the default grid.
JAX_ROW_KEYS = {"labeled_size", "steps", "mean_offset",
                "unlabeled_loss_multiplier", "fake_loss_multiplier",
                "gradient_penalty_multiplier", "learning_rate",
                "gan_mae_mean", "gan_mae_std", "dnn_mae_mean", "dnn_mae_std",
                "gan_wins", "seeds", "gan_mae_per_seed", "dnn_mae_per_seed"}


def _jax_setup(app: str, seed: int = 0, hidden_size: int = 10):
    """A JAX experiment of the golden trace's configuration: (experiment,
    models, {"d"|"g"|"dnn": initial params as NumPy})."""
    settings = JaxSettings(**golden_trace.app_settings(app, seed,
                                                       hidden_size))
    experiment = JAX_APPS[app](settings)
    experiment.dataset_setup()
    models, d, g, dnn = experiment.model_setup()
    params = {name: jax.tree_util.tree_map(np.asarray,
                                           jax.device_get(tree))
              for name, tree in (("d", d), ("g", g), ("dnn", dnn))}
    return experiment, models, params


def _jax_draws(key, settings):
    """The step's z_d, α and z_g from its key (``train.py``'s split)."""
    k_zd, k_zg, k_alpha = jax.random.split(key, 3)
    shape = (settings.batch_size, settings.latent_dimension)
    return {"z_d": np.asarray(jax_sample_z(k_zd, shape,
                                           settings.mean_offset)),
            "alpha": np.asarray(jax.random.uniform(
                k_alpha, (settings.batch_size,), dtype=jnp.float32)),
            "z_g": np.asarray(jax_sample_z(k_zg, shape,
                                           settings.mean_offset))}


# ------------------------------------------------------------------ hyper
def _port_state(app, params):
    settings = Settings(**golden_trace.app_settings(app, 0, 10))
    experiment = golden_trace.make_experiment(app, settings, "cpu")
    experiment.dataset_setup()
    models = experiment.model_setup()
    for name, tree in params.items():
        getattr(models, name).load_state_dict(
            golden_trace.CONVERTERS[app][name](tree))
    return experiment, init_train_state(settings, models)


def _put(array):
    return model_layout(torch.from_numpy(
        np.ascontiguousarray(array, np.float32)))


@pytest.mark.parametrize("app", ["coefficient", "crowd"])
def test_hyper_step_matches_jax(app):
    jexp, models, params = _jax_setup(app)
    j_state = jax_init_train_state(jexp.settings, *(
        jax.device_put(params[k]) for k in ("d", "g", "dnn")))
    j_step = jax.jit(jax_make_gan_train_step(
        jexp.settings, models, labeled_loss_fn=jexp.labeled_loss_fn(),
        hyper=HYPER))
    exp, state = _port_state(app, params)
    x, y, u = next(golden_trace.host_batches(app, exp, exp.settings))
    key = jax.random.key(7)
    j_new, j_metrics = jax.device_get(j_step(
        j_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(u), key))
    before = {name: {k: v.clone() for k, v in
                     getattr(state, name).state_dict().items()}
              for name in ("d", "g", "dnn")}
    step = make_gan_train_step(exp.settings,
                               labeled_loss_fn=exp.labeled_loss_fn(),
                               hyper=HYPER)
    draws = {k: torch.from_numpy(v)
             for k, v in _jax_draws(key, jexp.settings).items()}
    state, metrics = step(state, _put(x), _put(y), _put(u), **draws)

    assert set(metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    lr = HYPER["learning_rate"]
    for name in ("d", "g", "dnn"):
        opt = getattr(state, f"{name}_opt")
        assert [g["lr"] for g in opt.adam.param_groups] == [lr]
        convert_fn = golden_trace.CONVERTERS[app][name]
        j_params = convert_fn(getattr(j_new, f"{name}_params"))
        j_mu = convert_fn(getattr(j_new, f"{name}_opt")[0].mu)
        module = getattr(state, name)
        moved = 0
        for k, p in module.named_parameters():
            ours = (p.detach() - before[name][k]).numpy()
            theirs = (j_params[k] - before[name][k]).numpy()
            assert np.abs(ours - theirs).max() <= 2 * lr, f"{name} {k}"
            g = np.abs(j_mu[k].numpy())
            large = g > 1e-2 * g.max()
            if _cancelled_by_norm(module, k):
                continue
            np.testing.assert_allclose(ours[large], theirs[large], rtol=0,
                                       atol=1e-3 * lr, err_msg=f"{name} {k}")
            assert np.all(np.abs(ours[large]) > 0.99 * lr), f"{name} {k}"
            moved += int(large.sum())
        assert moved > 0


def _cancelled_by_norm(module, key: str) -> bool:
    """A conv bias right before a GroupNorm of one channel per group:
    its true gradient is 0, and Adam turns its rounding into ±lr."""
    parts = key.split(".")
    if len(parts) != 3 or parts[0] not in ("convs", "deconvs") \
            or parts[2] != "bias":
        return False
    layer, index, _ = parts
    norms = getattr(module, "norms", None)
    i = int(index) + (1 if layer == "deconvs" else 0)  # G: norms[0] is Dense's
    return (norms is not None and i < len(norms)
            and norms[i].num_groups == norms[i].scale.numel())


def test_hyper_refusals():
    settings = Settings(**golden_trace.app_settings("coefficient", 0, 10))
    j_settings = JaxSettings(**golden_trace.app_settings("coefficient", 0,
                                                         10))
    bogus = {"bogus": 1.0, "learning_rate": 1e-3}
    with pytest.raises(ValueError) as ours:
        make_gan_train_step(settings, hyper=bogus)
    models = JaxCoefficientExperiment(j_settings).model_setup()[0]
    with pytest.raises(ValueError) as theirs:
        jax_make_gan_train_step(j_settings, models, hyper=bogus)
    assert str(ours.value) == str(theirs.value)
    # A capturable Adam (steps_per_dispatch > 1 on a card) replays the
    # learning rate its graph captured: an overridden one is refused.
    exp, state = _port_state("coefficient", _jax_setup("coefficient")[2])
    state.d_opt.capturable = True
    step = make_gan_train_step(settings, hyper={"learning_rate": 1e-3})
    x, y, u = next(golden_trace.host_batches("coefficient", exp, settings))
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        step(state, _put(x), _put(y), _put(u), generator_for(0, "train"))


# ------------------------------------------------------------------ sweep
def test_sweep_rows_and_a_lane_through_the_shipped_step(tmp_path):
    out = tmp_path / "rows.json"
    rc = sweep.main(["--labeled-sizes", "8", "--seeds", "2",
                     "--steps", "30", "--unlabeled-size", "64",
                     "--ul", "1.0", "--fl", "1.0", "--gp", "10.0",
                     "--lr", "1e-3", "--mean-offset", "0.5",
                     "--out", str(out), "--device", "cpu"])
    assert rc == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 1
    row = rows[0]
    assert set(row) == JAX_ROW_KEYS
    assert row["seeds"] == 2 and row["mean_offset"] == 0.5
    assert all(v > 0 for v in row["gan_mae_per_seed"])
    assert all(v > 0 for v in row["dnn_mae_per_seed"])

    # Lane 1 (combo 0, seed 1) outside the tool: the seed's data, the
    # lane's init and index streams, the shipped step with its hyper.
    from srgan_tpu_torch.data.coefficient import (
        OBSERVATION_COUNT, generate_coefficient_examples)
    from srgan_tpu_torch.models.mlp import (CoefficientGenerator,
                                            CoefficientMLP)
    from srgan_tpu_torch.train import ModelBundle

    rng = np.random.default_rng(1)
    lab_x, lab_y = map(torch.from_numpy,
                       generate_coefficient_examples(8, rng))
    unl_x = torch.from_numpy(generate_coefficient_examples(
        64, rng, mean_offset=0.5)[0])
    val_x, val_y = map(torch.from_numpy, generate_coefficient_examples(
        2000, np.random.default_rng(10_000)))
    settings = Settings(batch_size=32, hidden_size=10, latent_dimension=10,
                        mean_offset=0.5)
    init = generator_for(1, "init")
    state = init_train_state(settings, ModelBundle(
        CoefficientMLP(OBSERVATION_COUNT, 10, rng=init),
        CoefficientGenerator(10, OBSERVATION_COUNT, 10, rng=init),
        CoefficientMLP(OBSERVATION_COUNT, 10, rng=init)))
    step = make_gan_train_step(settings, hyper={
        "unlabeled_loss_multiplier": 1.0, "fake_loss_multiplier": 1.0,
        "gradient_penalty_multiplier": 10.0, "learning_rate": 1e-3})
    draws = generator_for(1, "train")
    for _ in range(30):
        li = torch.randint(0, 8, (32,), generator=draws)
        ui = torch.randint(0, 64, (32,), generator=draws)
        state, _ = step(state, lab_x[li], lab_y[li], unl_x[ui], draws)
    with torch.inference_mode():
        d_mae = float((state.d(val_x)[0] - val_y).abs().mean())
        dnn_mae = float((state.dnn(val_x)[0] - val_y).abs().mean())
    assert d_mae == row["gan_mae_per_seed"][1]
    assert dnn_mae == row["dnn_mae_per_seed"][1]


# ---------------------------------------------------------- golden traces
@pytest.fixture(scope="module")
def jax_draws(tmp_path_factory):
    """trace name → an .npz of JAX's initial parameters and draws."""
    root = tmp_path_factory.mktemp("jax_draws")
    files = {}
    for name in TRACES:
        with open(os.path.join(REPO, "traces", f"{name}.json")) as f:
            golden = json.load(f)
        app = golden.get("app", "coefficient")
        experiment, _, params = _jax_setup(app, golden["seed"],
                                           golden["hidden_size"])
        keys = KeySequence(golden["seed"], "train")
        steps = [_jax_draws(keys.next(), experiment.settings)
                 for _ in range(golden["steps"])]
        draws = {k: np.stack([s[k] for s in steps])
                 for k in golden_trace.DRAWS}
        files[name] = str(root / f"{name}.npz")
        np.savez(files[name], **golden_trace.npz_of(params, draws))
    return files


@pytest.mark.parametrize("name", list(TRACES))
def test_port_replays_the_committed_jax_trace(jax_draws, name):
    with open(os.path.join(REPO, "traces", f"{name}.json")) as f:
        golden = json.load(f)
    params, draws = golden_trace.load_draws(jax_draws[name])
    trace = golden_trace.run_trace(golden["steps"], golden["seed"],
                                   golden["hidden_size"],
                                   golden.get("app", "coefficient"),
                                   device="cpu", params=params,
                                   draws=draws)
    # golden_trace.TOLERANCES: see the module docstring for driving's.
    rtol, atol = golden_trace.TOLERANCES[TRACES[name]]
    mismatch = golden_trace.compare_traces(trace, golden["trace"],
                                           rtol=rtol, atol=atol)
    assert mismatch is None, mismatch


def test_golden_trace_cli_record_compare(tmp_path, capsys, jax_draws):
    trace = str(tmp_path / "t.json")
    assert golden_trace.main(["record", "--steps", "3", "--out", trace,
                              "--device", "cpu"]) == 0
    assert golden_trace.main(["compare", "--trace", trace,
                              "--device", "cpu"]) == 0
    assert "matches" in capsys.readouterr().out
    # The committed JAX trace through the command line, with JAX's draws.
    committed = os.path.join(REPO, "traces", "coefficient_h10_s0.json")
    assert golden_trace.main([
        "compare", "--trace", committed, "--draws",
        jax_draws["coefficient_h10_s0"], "--rtol", "1e-4", "--atol",
        "1e-5", "--device", "cpu"]) == 0
    # Without them the port's own init and draws do not reproduce it.
    assert golden_trace.main(["compare", "--trace", committed,
                              "--device", "cpu"]) == 1


# -------------------------------------------------------------- native io
def test_native_library_available():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/srgan_io.cc")
    assert native.native_library_available()
