"""The port's tensor parallelism (``model_parallel_devices``) on the CPU:
gloo ranks on a data × model grid, spawned by the port's launcher
(``srgan_tpu_torch.parallel.launch``), held against the port's one-rank
step and JAX's ``jit_data_model_parallel`` on a 2-D mesh (the 8 CPU
devices of ``tests/conftest.py``).

The rank workers live in ``tests/torch_dp_workers.py``, which imports no
JAX. Every launch has a join timeout (``JOIN_S``), each rank one thread
and a collective timeout (``COLLECTIVE_S``), and its ``file://`` store in
a new directory under the test's temporary path. The launches are few
and run together (module fixtures) while JAX's mesh steps run here.

Tolerances: JAX's own in ``tests/test_tensor_parallel.py`` — the losses
within rtol 5e-4 and atol 5e-5, the parameters after a step within
2.1·lr (Adam's first update is about lr·sign(g), so rounding noise on a
near-zero gradient may flip it); the sharded layers' forward, gradient
and double backward within 1e-5 in float32. The parameters alone cannot
tell a wrong gradient (Adam's first step ignores a constant scale of
it), so Adam's moments after the step, which record the averaged and
clipped gradient, are held to the one-rank step's and to optax's within
the losses' tolerances.
"""

import concurrent.futures
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_dp_workers as workers
from srgan_tpu.apps.age import AgeExperiment as JaxAgeExperiment
from srgan_tpu.apps.coefficient import \
    CoefficientExperiment as JaxCoefficientExperiment
from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.parallel.tp import (MODEL_AXIS, _leaf_spec,
                                   jit_data_model_parallel, make_mesh_2d,
                                   place_state)
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu.train import make_gan_train_step as jax_make_gan_train_step
from srgan_tpu.utils.mixture import sample_offset_normal as jax_sample_z
from srgan_tpu_torch import __main__ as cli
from srgan_tpu_torch import checkpoint, convert
from srgan_tpu_torch.apps.age import AgeExperiment
from srgan_tpu_torch.apps.coefficient import CoefficientExperiment
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.parallel import launch
from srgan_tpu_torch.parallel.mesh import rank_devices
from srgan_tpu_torch.parallel.tp import param_shardings
from srgan_tpu_torch.settings import Settings

RTOL, ATOL = 5e-4, 5e-5
BLOCK_TOL = 1e-5
JOIN_S, COLLECTIVE_S = 150.0, 60.0
LR = 1e-4
B, P, LATENT = 8, 16, 16
# JAX's crowd case of tests/test_tensor_parallel.py, with trained heads.
CROWD = dict(batch_size=B, image_patch_size=P, model_base_width=16,
             latent_dimension=LATENT, learning_rate=LR, seed=3,
             zero_init_heads=False)
COEF = dict(batch_size=B, hidden_size=8, labeled_dataset_size=16,
            unlabeled_dataset_size=32, validation_dataset_size=11,
            learning_rate=LR)
# (name, settings, data ranks, JAX's mesh held to it or None)
STEPS = {
    "crowd-1x2": (CROWD, 1, True),
    "crowd-2x2-clip": (dict(CROWD, gradient_clip_norm=0.5), 2, True),
    "crowd-pallas-1x2": (dict(CROWD, norm_impl="pallas"), 1, False),
    "coefficient-1x2": (COEF, 1, False),
}
# The host tier on a 1 × 2 grid (4 gather threads a prefetcher would
# use), and the resident tier it is held to.
RESIDENT = dict(batch_size=4, image_patch_size=32, model_base_width=8,
                latent_dimension=LATENT, labeled_dataset_size=7,
                unlabeled_dataset_size=5, validation_dataset_size=3,
                test_dataset_size=1, crowd_image_height=80,
                crowd_image_width=96, crowd_synthetic_max_heads=12, seed=2)
HOST = dict(RESIDENT, crowd_host_pipeline=True, number_of_data_workers=4,
            model_parallel_devices=2)
# conv(3 → 96) → GroupNorm(32 groups) → conv(96 → 6): whole groups on 2
# ranks, straddling groups on 3.
BLOCK = dict(cin=3, width=96, cout=6, groups=32)
NORMS = ("xla", "fast", "pallas")
CROWD_CONVERT = {"d": convert.joint_cnn_state_dict,
                 "g": convert.generator_state_dict,
                 "dnn": convert.joint_cnn_state_dict}
ranks = functools.partial(launch.launch, timeout_s=JOIN_S,
                          collective_timeout_s=COLLECTIVE_S, threads=1)


# ------------------------------------------------------------ JAX's side
def _jax_draws(key, batch, latent, offset):
    """z_d, z_g and α as JAX's step draws them from its key."""
    k_zd, k_zg, k_alpha = jax.random.split(key, 3)
    return {k: np.array(v) for k, v in dict(
        z_d=jax_sample_z(k_zd, (batch, latent), offset),
        z_g=jax_sample_z(k_zg, (batch, latent), offset),
        alpha=jax.random.uniform(k_alpha, (batch,),
                                 dtype=jnp.float32)).items()}


def _is_adam(s):
    return isinstance(s, optax.ScaleByAdamState)


def _jax_moments(opt_state, to_port):
    """optax's mu and nu in ``opt_state``, in the port's names."""
    (adam,) = [s for s in jax.tree.leaves(opt_state, is_leaf=_is_adam)
               if _is_adam(s)]
    mu, nu = (to_port(jax.device_get(t)) for t in (adam.mu, adam.nu))
    return {k: {"exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in mu}


def _jax_on_grid(jexp, models, state, batch, key, data, model):
    """JAX's step through ``jit_data_model_parallel`` on a
    ``make_mesh_2d(data, model)``: its metrics, updated models and Adam
    moments, converted to the port's names."""
    step = jax_make_gan_train_step(jexp.settings, models,
                                   labeled_loss_fn=jexp.labeled_loss_fn(),
                                   latent_shape=(LATENT,))
    mesh = make_mesh_2d(data, model)
    placed = place_state(state, mesh)
    fn = jit_data_model_parallel(step, mesh, placed, donate_state=False)
    rows = NamedSharding(mesh, PartitionSpec("data"))
    new, metrics = fn(placed, *(jax.device_put(a, rows) for a in batch),
                      key)
    host = jax.device_get
    return ({k: float(v) for k, v in host(metrics).items()},
            {name: to_port(host(getattr(new, f"{name}_params")))
             for name, to_port in CROWD_CONVERT.items()},
            {name: _jax_moments(getattr(new, f"{name}_opt"), to_port)
             for name, to_port in CROWD_CONVERT.items()})


def _crowd_case(kw, data):
    """JAX's weights (converted), batch and draws of the crowd step, and
    its step on the grid (a thunk, run while the ranks run)."""
    jexp = JaxCrowdExperiment(JaxSettings(**kw))
    models, d, g, dnn = jexp.model_setup()
    state = jax_init_train_state(jexp.settings, d, g, dnn)
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((B, P, P, 3)).astype(np.float32),
             np.abs(rng.standard_normal((B, P, P))).astype(np.float32),
             rng.standard_normal((B, P, P, 3)).astype(np.float32))
    key = jax.random.key(3)
    weights = {name: CROWD_CONVERT[name](jax.device_get(params))
               for name, params in (("d", d), ("g", g), ("dnn", dnn))}
    return dict(app="crowd", kw=kw, data=data, weights=weights,
                batch=batch, draws=_jax_draws(key, B, LATENT,
                                              jexp.settings.mean_offset),
                jax=functools.partial(_jax_on_grid, jexp, models, state,
                                      batch, key, data, 2))


def _coefficient_case(kw, data):
    jexp = JaxCoefficientExperiment(JaxSettings(**kw))
    _, d, g, dnn = jexp.model_setup()
    rng = np.random.default_rng(1)
    batch = (rng.standard_normal((B, 10)).astype(np.float32),
             rng.standard_normal((B,)).astype(np.float32),
             rng.standard_normal((B, 10)).astype(np.float32))
    weights = {name: convert.mlp_state_dict(jax.device_get(params))
               for name, params in (("d", d), ("g", g), ("dnn", dnn))}
    return dict(app="coefficient", kw=kw, data=data, weights=weights,
                batch=batch,
                draws=_jax_draws(jax.random.key(5), B, 10, 0.0))


def _case(name):
    kw, data, with_jax = STEPS[name]
    make = _crowd_case if name.startswith("crowd") else _coefficient_case
    case = make(kw, data)
    if not with_jax:
        case.pop("jax", None)
    return case


def _grid_args(case):
    return (case["app"], dict(case["kw"], model_parallel_devices=2),
            case["weights"], case["batch"], case["draws"])


def _one_args(case):
    return (case["app"], case["kw"], case["weights"], case["batch"],
            case["draws"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every grid case in three launches (1 × 2, 2 × 2 and 1 × 3 ranks),
    in the background while JAX's grid steps and the port's one-rank
    steps run here."""
    cases = {name: _case(name) for name in STEPS}
    two_calls = [(f"step-{name}", ("tp_gan_step", _grid_args(case)))
                 for name, case in cases.items() if case["data"] == 1]
    coefficient = cases["coefficient-1x2"]
    two_calls.append(("dnn", ("tp_dnn_step", (
        dict(COEF, model_parallel_devices=2), coefficient["weights"],
        coefficient["batch"]))))
    two_calls.append(("host", ("host_tier_batches", (HOST, 2))))
    block_calls = [(f"block-{impl}", ("tp_block", (
        BLOCK["cin"], BLOCK["width"], BLOCK["cout"], BLOCK["groups"],
        impl, 7))) for impl in NORMS]
    base = tmp_path_factory.mktemp("grid")
    grid = functools.partial(ranks, workers.run_all, model=2)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        two = pool.submit(grid, ["cpu"] * 2, (two_calls + block_calls,),
                          directory=str(base / "two"))
        four = pool.submit(grid, ["cpu"] * 4, ([
            (f"step-{name}", ("tp_gan_step", _grid_args(case)))
            for name, case in cases.items() if case["data"] == 2],),
            directory=str(base / "four"))
        three = pool.submit(ranks, workers.run_all, ["cpu"] * 3,
                            (block_calls,), model=3,
                            directory=str(base / "three"))
        for case in cases.values():
            if "jax" in case:
                (case["jax_metrics"], case["jax_models"],
                 case["jax_moments"]) = case["jax"]()
        one = {name: workers.tp_gan_step(None, *_one_args(case))
               for name, case in cases.items()}
        one["dnn"] = workers.tp_dnn_step(None, COEF, coefficient["weights"],
                                         coefficient["batch"])
        return dict(cases=cases, one=one, two=two.result(),
                    four=four.result(), three=three.result())


def _grid_result(runs, name):
    """Every rank's result of case ``name``."""
    key = f"step-{name}"
    launched = runs["two"] if runs["cases"][name]["data"] == 1 \
        else runs["four"]
    return [r[key] for r in launched]


# ------------------------------------------------------------- checks
def _assert_metrics(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {k}")


def _assert_params(got, want, what):
    assert set(got) == set(want), what
    for k, p in want.items():
        assert got[k].shape == p.shape, (what, k)
        moved = float((got[k] - p).abs().max())
        assert moved <= 2.1 * LR, f"{what}: {k} differs by {moved}"


def _assert_moments(got, want, what):
    """Adam's ``exp_avg`` and ``exp_avg_sq`` after one step, (1 − β1)·g
    and (1 − β2)·g² of the averaged and clipped gradient g."""
    assert set(got) == set(want), what
    for k, moments in want.items():
        for m, v in moments.items():
            np.testing.assert_allclose(got[k][m].numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {k} {m}")


def _gradient_norm(moments):
    """The global norm of the gradient that one step's moments record."""
    beta1 = Settings().adam_b1
    return float(sum(float((v["exp_avg"] / (1 - beta1)).square().sum())
                     for v in moments.values())) ** 0.5


@pytest.mark.parametrize("name", list(STEPS))
def test_the_grid_takes_the_one_rank_step(name, runs):
    """Every rank's metrics, full models and Adam moments after the step
    against the port's one-rank step; the ranks end bit-equal."""
    want = runs["one"][name]
    results = _grid_result(runs, name)
    for r, got in enumerate(results):
        _assert_metrics(got["metrics"], want["metrics"], f"{name} r{r}")
        for model in ("d", "g", "dnn"):
            _assert_params(got["models"][model], want["models"][model],
                           f"{name} r{r} {model}")
            _assert_moments(got["moments"][model], want["moments"][model],
                            f"{name} r{r} {model}")
            for k, v in got["models"][model].items():
                assert torch.equal(v, results[0]["models"][model][k])


def test_the_clip_case_clips(runs):
    """In the clip case every model's gradient is clipped: the one-rank
    step's, the grid's and JAX's recorded gradients each have the clip
    norm as their global norm, so that a wrong norm on the grid (a
    replicated square counted M times, a sharded one not summed) moves
    the moments held above."""
    name = "crowd-2x2-clip"
    clip = STEPS[name][0]["gradient_clip_norm"]
    case = runs["cases"][name]
    for model in ("d", "g", "dnn"):
        for what, moments in (
                ("one", runs["one"][name]["moments"][model]),
                ("grid", _grid_result(runs, name)[0]["moments"][model]),
                ("jax", case["jax_moments"][model])):
            assert _gradient_norm(moments) == pytest.approx(
                clip, rel=RTOL), (model, what)


@pytest.mark.parametrize("name", [n for n, (_, _, j) in STEPS.items() if j])
def test_the_grid_matches_jax_on_its_2d_mesh(name, runs):
    """``jit_data_model_parallel`` on ``make_mesh_2d(data, 2)``, fed the
    same converted weights, batch and draws."""
    case = runs["cases"][name]
    got = _grid_result(runs, name)[0]
    _assert_metrics(got["metrics"], case["jax_metrics"], name)
    for model in ("d", "g", "dnn"):
        _assert_params(got["models"][model], case["jax_models"][model],
                       f"{name} {model}")
        _assert_moments(got["moments"][model], case["jax_moments"][model],
                        f"{name} {model}")


def test_the_dnn_only_step_on_the_grid(runs):
    want = runs["one"]["dnn"]
    for r in range(2):
        got = runs["two"][r]["dnn"]
        _assert_metrics(got["metrics"], want["metrics"], f"rank {r}")
        _assert_params(got["dnn"], want["dnn"], f"rank {r}")
        _assert_moments(got["moments"], want["moments"], f"rank {r}")


@pytest.mark.parametrize("name", ["crowd-1x2", "crowd-2x2-clip",
                                  "coefficient-1x2"])
def test_each_rank_holds_only_its_blocks(name, runs):
    """Every parameter and Adam moment the rule shards exists on a rank
    as its 1/2 block along the output axis; the others whole."""
    want = runs["one"][name]["models"]
    for got in _grid_result(runs, name):
        shapes = got["shapes"]
        for model in ("d", "g", "dnn"):
            full = {k: tuple(v.shape) for k, v in want[model].items()}
            rule = _port_rule(full, model, runs["cases"][name]["app"], 2)
            sharded = 0
            for k, shape in full.items():
                local = list(shape)
                if rule[k] is not None:
                    local[rule[k]] //= 2
                    sharded += 1
                assert shapes[model][k] == tuple(local), (model, k)
                assert set(shapes[f"{model}_opt"][k].values()) == {
                    tuple(local)}, (model, k)
            assert sharded > 0, model


def _port_rule(full_shapes, model, app, size):
    """``param_shardings`` of the unsharded model with these shapes."""
    exp = (CrowdExperiment(Settings(**CROWD), device="cpu") if app ==
           "crowd" else CoefficientExperiment(Settings(**COEF),
                                              device="cpu"))
    module = getattr(exp.model_setup(), model)
    assert {k: tuple(p.shape) for k, p in module.named_parameters()} == \
        full_shapes
    return param_shardings(module, size)


@pytest.mark.parametrize("impl", NORMS)
@pytest.mark.parametrize("model", [2, 3])
def test_the_sharded_block_and_its_double_backward(model, impl, runs):
    """conv → norm → conv sharded over 2 ranks (whole groups: 16 of the
    32 on each) and 3 ranks (a group straddles two ranks: the norm runs
    replicated on the gathered input): the output, the penalty-style
    input gradient and penalty, and the gradient of both w.r.t. the
    parameters equal the unsharded block's."""
    launched = runs["two"] if model == 2 else runs["three"]
    for r, result in enumerate(launched):
        got = result[f"block-{impl}"]
        local = BLOCK["width"] // model
        assert got["local_width"] == local
        assert got["local_groups"] == (BLOCK["groups"] // 2 if model == 2
                                       else BLOCK["groups"])
        for key in ("y", "gx", "penalty"):
            np.testing.assert_allclose(
                got["got"][key].numpy(), got["want"][key].numpy(),
                rtol=BLOCK_TOL, atol=BLOCK_TOL, err_msg=f"r{r} {key}")
        for k, g in got["want"]["grads"].items():
            np.testing.assert_allclose(
                got["got"]["grads"][k].numpy(), g.numpy(), rtol=BLOCK_TOL,
                atol=BLOCK_TOL, err_msg=f"r{r} grad {k}")


def test_the_host_tier_feeds_the_model_ranks_one_batch(runs):
    """The host tier on a 1 × 2 grid: no prefetcher (its threads deliver
    in no fixed order); both model ranks gather the same crops of the
    global draws, those the one-rank resident tier cuts."""
    want = workers.sharded_samples(None, RESIDENT, 2, 1)["samples"]
    a, b = (runs["two"][r]["host"] for r in range(2))
    assert a["host_io"] == b["host_io"] == 3
    for epoch, (ours, theirs, (_, *resident)) in enumerate(
            zip(a["batches"], b["batches"], want)):
        for name, x, y, z in zip(("images", "labels", "unlabeled"), ours,
                                 theirs, resident):
            np.testing.assert_array_equal(x, y, err_msg=f"{epoch} {name}")
            if x.dtype == np.uint8:
                x = x.astype(np.float32) * (2 / 255) - 1
            np.testing.assert_allclose(x, z, rtol=0, atol=1e-6,
                                       err_msg=f"{epoch} {name}")


# ------------------------------------------------------------- the rule
def _jax_states():
    """JAX's train states of the crowd, coefficient and age apps with the
    converter of each model: ``{app: (state, {model: convert})}``."""
    out = {}
    jexp = JaxCrowdExperiment(JaxSettings(**CROWD))
    _, d, g, dnn = jexp.model_setup()
    out["crowd"] = (jax_init_train_state(jexp.settings, d, g, dnn),
                    CROWD_CONVERT)
    jexp = JaxCoefficientExperiment(JaxSettings(**COEF))
    _, d, g, dnn = jexp.model_setup()
    out["coefficient"] = (jax_init_train_state(jexp.settings, d, g, dnn),
                          dict.fromkeys(("d", "g", "dnn"),
                                        convert.mlp_state_dict))
    jexp = JaxAgeExperiment(JaxSettings(**AGE))
    _, d, g, dnn = jexp.model_setup()
    out["age"] = (jax_init_train_state(jexp.settings, d, g, dnn),
                  {"d": convert.conv_regressor_state_dict,
                   "g": convert.generator_state_dict,
                   "dnn": convert.conv_regressor_state_dict})
    return out


AGE = dict(batch_size=8, age_image_size=32, model_base_width=8,
           latent_dimension=16)
PORT_APPS = {"crowd": (CrowdExperiment, CROWD),
             "coefficient": (CoefficientExperiment, COEF),
             "age": (AgeExperiment, AGE)}


@pytest.fixture(scope="module")
def jax_states():
    return _jax_states()


@pytest.mark.parametrize("app", list(PORT_APPS))
def test_the_rule_selects_jaxs_leaves(app, jax_states):
    """``param_shardings`` on the port's models chooses, at 2, 3 and 4
    model ranks, the leaves that JAX's ``_leaf_spec`` shards on the
    converted flax state, and the moments follow (optax's mu and nu
    mirror the parameters; the counts stay replicated)."""
    state, converters = jax_states[app]
    cls, kw = PORT_APPS[app]
    bundle = cls(Settings(**kw), device="cpu").model_setup()
    for size in (2, 3, 4):
        for model, to_port in converters.items():
            params = getattr(state, f"{model}_params")
            flags = jax.tree.map(
                lambda leaf: np.full(np.shape(leaf), float(
                    _leaf_spec(leaf, size) == PartitionSpec(
                        *([None] * (np.ndim(leaf) - 1) + [MODEL_AXIS])))),
                params)
            want = {k: bool(v.reshape(-1)[0]) if v.numel() else False
                    for k, v in to_port(jax.device_get(flags)).items()}
            got = {k: dim is not None for k, dim in
                   param_shardings(getattr(bundle, model), size).items()}
            assert got == want, (app, model, size)
        for leaf in jax.tree.leaves(state.d_opt):
            if np.ndim(leaf) == 0:
                assert _leaf_spec(leaf, size) == PartitionSpec()


# -------------------------------------------------- the user's entries
@pytest.fixture
def bounded_train(monkeypatch, tmp_path):
    """``Experiment.train()``'s spawned ranks under this file's limits,
    each rank returning its full models (``tp_trained_models``); the
    ranks' results are kept in the returned list."""
    results = []
    real = launch.run_experiment

    def run(*args, **kwargs):
        kwargs.update(action=workers.tp_trained_models, timeout_s=JOIN_S,
                      collective_timeout_s=COLLECTIVE_S, threads=1,
                      directory=str(tmp_path / f"ranks{len(results)}"))
        results.append(real(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr(launch, "run_experiment", run)
    return results


def _trial_settings(tmp_path, **kw):
    """JAX's ``TestSettingsLevelTp`` trial."""
    base = dict(trial_name="tpuser", logs_directory=str(tmp_path / "logs"),
                batch_size=8, steps_to_run=3, summary_step_period=1,
                labeled_dataset_size=6, unlabeled_dataset_size=8,
                validation_dataset_size=3, crowd_image_height=80,
                crowd_image_width=96, image_patch_size=32, crowd_sigma=3.0,
                model_base_width=8, latent_dimension=16,
                learning_rate=1e-3, seed=0)
    base.update(kw)
    return Settings(**base)


def _first_losses(trial):
    out = {}
    with open(os.path.join(trial, "GAN", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["step"] == 0 and rec["tag"].endswith("_loss"):
                out[rec["tag"]] = rec["value"]
    return out


def test_a_crowd_trial_on_the_grid(tmp_path, bounded_train):
    """``CrowdExperiment(Settings(model_parallel_devices=2),
    device="cpu").train()``: 3 steps on a 1 × 2 grid; the first step's
    losses those of the one-process trial; the checkpoint, the full
    logical state, restores bit-equal into this one-rank experiment (the
    ranks' gathered models and Adam moments); a finite evaluation."""
    exp = CrowdExperiment(_trial_settings(tmp_path,
                                          model_parallel_devices=2),
                          device="cpu")
    state = exp.train()
    assert state.step == 3
    (ranks_out,) = bounded_train
    for result in ranks_out:
        assert result["step"] == 3
        for name in ("d", "g", "dnn"):
            ours = getattr(state, name).state_dict()
            for k, v in result[name].items():
                assert torch.equal(ours[k], v), (name, k)
            opt = getattr(state, f"{name}_opt").adam.state_dict()["state"]
            for i, entry in result[f"{name}_opt"].items():
                for k, v in entry.items():
                    assert torch.equal(opt[i][k], v), (name, i, k)
    assert np.isfinite(exp.evaluate()["MAE"])
    saved = torch.load(os.path.join(checkpoint.latest_checkpoint(
        exp.trial_directory), checkpoint.STATE_FILE), weights_only=True)
    for name in ("d", "g", "dnn"):
        for k, v in saved[name].items():
            assert torch.equal(v, ranks_out[0][name][k]), (name, k)
    one = CrowdExperiment(_trial_settings(tmp_path, trial_name="one",
                                          steps_to_run=1), device="cpu")
    one.train()
    want, got = _first_losses(one.trial_directory), \
        _first_losses(exp.trial_directory)
    assert want and want.keys() == got.keys()
    for tag, value in want.items():
        assert got[tag] == pytest.approx(value, rel=1e-3, abs=1e-5), tag
    exp.close()
    one.close()


@pytest.mark.parametrize("app", ["coefficient", "crowd"])
def test_the_command_line_on_the_grid(app, tmp_path, capsys,
                                      bounded_train):
    """``python -m srgan_tpu_torch <app> --device cpu
    --model_parallel_devices 2``: trained on two spawned ranks, the step
    2 checkpoint, finite validation metrics."""
    flags = [app, "--device", "cpu", "--model_parallel_devices", "2",
             "--steps_to_run", "2", "--logs_directory",
             str(tmp_path / "logs")]
    kw = COEF if app == "coefficient" else dict(
        batch_size=8, image_patch_size=32, model_base_width=8,
        latent_dimension=16, labeled_dataset_size=6,
        unlabeled_dataset_size=6, validation_dataset_size=3,
        test_dataset_size=2, crowd_image_height=80, crowd_image_width=96,
        crowd_synthetic_max_heads=12)
    for key, value in kw.items():
        flags += [f"--{key}", str(value)]
    assert cli.main(flags) == 0
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert all(np.isfinite(v) for v in result["validation"].values())
    assert [r["step"] for r in bounded_train[0]] == [2, 2]
    assert os.listdir(os.path.join(result["trial_directory"],
                                   "checkpoints")) == ["step_2"]


def test_model_parallel_devices_below_one_raises_jaxs_error(tmp_path):
    jexp = JaxCrowdExperiment(JaxSettings(model_parallel_devices=0))
    with pytest.raises(ValueError) as theirs:
        jexp.prepare_mesh()
    with pytest.raises(ValueError) as ours:
        CrowdExperiment(_trial_settings(tmp_path, model_parallel_devices=0),
                        device="cpu").train()
    assert str(ours.value) == str(theirs.value)


def test_rank_devices_of_a_grid():
    """data × model ranks in rank order; ``None`` data ranks is 1 on the
    CPU; named devices must divide by the model ranks."""
    cpu = torch.device("cpu")
    assert rank_devices(device="cpu", model=2) == [cpu] * 2
    assert rank_devices(2, device="cpu", model=3) == [cpu] * 6
    assert rank_devices(devices=["cuda:0", "cuda:0"], model=2) == [
        torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="3 devices were named"):
        rank_devices(devices=["cpu"] * 3, model=2)
    with pytest.raises(ValueError, match="model_parallel_devices must be"):
        rank_devices(device="cpu", model=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_devices(model=2)
