"""The port's ``steps_per_dispatch`` on the CPU: K (sample + step)
iterations a dispatch in the crowd app.

The settings are ``tests/test_chunked.py``'s (base width 8, 64×64 images,
32-px patches, batch 8, K = 2). Held here:

* one port chunk against JAX's ``_train_chunk`` on the same weights
  (converted), the same patch-argument stream and JAX's per-step draws
  reproduced from its ``KeySequence.take()`` chain; the metric trace at
  ``tests/test_torch_port_train_step.py``'s tolerances (rtol 1e-4, atol
  1e-6);
* a chunk against as many single steps of the port, bit for bit (on the
  CPU a chunk is the K steps in a loop), in one process and on each of 2
  gloo ranks for both ``crowd_shard_dataset`` settings; and ``train()``
  at K = 2 on 2 ranks against one rank (``tests/test_torch_port_
  parallel.py``'s tolerances: rtol 2e-4, atol 2e-5, a conv bias that a
  one-channel GroupNorm cancels within 2·lr a step). The ranks run
  through the port's launcher with a join timeout, in the background
  while the other tests run;
* ``train()`` at K = 2: summaries at the chunks' first steps, validation
  and checkpoints on the per-step loop's steps, resume at K = 2 and at
  K = 1, and JAX's refusals;
* the G update's period: each chunk runs the graph of the phase of its
  first step.
"""

import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu.utils.mixture import sample_offset_normal as jax_sample_z
from srgan_tpu.utils.seeding import KeySequence
from srgan_tpu_torch import convert
from srgan_tpu_torch.apps.coefficient import CoefficientExperiment
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.parallel import launch
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state

K, B, LATENT = 2, 8, 16
RTOL, ATOL = 1e-4, 1e-6              # against JAX, one chunk
DP_RTOL, DP_ATOL = 2e-4, 2e-5        # 2 ranks against one
JOIN_S, COLLECTIVE_S = 120.0, 60.0
BASE = dict(trial_name="chunktest", batch_size=B, steps_to_run=4,
            summary_step_period=2, validation_step_period=4,
            labeled_dataset_size=6, unlabeled_dataset_size=8,
            validation_dataset_size=2, crowd_image_height=64,
            crowd_image_width=64, image_patch_size=32, crowd_sigma=3.0,
            crowd_synthetic_max_heads=12, model_base_width=8,
            latent_dimension=LATENT, learning_rate=1e-3, seed=0,
            steps_per_dispatch=K)
# The 2-rank train() against one rank: Adam's first steps move a
# parameter by ±lr, so a smaller lr keeps a noise-level gradient's flip
# inside the tolerance, as in tests/test_torch_port_parallel.py.
DP_TRAIN = dict(BASE, learning_rate=1e-4, summary_step_period=2,
                validation_step_period=4)


def _kw(tmp_path, **over):
    return dict(BASE, logs_directory=str(tmp_path / "logs"), **over)


def _settings(tmp_path, **over):
    return Settings(**_kw(tmp_path, **over))


def _manual(settings, weights=None):
    """A crowd experiment ready to step on the CPU, without train()."""
    exp = CrowdExperiment(settings, device="cpu")
    exp.dataset_setup()
    exp.models = exp.model_setup()
    for name, state_dict in (weights or {}).items():
        getattr(exp.models, name).load_state_dict(state_dict)
    exp.state = init_train_state(exp.settings, exp.models)
    exp.prepare_train_step()
    return exp


def _single_steps(exp, args, n):
    data = exp._device_data
    out = []
    for _ in range(n):
        batch = exp._sample_batch(data["labeled_images"],
                                  data["labeled_density"],
                                  data["unlabeled_images"], *next(args))
        exp.state, metrics = exp._train_step(exp.state, *batch, exp._rng)
        out.append(metrics)
    return out


def _chunk_steps(chunk_metrics):
    n = len(next(iter(chunk_metrics.values())))
    return [{k: v[i] for k, v in chunk_metrics.items()} for i in range(n)]


def _assert_bit_equal(a, b, what):
    assert set(a) == set(b), what
    for k, v in b.items():
        if isinstance(v, dict):
            _assert_bit_equal(a[k], v, f"{what} {k}")
        else:
            assert torch.equal(a[k], v), f"{what} {k}"


# --------------------------------------------------------------- the ranks
@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """One 2-rank launch in the background from the module's first test:
    a chunk against single steps for both crowd_shard_dataset settings,
    and train() at K = 2."""
    base = tmp_path_factory.mktemp("chunk_ranks")
    calls = [(f"shard-{shard}", ("chunk_against_steps", (dict(
        _kw(base), crowd_shard_dataset=shard),)))
        for shard in (False, True)]
    train_kw = dict(DP_TRAIN, logs_directory=str(base / "logs"))
    calls.append(("train", ("train_chunked", (train_kw,
                                              str(base / "trial")))))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.launch, workers.run_all, ["cpu"] * 2,
                         (calls,), timeout_s=JOIN_S,
                         collective_timeout_s=COLLECTIVE_S, threads=1,
                         directory=str(base / "store"))
    yield dict(future=future, train_kw=train_kw)
    pool.shutdown(wait=True)


# -------------------------------------------------------- against JAX
def _jax_draws(key):
    """z_d, z_g and α as JAX's step draws them from its key."""
    k_zd, k_zg, k_alpha = jax.random.split(key, 3)
    return {k: torch.from_numpy(np.array(v)) for k, v in dict(
        z_d=jax_sample_z(k_zd, (B, LATENT), 0.0),
        z_g=jax_sample_z(k_zg, (B, LATENT), 0.0),
        alpha=jax.random.uniform(k_alpha, (B,), dtype=jnp.float32)).items()}


def test_a_chunk_matches_jax_train_chunk(tmp_path):
    """One K = 2 chunk of the port against JAX's ``_train_chunk``: the
    same converted weights, patch arguments and draws; step 1 depends on
    step 0's update, so the trace holds the whole chain."""
    jexp = JaxCrowdExperiment(JaxSettings(**_kw(tmp_path / "jax")))
    jexp.dataset_setup()
    models, d, g, dnn = jexp.model_setup()
    jexp.models = models
    jexp.state = jax_init_train_state(jexp.settings, d, g, dnn)
    jexp.prepare_mesh()
    jexp.prepare_train_step()
    host = jax.device_get
    weights = {"d": convert.joint_cnn_state_dict(host(d)),
               "g": convert.generator_state_dict(host(g)),
               "dnn": convert.joint_cnn_state_dict(host(dnn))}
    chain = KeySequence(0, "train").take()
    draws, key = [], chain
    for _ in range(K):  # the chunk's chain: split → (next, sub)
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub))
    args = jexp._patch_args_stream()
    stacked = [np.stack(col) for col in zip(*(next(args) for _ in range(K)))]
    data = jexp._device_data
    _, _, want = jexp._train_chunk(
        jexp.state, chain, data["labeled_images"], data["labeled_density"],
        data["unlabeled_images"], *stacked)
    want = host(want)

    exp = _manual(_settings(tmp_path / "port"), weights)
    args = exp._patch_args_stream()
    rows = np.stack([exp._flat_args(next(args)) for _ in range(K)])
    got = exp._run_chunk_steps(torch.from_numpy(rows), draws=draws)
    assert set(got) == set(want)
    for name, values in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(values),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert exp.state.step == K


# ------------------------------------------------- against single steps
def test_a_chunk_is_its_single_steps_bit_for_bit(tmp_path):
    """A chunk (``dispatch_chunk``) against K single steps from the same
    seed: metrics, models, the generator and the argument stream after,
    bit for bit."""
    runs = {}
    for how in ("chunk", "steps"):
        exp = _manual(_settings(tmp_path))
        args = exp._patch_args_stream()
        metrics = (_chunk_steps(exp.dispatch_chunk(args)) if how == "chunk"
                   else _single_steps(exp, args, K))
        runs[how] = dict(metrics=metrics, step=exp.state.step,
                         rng=exp._rng.get_state(), next=next(args),
                         models={n: getattr(exp.state, n).state_dict()
                                 for n in ("d", "g", "dnn")})
    chunk, steps = runs["chunk"], runs["steps"]
    for i in range(K):
        _assert_bit_equal(chunk["metrics"][i], steps["metrics"][i],
                          f"step {i}")
    _assert_bit_equal(chunk["models"], steps["models"], "models")
    assert chunk["step"] == steps["step"] == K
    assert torch.equal(chunk["rng"], steps["rng"])
    for a, b in zip(chunk["next"], steps["next"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shard", [False, True])
def test_a_chunk_on_each_rank_is_its_single_steps(ranks, shard):
    """On 2 gloo ranks, replicated or sharded split: each rank's chunk is
    its K single steps bit for bit, and the ranks' models are equal."""
    results = ranks["future"].result()
    for r, result in enumerate(results):
        got = result[f"shard-{shard}"]
        chunk, steps = got["chunk"], got["steps"]
        for i in range(K):
            _assert_bit_equal(chunk["metrics"][i], steps["metrics"][i],
                              f"rank {r} step {i}")
        _assert_bit_equal(chunk["models"], steps["models"], f"rank {r}")
        assert chunk["step"] == steps["step"] == K
        assert torch.equal(chunk["rng"], steps["rng"])
        for a, b in zip(chunk["next_args"], steps["next_args"]):
            np.testing.assert_array_equal(a, b)
    _assert_bit_equal(results[0][f"shard-{shard}"]["chunk"]["models"],
                      results[1][f"shard-{shard}"]["chunk"]["models"],
                      "rank 1 against rank 0")


def test_two_ranks_train_chunked_as_one_rank(ranks):
    """``train()`` at K = 2 on 2 gloo ranks against one rank on the same
    global batches and draws."""
    results = ranks["future"].result()
    kw = ranks["train_kw"]
    state = CrowdExperiment(Settings(**kw), device="cpu").train()
    lr = kw["learning_rate"] * kw["steps_to_run"]
    for r, result in enumerate(results):
        got = result["train"]
        for name in ("d", "g", "dnn"):
            ours = getattr(state, name).state_dict()
            for k, v in got[name].items():
                if (name, k) in got["cancelled"]:
                    assert float((v - ours[k]).abs().max()) <= 2 * lr, k
                    continue
                torch.testing.assert_close(v, ours[k], rtol=DP_RTOL,
                                           atol=DP_ATOL,
                                           msg=f"rank {r} {name} {k}")
    _assert_bit_equal({n: results[0]["train"][n] for n in ("d", "g", "dnn")},
                      {n: results[1]["train"][n] for n in ("d", "g", "dnn")},
                      "rank 1 against rank 0")


# ------------------------------------------------------------- train()
def _tags(trial, writer):
    with open(os.path.join(trial, writer, "scalars.jsonl")) as f:
        records = [json.loads(line) for line in f]
    out = {}
    for rec in records:
        out.setdefault(rec["step"], set()).add(rec["tag"])
    return out


def test_train_at_k2_lands_on_the_per_step_grid(tmp_path):
    """Summaries at the chunks' first steps (their metrics), throughput,
    validation at ``validation_step_period`` and checkpoints at
    ``save_step_period``, as the per-step loop writes them."""
    exp = CrowdExperiment(_settings(tmp_path, save_step_period=2),
                          device="cpu")
    state = exp.train()
    assert state.step == 4
    gan, dnn = _tags(exp.trial_directory, "GAN"), _tags(exp.trial_directory,
                                                        "DNN")
    losses = {"d_labeled_loss", "d_unlabeled_loss", "d_fake_loss",
              "d_gradient_penalty", "d_total_loss", "g_loss"}
    validation = {f"validation/{m}" for m in ("MAE", "RMSE", "NVE", "NAE")}
    throughput = {"throughput/steps_per_second",
                  "throughput/examples_per_second"}
    assert gan == {0: losses, 2: losses | throughput, 4: validation}
    assert dnn == {0: {"dnn_loss"}, 2: {"dnn_loss"}, 4: validation}
    assert sorted(os.listdir(os.path.join(exp.trial_directory,
                                          "checkpoints"))) == [
        "step_2", "step_4"]
    assert np.isfinite(exp.evaluate()["MAE"])


@pytest.mark.parametrize("resumed_k", [2, 1])
def test_resume_at_k2_and_at_k1(tmp_path, resumed_k):
    """A K = 2 trial's checkpoint resumes at K = 2 and at K = 1 and trains
    on to the new total."""
    first = CrowdExperiment(_settings(tmp_path, steps_to_run=2),
                            device="cpu")
    first.train()
    resumed = CrowdExperiment(_settings(
        tmp_path, steps_per_dispatch=resumed_k,
        load_model_path=first.trial_directory), device="cpu")
    state = resumed.train()
    assert state.step == 4
    assert np.isfinite(resumed.evaluate()["MAE"])
    for opt in (state.d_opt, state.g_opt, state.dnn_opt):
        assert {float(s["step"]) for s in opt.adam.state.values()} == {4.0}


def test_a_misaligned_resume_is_refused(tmp_path):
    first = CrowdExperiment(_settings(tmp_path, steps_per_dispatch=1,
                                      steps_to_run=2), device="cpu")
    first.train()
    resumed = CrowdExperiment(_settings(
        tmp_path, steps_per_dispatch=4, steps_to_run=8,
        summary_step_period=4, validation_step_period=4,
        load_model_path=first.trial_directory), device="cpu")
    with pytest.raises(ValueError, match="resumed step 2"):
        resumed.train()


@pytest.mark.parametrize("over,name", [
    (dict(steps_per_dispatch=3), "total training steps=4"),
    (dict(summary_step_period=1), "summary_step_period=1"),
    (dict(save_step_period=3), "save_step_period=3"),
    (dict(validation_step_period=3), "validation_step_period=3"),
    (dict(validation_step_period=None, batch_size=2, labeled_dataset_size=6),
     "steps_per_epoch"),
    (dict(crowd_hbm_window=4, crowd_window_slices=2,
          crowd_window_refresh_period=1), "crowd_window_refresh_period=1"),
])
def test_periods_that_are_not_multiples_of_k_are_refused(tmp_path, over,
                                                          name):
    with pytest.raises(ValueError, match=f"{name}.* must be a multiple of "
                       f"steps_per_dispatch"):
        CrowdExperiment(_settings(tmp_path, **over), device="cpu").train()


@pytest.mark.parametrize("app", ["dnn_only", "host tier", "coefficient"])
def test_what_jax_refuses_is_refused(tmp_path, app):
    if app == "coefficient":
        settings = Settings(
            trial_name="chunkcoef", logs_directory=str(tmp_path / "logs"),
            batch_size=8, steps_to_run=4, steps_per_dispatch=2,
            labeled_dataset_size=8, unlabeled_dataset_size=8,
            validation_dataset_size=8, hidden_size=4, latent_dimension=4)
        experiment, match = (CoefficientExperiment(settings, device="cpu"),
                             "on-device input pipeline")
    elif app == "dnn_only":
        experiment, match = (CrowdExperiment(_settings(
            tmp_path, dnn_only=True), device="cpu"), "dnn_only")
    else:
        experiment, match = (CrowdExperiment(_settings(
            tmp_path, crowd_host_pipeline=True, number_of_data_workers=1),
            device="cpu"), "HBM-resident input path")
    with pytest.raises(ValueError, match=match):
        experiment.train()


def test_chunks_under_tensor_parallelism_are_refused(tmp_path):
    """JAX's rule: ``steps_per_dispatch`` > 1 with
    ``model_parallel_devices`` > 1 raises its ``ValueError``, before any
    rank is spawned."""
    with pytest.raises(ValueError, match=r"steps_per_dispatch > 1 is not "
                       r"supported with model_parallel_devices > 1"):
        CrowdExperiment(_settings(tmp_path, model_parallel_devices=2,
                                  steps_per_dispatch=2),
                        device="cpu").train()


def test_each_chunk_takes_the_g_phase_of_its_first_step(tmp_path,
                                                        monkeypatch):
    """With G trained every 3rd step, chunks of 2 start at phases 0, 2 and
    1 (one graph each on a card) and their steps are the single steps':
    G's loss is 0 off its period."""
    keys = []
    real = CrowdExperiment._loop_chunk

    def recording(self, args, key=0):
        keys.append(key)
        return real(self, args, key)

    monkeypatch.setattr(CrowdExperiment, "_loop_chunk", recording)
    settings = _settings(tmp_path, generator_training_step_period=3)
    chunked = _manual(settings)
    args = chunked._patch_args_stream()
    got = [m for _ in range(3)
           for m in _chunk_steps(chunked.dispatch_chunk(args))]
    single = _manual(settings)
    want = _single_steps(single, single._patch_args_stream(), 6)
    assert keys == [0, 2, 1]
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_bit_equal(a, b, f"step {i}")
        assert (float(a["g_loss"]) != 0.0) == (i % 3 == 0), i


def test_debug_nans_checks_every_step_of_a_chunk(tmp_path, monkeypatch):
    """A non-finite metric at a chunk's second step raises, naming it."""
    real = CrowdExperiment._loop_chunk

    def poisoned(self, args, key=0):
        metrics = real(self, args, key)
        metrics["d_total_loss"][1] = float("nan")
        return metrics

    monkeypatch.setattr(CrowdExperiment, "_loop_chunk", poisoned)
    with pytest.raises(FloatingPointError, match="step 1: d_total_loss"):
        CrowdExperiment(_settings(tmp_path, debug_nans=True),
                        device="cpu").train()
