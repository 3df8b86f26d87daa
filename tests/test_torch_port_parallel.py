"""The port's data parallelism on the CPU: gloo ranks spawned by the
port's own launcher (``srgan_tpu_torch.parallel.launch``), held against
the port's one-rank run and JAX's multi-device mesh (the 8 CPU devices of
``tests/conftest.py``).

The rank workers live in ``tests/torch_dp_workers.py``, which imports no
JAX. Every launch has a join timeout (``JOIN_S``), each rank one thread
and a collective timeout (``COLLECTIVE_S``), and its ``file://`` store in
a new directory under the test's temporary path, so that no case can
hang. The launches are
few and shared (module fixtures): a rank's start-up costs seconds.

Tolerances: ``tests/test_parallel.py``'s rtol 2e-4, atol 2e-5 for the
metrics, the updated parameters and the averaged gradients (the latter
scaled by the model's largest gradient, since gradients are not O(1)).
Two exceptions, both reasoned in the helpers: a conv bias cancelled by a
GroupNorm of one channel per group has a true gradient of 0, so its
rounding noise sets Adam's ±lr step (``_assert_same_step``); and the port
against JAX moves each parameter by the update rule of
``tests/test_torch_port_train_step.py`` (convolutions sum in another
order there, so noise-level gradients may flip an Adam step).
"""

import concurrent.futures
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

import torch_dp_workers as workers
from srgan_tpu.apps.coefficient import \
    CoefficientExperiment as JaxCoefficientExperiment
from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.apps.crowd import shard_local_counts as jax_shard_local_counts
from srgan_tpu.parallel import jit_data_parallel, make_mesh, shard_batch
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu.train import make_dnn_train_step as jax_make_dnn_train_step
from srgan_tpu.train import make_gan_train_step as jax_make_gan_train_step
from srgan_tpu.utils.mixture import sample_offset_normal as jax_sample_z
from srgan_tpu_torch import __main__ as cli
from srgan_tpu_torch import checkpoint, convert
from srgan_tpu_torch.apps.coefficient import CoefficientExperiment
from srgan_tpu_torch.apps.crowd import shard_local_counts, shard_rows
from srgan_tpu_torch.experiment import check_batch_divides
from srgan_tpu_torch.ops.patches import extract_patches_reference
from srgan_tpu_torch.parallel import launch
from srgan_tpu_torch.parallel.mesh import (DataParallel, backend_for,
                                           rank_devices)
from srgan_tpu_torch.settings import Settings

RTOL, ATOL = 2e-4, 2e-5
JOIN_S, COLLECTIVE_S = 120.0, 60.0
LR = 1e-4
B_COEF, B_CROWD, P, LATENT = 16, 4, 32, 16
COEF = dict(batch_size=B_COEF, hidden_size=8, labeled_dataset_size=16,
            unlabeled_dataset_size=32, validation_dataset_size=11,
            test_dataset_size=5, learning_rate=LR)
CROWD = dict(batch_size=B_CROWD, image_patch_size=P, model_base_width=8,
             latent_dimension=LATENT, labeled_dataset_size=7,
             unlabeled_dataset_size=5, validation_dataset_size=3,
             test_dataset_size=1, crowd_image_height=80,
             crowd_image_width=96, crowd_synthetic_max_heads=12,
             learning_rate=LR, seed=2, mean_offset=0.5,
             zero_init_heads=False, crowd_shard_dataset=True)
WINDOW = dict(CROWD, labeled_dataset_size=13, unlabeled_dataset_size=11,
              crowd_hbm_window=8, crowd_window_slices=2,
              crowd_window_refresh_period=1)
# The host tier on the replicated split, and the resident tier it is held
# to.
RESIDENT = dict(CROWD, crowd_shard_dataset=False)
HOST = dict(RESIDENT, crowd_host_pipeline=True, number_of_data_workers=1)
NORMS = ("xla", "pallas")
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


def _jax_on_mesh(jexp, models, state, batch, key, convert_d, devices=2,
                 **step_kw):
    """JAX's step on a mesh of ``devices``: its metrics and updated D, the
    latter converted to the port's names."""
    step = jax_make_gan_train_step(jexp.settings, models, **step_kw)
    mesh = make_mesh(devices)
    new, metrics = jit_data_parallel(step, mesh, donate_state=False)(
        state, *shard_batch(mesh, *batch), key)
    d = convert_d(jax.device_get(new.d_params))
    return ({k: float(v) for k, v in jax.device_get(metrics).items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})


def _jax_dnn_on_mesh(jexp, models, state, batch):
    """JAX's DNN-only step on a 2-device mesh: its metrics and updated
    DNN, converted."""
    step = jax_make_dnn_train_step(jexp.settings, models)
    mesh = make_mesh(2)
    new, metrics = jit_data_parallel(step, mesh, num_batch_args=2,
                                     donate_state=False, has_key=False)(
        state, *shard_batch(mesh, *batch[:2]))
    dnn = convert.mlp_state_dict(jax.device_get(new.dnn_params))
    return ({k: float(v) for k, v in jax.device_get(metrics).items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in dnn.items()})


def _coefficient_case():
    """JAX's model, weights and batch of ``tests/test_parallel.py``, the
    weights converted, its draws, and its step on a 2-device mesh (a
    thunk, run while the ranks run)."""
    jexp = JaxCoefficientExperiment(JaxSettings(**COEF))
    models, d, g, dnn = jexp.model_setup()
    state = jax_init_train_state(jexp.settings, d, g, dnn)
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((B_COEF, 10)).astype(np.float32),
             rng.standard_normal((B_COEF,)).astype(np.float32),
             rng.standard_normal((B_COEF, 10)).astype(np.float32))
    key = jax.random.key(3)
    weights = {name: convert.mlp_state_dict(jax.device_get(params))
               for name, params in (("d", d), ("g", g), ("dnn", dnn))}
    return dict(weights=weights, batch=batch,
                draws=_jax_draws(key, B_COEF, 10, 0.0),
                jax=functools.partial(_jax_on_mesh, jexp, models, state,
                                      batch, key, convert.mlp_state_dict),
                jax_dnn=functools.partial(_jax_dnn_on_mesh, jexp, models,
                                          state, batch),
                jax4=functools.partial(_jax_on_mesh, jexp, models, state,
                                       batch, key, convert.mlp_state_dict,
                                       devices=4))


def _crowd_case(norm_impl):
    """The tiny crowd SR-GAN step: JAX's weights and patches (cut from the
    synthetic database with seeded host draws), its draws, and its step
    on a 2-device mesh (a thunk)."""
    kw = dict(CROWD, norm_impl=norm_impl)
    jexp = JaxCrowdExperiment(JaxSettings(**kw))
    jexp.dataset_setup()
    models, d, g, dnn = jexp.model_setup()
    state = jax_init_train_state(jexp.settings, d, g, dnn)
    rng = np.random.default_rng(4)
    db_l, db_u = jexp.labeled_db, jexp.unlabeled_db
    h, w = db_l.image_size

    def args(n):
        return (rng.integers(0, n, B_CROWD),
                np.stack([rng.integers(0, h - P + 1, B_CROWD),
                          rng.integers(0, w - P + 1, B_CROWD)], -1),
                rng.integers(0, 2, B_CROWD))

    (i, o, f), (ui, uo, uf) = args(len(db_l)), args(len(db_u))
    batch = (
        extract_patches_reference(db_l.images, o, f, P, 2 / 255, -1.0, i),
        extract_patches_reference(db_l.density_maps[..., None], o, f, P,
                                  indices=i)[..., 0],
        extract_patches_reference(db_u.images, uo, uf, P, 2 / 255, -1.0,
                                  ui))
    key = jax.random.key(7)
    host = jax.device_get
    weights = {"d": convert.joint_cnn_state_dict(host(d)),
               "g": convert.generator_state_dict(host(g)),
               "dnn": convert.joint_cnn_state_dict(host(dnn))}
    return dict(kw=kw, weights=weights, batch=batch,
                draws=_jax_draws(key, B_CROWD, LATENT, 0.5),
                jax=functools.partial(
                    _jax_on_mesh, jexp, models, state, batch, key,
                    convert.joint_cnn_state_dict,
                    labeled_loss_fn=jexp.labeled_loss_fn(),
                    latent_shape=(LATENT,)))


# ------------------------------------------------------- the port's runs
def _kw(name, case):
    return COEF if name == "coefficient" else case["kw"]


def _app(name):
    return name.split("-")[0]


def _step_args(name, case):
    return (_app(name), _kw(name, case), case["weights"], case["batch"],
            case["draws"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases' inputs; one 2-rank launch running every 2-rank case and
    one 4-rank launch, both in the background while JAX's mesh steps and
    the port's one-rank steps run here."""
    cases = {"coefficient": _coefficient_case()}
    cases.update({f"crowd-{impl}": _crowd_case(impl) for impl in NORMS})
    calls = [(f"step-{name}", ("gan_step", _step_args(name, case)))
             for name, case in cases.items()]
    coefficient = cases["coefficient"]
    calls += [
        ("dnn-coefficient", ("dnn_step", (COEF, coefficient["weights"],
                                          coefficient["batch"]))),
        ("predict-coefficient", ("predictions", (
            "coefficient", COEF, cases["coefficient"]["weights"]))),
        ("predict-crowd", ("predictions", (
            "crowd", cases["crowd-xla"]["kw"],
            cases["crowd-xla"]["weights"]))),
        ("samples", ("sharded_samples", (CROWD, 2, 200))),
        ("window", ("window_refreshes", (WINDOW, 5))),
        ("host", ("host_tier_batches", (HOST, 2))),
        ("window-opportunistic", ("window_refreshes", (dict(
            WINDOW, crowd_window_refresh_period=0), 5))),
    ]
    base = tmp_path_factory.mktemp("ranks")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(ranks, workers.run_all, ["cpu"] * 2, (calls,),
                          directory=str(base / "two"))
        four = pool.submit(ranks, workers.gan_step, ["cpu"] * 4,
                           _step_args("coefficient", cases["coefficient"]),
                           directory=str(base / "four"))
        for case in cases.values():
            case["jax_metrics"], case["jax_d"] = case["jax"]()
        coefficient["jax_dnn_metrics"], coefficient["jax_dnn_params"] = \
            coefficient["jax_dnn"]()
        coefficient["jax4_metrics"], coefficient["jax4_d"] = \
            coefficient["jax4"]()
        one = {name: workers.gan_step(None, *_step_args(name, case))
               for name, case in cases.items()}
        one["dnn-coefficient"] = workers.dnn_step(
            None, COEF, coefficient["weights"], coefficient["batch"])
        return dict(cases=cases, one=one, two=two.result(),
                    four=four.result())


@pytest.fixture(scope="module")
def cases(runs):
    return runs["cases"]


@pytest.fixture(scope="module")
def one_rank(runs):
    return runs["one"]


@pytest.fixture(scope="module")
def two_ranks(runs):
    return runs["two"]


@pytest.fixture(scope="module")
def four_ranks(runs):
    return runs["four"]


# ------------------------------------------------------------- checks
def _assert_metrics(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {k}")


def _assert_same_step(got, want, what):
    """Metrics, parameters and averaged gradients of two port runs. A
    conv bias right before a GroupNorm of one channel per group (the
    crowd models at base width 8, ``want["cancelled"]``) has a true
    gradient of 0: its computed gradient is rounding noise, which Adam
    turns into a step of ±lr either way."""
    _assert_metrics(got["metrics"], want["metrics"], what)
    assert got["cancelled"] == want["cancelled"]
    for name in ("d", "g", "dnn"):
        grads, want_grads = got[f"{name}_grad"], want[f"{name}_grad"]
        scale = max(float(g.abs().max()) for g in want_grads.values())
        for k, p in want[name].items():
            if (name, k) in want["cancelled"]:
                # Both gradients at the noise level, the step at most ±lr.
                assert float(grads[k].abs().max()) <= 1e-5 * scale, k
                assert float((got[name][k] - p).abs().max()) <= 2 * LR, k
                continue
            np.testing.assert_allclose(
                grads[k].numpy(), want_grads[k].numpy(), rtol=RTOL,
                atol=ATOL * scale, err_msg=f"{what}: {name} grad {k}")
            np.testing.assert_allclose(
                got[name][k].numpy(), p.numpy(), rtol=RTOL, atol=ATOL,
                err_msg=f"{what}: {name} {k}")


@pytest.mark.parametrize("name", ["coefficient", "crowd-xla",
                                  "crowd-pallas"])
def test_two_ranks_take_the_one_rank_step(name, two_ranks, one_rank):
    for r in range(2):
        _assert_same_step(two_ranks[r][f"step-{name}"], one_rank[name],
                          f"{name}, rank {r}")


@pytest.mark.parametrize("name", ["coefficient", "crowd-xla",
                                  "crowd-pallas"])
def test_the_ranks_end_bit_equal(name, two_ranks):
    a, b = (two_ranks[r][f"step-{name}"] for r in range(2))
    assert a["metrics"] == b["metrics"]
    for model in ("d", "g", "dnn"):
        for k in a[model]:
            assert torch.equal(a[model][k], b[model][k]), (model, k)


def test_four_ranks_take_the_one_rank_step(cases, four_ranks, one_rank):
    """``tests/test_parallel.py``'s 1 against 8 devices, as 1 against 4
    ranks; and the 4 ranks against JAX's 4-device mesh."""
    case = cases["coefficient"]
    for r, got in enumerate(four_ranks):
        _assert_same_step(got, one_rank["coefficient"], f"rank {r}")
        assert got["metrics"] == four_ranks[0]["metrics"]
        _assert_metrics(got["metrics"], case["jax4_metrics"], "JAX")
        for k, want in case["jax4_d"].items():
            np.testing.assert_allclose(got["d"][k].numpy(), want.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["coefficient", "crowd-xla",
                                  "crowd-pallas"])
def test_two_ranks_match_jax_on_a_two_device_mesh(name, cases, two_ranks):
    case = cases[name]
    got = two_ranks[0][f"step-{name}"]
    _assert_metrics(got["metrics"], case["jax_metrics"], name)
    before = case["weights"]["d"]
    for k, want in case["jax_d"].items():
        moved = (got["d"][k] - before[k]).numpy()
        want_moved = (want - before[k]).numpy()
        if name == "coefficient":
            np.testing.assert_allclose(got["d"][k].numpy(), want.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        else:  # tests/test_torch_port_train_step.py's update rule
            assert np.abs(moved - want_moved).max() <= 2 * LR, k


def test_the_dnn_only_step_on_two_ranks(cases, two_ranks, one_rank):
    """``make_dnn_train_step`` under a group: the global loss and the
    averaged gradient, as one rank and as JAX's 2-device mesh."""
    want = one_rank["dnn-coefficient"]
    case = cases["coefficient"]
    for r in range(2):
        got = two_ranks[r]["dnn-coefficient"]
        _assert_metrics(got["metrics"], want["metrics"], f"rank {r}")
        _assert_metrics(got["metrics"], case["jax_dnn_metrics"], "JAX")
        scale = max(float(g.abs().max()) for g in want["dnn_grad"].values())
        for k, p in want["dnn"].items():
            np.testing.assert_allclose(
                got["dnn_grad"][k].numpy(), want["dnn_grad"][k].numpy(),
                rtol=RTOL, atol=ATOL * scale, err_msg=f"grad {k}")
            for other in (p, case["jax_dnn_params"][k]):
                np.testing.assert_allclose(got["dnn"][k].numpy(),
                                           other.numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=k)


def test_the_per_rank_mean_objective_is_a_different_one(cases, one_rank):
    """The guard of the parity tests: plain DDP's objective, the mean of
    each rank's loss over its own share, differs from the global one by
    more than the tolerance, so the tests above cannot pass vacuously."""
    case = cases["crowd-pallas"]
    halves = []
    for r in range(2):
        rows = slice(r * B_CROWD // 2, (r + 1) * B_CROWD // 2)
        halves.append(workers.gan_step(
            None, "crowd", case["kw"], case["weights"],
            tuple(a[rows] for a in case["batch"]),
            {k: v[rows] for k, v in case["draws"].items()}))
    glob = one_rank["crowd-pallas"]["metrics"]
    differs = []
    for k in ("d_fake_loss", "d_gradient_penalty"):
        ddp = np.mean([h["metrics"][k] for h in halves])
        if abs(ddp - glob[k]) > RTOL * abs(glob[k]) + ATOL:
            differs.append(k)
    assert differs, "the per-rank-mean objective equals the global one"


def test_evaluation_splits_over_the_ranks(cases, two_ranks):
    """``predict``, the crowd grid's counts and maps and ``evaluate`` on
    2 ranks (a tail chunk padded) equal the one-rank results."""
    for r in range(2):
        got = two_ranks[r]["predict-coefficient"]
        want = workers.predictions(None, "coefficient", COEF,
                                   cases["coefficient"]["weights"])
        np.testing.assert_allclose(got["predict"], want["predict"],
                                   rtol=RTOL, atol=ATOL)
        _assert_metrics(got["metrics"], want["metrics"], "coefficient")
        case = cases["crowd-xla"]
        got = two_ranks[r]["predict-crowd"]
        want = workers.predictions(None, "crowd", case["kw"],
                                   case["weights"])
        for key in ("counts", "maps"):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)
        _assert_metrics(got["metrics"], want["metrics"], "crowd")


# ------------------------------------------------ the sharded database
@pytest.mark.parametrize("n,shards", [(15, 8), (9, 8), (16, 8), (7, 2),
                                      (5, 2), (3, 4), (1, 2)])
def test_shard_local_counts_equal_jax(n, shards):
    got = shard_local_counts(n, shards)
    np.testing.assert_array_equal(got, jax_shard_local_counts(n, shards))
    assert got.dtype == jax_shard_local_counts(n, shards).dtype
    padded = np.resize(np.arange(n), (-(-n // shards) * shards,))
    for s in range(shards):
        np.testing.assert_array_equal(
            shard_rows(n, shards, s), padded.reshape(shards, -1)[s])


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's crowd app on a 2-device mesh with ``crowd_shard_dataset``:
    its sampler over the first two steps' draws, and its resident
    arrays."""
    jexp = JaxCrowdExperiment(JaxSettings(**dict(
        CROWD, data_parallel_devices=2)))
    jexp.dataset_setup()
    models, d, g, dnn = jexp.model_setup()
    jexp.models = models
    jexp.state = jax_init_train_state(jexp.settings, d, g, dnn)
    jexp.prepare_mesh()
    jexp.prepare_train_step()
    data = jexp._device_data
    stream = jexp._patch_args_stream()
    samples = []
    for _ in range(2):
        args = next(stream)
        out = jexp._sample_batch(data["labeled_images"],
                                 data["labeled_density"],
                                 data["unlabeled_images"], *args)
        samples.append((args, [np.asarray(jax.device_get(t))
                               for t in out]))
    return jexp, samples


def test_sharded_sampler_equals_jax_per_shard(two_ranks, jax_sharded):
    """An odd split (7 labeled, 5 unlabeled over 2 ranks): each rank holds
    its block of the cyclically padded split, draws JAX's arguments for
    its positions, and cuts JAX's patches of its shard."""
    jexp, want = jax_sharded
    half = B_CROWD // 2
    for r in range(2):
        got = two_ranks[r]["samples"]
        np.testing.assert_array_equal(got["counts"][0], [4, 3])
        np.testing.assert_array_equal(got["counts"][1], [3, 2])
        assert got["bounds"] == (jexp._labeled_index_bound,
                                 jexp._unlabeled_index_bound) == (4, 3)
        np.testing.assert_array_equal(
            got["labeled_images"],
            jexp.labeled_db.images[shard_rows(7, 2, r)])
        np.testing.assert_array_equal(
            got["unlabeled_images"],
            jexp.unlabeled_db.images[shard_rows(5, 2, r)])
        rows = slice(r * half, (r + 1) * half)
        for (args, *patches), (jargs, jpatches) in zip(got["samples"],
                                                       want):
            for a, b in zip(args, jargs):
                np.testing.assert_array_equal(a, np.asarray(b)[rows])
            for name, ours, theirs in zip(("images", "labels", "unlabeled"),
                                          patches, jpatches):
                np.testing.assert_allclose(ours, theirs[rows], rtol=0,
                                           atol=1e-6, err_msg=name)


def test_no_padded_duplicate_is_drawn(two_ranks):
    """Over 200 steps of draws every local index lies below its shard's
    true count: the cyclic pad's duplicates (rank 1's last labeled row,
    global 0) are never drawn, while every true row is."""
    for r in range(2):
        got = two_ranks[r]["samples"]
        for idx, counts, n in ((got["labeled_idx"], got["counts"][0], 7),
                               (got["unlabeled_idx"], got["counts"][1], 5)):
            assert idx.max() < counts[r]
            assert set(np.unique(idx)) == set(range(counts[r]))
            drawn = shard_rows(n, 2, r)[np.unique(idx)]
            assert len(set(drawn)) == len(drawn)  # no id twice


@pytest.fixture(scope="module")
def jax_window():
    """JAX's crowd app on a 2-device mesh with ``crowd_shard_dataset`` and
    a window (8 of 13 labeled and of 11 unlabeled images, 2 slices, a
    refresh every step): its global buffers after steps 0..4."""
    jexp = JaxCrowdExperiment(JaxSettings(**dict(
        WINDOW, data_parallel_devices=2)))
    jexp.dataset_setup()
    jexp.prepare_mesh()
    jexp._upload_databases()
    trace = []
    try:
        for step in range(5):
            jexp._refresh_windows(step)
            trace.append({k: np.asarray(jax.device_get(v))
                          for k, v in jexp._device_data.items()
                          if k != "validation_images"})
        return trace, [w.resident_ids() for w in jexp._windows]
    finally:
        jexp.close()


def test_sharded_window_equals_jax_per_shard(two_ranks, jax_window):
    trace, resident = jax_window
    for r in range(2):
        got = two_ranks[r]["window"]
        assert got["refreshes"] == [4, 4]
        for ours, theirs in zip(got["resident"], resident):
            np.testing.assert_array_equal(ours, theirs)
        for ours, theirs in zip(got["local"], resident):
            np.testing.assert_array_equal(ours, theirs[r * 4:(r + 1) * 4])
        for step, (ours, theirs) in enumerate(zip(got["trace"], trace)):
            for name, buffer in ours.items():
                want = theirs[name][r * 4:(r + 1) * 4]
                np.testing.assert_array_equal(
                    buffer.float().numpy(), want.astype(np.float32),
                    err_msg=f"rank {r}, step {step}, {name}")


def test_opportunistic_windows_move_together(two_ranks):
    """Without a period, a slice is applied once every rank's copy is
    ready: both ranks hold the same global ids after every run."""
    a, b = (two_ranks[r]["window-opportunistic"] for r in range(2))
    assert a["refreshes"] == b["refreshes"]
    for x, y in zip(a["resident"], b["resident"]):
        np.testing.assert_array_equal(x, y)


def test_the_host_tier_gathers_each_ranks_share(two_ranks):
    """Two ranks on the host tier open the three native readers and no
    prefetcher; each rank's batch of each epoch is its share of the
    global draws, cut as the one-rank resident tier cuts them."""
    want = workers.sharded_samples(None, RESIDENT, 2, 1)["samples"]
    half = B_CROWD // 2
    for r in range(2):
        got = two_ranks[r]["host"]
        assert got["host_io"] == 3
        rows = slice(r * half, (r + 1) * half)
        for epoch, (ours, (_, *theirs)) in enumerate(zip(got["batches"],
                                                         want)):
            images, labels, unlabeled = ours
            assert images.dtype == unlabeled.dtype == np.uint8
            for name, a, b in (
                    ("images", images.astype(np.float32) * (2 / 255) - 1,
                     theirs[0]),
                    ("labels", labels, theirs[1]),
                    ("unlabeled",
                     unlabeled.astype(np.float32) * (2 / 255) - 1,
                     theirs[2])):
                np.testing.assert_allclose(
                    a, b[rows], rtol=0, atol=1e-6,
                    err_msg=f"rank {r}, epoch {epoch}, {name}")


# --------------------------------------------------- entry and launcher
@pytest.fixture
def bounded_train(monkeypatch, tmp_path):
    """``Experiment.train()``'s spawned ranks under this file's time
    limits, one thread each, their store under ``tmp_path``."""
    monkeypatch.setattr(launch, "run_experiment", functools.partial(
        launch.run_experiment, timeout_s=JOIN_S,
        collective_timeout_s=COLLECTIVE_S, threads=1,
        directory=str(tmp_path / "ranks")))


def test_train_without_a_group_spawns_the_ranks(tmp_path, bounded_train):
    """``CoefficientExperiment(Settings(data_parallel_devices=2),
    device="cpu").train()`` trains on two spawned ranks and restores
    rank 0's last checkpoint here: the models of the launcher's own
    2-rank run, bit for bit."""
    settings = Settings(**dict(COEF, data_parallel_devices=2,
                               steps_to_run=2, seed=1,
                               logs_directory=str(tmp_path / "logs")))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launched = pool.submit(
            launch.run_experiment, CoefficientExperiment, settings,
            ["cpu"] * 2, action=workers.trained_models,
            trial_directory=str(tmp_path / "launched"),
            directory=str(tmp_path / "launched_ranks"))
        experiment = CoefficientExperiment(settings, device="cpu")
        state = experiment.train()
        want = launched.result()[0]
    assert state.step == 2
    assert os.listdir(tmp_path / "logs") == [
        os.path.basename(experiment.trial_directory)]
    assert os.listdir(os.path.join(experiment.trial_directory,
                                   "checkpoints")) == ["step_2"]
    for name in ("d", "g", "dnn"):
        ours = getattr(state, name).state_dict()
        for k, v in want[name].items():
            assert torch.equal(ours[k], v), (name, k)
    experiment.close()



def test_a_batch_that_does_not_divide_raises():
    settings = Settings(**dict(COEF, batch_size=5, data_parallel_devices=2))
    with pytest.raises(ValueError, match="batch_size 5 must be divisible "
                       "by the data-parallel mesh size 2"):
        CoefficientExperiment(settings, device="cpu").train()
    rank = DataParallel(rank=0, world_size=2, device=torch.device("cpu"))
    exp = CoefficientExperiment(Settings(**dict(COEF, batch_size=5)),
                                device="cpu", data_parallel=rank)
    with pytest.raises(ValueError, match="divisible"):
        exp.prepare_train_step()
    with pytest.raises(ValueError, match="divisible"):
        check_batch_divides(7, 4)
    with pytest.raises(ValueError, match="data_parallel_devices=3"):
        CoefficientExperiment(Settings(data_parallel_devices=3),
                              device="cpu", data_parallel=rank)


def test_rank_devices_and_backends():
    cpu = torch.device("cpu")
    assert rank_devices(device="cpu") == [cpu]
    assert rank_devices(3, device="cpu") == [cpu] * 3
    two = rank_devices(devices=["cuda:0", "cuda:0"])
    assert backend_for(two) == "gloo"
    assert backend_for(rank_devices(devices=["cuda:0", "cuda:1"])) == "nccl"
    assert backend_for([cpu, cpu]) == "gloo"
    with pytest.raises(ValueError, match="2 devices were named"):
        rank_devices(3, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_devices(2)


def test_a_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 raises: the launch raises (the first rank to end reports,
    rank 1's error or rank 0's broken barrier) and stops the other."""
    with pytest.raises(ProcessRaisedException):
        ranks(workers.fail_on_rank, ["cpu"] * 2, (1,),
              directory=str(tmp_path / "ranks"))


def test_a_rank_past_the_time_limit_is_stopped(tmp_path):
    with pytest.raises(TimeoutError, match="did not finish within 5 s"):
        launch.launch(workers.hang, ["cpu"] * 2, timeout_s=5,
                      collective_timeout_s=COLLECTIVE_S, threads=1,
                      directory=str(tmp_path / "ranks"))
    with pytest.raises(FileExistsError):  # a store is never reused
        launch.launch(workers.hang, ["cpu"] * 2, timeout_s=5,
                      directory=str(tmp_path / "ranks"))


def _scalars(trial, writer):
    with open(os.path.join(trial, writer, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_the_command_line_on_two_ranks(tmp_path, capsys, bounded_train):
    """``python -m srgan_tpu_torch coefficient --device cpu
    --data_parallel_devices 2``: one trial directory, every scalar
    written once (rank 0 alone writes), the checkpoint of step 2, the
    JSON line of the one-rank run; resumed on one rank, the run goes on
    as the one-rank run's resume does."""
    flags = ["coefficient", "--device", "cpu", "--steps_to_run", "2",
             "--summary_step_period", "1", "--seed", "1"]
    for key, value in COEF.items():
        flags += [f"--{key}", str(value)]
    results = {}
    for n in (2, 1):
        logs = str(tmp_path / f"logs{n}")
        assert cli.main(flags + ["--logs_directory", logs,
                                 "--data_parallel_devices", str(n)]) == 0
        results[n] = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert len(os.listdir(logs)) == 1
    two, one = results[2], results[1]
    for split in ("validation", "test"):
        _assert_metrics(two[split], one[split], split)
    for writer in ("GAN", "DNN"):
        lines = _scalars(two["trial_directory"], writer)
        keys = [(s["tag"], s["step"]) for s in lines]
        assert len(keys) == len(set(keys)), writer
        want = {(s["tag"], s["step"]): s["value"]
                for s in _scalars(one["trial_directory"], writer)}
        assert set(want) == set(keys), writer
        for s in lines:
            if not s["tag"].startswith("throughput"):
                np.testing.assert_allclose(s["value"], want[s["tag"],
                                                             s["step"]],
                                           rtol=RTOL, atol=ATOL)
    assert os.listdir(os.path.join(two["trial_directory"],
                                   "checkpoints")) == ["step_2"]
    resumed = {}
    for n, result in results.items():
        assert cli.main(flags[:4] + ["4"] + flags[5:] + [
            "--logs_directory", str(tmp_path / f"resume{n}"),
            "--load_model_path", result["trial_directory"]]) == 0
        resumed[n] = json.loads(capsys.readouterr().out.splitlines()[-1])
    _assert_metrics(resumed[2]["validation"], resumed[1]["validation"],
                    "resumed")
    a, b = (checkpoint.latest_checkpoint(resumed[n]["trial_directory"])
            for n in (2, 1))
    assert os.path.basename(a) == os.path.basename(b) == "step_4"
