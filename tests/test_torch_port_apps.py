"""The port's generic experiment path and its coefficient, age and
driving apps against the JAX package's, on the CPU at a tiny size
(base width 8, 32-px images, batch 4, hidden 8), float32.

Data (NumPy on both sides) must be equal exactly: the batch streams, the
synthetic datasets, the preprocessed IMDB-WIKI npz and the dash-cam
recording. Models run on the converted flax weights. Tolerances:

* forwards: within 1e-5 of the output's largest magnitude;
* one step: as ``tests/test_torch_port_train_step.py`` (metrics rtol
  1e-4; gradients within 1e-3 of the tensor's largest; parameters after
  the step within 1e-3·lr where the gradient is not near the rounding
  noise, 2·lr everywhere; a conv bias cancelled by a one-channel-per-group
  norm has a gradient below 1e-5 of the model's largest on both sides);
* metrics of ``evaluate``: rtol 1e-5.

The "pallas" cases run JAX's Pallas kernels in interpret mode and the
port's fused norm on its plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import savemat

from srgan_tpu.apps.age import AgeExperiment as JaxAgeExperiment
from srgan_tpu.apps.coefficient import \
    CoefficientExperiment as JaxCoefficientExperiment
from srgan_tpu.data import core as jax_core
from srgan_tpu.data.age import age_datasets as jax_age_datasets
from srgan_tpu.data.age import main as jax_age_main
from srgan_tpu.data.coefficient import \
    coefficient_datasets as jax_coefficient_datasets
from srgan_tpu.data.driving import driving_datasets as jax_driving_datasets
from srgan_tpu.data.driving import \
    load_driving_recording as jax_load_driving_recording
from srgan_tpu.models.dcgan import ConvRegressor as JaxConvRegressor
from srgan_tpu.models.dcgan import DCGANGenerator as JaxGenerator
from srgan_tpu.models.mlp import CoefficientGenerator as JaxMLPGenerator
from srgan_tpu.models.mlp import CoefficientMLP as JaxMLP
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu.train import make_dnn_train_step as jax_make_dnn_train_step
from srgan_tpu.train import make_gan_train_step as jax_make_gan_train_step
from srgan_tpu.utils.mixture import sample_offset_normal as jax_sample_z
from srgan_tpu_torch import convert
from srgan_tpu_torch.apps.age import AgeExperiment
from srgan_tpu_torch.apps.coefficient import CoefficientExperiment
from srgan_tpu_torch.data import core
from srgan_tpu_torch.data.age import age_datasets
from srgan_tpu_torch.data.age import main as age_main
from srgan_tpu_torch.data.age import preprocess_imdb_wiki
from srgan_tpu_torch.data.coefficient import coefficient_datasets
from srgan_tpu_torch.data.driving import (driving_datasets,
                                          load_driving_recording)
from srgan_tpu_torch.models.dcgan import ConvRegressor, DCGANGenerator
from srgan_tpu_torch.models.mlp import CoefficientGenerator, CoefficientMLP
from srgan_tpu_torch.ops import fused_norm as fn
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import (init_train_state, make_dnn_train_step,
                                   make_gan_train_step)
from srgan_tpu_torch.utils.seeding import generator_for

B, SIZE, WIDTH, LATENT, HIDDEN = 4, 32, 8, 16, 8
LR, B1 = 1e-4, 0.9
FWD_TOL = 1e-5
RTOL = 1e-4       # step metrics
GRAD_TOL = 1e-3   # gradients, relative to the tensor's largest
TINY = dict(batch_size=B, age_image_size=SIZE, model_base_width=WIDTH,
            latent_dimension=LATENT, hidden_size=HIDDEN,
            labeled_dataset_size=6, unlabeled_dataset_size=10,
            validation_dataset_size=5, test_dataset_size=3, seed=3,
            learning_rate=LR, adam_b1=B1, mean_offset=0.5,
            data_parallel_devices=1)


def _nchw(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _close_fwd(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= FWD_TOL * float(np.abs(want).max()), (what, err)


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("n,batch", [(10, 4), (3, 4), (8, 8)])
def test_epoch_and_cycling_batches_equal_jax(n, batch):
    """The NumPy batch streams, index for index, including a labeled set
    smaller than a batch (one batch drawn with replacement)."""
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(n, 3)), rng.normal(size=n)
    ours_ds, theirs_ds = core.ArrayDataset(x, y), jax_core.ArrayDataset(x, y)
    for seed in (0, [5, 1, 7]):
        ours = list(core.epoch_batches(ours_ds, batch,
                                       np.random.default_rng(seed)))
        theirs = list(jax_core.epoch_batches(theirs_ds, batch,
                                             np.random.default_rng(seed)))
        assert len(ours) == len(theirs) == max(1, n // batch)
        for a, b in zip(ours, theirs, strict=True):
            for u, v in zip(a, b, strict=True):
                np.testing.assert_array_equal(u, v)
        ours = core.cycling_batches(core.ArrayDataset(x), batch,
                                    np.random.default_rng(seed))
        theirs = jax_core.cycling_batches(jax_core.ArrayDataset(x), batch,
                                          np.random.default_rng(seed))
        for _ in range(7):
            np.testing.assert_array_equal(next(ours)[0], next(theirs)[0])


@pytest.mark.parametrize("start", [0, 3])
def test_experiment_batch_iterators_equal_jax(start):
    """The base experiment's batches (labeled, labels, unlabeled) over two
    epochs, as JAX's ``epoch_batch_iterators`` yields them, from step 0
    and from a resumed step."""
    kw = dict(TINY, labeled_dataset_size=9)
    theirs = JaxCoefficientExperiment(JaxSettings(**kw))
    theirs.dataset_setup()
    theirs.prepare_mesh()
    theirs._start_step = start
    ours = CoefficientExperiment(Settings(**kw), device="cpu")
    ours.dataset_setup()
    ours._start_step = start
    our_epochs, their_epochs = (ours.epoch_batch_iterators(),
                                theirs.epoch_batch_iterators())
    for _ in range(2):
        got, want = list(next(our_epochs)), list(next(their_epochs))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for u, v in zip(a, b, strict=True):
                assert u.dtype == torch.float32
                np.testing.assert_array_equal(u.numpy(), np.asarray(v))


def test_prefetch_keeps_the_order_and_copies():
    batches = [(np.full((2, 3), i, np.float32), np.arange(i, i + 2))
               for i in range(5)]
    got = list(core.prefetch_to_device(iter(batches), torch.device("cpu"),
                                       size=2))
    assert len(got) == 5
    for (a, b), (ta, tb) in zip(batches, got):
        np.testing.assert_array_equal(ta.numpy(), a)
        np.testing.assert_array_equal(tb.numpy(), b)


def _same_splits(ours, theirs):
    for a, b in zip(ours, theirs, strict=True):
        assert a.examples.dtype == b.examples.dtype
        np.testing.assert_array_equal(a.examples, b.examples)
        if b.labels is None:
            assert a.labels is None
        else:
            assert a.labels.dtype == b.labels.dtype
            np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("app", ["coefficient", "age", "driving"])
def test_synthetic_datasets_equal_jax(app):
    kw = dict(TINY, driving_frame_stack=3)
    ours, theirs = {
        "coefficient": (coefficient_datasets, jax_coefficient_datasets),
        "age": (age_datasets, jax_age_datasets),
        "driving": (driving_datasets, jax_driving_datasets)}[app]
    _same_splits(ours(Settings(**kw)), theirs(JaxSettings(**kw)))


def _imdb_wiki_layout(root, n=10):
    """A wiki.mat and JPEGs of mixed sizes; record 2 has a second face,
    record 5 an age out of range, record 7 points at a missing file."""
    rng = np.random.default_rng(0)
    (root / "00").mkdir()
    full_path = np.empty((1, n), object)
    for i in range(n):
        rel = f"00/img_{i}.jpg"
        if i != 7:
            side = int(rng.integers(20, 60))
            Image.fromarray(rng.integers(0, 255, (side, side + 5, 3)).astype(
                np.uint8)).save(root / rel)
        full_path[0, i] = np.array([rel])
    dob = rng.uniform(693962.0, 720000.0, (1, n))
    taken = np.full((1, n), 2000.0)
    taken[0, 5] = 1800.0
    second = np.full((1, n), np.nan)
    second[0, 2] = 3.0
    wiki = np.zeros((1, 1), dtype=[
        ("dob", object), ("photo_taken", object), ("full_path", object),
        ("face_score", object), ("second_face_score", object)])
    wiki[0, 0] = (dob, taken, full_path, np.full((1, n), 2.0), second)
    savemat(root / "wiki.mat", {"wiki": wiki})


def test_preprocess_imdb_wiki_equals_jax(tmp_path):
    _imdb_wiki_layout(tmp_path)
    out = {}
    for name, main in (("ours", age_main), ("theirs", jax_age_main)):
        path = tmp_path / f"{name}.npz"
        with pytest.warns(UserWarning, match="1/8 metadata records"):
            assert main([str(tmp_path), str(tmp_path / "wiki.mat"),
                         str(path), "--image-size", "24"]) == 0
        with np.load(path) as z:
            out[name] = {k: z[k] for k in z}
    assert set(out["ours"]) == {"images", "ages"}
    for key, want in out["theirs"].items():
        got = out["ours"][key]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert out["ours"]["images"].shape == (7, 24, 24, 3)
    with pytest.raises(FileNotFoundError, match="root_directory"):
        preprocess_imdb_wiki(str(tmp_path / "elsewhere"),
                             str(tmp_path / "wiki.mat"), image_size=8)


@pytest.mark.parametrize("stack", [1, 2, 3])
def test_load_driving_recording_equals_jax(tmp_path, stack):
    """A recording with a header, a bad angle and a missing frame: the
    windows that span them are dropped alike."""
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(1)
    rows = ["frame,angle\n"]
    for i in range(12):
        name = f"f{i}.jpg"
        if i != 6:
            Image.fromarray(rng.integers(0, 255, (20, 30, 3)).astype(
                np.uint8)).save(frames / name)
        rows.append(f"{name},{'nan' if i == 3 else 0.1 * i - 0.5}\n")
    csv_path = tmp_path / "steering.csv"
    csv_path.write_text("".join(rows))
    args = (str(frames), str(csv_path))
    got = load_driving_recording(*args, image_size=16, frame_stack=stack)
    want = jax_load_driving_recording(*args, image_size=16,
                                      frame_stack=stack)
    assert len(got[0]) > 0
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- models

def test_mlps_match_flax():
    rng = generator_for(0, "t")
    x = np.random.default_rng(0).normal(size=(5, 10)).astype(np.float32)
    z = np.random.default_rng(1).normal(size=(5, LATENT)).astype(np.float32)
    mlp = JaxMLP(hidden_size=HIDDEN)
    params = mlp.init(jax.random.key(1), jnp.zeros((1, 10)))
    want_pred, want_feats = jax.jit(mlp.apply)(params, jnp.asarray(x))
    ours = CoefficientMLP(10, HIDDEN, rng=rng)
    ours.load_state_dict(convert.mlp_state_dict(jax.device_get(params)))
    pred, feats = ours(torch.from_numpy(x))
    assert pred.shape == (5,) and feats.shape == (5, HIDDEN)
    _close_fwd(pred, want_pred, "prediction")
    _close_fwd(feats, want_feats, "features")
    gen = JaxMLPGenerator(hidden_size=HIDDEN)
    params = gen.init(jax.random.key(2), jnp.zeros((1, LATENT)))
    ours = CoefficientGenerator(LATENT, 10, HIDDEN, rng=rng)
    ours.load_state_dict(convert.mlp_state_dict(jax.device_get(params)))
    _close_fwd(ours(torch.from_numpy(z)),
               jax.jit(gen.apply)(params, jnp.asarray(z)), "generator")


@pytest.mark.parametrize("norm_impl,channels", [("xla", 3), ("pallas", 3),
                                                ("xla", 9), ("fast", 3)])
def test_conv_regressor_and_generator_match_flax(norm_impl, channels):
    """D/DNN and G of the image apps at 3 (age) and 9 channels (driving,
    frame stack 3) under the three norm paths."""
    rng = generator_for(0, "t")
    x = np.random.default_rng(0).uniform(-1, 1, (3, SIZE, SIZE, channels)
                                         ).astype(np.float32)
    reg = JaxConvRegressor(base_width=WIDTH, feature_size=16 * WIDTH,
                           norm_impl=norm_impl)
    params = reg.init(jax.random.key(1), jnp.zeros((1, SIZE, SIZE,
                                                    channels)))
    want_pred, want_feats = jax.jit(reg.apply)(params, jnp.asarray(x))
    ours = ConvRegressor(SIZE, channels, WIDTH, 16 * WIDTH,
                         norm_impl=norm_impl, rng=rng)
    ours.load_state_dict(convert.conv_regressor_state_dict(
        jax.device_get(params)))
    pred, feats = ours(_nchw(x))
    assert pred.shape == (3,) and feats.shape == (3, 16 * WIDTH)
    _close_fwd(pred, want_pred, "prediction")
    _close_fwd(feats, want_feats, "features")

    z = np.random.default_rng(2).normal(size=(3, LATENT)).astype(np.float32)
    gen = JaxGenerator(image_size=SIZE, channels=channels, base_width=WIDTH,
                       latent_dimension=LATENT, norm_impl=norm_impl)
    params = gen.init(jax.random.key(3), jnp.zeros((1, LATENT)))
    ours = DCGANGenerator(SIZE, channels, WIDTH, LATENT, norm_impl=norm_impl,
                          rng=rng)
    ours.load_state_dict(convert.generator_state_dict(
        jax.device_get(params)))
    got = ours(torch.from_numpy(z))
    assert got.shape == (3, channels, SIZE, SIZE)
    _close_fwd(got.permute(0, 2, 3, 1),
               jax.jit(gen.apply)(params, jnp.asarray(z)), "generator")


def test_conv_regressor_pads_and_flattens_as_flax():
    """The k4 s2 convs pad (1, 1) on even inputs (not the (0, 1) of the
    crowd's k3 s2 ones), and the flatten is a view in NHWC order on
    channels_last memory."""
    ours = ConvRegressor(64, 3, 4, 16, rng=generator_for(0, "t"))
    assert [c.weight.shape[1:] for c in ours.convs] == [
        (3, 4, 4), (4, 4, 4), (8, 4, 4), (16, 4, 4)]
    assert ours.dense.weight.shape == (16, 4 * 4 * 32)
    x = torch.randn(2, 32, 4, 4).contiguous(memory_format=torch.channels_last)
    flat = x.permute(0, 2, 3, 1).reshape(2, -1)
    assert flat.data_ptr() == x.data_ptr()
    assert torch.equal(flat[1, :32], x[1, :, 0, 0])


# Every norm of the age/driving SR-GAN step at 64 px, batch 32, base width
# 64: (B, H·W, C) of D over 3B, and of D, the DNN and G over B.
AGE_NORM_SHAPES = [(96, 1024, 64), (96, 256, 128), (96, 64, 256),
                   (96, 16, 512), (32, 1024, 64), (32, 256, 128),
                   (32, 64, 256), (32, 16, 512)]


@pytest.mark.parametrize("b,hw,c", AGE_NORM_SHAPES)
def test_norm_tiling_at_the_age_shapes(b, hw, c):
    """At 16 rows an example the kernels take clusters of one block; the
    larger maps of the batch of 32 grow clusters of 4 blocks of at least
    16 rows (``_MIN_ROWS``), those of the 3B batch fill the card without.
    Every row is owned once and resident (nothing streams)."""
    for direction in ("fwd", "bwd"):
        t = fn.norm_tiling(b, hw, c, torch.bfloat16, direction)
        assert t.rows_per_block * t.cluster >= hw
        assert (t.cluster - 1) * t.rows_per_block < hw
        assert t.resident_rows == t.rows_per_block
        assert t.smem_bytes <= fn._SMEM_BUDGET
        want = 1 if hw == 16 or b == 96 else 4
        if (b, hw, c, direction) == (96, 1024, 64, "bwd"):
            want = 2  # x and dy of 1024 rows do not fit one block
        assert t.cluster == want, (direction, t)
        assert t.rows_per_block >= fn._MIN_ROWS


# ---------------------------------------------------------------- steps

def _jax_draws(key, batch, latent, offset):
    """z_d, z_g and α as JAX's step draws them from its key."""
    k_zd, k_zg, k_alpha = jax.random.split(key, 3)
    return dict(z_d=jax_sample_z(k_zd, (batch, latent), offset),
                z_g=jax_sample_z(k_zg, (batch, latent), offset),
                alpha=jax.random.uniform(k_alpha, (batch,),
                                         dtype=jnp.float32))


_CONVERT = {"coefficient": {"d": convert.mlp_state_dict,
                            "g": convert.mlp_state_dict,
                            "dnn": convert.mlp_state_dict},
            "age": {"d": convert.conv_regressor_state_dict,
                    "g": convert.generator_state_dict,
                    "dnn": convert.conv_regressor_state_dict}}


def _run_both(app, norm_impl, dnn_only):
    kw = dict(TINY, norm_impl=norm_impl, dnn_only=dnn_only)
    jax_cls, cls = {
        "coefficient": (JaxCoefficientExperiment, CoefficientExperiment),
        "age": (JaxAgeExperiment, AgeExperiment)}[app]
    theirs = jax_cls(JaxSettings(**kw))
    theirs.dataset_setup()
    models, d_params, g_params, dnn_params = theirs.model_setup()
    j_state = jax_init_train_state(theirs.settings, d_params, g_params,
                                   dnn_params)
    lab = theirs.labeled_dataset
    x, y = lab.examples[:B], lab.labels[:B]
    u = theirs.unlabeled_dataset.examples[:B]
    key = jax.random.key(11)
    if dnn_only:
        j_step = jax.jit(jax_make_dnn_train_step(theirs.settings, models))
        j_new, j_metrics = j_step(j_state, jnp.asarray(x), jnp.asarray(y))
    else:
        j_step = jax.jit(jax_make_gan_train_step(theirs.settings, models))
        j_new, j_metrics = j_step(j_state, jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(u), key)

    ours = cls(Settings(**kw), device="cpu")
    ours.dataset_setup()
    bundle = ours.model_setup()
    host = jax.device_get
    for name, params in (("d", d_params), ("g", g_params),
                         ("dnn", dnn_params)):
        getattr(bundle, name).load_state_dict(
            _CONVERT[app][name](host(params)))
    before = {name: {k: v.clone() for k, v in
                     getattr(bundle, name).state_dict().items()}
              for name in ("d", "g", "dnn")}
    state = init_train_state(ours.settings, bundle)
    if dnn_only:
        step = make_dnn_train_step(ours.settings)
        state, metrics = step(state, _nchw(x), torch.from_numpy(y))
    else:
        step = make_gan_train_step(ours.settings)
        draws = {k: torch.from_numpy(np.array(v)) for k, v in
                 _jax_draws(key, B, LATENT, TINY["mean_offset"]).items()}
        state, metrics = step(state, _nchw(x), torch.from_numpy(y),
                              _nchw(u), **draws)
    return dict(app=app, j_new=host(j_new), j_metrics=host(j_metrics),
                state=state, metrics=metrics, before=before)


@pytest.fixture(scope="module", params=[
    ("coefficient", "xla", False), ("age", "xla", False),
    ("age", "pallas", False), ("age", "xla", True)],
    ids=["coefficient", "age-xla", "age-pallas", "age-dnn_only"])
def both_steps(request):
    return _run_both(*request.param)


def _jax_tree(run, name, what):
    j_new = run["j_new"]
    params = getattr(j_new, f"{name}_params")
    adam = getattr(j_new, f"{name}_opt")[0]   # optax ScaleByAdamState
    return _CONVERT[run["app"]][name]({"params": params, "mu": adam.mu,
                                       "nu": adam.nu}[what])


def _bias_cancelled_by_norm(module, key: str) -> bool:
    """A conv bias right before a GroupNorm of one channel per group."""
    parts = key.split(".")
    if len(parts) != 3 or parts[0] not in ("convs", "deconvs") \
            or parts[2] != "bias":
        return False
    i = int(parts[1]) + (1 if parts[0] == "deconvs" else 0)
    norms = getattr(module, "norms", None)
    if norms is None or i >= len(norms):
        return False
    return norms[i].num_groups == norms[i].scale.numel()


def _trained(run):
    """The models the step updates: the DNN alone in a DNN-only step."""
    return ("dnn",) if set(run["metrics"]) == {"dnn_loss"} \
        else ("d", "g", "dnn")


def test_step_metrics_match(both_steps):
    j, ours = both_steps["j_metrics"], both_steps["metrics"]
    assert set(ours) == set(j)
    for k in j:
        np.testing.assert_allclose(float(ours[k]), float(j[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)


def test_step_gradients_and_parameters_match(both_steps):
    run = both_steps
    state = run["state"]
    for name in _trained(run):
        module = getattr(state, name)
        opt = getattr(state, f"{name}_opt")
        j_mu = _jax_tree(run, name, "mu")
        j_params = _jax_tree(run, name, "params")
        params = dict(module.named_parameters())
        assert set(params) == set(j_mu)
        scale = max(float(m.abs().max()) for m in j_mu.values()) / (1 - B1)
        for k, p in params.items():
            j_grad = j_mu[k].numpy() / (1 - B1)
            moved = (p.detach() - run["before"][name][k]).numpy()
            want = (j_params[k] - run["before"][name][k]).numpy()
            assert np.abs(moved - want).max() <= 2 * LR, f"{name} {k}"
            if _bias_cancelled_by_norm(module, k):
                assert np.abs(j_grad).max() <= 1e-5 * scale, k
                assert float(p.grad.abs().max()) <= 1e-5 * scale, k
                continue
            g_max = float(np.abs(j_grad).max())
            err = float(np.abs(p.grad.numpy() - j_grad).max())
            assert err <= GRAD_TOL * g_max, f"{name} grad {k}: {err}"
            exp_avg = opt.adam.state[p]["exp_avg"].numpy()
            assert np.abs(exp_avg - j_mu[k].numpy()).max() <= \
                GRAD_TOL * (1 - B1) * g_max, f"{name} m {k}"
            large = np.abs(j_grad) > 1e-2 * g_max
            np.testing.assert_allclose(moved[large], want[large], rtol=0,
                                       atol=1e-3 * LR,
                                       err_msg=f"{name} {k}")
    # What the step does not train stays at its init.
    for name in {"d", "g", "dnn"} - set(_trained(run)):
        for k, v in getattr(state, name).state_dict().items():
            assert torch.equal(v, run["before"][name][k]), (name, k)
    assert state.step == 1


# ------------------------------------------------------- evaluation

@pytest.mark.parametrize("app,norm_impl", [("coefficient", "xla"),
                                           ("age", "xla")])
def test_predict_and_evaluate_equal_jax(app, norm_impl):
    kw = dict(TINY, norm_impl=norm_impl)
    jax_cls, cls = {
        "coefficient": (JaxCoefficientExperiment, CoefficientExperiment),
        "age": (JaxAgeExperiment, AgeExperiment)}[app]
    theirs = jax_cls(JaxSettings(**kw))
    theirs.dataset_setup()
    models, d, g, dnn = theirs.model_setup()
    theirs.models = models
    theirs.state = jax_init_train_state(theirs.settings, d, g, dnn)
    theirs.prepare_mesh()
    theirs.prepare_train_step()
    ours = cls(Settings(**kw), device="cpu")
    ours.dataset_setup()
    bundle = ours.model_setup()
    for name, params in (("d", d), ("g", g), ("dnn", dnn)):
        getattr(bundle, name).load_state_dict(
            _CONVERT[app][name](jax.device_get(params)))
    ours.state = init_train_state(ours.settings, bundle)
    for use_dnn in (False, True):
        _close_fwd(ours.predict(ours.validation_dataset, use_dnn=use_dnn),
                   theirs.predict(theirs.validation_dataset,
                                  use_dnn=use_dnn), "predict")
        for split in ("validation_dataset", "test_dataset"):
            got = ours.evaluate(getattr(ours, split), use_dnn=use_dnn)
            want = theirs.evaluate(getattr(theirs, split), use_dnn=use_dnn)
            assert set(got) == set(want) == {"MAE", "RMSE", "NVE"}
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=f"{split} {k}")
    assert ours.test() == ours.evaluate(ours.test_dataset)
    with pytest.raises(ValueError, match="empty dataset"):
        ours.evaluate(ours.test_dataset.subset(slice(0, 0)))
