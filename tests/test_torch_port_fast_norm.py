"""``norm_impl="fast"`` in the port: ``FastGroupNorm`` against JAX's
(``srgan_tpu.models.dcgan.FastGroupNorm``) on the same parameters and
inputs, the converter on ``FastGroupNorm_i`` trees, the checkpoint's
structure check, a ``steps_per_dispatch`` chunk, and a bfloat16 crowd
trial (``tests/test_fast_norm.py``'s).

Tolerances:
* float32: the output within 1e-5 (absolute), the first gradients w.r.t.
  x, scale and bias within 1e-5 of each tensor's largest magnitude
  (measured: 1.5e-6 and 7e-7).
* bfloat16 forward: bit-equal at ``PROBE`` ([4, 14, 14, 64], 32 groups).
  The port keeps the variance's squares in float32, as XLA does (see
  ``fast_group_norm_nchw``). At other shapes a float32 sum in another
  order can round a group's mean or rsqrt to the neighbouring bfloat16
  value, which moves the group's outputs by about one ulp of each.
* bfloat16 gradients: x within 1e-2 of its largest (two ulps; measured
  3.2e-3 to 4.8e-3). JAX sums the scale and bias cotangents over the
  784 (example, pixel) terms in bfloat16 (the HLO's reduce is bf16 →
  bf16), the port in float32. So the port's bias gradient is held to the
  float64 sum of its bf16 terms within 1e-2 of its largest, and scale
  and bias to JAX's within 8e-2 of their largest (measured 3.3e-2 and
  5.7e-2, where JAX's own bias gradient is 6e-2 from the float64 sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.models import crowd as jax_crowd
from srgan_tpu.models.dcgan import FastGroupNorm as JaxFastGroupNorm
from srgan_tpu_torch import convert
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.models import crowd
from srgan_tpu_torch.models.dcgan import FastGroupNorm, group_norm
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state
from srgan_tpu_torch.utils.seeding import generator_for

PROBE = ((4, 14, 14, 64), 32)
F32_TOL = 1e-5
BF16_X_TOL = 1e-2
BF16_PARAM_TOL = 8e-2
# tests/test_fast_norm.py's bfloat16 crowd trial, with a test split of 2
# synthetic images (not the default 1000: it is not used).
FAST_TRIAL = dict(
    trial_name="fastnorm", batch_size=8, steps_to_run=3,
    summary_step_period=2, labeled_dataset_size=6, unlabeled_dataset_size=8,
    validation_dataset_size=3, test_dataset_size=2, crowd_image_height=80,
    crowd_image_width=96, image_patch_size=32, crowd_sigma=3.0,
    model_base_width=8, latent_dimension=16, compute_dtype="bfloat16",
    norm_impl="fast")


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return ((rng.normal(size=shape) * 3 + 1).astype(np.float32),
            rng.normal(1, 0.2, c).astype(np.float32),
            rng.normal(0, 0.3, c).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _both(shape, groups, dtype_name, seed=0):
    """JAX's and the port's output and first gradients of
    sum(w · y) w.r.t. (x, scale, bias), on the same inputs."""
    x, scale, bias, w = _inputs(shape, seed)
    jax_norm = JaxFastGroupNorm(num_groups=groups,
                                dtype=getattr(jnp, dtype_name))
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}

    def loss(p, x):
        return jnp.sum(jax_norm.apply(p, x).astype(jnp.float32) * w)

    want_y = jax.jit(jax_norm.apply)(params, jnp.asarray(x))
    j_params, j_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    want = {"y": np.asarray(want_y.astype(jnp.float32)),
            "x": np.asarray(j_x),
            "scale": np.asarray(j_params["params"]["scale"]),
            "bias": np.asarray(j_params["params"]["bias"])}

    norm = FastGroupNorm(shape[-1], groups, dtype=getattr(torch, dtype_name))
    norm.load_state_dict({"scale": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    xt = _nchw(x).requires_grad_(True)
    y = norm(xt)
    gx, gs, gb = torch.autograd.grad(
        (y.float() * _nchw(w)).sum(), [xt, norm.scale, norm.bias])
    got = {"y": _nhwc(y), "x": _nhwc(gx), "scale": gs.numpy(),
           "bias": gb.numpy()}
    return got, want, w


def _within(got, want, tol, what):
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def test_float32_matches_jax():
    got, want, _ = _both(*PROBE, "float32")
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=F32_TOL)
    for name in ("x", "scale", "bias"):
        _within(got[name], want[name], F32_TOL, name)


def test_bfloat16_matches_jax():
    got, want, w = _both(*PROBE, "bfloat16")
    np.testing.assert_array_equal(got["y"], want["y"])
    _within(got["x"], want["x"], BF16_X_TOL, "x")
    exact_bias = w.astype(jnp.bfloat16).astype(np.float64).sum((0, 1, 2))
    _within(got["bias"], exact_bias, BF16_X_TOL, "bias vs float64")
    for name in ("scale", "bias"):
        _within(got[name], want[name], BF16_PARAM_TOL, name)


def test_the_group_count_falls_back_to_a_divisor():
    """tests/test_fast_norm.py's 6 channels under 4 groups: JAX lowers
    the count to 3; the port resolves it once, at construction."""
    norm = FastGroupNorm(6, 4, dtype=torch.float32)
    assert norm.num_groups == 3
    got, want, _ = _both((2, 4, 4, 6), 4, "float32", seed=1)
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=F32_TOL)
    _within(got["x"], want["x"], F32_TOL, "x")


def test_the_factory_and_epsilon():
    """``group_norm(..., "fast")`` is a FastGroupNorm of
    ``min(32, width)`` groups; ε is JAX's 1e-5 rounded to the compute
    dtype, a Python float."""
    norm = group_norm(16, torch.bfloat16, "fast")
    assert isinstance(norm, FastGroupNorm) and norm.num_groups == 16
    assert type(norm.epsilon) is float
    assert norm.epsilon == float(jnp.asarray(1e-5, jnp.bfloat16))
    assert group_norm(64, torch.float32, "fast").epsilon == float(
        np.float32(1e-5))


@pytest.mark.parametrize("name", ["jointcnn", "jointdcnn", "pyramid"])
def test_the_converter_reads_fast_group_norm_trees(name):
    """A flax crowd network under "fast" holds ``FastGroupNorm_i``; the
    converter maps them onto the port's norms in JAX's order, and the
    port's network on the converted weights equals flax's (float32,
    rtol 1e-4 as tests/test_torch_port_models.py)."""
    p, width, b = 32, 8, 3
    kw = dict(zero_init_heads=False, density_head_bias=0.25,
              count_head_bias=-0.5)
    flax_model = jax_crowd.CROWD_MODELS[name](base_width=width,
                                              norm_impl="fast", **kw)
    x = np.random.default_rng(0).uniform(-1, 1, (b, p, p, 3)).astype(
        np.float32)
    params = flax_model.init(jax.random.key(1), jnp.zeros((1, p, p, 3)))
    assert "FastGroupNorm_0" in params["params"]
    (j_density, j_count), j_feats = flax_model.apply(params, jnp.asarray(x))
    extra = dict(image_size=p) if name == "pyramid" else {}
    model = crowd.CROWD_MODELS[name](width, norm_impl="fast",
                                     rng=generator_for(0, "t"), **kw,
                                     **extra)
    model.load_state_dict(convert.joint_cnn_state_dict(
        jax.device_get(params)))
    (density, count), feats = model(_nchw(x))
    for ours, theirs in ((density, j_density), (count, j_count),
                         (feats, j_feats)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(theirs).max()))
    tree = params["params"]
    with pytest.raises(KeyError, match="GroupNorm_1, FastGroupNorm_1 or "
                                       "FusedGroupNormAct_1"):
        convert.joint_cnn_state_dict({k: tree[k] for k in (
            "Conv_0", "Conv_1", "FastGroupNorm_0")})


# -------------------------------------------------- the crowd app
@pytest.fixture(scope="module")
def fast_trial(tmp_path_factory):
    """tests/test_fast_norm.py's bfloat16 crowd trial through the port's
    ``train()``, its checkpoint saved at the end."""
    logs = tmp_path_factory.mktemp("fast_trial")
    exp = CrowdExperiment(Settings(**FAST_TRIAL,
                                   logs_directory=str(logs)), device="cpu")
    state = exp.train()
    return exp, state


def test_a_bfloat16_crowd_trial_trains_and_evaluates(fast_trial):
    exp, state = fast_trial
    assert state.step == 3
    assert all(isinstance(n, FastGroupNorm) for n in state.d.norms)
    assert np.isfinite(exp.evaluate()["MAE"])


@pytest.mark.parametrize("other", ["xla", "pallas"])
def test_a_fast_checkpoint_refuses_another_norm(fast_trial, other):
    """The checkpoint records each parameter's owner class, so a "fast"
    trial restored under another norm raises the structure error, as
    JAX's Orbax tree of ``FastGroupNorm_i`` does against ``GroupNorm_i``.
    """
    exp, _ = fast_trial
    again = CrowdExperiment(exp.settings.copy(norm_impl=other),
                            device="cpu")
    with pytest.raises(ValueError, match="norm_impl.*saved FastGroupNorm"):
        again.prepare_for_evaluation(exp.trial_directory)


def test_a_k2_chunk_is_two_eager_steps(tmp_path):
    """``steps_per_dispatch=2`` under "fast": a chunk's metrics, models
    and generator equal two single steps' from the same seed, bit for
    bit (tests/test_torch_port_chunked.py's check)."""
    settings = Settings(**dict(
        FAST_TRIAL, compute_dtype="float32", steps_per_dispatch=2,
        logs_directory=str(tmp_path)))
    runs = {}
    for how in ("chunk", "steps"):
        exp = CrowdExperiment(settings, device="cpu")
        exp.dataset_setup()
        exp.models = exp.model_setup()
        exp.state = init_train_state(settings, exp.models)
        exp.prepare_train_step()
        args = exp._patch_args_stream()
        if how == "chunk":
            chunk = exp.dispatch_chunk(args)
            metrics = [{k: v[i] for k, v in chunk.items()} for i in range(2)]
        else:
            data, metrics = exp._device_data, []
            for _ in range(2):
                batch = exp._sample_batch(
                    data["labeled_images"], data["labeled_density"],
                    data["unlabeled_images"], *next(args))
                exp.state, m = exp._train_step(exp.state, *batch, exp._rng)
                metrics.append(m)
        runs[how] = dict(metrics=metrics, rng=exp._rng.get_state(),
                         models={f"{n}.{k}": v for n in ("d", "g", "dnn")
                                 for k, v in getattr(exp.state, n)
                                 .state_dict().items()})
    chunk, steps = runs["chunk"], runs["steps"]
    for a, b in zip(chunk["metrics"], steps["metrics"], strict=True):
        assert set(a) == set(b)
        for k in b:
            assert torch.equal(a[k], b[k]), k
    assert set(chunk["models"]) == set(steps["models"])
    for k, v in steps["models"].items():
        assert torch.equal(chunk["models"][k], v), k
    assert torch.equal(chunk["rng"], steps["rng"])
