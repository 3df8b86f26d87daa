"""One whole SR-GAN step of the port against ``srgan_tpu.train``'s.

Same weights (the flax init, converted), same patches (cut from the same
synthetic database with the same host draws), and the same random draws:
JAX's z_d, z_g and α are reproduced from the step's key exactly as
``make_gan_train_step`` splits it, and fed to the port's step. Compared:
every metric, the D/G/DNN gradients (recovered on the JAX side from Adam's
first moment, which after one step is (1 − b1)·g), Adam's moments, and
the parameters after the step. float32 on the CPU. The three norm paths
run: ``norm_impl="xla"`` (flax GroupNorm; the port's composite),
``"fast"`` (JAX's FastGroupNorm; the port's) and ``"pallas"`` (JAX's
Pallas kernels in interpret mode; the port's fused autograd Functions on
their plain versions).

Tolerances (the two sides sum in different orders: convolutions,
GroupNorm statistics, the double backward; f32 rounding differs by up to
~3e-4 of a tensor's largest gradient):
* metrics: rtol 1e-4.
* gradients and Adam's first moment: within 1e-3 × the tensor's largest
  magnitude; Adam's second moment (∝ g²) within twice that.
* a conv bias followed by a GroupNorm of one channel per group has a true
  gradient of 0 (the norm subtracts it again): both sides must be below
  1e-5 × the model's largest gradient, and the parameter is left out of
  the post-step comparison, where Adam turns that rounding noise into ±lr.
* parameters after the step: Adam's first update is lr·g/(|g| + ε), i.e.
  ±lr wherever |g| ≫ ε = 1e-8, so a rounding difference in a gradient
  can flip an update only where |g| is near the rounding noise. Where
  |g| > 1e-2 × the tensor's largest, the update must agree to 1e-3·lr and
  have moved the parameter by about lr; everywhere it must agree to 2·lr
  (the most one Adam step can move a parameter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu.train import make_gan_train_step as jax_make_gan_train_step
from srgan_tpu.utils.mixture import sample_offset_normal as jax_sample_z
from srgan_tpu_torch import convert
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.ops.patches import extract_patches_reference
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state, make_gan_train_step

P, WIDTH, LATENT, B = 32, 8, 16, 4
LR, B1 = 1e-4, 0.9
RTOL = 1e-4       # metrics
GRAD_TOL = 1e-3   # gradients, relative to the tensor's largest
SETTINGS = dict(batch_size=B, image_patch_size=P, model_base_width=WIDTH,
                latent_dimension=LATENT, labeled_dataset_size=6,
                unlabeled_dataset_size=6, validation_dataset_size=1,
                test_dataset_size=1, crowd_image_height=80,
                crowd_image_width=96, crowd_synthetic_max_heads=12,
                learning_rate=LR, adam_b1=B1, seed=2, mean_offset=0.5,
                # Random (not zero) heads: every D/DNN parameter then gets
                # a gradient from every loss stream.
                zero_init_heads=False)


def _batch(db_l, db_u, rng):
    """Patches [B, P, P, 3] in [-1, 1], labels [B, P, P], unlabeled."""
    h, w = db_l.image_size

    def args():
        return (rng.integers(0, len(db_l), B),
                np.stack([rng.integers(0, h - P + 1, B),
                          rng.integers(0, w - P + 1, B)], -1),
                rng.integers(0, 2, B))

    (i, o, f), (ui, uo, uf) = args(), args()
    x = extract_patches_reference(db_l.images, o, f, P, 2 / 255, -1.0, i)
    y = extract_patches_reference(db_l.density_maps[..., None], o, f, P,
                                  indices=i)[..., 0]
    u = extract_patches_reference(db_u.images, uo, uf, P, 2 / 255, -1.0, ui)
    return x, y, u


@pytest.fixture(scope="module", params=["xla", "fast", "pallas"])
def both_steps(request):
    settings = dict(SETTINGS, norm_impl=request.param)
    # ---- JAX: the step as the crowd app builds it ------------------------
    jexp = JaxCrowdExperiment(JaxSettings(**settings))
    jexp.dataset_setup()
    models, d_params, g_params, dnn_params = jexp.model_setup()
    j_state = jax_init_train_state(jexp.settings, d_params, g_params,
                                   dnn_params)
    j_step = jax.jit(jax_make_gan_train_step(
        jexp.settings, models, labeled_loss_fn=jexp.labeled_loss_fn(),
        latent_shape=(LATENT,)))
    x, y, u = _batch(jexp.labeled_db, jexp.unlabeled_db,
                     np.random.default_rng(4))
    key = jax.random.key(7)
    j_new, j_metrics = j_step(j_state, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(u), key)
    # The step's own draws (train.py: split into z_d, z_g, α keys).
    k_zd, k_zg, k_alpha = jax.random.split(key, 3)
    z_d = jax_sample_z(k_zd, (B, LATENT), 0.5)
    z_g = jax_sample_z(k_zg, (B, LATENT), 0.5)
    alpha = jax.random.uniform(k_alpha, (B,), dtype=jnp.float32)

    # ---- the port, on the converted flax weights -------------------------
    exp = CrowdExperiment(Settings(**settings), device="cpu")
    exp.dataset_setup()
    bundle = exp.model_setup()
    host = jax.device_get
    bundle.d.load_state_dict(convert.joint_cnn_state_dict(host(d_params)))
    bundle.dnn.load_state_dict(convert.joint_cnn_state_dict(
        host(dnn_params)))
    bundle.g.load_state_dict(convert.generator_state_dict(host(g_params)))
    before = {name: {k: v.clone() for k, v in m.state_dict().items()}
              for name, m in (("d", bundle.d), ("g", bundle.g),
                              ("dnn", bundle.dnn))}
    state = init_train_state(exp.settings, bundle)
    step = make_gan_train_step(exp.settings,
                               labeled_loss_fn=exp.labeled_loss_fn(),
                               latent_shape=(LATENT,))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    state, metrics = step(state, nchw(x), torch.from_numpy(y), nchw(u),
                          z_d=torch.from_numpy(np.array(z_d)),
                          z_g=torch.from_numpy(np.array(z_g)),
                          alpha=torch.from_numpy(np.array(alpha)))
    return dict(j_new=host(j_new), j_metrics=host(j_metrics), state=state,
                metrics=metrics, before=before)


_CONVERTERS = {"d": convert.joint_cnn_state_dict,
               "dnn": convert.joint_cnn_state_dict,
               "g": convert.generator_state_dict}


def _jax_tree(j_new, name, what):
    params = getattr(j_new, f"{name}_params")
    adam = getattr(j_new, f"{name}_opt")[0]   # optax ScaleByAdamState
    return _CONVERTERS[name]({"params": params, "mu": adam.mu,
                              "nu": adam.nu}[what])


def _assert_close(ours, theirs, what, tol=GRAD_TOL):
    theirs = np.asarray(theirs, np.float32)
    ours = ours.detach().numpy()
    scale = float(np.abs(theirs).max())
    assert np.abs(ours - theirs).max() <= tol * scale, what


def _bias_cancelled_by_norm(module, key: str) -> bool:
    """A conv bias right before a GroupNorm of one channel per group."""
    parts = key.split(".")
    if len(parts) != 3 or parts[0] not in ("convs", "deconvs") \
            or parts[2] != "bias":
        return False
    layer, index, _ = parts
    norms = getattr(module, "norms", None)
    i = int(index) + (1 if layer == "deconvs" else 0)  # G: norms[0] is Dense's
    if norms is None or i >= len(norms):
        return False
    return norms[i].num_groups == norms[i].scale.numel()


def test_metrics_match(both_steps):
    j = both_steps["j_metrics"]
    ours = both_steps["metrics"]
    assert set(ours) == set(j)
    for k in j:
        np.testing.assert_allclose(float(ours[k]), float(j[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["d", "g", "dnn"])
def test_gradients_and_adam_moments_match(both_steps, name):
    module = getattr(both_steps["state"], name)
    opt = getattr(both_steps["state"], f"{name}_opt")
    j_mu = _jax_tree(both_steps["j_new"], name, "mu")
    j_nu = _jax_tree(both_steps["j_new"], name, "nu")
    params = dict(module.named_parameters())
    assert set(params) == set(j_mu)
    model_scale = max(float(m.abs().max()) for m in j_mu.values()) / (1 - B1)
    for k, p in params.items():
        j_grad = j_mu[k].numpy() / (1 - B1)
        if _bias_cancelled_by_norm(module, k):
            assert np.abs(j_grad).max() <= 1e-5 * model_scale, k
            assert float(p.grad.abs().max()) <= 1e-5 * model_scale, k
            continue
        _assert_close(p.grad, j_grad, f"{name} grad {k}")
        adam = opt.adam.state[p]
        _assert_close(adam["exp_avg"], j_mu[k], f"{name} m {k}")
        _assert_close(adam["exp_avg_sq"], j_nu[k], f"{name} v {k}",
                      tol=2 * GRAD_TOL)


@pytest.mark.parametrize("name", ["d", "g", "dnn"])
def test_parameters_after_the_step_match(both_steps, name):
    module = getattr(both_steps["state"], name)
    before = both_steps["before"][name]
    j_params = _jax_tree(both_steps["j_new"], name, "params")
    j_mu = _jax_tree(both_steps["j_new"], name, "mu")
    compared = 0
    for k, p in module.named_parameters():
        ours = (p.detach() - before[k]).numpy()
        theirs = (j_params[k] - before[k]).numpy()
        assert np.abs(ours - theirs).max() <= 2 * LR, f"{name} {k}"
        if _bias_cancelled_by_norm(module, k):
            continue
        g = np.abs(j_mu[k].numpy())
        large = g > 1e-2 * g.max()
        np.testing.assert_allclose(ours[large], theirs[large], rtol=0,
                                   atol=1e-3 * LR, err_msg=f"{name} {k}")
        assert np.all(np.abs(ours[large]) > 0.99 * LR), f"{name} {k}"
        compared += int(large.sum())
    assert compared > 0
