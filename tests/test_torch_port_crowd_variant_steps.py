"""One fused step of the port's crowd variants against the JAX package's,
on the CPU at a tiny size: the JointDCNN and SpatialPyramidCNN models on
density targets and the JointCNN on iKNN targets, under both norm paths
("pallas": JAX's Pallas kernels in interpret mode, the port's plain
versions), from the same converted weights, patches and random draws
(JAX's z_d, z_g and α fed to the port's step). float32.

Tolerances: the metrics rtol 1e-4 and the gradients within 1e-3 of each
tensor's largest (``tests/test_torch_port_train_step.py`` gives the
reasons). The rest of the crowd variants is in
``tests/test_torch_port_crowd_variants.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowd_variants_helpers import B, B1, LATENT, P, TINY, nchw, within
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


# ------------------------------------------------------------ fused steps
def _batch(db_l, db_u, labels_of, rng):
    """Patches [B, P, P, 3] in [-1, 1], labels, unlabeled patches."""
    h, w = db_l.image_size

    def args():
        return (rng.integers(0, len(db_l), B),
                np.stack([rng.integers(0, h - P + 1, B),
                          rng.integers(0, w - P + 1, B)], -1),
                rng.integers(0, 2, B))

    (i, o, f), (ui, uo, uf) = args(), args()
    x = extract_patches_reference(db_l.images, o, f, P, 2 / 255, -1.0, i)
    y = extract_patches_reference(labels_of, o, f, P, indices=i)
    if y.shape[-1] == 1:
        y = y[..., 0]
    u = extract_patches_reference(db_u.images, uo, uf, P, 2 / 255, -1.0, ui)
    return x, y, u


STEP_CASES = [("jointdcnn", "density"), ("pyramid", "density"),
              ("jointcnn", "iknn")]


@pytest.fixture(scope="module",
                params=[(m, t, n) for m, t in STEP_CASES
                        for n in ("xla", "pallas")],
                ids=lambda p: "-".join(p))
def both_steps(request):
    name, label_type, norm_impl = request.param
    settings = dict(TINY, crowd_model=name, crowd_label_type=label_type,
                    norm_impl=norm_impl)
    jexp = JaxCrowdExperiment(JaxSettings(**settings))
    jexp.dataset_setup()
    models, d_params, g_params, dnn_params = jexp.model_setup()
    j_state = jax_init_train_state(jexp.settings, d_params, g_params,
                                   dnn_params)
    j_step = jax.jit(jax_make_gan_train_step(
        jexp.settings, models, labeled_loss_fn=jexp.labeled_loss_fn(),
        latent_shape=(LATENT,)))
    x, y, u = _batch(jexp.labeled_db, jexp.unlabeled_db,
                     jexp._stacked_labels(), np.random.default_rng(4))
    key = jax.random.key(7)
    j_new, j_metrics = j_step(j_state, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(u), key)
    k_zd, k_zg, k_alpha = jax.random.split(key, 3)
    z_d = jax_sample_z(k_zd, (B, LATENT), 0.5)
    z_g = jax_sample_z(k_zg, (B, LATENT), 0.5)
    alpha = jax.random.uniform(k_alpha, (B,), dtype=jnp.float32)

    exp = CrowdExperiment(Settings(**settings), device="cpu")
    exp.dataset_setup()
    bundle = exp.model_setup()
    host = jax.device_get
    bundle.d.load_state_dict(convert.joint_cnn_state_dict(host(d_params)))
    bundle.dnn.load_state_dict(convert.joint_cnn_state_dict(
        host(dnn_params)))
    bundle.g.load_state_dict(convert.generator_state_dict(host(g_params)))
    state = init_train_state(exp.settings, bundle)
    step = make_gan_train_step(exp.settings,
                               labeled_loss_fn=exp.labeled_loss_fn(),
                               latent_shape=(LATENT,))
    state, metrics = step(state, nchw(x), torch.from_numpy(y), nchw(u),
                          z_d=torch.from_numpy(np.array(z_d)),
                          z_g=torch.from_numpy(np.array(z_g)),
                          alpha=torch.from_numpy(np.array(alpha)))
    return dict(j_new=host(j_new), j_metrics=host(j_metrics), state=state,
                metrics=metrics)


def test_step_metrics_match(both_steps):
    j = both_steps["j_metrics"]
    ours = both_steps["metrics"]
    assert set(ours) == set(j)
    for k in j:
        np.testing.assert_allclose(float(ours[k]), float(j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _cancelled_by_norm(module, key):
    """A conv bias right before a GroupNorm of one channel per group: its
    true gradient is 0, and both sides hold rounding noise."""
    parts = key.split(".")
    norms = getattr(module, "norms", None)
    if parts[0] not in ("convs", "deconvs") or parts[-1] != "bias" \
            or norms is None:
        return False
    i = int(parts[1]) + (1 if parts[0] == "deconvs" else 0)
    return i < len(norms) and norms[i].num_groups == norms[i].scale.numel()


@pytest.mark.parametrize("name", ["d", "g", "dnn"])
def test_step_gradients_match(both_steps, name):
    module = getattr(both_steps["state"], name)
    convert_fn = (convert.generator_state_dict if name == "g"
                  else convert.joint_cnn_state_dict)
    adam = getattr(both_steps["j_new"], f"{name}_opt")[0]
    j_mu = convert_fn(adam.mu)
    params = dict(module.named_parameters())
    assert set(params) == set(j_mu)
    for k, p in params.items():
        if _cancelled_by_norm(module, k):
            continue
        within(p.grad, j_mu[k].numpy() / (1 - B1), 1e-3, f"{name} {k}")
