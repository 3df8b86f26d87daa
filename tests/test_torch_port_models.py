"""The port's crowd models against the flax models on converted weights:
JointCNN (with and without norms, random heads) and CrowdDCGenerator
(exact doubling and the center-crop geometry). float32, rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.models.crowd import CrowdDCGenerator as JaxGenerator
from srgan_tpu.models.crowd import JointCNN as JaxJointCNN
from srgan_tpu_torch import convert
from srgan_tpu_torch.models.crowd import CrowdDCGenerator, JointCNN
from srgan_tpu_torch.models.dcgan import same_padding
from srgan_tpu_torch.utils.seeding import generator_for

P, WIDTH, LATENT, B = 32, 8, 16, 3
RTOL = 1e-4


def _close(ours, theirs):
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=RTOL,
                               atol=RTOL * float(np.abs(theirs).max()))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("use_norm", [True, False])
def test_joint_cnn_matches_flax(use_norm):
    kw = dict(zero_init_heads=False, density_head_bias=0.25,
              count_head_bias=-0.5)
    flax_model = JaxJointCNN(base_width=WIDTH, use_norm=use_norm, **kw)
    x = np.random.default_rng(0).uniform(-1, 1, (B, P, P, 3)).astype(
        np.float32)
    params = flax_model.init(jax.random.key(1), jnp.zeros((1, P, P, 3)))
    (j_density, j_count), j_feats = flax_model.apply(params, jnp.asarray(x))

    model = JointCNN(WIDTH, use_norm=use_norm, rng=generator_for(0, "t"),
                     **kw)
    model.load_state_dict(convert.joint_cnn_state_dict(
        jax.device_get(params)))
    (density, count), feats = model(_nchw(x))
    assert density.shape == (B, P // 4, P // 4) == j_density.shape
    _close(density, j_density)
    _close(count, j_count)
    _close(feats, j_feats)


@pytest.mark.parametrize("image_size", [P, 72])
def test_generator_matches_flax(image_size):
    flax_model = JaxGenerator(image_size=image_size, base_width=WIDTH,
                              latent_dimension=LATENT)
    z = np.random.default_rng(2).normal(0, 1, (B, LATENT)).astype(np.float32)
    params = flax_model.init(jax.random.key(3), jnp.zeros((1, LATENT)))
    want = np.asarray(flax_model.apply(params, jnp.asarray(z)))

    model = CrowdDCGenerator(image_size=image_size, base_width=WIDTH,
                             latent_dimension=LATENT,
                             rng=generator_for(0, "t"))
    model.load_state_dict(convert.generator_state_dict(
        jax.device_get(params)))
    got = model(torch.from_numpy(z))
    assert got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(got.permute(0, 2, 3, 1), want)


def test_same_padding_is_flax_same():
    assert same_padding(224, 3, 2) == (0, 1)    # even input, stride 2
    assert same_padding(225, 3, 2) == (1, 1)
    assert same_padding(56, 3, 1) == (1, 1)
    assert same_padding(56, 1, 1) == (0, 0)


def test_random_init_follows_flax_defaults():
    model = JointCNN(64, rng=generator_for(0, "init"),
                     density_head_bias=0.5, count_head_bias=0.25)
    w = model.convs[1].weight.detach()  # fan_in 3·3·64
    std = float(w.std())
    assert abs(std - (1.0 / 576) ** 0.5) < 0.05 * (1.0 / 576) ** 0.5
    assert float(w.abs().max()) <= 2 * (1.0 / 576) ** 0.5 / 0.8796 + 1e-6
    assert float(model.convs[1].bias.detach().abs().max()) == 0.0
    assert float(model.density_head.weight.detach().abs().max()) == 0.0
    assert float(model.density_head.bias.detach()[0]) == 0.5
    assert float(model.count_head.bias.detach()[0]) == 0.25
    same = JointCNN(64, rng=generator_for(0, "init"))
    assert torch.equal(same.convs[0].weight, model.convs[0].weight)
