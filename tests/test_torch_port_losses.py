"""The port's loss stack against ``srgan_tpu.losses`` on the same inputs,
including the gradient penalty's input gradients and its gradients with
respect to the parameters (the double backward). float32 on both sides,
rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu import losses as jl
from srgan_tpu_torch import losses as tl

B, F, D = 6, 12, 20
RTOL = 1e-5


def _np(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(ours, theirs, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(ours.detach()), np.asarray(theirs),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("order", [1.0, 2.0, 3.0])
def test_labeled_loss(order):
    p, y = _np(0, B, 4, 4), _np(1, B, 4, 4)
    _close(tl.labeled_loss(torch.from_numpy(p), torch.from_numpy(y), order),
           jl.labeled_loss(jnp.asarray(p), jnp.asarray(y), order))


@pytest.mark.parametrize("order", [1.0, 2.0, 1.5])
def test_feature_streams(order):
    a, b = _np(2, B, F), _np(3, B, F) + 0.3
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), \
        jnp.asarray(a), jnp.asarray(b)
    _close(tl.unlabeled_loss(ta, tb, 0.7, order),
           jl.unlabeled_loss(ja, jb, 0.7, order))
    _close(tl.generator_loss(ta, tb, order), jl.generator_loss(ja, jb, order))
    for scale in ("log", "linear"):
        _close(tl.fake_loss(ta, tb, 1.3, order, scale),
               jl.fake_loss(ja, jb, 1.3, order, scale))
    with pytest.raises(ValueError, match="contrasting"):
        tl.contrasting_scale_fn("cubic")


def _torch_d(x, w):
    return torch.tanh(x.reshape(x.shape[0], -1) @ w)


def _jax_d(x, w):
    return jnp.tanh(x.reshape(x.shape[0], -1) @ w)


def test_gradient_penalty_input_and_parameter_gradients():
    u, f, w = _np(4, B, 2, 2, 5), _np(5, B, 2, 2, 5), _np(6, D, F) * 0.3
    alpha = np.random.default_rng(7).uniform(0, 1, B).astype(np.float32)
    f_u = _np(8, B, F)

    def jax_gp(w):
        interp = jl.interpolate_inputs(jnp.asarray(alpha), jnp.asarray(u),
                                       jnp.asarray(f))
        grads = jax.grad(lambda x: jl.fake_loss(
            jnp.asarray(f_u), _jax_d(x, w), 1.0, 1.0, "log"))(interp)
        return jl.gradient_penalty(grads, 10.0), grads

    (j_gp, j_in_grads), j_w_grad = jax.value_and_grad(
        jax_gp, has_aux=True)(jnp.asarray(w))

    tw = torch.from_numpy(w).requires_grad_(True)
    interp = tl.interpolate_inputs(torch.from_numpy(alpha),
                                   torch.from_numpy(u), torch.from_numpy(f))
    interp.requires_grad_(True)
    loss = tl.fake_loss(torch.from_numpy(f_u), _torch_d(interp, tw), 1.0,
                        1.0, "log")
    (t_in_grads,) = torch.autograd.grad(loss, interp, create_graph=True)
    t_gp = tl.gradient_penalty(t_in_grads, 10.0)
    (t_w_grad,) = torch.autograd.grad(t_gp, tw)

    _close(interp, tl.interpolate_inputs(torch.from_numpy(alpha),
                                         torch.from_numpy(u),
                                         torch.from_numpy(f)))
    _close(t_in_grads, j_in_grads)
    _close(t_gp, j_gp)
    _close(t_w_grad, j_w_grad, atol=1e-6 * float(np.abs(j_w_grad).max()))
    _close(tl.per_example_gradient_norm(t_in_grads),
           jl.per_example_gradient_norm(j_in_grads))
