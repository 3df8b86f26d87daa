"""The SR-GAN training step.

The port of ``srgan_tpu.train``: ``make_optimizer``, ``init_train_state``,
``make_gan_train_step`` and ``make_dnn_train_step`` (the supervised-only
step of ``Settings.dnn_only``). One SR-GAN step runs, in this order:

1. the D update: labeled, unlabeled and fake streams through one D
   forward over the concatenated 3B batch, plus the gradient penalty at
   unlabeled↔fake interpolates (a double backward);
2. the G update, against the UPDATED D;
3. the update of the supervised DNN baseline on the same labeled batch.

Each model's gradient is taken with ``torch.autograd.grad`` over its own
parameters, so no stray gradients collect in another model's ``.grad``;
then its Adam takes a step. Each model's forward, gradient and update
run under a timed span of ``utils/trace.py`` (``step.d.forward``,
holding the penalty's input gradient ``step.d.penalty_grad``,
``step.d.backward``, ``step.d.adam``; the same three for ``g`` and
``dnn``). PyTorch runs
eagerly: the step updates the modules and optimizers of the state in
place, where the JAX step returns a new state.

Under data parallelism (``dp``) each rank holds its share of the global
batch and the losses are the global batch's (``losses``): replicated on
every rank, differentiated through sum all-reduces whose backward sums
again. A rank's gradient is then W times its share of the true one, at
every order: the parameters' gradients are averaged over the ranks
(before the global-norm clip, as JAX clips the global gradient), and the
penalty's inner input gradient is taken with a cotangent of 1/W, so that
its norm is the example's true gradient norm. z_d, α and z_g are drawn
for the global batch from the same generator on every rank, each rank
taking its rows: a W-rank run consumes the one-rank run's draws.

Under tensor parallelism (a ``dp`` with a model axis, ``parallel/tp.py``)
W counts the data ranks; the models are sharded over the model ranks
of each data rank, which take the same batch and draws. Their layers
place the model axis's collectives themselves, D's first layer included,
so the penalty's input gradient is already summed over the model ranks
when it reaches the loss. Gradients are averaged over the data ranks
only: a sharded parameter's gradient is its block of the whole one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from srgan_tpu_torch import losses
from srgan_tpu_torch.parallel import tp
from srgan_tpu_torch.parallel.mesh import (DataParallel, average_gradients,
                                           broadcast_module)
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.utils.mixture import sample_offset_normal
from srgan_tpu_torch.utils.trace import span

Tensor = torch.Tensor


def set_float32_precision() -> None:
    """float32 means float32 on the card: TF32 off for matmuls AND for
    cuDNN convolutions (whose default is on). The float32 configuration
    is the one held to the JAX package; the bfloat16 flagship does not
    use TF32 either way."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class ModelBundle:
    """The three models of one SR-GAN trial.

    * ``d(x) -> (prediction, features)`` — the discriminator
    * ``g(z) -> fake_examples``
    * ``dnn(x) -> (prediction, features)`` — the supervised baseline
    """
    d: nn.Module
    g: nn.Module
    dnn: Optional[nn.Module] = None


@dataclasses.dataclass
class SRGANTrainState:
    """All learnable state of a trial: the models and their optimizers."""
    step: int
    d: nn.Module
    d_opt: Optimizer
    g: nn.Module
    g_opt: Optimizer
    dnn: Optional[nn.Module] = None
    dnn_opt: Optional[Optimizer] = None


class Optimizer:
    """Adam (AdamW when decayed) after optional global-norm clipping.

    optax's ``clip_by_global_norm`` scales the gradients by
    ``max_norm / norm`` when ``norm > max_norm``, with no ε, which is what
    :meth:`step` does (``clip_grad_norm_`` would divide by norm + 1e-6).
    Under ``dp`` the gradients are first averaged over the data ranks;
    with a model axis the global norm counts each replicated gradient
    once and sums the sharded ones' squares over the model ranks.

    On a card with ``steps_per_dispatch`` > 1 Adam is ``capturable``: its
    step counts and bias corrections live on the card, so that a CUDA
    graph of K steps (``utils/cuda_graph.py``) replays them. Everywhere
    else it is the default Adam, whose step counts live on the host.
    """

    def __init__(self, settings: Settings, params: List[nn.Parameter],
                 weight_decay: bool, dp: Optional[DataParallel] = None):
        self.params = params
        self.dp = dp
        self.sharded = [tp.shard_of(p) is not None for p in params]
        self.clip_norm = settings.gradient_clip_norm
        self.capturable = (settings.steps_per_dispatch > 1
                           and params[0].device.type == "cuda")
        kwargs = dict(lr=settings.learning_rate,
                      betas=(settings.adam_b1, settings.adam_b2), eps=1e-8,
                      capturable=self.capturable)
        if weight_decay and settings.weight_decay > 0.0:
            self.adam = torch.optim.AdamW(
                params, weight_decay=settings.weight_decay, **kwargs)
        else:
            self.adam = torch.optim.Adam(params, weight_decay=0.0, **kwargs)

    def set_learning_rate(self, lr: float) -> None:
        """The learning rate of the next steps. AdamW's decoupled decay
        is scaled by it, as optax's ``adamw`` scales it."""
        for group in self.adam.param_groups:
            group["lr"] = lr

    def step(self, grads: Tuple[Tensor, ...]) -> None:
        if self.dp is not None:
            grads = average_gradients(grads, self.dp)
        if self.clip_norm > 0.0:
            norm = torch.sqrt(self._squared_norm(grads))
            factor = torch.where(norm < self.clip_norm,
                                 torch.ones_like(norm),
                                 self.clip_norm / norm)
            grads = tuple(g * factor for g in grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()

    def _squared_norm(self, grads: Tuple[Tensor, ...]) -> Tensor:
        axis = None if self.dp is None else self.dp.model
        if axis is None or not any(self.sharded):
            return sum(g.float().square().sum() for g in grads)
        squares = [g.float().square().sum() for g in grads]
        sharded = torch.stack([s for s, on in zip(squares, self.sharded)
                               if on]).sum()
        dist.all_reduce(sharded, group=axis.group)
        replicated = [s for s, on in zip(squares, self.sharded) if not on]
        return sharded + (sum(replicated) if replicated else 0.0)


def make_optimizer(settings: Settings, params, weight_decay: bool = False,
                   dp: Optional[DataParallel] = None) -> Optimizer:
    """Adam (AdamW when decayed), clipped when ``gradient_clip_norm > 0``.

    ``torch.optim.Adam`` and ``optax.adam`` compute the same update,
    ``lr · m̂ / (√v̂ + ε)`` with ε = 1e-8.
    """
    return Optimizer(settings, list(params), weight_decay, dp)


def init_train_state(settings: Settings, models: ModelBundle,
                     dp: Optional[DataParallel] = None) -> SRGANTrainState:
    """The models and their optimizers; under ``dp`` the models are
    first broadcast from process 0, so that every rank starts alike, and
    with a model axis then sharded (each rank keeping its blocks of
    process 0's full tensors) before their optimizers are made."""
    modules = [m for m in (models.d, models.g, models.dnn) if m is not None]
    if dp is not None:
        for module in modules:
            broadcast_module(module)
            if dp.model is not None:
                tp.shard_module(module, dp.model)
    return SRGANTrainState(
        step=0,
        d=models.d, d_opt=make_optimizer(settings, models.d.parameters(),
                                         weight_decay=True, dp=dp),
        g=models.g, g_opt=make_optimizer(settings, models.g.parameters(),
                                         dp=dp),
        dnn=models.dnn,
        dnn_opt=(make_optimizer(settings, models.dnn.parameters(),
                                weight_decay=True, dp=dp)
                 if models.dnn is not None else None))


def default_labeled_loss_fn(settings: Settings):
    order = settings.labeled_loss_order
    return lambda predictions, labels: losses.labeled_loss(
        predictions, labels, order=order)


HYPER_KEYS = ("unlabeled_loss_multiplier", "fake_loss_multiplier",
              "gradient_penalty_multiplier", "learning_rate")


def _dnn_update(state: SRGANTrainState, labeled_x: Tensor, labels,
                labeled_loss_fn: Callable, dp: Optional[DataParallel],
                update: Callable) -> Tensor:
    """The supervised DNN's forward, gradient and ``update(opt, grads)``,
    each under its span; returns its loss."""
    with span("step.dnn.forward", timed=True):
        pred, _ = state.dnn(labeled_x)
        loss = losses.global_mean(labeled_loss_fn(pred, labels), dp)
    with span("step.dnn.backward", timed=True):
        grads = torch.autograd.grad(loss, state.dnn_opt.params)
    with span("step.dnn.adam", timed=True):
        update(state.dnn_opt, grads)
    return loss


def _slice_predictions(predictions, end: int):
    if isinstance(predictions, (tuple, list)):
        return type(predictions)(p[:end] for p in predictions)
    return predictions[:end]


def make_gan_train_step(
    settings: Settings,
    labeled_loss_fn: Optional[Callable] = None,
    latent_shape: Optional[Tuple[int, ...]] = None,
    dp: Optional[DataParallel] = None,
    hyper: Optional[Dict[str, float]] = None,
) -> Callable[..., Tuple[SRGANTrainState, Dict[str, Tensor]]]:
    """Build the fused (D + G [+ DNN]) step.

    ``step(state, labeled_x, labels, unlabeled_x, rng, z_d=None, z_g=None,
    alpha=None) -> (state, metrics)``. ``rng`` is a ``torch.Generator`` on
    the batch's device; it draws z_d, α and z_g (in that order) unless
    they are given, which is how a test feeds the step the JAX package's
    draws. ``metrics`` holds 0-dim tensors on the device: reading them
    synchronizes, so the training loop reads them only on summary steps.

    Under ``dp`` the batch tensors are this rank's share, the draws
    (drawn or given) are the global batch's, and the metrics are the
    global losses, the same on every rank.

    ``hyper`` overrides the settings' ``unlabeled_loss_multiplier``,
    ``fake_loss_multiplier``, ``gradient_penalty_multiplier`` and
    ``learning_rate``: how ``tools/sweep.py`` trains each lane of its grid
    through this step. The optimizers are built by
    :func:`init_train_state`, so an overridden learning rate is set on
    the state's three optimizers before each of their updates, and stays
    set after the step. A CUDA graph of a chunk (``steps_per_dispatch`` >
    1 on the card, ``utils/cuda_graph.py``) would replay the learning rate
    in force when it was captured, so the step refuses an overridden one
    with a capturable Adam.
    """
    labeled_loss_fn = labeled_loss_fn or default_labeled_loss_fn(settings)
    z_dim = settings.latent_dimension
    period = settings.generator_training_step_period
    h = {k: getattr(settings, k) for k in HYPER_KEYS}
    if hyper:
        unknown = set(hyper) - set(h)
        if unknown:
            raise ValueError(f"unknown hyper overrides {sorted(unknown)}; "
                             f"choose from {sorted(h)}")
        h.update(hyper)
    unl_mult = h["unlabeled_loss_multiplier"]
    fake_mult = h["fake_loss_multiplier"]
    gp_mult = h["gradient_penalty_multiplier"]
    lr = hyper.get("learning_rate") if hyper else None

    def update(opt: Optimizer, grads: Tuple[Tensor, ...]) -> None:
        if lr is not None:
            if opt.capturable:
                raise ValueError(
                    "hyper['learning_rate'] cannot be used with "
                    "steps_per_dispatch > 1 on a CUDA card: a chunk's CUDA "
                    "graph replays the learning rate it captured")
            opt.set_learning_rate(lr)
        opt.step(grads)

    def sample_z(rng: torch.Generator, batch: int) -> Tensor:
        shape = (batch,) + tuple(latent_shape or (z_dim,))
        return sample_offset_normal(rng, shape, settings.mean_offset)

    def contrast(f_u: Tensor, f_other: Tensor) -> Tensor:
        return losses.fake_loss(
            f_u, f_other, multiplier=fake_mult,
            order=settings.fake_loss_order,
            distance_function=settings.contrasting_distance_function, dp=dp)

    def d_streams(d: nn.Module, labeled_x, unlabeled_x, fake):
        """D on the three primal streams: one forward over the 3B batch
        when the streams are of one size (per-example GroupNorm makes it
        the same math), else three."""
        if (settings.fuse_discriminator_streams
                and labeled_x.shape[0] == unlabeled_x.shape[0]
                == fake.shape[0]):
            b = labeled_x.shape[0]
            preds, feats = d(torch.cat([labeled_x, unlabeled_x, fake]))
            return (_slice_predictions(preds, b), feats[:b],
                    feats[b:2 * b], feats[2 * b:])
        pred_l, f_l = d(labeled_x)
        _, f_u = d(unlabeled_x)
        _, f_f = d(fake)
        return pred_l, f_l, f_u, f_f

    def d_loss(state: SRGANTrainState, labeled_x, labels, unlabeled_x,
               z: Tensor, alpha: Tensor):
        with torch.no_grad():
            fake = state.g(z)
        pred_l, f_l, f_u, f_f = d_streams(state.d, labeled_x, unlabeled_x,
                                          fake)
        l_loss = losses.global_mean(labeled_loss_fn(pred_l, labels), dp)
        u_loss = losses.unlabeled_loss(f_l, f_u, multiplier=unl_mult,
                                       order=settings.unlabeled_loss_order,
                                       dp=dp)
        f_loss = contrast(f_u, f_f)
        # Gradient penalty: the contrasting loss at the interpolates,
        # differentiated w.r.t. the interpolated INPUTS with create_graph,
        # so that the penalty itself differentiates w.r.t. D's params.
        interp = losses.interpolate_inputs(alpha, unlabeled_x, fake)
        interp.requires_grad_(True)
        _, f_i = state.d(interp)
        inner = contrast(f_u.detach(), f_i)
        # Under dp the sum all-reduces' backward makes the rank's gradient
        # W times the example's own: a cotangent of 1/W undoes it.
        cotangent = (None if dp is None
                     else torch.full_like(inner, 1.0 / dp.world_size))
        with span("step.d.penalty_grad", timed=True):
            (interp_grads,) = torch.autograd.grad(
                inner, interp, grad_outputs=cotangent, create_graph=True)
        gp = losses.gradient_penalty(interp_grads, multiplier=gp_mult,
                                     dp=dp)
        total = l_loss + u_loss + f_loss + gp
        metrics = {"d_labeled_loss": l_loss, "d_unlabeled_loss": u_loss,
                   "d_fake_loss": f_loss, "d_gradient_penalty": gp,
                   "d_total_loss": total}
        return total, metrics

    def g_loss(state: SRGANTrainState, unlabeled_x, z: Tensor) -> Tensor:
        fake = state.g(z)
        with torch.no_grad():  # stop-gradient target
            _, f_u = state.d(unlabeled_x)
        _, f_f = state.d(fake)
        return losses.generator_loss(f_u, f_f,
                                     order=settings.unlabeled_loss_order,
                                     dp=dp)

    def step(state: SRGANTrainState, labeled_x: Tensor, labels,
             unlabeled_x: Tensor, rng: Optional[torch.Generator] = None,
             z_d: Optional[Tensor] = None, z_g: Optional[Tensor] = None,
             alpha: Optional[Tensor] = None
             ) -> Tuple[SRGANTrainState, Dict[str, Tensor]]:
        batch = unlabeled_x.shape[0] * (1 if dp is None
                                        else dp.world_size)
        if z_d is None:
            z_d = sample_z(rng, batch)
        if alpha is None:
            alpha = torch.rand((batch,), generator=rng, device=rng.device)
        if z_g is None:
            z_g = sample_z(rng, batch)
        if dp is not None:
            share = dp.share(batch)
            z_d, alpha, z_g = z_d[share], alpha[share], z_g[share]

        # ---- D update ----------------------------------------------------
        d_params = state.d_opt.params
        with span("step.d.forward", timed=True):
            total, metrics = d_loss(state, labeled_x, labels, unlabeled_x,
                                    z_d, alpha)
        with span("step.d.backward", timed=True):
            d_grads = torch.autograd.grad(total, d_params)
        del total
        with span("step.d.adam", timed=True):
            update(state.d_opt, d_grads)

        # ---- G update (every `generator_training_step_period` steps) -----
        if period == 1 or state.step % period == 0:
            with span("step.g.forward", timed=True):
                loss = g_loss(state, unlabeled_x, z_g)
            with span("step.g.backward", timed=True):
                g_grads = torch.autograd.grad(loss, state.g_opt.params)
            with span("step.g.adam", timed=True):
                update(state.g_opt, g_grads)
            metrics["g_loss"] = loss.detach()
        else:
            metrics["g_loss"] = torch.zeros((), device=unlabeled_x.device)

        # ---- DNN baseline update -----------------------------------------
        if state.dnn is not None:
            loss = _dnn_update(state, labeled_x, labels, labeled_loss_fn,
                              dp, update)
            metrics["dnn_loss"] = loss.detach()

        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_dnn_train_step(
    settings: Settings,
    labeled_loss_fn: Optional[Callable] = None,
    dp: Optional[DataParallel] = None,
) -> Callable[..., Tuple[SRGANTrainState, Dict[str, Tensor]]]:
    """Build the supervised-only step of ``dnn_only`` trials:
    ``step(state, labeled_x, labels) -> (state, {"dnn_loss": ...})``.
    Only the DNN and its (decayed) optimizer move; D and G stay at their
    init. ``state.step`` advances as in the SR-GAN step. Under ``dp``
    the loss is the global batch's."""
    labeled_loss_fn = labeled_loss_fn or default_labeled_loss_fn(settings)

    def step(state: SRGANTrainState, labeled_x: Tensor, labels
             ) -> Tuple[SRGANTrainState, Dict[str, Tensor]]:
        if state.dnn is None:
            raise ValueError("the DNN-only step needs a DNN in the state")
        loss = _dnn_update(state, labeled_x, labels, labeled_loss_fn, dp,
                          lambda opt, grads: opt.step(grads))
        state.step += 1
        return state, {"dnn_loss": loss.detach()}

    return step
