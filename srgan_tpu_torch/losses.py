"""SR-GAN loss stack, as plain tensor functions.

The port of ``srgan_tpu.losses``: the same streams over explicit feature
tensors.

* labeled:      mean ``|pred − label|^order`` on the labeled batch.
* unlabeled:    feature matching — norm distance between the batch-mean
                D features of the labeled and of the unlabeled batch.
* fake:         feature contrasting — log-scaled NEGATIVE distance that
                pushes the fake batch-mean features away from the
                unlabeled ones.
* gradient penalty: ``mean((‖∇_x interp_loss‖₂ − 1)²) · multiplier`` at
                unlabeled↔fake interpolates; the caller takes the input
                gradient with ``torch.autograd.grad(..., create_graph=True)``.
* generator:    pull the fake batch-mean features toward the unlabeled ones.

Under data parallelism (``dp``, a :class:`~srgan_tpu_torch.parallel.mesh.
DataParallel`) every batch mean is over the GLOBAL batch, as JAX's one
program over a sharded batch takes it: the local sum, all-reduced by
:func:`~srgan_tpu_torch.parallel.mesh.all_reduce_sum`, over the global
count. The loss is then the same on every rank. With ``dp=None`` the
functions are the one-device functions, op for op. Under tensor
parallelism the sums run over the data group (``dp.group``), and the
models hand the losses all features (``models.dcgan.gather_channels``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from srgan_tpu_torch.parallel.mesh import DataParallel, all_reduce_sum

Tensor = torch.Tensor


def batch_mean(x: Tensor, dp: Optional[DataParallel] = None) -> Tensor:
    """Mean over dim 0 (and its trailing dims kept): over the global
    batch under ``dp``."""
    if dp is None:
        return x.mean(dim=0)
    return (all_reduce_sum(x.sum(dim=0), dp.group)
            / (x.shape[0] * dp.world_size))


def global_mean(local_mean: Tensor,
                dp: Optional[DataParallel] = None) -> Tensor:
    """A mean over this rank's share → the mean over the global batch
    (the ranks' shares are equal)."""
    if dp is None:
        return local_mean
    return all_reduce_sum(local_mean, dp.group) / dp.world_size


def mean_features(features: Tensor,
                  dp: Optional[DataParallel] = None) -> Tensor:
    """Batch-mean feature vector: [B, F] → [F] (any trailing dims)."""
    return batch_mean(features.reshape(features.shape[0], -1), dp)


def feature_distance(base_features: Tensor, other_features: Tensor,
                     order: float = 2.0, epsilon: float = 1e-12,
                     dp: Optional[DataParallel] = None) -> Tensor:
    """``(Σ_i |mean(base)_i − mean(other)_i|^order)^(1/order)``;
    ``epsilon`` keeps the fractional-power gradient finite at 0."""
    diff = (mean_features(base_features, dp)
            - mean_features(other_features, dp)).abs()
    if order == 1.0:
        return diff.sum()
    if order == 2.0:
        return torch.sqrt(diff.square().sum() + epsilon)
    return torch.pow(torch.pow(diff + epsilon, order).sum(), 1.0 / order)


def abs_mean(x: Tensor) -> Tensor:
    return x.abs().mean()


def square_mean(x: Tensor) -> Tensor:
    return x.square().mean()


def abs_plus_one_log(x: Tensor) -> Tensor:
    """``log(|x| + 1)``."""
    return torch.log(x.abs() + 1.0)


def abs_plus_one_log_neg(x: Tensor) -> Tensor:
    """``−log(|x| + 1)``: minimizing it pushes distributions apart with a
    gradient that decays as 1/(d+1)."""
    return -abs_plus_one_log(x)


_CONTRASTING_SCALES: dict = {
    "log": abs_plus_one_log_neg,
    "linear": lambda d: -d,
}


def contrasting_scale_fn(name: str) -> Callable[[Tensor], Tensor]:
    try:
        return _CONTRASTING_SCALES[name]
    except KeyError:
        raise ValueError(
            f"unknown contrasting_distance_function {name!r}; "
            f"choose from {sorted(_CONTRASTING_SCALES)}") from None


def labeled_loss(predictions: Tensor, labels: Tensor,
                 order: float = 2.0) -> Tensor:
    """Supervised regression loss: mean |pred − label|^order."""
    err = (predictions.float() - labels.float()).abs()
    if order == 2.0:
        return err.square().mean()
    if order == 1.0:
        return err.mean()
    return torch.pow(err, order).mean()


def unlabeled_loss(labeled_features: Tensor, unlabeled_features: Tensor,
                   multiplier: float = 1.0, order: float = 2.0,
                   dp: Optional[DataParallel] = None) -> Tensor:
    """Feature matching between labeled and unlabeled batch-mean features."""
    return feature_distance(labeled_features, unlabeled_features,
                            order=order, dp=dp) * multiplier


def fake_loss(unlabeled_features: Tensor, fake_features: Tensor,
              multiplier: float = 1.0, order: float = 1.0,
              distance_function: str = "log",
              dp: Optional[DataParallel] = None) -> Tensor:
    """Feature contrasting: scaled NEGATIVE unlabeled↔fake distance."""
    dist = feature_distance(unlabeled_features, fake_features, order=order,
                            dp=dp)
    return contrasting_scale_fn(distance_function)(dist) * multiplier


def generator_loss(unlabeled_features: Tensor, fake_features: Tensor,
                   order: float = 2.0,
                   dp: Optional[DataParallel] = None) -> Tensor:
    """G objective: distance of the fake batch-mean features to the
    unlabeled ones."""
    return feature_distance(unlabeled_features, fake_features, order=order,
                            dp=dp)


def per_example_gradient_norm(gradients: Tensor) -> Tensor:
    """L2 norm of each example's input gradient: [B, ...] → [B]."""
    flat = gradients.reshape(gradients.shape[0], -1).float()
    return torch.sqrt(flat.square().sum(dim=1) + 1e-12)


def gradient_penalty(interpolate_gradients: Tensor,
                     multiplier: float = 10.0,
                     dp: Optional[DataParallel] = None) -> Tensor:
    """WGAN-GP-style penalty ``mean((‖∇‖₂ − 1)²) * multiplier``; each
    row of ``interpolate_gradients`` must be the example's true input
    gradient (under ``dp``, not the rank's W-fold one)."""
    norms = per_example_gradient_norm(interpolate_gradients)
    if dp is None:
        return (norms - 1.0).square().mean() * multiplier
    return batch_mean((norms - 1.0).square(), dp) * multiplier


def interpolate_inputs(alpha: Tensor, unlabeled_examples: Tensor,
                       fake_examples: Tensor) -> Tensor:
    """Per-example convex combination ``α·unlabeled + (1−α)·fake``;
    ``alpha`` is [B], broadcast over the trailing dims."""
    alpha = alpha.reshape((alpha.shape[0],)
                          + (1,) * (unlabeled_examples.dim() - 1))
    return alpha * unlabeled_examples + (1.0 - alpha) * fake_examples
