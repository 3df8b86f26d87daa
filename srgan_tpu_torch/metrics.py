"""Validation metrics: MAE / RMSE / NVE and the crowd-counting NAE.

The port of ``srgan_tpu.metrics``, in float32. ``nve`` divides by the
population standard deviation of the labels (ddof 0, as ``jnp.std``).
"""

from __future__ import annotations

import torch


def _flat(values) -> torch.Tensor:
    return torch.as_tensor(values).to(torch.float32).reshape(-1)


def mae(predictions, labels) -> torch.Tensor:
    return (_flat(predictions) - _flat(labels)).abs().mean()


def rmse(predictions, labels) -> torch.Tensor:
    return (_flat(predictions) - _flat(labels)).square().mean().sqrt()


def nve(predictions, labels, epsilon: float = 1e-8) -> torch.Tensor:
    """Normalized vector error: MAE / std(labels), std with ddof 0."""
    return mae(predictions, labels) / (
        torch.std(_flat(labels), correction=0) + epsilon)


def count_nae(predicted_counts, true_counts, floor: float = 1.0
              ) -> torch.Tensor:
    """mean(|pred − true| / max(true, floor)): the floor keeps an empty
    image from blowing the mean up."""
    p, t = _flat(predicted_counts), _flat(true_counts)
    return ((p - t).abs() / t.clamp(min=floor)).mean()
