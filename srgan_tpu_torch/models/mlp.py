"""The coefficient app's MLPs: the port of ``srgan_tpu.models.mlp``.

Built from the port's flax-semantics :class:`~srgan_tpu_torch.models.
dcgan.Dense` (LeCun-normal init from an explicit generator, the compute
dtype of ``dtype``), with flax's ``leaky_relu`` slope of 0.01. The
regressor returns ``(prediction, features)``, both float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from srgan_tpu_torch.models.dcgan import Dense, gather_channels

_SLOPE = 0.01  # flax.linen.leaky_relu's default


def _layers(sizes, dtype, rng) -> nn.ModuleList:
    """Dense layers ``sizes[i] → sizes[i + 1]``: flax's ``Dense_i``."""
    return nn.ModuleList(Dense(a, b, dtype=dtype, rng=rng)
                         for a, b in zip(sizes, sizes[1:]))


class CoefficientGenerator(nn.Module):
    """z → ``observation_count`` observations: two hidden layers."""

    def __init__(self, latent_dimension: int = 10,
                 observation_count: int = 10, hidden_size: int = 10, *,
                 dtype: torch.dtype = torch.float32, rng: torch.Generator):
        super().__init__()
        self.observation_count = observation_count
        self.layers = _layers((latent_dimension, hidden_size, hidden_size,
                               observation_count), dtype, rng)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for layer in self.layers[:-1]:
            x = F.leaky_relu(layer(x), _SLOPE)
        return gather_channels(self, self.layers[-1](x),
                               self.observation_count, dim=-1).float()


class CoefficientMLP(nn.Module):
    """Observations → (coefficient estimate, features): the features are
    the second hidden layer's activations. The estimate is squeezed to
    [B] when ``output_size`` is 1."""

    def __init__(self, observation_count: int = 10, hidden_size: int = 10,
                 output_size: int = 1, *,
                 dtype: torch.dtype = torch.float32, rng: torch.Generator):
        super().__init__()
        self.output_size = output_size
        self.hidden_size = hidden_size
        self.layers = _layers((observation_count, hidden_size, hidden_size,
                               output_size), dtype, rng)

    def forward(self, observations: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = observations
        for layer in self.layers[:-1]:
            x = F.leaky_relu(layer(x), _SLOPE)
        x = gather_channels(self, x, self.hidden_size, dim=-1)
        prediction = gather_channels(self, self.layers[-1](x),
                                     self.output_size, dim=-1)
        if self.output_size == 1:
            prediction = prediction.squeeze(-1)
        return prediction.float(), x.float()
