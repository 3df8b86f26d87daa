"""Mixture-of-distributions sampling: the port of
``srgan_tpu.utils.mixture``.

* :class:`MixtureModel` — the host-side mixture of scipy distributions
  (the coefficient app's offset populations), NumPy as in JAX, so that
  one NumPy generator gives both packages the same draws.
* :func:`sample_offset_normal` — the latent z draws of the train step,
  on a ``torch.Generator``'s device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class MixtureModel:
    """Equal-weight (or weighted) mixture of scipy frozen distributions:
    ``MixtureModel([norm(-offset, 1), norm(offset, 1)]).rvs(shape, rng)``."""

    def __init__(self, submodels: Sequence, weights: Sequence[float] = None):
        self.submodels = list(submodels)
        n = len(self.submodels)
        if weights is None:
            weights = [1.0 / n] * n
        total = float(sum(weights))
        self.weights = [w / total for w in weights]

    def rvs(self, size, random_state: np.random.Generator = None
            ) -> np.ndarray:
        rng = random_state or np.random.default_rng()
        size = tuple(np.atleast_1d(size))
        choices = rng.choice(len(self.submodels), size=size, p=self.weights)
        out = np.empty(size, dtype=np.float64)
        for idx, sub in enumerate(self.submodels):
            mask = choices == idx
            count = int(mask.sum())
            if count:
                out[mask] = sub.rvs(size=count, random_state=rng)
        return out

    def pdf(self, x) -> np.ndarray:
        return sum(w * m.pdf(x) for w, m in zip(self.weights, self.submodels))


def sample_offset_normal(generator: torch.Generator, shape, mean_offset: float,
                         dtype=torch.float32) -> torch.Tensor:
    """z ~ equal mixture of N(−offset·1, I) and N(+offset·1, I), per example.

    Drawn on the generator's device. Offset 0 reduces exactly to N(0, I);
    the component choice is per example (axis 0).
    """
    device = generator.device
    z = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    if mean_offset == 0.0:
        return z
    sign_shape = (shape[0],) + (1,) * (len(shape) - 1)
    sign = torch.randint(0, 2, sign_shape, generator=generator,
                         device=device).to(dtype) * 2 - 1
    return z + sign * mean_offset
