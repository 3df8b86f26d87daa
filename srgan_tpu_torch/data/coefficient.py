"""Synthetic polynomial-coefficient data (the toy configuration).

The port of ``srgan_tpu.data.coefficient``, NumPy as in JAX: one seed
gives both packages the same arrays. A coefficient a is drawn from
N(0, 1) (the unlabeled population from an equal mixture of N(±offset, 1)
when ``mean_offset`` is not 0); its example is the ten noisy
observations o_i = a·x_i³ + x_i² − a·x_i + ε_i, ε ~ N(0, 0.1), at x_i
evenly spaced in [−1, 1]; the label is a.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from srgan_tpu_torch.data.core import ArrayDataset
from srgan_tpu_torch.utils.mixture import MixtureModel

OBSERVATION_COUNT = 10
NOISE_SCALE = 0.1


def generate_coefficient_examples(
        count: int, rng: np.random.Generator,
        mean_offset: float = 0.0,
        observation_count: int = OBSERVATION_COUNT
) -> Tuple[np.ndarray, np.ndarray]:
    """(observations [count, observation_count], coefficients [count]),
    float32."""
    if mean_offset == 0.0:
        coefficients = rng.standard_normal(count)
    else:
        from scipy.stats import norm

        mixture = MixtureModel([norm(-mean_offset, 1), norm(mean_offset, 1)])
        coefficients = mixture.rvs(count, random_state=rng)
    x = np.linspace(-1.0, 1.0, observation_count)
    clean = (coefficients[:, None] * x[None, :] ** 3
             + x[None, :] ** 2
             - coefficients[:, None] * x[None, :])
    observations = clean + rng.normal(0.0, NOISE_SCALE,
                                      size=(count, observation_count))
    return (observations.astype(np.float32),
            coefficients.astype(np.float32))


def coefficient_datasets(settings) -> Tuple[ArrayDataset, ArrayDataset,
                                            ArrayDataset, ArrayDataset]:
    """(labeled, unlabeled, validation, test) from one generator seeded
    with ``settings.seed``; only the unlabeled population is offset."""
    rng = np.random.default_rng(settings.seed)
    lab_x, lab_y = generate_coefficient_examples(
        settings.labeled_dataset_size, rng)
    unl_x, _ = generate_coefficient_examples(
        settings.unlabeled_dataset_size, rng,
        mean_offset=settings.mean_offset)
    val_x, val_y = generate_coefficient_examples(
        settings.validation_dataset_size, rng)
    test_x, test_y = generate_coefficient_examples(
        settings.test_dataset_size, rng)
    return (ArrayDataset(lab_x, lab_y), ArrayDataset(unl_x),
            ArrayDataset(val_x, val_y), ArrayDataset(test_x, test_y))
