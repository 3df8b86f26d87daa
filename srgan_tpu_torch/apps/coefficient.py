"""The polynomial-coefficient toy app: SR-GAN on the synthetic
coefficient data with the MLP D, G and DNN.

The port of ``srgan_tpu.apps.coefficient.CoefficientExperiment``; its
batches, validation and evaluation are the base experiment's.
"""

from __future__ import annotations

import torch

from srgan_tpu_torch.data.coefficient import (OBSERVATION_COUNT,
                                              coefficient_datasets)
from srgan_tpu_torch.experiment import Experiment
from srgan_tpu_torch.models.mlp import CoefficientGenerator, CoefficientMLP
from srgan_tpu_torch.train import ModelBundle
from srgan_tpu_torch.utils.seeding import generator_for


class CoefficientExperiment(Experiment):
    """SR-GAN on the polynomial-coefficient toy task."""

    def dataset_setup(self) -> None:
        (self.labeled_dataset, self.unlabeled_dataset,
         self.validation_dataset,
         self.test_dataset) = coefficient_datasets(self.settings)

    def model_setup(self) -> ModelBundle:
        """D, G and the DNN, drawn in turn from the ``(seed, "init")``
        stream on the host, then placed on the device."""
        settings = self.settings
        dtype = getattr(torch, settings.compute_dtype)
        rng = generator_for(settings.seed, "init")
        hidden = settings.hidden_size
        d = CoefficientMLP(OBSERVATION_COUNT, hidden, dtype=dtype, rng=rng)
        g = CoefficientGenerator(settings.latent_dimension, OBSERVATION_COUNT,
                                 hidden, dtype=dtype, rng=rng)
        dnn = CoefficientMLP(OBSERVATION_COUNT, hidden, dtype=dtype, rng=rng)
        return ModelBundle(*(m.to(self.device) for m in (d, g, dnn)))
