"""Age estimation (IMDB-WIKI): the SR-GAN and, with ``dnn_only``, the
supervised DNN baseline.

The port of ``srgan_tpu.apps.age.AgeExperiment``: conv regressors for D
and the DNN, a DCGAN generator, the base experiment's batches and
metrics, and G samples at each validation.
"""

from __future__ import annotations

from srgan_tpu_torch.apps.common import (setup_image_models,
                                         write_generated_sample_grid)
from srgan_tpu_torch.data.age import age_datasets
from srgan_tpu_torch.experiment import Experiment
from srgan_tpu_torch.train import ModelBundle


class AgeExperiment(Experiment):
    """SR-GAN (or DNN-only) age regression from face images."""

    def dataset_setup(self) -> None:
        (self.labeled_dataset, self.unlabeled_dataset,
         self.validation_dataset,
         self.test_dataset) = age_datasets(self.settings)

    def model_setup(self) -> ModelBundle:
        return setup_image_models(self.settings,
                                  self.settings.age_image_size,
                                  device=self.device)

    def validation_summaries(self, epoch: int, step: int) -> None:
        super().validation_summaries(epoch, step)
        write_generated_sample_grid(self, epoch, step)
