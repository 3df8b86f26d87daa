"""Steering-angle regression from dash-cam frame stacks.

The port of ``srgan_tpu.apps.driving.DrivingExperiment``: the age app's
models over ``3 · driving_frame_stack`` channels; G samples render the
latest frame.
"""

from __future__ import annotations

from srgan_tpu_torch.apps.common import (setup_image_models,
                                         write_generated_sample_grid)
from srgan_tpu_torch.data.driving import driving_datasets
from srgan_tpu_torch.experiment import Experiment
from srgan_tpu_torch.train import ModelBundle


class DrivingExperiment(Experiment):
    """SR-GAN steering-angle regression from frame stacks."""

    def dataset_setup(self) -> None:
        (self.labeled_dataset, self.unlabeled_dataset,
         self.validation_dataset,
         self.test_dataset) = driving_datasets(self.settings)

    def model_setup(self) -> ModelBundle:
        return setup_image_models(
            self.settings, self.settings.resolved_driving_image_size,
            channels=3 * self.settings.driving_frame_stack,
            device=self.device)

    def validation_summaries(self, epoch: int, step: int) -> None:
        super().validation_summaries(epoch, step)
        write_generated_sample_grid(self, epoch, step)
