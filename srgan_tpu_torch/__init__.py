"""srgan_tpu_torch — the SR-GAN framework of ``srgan_tpu`` ported to
PyTorch and CUDA, for one NVIDIA H100.

The same public surface as the JAX package: construct a
:class:`~srgan_tpu_torch.settings.Settings`, construct an application
experiment (``CoefficientExperiment``, ``AgeExperiment``,
``CrowdExperiment`` or ``DrivingExperiment`` of
:mod:`srgan_tpu_torch.apps`), call ``.train()``. The package imports
PyTorch and never JAX; the tests hold it against the JAX package on the
same weights and inputs.
"""

from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.apps.age import AgeExperiment
from srgan_tpu_torch.apps.coefficient import CoefficientExperiment
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.apps.driving import DrivingExperiment

__all__ = ["Settings", "AgeExperiment", "CoefficientExperiment",
           "CrowdExperiment", "DrivingExperiment"]
