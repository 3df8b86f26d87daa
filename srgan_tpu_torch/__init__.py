"""srgan_tpu_torch — the SR-GAN framework of ``srgan_tpu`` ported to
PyTorch and CUDA, for one NVIDIA H100.

The same public surface as the JAX package: construct a
:class:`~srgan_tpu_torch.settings.Settings`, construct an application
experiment (:class:`~srgan_tpu_torch.apps.crowd.CrowdExperiment`), call
``.train()``. The package imports PyTorch and never JAX; the tests hold
it against the JAX package on the same weights and inputs.
"""

from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.apps.crowd import CrowdExperiment

__all__ = ["Settings", "CrowdExperiment"]
