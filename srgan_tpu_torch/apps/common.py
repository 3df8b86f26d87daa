"""Scaffolding shared by the image apps: generated-sample summaries.

The port of ``srgan_tpu.apps.common.write_generated_sample_grid``.
"""

from __future__ import annotations

import torch

from srgan_tpu_torch.utils.seeding import generator_for


def write_generated_sample_grid(experiment, epoch: int, step: int,
                                count: int = 4) -> None:
    """``count`` G samples as image summaries of the GAN writer.

    z is drawn on the host from the ``(seed + epoch, "samples")`` stream,
    so a seed gives the same samples on every device. ``jax.random``'s
    numbers cannot be reproduced, so the images differ from the JAX
    package's. Frame-stacked images render their last 3 channels.
    """
    if experiment.settings.dnn_only:
        return
    rng = generator_for(experiment.settings.seed + epoch, "samples")
    z = torch.randn((count, experiment.settings.latent_dimension),
                    generator=rng).to(experiment.device)
    with torch.inference_mode():
        fakes = experiment.state.g(z).float().permute(0, 2, 3, 1).cpu()
    for i, image in enumerate(fakes.numpy()):
        experiment.gan_summary_writer.add_image(
            f"generated/sample_{i}", image[..., -3:], step)
