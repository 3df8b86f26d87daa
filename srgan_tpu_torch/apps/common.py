"""Scaffolding shared by the image apps: the models of the age and
driving apps and the generated-sample summaries.

The port of ``srgan_tpu.apps.common`` (``setup_image_models`` and
``write_generated_sample_grid``).
"""

from __future__ import annotations

import torch
from torch import nn

from srgan_tpu_torch.models.dcgan import ConvRegressor, DCGANGenerator
from srgan_tpu_torch.train import ModelBundle
from srgan_tpu_torch.utils.seeding import generator_for


def setup_image_models(settings, image_size: int, channels: int = 3, *,
                       device) -> ModelBundle:
    """D and the DNN as ``ConvRegressor(base_width=w, feature_size=16·w)``
    and G as ``DCGANGenerator(image_size, channels)``, all under
    ``settings.norm_impl``, on ``device`` in ``channels_last`` memory.
    Init draws on the host from the ``(seed, "init")`` stream (D, G, DNN
    in turn), so a seed gives the same weights on every device."""
    if settings.image_normalization != "[-1,1]":
        # The age/driving databases are stored [-1, 1]-normalized;
        # 'meanstd' is a crowd-app feature.
        raise ValueError(
            f"image_normalization={settings.image_normalization!r} is "
            f"supported by the crowd app only; age/driving databases "
            f"are stored [-1,1]-normalized")
    dtype = getattr(torch, settings.compute_dtype)
    width = settings.model_base_width
    rng = generator_for(settings.seed, "init")

    def regressor():
        return ConvRegressor(image_size, channels, base_width=width,
                             feature_size=16 * width, dtype=dtype,
                             norm_impl=settings.norm_impl, rng=rng)

    d = regressor()
    g = DCGANGenerator(image_size=image_size, channels=channels,
                       base_width=width,
                       latent_dimension=settings.latent_dimension,
                       dtype=dtype, norm_impl=settings.norm_impl, rng=rng)
    dnn = regressor()
    return ModelBundle(*(nn.Module.to(m, device=device,
                                      memory_format=torch.channels_last)
                         for m in (d, g, dnn)))


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
