"""Crowd counting: SR-GAN over random patches of a device-resident
database.

The port of ``srgan_tpu.apps.crowd.CrowdExperiment`` on its resident
single-device path. The whole training split lives on the device (images
as uint8); every step draws random (index, offset, flip) triples on the
host, with the same NumPy stream as the JAX package, and the patch kernel
(``srgan_tpu_torch/ops/patches.py``) cuts the normalized image and
density patches on the device. Image and density patches share offsets
and flips, so augmentation stays label-consistent.

Not ported yet: grid evaluation and validation, the host and window
tiers, dataset sharding, the rescale sampler, kNN/iKNN targets and the
deeper crowd models.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from srgan_tpu_torch.data.crowd import CrowdDatabase, synthetic_crowd_database
from srgan_tpu_torch.experiment import Experiment
from srgan_tpu_torch.models.crowd import CrowdDCGenerator, JointCNN
from srgan_tpu_torch.ops.patches import extract_patches
from srgan_tpu_torch.train import ModelBundle
from srgan_tpu_torch.utils.seeding import generator_for

DENSITY_DOWNSAMPLE = 4  # JointCNN heads emit 1/4-resolution maps


def sum_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, H, W] → [B, H/f, W/f] by window summation (mass-preserving)."""
    b, h, w = x.shape
    return x.reshape(b, h // factor, factor,
                     w // factor, factor).sum(dim=(2, 4))


class InputAffine(nn.Module):
    """``model(x * a + b)`` with per-channel (a, b): the 'meanstd' image
    normalization, applied inside D and the DNN so that every input
    stream, the fake one included, shares it."""

    def __init__(self, model: nn.Module, a: np.ndarray, b: np.ndarray):
        super().__init__()
        self.model = model
        self.register_buffer("a", torch.as_tensor(a).view(1, -1, 1, 1))
        self.register_buffer("b", torch.as_tensor(b).view(1, -1, 1, 1))

    def forward(self, x: torch.Tensor):
        return self.model(x * self.a + self.b)


class CrowdExperiment(Experiment):
    """SR-GAN crowd counting with the on-device patch pipeline."""

    def __init__(self, settings, device=None):
        super().__init__(settings, device)
        self.labeled_db: Optional[CrowdDatabase] = None
        self.unlabeled_db: Optional[CrowdDatabase] = None
        self.validation_db: Optional[CrowdDatabase] = None
        self.test_db: Optional[CrowdDatabase] = None
        self._device_data = None
        self._labeled_index_bound = 0
        self._unlabeled_index_bound = 0

    # ------------------------------------------------------------ datasets
    def _load_databases(self) -> Tuple[CrowdDatabase, CrowdDatabase,
                                       CrowdDatabase,
                                       Optional[CrowdDatabase]]:
        """(labeled, unlabeled, validation, test-or-None)."""
        settings = self.settings
        if settings.crowd_database_path:
            root = settings.crowd_database_path
            test_path = os.path.join(root, "test.npz")
            return (CrowdDatabase.load(os.path.join(root, "labeled.npz")),
                    CrowdDatabase.load(os.path.join(root, "unlabeled.npz")),
                    CrowdDatabase.load(os.path.join(root, "validation.npz")),
                    CrowdDatabase.load(test_path)
                    if os.path.exists(test_path) else None)
        # Hermetic fallback: procedural data (no real database on disk).
        h, w = settings.crowd_image_height, settings.crowd_image_width
        make = functools.partial(
            synthetic_crowd_database, height=h, width=w,
            max_heads=settings.crowd_synthetic_max_heads,
            sigma=settings.crowd_sigma,
            label_type=settings.crowd_label_type)
        return (make(settings.labeled_dataset_size, seed=settings.seed),
                make(settings.unlabeled_dataset_size,
                     seed=settings.seed + 1),
                make(settings.validation_dataset_size,
                     seed=settings.seed + 2),
                make(settings.test_dataset_size, seed=settings.seed + 3))

    def dataset_setup(self) -> None:
        label_type = self.settings.crowd_label_type
        if label_type != "density":
            raise NotImplementedError(
                f"crowd_label_type={label_type!r}: kNN/iKNN targets are "
                f"not ported yet; use 'density'")
        (self.labeled_db, self.unlabeled_db, self.validation_db,
         self.test_db) = self._load_databases()
        self.labeled_dataset = self.labeled_db
        self.unlabeled_dataset = self.unlabeled_db

    @property
    def _label_dtype(self) -> torch.dtype:
        """Device dtype of the training label maps; the patch kernel
        upcasts to float32."""
        name = self.settings.crowd_label_dtype
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"unknown crowd_label_dtype {name!r}; "
                             f"choose float32 or bfloat16")
        return getattr(torch, name)

    def _upload_databases(self) -> None:
        """Place the training splits on the device once: images as uint8
        (raw 0..255), density labels [N, H, W, 1] in ``_label_dtype``."""
        device = self.device
        self._labeled_index_bound = len(self.labeled_db)
        self._unlabeled_index_bound = len(self.unlabeled_db)
        labels = torch.from_numpy(self.labeled_db.density_maps[..., None])
        self._device_data = {
            "labeled_images": torch.from_numpy(
                self.labeled_db.images).to(device),
            "labeled_density": labels.to(device).to(self._label_dtype),
            "unlabeled_images": torch.from_numpy(
                self.unlabeled_db.images).to(device),
        }

    # -------------------------------------------------------------- models
    def model_setup(self) -> ModelBundle:
        settings = self.settings
        dtype = getattr(torch, settings.compute_dtype)
        w = settings.model_base_width
        # Dataset-mean per-cell head biases: with zero-init kernels the
        # step-0 prediction is the dataset-mean map and count. The density
        # head regresses sum_pool(density, 4), i.e. 16 × the mean pixel.
        if settings.zero_init_heads:
            cell = DENSITY_DOWNSAMPLE ** 2
            mean_px = (float(np.mean(self.labeled_db.density_maps))
                       if self.labeled_db is not None else 0.0)
            head_init = dict(zero_init_heads=True,
                             density_head_bias=mean_px * cell,
                             count_head_bias=mean_px * cell)
        else:
            head_init = dict(zero_init_heads=False)
        # Init draws on the host, so a seed gives the same weights on
        # every device.
        rng = generator_for(settings.seed, "init")
        impl = settings.norm_impl
        d = JointCNN(w, dtype=dtype, norm_impl=impl, rng=rng, **head_init)
        g = CrowdDCGenerator(image_size=settings.image_patch_size,
                             base_width=w,
                             latent_dimension=settings.latent_dimension,
                             dtype=dtype, norm_impl=impl, rng=rng)
        dnn = JointCNN(w, dtype=dtype, norm_impl=impl,
                       use_norm=settings.dnn_use_norm, rng=rng, **head_init)
        transform = self._input_normalization_transform()
        if transform is not None:
            d, dnn = InputAffine(d, *transform), InputAffine(dnn, *transform)
        place = functools.partial(nn.Module.to, device=self.device,
                                  memory_format=torch.channels_last)
        return ModelBundle(d=place(d), g=place(g), dnn=place(dnn))

    def _input_normalization_transform(self):
        """Per-channel affine ``(a, b)`` for D/DNN inputs, or None for the
        default '[-1,1]' space. With pixels p in [0,1] and x = 2p − 1,
        ``(p − m)/s = x · (0.5/s) + (0.5 − m)/s``."""
        mode = self.settings.image_normalization
        if mode == "[-1,1]":
            return None
        if mode != "meanstd":
            raise ValueError(
                f"unknown image_normalization {mode!r}; choose "
                f"'[-1,1]' or 'meanstd'")
        if self.labeled_db is None:
            raise ValueError(
                "image_normalization='meanstd' needs the dataset loaded "
                "before model_setup (run dataset_setup first)")
        mean, std = self.labeled_db.image_statistics()
        return ((0.5 / std).astype(np.float32),
                ((0.5 - mean) / std).astype(np.float32))

    # --------------------------------------------------------------- loss
    def labeled_loss_fn(self):
        """Joint density-map + count loss. predictions: (density_map,
        count_map), each [B, P/4, P/4]; labels: density patches [B, P, P]."""
        settings = self.settings

        def loss_fn(predictions, labels):
            density_map, count_map = predictions
            map_target = sum_pool(labels, DENSITY_DOWNSAMPLE)
            map_loss = (density_map - map_target).square().mean()
            true_count = labels.sum(dim=(1, 2))
            pred_count = count_map.sum(dim=(1, 2))
            count_loss = (pred_count - true_count).square().mean()
            return (map_loss * settings.density_loss_multiplier
                    + count_loss * settings.count_loss_multiplier)

        return loss_fn

    # ------------------------------------------------------ batch pipeline
    def prepare_train_step(self) -> None:
        super().prepare_train_step()
        self._upload_databases()

    def _to_device(self, *arrays: np.ndarray):
        """One host→device copy for all of a step's small int32 arrays,
        from pinned memory so that it does not wait for the device."""
        flat = torch.from_numpy(np.concatenate(
            [a.ravel() for a in arrays]).astype(np.int32))
        if self.device.type == "cuda":
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        parts = torch.split(flat, [a.size for a in arrays])
        return [t.view(a.shape) for t, a in zip(parts, arrays)]

    def _sample_batch(self, labeled_images, labeled_density,
                      unlabeled_images, idx, offs, flips, uidx, uoffs,
                      uflips):
        """Three patch-kernel calls: labeled images and their density
        labels (same windows), and unlabeled images. Returns NCHW image
        patches (channels_last memory) and [B, P, P] labels."""
        p = self.settings.image_patch_size
        idx, offs, flips, uidx, uoffs, uflips = self._to_device(
            idx, offs, flips, uidx, uoffs, uflips)
        patches = extract_patches(
            labeled_images, offs, flips, patch_size=p,
            scale=2.0 / 255.0, shift=-1.0, indices=idx)
        labels = extract_patches(
            labeled_density, offs, flips, patch_size=p, indices=idx)
        upatches = extract_patches(
            unlabeled_images, uoffs, uflips, patch_size=p,
            scale=2.0 / 255.0, shift=-1.0, indices=uidx)
        return (patches.permute(0, 3, 1, 2), labels[..., 0],
                upatches.permute(0, 3, 1, 2))

    def _random_patch_args(self, rng: np.random.Generator, n_images: int,
                           image_hw: Tuple[int, int], batch: int):
        """Sample ``(index, offset, flip)`` per example: the draws of the
        JAX package's sampler with rescaling off."""
        h, w = image_hw
        p = self.settings.image_patch_size
        idx = rng.integers(0, n_images, batch).astype(np.int32)
        offs = np.stack([rng.integers(0, h - p + 1, batch),
                         rng.integers(0, w - p + 1, batch)],
                        axis=-1).astype(np.int32)
        flips = rng.integers(0, 2, batch).astype(np.int32)
        return idx, offs, flips

    def _patch_args_stream(self):
        """Endless per-step host draws: labeled then unlabeled
        ``(idx, offs, flips)`` for each step."""
        settings = self.settings
        rng = np.random.default_rng([settings.seed, 1, self._start_step])
        batch = settings.batch_size
        hw = self.labeled_db.image_size
        uhw = self.unlabeled_db.image_size
        n_lab, n_unl = self._labeled_index_bound, self._unlabeled_index_bound
        while True:
            yield (self._random_patch_args(rng, n_lab, hw, batch)
                   + self._random_patch_args(rng, n_unl, uhw, batch))

    def epoch_batch_iterators(self):
        data = self._device_data
        args = self._patch_args_stream()
        steps = self.steps_per_epoch()

        def one_epoch():
            for _ in range(steps):
                yield self._sample_batch(
                    data["labeled_images"], data["labeled_density"],
                    data["unlabeled_images"], *next(args))

        while True:
            yield one_epoch()
