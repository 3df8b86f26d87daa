"""The crowd application: a synthetic crowd database made on the device,
put into ``CrowdExperiment`` through ``_load_databases``.

Each image holds ``n ~ U{0..max_heads}`` heads at uniform positions. Its
density map is the sum of one unit-mass Gaussian (σ = ``sigma``) per
head, and its pixels are 40 + 140 × the sum of wider unnormalized
Gaussians (σ = 2.5 ``sigma``) plus N(0, 8) noise per channel, clipped
to 0..255: the recipe of the program's synthetic database, made with
separable Gaussians in a batched product instead of a loop per head.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from benchmark.harness.weights import device_generator
from benchmark.reference import models as ref
from benchmark.reference import sampler
from benchmark.reference.step import Models

CHUNK = 64  # images made at a time


@dataclasses.dataclass
class Split:
    images: np.ndarray        # [N, H, W, 3] uint8
    density: np.ndarray       # [N, H, W] float32
    counts: np.ndarray        # [N] float32


@dataclasses.dataclass
class Data:
    splits: Dict[str, Split]
    mean_density: float       # the labeled maps' mean pixel


def _gaussians(centres: torch.Tensor, size: int, sigma: float
               ) -> torch.Tensor:
    """[C, J] centres → [C, size, J] exp(−(t − centre)² / 2σ²)."""
    t = torch.arange(size, device=centres.device, dtype=torch.float32)
    return torch.exp(-(t[None, :, None] - centres[:, None, :]) ** 2
                     / (2.0 * sigma * sigma))


def make_split(count: int, height: int, width: int, max_heads: int,
               sigma: float, gen: torch.Generator) -> Split:
    device = gen.device
    images, density, counts = [], [], []
    for start in range(0, count, CHUNK):
        c = min(CHUNK, count - start)
        n = torch.randint(0, max_heads + 1, (c,), generator=gen,
                          device=device)
        mask = (torch.arange(max_heads, device=device)[None, :]
                < n[:, None]).float()
        hy = torch.rand((c, max_heads), generator=gen, device=device) * height
        hx = torch.rand((c, max_heads), generator=gen, device=device) * width
        gy, gx = _gaussians(hy, height, sigma), _gaussians(hx, width, sigma)
        gy = gy / gy.sum(dim=1, keepdim=True) * mask[:, None, :]
        gx = gx / gx.sum(dim=1, keepdim=True)
        density.append(torch.bmm(gy, gx.transpose(1, 2)).cpu())
        by = _gaussians(hy, height, 2.5 * sigma) * mask[:, None, :]
        bx = _gaussians(hx, width, 2.5 * sigma)
        blob = torch.bmm(by, bx.transpose(1, 2))
        noise = torch.randn((c, height, width, 3), generator=gen,
                            device=device) * 8.0
        pixels = (40.0 + 140.0 * blob)[..., None] + noise
        images.append(pixels.clamp(0.0, 255.0).to(torch.uint8).cpu())
        counts.append(n.float().cpu())
    return Split(torch.cat(images).numpy(), torch.cat(density).numpy(),
                 torch.cat(counts).numpy())


def make_data(config: Dict, seed: int, device) -> Data:
    d = config["data"]
    gen = device_generator(seed, "data", device)
    splits = {name: make_split(d[name], d["height"], d["width"],
                               d["max_heads"], d["sigma"], gen)
              for name in ("labeled", "unlabeled", "validation", "test")}
    mean = float(splits["labeled"].density.mean(dtype=np.float64))
    return Data(splits, mean)


def _database(split: Split):
    from srgan_tpu_torch.data.crowd import CrowdDatabase
    return CrowdDatabase(images=split.images, density_maps=split.density,
                         head_counts=split.counts)


def experiment(settings, data: Data, device):
    """``CrowdExperiment`` whose ``_load_databases`` returns the
    benchmark's splits; the rest of its set-up is the program's."""
    from srgan_tpu_torch.apps.crowd import CrowdExperiment
    hook = vars(CrowdExperiment).get("_load_databases")
    if hook is None or "self._load_databases()" not in inspect.getsource(
            CrowdExperiment.dataset_setup):
        raise RuntimeError(
            "CrowdExperiment no longer loads its databases through "
            "_load_databases(): the benchmark's data hook is gone")
    databases = tuple(_database(data.splits[name]) for name in
                      ("labeled", "unlabeled", "validation", "test"))

    class BenchCrowdExperiment(CrowdExperiment):
        def _load_databases(self):
            return databases

    return BenchCrowdExperiment(settings, device=device)


def weight_shapes(config: Dict) -> Dict[str, Dict[str, tuple]]:
    s = config["settings"]
    d = ref.joint_cnn_shapes(s["model_base_width"])
    return {"d": d, "g": ref.generator_shapes(
        s["image_patch_size"], s["model_base_width"],
        s["latent_dimension"]), "dnn": dict(d)}


def fixed_weights(config: Dict, data: Data) -> Dict[str, Dict[str, float]]:
    """The heads' zero kernels and their biases at the dataset-mean map
    cell (16 pixels of the labeled maps' mean), as ``zero_init_heads``."""
    cell = 16.0 * data.mean_density
    heads = {"density_head.weight": 0.0, "density_head.bias": cell,
             "count_head.weight": 0.0, "count_head.bias": cell}
    return {"d": dict(heads), "dnn": dict(heads)}


def distinct_rows(order: np.ndarray, rng: np.random.Generator, step: int,
                  batch: int) -> np.ndarray:
    """Step ``step``'s rows: the next ``batch`` of one permutation of the
    split while it lasts, then a fresh permutation's first; with
    replacement only where the split is smaller than a batch."""
    n = len(order)
    if (step + 1) * batch <= n:
        return order[step * batch:(step + 1) * batch]
    if batch <= n:
        return rng.permutation(n)[:batch]
    return rng.integers(0, n, batch)


def checked_batches(exp, data: Data, rng: np.random.Generator, steps: int
                    ) -> Iterator[Tuple[tuple, tuple]]:
    """``steps`` batches through ``CrowdExperiment._sample_batch`` (the
    sampler kernels) on the benchmark's own draws, each with the draws.
    Within a step no image repeats; across the steps the images differ
    while the split holds enough of them."""
    settings = exp.settings
    b, p = settings.batch_size, settings.image_patch_size
    lab, unl = data.splits["labeled"], data.splits["unlabeled"]
    orders = {name: rng.permutation(len(split.images))
              for name, split in (("labeled", lab), ("unlabeled", unl))}
    device_data = exp._device_data
    for step in range(steps):
        args = []
        for name, split in (("labeled", lab), ("unlabeled", unl)):
            idx = distinct_rows(orders[name], rng, step, b)
            h, w = split.images.shape[1:3]
            offs = np.stack([rng.integers(0, h - p + 1, b),
                             rng.integers(0, w - p + 1, b)], axis=-1)
            flips = rng.integers(0, 2, b)
            args += [idx, offs, flips, np.zeros(b)]
        args = tuple(a.astype(np.int32) for a in args)
        batch = exp._sample_batch(device_data["labeled_images"],
                                  device_data["labeled_density"],
                                  device_data["unlabeled_images"], *args)
        yield batch, args


def reference_batch(config: Dict, data: Data, record: tuple, device
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    patch = config["settings"]["image_patch_size"]
    idx, offs, flips, _, uidx, uoffs, uflips, _ = (
        torch.from_numpy(a.astype(np.int64)) for a in record)
    lab, unl = data.splits["labeled"], data.splits["unlabeled"]

    def rows(array, ids):
        """The rows ``ids`` of a host array on the device, and ``ids``
        renumbered into them."""
        unique, inverse = torch.unique(ids, return_inverse=True)
        return torch.from_numpy(array[unique.numpy()]).to(device), inverse

    images, i = rows(lab.images, idx)
    density, _ = rows(lab.density, idx)
    uimages, ui = rows(unl.images, uidx)
    return (sampler.image_patches(images, i, offs, flips, patch),
            sampler.label_patches(density, i, offs, flips, patch),
            sampler.image_patches(uimages, ui, uoffs, uflips, patch))


def batch_shapes(config: Dict, batch: int) -> Tuple[tuple, tuple, tuple]:
    """(labeled patches, label patches, unlabeled patches) of a step."""
    p = config["settings"]["image_patch_size"]
    return (batch, 3, p, p), (batch, p, p), (batch, 3, p, p)


def reference_models(config: Dict) -> Models:
    patch = config["settings"]["image_patch_size"]
    return Models(d=ref.joint_cnn,
                  g=lambda w, z, q: ref.generator(w, z, patch, q),
                  labeled_loss=ref.crowd_labeled_loss)
