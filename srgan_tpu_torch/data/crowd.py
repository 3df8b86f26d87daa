"""Crowd-counting data: the database container and the synthetic database.

The same arrays, file format and random draws as ``srgan_tpu.data.crowd``
(NumPy only), so a database written by either package loads in the other
and ``synthetic_crowd_database`` gives the same bytes for the same seed.
The preprocessors of raw databases and the kNN/iKNN label maps are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np


def density_maps_reference(head_positions: np.ndarray,
                           head_counts: np.ndarray, sigma: float,
                           height: int, width: int) -> np.ndarray:
    """Sum of unit-mass Gaussians per image, on the host: [B, N, 2] heads,
    [B] counts → [B, H, W] float32 (``srgan_tpu.ops.density``'s NumPy
    renderer)."""
    b = head_positions.shape[0]
    out = np.zeros((b, height, width), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i in range(b):
        for j in range(int(head_counts[i])):
            hy, hx = head_positions[i, j]
            g = np.exp(-((yy - hy) ** 2 + (xx - hx) ** 2)
                       / (2.0 * sigma * sigma))
            total = g.sum()
            if total > 1e-12:
                out[i] += g / total
    return out


def generate_density_label(head_positions: np.ndarray, height: int,
                           width: int, sigma: float = 8.0) -> np.ndarray:
    """Render one Gaussian density map; Σ map == head count."""
    heads = np.asarray(head_positions, np.float32).reshape(1, -1, 2)
    counts = np.array([heads.shape[1]], np.int32)
    return density_maps_reference(heads, counts, sigma, height, width)[0]


@dataclasses.dataclass
class CrowdDatabase:
    """One split of a preprocessed crowd database (fixed-size arrays).

    images:         [N, H, W, 3] uint8 raw pixels
    density_maps:   [N, H, W] float32, Σ per map == head count
    head_counts:    [N] float32 total heads per image
    aux_maps:       optional [N, H, W] kNN/iKNN targets (``label_type``)
    image_ids:      optional [N] source image of each tile
    roi_masks:      optional [N, H, W] uint8 evaluation regions
    image_mean/std: optional [3] per-channel pixel statistics in [0, 1]
    """
    images: np.ndarray
    density_maps: np.ndarray
    head_counts: np.ndarray
    aux_maps: Optional[np.ndarray] = None
    label_type: str = "density"
    image_ids: Optional[np.ndarray] = None
    roi_masks: Optional[np.ndarray] = None
    image_mean: Optional[np.ndarray] = None
    image_std: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.images.ndim != 4 or self.images.shape[3] != 3:
            raise ValueError(f"images must be [N, H, W, 3], got "
                             f"{self.images.shape}")
        if self.density_maps.shape != self.images.shape[:3]:
            raise ValueError(f"density_maps {self.density_maps.shape} do "
                             f"not match images {self.images.shape}")
        if len(self.head_counts) != len(self.images):
            raise ValueError("head_counts and images differ in length")
        if self.image_ids is not None and \
                len(self.image_ids) != len(self.images):
            raise ValueError("image_ids and images differ in length")
        if self.roi_masks is not None and \
                self.roi_masks.shape != self.images.shape[:3]:
            raise ValueError("roi_masks do not match images")

    def __len__(self) -> int:
        return len(self.images)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    @property
    def num_source_images(self) -> int:
        if self.image_ids is None:
            return len(self.images)
        return int(self.image_ids.max()) + 1 if len(self.image_ids) else 0

    def image_statistics(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-channel (mean, std) of the pixels in [0,1] scale.

        Stored statistics win; otherwise computed once, in float64 over
        ~128 MB chunks (a whole-array float64 copy is 8× the image
        bytes), and cached. std is floored at 1e-3.
        """
        if self.image_mean is None or self.image_std is None:
            total = np.zeros(3, np.float64)
            total_sq = np.zeros(3, np.float64)
            count = 0
            per_image = max(1, int(self.images[:1].nbytes))
            step = max(1, (128 << 20) // per_image)
            for i in range(0, len(self.images), step):
                chunk = (self.images[i:i + step].reshape(-1, 3)
                         .astype(np.float64) / 255.0)
                total += chunk.sum(axis=0)
                total_sq += np.square(chunk).sum(axis=0)
                count += len(chunk)
            mean = total / max(count, 1)
            var = np.maximum(total_sq / max(count, 1) - mean ** 2, 0.0)
            self.image_mean = mean.astype(np.float32)
            self.image_std = np.maximum(
                np.sqrt(var), 1e-3).astype(np.float32)
        return self.image_mean, self.image_std

    def roi_head_counts(self) -> np.ndarray:
        """Ground-truth counts inside the ROI (``head_counts`` without
        masks), cached after the first call."""
        if self.roi_masks is None:
            return self.head_counts
        cached = getattr(self, "_roi_counts_cache", None)
        if cached is None:
            cached = (self.density_maps
                      * self.roi_masks.astype(np.float32)
                      ).sum(axis=(1, 2)).astype(np.float32)
            self._roi_counts_cache = cached
        return cached

    def per_image_counts(self, per_example: np.ndarray) -> np.ndarray:
        """Per-example (per-tile) counts summed per source image."""
        per_example = np.asarray(per_example, np.float64)
        if self.image_ids is None:
            return per_example.astype(np.float32)
        return np.bincount(self.image_ids, weights=per_example,
                           minlength=self.num_source_images
                           ).astype(np.float32)

    def save(self, path: str, compress: bool = True) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        arrays = dict(images=self.images, density_maps=self.density_maps,
                      head_counts=self.head_counts,
                      label_type=np.asarray(self.label_type))
        if self.aux_maps is not None:
            arrays["aux_maps"] = self.aux_maps
        if self.image_ids is not None:
            arrays["image_ids"] = self.image_ids
        if self.roi_masks is not None:
            arrays["roi_masks"] = self.roi_masks
        if self.image_mean is not None and self.image_std is not None:
            arrays["image_mean"] = self.image_mean
            arrays["image_std"] = self.image_std
        (np.savez_compressed if compress else np.savez)(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "CrowdDatabase":
        data = np.load(path)
        # Bind each member once: NpzFile re-inflates a compressed member
        # on every __getitem__.
        density_maps = data["density_maps"]
        head_counts = data["head_counts"]
        aux_maps = data["aux_maps"] if "aux_maps" in data else None
        # One NaN here would surface steps later as NaN losses.
        for name, arr in (("density_maps", density_maps),
                          ("head_counts", head_counts),
                          ("aux_maps", aux_maps)):
            if arr is not None and not np.isfinite(arr).all():
                raise ValueError(
                    f"{path}: non-finite values in {name!r} — the "
                    f"database file is corrupted; re-run preprocessing")
        return cls(images=data["images"],
                   density_maps=density_maps,
                   head_counts=head_counts,
                   aux_maps=aux_maps,
                   label_type=(str(data["label_type"])
                               if "label_type" in data else "density"),
                   image_ids=(data["image_ids"]
                              if "image_ids" in data else None),
                   roi_masks=(data["roi_masks"]
                              if "roi_masks" in data else None),
                   image_mean=(data["image_mean"]
                               if "image_mean" in data else None),
                   image_std=(data["image_std"]
                              if "image_std" in data else None))


def synthetic_crowd_database(count: int, height: int = 96, width: int = 128,
                             max_heads: int = 64, sigma: float = 4.0,
                             seed: int = 0,
                             label_type: str = "density") -> CrowdDatabase:
    """Procedural crowd-like data with real signal: each head renders a
    bright blob into the image, so density and count are learnable from
    pixels. Draws the same numbers as the JAX package's generator."""
    if label_type != "density":
        raise NotImplementedError(
            f"label_type {label_type!r}: the kNN/iKNN maps are not "
            f"ported yet; use 'density'")
    rng = np.random.default_rng(seed)
    images = np.zeros((count, height, width, 3), np.float32)
    densities = np.zeros((count, height, width), np.float32)
    counts = np.zeros((count,), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i in range(count):
        n = int(rng.integers(0, max_heads + 1))
        heads = np.stack([rng.uniform(0, height, n),
                          rng.uniform(0, width, n)], axis=-1)
        blob = np.zeros((height, width), np.float32)
        for hy, hx in heads:
            blob += np.exp(-((yy - hy) ** 2 + (xx - hx) ** 2)
                           / (2.0 * (2.5 * sigma) ** 2))
        # Brightness linear in local blob density, so pixels carry count.
        img = 40.0 + 140.0 * blob
        noise = rng.normal(0, 8.0, (height, width, 3))
        images[i] = np.clip(img[..., None] + noise, 0, 255)
        densities[i] = generate_density_label(heads, height, width, sigma)
        counts[i] = float(n)
    return CrowdDatabase(images=images.astype(np.uint8),
                         density_maps=densities, head_counts=counts,
                         label_type=label_type)
