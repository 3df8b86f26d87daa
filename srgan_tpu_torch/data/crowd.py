"""Crowd-counting data: label maps, the database container, the
preprocessors of raw databases and the synthetic database.

The same arrays, file format and random draws as ``srgan_tpu.data.crowd``,
so a database written by either package loads in the other and
``synthetic_crowd_database`` gives the same bytes for the same seed.

One step moves: in ``resize`` mode the preprocessor renders each image's
density label with ``ops.density.density_maps`` on its device (the CUDA
kernel on the card), where the JAX package renders it on the host with
NumPy. The function is the same; see ``ops/density.py`` for the one
difference of the kernel's form from the NumPy one. Everything else stays
on the host: images are decoded and resized with PIL (imported where it
is used), kNN/iKNN maps come from scipy, and ``tiles`` mode renders its
native-resolution canvases with the windowed NumPy form.

    python -m srgan_tpu_torch.data.crowd <raw_dir> <out.npz> \\
        [--database ucf_qnrf] [--height H] [--width W] [--sigma S] \\
        [--mode resize|tiles] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from srgan_tpu_torch.ops.density import density_maps
from srgan_tpu_torch.utils.device import default_device


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


def generate_knn_map(head_positions: np.ndarray, height: int, width: int,
                     k: int = 1, origin: Tuple[float, float] = (0.0, 0.0),
                     empty_value: Optional[float] = None) -> np.ndarray:
    """Per-pixel mean distance to the k nearest heads (scipy ``cKDTree``).

    ``origin`` offsets the pixel grid, so a tile of a larger image is
    measured against all of the image's heads. Without heads the map is
    ``empty_value``, by default the canvas diagonal ("no crowd anywhere");
    tiles pass their source canvas's diagonal.
    """
    heads = np.asarray(head_positions, np.float64).reshape(-1, 2)
    if len(heads) == 0:
        diag = np.float32(empty_value if empty_value is not None
                          else np.hypot(height, width))
        return np.full((height, width), diag, np.float32)
    from scipy.spatial import cKDTree

    oy, ox = origin
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    points = np.stack([yy.ravel() + oy, xx.ravel() + ox], axis=-1)
    k = min(k, len(heads))
    distances, _ = cKDTree(heads).query(points, k=k)
    if k > 1:
        distances = distances.mean(axis=-1)
    return distances.reshape(height, width).astype(np.float32)


def _generate_knn_map_chunked(head_positions: np.ndarray, height: int,
                              width: int, k: int = 1,
                              origin: Tuple[float, float] = (0.0, 0.0),
                              empty_value: Optional[float] = None,
                              _chunk: int = 64) -> np.ndarray:
    """Brute-force form of :func:`generate_knn_map` (a running top-k over
    chunks of heads, float32): the independent implementation the tree
    form is tested against."""
    heads = np.asarray(head_positions, np.float32).reshape(-1, 2)
    oy, ox = origin
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    yy += np.float32(oy)
    xx += np.float32(ox)
    if len(heads) == 0:
        diag = np.float32(empty_value if empty_value is not None
                          else np.hypot(height, width))
        return np.full((height, width), diag, np.float32)
    k = min(k, len(heads))
    best = np.full((height, width, k), np.inf, np.float32)
    for start in range(0, len(heads), _chunk):
        chunk = heads[start:start + _chunk]
        d = np.sqrt((yy[..., None] - chunk[None, None, :, 0]) ** 2
                    + (xx[..., None] - chunk[None, None, :, 1]) ** 2)
        merged = np.concatenate([best, d], axis=-1)
        if k == 1:
            best = merged.min(axis=-1, keepdims=True)
        else:
            best = np.partition(merged, k - 1, axis=-1)[..., :k]
    return best.mean(axis=-1).astype(np.float32)


def generate_iknn_map(head_positions: np.ndarray, height: int, width: int,
                      k: int = 1, epsilon: float = 1.0,
                      origin: Tuple[float, float] = (0.0, 0.0),
                      empty_value: Optional[float] = None) -> np.ndarray:
    """Inverse kNN map ``1 / (knn + ε)``: bounded, large where heads are
    dense."""
    return (1.0 / (generate_knn_map(head_positions, height, width, k,
                                    origin=origin,
                                    empty_value=empty_value)
                   + epsilon)).astype(np.float32)


def polygon_roi_mask(xs: np.ndarray, ys: np.ndarray, height: int,
                     width: int) -> np.ndarray:
    """Rasterize a region-of-interest polygon to a [H, W] uint8 mask
    (WorldExpo'10's per-scene ROI); evaluation counts density inside it."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (width, height), 0)
    points = [(float(x), float(y)) for x, y in zip(np.ravel(xs),
                                                   np.ravel(ys))]
    ImageDraw.Draw(img).polygon(points, fill=1, outline=1)
    return np.asarray(img, np.uint8)


def render_density_windowed(head_positions: np.ndarray, height: int,
                            width: int, sigma: float = 8.0,
                            radius_sigmas: float = 4.0) -> np.ndarray:
    """A native-resolution density canvas from per-head windows.

    Each head's Gaussian is rendered into a ±r window (r =
    ``radius_sigmas``·σ) clipped at the border and normalized to unit mass
    over it, so Σ canvas == head count, in O(heads·r²) rather than the
    full canvas's O(heads·H·W). A head beyond r of the canvas is skipped,
    as the full-canvas NumPy renderer drops it.
    """
    heads = np.asarray(head_positions, np.float32).reshape(-1, 2)
    canvas = np.zeros((height, width), np.float32)
    if len(heads) == 0:
        return canvas
    r = int(np.ceil(radius_sigmas * sigma))
    inv = 1.0 / (2.0 * sigma * sigma)
    for hy, hx in heads:
        y0 = max(0, int(np.floor(hy)) - r)
        y1 = min(height, int(np.floor(hy)) + r + 1)
        x0 = max(0, int(np.floor(hx)) - r)
        x1 = min(width, int(np.floor(hx)) + r + 1)
        if y0 >= y1 or x0 >= x1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        g = np.exp(-((yy - hy) ** 2 + (xx - hx) ** 2) * inv)
        total = g.sum()
        if total > 1e-12:
            canvas[y0:y1, x0:x1] += g / total
    return canvas


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


class DatabasePreprocessor:
    """Raw database directory → fixed-size :class:`CrowdDatabase`.

    Subclasses implement :meth:`example_paths` (image/annotation pairs)
    and :meth:`load_head_positions`. Two modes, both of static shapes:

    * ``mode='resize'``: every image is resized to (height, width) and its
      head coordinates scaled; one example per image. Its density label is
      rendered by ``ops.density.density_maps`` on ``device``: one launch
      per image, zero-head images included.
    * ``mode='tiles'``: images keep their native pixel scale and are cut
      into (height, width) tiles, zero-padded at the bottom and right. The
      density is rendered once on the native canvas (windowed, NumPy) and
      sliced, so a head's mass splits exactly across tile borders;
      ``image_ids`` maps tiles back to their images.

    ``device`` None is the CUDA card (raises without one); pass "cpu" to
    render on the CPU.
    """

    database_name = "base"
    ARCHIVE_SUFFIXES = (".zip", ".tar", ".tar.gz", ".tgz", ".tar.bz2")

    def __init__(self, height: int = 384, width: int = 512,
                 sigma: float = 8.0, label_type: str = "density",
                 knn_k: int = 1, mode: str = "resize",
                 compress: bool = True,
                 device: Optional[torch.device | str] = None):
        if label_type not in ("density", "knn", "iknn"):
            raise ValueError(f"unknown label_type {label_type!r}; "
                             f"choose density, knn or iknn")
        if mode not in ("resize", "tiles"):
            raise ValueError(f"unknown mode {mode!r}; "
                             f"choose resize or tiles")
        self.height = height
        self.width = width
        self.sigma = sigma
        self.label_type = label_type
        self.knn_k = knn_k
        self.mode = mode
        # Multi-GB tiles databases pay single-core zlib at save and a full
        # decompress at every training start; --no-compress skips both.
        self.compress = compress
        self.device = (torch.device(device) if device is not None
                       else default_device())

    # -------------------------------------------------- subclass interface
    def example_paths(self, raw_directory: str):
        """Yield (image_path, annotation_path) pairs."""
        raise NotImplementedError

    def load_head_positions(self, annotation_path: str) -> np.ndarray:
        """Return [M, 2] float32 (x, y) head positions in raw-image pixels."""
        raise NotImplementedError

    def load_roi_mask(self, image_path: str, raw_h: int,
                      raw_w: int) -> Optional[np.ndarray]:
        """Optional [raw_h, raw_w] uint8 region-of-interest mask for one
        image; None → the whole image."""
        return None

    # -------------------------------------------------- acquisition step
    def resolve_raw_directory(self, raw: str) -> str:
        """A directory is used as it is; an archive is unpacked once into a
        sibling ``<archive>_unpacked`` directory (kept across runs). A URL
        is downloaded first only when ``SRGAN_ALLOW_DOWNLOAD=1`` is set;
        otherwise it is refused: preprocessing never fetches anything
        unasked."""
        if raw.startswith(("http://", "https://")):
            from urllib.parse import urlparse
            # The basename of the URL's path: a query string must not reach
            # the file name or the archive-suffix check.
            name = os.path.basename(urlparse(raw).path)
            target = os.path.join(os.getcwd(), name or "crowd_archive")
            if not os.path.exists(target):
                if os.environ.get("SRGAN_ALLOW_DOWNLOAD") != "1":
                    raise RuntimeError(
                        f"refusing to download {raw}: set "
                        f"SRGAN_ALLOW_DOWNLOAD=1 to allow, or download "
                        f"manually and pass the archive/directory path")
                import urllib.request
                # Staged, then renamed: an interrupted download leaves no
                # partial file under the final name.
                tmp = target + ".partial"
                urllib.request.urlretrieve(raw, tmp)
                os.replace(tmp, target)
            raw = target
        if os.path.isfile(raw):
            if not raw.endswith(self.ARCHIVE_SUFFIXES):
                raise ValueError(
                    f"{raw} is a file but not a supported archive "
                    f"{self.ARCHIVE_SUFFIXES}")
            base = next(raw[:-len(suffix)] for suffix in self.ARCHIVE_SUFFIXES
                        if raw.endswith(suffix))
            unpacked = base + "_unpacked"
            if not os.path.isdir(unpacked):
                import shutil
                tmp = unpacked + ".partial"
                shutil.unpack_archive(raw, tmp)
                os.replace(tmp, unpacked)  # no half-unpacked directory
            return unpacked
        return raw

    # ---------------------------------------------------------- pipeline
    def render_density(self, heads_yx: np.ndarray) -> np.ndarray:
        """One image's [height, width] density label, rendered on the
        preprocessor's device: one ``density_maps`` call."""
        heads = torch.from_numpy(
            np.ascontiguousarray(heads_yx, np.float32).reshape(1, -1, 2))
        counts = torch.tensor([heads.shape[1]], dtype=torch.int32)
        maps = density_maps(heads.to(self.device), counts.to(self.device),
                            self.sigma, height=self.height, width=self.width)
        return maps[0].cpu().numpy()

    def preprocess(self, raw_directory: str,
                   output_path: Optional[str] = None) -> CrowdDatabase:
        from PIL import Image

        raw_directory = self.resolve_raw_directory(raw_directory)
        images, densities, counts, aux, ids, rois = [], [], [], [], [], []
        any_roi = False
        image_id = 0
        for image_path, ann_path in self.example_paths(raw_directory):
            with Image.open(image_path) as img:
                img = img.convert("RGB")
                raw_w, raw_h = img.size
                if self.mode == "tiles":
                    pixels = np.asarray(img, np.uint8)
                else:
                    pixels = np.asarray(
                        img.resize((self.width, self.height),
                                   Image.BILINEAR), np.uint8)
            heads_xy = self.load_head_positions(ann_path)
            # NaN/inf points occur in real annotation files; they would
            # turn the whole map into NaN, so they are dropped.
            heads_xy = heads_xy[np.isfinite(heads_xy).all(axis=-1)]
            roi = self.load_roi_mask(image_path, raw_h, raw_w)
            any_roi = any_roi or roi is not None
            if roi is None:
                roi = np.ones((raw_h, raw_w), np.uint8)
            if self.mode == "tiles":
                heads_yx = (np.stack([heads_xy[:, 1], heads_xy[:, 0]],
                                     axis=-1)
                            if len(heads_xy) else np.zeros((0, 2),
                                                           np.float32))
                self._append_tiles(pixels, heads_yx, image_id, images,
                                   densities, counts, aux, ids, rois, roi)
            else:
                # raw (x, y) → resized (y, x)
                scale_x = self.width / raw_w
                scale_y = self.height / raw_h
                heads_yx = np.stack([heads_xy[:, 1] * scale_y,
                                     heads_xy[:, 0] * scale_x], axis=-1) \
                    if len(heads_xy) else np.zeros((0, 2), np.float32)
                density = self.render_density(heads_yx)
                if self.label_type == "knn":
                    aux.append(generate_knn_map(heads_yx, self.height,
                                                self.width, self.knn_k))
                elif self.label_type == "iknn":
                    aux.append(generate_iknn_map(heads_yx, self.height,
                                                 self.width, self.knn_k))
                images.append(pixels)
                densities.append(density)
                counts.append(float(len(heads_yx)))
                with Image.fromarray(roi * 255) as m:
                    rois.append((np.asarray(
                        m.resize((self.width, self.height),
                                 Image.NEAREST), np.uint8) > 0
                        ).astype(np.uint8))
            image_id += 1
        database = CrowdDatabase(
            images=np.stack(images) if images else
            np.zeros((0, self.height, self.width, 3), np.uint8),
            # copy=False: the maps are float32 already, and the stack is
            # the largest array of a tiles database.
            density_maps=(np.stack(densities).astype(np.float32,
                                                     copy=False)
                          if densities
                          else np.zeros((0, self.height, self.width),
                                        np.float32)),
            head_counts=np.asarray(counts, np.float32),
            aux_maps=(np.stack(aux).astype(np.float32, copy=False)
                      if aux else None),
            label_type=self.label_type,
            image_ids=(np.asarray(ids, np.int32)
                       if self.mode == "tiles" else None),
            # Masks whenever any pixel is excluded, by a dataset ROI or by
            # the tiles' edge padding; an all-ones set is dropped.
            roi_masks=(np.stack(rois)
                       if rois and (any_roi or
                                    any(m.min() == 0 for m in rois))
                       else None))
        # The 'meanstd' normalization's pixel statistics, stored with the
        # arrays.
        if len(database):
            database.image_statistics()
        if output_path:
            database.save(output_path, compress=self.compress)
        return database

    def _append_tiles(self, pixels: np.ndarray, heads_yx: np.ndarray,
                      image_id: int, images, densities, counts, aux,
                      ids, rois, roi: np.ndarray) -> None:
        """Cut one native-resolution image into (height, width) tiles.
        Per-tile ``head_counts`` are the tiles' density mass, fractional
        where a head straddles a border; per-image totals stay exact."""
        th, tw = self.height, self.width
        raw_h, raw_w = pixels.shape[:2]
        ny, nx = -(-raw_h // th), -(-raw_w // tw)
        padded = np.zeros((ny * th, nx * tw, 3), np.uint8)
        padded[:raw_h, :raw_w] = pixels
        padded_roi = np.zeros((ny * th, nx * tw), np.uint8)
        padded_roi[:raw_h, :raw_w] = roi
        canvas = render_density_windowed(heads_yx, ny * th, nx * tw,
                                         self.sigma)
        # Without heads, every tile's kNN distance is the SOURCE canvas's
        # diagonal: a tile's own would read as closer crowd.
        diag = float(np.hypot(ny * th, nx * tw))
        for ty in range(ny):
            for tx in range(nx):
                ys, xs = ty * th, tx * tw
                images.append(padded[ys:ys + th, xs:xs + tw])
                tile_density = canvas[ys:ys + th, xs:xs + tw]
                densities.append(tile_density)
                counts.append(float(tile_density.sum()))
                ids.append(image_id)
                rois.append(padded_roi[ys:ys + th, xs:xs + tw])
                if self.label_type in ("knn", "iknn"):
                    make = (generate_knn_map if self.label_type == "knn"
                            else generate_iknn_map)
                    aux.append(make(heads_yx, th, tw, self.knn_k,
                                    origin=(float(ys), float(xs)),
                                    empty_value=diag))


def _load_ann_points(annotation_path: str) -> np.ndarray:
    from scipy.io import loadmat
    points = loadmat(annotation_path)["annPoints"]
    return np.asarray(points, np.float32).reshape(-1, 2)


class UcfQnrfPreprocessor(DatabasePreprocessor):
    """UCF-QNRF layout: ``img_0001.jpg`` + ``img_0001_ann.mat`` with key
    ``annPoints`` [M, 2] (x, y)."""

    database_name = "ucf_qnrf"

    def example_paths(self, raw_directory: str):
        for image_path in sorted(glob.glob(
                os.path.join(raw_directory, "**", "img_*.jpg"),
                recursive=True)):
            ann = image_path[:-len(".jpg")] + "_ann.mat"
            if os.path.exists(ann):
                yield image_path, ann

    def load_head_positions(self, annotation_path: str) -> np.ndarray:
        return _load_ann_points(annotation_path)


class ShanghaiTechPreprocessor(DatabasePreprocessor):
    """ShanghaiTech layout: ``images/IMG_i.jpg`` + ``ground-truth/
    GT_IMG_i.mat`` with ``image_info[0,0]['location'][0,0]`` [M, 2]
    (x, y)."""

    database_name = "shanghai_tech"

    def example_paths(self, raw_directory: str):
        for image_path in sorted(glob.glob(
                os.path.join(raw_directory, "**", "IMG_*.jpg"),
                recursive=True)):
            name = os.path.splitext(os.path.basename(image_path))[0]
            gt_dir = os.path.join(os.path.dirname(os.path.dirname(
                image_path)), "ground-truth")
            ann = os.path.join(gt_dir, f"GT_{name}.mat")
            if os.path.exists(ann):
                yield image_path, ann

    def load_head_positions(self, annotation_path: str) -> np.ndarray:
        from scipy.io import loadmat
        info = loadmat(annotation_path)["image_info"]
        points = info[0, 0][0, 0][0]
        return np.asarray(points, np.float32).reshape(-1, 2)


class UcfCc50Preprocessor(DatabasePreprocessor):
    """UCF-CC-50 layout: ``<i>.jpg`` + ``<i>_ann.mat`` with key
    ``annPoints`` [M, 2] (x, y), UCF-QNRF's schema under bare numeric
    names."""

    database_name = "ucf_cc_50"

    def example_paths(self, raw_directory: str):
        for image_path in sorted(glob.glob(
                os.path.join(raw_directory, "**", "*.jpg"),
                recursive=True)):
            ann = image_path[:-len(".jpg")] + "_ann.mat"
            if os.path.exists(ann):
                yield image_path, ann

    def load_head_positions(self, annotation_path: str) -> np.ndarray:
        return _load_ann_points(annotation_path)


class WorldExpoPreprocessor(DatabasePreprocessor):
    """WorldExpo'10 layout: scene frames ``<scene>_<frame>.jpg``, each with
    a ``<same name>.mat`` beside it holding ``point_position`` [M, 2]
    (x, y), and a per-scene ``roi.mat`` polygon. (The distribution keeps
    the labels in a sibling directory: place each frame's .mat next to its
    .jpg first.)"""

    database_name = "world_expo"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._roi_cache: Dict[tuple, Optional[np.ndarray]] = {}

    def example_paths(self, raw_directory: str):
        for image_path in sorted(glob.glob(
                os.path.join(raw_directory, "**", "*.jpg"),
                recursive=True)):
            ann = os.path.splitext(image_path)[0] + ".mat"
            if os.path.exists(ann):
                yield image_path, ann

    def load_head_positions(self, annotation_path: str) -> np.ndarray:
        from scipy.io import loadmat
        points = np.asarray(loadmat(annotation_path)["point_position"],
                            np.float32)
        # Empty frames come as 0-d or (0, 0) arrays.
        if points.size == 0:
            return np.zeros((0, 2), np.float32)
        return points.reshape(-1, 2)

    def load_roi_mask(self, image_path: str, raw_h: int,
                      raw_w: int) -> Optional[np.ndarray]:
        """The scene's ROI polygon (``roi.mat`` beside the frames, keys
        ``maskVerticesXCoordinates``/``maskVerticesYCoordinates``),
        rasterized once per scene and size."""
        scene_dir = os.path.dirname(image_path)
        key = (scene_dir, raw_h, raw_w)
        if key not in self._roi_cache:
            roi_path = os.path.join(scene_dir, "roi.mat")
            if not os.path.exists(roi_path):
                self._roi_cache[key] = None
            else:
                from scipy.io import loadmat
                data = loadmat(roi_path)
                self._roi_cache[key] = polygon_roi_mask(
                    data["maskVerticesXCoordinates"],
                    data["maskVerticesYCoordinates"], raw_h, raw_w)
        return self._roi_cache[key]


PREPROCESSORS: Dict[str, type] = {
    cls.database_name: cls
    for cls in (UcfQnrfPreprocessor, ShanghaiTechPreprocessor,
                UcfCc50Preprocessor, WorldExpoPreprocessor)
}


def main(argv=None) -> int:
    """Preprocess one raw split into a fixed-resolution ``.npz``; the
    flags of ``python -m srgan_tpu.data.crowd``, plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="srgan_tpu_torch.data.crowd",
        description="Preprocess a raw crowd database into a fixed-"
                    "resolution .npz split")
    parser.add_argument("raw_directory")
    parser.add_argument("output_path")
    parser.add_argument("--database", default="ucf_qnrf",
                        choices=sorted(PREPROCESSORS))
    parser.add_argument("--height", type=int, default=384)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--sigma", type=float, default=8.0)
    parser.add_argument("--label-type", default="density",
                        choices=["density", "knn", "iknn"])
    parser.add_argument("--knn-k", type=int, default=1)
    parser.add_argument("--mode", default="resize",
                        choices=["resize", "tiles"],
                        help="resize: one (height,width) example per "
                             "image; tiles: native-resolution "
                             "(height,width) tiles with image_ids for "
                             "per-image evaluation")
    parser.add_argument("--no-compress", action="store_true",
                        help="write an uncompressed .npz (no zlib at save, "
                             "no decompress at each training start)")
    parser.add_argument("--device", default=None,
                        help="where resize mode renders the density "
                             "labels (default: the CUDA card; 'cpu' for "
                             "the plain version)")
    args = parser.parse_args(argv)
    pre = PREPROCESSORS[args.database](height=args.height,
                                       width=args.width, sigma=args.sigma,
                                       label_type=args.label_type,
                                       knn_k=args.knn_k, mode=args.mode,
                                       compress=not args.no_compress,
                                       device=args.device)
    db = pre.preprocess(args.raw_directory, args.output_path)
    sources = (f" from {db.num_source_images} images"
               if db.image_ids is not None else "")
    print(f"wrote {len(db)} examples "
          f"({args.height}x{args.width}){sources} to {args.output_path}")
    return 0


def synthetic_crowd_database(count: int, height: int = 96, width: int = 128,
                             max_heads: int = 64, sigma: float = 4.0,
                             seed: int = 0,
                             label_type: str = "density",
                             knn_k: int = 1) -> CrowdDatabase:
    """Procedural crowd-like data with real signal: each head renders a
    bright blob into the image, so density and count are learnable from
    pixels. Draws the same numbers as the JAX package's generator.
    ``label_type`` 'knn'/'iknn' also fills ``aux_maps``."""
    if label_type not in ("density", "knn", "iknn"):
        raise ValueError(f"unknown label_type {label_type!r}; "
                         f"choose density, knn or iknn")
    rng = np.random.default_rng(seed)
    images = np.zeros((count, height, width, 3), np.float32)
    densities = np.zeros((count, height, width), np.float32)
    aux = (np.zeros((count, height, width), np.float32)
           if label_type != "density" else None)
    counts = np.zeros((count,), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i in range(count):
        n = int(rng.integers(0, max_heads + 1))
        heads = np.stack([rng.uniform(0, height, n),
                          rng.uniform(0, width, n)], axis=-1)
        if label_type == "knn":
            aux[i] = generate_knn_map(heads, height, width, knn_k)
        elif label_type == "iknn":
            aux[i] = generate_iknn_map(heads, height, width, knn_k)
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
                         aux_maps=aux, label_type=label_type)


if __name__ == "__main__":
    raise SystemExit(main())
