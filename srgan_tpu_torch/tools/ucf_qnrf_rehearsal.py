"""Full-scale UCF-QNRF preprocessing rehearsal, through the port.

The port of ``tools/ucf_qnrf_rehearsal.py``. UCF-QNRF's offline path —
JPEGs up to ~6000 px wide, ``.mat`` annotations of up to 12 865 heads
with NaN/inf and out-of-frame points, ``--mode tiles``, the windowed
density renderer, the kNN maps — is rehearsed at real scale on
synthesized data:

1. UCF-QNRF-layout raw inputs (``img_NNNN.jpg`` and
   ``img_NNNN_ann.mat['annPoints']``), clustered heads, and in every
   annotation file two non-finite and two out-of-frame points.
2. ``UcfQnrfPreprocessor(mode="tiles")`` of the port for each label type,
   its stages timed apart: the annotation loads, the labels (the density
   canvas, its tiles and the kNN maps), the rest of the pass (the JPEG
   decode and RGB conversion, the stacking and the pixel statistics) and
   the npz write.
3. The mass check: each image's count (the sum of its tiles' density)
   against the finite heads whose window reaches its canvas.

Prints one JSON line per label type and a summary line.

Usage:
    python -m srgan_tpu_torch.tools.ucf_qnrf_rehearsal [--out-dir DIR]
        [--max-heads N] [--label-types density knn] [--keep] [--small]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import tempfile
import time
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from srgan_tpu_torch.data.crowd import (CrowdDatabase, UcfQnrfPreprocessor,
                                        render_density_windowed)

# (height, width, heads): spans UCF-QNRF's size range, the largest at the
# dataset's documented extremes (None: --max-heads).
DEFAULT_IMAGES = [
    (4000, 6000, None),
    (3264, 4928, 4000),
    (2160, 3840, 900),
    (1080, 1920, 45),
]
MASS_RTOL = 1e-4  # float32 sums over a canvas of up to 26 M pixels


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _junk(h: int, w: int) -> np.ndarray:
    """The injected (x, y) points: NaN, inf and two out of frame."""
    return np.array([[np.nan, 10.0], [20.0, np.inf],
                     [w + 500.0, h / 2], [-42.0, 13.0]], np.float32)


def generate_raw(root: str, images: Sequence[Tuple[int, int, Optional[int]]],
                 max_heads: int, seed: int) -> List[np.ndarray]:
    """UCF-QNRF-layout raw data at native scale: clustered heads (a
    mixture of ~n/300 blobs), an image whose brightness is linear in
    their local density, and the annotations as (x, y) with the junk
    points shuffled in. Returns each image's annotation points."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    annotations = []
    for i, (h, w, n) in enumerate(images):
        n = max_heads if n is None else n
        centers = rng.uniform([0, 0], [h, w], (max(1, n // 300), 2))
        which = rng.integers(0, len(centers), n)
        spread = np.array([h, w]) * 0.06
        heads_yx = centers[which] + rng.normal(0, 1, (n, 2)) * spread
        heads_yx = np.clip(heads_yx, 0, [h - 1, w - 1]).astype(np.float32)
        blob = render_density_windowed(heads_yx, h, w, sigma=16.0)
        blob /= max(blob.max(), 1e-6)
        img = (40.0 + 140.0 * blob)[..., None] + rng.normal(0, 8, (h, w, 1))
        pixels = np.clip(np.repeat(img, 3, axis=-1), 0, 255).astype(np.uint8)
        t0 = time.perf_counter()
        Image.fromarray(pixels).save(os.path.join(root, f"img_{i:04d}.jpg"),
                                     quality=92)
        ann_xy = np.concatenate([heads_yx[:, ::-1], _junk(h, w)])
        rng.shuffle(ann_xy)
        savemat(os.path.join(root, f"img_{i:04d}_ann.mat"),
                {"annPoints": ann_xy})
        annotations.append(ann_xy)
        print(f"  raw img_{i:04d}: {h}x{w}, {n} heads (+4 junk ann), jpeg "
              f"in {time.perf_counter() - t0:.1f}s", flush=True)
    return annotations


def expected_mass(ann_xy: np.ndarray, h: int, w: int, tile_h: int,
                  tile_w: int, sigma: float, radius_sigmas: float = 4.0
                  ) -> int:
    """The heads a tiles database keeps of one image: the finite points
    whose ±r window reaches the image's tile-padded canvas (each then
    carries unit mass; ``render_density_windowed`` skips the others)."""
    pts = ann_xy[np.isfinite(ann_xy).all(axis=-1)]
    canvas_h, canvas_w = -(-h // tile_h) * tile_h, -(-w // tile_w) * tile_w
    r = int(np.ceil(radius_sigmas * sigma))
    fy, fx = np.floor(pts[:, 1]), np.floor(pts[:, 0])
    reach = ((np.maximum(0, fy - r) < np.minimum(canvas_h, fy + r + 1))
             & (np.maximum(0, fx - r) < np.minimum(canvas_w, fx + r + 1)))
    return int(reach.sum())


class TimedPreprocessor(UcfQnrfPreprocessor):
    """``UcfQnrfPreprocessor`` with its annotation loads and, in tiles
    mode, its labels (the density canvas, its tiles, the kNN maps)
    timed."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seconds = defaultdict(float)

    def load_head_positions(self, annotation_path):
        t0 = time.perf_counter()
        heads = super().load_head_positions(annotation_path)
        self.seconds["annotations"] += time.perf_counter() - t0
        return heads

    def _append_tiles(self, *args, **kwargs):
        t0 = time.perf_counter()
        super()._append_tiles(*args, **kwargs)
        self.seconds["labels"] += time.perf_counter() - t0


def rehearse(root: str, images: Sequence[Tuple[int, int, Optional[int]]],
             max_heads: int, label_types: Sequence[str], height: int,
             width: int, sigma: float, seed: int, device=None) -> dict:
    """Generate the raw data under ``root`` and preprocess it once per
    label type; returns the summary (``results``: one record per label
    type)."""
    raw = os.path.join(root, "raw")
    print(f"[1/2] generating raw data under {raw}", flush=True)
    t0 = time.perf_counter()
    annotations = generate_raw(raw, images, max_heads, seed)
    gen_s = time.perf_counter() - t0
    raw_bytes = sum(os.path.getsize(os.path.join(raw, f))
                    for f in os.listdir(raw))
    print(f"  raw done in {gen_s:.1f}s, {raw_bytes / 1e6:.0f} MB, "
          f"peak RSS {_peak_rss_gb():.1f} GB", flush=True)
    expected = np.array([expected_mass(ann, h, w, height, width, sigma)
                         for ann, (h, w, _) in zip(annotations, images)],
                        np.float64)
    results = []
    for label_type in label_types:
        out = os.path.join(root, f"labeled_{label_type}.npz")
        print(f"[2/2] preprocess --mode tiles --label-type {label_type}",
              flush=True)
        pre = TimedPreprocessor(height=height, width=width, sigma=sigma,
                                label_type=label_type, mode="tiles",
                                device=device)
        t0 = time.perf_counter()
        db = pre.preprocess(raw)
        pass_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        db.save(out, compress=pre.compress)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = CrowdDatabase.load(out)
        load_s = time.perf_counter() - t0
        per_image = loaded.per_image_counts(loaded.head_counts)
        mass_error = np.abs(per_image - expected) / np.maximum(expected, 1)
        record = {
            "label_type": label_type,
            "tiles": len(db),
            "source_images": db.num_source_images,
            "preprocess_seconds": pass_s + write_s,
            "annotation_seconds": pre.seconds["annotations"],
            "label_seconds": pre.seconds["labels"],
            "decode_seconds": (pass_s - pre.seconds["annotations"]
                               - pre.seconds["labels"]),
            "npz_write_seconds": write_s,
            "load_seconds": load_s,
            "npz_mb": os.path.getsize(out) / 1e6,
            "peak_rss_gb": _peak_rss_gb(),
            "per_image_counts": [float(c) for c in per_image],
            "expected_counts": [int(c) for c in expected],
            "max_mass_error": float(mass_error.max()),
            "mass_conserved": bool(mass_error.max() <= MASS_RTOL),
            "density_finite": bool(np.isfinite(loaded.density_maps).all()),
            "has_masks": loaded.roi_masks is not None,
            "has_stats": loaded.image_mean is not None,
        }
        results.append(record)
        print(json.dumps(record), flush=True)
    return {"summary": True, "raw_generate_seconds": gen_s,
            "raw_mb": raw_bytes / 1e6, "results": results}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out-dir", default=None,
                        help="working dir (default: temp, removed unless "
                             "--keep)")
    parser.add_argument("--max-heads", type=int, default=12000)
    parser.add_argument("--label-types", nargs="+",
                        default=["density", "knn"])
    parser.add_argument("--height", type=int, default=384)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--sigma", type=float, default=8.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--keep", action="store_true")
    parser.add_argument("--small", action="store_true",
                        help="1/4-scale smoke form (CI-sized)")
    parser.add_argument("--device", default=None,
                        help="the preprocessor's device (default: the CUDA "
                             "card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    images = DEFAULT_IMAGES
    if args.small:
        images = [(h // 4, w // 4, (n or args.max_heads) // 16)
                  for h, w, n in images]
    root = args.out_dir or tempfile.mkdtemp(prefix="ucf_rehearsal_")
    try:
        summary = rehearse(root, images, args.max_heads, args.label_types,
                           args.height, args.width, args.sigma, args.seed,
                           args.device)
        print(json.dumps(summary))
        return 0 if all(r["mass_conserved"] for r in summary["results"]) \
            else 1
    finally:
        if not args.keep and args.out_dir is None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
