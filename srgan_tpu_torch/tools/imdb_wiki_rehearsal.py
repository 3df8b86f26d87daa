"""IMDB-WIKI-scale age preprocessing rehearsal, through the port.

The port of ``tools/imdb_wiki_rehearsal.py``. IMDB-WIKI's offline path —
a ~460k-record ``.mat`` metadata file (NaN DOBs, -inf face scores,
multi-face rows, missing files) feeding the per-image crop/resize loop
and the ``.npz`` pack — is rehearsed at scale on synthesized data:

1. A ``wiki.mat`` of ``--records`` rows (default 460 000, the IMDB
   split's order of magnitude) with dirt injected: NaN/inf DOBs, -inf
   face scores, second faces, ages out of range and records pointing at
   files that do not exist.
2. ``--images`` real JPEGs that the records cycle over.
3. The port's entries timed stage by stage: ``parse_imdb_wiki_metadata``
   at the full metadata scale, then ``preprocess_imdb_wiki`` over
   ``--limit`` images with its npz write.
4. The per-image stage extrapolated to the full filtered count, in one
   JSON report.

The preprocessing runs on the host (PIL); no stage uses the card.

Usage:
    python -m srgan_tpu_torch.tools.imdb_wiki_rehearsal [--records N]
        [--images M] [--limit K] [--image-size 64] [--keep]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np

from srgan_tpu_torch.data.age import (parse_imdb_wiki_metadata,
                                      preprocess_imdb_wiki)


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def synthesize_raw(root: str, records: int, images: int, seed: int) -> str:
    """IMDB-WIKI-layout raw tree: ``wiki.mat`` (with dirt) and JPEG
    files; returns the ``.mat``'s path."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "00"), exist_ok=True)
    # Real JPEGs at the dataset's typical face-crop scale (~150-600 px);
    # records cycle over them.
    sizes = rng.integers(120, 600, images)
    for i in range(images):
        arr = rng.integers(0, 255, (sizes[i], sizes[i], 3), np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"00/img_{i}.jpg"),
                                  quality=85)
    # Metadata: mostly-clean rows with injected dirt classes.
    dob = rng.uniform(675000, 735000, records)  # ~1848..2012 datenums
    photo_taken = rng.integers(1990, 2015, records).astype(np.float64)
    face_score = rng.uniform(0.5, 6.0, records)
    second_face = np.full(records, np.nan)
    dirt = rng.random(records)
    dob[dirt < 0.02] = np.nan                      # unknown DOB
    dob[(dirt >= 0.02) & (dirt < 0.03)] = np.inf   # corrupt DOB
    face_score[(dirt >= 0.03) & (dirt < 0.18)] = -np.inf  # no face found
    second_mask = (dirt >= 0.18) & (dirt < 0.28)   # second face present
    second_face[second_mask] = rng.uniform(0.5, 5.0,
                                           int(second_mask.sum()))
    photo_taken[(dirt >= 0.28) & (dirt < 0.30)] = 1800.0  # negative age
    missing = (dirt >= 0.30) & (dirt < 0.32)       # file absent on disk
    full_path = np.empty((1, records), object)
    for i in range(records):
        name = (f"00/missing_{i}.jpg" if missing[i]
                else f"00/img_{i % images}.jpg")
        full_path[0, i] = np.array([name])
    wiki = np.zeros((1, 1), dtype=[
        ("dob", object), ("photo_taken", object), ("full_path", object),
        ("face_score", object), ("second_face_score", object)])
    wiki[0, 0] = (dob.reshape(1, -1), photo_taken.reshape(1, -1),
                  full_path, face_score.reshape(1, -1),
                  second_face.reshape(1, -1))
    mat_path = os.path.join(root, "wiki.mat")
    savemat(mat_path, {"wiki": wiki})
    return mat_path


def rehearse(root: str, records: int, images: int, limit: int,
             image_size: int, seed: int) -> dict:
    """Synthesize the raw tree under ``root`` and run the stages; the
    report."""
    report = {"records": records, "jpeg_files": images,
              "decoded_limit": limit, "image_size": image_size}
    t0 = time.perf_counter()
    mat_path = synthesize_raw(root, records, images, seed)
    report["synthesize_secs"] = time.perf_counter() - t0
    report["mat_mb"] = os.path.getsize(mat_path) / 1e6

    t0 = time.perf_counter()
    paths, ages = parse_imdb_wiki_metadata(mat_path)
    report["parse_secs"] = time.perf_counter() - t0
    report["filtered_records"] = int(len(paths))
    if not (np.isfinite(ages).all() and (ages >= 0).all()
            and (ages <= 100).all()):
        raise ValueError("the parsed ages are not all finite in [0, 100]")

    out = os.path.join(root, "age.npz")
    t0 = time.perf_counter()
    images_out, _ = preprocess_imdb_wiki(root, mat_path,
                                         image_size=image_size,
                                         limit=limit, output_path=out)
    decode_secs = time.perf_counter() - t0
    report["preprocess_secs"] = decode_secs
    report["packed_examples"] = int(len(images_out))
    report["npz_mb"] = os.path.getsize(out) / 1e6
    report["peak_rss_gb"] = _peak_rss_gb()
    # The per-image stage extrapolated to the full filtered count.
    scale = len(paths) / max(1, limit)
    report["extrapolated_full_preprocess_hours"] = (decode_secs * scale
                                                    / 3600)
    report["extrapolated_full_npz_gb"] = (os.path.getsize(out) / 1e9
                                          * scale)
    # The in-RAM pack allocates images for ALL filtered records before
    # the valid mask.
    report["full_pack_ram_gb"] = len(paths) * image_size ** 2 * 3 / 1e9
    return report


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--records", type=int, default=460_000)
    parser.add_argument("--images", type=int, default=2000)
    parser.add_argument("--limit", type=int, default=5000,
                        help="filtered records actually decoded/packed; "
                             "per-image stages extrapolate to the full "
                             "filtered count")
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--keep", action="store_true")
    args = parser.parse_args(argv)

    root = args.out_dir or tempfile.mkdtemp(prefix="imdb_rehearsal_")
    try:
        report = rehearse(root, args.records, args.images, args.limit,
                          args.image_size, args.seed)
        print(json.dumps(report, indent=2))
        return 0
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
