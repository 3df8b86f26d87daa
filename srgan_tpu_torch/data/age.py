"""IMDB-WIKI age-estimation data: the port of ``srgan_tpu.data.age``.

The ``.mat`` metadata is parsed (date of birth against the year the
photo was taken gives the age label) and filtered by face score; the
images are resized and packed into an ``.npz`` (uint8 images, float32
ages) once, offline, by ``python -m srgan_tpu_torch.data.age``. NumPy,
scipy and PIL as in the JAX package, so that both write the same arrays
from the same raw layout. scipy and PIL are imported inside the
functions that need them. A procedural generator stands in for the
database in tests.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from srgan_tpu_torch.data.core import ArrayDataset

MATLAB_EPOCH_ORDINAL = 366  # Matlab datenum 1 == Jan 1 year 0


def matlab_datenum_to_year(datenum: np.ndarray) -> np.ndarray:
    """Matlab serial date → fractional year (vectorized, no datetime
    object per row — the metadata has ~500k entries)."""
    return 1 + (np.asarray(datenum, np.float64)
                - MATLAB_EPOCH_ORDINAL) / 365.2425


def parse_imdb_wiki_metadata(mat_path: str, database: str = "wiki",
                             minimum_face_score: float = 1.0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Return (relative image paths, float ages) after quality filtering:
    a detected face (``face_score`` above the threshold), no second face,
    and an age in [0, 100]."""
    from scipy.io import loadmat

    meta = loadmat(mat_path)[database][0, 0]
    dob = meta["dob"].reshape(-1)
    photo_taken = meta["photo_taken"].reshape(-1).astype(np.float64)
    full_path = np.array([p[0] for p in meta["full_path"].reshape(-1)])
    face_score = meta["face_score"].reshape(-1)
    second_face = meta["second_face_score"].reshape(-1)

    age = photo_taken + 0.5 - matlab_datenum_to_year(dob)
    keep = (np.isfinite(face_score)
            & (face_score > minimum_face_score)
            & ~np.isfinite(second_face)
            & (age >= 0) & (age <= 100))
    return full_path[keep], age[keep].astype(np.float32)


def preprocess_imdb_wiki(root_directory: str, mat_path: str,
                         database: str = "wiki", image_size: int = 64,
                         limit: Optional[int] = None,
                         output_path: Optional[str] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Crop/resize the filtered images to ``image_size`` and pack arrays."""
    from PIL import Image

    paths, ages = parse_imdb_wiki_metadata(mat_path, database)
    if limit:
        paths, ages = paths[:limit], ages[:limit]
    images = np.zeros((len(paths), image_size, image_size, 3), np.uint8)
    valid = np.zeros(len(paths), bool)
    for i, rel in enumerate(paths):
        path = os.path.join(root_directory, rel)
        if not os.path.exists(path):
            continue
        with Image.open(path) as img:
            images[i] = np.asarray(
                img.convert("RGB").resize((image_size, image_size),
                                          Image.BILINEAR), np.uint8)
        valid[i] = True
    skipped = int(len(valid) - valid.sum())
    if skipped:
        # A wrong root_directory must not write an empty database and
        # exit 0: report the skips, and raise when nothing resolved.
        if len(paths) and not valid.any():
            raise FileNotFoundError(
                f"none of the {len(valid)} metadata records resolve to "
                f"an image file under {root_directory!r} — wrong "
                f"root_directory?")
        import warnings
        warnings.warn(
            f"{skipped}/{len(valid)} metadata records point at image "
            f"files missing under {root_directory!r}; they were skipped",
            stacklevel=2)
    images, ages = images[valid], ages[valid]
    if output_path:
        os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                    exist_ok=True)
        np.savez_compressed(output_path, images=images, ages=ages)
    return images, ages


def synthetic_age_examples(count: int, image_size: int = 64, seed: int = 0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural 'faces' whose pixel statistics encode age: an elliptical
    blob whose radius and contrast vary monotonically with age, plus
    noise — a learnable stand-in for hermetic tests/benchmarks."""
    rng = np.random.default_rng(seed)
    ages = rng.uniform(0.0, 100.0, count).astype(np.float32)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    cy = cx = (image_size - 1) / 2.0
    images = np.zeros((count, image_size, image_size, 3), np.float32)
    for i, age in enumerate(ages):
        radius = image_size * (0.15 + 0.002 * age)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                        / (2.0 * radius ** 2)))
        base = 60.0 + 1.2 * age
        img = base * blob[..., None] + rng.normal(0, 6.0,
                                                  (image_size, image_size,
                                                   3))
        images[i] = np.clip(img, 0, 255)
    # [-1, 1] normalization (reference image convention)
    images = images / 127.5 - 1.0
    return images.astype(np.float32), ages


def age_datasets(settings) -> Tuple[ArrayDataset, ArrayDataset,
                                    ArrayDataset, ArrayDataset]:
    """(labeled, unlabeled, validation, test) splits, from a preprocessed
    ``.npz`` at ``settings.age_database_path`` or the synthetic
    generator."""
    path = settings.age_database_path
    size = settings.age_image_size
    if path:
        data = np.load(path)
        images = data["images"]
        ages = data["ages"].astype(np.float32)
        bounds = np.cumsum([settings.labeled_dataset_size,
                            settings.unlabeled_dataset_size,
                            settings.validation_dataset_size,
                            settings.test_dataset_size])

        def norm(u8: np.ndarray) -> np.ndarray:
            # Per split: converting the whole array to float32 first
            # would hold records no split uses.
            return u8.astype(np.float32) / 127.5 - 1.0

        return (ArrayDataset(norm(images[:bounds[0]]), ages[:bounds[0]]),
                ArrayDataset(norm(images[bounds[0]:bounds[1]])),
                ArrayDataset(norm(images[bounds[1]:bounds[2]]),
                             ages[bounds[1]:bounds[2]]),
                ArrayDataset(norm(images[bounds[2]:bounds[3]]),
                             ages[bounds[2]:bounds[3]]))
    lab = synthetic_age_examples(settings.labeled_dataset_size, size,
                                 settings.seed)
    unl = synthetic_age_examples(settings.unlabeled_dataset_size, size,
                                 settings.seed + 1)
    val = synthetic_age_examples(settings.validation_dataset_size, size,
                                 settings.seed + 2)
    test = synthetic_age_examples(settings.test_dataset_size, size,
                                  settings.seed + 3)
    return (ArrayDataset(*lab), ArrayDataset(unl[0]), ArrayDataset(*val),
            ArrayDataset(*test))


def main(argv=None) -> int:
    """Offline preprocessing:

    python -m srgan_tpu_torch.data.age <root_dir> <wiki.mat> <out.npz> \
        [--database wiki|imdb] [--image-size N] [--limit N]
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="srgan_tpu_torch.data.age",
        description="Preprocess IMDB-WIKI into a fixed-size .npz")
    parser.add_argument("root_directory")
    parser.add_argument("mat_path")
    parser.add_argument("output_path")
    parser.add_argument("--database", default="wiki",
                        choices=["wiki", "imdb"])
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    images, ages = preprocess_imdb_wiki(
        args.root_directory, args.mat_path, database=args.database,
        image_size=args.image_size, limit=args.limit,
        output_path=args.output_path)
    print(f"wrote {len(images)} examples to {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
