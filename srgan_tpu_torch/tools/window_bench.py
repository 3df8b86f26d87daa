"""Benchmark the window tier on a database larger than the card.

The port of ``tools/window_bench.py``. It builds (once, kept on disk) a
memmap-backed synthetic crowd database of 384×512 images, by default
1.25× the card's memory (``total_memory``), and trains the flagship
crowd step (224-px patches, batch 120, bfloat16, ``norm_impl="pallas"``:
the patch sampler and the fused norm kernels) with only a ``--window``
of each training split resident on the card
(``Settings.crowd_hbm_window``, ``data/window.py``), the rest streaming
through it.

The database must fit on the disk under ``--db-root``. When it does
not, the tool says so on a line of its own and runs at the largest size
that fits, with the window cut below each split if it would hold a
whole split.

It prints one JSON line: images/s, the refreshes applied in the timed
steps, the refresh rate and the time one full rotation of the database
through the window takes at that rate.

Usage:
    python -m srgan_tpu_torch.tools.window_bench [--total-gb GB]
        [--window 1024] [--slices 8] [--steps 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

H, W = 384, 512  # the flagship's database images
BYTES_PER_LABELED = H * W * 3 + H * W * 4  # u8 image + f32 density
BYTES_PER_UNLABELED = H * W * 3
CARD_MULTIPLE = 1.25  # the default database, in cards' memory
DISK_SHARE = 0.9      # of the free disk a database may take
_FILES = ("labeled_images", "labeled_density", "unlabeled_images")


def split_sizes(total_gb: float) -> Tuple[int, int]:
    """(labeled, unlabeled) examples of a database of ``total_gb``: the
    bytes split evenly between the labeled (image + density) and the
    unlabeled (image) split."""
    half = total_gb * 1e9 / 2
    return int(half // BYTES_PER_LABELED), int(half // BYTES_PER_UNLABELED)


def _paths(root: str) -> dict:
    return {k: os.path.join(root, f"{k}.npy") for k in _FILES}


def _existing_bytes(root: str) -> int:
    return sum(os.path.getsize(p) for p in _paths(root).values()
               if os.path.exists(p))


def plan_database(total_gb: Optional[float], root: str,
                  device: torch.device) -> Tuple[float, Optional[str]]:
    """The database size in GB, and a note when the disk cut it.

    ``total_gb`` None is ``CARD_MULTIPLE`` × the card's memory (a CUDA
    device only). The database may take ``DISK_SHARE`` of the free disk
    under ``root``, counting an earlier database there, which is
    rewritten."""
    card_gb = (torch.cuda.get_device_properties(device).total_memory / 1e9
               if device.type == "cuda" else None)
    if total_gb is None:
        if card_gb is None:
            raise ValueError("--total-gb is needed off a CUDA card (the "
                             "default is 1.25x the card's memory)")
        total_gb = CARD_MULTIPLE * card_gb
    probe = os.path.abspath(root)
    while not os.path.exists(probe):
        probe = os.path.dirname(probe)
    free = shutil.disk_usage(probe).free + _existing_bytes(root)
    usable_gb = DISK_SHARE * free / 1e9
    if total_gb <= usable_gb:
        return total_gb, None
    card = (f" ({usable_gb / card_gb:.3f}x the card's {card_gb:.1f} GB)"
            if card_gb else "")
    return usable_gb, (
        f"window_bench: the disk under {probe} has {free / 1e9:.1f} GB "
        f"free, too little for a {total_gb:.1f} GB database; running at "
        f"{usable_gb:.1f} GB{card}")


def build_database(root: str, total_gb: float) -> dict:
    """Create (or reuse) the memmap-backed synthetic splits on disk."""
    os.makedirs(root, exist_ok=True)
    n_lab, n_unl = split_sizes(total_gb)
    meta_path = os.path.join(root, "meta.json")
    paths = _paths(root)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta["n_lab"] == n_lab and meta["n_unl"] == n_unl:
            return {"n_lab": n_lab, "n_unl": n_unl, "paths": paths,
                    "build_seconds": 0.0}
        os.remove(meta_path)
    for path in paths.values():  # an earlier size's files
        if os.path.exists(path):
            os.remove(path)
    print(f"window_bench: building a {total_gb:.2f} GB synthetic database "
          f"({n_lab} labeled + {n_unl} unlabeled {H}x{W} images) under "
          f"{root} ...", file=sys.stderr, flush=True)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    chunk = 512

    def fill(path, dtype, shape, make):
        arr = np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                        shape=shape)
        for s in range(0, shape[0], chunk):
            e = min(s + chunk, shape[0])
            arr[s:e] = make(e - s)
        arr.flush()
        del arr

    def pixels(n):
        return np.frombuffer(rng.bytes(n * H * W * 3), np.uint8).reshape(
            n, H, W, 3)

    fill(paths["labeled_images"], np.uint8, (n_lab, H, W, 3), pixels)
    # Constant per-image density (mass = "head count"): throughput does
    # not depend on label content, and constants make counts exact.
    per_px = np.float32(20.0 / (H * W))
    fill(paths["labeled_density"], np.float32, (n_lab, H, W),
         lambda n: per_px)
    fill(paths["unlabeled_images"], np.uint8, (n_unl, H, W, 3), pixels)
    with open(meta_path, "w") as f:
        json.dump({"n_lab": n_lab, "n_unl": n_unl}, f)
    seconds = time.perf_counter() - t0
    print(f"window_bench: database built in {seconds:.0f} s",
          file=sys.stderr, flush=True)
    return {"n_lab": n_lab, "n_unl": n_unl, "paths": paths,
            "build_seconds": seconds}


def window_size(window: int, slices: int, db: dict) -> Tuple[int, Optional[str]]:
    """``window``, or when it would hold a whole split (a database cut
    to the disk), the largest multiple of ``slices`` below the smaller
    split, with a note."""
    smallest = min(db["n_lab"], db["n_unl"])
    if window < smallest:
        return window, None
    forced = (smallest - 1) // slices * slices
    if forced < slices:
        raise ValueError(f"a split of {smallest} examples is too small "
                         f"for a window of {slices} slices")
    return forced, (f"window_bench: a window of {window} would hold a "
                    f"whole split of {smallest}; forcing a window of "
                    f"{forced}")


def _load_split(images_path, density_path=None):
    from srgan_tpu_torch.data.crowd import CrowdDatabase

    images = np.load(images_path, mmap_mode="r")
    if density_path is not None:
        density = np.load(density_path, mmap_mode="r")
        counts = np.full(len(images), 20.0, np.float32)
    else:
        # The sampler never reads unlabeled density; a broadcast zero
        # view keeps the container honest without disk cost.
        density = np.broadcast_to(np.zeros((1, H, W), np.float32),
                                  images.shape[:3])
        counts = np.zeros(len(images), np.float32)
    return CrowdDatabase(images=images, density_maps=density,
                         head_counts=counts,
                         image_mean=np.full(3, 0.5, np.float32),
                         image_std=np.full(3, 0.3, np.float32))


def run_bench(args: argparse.Namespace, device: torch.device):
    """Build or reuse the database and time the steps: (the JSON
    result, the experiment, its settings). The experiment's inputs stay
    open; the caller closes it."""
    from srgan_tpu_torch.apps.crowd import CrowdExperiment
    from srgan_tpu_torch.data.crowd import synthetic_crowd_database
    from srgan_tpu_torch.settings import Settings
    from srgan_tpu_torch.train import init_train_state

    total_gb, disk_note = plan_database(args.total_gb, args.db_root, device)
    if disk_note:
        print(disk_note, flush=True)
    db = build_database(args.db_root, total_gb)
    window, window_note = window_size(args.window, args.slices, db)
    if window_note:
        print(window_note, flush=True)

    class WindowBenchExperiment(CrowdExperiment):
        """The flagship crowd experiment over the memmap-backed splits."""

        def _load_databases(self):
            labeled = _load_split(db["paths"]["labeled_images"],
                                  db["paths"]["labeled_density"])
            unlabeled = _load_split(db["paths"]["unlabeled_images"])
            validation = synthetic_crowd_database(
                2, height=H, width=W, max_heads=20, sigma=10.0,
                label_type="density", seed=7)
            return labeled, unlabeled, validation, validation

    settings = Settings(
        trial_name="window_bench", batch_size=args.batch,
        image_patch_size=args.patch, model_base_width=args.base_width,
        latent_dimension=100, steps_to_run=0, seed=0,
        compute_dtype="bfloat16", norm_impl="pallas",
        data_parallel_devices=1, crowd_hbm_window=window,
        crowd_window_slices=args.slices,
        crowd_window_refresh_period=args.refresh_period,
        crowd_label_dtype=args.label_dtype)
    exp = WindowBenchExperiment(settings, device=device)
    exp.dataset_setup()
    exp.models = exp.model_setup()
    exp.state = init_train_state(settings, exp.models)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    exp.prepare_train_step()  # includes the initial window uploads
    sync()
    upload_secs = time.perf_counter() - t0
    window_bytes = sum(a.numel() * a.element_size()
                       for w in exp._windows for a in w.arrays.values())
    print(f"window_bench: initial {window_bytes / 1e9:.2f} GB window "
          f"upload in {upload_secs:.1f} s "
          f"({window_bytes / 1e6 / upload_secs:.0f} MB/s)",
          file=sys.stderr, flush=True)

    # The production input path: epoch_batch_iterators refreshes the
    # windows before each step's sampling.
    epochs = exp.epoch_batch_iterators()
    batches = (b for epoch in epochs for b in epoch)

    def one_step():
        exp.state, metrics = exp._step(*next(batches))
        return metrics

    for _ in range(args.warmup):
        one_step()
    sync()
    refreshes_before = [w.refresh_count for w in exp._windows]
    start = time.perf_counter()
    for _ in range(args.steps):
        metrics = one_step()
    sync()
    elapsed = time.perf_counter() - start
    loss = float(metrics["d_total_loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"d_total_loss is {loss}")

    refreshes = [w.refresh_count - b
                 for w, b in zip(exp._windows, refreshes_before)]
    slice_bytes = [sum(a[0].numel() * a.element_size()
                       for a in w.arrays.values()) * w.slice_size
                   for w in exp._windows]
    refreshed_bytes = sum(r * b for r, b in zip(refreshes, slice_bytes))
    total_bytes = (db["n_lab"] * BYTES_PER_LABELED
                   + db["n_unl"] * BYTES_PER_UNLABELED)
    refresh_mb_s = refreshed_bytes / 1e6 / elapsed
    images_per_sec = args.batch * args.steps / elapsed
    card_bytes = (torch.cuda.get_device_properties(device).total_memory
                  if device.type == "cuda" else None)
    result = {
        "metric": "crowd_srgan_images_per_sec_window_tier",
        "value": images_per_sec,
        "unit": "images/sec",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "ms_per_step": 1e3 * elapsed / args.steps,
        "database_gb": total_bytes / 1e9,
        "database_vs_card": (total_bytes / card_bytes if card_bytes
                             else None),
        "disk_limited": disk_note is not None,
        "database_build_seconds": db["build_seconds"],
        "window_examples": window,
        "window_gb": window_bytes / 1e9,
        "initial_upload_seconds": upload_secs,
        "refreshes_in_timed_region": refreshes,
        "refresh_mb_per_sec": refresh_mb_s,
        "full_rotation_minutes": (total_bytes / 1e6 / refresh_mb_s / 60
                                  if refresh_mb_s > 0 else None),
    }
    return result, exp, settings


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--total-gb", type=float, default=None,
                        help="database size (default: 1.25x the card's "
                             "memory, or what the disk holds)")
    parser.add_argument("--window", type=int, default=1024)
    parser.add_argument("--slices", type=int, default=8)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--batch", type=int, default=120)
    parser.add_argument("--patch", type=int, default=224)
    parser.add_argument("--refresh-period", type=int, default=0,
                        help="0 = opportunistic (default)")
    parser.add_argument("--base-width", type=int, default=64)
    parser.add_argument("--label-dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="device dtype of the window's label maps "
                             "(Settings.crowd_label_dtype): bfloat16 "
                             "halves the labeled window and its refresh "
                             "slices")
    parser.add_argument("--db-root",
                        default=os.path.join("logs", "window_bench", "db"))
    parser.add_argument("--smoke", action="store_true",
                        help="1 GB DB, tiny window/steps/model")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to run on the "
                             "CPU")
    args = parser.parse_args(argv)
    if args.smoke:
        args.total_gb = min(args.total_gb or 1.0, 1.0)
        args.window, args.slices = 64, 4
        args.steps, args.warmup = 8, 2
        args.batch, args.patch = 16, 64
        args.base_width = 16
    return args


def main(argv: Optional[List[str]] = None) -> int:
    from srgan_tpu_torch.utils.device import default_device

    args = parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    result, exp, _ = run_bench(args, device)
    exp.close()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
