"""Real-scale end-to-end training rehearsal through the port's command
lines.

The port of ``tools/real_scale_cli_rehearsal.py``: the chain a UCF-QNRF
user runs — raw native-resolution images and ``.mat`` annotations →
``python -m srgan_tpu_torch.data.crowd --mode tiles`` → a multi-GB npz
database → ``python -m srgan_tpu_torch crowd --crowd_database_path ...``
with the window tier → grid evaluation — end to end at realistic array
sizes:

1. ``--images`` native-resolution (default 3000×4000) raw images with
   windowed blob rendering, timed;
2. each split through the preprocessing command line in tiles mode,
   timed (the npz writes included);
3. ``--steps`` steps of the flagship widths through the training command
   line on one card (``--data_parallel_devices 1``) with
   ``--crowd_hbm_window``, then its grid evaluation: the command line's
   JSON result and the trial's throughput scalars;
4. one JSON report (database size, stage times, steady images/s,
   validation metrics).

Both command lines run on the card unless ``--device cpu`` is given.

Usage:
    python -m srgan_tpu_torch.tools.real_scale_cli_rehearsal
        [--images 100] [--steps 400] [--keep] [--skip-train]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def generate_raw_fast(root: str, split: str, count: int, height: int,
                      width: int, blob_sigma: float, max_heads: int,
                      seed: int) -> None:
    """Native-resolution raw crowd images in the UCF-QNRF layout, each
    head a ±3σ window of the blob (the full-image form costs about a
    minute per 3000×4000 image)."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    raw = os.path.join(root, split)
    os.makedirs(raw, exist_ok=True)
    r = int(3 * blob_sigma)
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1].astype(np.float32)
    kernel = np.exp(-(yy ** 2 + xx ** 2) / (2.0 * blob_sigma ** 2))
    for i in range(count):
        n = int(rng.integers(8, max_heads + 1))
        heads_yx = np.stack([rng.uniform(0, height, n),
                             rng.uniform(0, width, n)], axis=-1)
        canvas = np.zeros((height, width), np.float32)
        for hy, hx in heads_yx:
            cy, cx = int(round(hy)), int(round(hx))
            y0, y1 = max(0, cy - r), min(height, cy + r + 1)
            x0, x1 = max(0, cx - r), min(width, cx + r + 1)
            canvas[y0:y1, x0:x1] += kernel[y0 - cy + r:y1 - cy + r,
                                           x0 - cx + r:x1 - cx + r]
        pixels = (40.0 + 140.0 * np.clip(canvas, 0, 1.2))
        noise = rng.integers(0, 16, (height, width, 1), dtype=np.uint8)
        u8 = np.clip(pixels[..., None] + noise, 0, 255).astype(np.uint8)
        u8 = np.repeat(u8, 3, axis=-1)
        Image.fromarray(u8).save(os.path.join(raw, f"img_{i:04d}.jpg"),
                                 quality=90)
        savemat(os.path.join(raw, f"img_{i:04d}_ann.mat"),
                {"annPoints": heads_yx[:, ::-1]})  # (x, y) convention


def _device_flag(device: Optional[str]) -> List[str]:
    return ["--device", device] if device else []


def train_command(args: argparse.Namespace, db_root: str,
                  logs: str) -> List[str]:
    """The training command line: the flagship widths on one card, the
    window tier, validation at the last step."""
    return [sys.executable, "-m", "srgan_tpu_torch", "crowd",
            "--crowd_database_path", db_root,
            "--crowd_hbm_window", str(args.window),
            "--batch_size", str(args.batch),
            "--image_patch_size", "224",
            "--model_base_width", "64",
            "--latent_dimension", "100",
            "--compute_dtype", "bfloat16",
            "--steps_to_run", str(args.steps),
            "--summary_step_period", "50",
            "--validation_step_period", str(args.steps),
            "--gradient_clip_norm", str(args.clip),
            "--unlabeled_loss_multiplier", str(args.ul),
            "--data_parallel_devices", "1",
            "--trial_name", "cli_rehearsal",
            "--logs_directory", logs] + _device_flag(args.device)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--images", type=int, default=100,
                        help="labeled source images (unlabeled gets half,"
                             " validation 6)")
    parser.add_argument("--size", type=int, nargs=2, default=[3000, 4000])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--window", type=int, default=1024)
    parser.add_argument("--batch", type=int, default=120)
    parser.add_argument("--clip", type=float, default=0.0,
                        help="Settings.gradient_clip_norm (1.0 stabilizes "
                             "the documented no-clip count-head "
                             "divergence; 0 = off)")
    parser.add_argument("--ul", type=float, default=1.0,
                        help="unlabeled_loss_multiplier")
    parser.add_argument("--work-dir",
                        default=os.path.join("logs", "cli_rehearsal"))
    parser.add_argument("--keep", action="store_true")
    parser.add_argument("--skip-gen", action="store_true",
                        help="reuse an existing raw/db tree")
    parser.add_argument("--skip-train", action="store_true")
    parser.add_argument("--device", default=None,
                        help="both command lines' device (default: the "
                             "CUDA card; 'cpu' to run on the CPU)")
    return parser.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The stages; the report."""
    h, w = args.size
    work_dir = os.path.abspath(args.work_dir)
    raw_root = os.path.join(work_dir, "raw")
    db_root = os.path.join(work_dir, "db")
    report = {"source_images": args.images, "source_size": [h, w]}
    # The subprocesses import this checkout's package.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    try:
        if not args.skip_gen or not os.path.exists(
                os.path.join(db_root, "validation.npz")):
            t0 = time.perf_counter()
            for split, n, s in (("labeled", args.images, 1),
                                ("unlabeled", args.images // 2, 2),
                                ("validation", 6, 3)):
                generate_raw_fast(raw_root, split, n, h, w,
                                  blob_sigma=24.0, max_heads=48, seed=s)
            report["generate_secs"] = time.perf_counter() - t0

            # Stage 2: the preprocessing command line, per split.
            os.makedirs(db_root, exist_ok=True)
            t0 = time.perf_counter()
            for split in ("labeled", "unlabeled", "validation"):
                proc = subprocess.run(
                    [sys.executable, "-m", "srgan_tpu_torch.data.crowd",
                     os.path.join(raw_root, split),
                     os.path.join(db_root, f"{split}.npz"),
                     "--mode", "tiles"] + _device_flag(args.device),
                    cwd=REPO, env=env, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise SystemExit(f"preprocess CLI failed for {split}:"
                                     f"\n{proc.stdout}\n{proc.stderr}")
                print(proc.stdout.strip(), file=sys.stderr, flush=True)
            report["preprocess_secs"] = time.perf_counter() - t0
        report["db_gb"] = sum(
            os.path.getsize(os.path.join(db_root, f))
            for f in os.listdir(db_root) if f.endswith(".npz")) / 1e9

        if args.skip_train:
            return report

        # Stage 3: the training command line, window tier, one card.
        logs = os.path.join(work_dir, "logs")
        t0 = time.perf_counter()
        proc = subprocess.run(
            train_command(args, db_root, logs),
            cwd=REPO, env=env, capture_output=True, text=True)
        report["train_wall_secs"] = time.perf_counter() - t0
        # The command line's one-line JSON result is the last stdout line.
        if proc.returncode != 0:
            raise SystemExit(f"training CLI failed:\n"
                             f"{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
        cli_result = json.loads(proc.stdout.strip().splitlines()[-1])
        report["validation"] = cli_result["validation"]
        for line in proc.stderr.splitlines():
            if "UserWarning" in line and "device memory" in line:
                report["budget_warning"] = line.strip()

        # Steady-state throughput from the trial's scalars.
        trial = cli_result["trial_directory"]
        scalars = os.path.join(trial, "GAN", "scalars.jsonl")
        rates = []
        if os.path.exists(scalars):  # 0-step runs write no scalars
            with open(scalars) as f:
                for line in f:
                    row = json.loads(line)
                    if row.get("tag") == "throughput/examples_per_second":
                        rates.append(row["value"])
        if rates:
            report["steady_images_per_sec"] = float(
                np.median(rates[1:] or rates))
            report["throughput_samples"] = rates
        # Clean up only on success: the raw/db tree is what --skip-gen
        # reuses and what a failure's post-mortem needs.
        if not args.keep:
            shutil.rmtree(work_dir, ignore_errors=True)
        return report
    except BaseException:
        print(f"leaving work tree for inspection/--skip-gen reuse: "
              f"{work_dir}", file=sys.stderr)
        raise


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(run(parse_args(argv)), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
