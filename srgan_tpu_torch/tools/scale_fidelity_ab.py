"""Measured A/B: resize-mode against native-resolution tiles (and the
random rescale), through the port.

The port of ``tools/scale_fidelity_ab.py``. A global fixed-resolution
resize changes head scale (UCF-QNRF sources are up to ~6000 px wide: a
512-wide resize shrinks heads up to ~12×). This tool measures the effect
end to end on synthetic high-resolution crowd data:

1. hi-res synthetic crowd images (default 768×1024, head blobs of σ 16
   native px) in the UCF-QNRF layout;
2. the same raw data preprocessed two ways: ``mode="resize"`` (global
   384×512, the density kernel on the card) and ``mode="tiles"`` (native
   384×512 tiles, ``image_ids`` for per-image evaluation);
3. identical configurations trained on each through
   ``CrowdExperiment(settings).train()``, and on the tiles with the
   random rescale (``crowd_rescale_factors``);
4. per-image validation MAE / NAE of D and the DNN per arm.

Usage:
    python -m srgan_tpu_torch.tools.scale_fidelity_ab [--steps N]
        [--seeds a b ...] [--device cpu]

Prints one JSON line per (arm, seed) and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

import numpy as np


def generate_raw_hires(root: str, split: str, count: int, height: int,
                       width: int, blob_sigma: float, max_heads: int,
                       seed: int) -> None:
    """Hi-res synthetic crowd raw data in the UCF-QNRF layout
    (``img_NNNN.jpg`` + ``img_NNNN_ann.mat['annPoints']`` (x, y)): the
    brightness-linear blob signal of ``synthetic_crowd_database``, at
    native scale."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    raw = os.path.join(root, split)
    os.makedirs(raw, exist_ok=True)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i in range(count):
        n = int(rng.integers(4, max_heads + 1))
        heads_yx = np.stack([rng.uniform(0, height, n),
                             rng.uniform(0, width, n)], axis=-1)
        blob = np.zeros((height, width), np.float32)
        for hy, hx in heads_yx:
            blob += np.exp(-((yy - hy) ** 2 + (xx - hx) ** 2)
                           / (2.0 * (2.5 * blob_sigma) ** 2))
        img = 40.0 + 140.0 * blob
        noise = rng.normal(0, 8.0, (height, width, 3))
        pixels = np.clip(img[..., None] + noise, 0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(
            os.path.join(raw, f"img_{i:04d}.jpg"), quality=95)
        heads_xy = heads_yx[:, ::-1]
        savemat(os.path.join(raw, f"img_{i:04d}_ann.mat"),
                {"annPoints": heads_xy})


def preprocess_all(raw_root: str, out_root: str, mode: str,
                   height: int, width: int, sigma: float,
                   device=None) -> None:
    from srgan_tpu_torch.data.crowd import UcfQnrfPreprocessor

    os.makedirs(out_root, exist_ok=True)
    pre = UcfQnrfPreprocessor(height=height, width=width, sigma=sigma,
                              mode=mode, device=device)
    for split in ("labeled", "unlabeled", "validation"):
        pre.preprocess(os.path.join(raw_root, split),
                       os.path.join(out_root, f"{split}.npz"))


def arm_settings(db_path: str, steps: int, seed: int, batch: int,
                 rescale: tuple = (), ul: float = 1.0, clip: float = 0.0):
    """The settings of one arm's run: the flagship widths."""
    from srgan_tpu_torch.settings import Settings

    return Settings(
        trial_name=f"ab_{os.path.basename(db_path)}_s{seed}",
        logs_directory=os.path.join(tempfile.gettempdir(), "srgan_ab"),
        batch_size=batch, image_patch_size=224, model_base_width=64,
        latent_dimension=100, compute_dtype="bfloat16",
        steps_to_run=steps, summary_step_period=max(1, steps // 4),
        # Tiny labeled splits make epochs 1 step long: validate on a step
        # period, not per epoch (a grid evaluation per step would swamp
        # the run).
        validation_step_period=max(1, steps // 2),
        crowd_database_path=db_path, seed=seed,
        unlabeled_loss_multiplier=ul, gradient_clip_norm=clip,
        crowd_rescale_factors=tuple(rescale))


def run_arm(db_path: str, steps: int, seed: int, batch: int,
            rescale: tuple = (), ul: float = 1.0, clip: float = 0.0,
            device=None) -> dict:
    from srgan_tpu_torch.apps.crowd import CrowdExperiment

    settings = arm_settings(db_path, steps, seed, batch, rescale, ul, clip)
    exp = CrowdExperiment(settings, device=device)
    exp.train()
    result = exp.evaluate()           # SR-GAN D (per-image aggregated)
    dnn = exp.evaluate(use_dnn=True)  # supervised baseline
    return {"MAE": result["MAE"], "NAE": result["NAE"],
            "dnn_MAE": dnn["MAE"], "dnn_NAE": dnn["NAE"]}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--batch", type=int, default=120)
    parser.add_argument("--images", type=int, default=8)
    parser.add_argument("--hires", type=int, nargs=2, default=[768, 1024])
    parser.add_argument("--work_dir", default=os.path.join(
        tempfile.gettempdir(), "srgan_ab_data"))
    parser.add_argument("--arms", nargs="+",
                        default=["resize", "tiles", "tiles_rescale"])
    parser.add_argument("--ul", type=float, default=1.0,
                        help="unlabeled_loss_multiplier (0.1 is the "
                             "measured win-regime value)")
    parser.add_argument("--gradient-clip", type=float, default=0.0,
                        help="Settings.gradient_clip_norm for every arm "
                             "(stabilizes the documented lr-1e-4 "
                             "supervised divergence; 0 = off)")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to run on the "
                             "CPU")
    args = parser.parse_args(argv)

    h, w = args.hires
    raw_root = os.path.join(args.work_dir, "raw")
    if not os.path.exists(os.path.join(raw_root, "validation")):
        for split, n, s in (("labeled", args.images, 1),
                            ("unlabeled", args.images, 2),
                            ("validation", 6, 3)):
            generate_raw_hires(raw_root, split, n, h, w,
                               blob_sigma=16.0, max_heads=24, seed=s)
    dbs = {}
    for mode in ("resize", "tiles"):
        out = os.path.join(args.work_dir, f"db_{mode}")
        if not os.path.exists(os.path.join(out, "validation.npz")):
            preprocess_all(raw_root, out, mode, 384, 512, sigma=8.0,
                           device=args.device)
        dbs[mode] = out

    summary = {}
    for arm in args.arms:
        mode = "tiles" if arm.startswith("tiles") else "resize"
        rescale = (0.75, 1.0, 1.25) if arm.endswith("rescale") else ()
        maes = []
        for seed in args.seeds:
            r = run_arm(dbs[mode], args.steps, seed, args.batch, rescale,
                        ul=args.ul, clip=args.gradient_clip,
                        device=args.device)
            print(json.dumps({"arm": arm, "seed": seed, **r}), flush=True)
            maes.append(r)
        summary[arm] = {k: float(np.mean([m[k] for m in maes]))
                        for k in maes[0]}
    print(json.dumps({"summary": summary, "steps": args.steps,
                      "seeds": args.seeds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
