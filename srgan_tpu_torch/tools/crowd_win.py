"""Re-measure the crowd few-label GAN-vs-DNN comparison, through the port.

The port of ``tools/crowd_win.py``: 4 labeled + 64 unlabeled synthetic
crowd images, 64-px patches, JointCNN of base width 32, 3000 steps, ul
0.1 / fl 1 / gp 10 / lr 1e-4, bfloat16, under the current defaults
(``zero_init_heads`` on; ``gradient_clip_norm`` by flag), each seed
trained through ``CrowdExperiment(settings).train()`` and evaluated for
D and the DNN beside the naive labeled-mean predictor.

Usage:
    python -m srgan_tpu_torch.tools.crowd_win [--steps N] [--seeds a b ...]
        [--gradient-clip C] [--ul U] [--device cpu]

Prints one JSON line per seed and a summary line with per-arm means, win
counts and the naive predictor's MAE for scale.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

import numpy as np


def naive_mae(exp) -> float:
    """MAE of predicting the labeled-set mean count on validation,
    computed from the trained experiment's own splits."""
    predictor = float(exp.labeled_db.per_image_counts(
        exp.labeled_db.roi_head_counts()).mean())
    val = exp.validation_db.per_image_counts(
        exp.validation_db.roi_head_counts())
    return float(np.abs(val - predictor).mean())


def seed_settings(seed: int, steps: int, ul: float, clip: float,
                  batch: int, labeled: int, unlabeled: int):
    """The settings of one seed's run."""
    from srgan_tpu_torch.settings import Settings

    return Settings(
        trial_name=f"crowdwin_l{labeled}_s{seed}",
        logs_directory=os.path.join(tempfile.gettempdir(), "srgan_crowdwin"),
        batch_size=batch, image_patch_size=64, model_base_width=32,
        compute_dtype="bfloat16", steps_to_run=steps,
        summary_step_period=max(1, steps // 4),
        validation_step_period=max(1, steps // 2),
        labeled_dataset_size=labeled, unlabeled_dataset_size=unlabeled,
        validation_dataset_size=32, test_dataset_size=32,
        learning_rate=1e-4, unlabeled_loss_multiplier=ul,
        fake_loss_multiplier=1.0, gradient_penalty_multiplier=10.0,
        gradient_clip_norm=clip, seed=seed)


def run_seed(seed: int, steps: int, ul: float, clip: float,
             batch: int, labeled: int = 4, unlabeled: int = 64,
             device=None) -> dict:
    from srgan_tpu_torch.apps.crowd import CrowdExperiment

    settings = seed_settings(seed, steps, ul, clip, batch, labeled,
                             unlabeled)
    exp = CrowdExperiment(settings, device=device)
    exp.train()
    gan = exp.evaluate()
    dnn = exp.evaluate(use_dnn=True)
    return {"seed": seed, "MAE": gan["MAE"], "dnn_MAE": dnn["MAE"],
            "NAE": gan["NAE"], "dnn_NAE": dnn["NAE"],
            "naive_MAE": naive_mae(exp)}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[0, 1, 2, 3, 4, 5])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--labeled", type=int, default=4)
    parser.add_argument("--unlabeled", type=int, default=64)
    parser.add_argument("--ul", type=float, default=0.1,
                        help="win-regime unlabeled multiplier")
    parser.add_argument("--gradient-clip", type=float, default=0.0)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to run on the "
                             "CPU")
    args = parser.parse_args(argv)

    rows = []
    for seed in args.seeds:
        r = run_seed(seed, args.steps, args.ul, args.gradient_clip,
                     args.batch, labeled=args.labeled,
                     unlabeled=args.unlabeled, device=args.device)
        print(json.dumps(r), flush=True)
        rows.append(r)
    wins = sum(1 for r in rows if r["MAE"] < r["dnn_MAE"])
    summary = {k: float(np.mean([r[k] for r in rows]))
               for k in ("MAE", "dnn_MAE", "NAE", "dnn_NAE", "naive_MAE")}
    summary["gan_wins"] = f"{wins}/{len(rows)}"
    summary["gan_median_MAE"] = float(np.median([r["MAE"] for r in rows]))
    summary["dnn_median_MAE"] = float(
        np.median([r["dnn_MAE"] for r in rows]))
    print(json.dumps({"summary": summary, "steps": args.steps,
                      "labeled": args.labeled, "ul": args.ul,
                      "clip": args.gradient_clip}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
