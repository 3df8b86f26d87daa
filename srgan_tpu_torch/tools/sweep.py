"""Semi-supervised regime sweep on the coefficient toy, through the port.

The port of ``tools/sweep.py``: a grid of (hyperparameter combination ×
seed) lanes, each trained through the port's own fused step,
``srgan_tpu_torch.train.make_gan_train_step(settings, hyper=...)``, with
the lane's loss multipliers and learning rate as its ``hyper``
overrides, then scored by the validation MAE of D and of the DNN. Rows,
flags and defaults are the JAX tool's.

The lanes run as a loop, combo-major and seed-minor: the port's step
takes ``torch.autograd.grad(create_graph=True)`` over ``nn.Module``s and
stateful optimizers, which ``torch.func.vmap`` does not batch. Each lane
draws its init (``generator_for(lane, "init")``, on the host) and its
with-replacement batch indices and step draws
(``generator_for(lane, "train")``, on the device) from generators seeded
by the lane's index, where the JAX tool folds jax.random keys; the data
are the JAX tool's NumPy draws.

Usage:
    python -m srgan_tpu_torch.tools.sweep --labeled-sizes 8 16 32 \\
        --seeds 5 --steps 3000 --out sweep_results.json [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from srgan_tpu_torch.data.coefficient import (OBSERVATION_COUNT,
                                              generate_coefficient_examples)
from srgan_tpu_torch.models.mlp import CoefficientGenerator, CoefficientMLP
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import (ModelBundle, SRGANTrainState,
                                   init_train_state, make_gan_train_step,
                                   set_float32_precision)
from srgan_tpu_torch.utils.device import default_device
from srgan_tpu_torch.utils.seeding import generator_for


class HP(NamedTuple):
    """One lane's hyperparameters: the step's ``hyper`` overrides."""
    unlabeled_loss_multiplier: float
    fake_loss_multiplier: float
    gradient_penalty_multiplier: float
    learning_rate: float


def init_lane(settings: Settings, lane: int,
              device: torch.device) -> SRGANTrainState:
    """D, G and the DNN drawn in turn from the lane's init stream, and
    their optimizers."""
    rng = generator_for(lane, "init")
    hidden = settings.hidden_size
    models = ModelBundle(
        d=CoefficientMLP(OBSERVATION_COUNT, hidden, rng=rng),
        g=CoefficientGenerator(settings.latent_dimension, OBSERVATION_COUNT,
                               hidden, rng=rng),
        dnn=CoefficientMLP(OBSERVATION_COUNT, hidden, rng=rng))
    models = ModelBundle(*(m.to(device) for m in
                           (models.d, models.g, models.dnn)))
    return init_train_state(settings, models)


def train_lane(settings: Settings, hp: HP, lab_x: torch.Tensor,
               lab_y: torch.Tensor, unl_x: torch.Tensor, lane: int,
               steps: int) -> SRGANTrainState:
    """One lane: ``steps`` steps of the shipped fused step with ``hp``,
    each on a labeled and an unlabeled batch drawn with replacement."""
    device = lab_x.device
    state = init_lane(settings, lane, device)
    step_fn = make_gan_train_step(settings, hyper=hp._asdict())
    rng = generator_for(lane, "train", device)
    batch = settings.batch_size
    for _ in range(steps):
        lab_idx = torch.randint(0, len(lab_x), (batch,), generator=rng,
                                device=device)
        unl_idx = torch.randint(0, len(unl_x), (batch,), generator=rng,
                                device=device)
        state, _ = step_fn(state, lab_x[lab_idx], lab_y[lab_idx],
                           unl_x[unl_idx], rng)
    return state


def build_sweep(batch_size: int, steps: int, hidden_size: int,
                latent_dimension: int, mean_offset: float = 0.0,
                adam_b1: float = 0.9, adam_b2: float = 0.999):
    """The (lanes → final validation MAEs) sweep: ``sweep(hps, lab_x,
    lab_y, unl_x, lanes, val_x, val_y) -> (d_mae [R], dnn_mae [R])``,
    lane i trained by :func:`train_lane` on ``lab_x[i]``, ``lab_y[i]``
    and ``unl_x[i]`` with ``hps[i]`` and the streams of ``lanes[i]``."""
    settings = Settings(batch_size=batch_size, hidden_size=hidden_size,
                        latent_dimension=latent_dimension,
                        mean_offset=mean_offset, adam_b1=adam_b1,
                        adam_b2=adam_b2)

    def sweep(hps, lab_x, lab_y, unl_x, lanes, val_x, val_y):
        d_mae, dnn_mae = np.zeros(len(hps)), np.zeros(len(hps))
        for i, (hp, lane) in enumerate(zip(hps, lanes)):
            state = train_lane(settings, hp, lab_x[i], lab_y[i], unl_x[i],
                               lane, steps)
            with torch.inference_mode():
                d_pred, _ = state.d(val_x)
                dnn_pred, _ = state.dnn(val_x)
                d_mae[i] = float((d_pred - val_y).abs().mean())
                dnn_mae[i] = float((dnn_pred - val_y).abs().mean())
        return d_mae, dnn_mae

    return sweep


def run_grid(labeled_size: int, steps: int, n_seeds: int,
             unlabeled_size: int, batch_size: int, hidden_size: int,
             latent_dimension: int, grid: dict, mean_offset: float = 0.0,
             device: Optional[torch.device] = None) -> list:
    """Train the full (grid × seeds) lane set for one labeled size."""
    device = torch.device(device) if device is not None \
        else default_device()
    set_float32_precision()
    combos = [dict(zip(grid, values))
              for values in itertools.product(*grid.values())]
    n_runs = len(combos) * n_seeds
    print(f"[labeled={labeled_size}] {len(combos)} combos x {n_seeds} seeds "
          f"= {n_runs} lanes, {steps} steps each", flush=True)

    # Per-seed datasets (coefficient_datasets' generator), shared across
    # combos; one large shared validation set keeps eval noise low.
    seed_data = []
    for seed in range(n_seeds):
        rng = np.random.default_rng(seed)
        lab_x, lab_y = generate_coefficient_examples(labeled_size, rng)
        unl_x, _ = generate_coefficient_examples(
            unlabeled_size, rng, mean_offset=mean_offset)
        seed_data.append(tuple(torch.from_numpy(a).to(device)
                               for a in (lab_x, lab_y, unl_x)))
    val_x, val_y = (torch.from_numpy(a).to(device) for a in
                    generate_coefficient_examples(
                        2000, np.random.default_rng(10_000)))

    # Lane layout: combo-major, seed-minor.
    lane_seeds = [seed for _ in combos for seed in range(n_seeds)]
    hps = [HP(**{k: float(v) for k, v in c.items()})
           for c in combos for _ in range(n_seeds)]
    lab_x, lab_y, unl_x = ([seed_data[s][k] for s in lane_seeds]
                           for k in range(3))
    sweep = build_sweep(batch_size, steps, hidden_size, latent_dimension,
                        mean_offset=mean_offset)
    start = time.perf_counter()
    d_mae, dnn_mae = sweep(hps, lab_x, lab_y, unl_x, range(n_runs), val_x,
                           val_y)
    seconds = time.perf_counter() - start
    print(f"[labeled={labeled_size}] {n_runs} lanes x {steps} steps in "
          f"{seconds:.3f} s on {device_name(device)}: "
          f"{1e3 * seconds / max(1, n_runs * steps):.4f} ms per lane-step",
          flush=True)

    results = []
    for i, combo in enumerate(combos):
        d = d_mae[i * n_seeds:(i + 1) * n_seeds]
        dnn = dnn_mae[i * n_seeds:(i + 1) * n_seeds]
        results.append({
            "labeled_size": labeled_size, "steps": steps,
            "mean_offset": mean_offset, **combo,
            "gan_mae_mean": float(np.mean(d)),
            "gan_mae_std": float(np.std(d)),
            "dnn_mae_mean": float(np.mean(dnn)),
            "dnn_mae_std": float(np.std(dnn)),
            "gan_wins": int(np.sum(d < dnn)), "seeds": n_seeds,
            "gan_mae_per_seed": [float(v) for v in d],
            "dnn_mae_per_seed": [float(v) for v in dnn],
        })
    return results


def device_name(device: torch.device) -> str:
    """The card's name, or the device type off the card."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--labeled-sizes", type=int, nargs="+",
                        default=[8, 16, 32])
    parser.add_argument("--seeds", type=int, default=5)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--unlabeled-size", type=int, default=5000)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--hidden-size", type=int, default=10)
    parser.add_argument("--latent-dimension", type=int, default=10)
    parser.add_argument("--ul", type=float, nargs="+",
                        default=[1e-2, 1e-1, 1e0, 1e1])
    parser.add_argument("--fl", type=float, nargs="+",
                        default=[1e-2, 1e-1, 1e0, 1e1])
    parser.add_argument("--gp", type=float, nargs="+", default=[1e0, 1e1])
    parser.add_argument("--lr", type=float, nargs="+", default=[1e-3, 1e-4])
    parser.add_argument("--mean-offset", type=float, default=0.0,
                        help="offset of the unlabeled population and the "
                             "z mixture (distribution-shift robustness)")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to run on the "
                             "CPU")
    args = parser.parse_args(argv)

    device = torch.device(args.device) if args.device else default_device()
    grid = {"unlabeled_loss_multiplier": args.ul,
            "fake_loss_multiplier": args.fl,
            "gradient_penalty_multiplier": args.gp,
            "learning_rate": args.lr}
    all_results = []
    for labeled_size in args.labeled_sizes:
        all_results.extend(run_grid(
            labeled_size, args.steps, args.seeds, args.unlabeled_size,
            args.batch_size, args.hidden_size, args.latent_dimension, grid,
            mean_offset=args.mean_offset, device=device))

    all_results.sort(key=lambda r: r["gan_mae_mean"] - r["dnn_mae_mean"])
    print(f"\n{'labeled':>7} {'ul':>8} {'fl':>8} {'gp':>6} {'lr':>8} "
          f"{'GAN mae':>9} {'DNN mae':>9} {'wins':>5}")
    for r in all_results[:25]:
        print(f"{r['labeled_size']:>7} {r['unlabeled_loss_multiplier']:>8g} "
              f"{r['fake_loss_multiplier']:>8g} "
              f"{r['gradient_penalty_multiplier']:>6g} "
              f"{r['learning_rate']:>8g} "
              f"{r['gan_mae_mean']:>6.4f}±{r['gan_mae_std']:.3f} "
              f"{r['dnn_mae_mean']:>6.4f}±{r['dnn_mae_std']:.3f} "
              f"{r['gan_wins']:>3}/{r['seeds']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(all_results, f, indent=1)
        print(f"\nwrote {len(all_results)} rows to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
