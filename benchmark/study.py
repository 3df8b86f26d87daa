"""The readings that the limits of ``correct`` are set from, on the card,
at a cell's own size, many seeds in one process.

    python3 -m benchmark.study --workload <cell> --mode <mode> \\
        --seeds <n> [<n> ...]

Modes:

* ``program``: the program as the configuration states it (its sound
  runs: the lower readings);
* ``control``: the reference computed one precision below the
  configuration's (``reference/quant.py``: fp8 for bfloat16, TF32 for
  float32) in its products, put in the program's place; its inputs
  are the reference's own batches, unrounded;
* ``unchanged``, ``half_batch``, ``patch_altered``,
  ``penalty_detached``, ``beta2_wrong``: a fault planted in the program
  (``PLANTS``): its optimizers take no step; each step trains on the
  first half of its batch alone; one value of each labeled batch
  altered where the input layer makes it; the gradient penalty taken on
  a detached input gradient, so that its second order is lost; Adam's
  β₂ ten times as far from 1 as the configuration's.

Each seed prints one JSON line of the numbers (``harness/check.py``).
The benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from benchmark import run
from benchmark.harness import check, session, spec
from benchmark.reference.quant import CONTROL_PRECISION


def _unchanged(exp) -> None:
    for opt in (exp.state.d_opt, exp.state.g_opt, exp.state.dnn_opt):
        opt.step = lambda grads: None


def _half_batch(exp) -> None:
    step = exp._train_step

    def half(state, lx, labels, ux, rng=None, z_d=None, z_g=None,
             alpha=None):
        h = lx.shape[0] // 2
        cut = lambda t: None if t is None else t[:h]  # noqa: E731
        return step(state, lx[:h], labels[:h], ux[:h], rng, z_d=cut(z_d),
                    z_g=cut(z_g), alpha=cut(alpha))

    exp._train_step = half


def _patch_altered(exp) -> None:
    sample = exp._sample_batch

    def altered(*args):
        lx, labels, ux = sample(*args)
        lx = lx.clone()
        lx[0, 0, 0, 0] += 0.5
        return lx, labels, ux

    exp._sample_batch = altered


def _penalty_detached(exp) -> None:
    from srgan_tpu_torch import losses
    step, penalty = exp._train_step, losses.gradient_penalty

    def detached(grads, *args, **kwargs):
        return penalty(grads.detach(), *args, **kwargs)

    def stepped(*args, **kwargs):
        losses.gradient_penalty = detached
        try:
            return step(*args, **kwargs)
        finally:
            losses.gradient_penalty = penalty

    exp._train_step = stepped


def _beta2_wrong(exp) -> None:
    for opt in (exp.state.d_opt, exp.state.g_opt, exp.state.dnn_opt):
        for group in opt.adam.param_groups:
            b1, b2 = group["betas"]
            group["betas"] = (b1, 1.0 - 10.0 * (1.0 - b2))


PLANTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "patch_altered": _patch_altered,
          "penalty_detached": _penalty_detached,
          "beta2_wrong": _beta2_wrong}


def control_numbers(cell, app, data, checked, seed, settings, device):
    """The control's numbers: the reference one precision below the
    configuration's, on the checked steps' inputs and draws, against the
    reference in float32."""
    precision = CONTROL_PRECISION[cell.config["counts"]["precision"]]
    ref, ref_inputs, start = run.reference_run(
        cell, app, data, checked.records, checked.draws, seed, settings,
        device)
    low, low_inputs, _ = run.reference_run(
        cell, app, data, checked.records, checked.draws, seed, settings,
        device, precision)
    host = lambda leaves: {m: {k: v.cpu() for k, v in named.items()}  # noqa
                           for m, named in leaves.items()}
    first = host(low["first_grads"])
    as_program = session.Checked(
        checked.records, low_inputs, checked.draws, low["losses"], first,
        {m: {k: v.square() for k, v in named.items()}
         for m, named in first.items()},
        host(low["weights"]), host(low["first_weights"]))
    return check.compare(as_program, ref, start, ref_inputs)


def details(checked, reference, start, top: int = 4) -> dict:
    """What the numbers are made of: each loss of each step (the
    program's, the reference's) and each model's leaves with the largest
    gaps of the first gradient and of the change."""
    out = {"losses": [{k: [got.get(k), r] for k, r in want.items()}
                      for got, want in zip(checked.losses,
                                           reference["losses"])]}
    keep = check.moving_leaves(reference["grad_norms"])
    pairs = {"grad": (checked.first_grads, reference["first_grads"], None),
             "change": (check.changes(checked.weights, start),
                        check.changes(reference["weights"], start), keep)}
    for what, (prog, ref, kept) in pairs.items():
        for m in ref:
            names = [k for k in ref[m] if kept is None or k in kept[m]]
            norms = {k: (float(prog[m][k].float().norm()),
                         float(ref[m][k].float().cpu().norm()))
                     for k in names}
            rows = sorted(norms.items(),
                          key=lambda kv: -abs(kv[1][0] - kv[1][1]))
            out[f"{what}.{m}"] = [[k, p, r] for k, (p, r) in rows[:top]]
            out[f"{what}.{m}.median_ref"] = sorted(
                r for _, r in norms.values())[len(norms) // 2]
    return out


def readings(cell: spec.Cell, mode: str, seed: int, device,
             detail: bool = False):
    logs = tempfile.mkdtemp(prefix="srgan_study_")
    try:
        exp, data, settings, checked = run.start_program(
            cell, seed, device, logs, PLANTS.get(mode))
        session.free(exp)
        del exp
        app = cell.app()
        if mode == "control":
            return control_numbers(cell, app, data, checked, seed, settings,
                                   device)
        if detail:
            got, inputs, start = run.reference_run(
                cell, app, data, checked.records, checked.draws, seed,
                settings, device)
            return {**check.compare(checked, got, start, inputs),
                    "details": details(checked, got, start)}
        return run.reference_numbers(cell, app, data, checked, seed,
                                     settings, device)
    finally:
        shutil.rmtree(logs, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.study")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", required=True,
                        choices=["program", "control", *PLANTS])
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--detail", action="store_true",
                        help="also print each loss and the worst leaves")
    args = parser.parse_args(argv)
    cell = spec.Cell(args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.monotonic()
        numbers = readings(cell, args.mode, seed, device, args.detail)
        print(json.dumps({"workload": cell.name, "mode": args.mode,
                          "seed": seed, "seconds": time.monotonic() - t0,
                          **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
