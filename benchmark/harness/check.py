"""Holding the program's checked steps to the reference.

The numbers, each compared where the workload file gives it a limit:

* ``input_gap``: the largest absolute difference between the batches the
  program's input layer made for the checked steps and the reference's;
* ``loss_gap``: the largest relative difference of a loss of the first
  step, where both sides start from the same weights;
* ``grad_gap``: the first step's gradient, leaf by leaf: the gap between
  the program's norm (from its Adam state) and the reference's, over the
  larger of the reference's norm of that leaf and of the model's median
  leaf; the median leaf's gap, of the model where it is largest;
* ``grad_sq_gap``: the same of the first gradient's square, the
  program's from its Adam's second moment over (1 − β₂): it holds the
  program to the configuration's β₂, which the first step's move does
  not show (Adam's first move is lr·g/|g| whatever β₂ is);
* ``change_gap``: the same measure of each leaf's change over the checked
  steps, over the leaves whose gradient in the reference reaches, in
  some checked step, a thousandth of the model's median leaf's (the
  others, biases before a GroupNorm, move under Adam by rounding alone).

* ``change_gap.first_step``: the worst leaf's gap of the change over the
  first step alone, where both sides start from the same weights.

Beside them, the same measures taken wide, for the record: the losses of
every checked step (``loss_gap.all_steps``) and the worst leaf
(``grad_gap.worst_leaf``, ``change_gap.worst_leaf``). In the bfloat16
flagship these, and the change over three steps, swing from seed to seed
by the nature of the step: the count head's bias gradient is a
difference of near-equal sums, and from the second step the count
head's first moves overshoot, so that the losses of steps 2 and 3 and
the moves they drive follow the rounding (PERF.md).

A number that cannot be read (a missing leaf or step, a NaN) reads
infinity.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

Leaves = Dict[str, Dict[str, torch.Tensor]]

QUIET_LEAF = 1e-3  # a leaf's gradient under this share of the median's


def _worst(gaps) -> float:
    """The largest gap; infinity if any is NaN or infinite (``max``
    alone would pass a NaN over)."""
    worst = 0.0
    for gap in gaps:
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def input_gap(program: List[tuple], reference: List[tuple]) -> float:
    gaps = []
    for got, want in zip(program, reference):
        for g, w in zip(got, want):
            if g.shape != w.shape:
                return math.inf
            gaps.append(float((g.float() - w.float().cpu()).abs().max()))
    return _worst(gaps) if len(program) == len(reference) else math.inf


def loss_gap(program: List[Dict[str, float]],
             reference: List[Dict[str, float]]) -> float:
    """The largest relative gap of any loss of any of the steps given."""
    gaps = [abs(got.get(name, math.nan) - r) / max(abs(r), 1e-12)
            for got, want in zip(program, reference)
            for name, r in want.items()]
    return _worst(gaps) if len(program) == len(reference) else math.inf


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in leaves.items()}


def leaf_gaps(program: Leaves, reference: Leaves,
              keep: Dict[str, set] = None) -> Dict[str, List[float]]:
    """Each model's leaves' |‖p‖ − ‖r‖| / max(‖r‖, the median leaf's
    ‖r‖), over its leaves (those in ``keep`` where it is given); the
    median is of the leaves whose ‖r‖ is not 0 (a model whose trunk has
    no gradient yet behind zero heads has many). A missing leaf reads
    NaN."""
    out = {}
    for m, ref_leaves in reference.items():
        gaps = out[m] = []
        names = [k for k in ref_leaves if keep is None or k in keep[m]]
        r = _norms({k: ref_leaves[k] for k in names})
        moving = [n for n in r.values() if n > 0.0]
        median = statistics.median(moving) if moving else 0.0
        for k in names:
            got = program.get(m, {}).get(k)
            gaps.append(math.nan if got is None else
                        abs(float(got.float().norm()) - r[k])
                        / max(r[k], median, 1e-30))
    return out


def worst_leaf(gaps: Dict[str, List[float]]) -> float:
    return _worst(g for leaves in gaps.values() for g in leaves)


def median_leaf(gaps: Dict[str, List[float]]) -> float:
    """The median leaf's gap of the model where it is largest."""
    medians = []
    for leaves in gaps.values():
        if any(not math.isfinite(g) for g in leaves):
            return math.inf
        medians.append(statistics.median(leaves) if leaves else 0.0)
    return _worst(medians)


def moving_leaves(grad_norms: List[Dict[str, Dict[str, float]]]
                  ) -> Dict[str, set]:
    """Each model's leaves whose largest gradient norm over the
    reference's steps is at least ``QUIET_LEAF`` of the median leaf's:
    a bias before a GroupNorm, whose gradient is nought but for
    rounding, is left out."""
    out = {}
    for m in grad_norms[0]:
        peak = {k: max(step[m][k] for step in grad_norms)
                for k in grad_norms[0][m]}
        median = statistics.median(peak.values())
        out[m] = {k for k, n in peak.items() if n >= QUIET_LEAF * median}
    return out


def changes(after: Leaves, before: Leaves) -> Leaves:
    return {m: {k: after[m][k].float().cpu() - before[m][k].float().cpu()
                for k in before[m] if k in after.get(m, {})}
            for m in before}


def compare(program, reference: Dict, start: Leaves,
            reference_inputs: List[tuple]) -> Dict[str, float]:
    """The numbers of ``program`` (a ``session.Checked``) against
    ``reference`` (``step.run_steps``' result from ``start``)."""
    keep = moving_leaves(reference["grad_norms"])
    first = {m: {k: v.float().cpu() for k, v in leaves.items()}
             for m, leaves in reference["first_grads"].items()}
    grads = leaf_gaps(program.first_grads, first)
    squares = leaf_gaps(program.first_grad_squares,
                        {m: {k: v.square() for k, v in leaves.items()}
                         for m, leaves in first.items()})
    change = leaf_gaps(changes(program.weights, start),
                       changes(reference["weights"], start), keep)
    return {
        "input_gap": input_gap(program.inputs, reference_inputs),
        "loss_gap": loss_gap(program.losses[:1], reference["losses"][:1]),
        "grad_gap": median_leaf(grads),
        "grad_sq_gap": median_leaf(squares),
        "change_gap": median_leaf(change),
        "change_gap.first_step": worst_leaf(leaf_gaps(
            changes(program.first_weights, start),
            changes(reference["first_weights"], start), keep)),
        "loss_gap.all_steps": loss_gap(program.losses, reference["losses"]),
        "grad_gap.worst_leaf": worst_leaf(grads),
        "change_gap.worst_leaf": worst_leaf(change),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
