"""``correct`` comes out false when the timed path is broken underneath:
whole runs of every cell at a tiny size on the CPU, the harness's look
for a card skipped, with a fault planted in the program before its first
step (``benchmark/study.py``'s ``PLANTS``): its optimizers take no step;
each step trains on the first half of its batch; one value of each
labeled batch altered where the input layer makes it; the gradient
penalty's second order lost; Adam's β₂ off. A cell on one card has no
exchange between cards to leave out. On the card (``gpu``), at each cell's
own size, the faults that its numbers catch there: all but the detached
penalty, whose first step reads as the sound runs do (PERF.md §2)."""

import time

import pytest
import torch

from benchmark import run, study
from benchmark.harness import check, spec
from benchmark.tests.conftest import CELLS, tiny_cell


def _run(name, plant=None):
    cell = tiny_cell(name)
    record = run.run_cell(cell, 2 ** 31 + 11, 0.5, False,
                          torch.device("cpu"), time.monotonic(), plant)
    return record, cell.workload["limits"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(study.PLANTS))
def test_a_planted_fault_makes_the_run_incorrect(name, fault):
    record, limits = _run(name, study.PLANTS[fault])
    assert not check.verdict(record.numbers, limits), record.numbers


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(set(study.PLANTS)
                                         - {"penalty_detached"}))
def test_a_planted_fault_is_caught_at_the_cells_size(name, fault, card):
    cell = spec.Cell(name)
    numbers = study.readings(cell, fault, 2 ** 31 + 404, card)
    assert not check.verdict(numbers, cell.workload["limits"]), numbers
