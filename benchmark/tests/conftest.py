"""Shared pieces of the benchmark's tests: the cells of BENCHMARK.json cut
to the size their configuration file gives under ``tiny``, which the CPU
runs in seconds (its compute is float32, so that sound runs read the
reference to rounding; the control stays one precision below the
configuration's own), and the card's fixture (tests marked ``gpu`` skip
where ``torch.cuda.is_available()`` is false, decided inside the
fixture)."""

import copy

import pytest
import torch

from benchmark.harness import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.Cell(name)
    cell.config = copy.deepcopy(cell.config)
    tiny = cell.config["tiny"]
    cell.config["settings"].update(tiny["settings"])
    cell.config["data"].update(tiny["data"])
    cell.workload = dict(cell.workload, profile_steps=3)
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
