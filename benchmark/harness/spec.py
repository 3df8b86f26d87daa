"""Finding a cell's files by name, and the small rules every run keeps.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its files:

* ``benchmark/workloads/<cell>.json``: the configuration's name, the
  settings it changes, the warm-up and profiled steps, the limits of the
  comparison;
* ``benchmark/configs/<config>.json`` (the configuration's ``file`` in
  ``BENCHMARK.json``): the application, its settings, its data, its
  counts;
* ``benchmark/apps/<app>.py``: the data, the loading hook and the
  reference's models of one application of the program;
* ``benchmark/metrics/<metric>.py``: one reader per metric, a function
  ``read(run)`` returning a number, or None where it finds nothing.

Nothing here holds a list of cells, configurations or metrics.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
from typing import Callable, Dict, Iterable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Whole top-level module names that no run may load: the JAX package and
# its libraries. The program's own name begins with one of them, so the
# names are compared whole.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "srgan_tpu")


def forbidden_loaded(modules: Iterable[str]) -> List[str]:
    """The names in ``modules`` whose part before the first dot is one of
    ``FORBIDDEN_MODULES``."""
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.benchmark = load_benchmark(root)
        entries = {w["name"]: w for w in self.benchmark["workloads"]}
        if name not in entries:
            raise ValueError(f"{name!r} is not a workload of "
                             f"BENCHMARK.json: {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.workload = load_json(os.path.join(
            root, "benchmark", "workloads", f"{name}.json"))
        if self.workload["config"] != self.entry["config"]:
            raise ValueError(
                f"{name}: the workload file names configuration "
                f"{self.workload['config']!r}, BENCHMARK.json "
                f"{self.entry['config']!r}")
        files = {c["name"]: c["file"] for c in self.benchmark["configs"]}
        self.config = load_json(os.path.join(root,
                                             files[self.entry["config"]]))

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, kind: str) -> List[Dict]:
        """The ``kind`` ("end_to_end" or "per_layer") metrics that this
        cell reports: those without a ``workloads`` key, and those that
        list it."""
        return [m for m in self.benchmark[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def settings(self) -> Dict:
        """The program's settings: the configuration's, then the
        workload's over them."""
        merged = dict(self.config["settings"])
        merged.update(self.workload.get("settings", {}))
        return merged

    def app(self):
        """The module of the configuration's application."""
        return importlib.import_module(f"benchmark.apps.{self.config['app']}")


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, kind: str, run, root: str = ROOT
                 ) -> Dict[str, Dict]:
    """{name: {"value", "unit"}} of every metric of ``kind`` that this
    cell reports and whose reader finds something in ``run``."""
    out = {}
    for metric in cell.metrics(kind):
        value = metric_reader(metric["name"], root)(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def percentile(values: List[float], q: int) -> float:
    """The ``q``-th percentile, interpolated between the order statistics
    (``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def step_gaps_ms(event_ms: List[float]) -> List[float]:
    """Each step's time from the CUDA events recorded after consecutive
    steps: ``event_ms[i]`` is the time of event i since the event
    recorded as the window opened."""
    times, last = [], 0.0
    for t in event_ms:
        times.append(t - last)
        last = t
    return times


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict, device: Dict, checks: Dict,
                breakdown: Optional[Dict] = None) -> str:
    """The last line of a run's standard output; ``checks`` (each number
    compared, with its limit) comes last."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def jax_guard() -> List[str]:
    """The forbidden modules this process has loaded."""
    return forbidden_loaded(list(sys.modules))
