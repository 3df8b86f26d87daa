"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from host spans and ``torch.profiler`` over the window's last steps.
A run needs as many CUDA cards as its cell asks for, and fails, printing
no result, without them, or when the JAX package or a JAX library was
loaded. The last line of standard output is the result (one JSON
object); the numbers compared for ``correct`` end standard error, each
beside its limit.
"""

import time

STARTED = time.monotonic()  # noqa: E402 — set-up counts from here

import argparse  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import torch  # noqa: E402

from benchmark.harness import check, session, spec  # noqa: E402
from benchmark.harness import trace as trace_reader  # noqa: E402
from benchmark.reference.quant import quantizer  # noqa: E402
from benchmark.reference.step import Hyper, run_steps  # noqa: E402


class RunRecord:
    """What a metric reader reads: the cell, the window, the set-up and
    the device."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def program_settings(cell: spec.Cell, seed: int, logs: str):
    from srgan_tpu_torch.settings import Settings
    values = cell.settings()
    # Settings.seed seeds NumPy's legacy generator, which takes 32 bits.
    values.update(seed=seed % 2 ** 32, trial_name=cell.name,
                  logs_directory=logs)
    return Settings(**values)


def hyper(settings) -> Hyper:
    if settings.gradient_clip_norm or settings.labeled_loss_order != 2.0 \
            or settings.generator_training_step_period != 1:
        raise ValueError("the reference step covers no gradient clip, a "
                         "labeled loss order of 2 and a G update every "
                         "step")
    return Hyper(settings.learning_rate, settings.adam_b1, settings.adam_b2,
                 settings.weight_decay, settings.unlabeled_loss_multiplier,
                 settings.fake_loss_multiplier,
                 settings.gradient_penalty_multiplier)


def reference_run(cell: spec.Cell, app, data, records, draws, seed: int,
                  settings, device, precision: str = "float32"):
    """The reference's steps from the benchmark's weights on the inputs
    of ``records`` and the ``draws``, in ``precision``: (the steps'
    results, their batches, the starting weights on the host)."""
    start = session.initial_weights(app, cell.config, data, seed, device)
    batches = [app.reference_batch(cell.config, data, r, device)
               for r in records]
    got = run_steps(app.reference_models(cell.config), start, batches,
                    [tuple(t.to(device) for t in d) for d in draws],
                    hyper(settings), quantizer(precision))
    host_start = {m: {k: t.cpu() for k, t in w.items()}
                  for m, w in start.items()}
    return got, [tuple(t.detach().cpu() for t in b) for b in batches], \
        host_start


def reference_numbers(cell: spec.Cell, app, data, checked, seed: int,
                      settings, device) -> Dict[str, float]:
    """The numbers of the program's ``checked`` steps against the
    reference in float32."""
    got, inputs, start = reference_run(cell, app, data, checked.records,
                                       checked.draws, seed, settings, device)
    return check.compare(checked, got, start, inputs)


def start_program(cell: spec.Cell, seed: int, device, logs: str,
                  plant=None):
    """Set-up as the program's ``train()`` makes it, on the benchmark's
    data and weights, and the checked first steps: (the experiment, the
    data, the settings, the checked steps). ``plant(exp)``, a test's,
    breaks the program before its first step."""
    app = cell.app()
    settings = program_settings(cell, seed, logs)
    data = app.make_data(cell.config, seed, device)
    exp = app.experiment(settings, data, device)
    session.prepare(exp)
    session.load_weights(exp.state, session.initial_weights(
        app, cell.config, data, seed, device))
    if plant is not None:
        plant(exp)
    checked = session.checked_steps(app, exp, data, seed,
                                    cell.workload["checked_steps"])
    return exp, data, settings, checked


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, started: float, plant=None) -> RunRecord:
    """One run: set-up, the checked steps, the warm-up, the window, and
    the comparison once the program's state is freed."""
    workload = cell.workload
    cuda = device.type == "cuda"
    logs = tempfile.mkdtemp(prefix="srgan_bench_")
    try:
        exp, data, settings, checked = start_program(cell, seed, device,
                                                     logs, plant)
        batches = session.window_batches(exp)
        for _ in range(workload["warmup_steps"]):
            exp.state, _ = exp._step(*next(batches))
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.monotonic() - started
        window = session.run_window(exp, batches, seconds, trace,
                                    workload["profile_steps"])
        peak = (torch.cuda.max_memory_allocated(device) if cuda else 0)
        session.free(exp)
        del exp, batches
        numbers = reference_numbers(cell, cell.app(), data, checked, seed,
                                    settings, device)
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    failed = window.losses_finite.count(False)
    return RunRecord(cell=cell, settings=settings, setup_s=setup_s,
                     window=window, memory_peak_bytes=peak, numbers=numbers,
                     failed=failed, counts=cell.config.get("counts", {}))


def device_info(record: RunRecord, device, chips: int) -> Dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(record.memory_peak_bytes)}
    profile = record.window.profile
    if profile is not None:
        info["busy_s"] = profile.busy_s
        info["window_s"] = profile.window_s
    return info


def report(cell: spec.Cell, record: RunRecord, trace: bool, device,
           chips: int) -> int:
    """Print the result; returns the exit code."""
    limits = cell.workload["limits"]
    # An unreadable number (infinite) prints as null.
    checks = {k: {"value": (record.numbers[k] if math.isfinite(
        record.numbers[k]) else None), "limit": limits[k]} for k in limits}
    correct = check.verdict(record.numbers, limits) and record.failed == 0
    kind = "per_layer" if trace else "end_to_end"
    metrics = spec.read_metrics(cell, kind, record)
    breakdown = (trace_reader.breakdown(record.window.profile)
                 if trace and record.window.profile is not None else None)
    loaded = spec.jax_guard()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    print(f"steps in the window: {record.window.steps}")
    for name, value in record.numbers.items():
        if name not in checks:
            print(f"not compared {name} {value!r}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(spec.result_line(correct, record.window.steps, record.failed,
                           metrics, device_info(record, device, chips),
                           checks, breakdown), flush=True)
    return 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    record = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, STARTED)
    return report(cell, record, bool(args.trace), device, cell.chips)


if __name__ == "__main__":
    sys.exit(main())
