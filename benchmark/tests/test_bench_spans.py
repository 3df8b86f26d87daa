"""The readers of the program's spans and counters
(``harness/program_trace.py`` and the metrics that use it) on synthetic
recordings, the profiler's copies of the program's annotations left out
of the device's busy time, a tiny traced run on the CPU, and (``gpu``)
every new metric read at each cell's size on the card."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.harness import program_trace, spec
from benchmark.harness import trace as trace_reader
from benchmark.tests.conftest import CELLS, tiny_cell
from srgan_tpu_torch.utils.trace import Recording, Span

PROGRAM_METRICS = [m["name"] for m in spec.load_benchmark()["per_layer"]
                   if m["source"] in ("program_span", "program_counter")
                   and m["name"] not in ("loop.host_ms_per_step",
                                         "input.host_ms_per_step")]


def phases(run):
    """Device ms a step by span name (each without the spans inside it),
    and ``(unattributed)``: the device time of the recorded steps, from
    the first timed span's start to the last one's end, that no
    ``step.`` span holds."""
    got, n = program_trace.recording(run), program_trace.steps(run)
    timed = [] if not n else [s for s in got.spans
                              if s.device_self_ms is not None]
    if not timed:
        return {}
    out = {}
    for s in timed:
        out[s.name] = out.get(s.name, 0.0) + s.device_self_ms / n
    total = (max(s.device_end_ms for s in timed)
             - min(s.device_start_ms for s in timed)) / n
    out["(unattributed)"] = total - sum(v for k, v in out.items()
                                        if k.startswith("step."))
    return out


def _span(name, parent, host, device=None, self_ms=None):
    a, b = device or (None, None)
    return Span(name, parent, host[0], host[1], a, b, self_ms)


def _two_steps():
    """Two steps on a device clock in ms: input 0–1, the step 1–10 (D
    forward 2–4 with the penalty gradient 3–4 inside it, D backward 4–8,
    Adam 8–9, G 9–9.5, DNN 9.5–10); the second step 10 ms later."""
    spans = []
    for k in range(2):
        t = 10.0 * k
        ns = int(1e7) * k
        spans += [
            _span("input.draws", None, (ns, ns + 200_000), (t, t + 0.2),
                  0.2),
            _span("input.sample", None, (ns + 200_000, ns + 1_000_000),
                  (t + 0.2, t + 1.0), 0.8),
            _span("loop.step", None, (ns + 1_000_000, ns + 9_000_000),
                  (t + 1.0, t + 10.0), 1.0),
            _span("step.d.forward", "loop.step", (ns + 2, ns + 3),
                  (t + 2.0, t + 4.0), 1.0),
            _span("step.d.penalty_grad", "step.d.forward", (ns + 2, ns + 3),
                  (t + 3.0, t + 4.0), 1.0),
            _span("step.d.backward", "loop.step", (ns + 3, ns + 4),
                  (t + 4.0, t + 8.0), 4.0),
            _span("step.d.adam", "loop.step", (ns + 4, ns + 5),
                  (t + 8.0, t + 9.0), 1.0),
            _span("step.g.forward", "loop.step", (ns + 5, ns + 6),
                  (t + 9.0, t + 9.2), 0.2),
            _span("step.g.backward", "loop.step", (ns + 6, ns + 7),
                  (t + 9.2, t + 9.5), 0.3),
            _span("step.g.adam", "loop.step", (ns + 7, ns + 8),
                  (t + 9.5, t + 9.5), 0.0),
            _span("step.dnn.forward", "loop.step", (ns + 8, ns + 9),
                  (t + 9.5, t + 9.6), 0.1),
            _span("step.dnn.backward", "loop.step", (ns + 9, ns + 10),
                  (t + 9.6, t + 9.8), 0.2),
            _span("step.dnn.adam", "loop.step", (ns + 10, ns + 11),
                  (t + 9.8, t + 10.0), 0.2),
        ]
    return Recording(spans, {"group_norm_act.layout_copies": 8})


def _read(name, recording):
    record = run.RunRecord(program_trace=recording)
    return spec.metric_reader(name)(record)


def test_each_program_metric_reads_its_spans():
    got = {name: _read(name, _two_steps()) for name in PROGRAM_METRICS}
    assert got == pytest.approx({
        "step.d_forward_ms_per_step": 1.0,
        "step.penalty_grad_ms_per_step": 1.0,
        "step.d_backward_ms_per_step": 4.0,
        "step.g_ms_per_step": 0.5,
        "step.dnn_ms_per_step": 0.3,
        "step.adam_ms_per_step": 1.2,
        "input.program_host_ms_per_step": 1.0,
        "kernels.layout_copies_per_step": 4.0})


def test_the_phases_and_the_unattributed_time_add_up_to_the_steps():
    record = run.RunRecord(program_trace=_two_steps())
    ms = phases(record)
    step = sum(v for k, v in ms.items() if k.startswith("step."))
    # 20 ms over two steps: 8 ms a step in step.* spans.
    assert step == pytest.approx(8.0)
    assert step + ms["(unattributed)"] == pytest.approx(10.0)
    assert ms["(unattributed)"] == pytest.approx(
        ms["input.draws"] + ms["input.sample"] + ms["loop.step"])


@pytest.mark.parametrize("recording", [
    None,                                     # a program without spans
    Recording([], {}),                        # nothing was recorded
    Recording([_span("loop.step", None, (0, 5)),
               _span("step.d.backward", "loop.step", (1, 2))], {})])
def test_a_program_metric_finds_nothing_where_nothing_was_kept(recording):
    for name in PROGRAM_METRICS:
        assert _read(name, recording) is None, name


def test_the_recording_is_taken_once_a_run(monkeypatch):
    from srgan_tpu_torch.utils import trace
    takes = []
    monkeypatch.setattr(trace, "take",
                        lambda: takes.append(1) or _two_steps())
    record = run.RunRecord()
    for name in PROGRAM_METRICS:
        spec.metric_reader(name)(record)
    assert takes == [1]


class _Event:
    def __init__(self, name, start, end, cuda, annotation=False):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation


def test_the_programs_annotations_are_no_device_operation():
    events = [_Event("step.d.backward", 0, 100, cuda=False, annotation=True),
              _Event("cudaLaunchKernel", 10, 12, cuda=False),
              _Event("step.d.backward", 5, 400, cuda=True, annotation=True),
              _Event("implicit_convolve_sgemm", 20, 60, cuda=True),
              _Event("bench.step", 0, 500, cuda=True)]
    device, host = trace_reader._events(SimpleNamespace(
        events=lambda: events))
    assert device == [("implicit_convolve_sgemm", 20, 60)]
    busy = trace_reader.union([(a, b) for _, a, b in device])
    assert sum(b - a for a, b in busy) == 40
    assert trace_reader.host_label(host, 50) == "step.d.backward"


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_at_a_tiny_size_keeps_the_programs_spans(name):
    cell = tiny_cell(name)
    record = run.run_cell(cell, 2 ** 31 + 9, 0.5, True,
                          torch.device("cpu"), time.monotonic())
    got = spec.read_metrics(cell, "per_layer", record)
    assert program_trace.steps(record) == cell.workload["profile_steps"]
    assert got["input.program_host_ms_per_step"]["value"] > 0
    # No card: no device time is read.
    assert not {n for n in got if n.startswith("step.")
                and n.endswith("_ms_per_step")}
    spans = program_trace.recording(record).spans
    assert {"input.draws", "input.copy", "input.sample", "loop.step",
            "step.d.penalty_grad"} <= {s.name for s in spans}


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_every_program_metric_reads_at_the_cells_size(name, card):
    cell = spec.Cell(name)
    record = run.run_cell(cell, 2 ** 31 + 505, 8.0, True, card,
                          time.monotonic())
    got = spec.read_metrics(cell, "per_layer", record)
    listed = [m["name"] for m in cell.metrics("per_layer")
              if m["name"] in PROGRAM_METRICS]
    for metric in listed:
        value = got[metric]["value"]
        assert value == value and abs(value) != float("inf"), metric
    ms = phases(record)
    total = sum(v for k, v in ms.items()
                if k.startswith("step.") or k == "(unattributed)")
    assert 0 <= ms["(unattributed)"] < 0.02 * total, ms
