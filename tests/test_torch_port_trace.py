"""The port's spans and counters (``srgan_tpu_torch/utils/trace.py``) on
the CPU: with no profiler recording they record nothing and open no
profiler range; while one records they nest per thread, the SR-GAN
and DNN-only steps, the loop and the crowd input emit theirs, only the
step's phases record timing events, the device times come out of the
events' clock less the children's, spans that no one takes are dropped
once the profiler has stopped. The counters: the program declares
exactly the names the metrics read, a module declares its own by itself,
a name is declared once and counted only once declared, and what a
capture takes back each replay adds again."""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from srgan_tpu_torch.apps.coefficient import CoefficientExperiment
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state
from srgan_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The counters the program declares once its crowd app is imported.
PROGRAM_COUNTERS = {
    "extract_patches.launches", "extract_rescaled_patches.launches",
    "fused_norm._launch_fwd.launches", "fused_norm._launch_bwd.launches",
    "fused_norm._launch_second_order.launches",
    "group_norm_act.layout_copies", "density_maps.launches",
    "TrainChunk.captures", "TrainChunk.replays", "conv.second_order",
    "conv.dilated_second_order"}
# This module's own counters, declared as any owner declares its own.
PROBE, IDLE = "test_torch_port_trace.probe", "test_torch_port_trace.idle"
trace.declare(PROBE)
trace.declare(IDLE)

GAN_STEP = ["step.d.forward", "step.d.penalty_grad", "step.d.backward",
            "step.d.adam", "step.g.forward", "step.g.backward", "step.g.adam",
            "step.dnn.forward", "step.dnn.backward", "step.dnn.adam"]
DNN_STEP = ["step.dnn.forward", "step.dnn.backward", "step.dnn.adam"]
TINY = dict(batch_size=4, hidden_size=8, labeled_dataset_size=8,
            unlabeled_dataset_size=8, validation_dataset_size=4,
            test_dataset_size=4, seed=3, latent_dimension=8)
CROWD = dict(batch_size=4, labeled_dataset_size=4, unlabeled_dataset_size=4,
             validation_dataset_size=2, crowd_image_height=48,
             crowd_image_width=48, image_patch_size=32, crowd_sigma=3.0,
             crowd_synthetic_max_heads=6, model_base_width=8,
             latent_dimension=8, seed=1, steps_per_dispatch=2,
             norm_impl="pallas")


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def profiling():
    """A CPU profiler records through the test, so the program's spans
    are on; nothing kept before or after leaks into another test."""
    trace.take()
    with _profiler():
        try:
            yield
        finally:
            trace.take()


class _Clock:
    """A stand-in for a card's timing events: each record reads the next
    time of a scripted device clock, or the count of records so far."""

    def __init__(self, times=None):
        self.times = None if times is None else iter(times)
        self.records = 0

    def event(self):
        clock = self

        class Event:
            def record(self):
                clock.records += 1
                self.at = (float(clock.records) if clock.times is None
                           else next(clock.times))

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return other.at - self.at

        return Event()

    def events(self):
        start = self.event()
        start.record()
        return start, self.event()


def _manual(cls, tmp_path, **over):
    exp = cls(Settings(**dict(over, logs_directory=str(tmp_path))),
              device="cpu")
    exp.dataset_setup()
    exp.models = exp.model_setup()
    exp.state = init_train_state(exp.settings, exp.models)
    exp.prepare_train_step()
    return exp


def _with_writers(exp):
    exp.trial_directory = exp._make_trial_directory()
    exp.prepare_summary_writers()
    return exp


def _names(spans, prefix=""):
    return [s.name for s in spans if s.name.startswith(prefix)]


def _refuse_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"profiler range {name!r} entered")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)


def test_a_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    trace.take()
    _refuse_record_function(monkeypatch)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = trace.span("step.d.forward", timed=True)
    second = trace.span("loop.step")
    assert first is second
    with first:
        with second:
            pass
    assert trace.take().spans == []


def test_a_step_without_a_profiler_records_nothing(tmp_path, monkeypatch):
    exp = _with_writers(_manual(CoefficientExperiment, tmp_path, **TINY))
    batch = next(next(exp.epoch_batch_iterators()))
    trace.take()
    monkeypatch.setattr(trace, "_Open", lambda *a: pytest.fail(
        f"span {a} opened"))
    exp.state, metrics = exp._step(*batch)
    exp.step_summaries(0, lambda: metrics)
    assert trace.take().spans == []
    exp.close()


def test_spans_nest_and_name_their_parents_on_each_thread(profiling):
    def worker():
        with trace.span("engine"):
            with trace.span("engine.inner"):
                pass

    with trace.span("outer"):
        with trace.span("inner"):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=30)
        with trace.span("inner.second"):
            pass
    assert not thread.is_alive()
    spans = trace.take().spans
    parents = {s.name: s.parent for s in spans}
    assert parents == {"outer": None, "inner": "outer",
                       "inner.second": "outer", "engine": None,
                       "engine.inner": "engine"}
    assert [s.name for s in spans][:2] == ["outer", "inner"]
    by = {s.name: s for s in spans}
    for child, parent in (("inner", "outer"), ("engine.inner", "engine")):
        assert by[parent].start_ns <= by[child].start_ns
        assert by[child].end_ns <= by[parent].end_ns
    # No card: host times only.
    assert all(s.device_self_ms is None for s in spans)
    assert trace.take().spans == []


def test_spans_are_on_while_a_profiler_records():
    trace.take()
    with _profiler() as prof:
        with trace.span("loop.step"):
            torch.ones(3).sum()
    assert trace.span("loop.step") is trace.span("x")
    assert _names(trace.take().spans) == []  # dropped by the span after
    with _profiler() as prof:
        with trace.span("loop.step"):
            torch.ones(3).sum()
        assert _names(trace.take().spans) == ["loop.step"]
    assert "loop.step" in {e.name for e in prof.events()}


def test_spans_that_no_one_takes_are_dropped_once_the_profiler_stops():
    trace.take()
    with _profiler():
        with trace.span("loop.step"):
            with trace.span("step.d.forward", timed=True):
                pass
        assert len(trace._kept) == 2
    assert len(trace._kept) == 2  # until a span is entered
    with trace.span("loop.step"):
        pass
    assert trace._kept == [] and trace._baseline is None
    assert trace.take().spans == []


def test_the_counters_count_from_the_first_span_of_the_recording():
    trace.take()
    with _profiler():
        with trace.span("loop.step"):
            pass
    for _ in range(5):
        trace.count(PROBE)
    with trace.span("loop.step"):  # no profiler: drops the baseline
        pass
    with _profiler():
        with trace.span("loop.step"):
            trace.count(PROBE)
            trace.count(PROBE)
        got = trace.take()
    assert _names(got.spans) == ["loop.step"]
    assert got.counts[PROBE] == 2 and got.counts[IDLE] == 0


@pytest.mark.parametrize("timed", [False, True])
def test_a_span_that_raises_is_closed_and_kept(profiling, monkeypatch,
                                               timed):
    clock = _Clock()
    monkeypatch.setattr(trace, "_device_events", clock.events)
    with pytest.raises(ValueError, match="inside"):
        with trace.span("step.d.backward", timed=timed):
            raise ValueError("inside")
    with trace.span("loop.step"):
        pass
    spans = trace.take().spans
    assert [(s.name, s.parent) for s in spans] == [
        ("step.d.backward", None), ("loop.step", None)]
    assert spans[0].start_ns <= spans[0].end_ns <= spans[1].start_ns
    assert clock.records == (2 if timed else 0)
    assert (spans[0].device_self_ms == 1.0) if timed else (
        spans[0].device_self_ms is None)


def test_a_gan_step_and_a_dnn_only_step_emit_their_spans(tmp_path,
                                                        profiling):
    exp = _manual(CoefficientExperiment, tmp_path / "gan", **TINY)
    batch = next(next(exp.epoch_batch_iterators()))
    trace.take()
    exp.state, _ = exp._step(*batch)
    spans = trace.take().spans
    assert _names(spans, "step.") == GAN_STEP
    parents = {s.name: s.parent for s in spans}
    assert parents["loop.step"] is None
    assert parents["step.d.penalty_grad"] == "step.d.forward"
    assert all(parents[n] == "loop.step" for n in GAN_STEP
               if n != "step.d.penalty_grad")

    dnn = _manual(CoefficientExperiment, tmp_path / "dnn", dnn_only=True,
                  **TINY)
    batch = next(next(dnn.epoch_batch_iterators()))
    trace.take()
    dnn.state, _ = dnn._step(*batch)
    assert _names(trace.take().spans, "step.") == DNN_STEP


@pytest.mark.parametrize("path", ["gan", "dnn_only", "crowd_chunk"])
def test_only_the_steps_phases_record_timing_events(tmp_path, profiling,
                                                    monkeypatch, path):
    """The metrics read device times of the step's phases alone; the
    loop's and the input's spans are host-only."""
    if path == "crowd_chunk":
        exp = _manual(CrowdExperiment, tmp_path, **CROWD)
        args = exp._patch_args_stream()
        run, phases = (lambda: exp.dispatch_chunk(args)), GAN_STEP * 2
    else:
        exp = _manual(CoefficientExperiment, tmp_path,
                      dnn_only=path == "dnn_only", **TINY)
        batch = next(next(exp.epoch_batch_iterators()))
        run = lambda: exp._step(*batch)  # noqa: E731
        phases = DNN_STEP if path == "dnn_only" else GAN_STEP
    clock = _Clock()
    monkeypatch.setattr(trace, "_device_events", clock.events)
    trace.take()
    run()
    spans = trace.take().spans
    timed = [s.name for s in spans if s.device_self_ms is not None]
    assert timed == phases
    assert clock.records == 2 * len(phases)
    host_only = {s.name for s in spans if s.device_self_ms is None}
    assert host_only == ({"loop.chunk", "input.draws", "input.sample"}
                         if path == "crowd_chunk" else {"loop.step"})


def test_device_times_are_the_events_less_the_childrens(profiling,
                                                         monkeypatch):
    # outer [10, 50] holds a [12, 20] and b [20, 41]; c [50, 53] after it.
    clock = _Clock([10.0, 12.0, 20.0, 20.0, 41.0, 50.0, 50.0, 53.0])
    monkeypatch.setattr(trace, "_device_events", clock.events)
    with trace.span("outer", timed=True):
        with trace.span("a", timed=True):
            pass
        with trace.span("host.only"):
            with trace.span("b", timed=True):
                pass
    with trace.span("c", timed=True):
        pass
    by = {s.name: s for s in trace.take().spans}
    assert (by["outer"].device_start_ms, by["outer"].device_end_ms) == (
        0.0, 40.0)
    # b's parent is a host-only span: outer keeps b's time as its own.
    assert by["outer"].device_self_ms == pytest.approx(40.0 - 8.0)
    assert by["a"].device_self_ms == 8.0 and by["b"].device_self_ms == 21.0
    assert by["host.only"].device_self_ms is None
    assert (by["c"].device_start_ms, by["c"].device_self_ms) == (40.0, 3.0)


def test_counters_read_the_attributes_they_name():
    """Importing the crowd app, in a process of its own, declares the
    program's counters and no other, each an int."""
    code = ("import srgan_tpu_torch.apps.crowd; "
            "from srgan_tpu_torch.utils import trace; "
            "counts = trace.counters(); "
            "print(sorted(counts), all(type(v) is int "
            "for v in counts.values()))")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == f"{sorted(PROGRAM_COUNTERS)} True"


def test_a_module_declares_and_counts_its_own_counters(profiling):
    """This module's counters, declared at its import, are read with the
    program's: no list elsewhere names them."""
    counts = trace.counters()
    assert PROGRAM_COUNTERS | {PROBE, IDLE} <= set(counts)
    assert all(type(v) is int for v in counts.values())
    with trace.span("loop.step"):
        trace.count(PROBE)
    now = trace.counters()
    assert (now[PROBE], now[IDLE]) == (counts[PROBE] + 1, counts[IDLE])
    got = trace.take()
    assert (got.counts[PROBE], got.counts[IDLE]) == (1, 0)


def test_a_name_is_declared_once_and_counted_only_once_declared():
    before = trace.counters()
    with pytest.raises(ValueError, match="declared twice"):
        trace.declare(PROBE)
    with pytest.raises(ValueError, match="declared twice"):
        trace.declare("conv.second_order")
    with pytest.raises(KeyError, match="test_torch_port_trace.undeclared"):
        trace.count("test_torch_port_trace.undeclared")
    assert trace.counters() == before


def test_what_a_capture_takes_back_each_replay_adds_again():
    """``TrainChunk``'s capture counts its body inside ``taken_back``,
    and each replay ``add``s what it handed over: the snapshot round
    trips, and only the counters that moved are handed over."""
    trace.count(PROBE)
    before = trace.counters()
    with trace.taken_back() as counted:
        for _ in range(3):
            trace.count(PROBE)
    assert counted == {PROBE: 3}
    assert trace.counters() == before
    for replays in (1, 2):
        trace.add(counted)
        now = trace.counters()
        assert now[PROBE] == before[PROBE] + 3 * replays
        assert {k: v for k, v in now.items() if k != PROBE} == {
            k: v for k, v in before.items() if k != PROBE}


def test_a_chunk_is_one_loop_chunk_span_with_its_input_and_steps(
        tmp_path, profiling):
    exp = _manual(CrowdExperiment, tmp_path, **CROWD)
    args = exp._patch_args_stream()
    trace.take()
    before = trace.counters()
    exp.dispatch_chunk(args)
    recording = trace.take()
    now = trace.counters()
    assert recording.counts == {k: now[k] - before[k] for k in now}
    spans = recording.spans
    assert spans[0].name == "loop.chunk" and spans[0].parent is None
    assert _names(spans, "input.draws") == ["input.draws"] * 2
    assert _names(spans, "input.sample") == ["input.sample"] * 2
    assert _names(spans, "step.") == GAN_STEP * 2
    assert {s.parent for s in spans
            if s.name.startswith("input.draws")} == {"loop.chunk"}


def test_loop_summary_marks_the_summary_steps_alone(tmp_path, profiling):
    exp = _with_writers(_manual(CoefficientExperiment, tmp_path,
                                summary_step_period=2, **TINY))
    trace.take()
    for step in range(4):
        exp.step_summaries(step, lambda: {"d_loss": torch.zeros(())})
    spans = trace.take().spans
    assert _names(spans) == ["loop.summary"] * 2
    exp.close()


def test_a_chunked_runs_profile_shows_its_chunks(tmp_path):
    """``profile_step_range`` over the crowd app's K = 2 loop: the trace
    of steps [2, 4) holds one ``loop.chunk`` with its input and steps,
    and the copies the spans kept are dropped at the range's end."""
    exp = CrowdExperiment(Settings(**dict(
        CROWD, logs_directory=str(tmp_path), steps_to_run=4,
        summary_step_period=2, validation_step_period=4,
        profile_step_range=(2, 4))), device="cpu")
    exp.train()
    with open(os.path.join(exp.trial_directory, "profile",
                           "steps_2_4.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"]
    assert names.count("loop.chunk") == 1
    assert names.count("input.draws") == 2
    assert names.count("step.d.backward") == 2
    assert trace.take().spans == []
