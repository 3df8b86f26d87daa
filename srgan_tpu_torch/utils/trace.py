"""Spans and counters of the port: where the training loop's time goes.

:func:`span` marks a phase of the loop (``loop.step``, ``loop.summary``,
``loop.chunk``), of the crowd resident tier's input (``input.draws``,
``input.copy``, ``input.sample``) or of the step (``step.d.forward`` with
``step.d.penalty_grad`` inside it, ``step.d.backward``, ``step.d.adam``,
the same three for ``g`` and ``dnn``). A span is on only while a
``torch.profiler`` records (the profiler's own flag); otherwise it
returns one shared no-op context manager. A span that is on:

* opens a profiler range of ``name``, so that the profiler shows it on
  its own timeline beside the kernels launched inside it. The range is
  ``torch._C._profiler._RecordFunctionFast``, the form of
  ``torch.profiler.record_function`` that torch's compiled graphs use:
  a tenth of its host cost, and no copy on the card's timeline;
* keeps, in memory, its name, the enclosing span on the same thread and
  the host clock (``time.perf_counter_ns``) at entry and at exit;
* if it is ``timed`` (the step's phases, which a metric reads), on a
  CUDA card outside graph capture, records a timing event on the current
  stream at entry and one at exit. The card reaches the two events in
  the order the host launched the work, so the time between them is the
  stream's wall time over what the span launched, from whichever thread
  (the autograd engine launches a backward from its own). It holds the
  card's idle moments inside the span too: it is the phase's device time
  only while the card never waits for the host. Under capture a span is
  host-only, and a replay is one ``loop.chunk`` around it.

:func:`take` hands the spans kept under the profiler over, with each
counter's change since the first of them; nothing is written on the hot
path. Spans that no one takes are dropped as the next span is entered
with no profiler recording. :func:`counters` reads the launch counters
where they live (the attributes keep their names; ``chip_smoke.py`` and
the tests read them).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# Spans kept between two takes; later ones go to the profiler alone.
KEEP_AT_MOST = 200_000

_NOOP = contextlib.nullcontext()
_kept: List["_Open"] = []
_baseline: Optional[Dict[str, int]] = None
_lock = threading.Lock()
_local = threading.local()


class Span(NamedTuple):
    """A finished span. The device times are on the card's clock, in ms
    from the earliest timed span of the same take; None where the span
    is not timed, ran on no card or under capture. ``device_self_ms``
    leaves out the device time of the timed spans directly inside it."""
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    device_start_ms: Optional[float] = None
    device_end_ms: Optional[float] = None
    device_self_ms: Optional[float] = None


class Recording(NamedTuple):
    spans: List[Span]          # by entry on the host clock
    counts: Dict[str, int]     # each counter's change since the first


def span(name: str, timed: bool = False):
    """A context manager marking ``name`` while a profiler records, with
    timing events on the card if ``timed``; the shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        if _kept:
            _drop()
        return _NOOP
    return _Open(name, timed)


def _drop() -> None:
    global _kept, _baseline
    with _lock:
        _kept, _baseline = [], None


def _device_events():
    if (not torch.cuda.is_initialized()
            or torch.cuda.is_current_stream_capturing()):
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return start, torch.cuda.Event(enable_timing=True)


class _Open:
    __slots__ = ("name", "timed", "parent", "start_ns", "end_ns", "events",
                 "children_ms", "_record")

    def __init__(self, name: str, timed: bool):
        self.name = name
        self.timed = timed

    def __enter__(self):
        global _baseline
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if _baseline is None:
            with _lock:
                if _baseline is None:
                    _baseline = counters()
        self._record = _RecordFunctionFast(self.name)
        self._record.__enter__()
        self.events = _device_events() if self.timed else None
        self.children_ms = 0.0
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.perf_counter_ns()
        self._record.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            if len(_kept) < KEEP_AT_MOST:
                _kept.append(self)
        return False


def take() -> Recording:
    """The spans kept since the last take (their device times read once
    the card has reached their events), and the counters' change since
    the first of them was entered."""
    global _kept, _baseline
    with _lock:
        kept, _kept = _kept, []
        baseline, _baseline = _baseline, None
    kept.sort(key=lambda s: s.start_ns)
    timed = [s for s in kept if s.events is not None]
    device = {}
    if timed:
        origin = timed[0].events[0]
        for s in timed:
            s.events[1].synchronize()
            device[id(s)] = (origin.elapsed_time(s.events[0]),
                             origin.elapsed_time(s.events[1]))
        for s in timed:
            if s.parent is not None and s.parent.events is not None:
                a, b = device[id(s)]
                s.parent.children_ms += b - a
    spans = []
    for s in kept:
        a, b = device.get(id(s), (None, None))
        spans.append(Span(s.name, s.parent.name if s.parent else None,
                          s.start_ns, s.end_ns, a, b,
                          None if a is None else b - a - s.children_ms))
    now = counters()
    counts = {k: now[k] - (baseline or now)[k] for k in now}
    return Recording(spans, counts)


def counters() -> Dict[str, int]:
    """The launch and copy counters as they stand, by the name they live
    under."""
    from srgan_tpu_torch.models.dcgan import conv
    from srgan_tpu_torch.ops import fused_norm
    from srgan_tpu_torch.ops.density import density_maps
    from srgan_tpu_torch.ops.patches import (extract_patches,
                                             extract_rescaled_patches)
    from srgan_tpu_torch.utils.cuda_graph import TrainChunk
    return {
        "extract_patches.launches": extract_patches.launches,
        "extract_rescaled_patches.launches":
            extract_rescaled_patches.launches,
        "fused_norm._launch_fwd.launches": fused_norm._launch_fwd.launches,
        "fused_norm._launch_bwd.launches": fused_norm._launch_bwd.launches,
        "fused_norm._launch_second_order.launches":
            fused_norm._launch_second_order.launches,
        "group_norm_act.layout_copies":
            fused_norm.group_norm_act.layout_copies,
        "density_maps.launches": density_maps.launches,
        "TrainChunk.captures": TrainChunk.captures,
        "TrainChunk.replays": TrainChunk.replays,
        "conv.second_order": conv.second_order,
        "conv.dilated_second_order": conv.dilated_second_order,
        "conv.layout_copies": conv.layout_copies,
    }
