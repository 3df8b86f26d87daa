"""What the program's own spans and counters say about a traced run.

The program (``srgan_tpu_torch/utils/trace.py``) keeps a span for each
phase of its loop, input and step while a ``torch.profiler`` records,
as over the traced run's profiled steps: the host clock at entry and
exit and, for the step's phases on the card, the stream's wall time
between timing events recorded at entry and exit, less that of the
phases inside it. That wall time holds the card's idle moments inside a
phase too, so it is the phase's device time only while the cell is
device-bound; a host-bound cell needs each kernel put down to its phase
by the profiler's correlation id instead. The launch counters' change
since the first kept span comes with the spans. A program without that
module (an older commit) gives nothing, and every reader of this module
then returns None.
"""

from __future__ import annotations

from typing import Iterable, Optional

STEP = "loop.step"


def recording(run):
    """The program's spans and counts of the run's profiled steps, taken
    once a run (the first reader takes them; later ones read the copy);
    None without the program's trace module."""
    if "program_trace" not in run.__dict__:
        try:
            from srgan_tpu_torch.utils import trace
        except ImportError:
            run.program_trace = None
        else:
            run.program_trace = trace.take()
    return run.program_trace


def steps(run) -> int:
    """The program's steps in the recording: its ``loop.step`` spans."""
    got = recording(run)
    return 0 if got is None else sum(s.name == STEP for s in got.spans)


def device_ms_per_step(run, names: Iterable[str]) -> Optional[float]:
    """The stream-wall ms a step under the spans ``names``, each without
    the timed spans inside it; None where no such span was timed on the
    card."""
    got, n = recording(run), steps(run)
    if not n:
        return None
    names = set(names)
    times = [s.device_self_ms for s in got.spans
             if s.name in names and s.device_self_ms is not None]
    return sum(times) / n if times else None


def host_ms_per_step(run, prefix: str) -> Optional[float]:
    """The host ms a step inside the spans named ``<prefix>*`` that no
    such span holds."""
    got, n = recording(run), steps(run)
    if not n:
        return None
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in got.spans
          if s.name.startswith(prefix)
          and not (s.parent or "").startswith(prefix)]
    return sum(ms) / n if ms else None


def count_per_step(run, counter: str) -> Optional[float]:
    got, n = recording(run), steps(run)
    if not n or counter not in got.counts:
        return None
    return got.counts[counter] / n
