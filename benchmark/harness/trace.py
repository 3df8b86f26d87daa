"""The profiler of the traced run, and what is read from it.

One ``torch.profiler`` session a process, with CPU and CUDA activities,
over the window's last steps: it starts after a synchronization and
stops after another, so its wall time holds the profiled steps whole.
From its events:

* ``busy_s``: the union of the intervals in which an operation ran on the
  device (kernels, copies, sets: the library's side streams overlap the
  main one, so a sum would count some time twice);
* ``device_ms``: device time by operation name, summed;
* the idle gaps between the busy intervals, each labelled with the
  benchmark's span (``bench.input``, ``bench.step``, ``bench.summary``)
  and the innermost host operation that ran as it began.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

label = torch.profiler.record_function


@dataclasses.dataclass
class Profile:
    steps: int
    window_s: float                   # wall time of the profiled steps
    busy_s: float
    device_ms: Dict[str, float]       # by operation name, summed
    gaps: List[Tuple[str, float]]     # (host label, seconds), longest first


def start(device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _events(profiler) -> Tuple[list, list]:
    """(device events, host events) as (name, start µs, end µs). The
    device's copies of the host's annotations (``bench.step``, Adam's
    ``Optimizer.step``) span whole phases and are no operation: they are
    left out."""
    events = profiler.events()
    annotations = {e.name for e in events
                   if getattr(e, "is_user_annotation", False)}
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        item = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != cuda:
            host.append(item)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name in annotations or e.name.startswith("bench.")):
            device.append(item)
    return device, host


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The sorted, merged union of ``intervals``."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def host_label(host: list, at: float) -> str:
    """The benchmark span and the innermost host operation running at
    ``at`` (µs)."""
    spans = [(b - a, n) for n, a, b in host if a <= at < b]
    bench = [n for _, n in spans if n.startswith("bench.")]
    ops = sorted(s for s in spans if not s[1].startswith("bench."))
    parts = bench[:1] + [ops[0][1]] if ops else bench[:1]
    return " > ".join(parts) if parts else "no host operation"


def stop(profiler, device, started: float, steps: int,
         gaps: int = 10) -> Profile:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - started
    profiler.stop()
    device_events, host = _events(profiler)
    per_name: Dict[str, float] = defaultdict(float)
    for name, a, b in device_events:
        per_name[name] += (b - a) / 1e3
    busy = union([(a, b) for _, a, b in device_events])
    busy_s = sum(b - a for a, b in busy) / 1e6
    idle = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                   for i in range(len(busy) - 1)), reverse=True)[:gaps]
    return Profile(steps, window_s, busy_s, dict(per_name),
                   [(host_label(host, at), length / 1e6)
                    for length, at in idle])


def breakdown(profile: Profile, top: int = 10) -> Dict:
    """The device operations that took most time (seconds per profiled
    step) and the longest idle gaps (seconds each, by host label)."""
    ops = sorted(profile.device_ms.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:160], ms / 1e3 / profile.steps]
                           for name, ms in ops],
            "idle_gaps": [[name, s] for name, s in profile.gaps[:top]]}
