"""Device time of a call on the CUDA card, by CUDA events.

One helper for ``chip_smoke.py`` and the tools of ``srgan_tpu_torch.tools``,
so that every time they print is taken the same way.
"""

from __future__ import annotations

import time

import torch

# The H100 SXM's highest SM clock: a sleep of 2·t·SM_CLOCK_HZ cycles lasts
# at least 2·t.
SM_CLOCK_HZ = 1.98e9


def cuda_ms(fn, calls: int, queued: bool = False) -> float:
    """Mean device ms of ``fn`` over ``calls`` calls, by CUDA events, after
    two warm-up calls. ``queued``: the timed calls wait on the card behind
    a sleep kernel that outlasts their enqueueing, so that they run back to
    back whatever the host's time per call; else the first call's host
    time falls inside the events (fine for a call much longer than that)."""
    for _ in range(2):
        fn()
    if queued:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * enqueue_s * SM_CLOCK_HZ))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls
