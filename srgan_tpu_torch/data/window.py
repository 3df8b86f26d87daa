"""The window tier: a rotating device-resident window of a training split.

The port of ``srgan_tpu.data.window`` (``SliceStream`` as it is, and
``HBMWindow`` with its schedule unchanged) on one device. A window of W
examples of a split stays on the device as one buffer per source array
(images, stacked labels), so the patch samplers index ``[0, W)`` at full
speed. The window is cut into S slices of R = W/S examples; a host-side
cursor walks an endless, seeded, per-pass-reshuffled stream of the whole
split (:class:`SliceStream`), and each refresh replaces the oldest slice
with the next one, which was staged a refresh ahead.

Staging on a CUDA device overlaps training. A daemon thread assembles
the next slice from the host arrays into pinned memory and copies it,
non-blocking, into a device staging buffer on a side stream, then
records an event. To apply, the current stream waits on that event and
copies the slice into its window rows, so stream order keeps the
previous steps' sampler reads before the write. Two hazards are closed
by events: the thread refills the pinned buffer only after its last copy
to the device finished, and the side stream writes the staging buffer
again only after the last apply's copy out of it ran. On the CPU the
same schedule runs with plain copies.

``refresh_period=k > 0`` applies a slice at every k-th step boundary
(the content at step t is a function of the seed alone; the device
waits for the copy if it lags). ``refresh_period=0`` is opportunistic: a
slice is applied at the first boundary after its copy finished, so
training never waits on input.

Only one device (``num_shards = 1``) is ported: the JAX package's
shard-major windows over a mesh wait for the port's multi-device data
path.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch


class _DaemonStager:
    """One daemon worker thread with a Future-returning ``submit``.

    A window keeps one staged slice in flight at all times, so exit
    would always wait on a slice nobody needs if the worker were joined
    at exit, as ``ThreadPoolExecutor``'s are; a daemon thread lets the
    process exit with that slice abandoned.
    """

    def __init__(self, name: str):
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True)
        self._thread.start()

    def submit(self, fn: Callable) -> concurrent.futures.Future:
        future: concurrent.futures.Future = concurrent.futures.Future()
        self._queue.put((fn, future))
        return future

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fn, future = item
            if not future.set_running_or_notify_cancel():
                continue
            try:
                future.set_result(fn())
            except BaseException as exc:  # delivered via Future.result()
                future.set_exception(exc)

    def shutdown(self) -> None:
        """Stop accepting work and end the worker once the queue drains
        (never joins: the thread is daemon, so exit never waits)."""
        self._queue.put(None)


class SliceStream:
    """Deterministic endless stream of fixed-size id slices covering a
    split.

    Pass p is a fresh seeded permutation of all ``num_examples`` ids
    (``default_rng([seed, pass])``); slices of ``slice_size`` are cut
    contiguously across pass boundaries, so every example appears exactly
    once per pass regardless of divisibility.
    """

    def __init__(self, num_examples: int, slice_size: int, seed):
        if num_examples < 1:
            raise ValueError("SliceStream needs at least one example")
        if slice_size < 1:
            raise ValueError("slice_size must be >= 1")
        self.num_examples = int(num_examples)
        self.slice_size = int(slice_size)
        self._seed = list(np.atleast_1d(np.asarray(seed, np.int64)))
        self._pass_index = 0
        self._pending = np.empty((0,), np.int64)

    def next_ids(self) -> np.ndarray:
        """The next ``slice_size`` example ids (always full-size)."""
        while len(self._pending) < self.slice_size:
            rng = np.random.default_rng(self._seed + [self._pass_index])
            order = rng.permutation(self.num_examples)
            self._pending = np.concatenate([self._pending, order])
            self._pass_index += 1
        ids, self._pending = (self._pending[:self.slice_size],
                              self._pending[self.slice_size:])
        return ids.astype(np.int64)


class HBMWindow:
    """One training split's rotating device-resident window.

    Parameters
    ----------
    names / sources:
        Parallel lists: ``sources[i](host_ids)`` returns the host rows of
        those example ids as a CPU tensor ``[len(ids), ...]`` in the
        window's dtype. ``names[i]`` keys the device buffer in
        :attr:`arrays` (e.g. ``"labeled_images"``).
    num_examples:
        Split size; one stream covers all its ids.
    window / num_slices:
        W resident examples in ``num_slices`` slices of R = W/S; W must
        divide by S.
    device:
        Where the window lives.
    refresh_period:
        0 = opportunistic (apply once the staged copy is done; never
        waits). k > 0 = a refresh at every k-th step (the device waits
        for the copy if it lags).
    """

    def __init__(self, names: Sequence[str],
                 sources: Sequence[Callable[[np.ndarray], torch.Tensor]],
                 num_examples: int, window: int, num_slices: int, *,
                 seed, device: torch.device, refresh_period: int = 0):
        if len(names) != len(sources):
            raise ValueError("names and sources must be parallel")
        if num_slices < 1:
            raise ValueError(
                f"crowd_window_slices={num_slices} must be positive")
        if window % num_slices:
            raise ValueError(
                f"crowd_hbm_window={window} must divide by "
                f"crowd_window_slices={num_slices}")
        if num_examples < 1:
            raise ValueError("cannot window an empty split")
        self.names = list(names)
        self.window = int(window)
        self.num_slices = int(num_slices)
        self.slice_size = window // num_slices
        self.num_examples = int(num_examples)
        self.device = torch.device(device)
        self.refresh_period = int(refresh_period)
        self._sources = list(sources)
        self._stream = SliceStream(num_examples, self.slice_size, seed)
        # Which host example id sits in each window row.
        self._resident = np.empty(window, np.int64)
        self.refresh_count = 0
        self._next_slot = 0
        self._last_boundary = -1
        self._stager = _DaemonStager("device-window")
        self._staged: Optional[concurrent.futures.Future] = None
        self._closed = False
        self._fill_initial()
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            # One pinned and one device staging buffer per source (one
            # slice is in flight at a time), the side stream, and the
            # events that order their reuse.
            self._side = torch.cuda.Stream(self.device)
            self._pinned = [torch.empty_like(a[:self.slice_size],
                                             device="cpu").pin_memory()
                            for a in self.arrays.values()]
            self._staging = [torch.empty_like(a[:self.slice_size])
                             for a in self.arrays.values()]
            self._copied: Optional[torch.cuda.Event] = None
            self._applied: Optional[torch.cuda.Event] = None
        self._stage_next()

    # ------------------------------------------------------------- plumbing
    def _fill_initial(self) -> None:
        """Upload the first S slices as one [W, ...] copy per source."""
        order = np.concatenate([self._stream.next_ids()
                                for _ in range(self.num_slices)])
        self._resident[:] = order
        self.arrays: Dict[str, torch.Tensor] = {
            name: source(order).to(self.device)
            for name, source in zip(self.names, self._sources)}

    def _stage_next(self) -> None:
        """Draw the next slice's ids and hand its assembly and copy to the
        staging thread."""
        ids = self._stream.next_ids()
        if not self._cuda:
            self._staged = self._stager.submit(
                lambda: (ids, [source(ids).contiguous()
                               for source in self._sources], None))
            return
        copied, applied = self._copied, self._applied

        def work():
            if copied is not None:
                copied.synchronize()  # the pinned buffers are free again
            for pinned, source in zip(self._pinned, self._sources):
                pinned.copy_(source(ids))
            with torch.cuda.stream(self._side):
                if applied is not None:
                    self._side.wait_event(applied)  # staging is free
                for staging, pinned in zip(self._staging, self._pinned):
                    staging.copy_(pinned, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._side)
            return ids, self._staging, event

        self._staged = self._stager.submit(work)

    def _ready(self) -> bool:
        """Whether the staged slice's copy has finished (never waits)."""
        if not self._staged.done():
            return False
        event = self._staged.result()[2]
        return event is None or event.query()

    def _apply_staged(self) -> None:
        ids, slices, event = self._staged.result()
        rows = slice(self._next_slot * self.slice_size,
                     (self._next_slot + 1) * self.slice_size)
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            self._copied = event
        for name, sl in zip(self.names, slices):
            self.arrays[name][rows].copy_(sl)
        if event is not None:
            self._applied = torch.cuda.Event()
            self._applied.record(current)
        self._resident[rows] = ids
        self._next_slot = (self._next_slot + 1) % self.num_slices
        self.refresh_count += 1
        self._stage_next()

    # -------------------------------------------------------------- surface
    def maybe_refresh(self, step: int) -> bool:
        """Refresh hook, called once per training step.

        Deterministic mode applies exactly at each period boundary.
        Opportunistic mode applies at most one slice per call, only if its
        copy already finished. Returns True when :attr:`arrays` changed.
        """
        if self._closed:
            raise RuntimeError("the window is closed: its stager no longer "
                               "runs")
        if self.refresh_period > 0:
            if step <= 0 or step % self.refresh_period:
                return False
            if step == self._last_boundary:
                return False  # idempotent within a boundary
            self._last_boundary = step
            self._apply_staged()
            return True
        if self._staged is not None and self._ready():
            self._apply_staged()
            return True
        return False

    def resident_ids(self) -> np.ndarray:
        """Host example ids currently resident, by window row."""
        return self._resident.copy()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stager.shutdown()
        if self._cuda and self._staged.exception() is None:
            # The staging buffers must outlive the copy in flight into
            # them: once freed, the allocator may hand them out again.
            self._staged.result()[2].synchronize()
