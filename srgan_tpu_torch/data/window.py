"""The window tier: a rotating device-resident window of a training split.

The port of ``srgan_tpu.data.window`` (``SliceStream`` as it is, and
``HBMWindow`` with its schedule unchanged). A window of W examples of a
split stays on the device as one buffer per source array (images,
stacked labels), so the patch samplers index ``[0, W)`` at full speed.
The window is cut into S slices of R = W/S examples; a host-side cursor
walks an endless, seeded, per-pass-reshuffled stream of the whole split
(:class:`SliceStream`), and each refresh replaces the oldest slice with
the next one, which was staged a refresh ahead.

Staging on a CUDA device overlaps training. A daemon thread assembles
the next slice from the host arrays into pinned memory and copies it,
non-blocking, into a device staging buffer on a side stream, then
records an event. To apply, the current stream waits on that event and
copies the slice into its window rows, so stream order keeps the
previous steps' sampler reads before the write. Two hazards are closed
by events: the thread refills the pinned buffer only after its last copy
to the device finished, and the side stream writes the staging buffer
again only after the last apply's copy out of it ran. On the CPU the
same schedule runs with plain copies. A refresh copies into the window's
tensors in place, so a CUDA graph that samples them (the training chunk
of ``steps_per_dispatch``, ``utils/cuda_graph.py``) keeps valid pointers;
the chunked loop refreshes between replays.

``refresh_period=k > 0`` applies a slice at every k-th step boundary
(the content at step t is a function of the seed alone; the device
waits for the copy if it lags). ``refresh_period=0`` is opportunistic: a
slice is applied at the first boundary after its copy finished, so
training never waits on input.

Sharded (``num_shards = d > 1``, ``crowd_shard_dataset`` under data
parallelism), as in JAX: rank s holds W/d window rows, one global
stream draws every slice, and the slice is laid out shard-major (block s
of it fills rank s's rows), so every example enters the window once a
pass whatever the split's size modulo d. Each rank assembles, copies and
applies only its block, at a shard-local offset; ``resident_ids`` is the
global, shard-major view and ``local_ids`` this rank's rows. Under data
parallelism (sharded or replicated) the opportunistic mode applies a
slice only when every rank's copy has finished (``agree``), so that the
ranks' windows move together.
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
        Where the window (this rank's rows of it) lives.
    refresh_period:
        0 = opportunistic (apply once the staged copy is done; never
        waits). k > 0 = a refresh at every k-th step (the device waits
        for the copy if it lags).
    num_shards / shard:
        Shards of the window and this rank's; W and the slice size must
        divide by the shard count.
    agree:
        ``agree(ready) -> bool``, true when ``ready`` is true on every
        rank (opportunistic mode under data parallelism); None alone.
    """

    def __init__(self, names: Sequence[str],
                 sources: Sequence[Callable[[np.ndarray], torch.Tensor]],
                 num_examples: int, window: int, num_slices: int, *,
                 seed, device: torch.device, refresh_period: int = 0,
                 num_shards: int = 1, shard: int = 0,
                 agree: Optional[Callable[[bool], bool]] = None):
        if len(names) != len(sources):
            raise ValueError("names and sources must be parallel")
        d = int(num_shards)
        if num_slices < 1:
            raise ValueError(
                f"crowd_window_slices={num_slices} must be positive")
        if window % num_slices:
            raise ValueError(
                f"crowd_hbm_window={window} must divide by "
                f"crowd_window_slices={num_slices}")
        slice_size = window // num_slices
        if window % d or slice_size % d:
            raise ValueError(
                f"crowd_hbm_window={window} and its slice size "
                f"{slice_size} must divide by the data-parallel shard "
                f"count {d}")
        if num_examples < 1:
            raise ValueError("cannot window an empty split")
        self.names = list(names)
        self.window = int(window)
        self.num_slices = int(num_slices)
        self.slice_size = slice_size
        self.num_examples = int(num_examples)
        self._d, self._shard = d, int(shard)
        self._w_local = window // d          # window rows per shard
        self._r_local = slice_size // d      # slice rows per shard
        self._agree = agree
        self.device = torch.device(device)
        self.refresh_period = int(refresh_period)
        self._sources = list(sources)
        self._stream = SliceStream(num_examples, self.slice_size, seed)
        # Which host example id sits in each window row, all shards'
        # (shard-major: shard s owns rows [s·W/d, (s+1)·W/d)).
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
            self._pinned = [torch.empty_like(a[:self._r_local],
                                             device="cpu").pin_memory()
                            for a in self.arrays.values()]
            self._staging = [torch.empty_like(a[:self._r_local])
                             for a in self.arrays.values()]
            self._copied: Optional[torch.cuda.Event] = None
            self._applied: Optional[torch.cuda.Event] = None
        self._stage_next()

    # ------------------------------------------------------------- plumbing
    def _block(self, ids: np.ndarray, s: int) -> np.ndarray:
        """Shard s's block of a slice's ids."""
        return ids[s * self._r_local:(s + 1) * self._r_local]

    def _shard_rows(self, s: int, slot: int) -> slice:
        """Slot ``slot``'s rows of shard s in the global window."""
        start = s * self._w_local + slot * self._r_local
        return slice(start, start + self._r_local)

    def _fill_initial(self) -> None:
        """Upload the first S slices (this shard's blocks of them) as one
        [W/d, ...] copy per source."""
        for slot in range(self.num_slices):
            ids = self._stream.next_ids()
            for s in range(self._d):
                self._resident[self._shard_rows(s, slot)] = \
                    self._block(ids, s)
        order = self.local_ids()
        self.arrays: Dict[str, torch.Tensor] = {
            name: source(order).to(self.device)
            for name, source in zip(self.names, self._sources)}

    def _stage_next(self) -> None:
        """Draw the next slice's ids and hand the assembly and copy of
        this shard's block to the staging thread (``ids`` stays the whole
        slice's, for ``resident_ids``)."""
        ids = self._stream.next_ids()
        block = self._block(ids, self._shard)
        if not self._cuda:
            self._staged = self._stager.submit(
                lambda: (ids, [source(block).contiguous()
                               for source in self._sources], None))
            return
        copied, applied = self._copied, self._applied

        def work():
            if copied is not None:
                copied.synchronize()  # the pinned buffers are free again
            for pinned, source in zip(self._pinned, self._sources):
                pinned.copy_(source(block))
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
        slot = self._next_slot
        rows = slice(slot * self._r_local, (slot + 1) * self._r_local)
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            self._copied = event
        for name, sl in zip(self.names, slices):
            self.arrays[name][rows].copy_(sl)
        if event is not None:
            self._applied = torch.cuda.Event()
            self._applied.record(current)
        for s in range(self._d):
            self._resident[self._shard_rows(s, slot)] = self._block(ids, s)
        self._next_slot = (slot + 1) % self.num_slices
        self.refresh_count += 1
        self._stage_next()

    # -------------------------------------------------------------- surface
    def maybe_refresh(self, step: int) -> bool:
        """Refresh hook, called once per training step.

        Deterministic mode applies exactly at each period boundary.
        Opportunistic mode applies at most one slice per call, only if its
        copy already finished (on every rank, under ``agree``). Returns
        True when :attr:`arrays` changed.
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
        ready = self._staged is not None and self._ready()
        if self._agree is not None:
            ready = self._agree(ready)
        if ready:
            self._apply_staged()
            return True
        return False

    def resident_ids(self) -> np.ndarray:
        """Host example ids currently resident, by window row of every
        shard (shard-major)."""
        return self._resident.copy()

    def local_ids(self) -> np.ndarray:
        """Host example ids of this shard's rows, by row of
        :attr:`arrays`."""
        start = self._shard * self._w_local
        return self._resident[start:start + self._w_local].copy()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stager.shutdown()
        if self._cuda and self._staged.exception() is None:
            # The staging buffers must outlive the copy in flight into
            # them: once freed, the allocator may hand them out again.
            self._staged.result()[2].synchronize()
