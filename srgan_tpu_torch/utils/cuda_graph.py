"""K training steps as one CUDA graph replay (``Settings.steps_per_dispatch``).

The port's counterpart of ``jax.jit`` of the K-step chunk
(``srgan_tpu.apps.crowd._prepare_train_chunk``): JAX compiles K unrolled
(sample + step) iterations into one program and dispatches it once; here
the same K iterations are captured once into a ``torch.cuda.CUDAGraph``,
and every later chunk is one replay. Nothing in the JAX package
corresponds to this module.

:class:`TrainChunk` holds:

* the static input: one [K, A] int32 device buffer of the chunk's
  per-step arguments (the patch draws), filled before each chunk by one
  host→device copy from one of two pinned buffers used in turn; the host
  refills a pinned buffer only after its last copy finished (an event);
* the static outputs: the chunk's metrics, one [K] tensor each, which the
  next replay overwrites (read them before it);
* one graph per key the caller gives (the G update's phase of a chunk,
  ``apps/crowd.py``), each captured once into a private memory pool;
* the train generator, registered with every graph, so that each replay
  draws fresh z and α from where the generator stands and advances it as
  the K eager steps would.

The first chunk runs its K steps eagerly, with the real draws, on the
capture stream: that is the warm-up (cuDNN's and cuBLAS's handles, the
optimizers' moments, the kernels' libraries and tables and the NCCL
communicator are made then, never under capture). The first chunk of
each key after it is captured, then replayed; every other chunk is a
replay. A capture or a replay that fails raises: nothing falls back to
eager steps.

The program's counters (``utils/trace.py``) count when Python runs the
code that counts, which under capture enqueues nothing: a capture takes
back every counter's change, and each replay adds it again, so that every
counter counts what the card ran. ``TrainChunk.captures`` and
``TrainChunk.replays`` count the captures and replays of every chunk.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List

import numpy as np
import torch

from srgan_tpu_torch.utils import trace

Tensor = torch.Tensor

trace.declare("TrainChunk.captures")
trace.declare("TrainChunk.replays")


class TrainChunk:
    """``chunk(args, key) -> metrics``: ``body`` over K steps, eagerly the
    first time, else as the replay of the graph captured for ``key``.

    ``body(args)`` runs K steps on the [K, A] int32 device tensor of their
    arguments, drawing from ``generator``, and returns the stacked metrics
    {name: [K] tensor}; it must launch the same work whatever the
    arguments' values, and must not synchronize with the card.
    """

    def __init__(self, body: Callable[[Tensor], Dict[str, Tensor]],
                 num_steps: int, width: int, device: torch.device,
                 generator: torch.Generator):
        self._body = body
        self._generator = generator
        self._args = torch.empty((num_steps, width), dtype=torch.int32,
                                 device=device)
        self._pinned = [torch.empty((num_steps, width),
                                    dtype=torch.int32).pin_memory()
                        for _ in range(2)]
        self._copied: List = [None, None]
        self._turn = 0
        self._stream = torch.cuda.Stream(device)
        self._graphs: Dict[Hashable, tuple] = {}
        self._warm = False

    def _upload(self, args: np.ndarray) -> None:
        """The chunk's arguments into the static input, on the current
        stream (behind the previous replay's reads)."""
        turn = self._turn
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()  # its last copy has run
        self._pinned[turn].numpy()[...] = args
        self._args.copy_(self._pinned[turn], non_blocking=True)
        self._copied[turn] = torch.cuda.Event()
        self._copied[turn].record()
        self._turn = 1 - turn

    def _eager(self) -> Dict[str, Tensor]:
        current = torch.cuda.current_stream(self._args.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = self._body(self._args)
        current.wait_stream(self._stream)
        return out

    def _capture(self) -> tuple:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generator)
        # thread_local: the window tier's stager thread goes on copying
        # on its own stream while this thread captures.
        with trace.taken_back() as counted, torch.cuda.graph(
                graph, stream=self._stream,
                capture_error_mode="thread_local"):
            outputs = self._body(self._args)
        trace.count("TrainChunk.captures")
        return graph, outputs, counted

    def __call__(self, args: np.ndarray, key: Hashable = 0
                 ) -> Dict[str, Tensor]:
        self._upload(args)
        if not self._warm:
            outputs = self._eager()
            self._warm = True
            return outputs
        if key not in self._graphs:
            self._graphs[key] = self._capture()
        graph, outputs, counted = self._graphs[key]
        graph.replay()
        trace.add(counted)
        trace.count("TrainChunk.replays")
        return outputs
