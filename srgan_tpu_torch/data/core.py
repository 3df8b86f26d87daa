"""Host-side dataset containers, batch iteration and the host→device
prefetch.

The port of ``srgan_tpu.data.core``. :class:`ArrayDataset`,
:func:`epoch_batches` and :func:`cycling_batches` are NumPy and are the
JAX package's as they are, so that one NumPy generator gives both
packages the same batches, index for index. :func:`prefetch_to_device`
keeps ``size`` batches in flight with pinned, non-blocking copies; under
data parallelism it copies only the rank's share of each batch.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch


class ArrayDataset:
    """In-memory dataset of parallel arrays (examples [+ labels])."""

    def __init__(self, examples: np.ndarray,
                 labels: Optional[np.ndarray] = None):
        self.examples = np.asarray(examples)
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and \
                len(self.labels) != len(self.examples):
            raise ValueError(f"{len(self.examples)} examples but "
                             f"{len(self.labels)} labels")

    def __len__(self) -> int:
        return len(self.examples)

    def subset(self, indices) -> "ArrayDataset":
        return ArrayDataset(
            self.examples[indices],
            None if self.labels is None else self.labels[indices])


def epoch_batches(dataset: ArrayDataset, batch_size: int,
                  rng: np.random.Generator, shuffle: bool = True,
                  drop_last: bool = True
                  ) -> Iterator[Tuple[np.ndarray, ...]]:
    """One shuffled epoch of batches of ``batch_size`` (the last partial
    one dropped). A dataset smaller than one batch yields a single batch
    drawn with replacement, so that an epoch is never empty."""
    n = len(dataset)
    if n == 0:
        raise ValueError("cannot batch an empty dataset")
    if n < batch_size:
        idx = rng.choice(n, size=batch_size, replace=True)
        if dataset.labels is None:
            yield (dataset.examples[idx],)
        else:
            yield dataset.examples[idx], dataset.labels[idx]
        return
    order = rng.permutation(n) if shuffle else np.arange(n)
    limit = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, limit, batch_size):
        idx = order[start:start + batch_size]
        if dataset.labels is None:
            yield (dataset.examples[idx],)
        else:
            yield dataset.examples[idx], dataset.labels[idx]


def cycling_batches(dataset: ArrayDataset, batch_size: int,
                    rng: np.random.Generator
                    ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Endless reshuffled batches."""
    while True:
        yield from epoch_batches(dataset, batch_size, rng)


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array on ``device``. To a CUDA device the copy is
    non-blocking from a fresh pinned buffer: PyTorch's pinned-memory
    allocator records the copy's event and reuses the buffer only after
    the copy completes, so dropping the reference at once is safe."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return tensor.to(device)
    return tensor.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(iterator: Iterable[Tuple[np.ndarray, ...]],
                       device: torch.device, size: int = 2,
                       share: slice = slice(None)
                       ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Tuples of host arrays → tuples of tensors on ``device``, ``size``
    batches in flight: the copies of the next batches are queued while
    the current one is consumed. ``share`` selects the rows to copy (a
    data-parallel rank's; all by default)."""
    queue = collections.deque()
    it = iter(iterator)

    def put(batch):
        return tuple(to_device(a[share], device) for a in batch)

    for batch in itertools.islice(it, size):
        queue.append(put(batch))
    while queue:
        yield queue.popleft()
        for batch in itertools.islice(it, 1):
            queue.append(put(batch))
