"""Data parallelism over ranks: the process group, the batch shares and
the collectives.

The counterpart of ``srgan_tpu.parallel.mesh``. JAX runs one program
over a 1-D mesh and GSPMD inserts the reductions its sharded batch
needs. PyTorch runs one process per rank, each on its own device, and
the code says where to reduce:

* the global batch of B examples splits into W contiguous shares, rank r
  holding rows ``[r·B/W, (r+1)·B/W)`` (:meth:`DataParallel.share`, the
  counterpart of ``shard_batch``);
* parameters are replicated: broadcast from rank 0 at the start
  (:func:`broadcast_module`), gradients averaged over the ranks before
  the optimizer (:func:`average_gradients`);
* the losses' batch means are global sums over global counts
  (``srgan_tpu_torch.losses``): local sums go through
  :func:`all_reduce_sum`, whose backward is again a sum all-reduce, so a
  rank's gradient of the replicated loss is W times its share of the
  true gradient at every order (the penalty's double backward included).

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used, the
collectives that both NCCL and gloo run on CUDA tensors; a gather is a
sum all-reduce of zero-padded slices (:func:`gather_rows`). The group is
initialized from a ``file://`` store in a directory the caller gives (no
TCP port), with a timeout, so that a deadlocked collective raises.

Under NCCL the collectives of a step are captured with it into the CUDA
graph of a training chunk (``steps_per_dispatch``,
``utils/cuda_graph.py``); gloo's run through the host and cannot be, so
a chunk on a card refuses a gloo group (``apps/crowd.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# A collective that waits longer than this raises (the ranks of one step
# meet within seconds; a checkpoint write or a validation pass within
# minutes).
COLLECTIVE_TIMEOUT_S = 600.0
# Gradients are averaged in flat buckets of at most this many bytes.
BUCKET_BYTES = 32 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the data-parallel group: its rank, the
    number of ranks, its device and a gloo group for host-side agreements
    (:func:`all_ranks_agree`; ``None`` where the default group is gloo).
    The collectives run in the default group."""
    rank: int
    world_size: int
    device: torch.device
    host_group: Optional[dist.ProcessGroup] = None

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes summaries, checkpoints and exports."""
        return self.rank == 0

    def share(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.world_size:
            raise ValueError(f"a batch of {n} does not divide over "
                             f"{self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)


def data_axis_size(dp: Optional[DataParallel]) -> int:
    """Ranks along the batch: 1 without a group."""
    return 1 if dp is None else dp.world_size


def rank_devices(num_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 device: Optional[torch.device | str] = None
                 ) -> List[torch.device]:
    """The ranks' devices, one a rank.

    ``devices`` is taken as given: it may name one card twice (two ranks
    on one card run over gloo). Otherwise, on the CPU (``device`` of type
    cpu) ``num_devices`` ranks on the CPU, ``None`` meaning 1; on CUDA the
    first ``num_devices`` cards, ``None`` meaning every visible card, and
    more than there are raises."""
    if devices is not None:
        # A card named without an index is card 0, as ``torch.device``
        # allocates on it.
        devices = [torch.device("cuda", 0) if torch.device(d) ==
                   torch.device("cuda") else torch.device(d)
                   for d in devices]
        if num_devices is not None and num_devices != len(devices):
            raise ValueError(f"data_parallel_devices={num_devices} but "
                             f"{len(devices)} devices were named")
        return devices
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)] * (1 if num_devices is None
                                         else num_devices)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            "device=\"cpu\" to run on the CPU")
    n = count if num_devices is None else num_devices
    if n < 1:
        raise ValueError(f"data_parallel_devices must be >= 1, got {n}")
    if n > count:
        raise ValueError(
            f"data_parallel_devices={n} exceeds the {count} visible CUDA "
            f"card(s); name the devices (devices=[...]) to put several "
            f"ranks on one card, which runs over gloo")
    return [torch.device("cuda", i) for i in range(n)]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo (the CPU, or
    one card named twice: NCCL refuses two ranks on one device)."""
    cuda = all(d.type == "cuda" for d in devices)
    distinct = len({(d.type, d.index) for d in devices}) == len(devices)
    return "nccl" if cuda and distinct else "gloo"


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None, *, rank: int = 0,
              init_file: str,
              timeout_s: float = COLLECTIVE_TIMEOUT_S) -> DataParallel:
    """Join the data-parallel group as rank ``rank`` of
    ``len(rank_devices(num_devices, devices))`` ranks, through the
    ``file://`` store ``init_file`` (a path no earlier group used)."""
    devices = rank_devices(num_devices, devices)
    world = len(devices)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(devices)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank, timeout=timeout)
    host_group = (None if backend == "gloo"
                  else dist.new_group(backend="gloo", timeout=timeout))
    return DataParallel(rank=rank, world_size=world, device=device,
                        host_group=host_group)


# ------------------------------------------------------------ collectives
class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward is the same sum, itself
    differentiable, so the double backward's collectives are issued in
    the same order on every rank."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``Σ_ranks x``, the same on every rank, differentiable to any
    order (the backward sums the ranks' cotangents)."""
    return _AllReduceSum.apply(x)


def gather_rows(local: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The ranks' equal blocks of rows, concatenated in rank order on
    every rank: a sum all-reduce of zero-padded slices."""
    n = local.shape[0]
    out = local.new_zeros((n * dp.world_size,) + tuple(local.shape[1:]))
    out[dp.rank * n:(dp.rank + 1) * n] = local
    dist.all_reduce(out)
    return out


def _buckets(tensors: Sequence[torch.Tensor], limit: int):
    """Runs of consecutive indices of one dtype and at most ``limit``
    bytes (a larger tensor alone)."""
    run: List[int] = []
    size = 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != tensors[run[0]].dtype
                    or size + nbytes > limit):
            yield run
            run, size = [], 0
        run.append(i)
        size += nbytes
    if run:
        yield run


def average_gradients(grads: Sequence[torch.Tensor], dp: DataParallel
                      ) -> Tuple[torch.Tensor, ...]:
    """The mean over the ranks of each gradient, all-reduced in flat
    buckets of at most ``BUCKET_BYTES``; every rank gets the same
    bytes."""
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for run in _buckets(grads, BUCKET_BYTES):
        flat = torch.cat([grads[i].reshape(-1) for i in run])
        dist.all_reduce(flat)
        flat.div_(dp.world_size)
        for i, part in zip(run, flat.split([grads[i].numel()
                                            for i in run])):
            out[i] = part.view_as(grads[i])
    return tuple(out)


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers, in place on every rank."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def barrier(dp: DataParallel) -> None:
    dist.barrier(group=dp.host_group)


def all_ranks_agree(flag: bool, dp: DataParallel) -> bool:
    """True when ``flag`` is true on every rank: a sum all-reduce of a
    host tensor over the gloo group, which does not wait for the card."""
    missing = torch.tensor([0 if flag else 1], dtype=torch.int32)
    dist.all_reduce(missing, group=dp.host_group)
    return int(missing) == 0
