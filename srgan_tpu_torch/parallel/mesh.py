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

With a model axis (``parallel/tp.py``) the batch's collectives run in
the data group of this rank's model rank (``DataParallel.group``), and
``rank`` / ``world_size`` count the data ranks.

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
    """This process's place in the data-parallel group: its rank along
    the batch, the number of such ranks, its device and a gloo group of
    every process for host-side agreements (:func:`all_ranks_agree`;
    ``None`` where the default group is gloo).

    The batch's collectives run in ``group``: ``None``, the default
    group, unless the ranks also form a model axis (``model``, a
    :class:`~srgan_tpu_torch.parallel.tp.ModelAxis`), where ``group``
    holds the ranks of this rank's model rank and ``global_rank`` is the
    process's rank in the default group (``parallel/tp.py``)."""
    rank: int
    world_size: int
    device: torch.device
    host_group: Optional[dist.ProcessGroup] = None
    group: Optional[dist.ProcessGroup] = None
    model: Optional[object] = None
    global_rank: Optional[int] = None

    @property
    def is_writer(self) -> bool:
        """Process 0 alone writes summaries, checkpoints and exports."""
        return (self.rank if self.global_rank is None
                else self.global_rank) == 0

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
                 device: Optional[torch.device | str] = None,
                 model: int = 1) -> List[torch.device]:
    """The ranks' devices, one a rank: ``num_devices`` data ranks times
    ``model`` model ranks, in rank order (data-major: rank d·model + m).

    ``devices`` is taken as given: it may name one card twice (two ranks
    on one card run over gloo). Otherwise, on the CPU (``device`` of type
    cpu) ``num_devices`` data ranks on the CPU, ``None`` meaning 1; on
    CUDA the first ``num_devices · model`` cards, ``None`` meaning
    ``max(1, cards // model)`` data ranks (JAX's ``prepare_mesh``), and
    more ranks than cards raises."""
    if model < 1:
        raise ValueError(f"model_parallel_devices must be >= 1, got {model}")
    if devices is not None:
        # A card named without an index is card 0, as ``torch.device``
        # allocates on it.
        devices = [torch.device("cuda", 0) if torch.device(d) ==
                   torch.device("cuda") else torch.device(d)
                   for d in devices]
        if len(devices) % model or (num_devices is not None and
                                    num_devices * model != len(devices)):
            raise ValueError(
                f"data_parallel_devices={num_devices} × "
                f"model_parallel_devices={model} but {len(devices)} "
                f"devices were named")
        return devices
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)] * ((1 if num_devices is None
                                          else num_devices) * model)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            "device=\"cpu\" to run on the CPU")
    n = max(1, count // model) if num_devices is None else num_devices
    if n < 1:
        raise ValueError(f"data_parallel_devices must be >= 1, got {n}")
    if n * model > count:
        raise ValueError(
            f"data_parallel_devices={n} × model_parallel_devices={model} "
            f"exceeds the {count} visible CUDA card(s); name the devices "
            f"(devices=[...]) to put several ranks on one card, which "
            f"runs over gloo")
    return [torch.device("cuda", i) for i in range(n * model)]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo (the CPU, or
    one card named twice: NCCL refuses two ranks on one device)."""
    cuda = all(d.type == "cuda" for d in devices)
    distinct = len({(d.type, d.index) for d in devices}) == len(devices)
    return "nccl" if cuda and distinct else "gloo"


def init_world(devices: Sequence[torch.device], rank: int, init_file: str,
               timeout_s: float) -> Optional[dist.ProcessGroup]:
    """Join the default group of ``len(devices)`` processes as ``rank``
    through the ``file://`` store ``init_file`` (a path no earlier group
    used), on ``devices[rank]``; returns the gloo host group (``None``
    where the default group is gloo)."""
    world = len(devices)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    backend = backend_for(devices)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank, timeout=timeout)
    return (None if backend == "gloo"
            else dist.new_group(backend="gloo", timeout=timeout))


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None, *, rank: int = 0,
              init_file: str,
              timeout_s: float = COLLECTIVE_TIMEOUT_S) -> DataParallel:
    """Join the data-parallel group as rank ``rank`` of
    ``len(rank_devices(num_devices, devices))`` ranks, through the
    ``file://`` store ``init_file`` (a path no earlier group used)."""
    devices = rank_devices(num_devices, devices)
    host_group = init_world(devices, rank, init_file, timeout_s)
    return DataParallel(rank=rank, world_size=len(devices),
                        device=devices[rank], host_group=host_group)


# ------------------------------------------------------------ collectives
class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward is the same sum, itself
    differentiable, so the double backward's collectives are issued in
    the same order on every rank."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None
                   ) -> torch.Tensor:
    """``Σ_ranks x`` over ``group`` (default: every process), the same on
    every rank, differentiable to any order (the backward sums the
    ranks' cotangents)."""
    return _AllReduceSum.apply(x, group)


def gather_rows(local: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The data ranks' equal blocks of rows, concatenated in rank order
    on every rank: a sum all-reduce of zero-padded slices."""
    n = local.shape[0]
    out = local.new_zeros((n * dp.world_size,) + tuple(local.shape[1:]))
    out[dp.rank * n:(dp.rank + 1) * n] = local
    dist.all_reduce(out, group=dp.group)
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
    """The mean over the data ranks of each gradient, all-reduced in flat
    buckets of at most ``BUCKET_BYTES``; every rank of the data group
    gets the same bytes."""
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for run in _buckets(grads, BUCKET_BYTES):
        flat = torch.cat([grads[i].reshape(-1) for i in run])
        dist.all_reduce(flat, group=dp.group)
        flat.div_(dp.world_size)
        for i, part in zip(run, flat.split([grads[i].numel()
                                            for i in run])):
            out[i] = part.view_as(grads[i])
    return tuple(out)


def broadcast_module(module: torch.nn.Module) -> None:
    """Process 0's parameters and buffers, in place on every process."""
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
