"""Tensor parallelism: channel-sharded parameters and Adam state on a
data × model grid of ranks.

The counterpart of ``srgan_tpu.parallel.tp``. JAX annotates each leaf
of the train state with a sharding (:func:`_leaf_spec`: the output axis
on the ``model`` mesh axis where it divides) and GSPMD partitions the
step. PyTorch has no GSPMD, so this module places every collective
itself:

* :func:`make_grid` joins ``data × model`` ranks, data-major as JAX's
  ``reshape(data, model)``: rank = d·M + m. The ranks that share m form
  a data group (the batch's collectives, ``DataParallel.group``), the
  ranks that share d a model group (:class:`ModelAxis`).
* :func:`shard_module` keeps, of every parameter the rule shards, this
  rank's block of its output channels, and makes each sharded layer
  compute only its block of the output (column parallelism). The model
  code does not change: the layers' inputs are converted by forward
  pre-hooks, the norms by ``models.dcgan.norm_act``'s hook, and a model
  gathers an activation at the points where it needs all channels
  (``models.dcgan.gather_channels``).
* :func:`full_state_dict` / :func:`load_full_state_dict` and
  :func:`full_optimizer_state` / :func:`load_full_optimizer_state` move
  between the shards and the logical full tensors (checkpoints hold the
  full state, as JAX's Orbax save of global arrays does; evaluation
  loads :func:`full_state_dict` into an unsharded model).

The collectives' convention: a tensor is either a shard (this rank's
block of channels) or replicated (the same full tensor on every model
rank), and a replicated tensor's cotangent is the whole cotangent, the
same on every model rank. Each collective is an ``autograd.Function``
whose backward is its adjoint under that convention, issued through
another such Function, so that the double backward of the gradient
penalty issues its collectives in one order on every rank:

=====================  ===================================  =================
Function               forward                              backward
=====================  ===================================  =================
``_Gather``            shards → replicated                  ``_Split``
``_Split``             replicated → this rank's block       ``_Gather``
``_GatherForShards``   shards → replicated (a sharded        ``_ReduceScatter``
                       layer's input)
``_ReduceScatter``     partial sums → this rank's block     ``_GatherForShards``
                       of their sum
``_Copy``              identity (a sharded layer's input)   ``_Sum``
``_Sum``               partial sums → their model-group     ``_Copy``
                       sum
=====================  ===================================  =================

A sharded layer takes a replicated input through ``copy``: its input
gradient is a partial sum (of its block of outputs), which ``copy``'s
backward sums over the model group. Where its input is the shards of
the layer before, it gathers them with ``gather_for_shards``, whose
reduce-scatter is that sum and the slice in one. A replicated layer
gathers shards with ``gather``. So the penalty's input gradient at the
interpolates is summed over the model group by D's first layer, and a
sharded parameter's gradient is its block of the whole gradient: the
optimizer averages gradients over the data group only.

The gathers and the reduce-scatter are sum all-reduces (of zero-padded
shards, or of the partial sums, then sliced), the one collective that
gloo runs on CUDA tensors; NCCL runs them as they are.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from srgan_tpu_torch.models.dcgan import (Conv, ConvTranspose, Dense,
                                          FastGroupNorm, GroupNorm,
                                          activation, fast_group_norm_nchw,
                                          group_norm_nchw, run_norm_act)
from srgan_tpu_torch.ops.fused_norm import FusedGroupNormAct, group_norm_act
from srgan_tpu_torch.parallel.mesh import (COLLECTIVE_TIMEOUT_S,
                                           DataParallel, init_world,
                                           make_mesh, rank_devices)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis: its model rank, the number of
    model ranks and their group; and the collectives over that group."""
    rank: int
    size: int
    group: Optional[dist.ProcessGroup]

    def gather(self, x: Tensor, dim: int = 1) -> Tensor:
        """The shards along ``dim`` → the full tensor, for replicated use
        (backward: this rank's slice)."""
        return _Gather.apply(x, _dim(x, dim), self)

    def split(self, x: Tensor, dim: int = 1) -> Tensor:
        """A replicated tensor → this rank's block along ``dim``
        (backward: the gather)."""
        return _Split.apply(x, _dim(x, dim), self)

    def gather_for_shards(self, x: Tensor, dim: int = 1) -> Tensor:
        """The shards along ``dim`` → the full tensor, as the input of a
        sharded layer (backward: a reduce-scatter of its partial
        sums)."""
        return _GatherForShards.apply(x, _dim(x, dim), self)

    def copy(self, x: Tensor) -> Tensor:
        """A replicated tensor as the input of a sharded layer: the
        identity, whose backward sums the partial cotangents."""
        return _Copy.apply(x, self)


def _dim(x: Tensor, dim: int) -> int:
    return dim % x.dim()


def _memory_format(x: Tensor) -> torch.memory_format:
    if (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        return torch.channels_last
    return torch.contiguous_format


def _all_gather(x: Tensor, dim: int, axis: ModelAxis) -> Tensor:
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * axis.size
    out = torch.empty(shape, dtype=x.dtype, device=x.device,
                      memory_format=_memory_format(x)).zero_()
    out.narrow(dim, axis.rank * n, n).copy_(x)
    dist.all_reduce(out, group=axis.group)
    return out


def _slice(x: Tensor, dim: int, axis: ModelAxis) -> Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n).contiguous(
        memory_format=_memory_format(x))


def _all_reduce(x: Tensor, axis: ModelAxis) -> Tensor:
    out = x.clone(memory_format=_memory_format(x))
    dist.all_reduce(out, group=axis.group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _Split.apply(grad, ctx.dim, ctx.axis), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _slice(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.dim, ctx.axis), None, None


class _GatherForShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatter.apply(grad, ctx.dim, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _slice(_all_reduce(x, axis), dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _GatherForShards.apply(grad, ctx.dim, ctx.axis), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _Sum.apply(grad, ctx.axis), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _Copy.apply(grad, ctx.axis), None


# ------------------------------------------------------------------ grid
def make_grid(data: int, model: int, devices: Sequence, rank: int,
              init_file: str,
              timeout_s: float = COLLECTIVE_TIMEOUT_S) -> DataParallel:
    """Join a grid of ``data × model`` ranks as ``rank`` (= d·model + m)
    through the ``file://`` store ``init_file``; ``devices`` holds the
    ranks' devices in rank order. Every rank creates the data groups
    (m = 0, 1, ...) and then the model groups (d = 0, 1, ...), in the
    same order. With ``model == 1`` it is :func:`~srgan_tpu_torch.
    parallel.mesh.make_mesh`'s data-parallel group."""
    if model == 1:
        return make_mesh(devices=devices, rank=rank, init_file=init_file,
                         timeout_s=timeout_s)
    devices = rank_devices(data, devices, model=model)
    host_group = init_world(devices, rank, init_file, timeout_s)
    timeout = datetime.timedelta(seconds=timeout_s)
    data_groups = [dist.new_group([d * model + m for d in range(data)],
                                  timeout=timeout) for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)],
                                   timeout=timeout) for d in range(data)]
    d, m = divmod(rank, model)
    return DataParallel(rank=d, world_size=data, device=devices[rank],
                        host_group=host_group, group=data_groups[m],
                        model=ModelAxis(m, model, model_groups[d]),
                        global_rank=rank)


# ------------------------------------------------------------------ rule
def is_sharded(shape: Sequence[int], dim: int, model_size: int) -> bool:
    """JAX's ``_leaf_spec``: shard the output axis when it divides by the
    model size and is at least twice it."""
    return (len(shape) >= 1 and model_size > 1
            and shape[dim] % model_size == 0
            and shape[dim] >= 2 * model_size)


def shard_dim(module: nn.Module, name: str) -> int:
    """The output axis of ``module``'s parameter ``name`` in the port's
    layouts: ``ConvTranspose.weight [in, out, 4, 4]`` dim 1; conv and
    dense weights ``[out, ...]``, biases and norm scales dim 0. It is the
    trailing axis of the flax leaf that JAX's rule shards."""
    return 1 if isinstance(module, ConvTranspose) and name == "weight" \
        else 0


def param_shardings(module: nn.Module, model_size: int
                    ) -> Dict[str, Optional[int]]:
    """Each parameter of an unsharded ``module`` by name: the dim the rule
    shards, or ``None`` where it replicates."""
    out = {}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        dim = shard_dim(sub, leaf)
        out[name] = dim if is_sharded(p.shape, dim, model_size) else None
    return out


def _shard_param(module: nn.Module, name: str, dim: int,
                 axis: ModelAxis) -> None:
    p = getattr(module, name)
    local = nn.Parameter(_slice(p.detach(), dim, axis).clone(),
                         requires_grad=p.requires_grad)
    local.model_shard = (dim, axis)
    setattr(module, name, local)


def _shard_layer(layer: nn.Module, axis: ModelAxis) -> None:
    out_dim = shard_dim(layer, "weight")
    in_dim = 1 - out_dim  # ConvTranspose [in, out, ...]; others [out, in]
    full_in = layer.weight.shape[in_dim]
    sharded = is_sharded(layer.weight.shape, out_dim, axis.size)
    channel = -1 if isinstance(layer, Dense) else 1
    if sharded:
        _shard_param(layer, "weight", out_dim, axis)
        _shard_param(layer, "bias", 0, axis)

    def convert_input(_, args):
        x = args[0]
        local = x.shape[channel] != full_in
        if sharded:
            x = (axis.gather_for_shards(x, channel) if local
                 else axis.copy(x))
        elif local:
            x = axis.gather(x, channel)
        return (x,) + tuple(args[1:])

    layer.register_forward_pre_hook(convert_input)


def _shard_norm(norm: nn.Module, axis: ModelAxis) -> None:
    channels = norm.scale.numel()
    if not is_sharded((channels,), 0, axis.size):
        return  # replicated: its input is replicated too
    groups = norm.num_groups
    _shard_param(norm, "scale", 0, axis)
    _shard_param(norm, "bias", 0, axis)
    if groups % axis.size == 0:
        # Whole groups on each rank: the norm on this rank's channels.
        norm.num_groups = groups // axis.size

        def local(x, negative_slope):
            if x.shape[1] == channels:
                x = axis.split(x)
            return run_norm_act(x, norm, negative_slope)

        norm.model_shard_hook = local
        return

    # A group straddles two ranks: the norm runs replicated, on the
    # gathered input with the gathered scale and bias.
    def straddling(x, negative_slope):
        if x.shape[1] != channels:
            x = axis.gather(x)
        scale, bias = axis.gather(norm.scale, 0), axis.gather(norm.bias, 0)
        if isinstance(norm, FusedGroupNormAct):
            return group_norm_act(x, scale, bias, groups=groups,
                                  negative_slope=negative_slope,
                                  eps=norm.epsilon)
        compute = (fast_group_norm_nchw if isinstance(norm, FastGroupNorm)
                   else group_norm_nchw)
        return activation(compute(x, scale, bias, groups, norm.epsilon,
                                  norm.dtype), negative_slope)

    norm.model_shard_hook = straddling


def shard_module(module: nn.Module, axis: ModelAxis) -> nn.Module:
    """Shard ``module`` in place over ``axis`` (see the module's
    docstring) and return it. Call it on the unsharded model that every
    rank holds alike, before its optimizer is made."""
    if getattr(module, "model_axis", None) is not None:
        raise ValueError("the module is already sharded")
    for sub in list(module.modules()):
        if isinstance(sub, (Conv, ConvTranspose, Dense)):
            _shard_layer(sub, axis)
        elif isinstance(sub, (GroupNorm, FastGroupNorm,
                              FusedGroupNormAct)):
            _shard_norm(sub, axis)
        sub.model_axis = axis
    return module


def module_axis(module: nn.Module) -> Optional[ModelAxis]:
    """The axis ``module`` is sharded over; ``None`` if it is not."""
    return getattr(module, "model_axis", None)


def shard_of(t: Tensor) -> Optional[Tuple[int, ModelAxis]]:
    """(dim, axis) of a sharded parameter; ``None`` otherwise."""
    return getattr(t, "model_shard", None)


def full_shape(t: Tensor) -> Tuple[int, ...]:
    """The logical shape of a parameter (a shard's full tensor's)."""
    shape = list(t.shape)
    shard = shard_of(t)
    if shard is not None:
        shape[shard[0]] *= shard[1].size
    return tuple(shape)


# ------------------------------------------------------- full tensors
def _gather_full(t: Tensor, shard) -> Tensor:
    """The full tensor of ``t``, a block of a parameter of sharding
    ``shard`` (``t`` itself where it is ``None``)."""
    if shard is None:
        return t.detach()
    with torch.no_grad():
        return _all_gather(t.detach(), shard[0], shard[1])


def _block(t: Tensor, shard) -> Tensor:
    """This rank's block of the full tensor ``t`` (``t`` where ``shard``
    is ``None``)."""
    return t if shard is None else _slice(t, shard[0], shard[1])


def full_state_dict(module: nn.Module) -> Dict[str, Tensor]:
    """``module.state_dict()`` with every shard gathered to its full
    tensor: the unsharded model's state dict. A collective over the model
    group."""
    return {key: _gather_full(t, shard_of(t))
            for key, t in module.state_dict(keep_vars=True).items()}


def load_full_state_dict(module: nn.Module, state: Dict[str, Tensor]
                         ) -> None:
    """Load the unsharded model's ``state`` into ``module``: each
    sharded parameter takes its block of the full tensor."""
    own = module.state_dict(keep_vars=True)
    module.load_state_dict({
        key: _block(t, shard_of(own[key]) if key in own else None)
        for key, t in state.items()})


def full_optimizer_state(optimizer: torch.optim.Optimizer,
                         params: List[nn.Parameter]) -> Dict:
    """``optimizer.state_dict()["state"]`` with each moment of a sharded
    parameter gathered to its full tensor (a collective over the model
    group); Adam's ``step`` is replicated."""
    return {i: {k: (_gather_full(v, shard_of(params[i])) if k != "step"
                    else v) for k, v in entry.items()}
            for i, entry in optimizer.state_dict()["state"].items()}


def load_full_optimizer_state(state: Dict, params: List[nn.Parameter]
                              ) -> Dict:
    """The full optimizer ``state`` cut to this rank's blocks."""
    return {i: {k: (_block(v, shard_of(params[i])) if k != "step"
                    else v) for k, v in entry.items()}
            for i, entry in state.items()}

