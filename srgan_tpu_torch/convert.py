"""flax parameter trees → the port's ``state_dict``s.

Input: the ``params`` collection of a flax model as nested dicts of NumPy
arrays (``jax.device_get`` of the tree, or a restored checkpoint), with
or without the outer ``{"params": ...}``. Output: a ``state_dict`` that
the matching port module loads with ``load_state_dict``.

Layout rules (``srgan_tpu_torch.models.dcgan``):

* ``Conv_i`` kernel [kh, kw, in, out] → weight [out, in, kh, kw].
* ``ConvTranspose_i`` kernel [kh, kw, in, out] → weight [in, out, kh, kw]
  flipped in H and W (flax does not flip the kernel of a transposed conv;
  ``conv_transpose2d`` does).
* ``Dense_i`` kernel [in, out] → weight [out, in].
* ``GroupNorm_i`` (``norm_impl="xla"``), ``FastGroupNorm_i``
  (``"fast"``) or ``FusedGroupNormAct_i`` (``"pallas"``) scale / bias →
  ``norms.i.scale`` / ``norms.i.bias``; the three norm modules of the
  port keep these keys.

The port's ``ConvRegressor`` flattens its last map in NHWC order, as the
flax model does, so its dense kernels convert by the plain transpose.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _tree(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, np.float32, order="C"))


def conv_weight(kernel) -> torch.Tensor:
    return _tensor(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def conv_transpose_weight(kernel) -> torch.Tensor:
    flipped = np.asarray(kernel)[::-1, ::-1]
    return _tensor(np.transpose(flipped, (2, 3, 0, 1)))


def dense_weight(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel).T)


_NORM_NAMES = ("GroupNorm", "FastGroupNorm", "FusedGroupNormAct")


def _has_norms(tree: Mapping) -> bool:
    return any(f"{name}_0" in tree for name in _NORM_NAMES)


def _norm_leaf(tree: Mapping, i: int) -> Mapping:
    for name in _NORM_NAMES:
        if f"{name}_{i}" in tree:
            return tree[f"{name}_{i}"]
    raise KeyError(f"no GroupNorm_{i}, FastGroupNorm_{i} or "
                   f"FusedGroupNormAct_{i} in the tree")


def _norms(tree: Mapping, count: int) -> StateDict:
    out = {}
    for i in range(count):
        leaf = _norm_leaf(tree, i)
        out[f"norms.{i}.scale"] = _tensor(leaf["scale"])
        out[f"norms.{i}.bias"] = _tensor(leaf["bias"])
    return out


def _conv(out: StateDict, prefix: str, leaf: Mapping) -> None:
    out[f"{prefix}.weight"] = conv_weight(leaf["kernel"])
    out[f"{prefix}.bias"] = _tensor(leaf["bias"])


def _dense(out: StateDict, prefix: str, leaf: Mapping) -> None:
    out[f"{prefix}.weight"] = dense_weight(leaf["kernel"])
    out[f"{prefix}.bias"] = _tensor(leaf["bias"])


def joint_cnn_state_dict(params: Mapping) -> StateDict:
    """flax ``JointCNN``, ``JointDCNN`` or ``SpatialPyramidCNN`` → the
    port's model of the same name (``srgan_tpu_torch.models.crowd``),
    with or without norms: ``Conv_i`` → ``convs.i``, the norms →
    ``norms.i``, ``pyramid_<level>`` → ``pyramid.<level>``, and the two
    heads by name."""
    tree = _tree(params)
    out: StateDict = {}
    count = sum(1 for name in tree if name.startswith("Conv_"))
    for i in range(count):
        _conv(out, f"convs.{i}", tree[f"Conv_{i}"])
    if _has_norms(tree):
        out.update(_norms(tree, count))
    for name in tree:
        if name.startswith("pyramid_"):
            _conv(out, f"pyramid.{name.split('_', 1)[1]}", tree[name])
    for head in ("density_head", "count_head"):
        _conv(out, head, tree[head])
    return out


def generator_state_dict(params: Mapping) -> StateDict:
    """flax ``DCGANGenerator`` / ``CrowdDCGenerator`` →
    ``srgan_tpu_torch.models.dcgan.DCGANGenerator``."""
    tree = _tree(params)
    out: StateDict = {}
    _dense(out, "dense", tree["Dense_0"])
    num_ups = sum(1 for name in tree if name.startswith("ConvTranspose_"))
    for i in range(num_ups):
        leaf = tree[f"ConvTranspose_{i}"]
        out[f"deconvs.{i}.weight"] = conv_transpose_weight(leaf["kernel"])
        out[f"deconvs.{i}.bias"] = _tensor(leaf["bias"])
    out.update(_norms(tree, num_ups))  # one after Dense, one per inner deconv
    return out


def mlp_state_dict(params: Mapping) -> StateDict:
    """flax ``CoefficientGenerator`` / ``CoefficientMLP`` →
    ``srgan_tpu_torch.models.mlp``: ``Dense_i`` → ``layers.i``."""
    tree = _tree(params)
    out: StateDict = {}
    count = sum(1 for name in tree if name.startswith("Dense_"))
    for i in range(count):
        _dense(out, f"layers.{i}", tree[f"Dense_{i}"])
    return out


def conv_regressor_state_dict(params: Mapping) -> StateDict:
    """flax ``ConvRegressor`` → ``srgan_tpu_torch.models.dcgan.
    ConvRegressor``: ``Conv_i`` → ``convs.i``, the norms → ``norms.i``,
    ``Dense_0`` (the features) → ``dense``, ``Dense_1`` → ``head``."""
    tree = _tree(params)
    out: StateDict = {}
    count = sum(1 for name in tree if name.startswith("Conv_"))
    for i in range(count):
        _conv(out, f"convs.{i}", tree[f"Conv_{i}"])
    out.update(_norms(tree, count))
    _dense(out, "dense", tree["Dense_0"])
    _dense(out, "head", tree["Dense_1"])
    return out
