"""Checkpoint and resume of the whole train state.

The port of ``srgan_tpu.checkpoint``. A checkpoint holds everything a
trial needs to go on: the step, the D, G and DNN parameters and buffers,
their Adam moments, and the structure they were saved with. It is one
``torch.save`` file, ``<trial>/checkpoints/step_<N>/state.pt``, written
under a temporary directory name and renamed into place, so a reader
never finds half a checkpoint.

Adam's step count is saved as a host tensor whether it lived on the
card (a ``capturable`` Adam, ``steps_per_dispatch`` > 1 on a card) or
on the host; ``torch.optim``'s loading puts it back where the restoring
optimizer keeps it, so a trial saved at one ``steps_per_dispatch``
resumes at another.

Under tensor parallelism (``parallel/tp.py``) a checkpoint holds the
full logical tensors, as JAX's Orbax save of global arrays does: the
snapshot gathers every shard of the parameters and Adam moments over
the model ranks, and a restore cuts each rank's blocks from the full
tensors. So a trial saved on a grid restores into one process, and the
reverse.

The optimizers' hyperparameters (learning rate, betas, decay) are not
restored: as in the JAX package, where they live in the optax
transformation and not in its state, a resumed trial takes them from its
settings.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import tempfile
from typing import Dict, List

import torch

from srgan_tpu_torch.parallel import tp

CHECKPOINT_SUBDIR = "checkpoints"
STATE_FILE = "state.pt"
_MODELS = ("d", "g", "dnn")


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _step_path(directory: str, step: int) -> str:
    return os.path.join(_abspath(directory), CHECKPOINT_SUBDIR,
                        f"step_{step}")


def _structure(module: torch.nn.Module) -> Dict[str, str]:
    """Each state-dict entry with the class of the module that owns it,
    its shape and its dtype: the port's counterpart of the parameter
    paths that tell a flax model with ``GroupNorm_i`` from one with
    ``FastGroupNorm_i`` or ``FusedGroupNormAct_i``."""
    out = {}
    for key, tensor in module.state_dict(keep_vars=True).items():
        owner = module.get_submodule(key.rpartition(".")[0])
        out[key] = (f"{type(owner).__name__} {tp.full_shape(tensor)} "
                    f"{tensor.dtype}")
    return out


def _to_host(tree):
    """A copy of ``tree`` with every tensor copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def gather_state(state) -> dict:
    """The models' and Adam's full tensors, where they live. Under tensor
    parallelism a collective over the model ranks, which every model rank
    of the writer's data rank takes part in."""
    out = {}
    for name in _MODELS:
        module = getattr(state, name)
        if module is None:
            continue
        opt = getattr(state, f"{name}_opt")
        out[name] = tp.full_state_dict(module)
        out[f"{name}_opt"] = tp.full_optimizer_state(opt.adam, opt.params)
    return out


def snapshot(state) -> dict:
    """The train state copied to host memory: what a checkpoint holds.
    Blocks until the device→host copies are done, so that the caller may
    go on updating ``state`` at once. Under tensor parallelism the full
    tensors (:func:`gather_state`)."""
    out = _to_host(gather_state(state))
    out["step"] = int(state.step)
    out["structure"] = {name: _structure(getattr(state, name))
                        for name in _MODELS
                        if getattr(state, name) is not None}
    return out


def _write(snap: dict, path: str) -> str:
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".",
                           suffix=".partial", dir=parent)
    try:
        torch.save(snap, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):  # a save of the same step overwrites
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def save_state(state, directory: str, step: int) -> str:
    """Save the train state under ``directory/checkpoints/step_<N>``
    (synchronous; the training loop uses :class:`AsyncStateCheckpointer`)."""
    return _write(snapshot(state), _step_path(directory, step))


class AsyncStateCheckpointer:
    """Saves that overlap training.

    ``save()`` blocks only for the device→host copy of the state; the
    file is written on one background thread while the next steps run.
    :meth:`close` waits for every pending write and raises the first
    error of one.
    """

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint")
        self._pending: List[concurrent.futures.Future] = []

    def save(self, state, directory: str, step: int) -> str:
        path = _step_path(directory, step)
        self._pending.append(self._pool.submit(_write, snapshot(state),
                                               path))
        return path

    def wait_until_finished(self) -> None:
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def close(self) -> None:
        """Wait for pending writes, then stop the background thread."""
        try:
            self.wait_until_finished()
        finally:
            self._pool.shutdown(wait=True)


def latest_checkpoint(directory: str) -> str | None:
    root = os.path.join(_abspath(directory), CHECKPOINT_SUBDIR)
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:  # a temporary directory of a write
                continue
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])


def restore_state(state, path: str):
    """Load a checkpoint into ``state`` (its modules and optimizers, in
    place) and return it.

    ``path`` is a checkpoint directory (``.../step_<N>``) or a trial
    directory, whose latest checkpoint is used, as
    ``Settings.load_model_path`` means. Raises ``FileNotFoundError``
    without a checkpoint, and ``ValueError`` when the checkpoint's
    structure is not the state's (another ``norm_impl``, width or model).
    """
    path = _abspath(path)
    if not os.path.basename(path).startswith("step_"):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = found
    snap = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    want = {name: _structure(getattr(state, name)) for name in _MODELS
            if getattr(state, name) is not None}
    if snap["structure"] != want:
        saved, current = snap["structure"], want
        differ = sorted(
            f"{model}.{key}: saved {saved.get(model, {}).get(key)}, "
            f"now {current.get(model, {}).get(key)}"
            for model in set(saved) | set(current)
            for key in set(saved.get(model, {})) | set(current.get(model, {}))
            if saved.get(model, {}).get(key) != current.get(model, {}).get(key))
        raise ValueError(
            f"checkpoint at {path} does not match the current model "
            f"structure. Restore with the SAME architecture settings the "
            f"trial was trained with (norm_impl, crowd_model, "
            f"model_base_width, dnn_use_norm, ...). Differences: "
            f"{'; '.join(differ[:8])}")
    for name in want:
        tp.load_full_state_dict(getattr(state, name), snap[name])
        opt = getattr(state, f"{name}_opt")
        # The moments from the checkpoint, the hyperparameters of now.
        opt.adam.load_state_dict({
            "state": tp.load_full_optimizer_state(snap[f"{name}_opt"],
                                                  opt.params),
            "param_groups": opt.adam.state_dict()["param_groups"]})
    state.step = snap["step"]
    return state
