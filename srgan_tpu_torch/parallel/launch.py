"""Spawn the ranks of a data-parallel or data × model run and join them.

:func:`launch` starts one process a rank (``torch.multiprocessing``,
``spawn``), each of which joins the group (:func:`~srgan_tpu_torch.
parallel.tp.make_grid`: the data-parallel group, or with ``model`` > 1
the grid of data × model ranks; a ``file://`` store in a new directory:
the caller's, or a temporary one) and calls ``fn(dp, *args)``; it joins
them within a time limit and returns their results by rank. A rank that raises or dies ends the
others and raises here; so does the time limit.

:func:`run_experiment` runs an experiment on the ranks: every rank
builds the same experiment on its own device and runs an action on it
(``train`` by default) under one trial directory resolved before the
spawn. ``Experiment.train()``, and through it the command line, calls it
when the settings ask for more than one rank; a caller that names the
devices (two ranks on one card) calls it directly.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from srgan_tpu_torch.parallel.mesh import (COLLECTIVE_TIMEOUT_S,
                                           DataParallel)
from srgan_tpu_torch.parallel.tp import make_grid


def _rank_main(rank: int, fn: Callable, devices: Sequence[torch.device],
               model: int, directory: str, collective_timeout_s: float,
               threads: Optional[int], args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    dp = make_grid(len(devices) // model, model, devices, rank,
                   init_file=os.path.join(directory, "store"),
                   timeout_s=collective_timeout_s)
    try:
        result = fn(dp, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(directory, f"result_{rank}.pt"))


def _stop(processes) -> None:
    for p in processes:
        if p.is_alive():
            p.terminate()
    for p in processes:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def launch(fn: Callable[..., Any], devices: Sequence, args: tuple = (), *,
           model: int = 1, timeout_s: Optional[float] = None,
           collective_timeout_s: float = COLLECTIVE_TIMEOUT_S,
           threads: Optional[int] = None,
           directory: Optional[str] = None) -> List[Any]:
    """``fn(dp, *args)`` on one spawned process per entry of ``devices``;
    their results, by rank. With ``model`` > 1 the ranks form a grid of
    ``len(devices) / model`` data × ``model`` model ranks.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).
    ``timeout_s`` bounds the whole run (``None``: no bound); a collective
    that waits ``collective_timeout_s`` raises in its rank. ``threads``
    sets each rank's ``torch.set_num_threads``. ``directory``, which must
    not exist yet, takes the group's store and the results (default: a
    temporary directory, removed after)."""
    devices = [torch.device(d) for d in devices]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    with contextlib.ExitStack() as stack:
        if directory is None:
            directory = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="srgan_ranks_"))
        else:
            os.makedirs(directory)
        context = mp.start_processes(
            _rank_main, args=(fn, devices, model, directory,
                              collective_timeout_s, threads, args),
            nprocs=len(devices), join=False, start_method="spawn")
        try:
            while True:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if context.join(timeout=left):
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{len(devices)} ranks of {fn.__name__} did not "
                        f"finish within {timeout_s:g} s")
        finally:
            _stop(context.processes)
        return [torch.load(os.path.join(directory, f"result_{r}.pt"),
                           weights_only=False)
                for r in range(len(devices))]


def _run_action(dp: DataParallel, experiment_cls, settings, action,
                trial_directory: Optional[str], action_args: tuple):
    experiment = experiment_cls(settings, data_parallel=dp)
    experiment.given_trial_directory = trial_directory
    return action(experiment, *action_args)


def train_action(experiment) -> int:
    """The ranks' ``train()``; returns the step reached."""
    return experiment.train().step


def run_experiment(experiment_cls, settings, devices: Sequence,
                   action: Callable = train_action,
                   action_args: tuple = (),
                   trial_directory: Optional[str] = None, *,
                   model: int = 1, timeout_s: Optional[float] = None,
                   collective_timeout_s: float = COLLECTIVE_TIMEOUT_S,
                   threads: Optional[int] = None,
                   directory: Optional[str] = None) -> List[Any]:
    """``action(experiment_cls(settings, data_parallel=dp), *action_args)``
    on every rank of ``devices``; the actions' results, by rank. Every
    rank trains under ``trial_directory`` (rank 0 alone writes there).
    The keywords are :func:`launch`'s."""
    return launch(_run_action, devices,
                  (experiment_cls, settings, action, trial_directory,
                   action_args),
                  model=model, timeout_s=timeout_s,
                  collective_timeout_s=collective_timeout_s,
                  threads=threads, directory=directory)
