"""One run of a cell: the program's trial built as its ``train()`` builds
it, the checked first steps, the warm-up and the measured window.

The window drives what ``Experiment.training_loop`` does each step: the
next batch of ``epoch_batch_iterators()``, ``Experiment._step``, and
``step_summaries`` at the settings' summary period (a read of the losses
every 100 steps by default). Validation passes and checkpoint saves are
left out. The loop runs until ``seconds`` have passed on the host's
clock and ends on ``torch.cuda.synchronize()``; a CUDA event recorded
after each step gives the step times once the window has closed.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import inspect
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import trace as trace_reader
from benchmark.harness.weights import (device_generator, make_weights,
                                       stream_seed)

# The calls of Experiment.train(), in order, that build a trial up to its
# training loop; prepare() makes the same ones.
TRAIN_SETUP_CALLS = ["check_supported", "check_settings",
                     "set_float32_precision", "_make_trial_directory",
                     "prepare_summary_writers", "seed_all", "dataset_setup",
                     "model_setup", "init_train_state", "load_models",
                     "prepare_train_step", "training_loop"]


def train_calls() -> List[str]:
    """The names that ``Experiment.train`` calls, in source order."""
    from srgan_tpu_torch.experiment import Experiment
    tree = ast.parse(inspect.cleandoc(
        "\n" + inspect.getsource(Experiment.train)))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            names.append((node.lineno, node.col_offset, name))
    return [n for _, _, n in sorted(names)]


def check_train_setup() -> None:
    """Raise unless ``Experiment.train`` still makes the calls of
    ``TRAIN_SETUP_CALLS`` in that order."""
    calls = train_calls()
    at = -1
    for name in TRAIN_SETUP_CALLS:
        if name not in calls[at + 1:]:
            raise RuntimeError(
                f"Experiment.train() no longer calls {name}() after "
                f"{TRAIN_SETUP_CALLS[TRAIN_SETUP_CALLS.index(name) - 1]}(): "
                f"the benchmark's set-up must follow it again")
        at = calls.index(name, at + 1)


def prepare(exp) -> None:
    """``exp.train()``'s set-up, up to its training loop, on one device."""
    from srgan_tpu_torch import experiment as ex
    from srgan_tpu_torch.train import init_train_state
    check_train_setup()
    ex.check_supported(exp.settings)
    exp.check_settings()
    ex.set_float32_precision()
    exp._evaluation_only = False
    exp.trial_directory = exp._make_trial_directory()
    exp.prepare_summary_writers()
    ex.seed_all(exp.settings.seed)
    exp.dataset_setup()
    exp.models = exp.model_setup()
    exp.state = init_train_state(exp.settings, exp.models,
                                 exp.data_parallel)
    exp.load_models()
    exp.prepare_train_step()


def modules(state) -> Dict[str, torch.nn.Module]:
    return {"d": state.d, "g": state.g, "dnn": state.dnn}


def load_weights(state, weights: Dict[str, Dict[str, torch.Tensor]]
                 ) -> None:
    """The benchmark's weights into the program's modules, in place (the
    optimizers keep their parameters); every name must match."""
    for m, module in modules(state).items():
        module.load_state_dict(weights[m], strict=True)


def host_params(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """A copy of each model's parameters on the host (a copy on the CPU
    too: the parameters train on)."""
    return {m: {k: p.detach().float().cpu().clone()
                for k, p in module.named_parameters()}
            for m, module in modules(state).items()}


def first_moments(state, settings):
    """Each model's first gradient, and its square, as its Adam holds
    them after one step: the first moment over (1 − β₁) and the second
    over (1 − β₂), with the β of the settings. A parameter without a
    moment reads NaN."""
    grads, squares = {}, {}
    for m, opt in (("d", state.d_opt), ("g", state.g_opt),
                   ("dnn", state.dnn_opt)):
        grads[m], squares[m] = {}, {}
        for k, p in modules(state)[m].named_parameters():
            moments = opt.adam.state.get(p, {})
            for out, key, beta in ((grads, "exp_avg", settings.adam_b1),
                                   (squares, "exp_avg_sq",
                                    settings.adam_b2)):
                moment = moments.get(key)
                out[m][k] = (torch.full(p.shape, math.nan) if moment is None
                             else (moment.detach().float()
                                   / (1.0 - beta)).cpu())
    return grads, squares


@dataclasses.dataclass
class Checked:
    """What the program's checked steps gave, on the host."""
    records: list            # each step's inputs, for the reference
    inputs: list             # each step's (labeled, labels, unlabeled)
    draws: list              # each step's (z_d, α, z_g)
    losses: list             # each step's {name: float}
    first_grads: Dict
    first_grad_squares: Dict
    weights: Dict            # after the last checked step
    first_weights: Dict      # after the first


def checked_steps(app, exp, data, seed: int, steps: int) -> Checked:
    """The program's first ``steps`` steps, through its input call and its
    step, on the benchmark's draws: z_d, α and z_g given to the step."""
    settings = exp.settings
    rng = np.random.default_rng(stream_seed(seed, "checked"))
    gen = device_generator(seed, "draws", exp.device)
    b, latent = settings.batch_size, settings.latent_dimension
    out = Checked([], [], [], [], None, None, None, None)
    for i, (batch, record) in enumerate(app.checked_batches(
            exp, data, rng, steps)):
        z_d = torch.randn((b, latent), generator=gen, device=exp.device)
        alpha = torch.rand((b,), generator=gen, device=exp.device)
        z_g = torch.randn((b, latent), generator=gen, device=exp.device)
        exp.state, metrics = exp._train_step(exp.state, *batch, exp._rng,
                                             z_d=z_d, z_g=z_g, alpha=alpha)
        out.records.append(record)
        out.inputs.append(tuple(t.detach().cpu() for t in batch))
        out.draws.append(tuple(t.cpu() for t in (z_d, alpha, z_g)))
        out.losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out.first_grads, out.first_grad_squares = first_moments(
                exp.state, settings)
            out.first_weights = host_params(exp.state)
    out.weights = host_params(exp.state)
    return out


def window_batches(exp):
    """The training loop's batches, epoch after epoch."""
    for epoch in exp.epoch_batch_iterators():
        yield from epoch


@dataclasses.dataclass
class Window:
    steps: int
    seconds: float                      # host clock, ends synchronized
    step_ms: List[float]                # from the CUDA events
    losses_finite: List[bool]           # per step
    spans: Dict[str, List[float]]       # host ms per step, traced runs
    profile: Optional[trace_reader.Profile] = None


def run_window(exp, batches, seconds: float, trace: bool,
               profile_steps: int) -> Window:
    """Steps until ``seconds`` have passed; with ``trace``, host spans
    around the input and the step, and the window's last
    ``profile_steps`` steps under ``torch.profiler``."""
    device = exp.device
    cuda = device.type == "cuda"
    spans = {"input": [], "step": []}
    events, metrics_kept = [], []
    profiler = profile = None
    step = exp.state.step
    if cuda:
        torch.cuda.synchronize(device)
        opened = torch.cuda.Event(enable_timing=True)
        opened.record()
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if profiler is None and trace and events:
            per_step = (now - t0) / len(events)
            if now - t0 + 1.2 * profile_steps * per_step >= seconds:
                profiler, profiled_from = trace_reader.start(device), step
                t_profile = time.perf_counter()
        elif profiler is None and now - t0 >= seconds:
            break
        label = (trace_reader.label if profiler is not None
                 else contextlib.nullcontext)
        a = time.perf_counter()
        with label("bench.input"):
            batch = next(batches)
        b = time.perf_counter()
        with label("bench.step"):
            exp.state, metrics = exp._step(*batch)
        c = time.perf_counter()
        with label("bench.summary"):
            exp.step_summaries(step, lambda: metrics)
        step += 1
        metrics_kept.append(metrics)
        if cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append(event)
        else:
            events.append(None)
        if trace:
            spans["input"].append(1e3 * (b - a))
            spans["step"].append(1e3 * (c - b))
        if profiler is not None and step - profiled_from >= profile_steps:
            profile = trace_reader.stop(profiler, device, t_profile,
                                        step - profiled_from)
            break
    if cuda:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    step_ms = ([opened.elapsed_time(e) for e in events] if cuda else [])
    finite = torch.isfinite(torch.stack(
        [torch.stack([t.float() for t in m.values()])
         for m in metrics_kept])).all(dim=1).tolist()
    return Window(len(events), elapsed, step_ms, finite, spans, profile)


def free(exp) -> None:
    """Close the trial and drop the program's state from the device."""
    import gc
    exp.close()
    exp.state = exp.models = exp._train_step = None
    if hasattr(exp, "_device_data"):
        exp._device_data = None
    gc.collect()
    if exp.device.type == "cuda":
        torch.cuda.empty_cache()


def initial_weights(app, cell_config, data, seed: int, device):
    return make_weights(app.weight_shapes(cell_config), seed, device,
                        app.fixed_weights(cell_config, data))
