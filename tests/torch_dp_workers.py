"""Rank workers of ``tests/test_torch_port_parallel.py`` and
``tests/test_torch_port_tensor_parallel.py``.

The port's launcher (``srgan_tpu_torch.parallel.launch``) spawns the
ranks, which import this module by name: it imports no JAX, so that a
rank loads only PyTorch and the port. Each worker takes the rank's
``DataParallel`` (or ``None``: the one-rank run, in the test's own
process) and returns plain tensors and arrays.
"""

import copy
import time

import numpy as np
import torch
import torch.distributed as dist

from srgan_tpu_torch.apps.coefficient import CoefficientExperiment
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.experiment import model_layout
from srgan_tpu_torch.models.dcgan import (Conv, gather_channels, group_norm,
                                          norm_act)
from srgan_tpu_torch.parallel import tp
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import (init_train_state, make_dnn_train_step,
                                   make_gan_train_step)

APPS = {"coefficient": CoefficientExperiment, "crowd": CrowdExperiment}


def run_all(dp, calls):
    """Several workers in one launch: ``[(key, (worker, args)), ...]`` →
    their results, by key."""
    return {key: globals()[worker](dp, *args)
            for key, (worker, args) in calls}


def _experiment(dp, app, settings_kw, weights=None):
    exp = APPS[app](Settings(**settings_kw), device="cpu", data_parallel=dp)
    bundle = exp.model_setup()
    for name, state_dict in (weights or {}).items():
        getattr(bundle, name).load_state_dict(state_dict)
    exp.models = bundle
    exp.state = init_train_state(exp.settings, bundle, dp)
    return exp


def _bias_cancelled_by_norm(module, key: str) -> bool:
    """A conv bias right before a GroupNorm of one channel per group: its
    true gradient is 0 (the norm subtracts it again)."""
    parts = key.split(".")
    if len(parts) != 3 or parts[0] not in ("convs", "deconvs") \
            or parts[2] != "bias":
        return False
    i = int(parts[1]) + (1 if parts[0] == "deconvs" else 0)
    norms = getattr(module, "norms", None)
    if norms is None or i >= len(norms):
        return False
    return norms[i].num_groups == norms[i].scale.numel()


def _share(dp, n):
    return slice(None) if dp is None else dp.share(n)


def gan_step(dp, app, settings_kw, weights, batch, draws):
    """One SR-GAN step of ``app`` from ``weights`` (state dicts by model)
    on this rank's share of ``batch`` (the global host arrays x, y, u;
    images NHWC) with the global ``draws`` (z_d, z_g, alpha): the
    metrics, and each model's parameters and averaged gradients after
    the step."""
    exp = _experiment(dp, app, settings_kw, weights)
    step = make_gan_train_step(exp.settings,
                               labeled_loss_fn=exp.labeled_loss_fn(),
                               latent_shape=exp.latent_shape(), dp=dp)
    share = _share(dp, len(batch[0]))
    x, y, u = (torch.from_numpy(np.ascontiguousarray(a[share]))
               for a in batch)
    state, metrics = step(exp.state, model_layout(x), y, model_layout(u),
                          **{k: torch.from_numpy(np.asarray(v))
                             for k, v in draws.items()})
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "cancelled": set()}
    for name in ("d", "g", "dnn"):
        module = getattr(state, name)
        out[name] = {k: p.detach().clone()
                     for k, p in module.named_parameters()}
        out[f"{name}_grad"] = {k: p.grad.clone()
                               for k, p in module.named_parameters()}
        inner = getattr(module, "model", module)  # InputAffine's
        out["cancelled"] |= {(name, k) for k in out[name] if
                             _bias_cancelled_by_norm(inner, k)}
    return out


def dnn_step(dp, settings_kw, weights, batch):
    """One DNN-only step of the coefficient app on this rank's share of
    ``batch`` (x, y): the metrics, the DNN's parameters and averaged
    gradients after the step."""
    exp = _experiment(dp, "coefficient", dict(settings_kw, dnn_only=True),
                      weights)
    step = make_dnn_train_step(exp.settings, dp=dp)
    share = _share(dp, len(batch[0]))
    x, y = (torch.from_numpy(np.ascontiguousarray(a[share]))
            for a in batch[:2])
    state, metrics = step(exp.state, x, y)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "dnn": {k: p.detach().clone()
                    for k, p in state.dnn.named_parameters()},
            "dnn_grad": {k: p.grad.clone()
                         for k, p in state.dnn.named_parameters()}}


def predictions(dp, app, settings_kw, weights):
    """The evaluation paths split over the ranks: ``predict`` of the
    validation split (generic apps) or the crowd grid's counts and
    density maps."""
    exp = _experiment(dp, app, settings_kw, weights)
    exp.dataset_setup()
    exp.prepare_train_step()
    if app == "crowd":
        return {"counts": exp.predict_image_counts(use_dnn=False),
                "maps": exp.predict_density_maps(use_dnn=True),
                "metrics": exp.evaluate()}
    return {"predict": exp.predict(exp.validation_dataset, use_dnn=False),
            "metrics": exp.evaluate(use_dnn=True)}


def sharded_samples(dp, settings_kw, steps, draws_checked):
    """The crowd app's resident sampler on this rank: its local counts,
    the host rows it holds, ``steps`` steps of (draws, patches NHWC), and
    ``draws_checked`` steps of labeled and unlabeled indices."""
    exp = CrowdExperiment(Settings(**settings_kw), device="cpu",
                          data_parallel=dp)
    exp.dataset_setup()
    exp._upload_databases()
    data = exp._device_data
    stream = exp._patch_args_stream()
    samples = []
    for _ in range(steps):
        args = next(stream)
        patches, labels, upatches = exp._sample_batch(
            data["labeled_images"], data["labeled_density"],
            data["unlabeled_images"], *args)
        samples.append((args, patches.permute(0, 2, 3, 1).numpy(),
                        labels.numpy(), upatches.permute(0, 2, 3, 1).numpy()))
    indices = [next(stream) for _ in range(draws_checked)]
    return {"counts": (exp._labeled_local_counts,
                       exp._unlabeled_local_counts),
            "bounds": (exp._labeled_index_bound,
                       exp._unlabeled_index_bound),
            "labeled_images": data["labeled_images"].numpy(),
            "unlabeled_images": data["unlabeled_images"].numpy(),
            "samples": samples,
            "labeled_idx": np.stack([a[0] for a in indices]),
            "unlabeled_idx": np.stack([a[4] for a in indices])}


def host_tier_batches(dp, settings_kw, epochs):
    """The crowd app's host tier on this rank: the first batch of each of
    ``epochs`` epochs (uint8 images NHWC, labels, uint8 unlabeled NHWC)
    and the number of native readers and prefetchers it opened."""
    exp = CrowdExperiment(Settings(**settings_kw), device="cpu",
                          data_parallel=dp)
    exp.dataset_setup()
    exp.prepare_train_step()
    try:
        iterators = exp.epoch_batch_iterators()
        batches = [tuple(t.numpy() for t in next(next(iterators)))
                   for _ in range(epochs)]
        return {"batches": batches, "host_io": len(exp._host_io)}
    finally:
        exp.close()


def window_refreshes(dp, settings_kw, steps):
    """The crowd app's windows on this rank refreshed at steps
    ``0..steps-1``: each window's global and local ids and this rank's
    buffers after every step."""
    exp = CrowdExperiment(Settings(**settings_kw), device="cpu",
                          data_parallel=dp)
    exp.dataset_setup()
    exp._upload_databases()
    trace = []
    try:
        for step in range(steps):
            exp._refresh_windows(step)
            trace.append({name: buffer.clone() for name, buffer
                          in exp._device_data.items()
                          if name != "validation_images"})
        return {"trace": trace,
                "resident": [w.resident_ids() for w in exp._windows],
                "local": [w.local_ids() for w in exp._windows],
                "refreshes": [w.refresh_count for w in exp._windows]}
    finally:
        exp.close()


def fail_on_rank(dp, rank):
    """Rank ``rank`` raises; the others wait for it at a barrier."""
    if dp.rank == rank:
        raise RuntimeError(f"rank {rank} fails")
    dist.barrier()


def hang(dp):
    """A rank that outlasts any test's time limit."""
    time.sleep(600)


def trained_models(experiment):
    """A rank's ``train()``: the models after it, on the host, and the
    (model, key) of each conv bias a one-channel GroupNorm cancels."""
    state = experiment.train()
    out = {"cancelled": set()}
    for name in ("d", "g", "dnn"):
        module = getattr(state, name)
        out[name] = {k: v.detach().cpu()
                     for k, v in module.state_dict().items()}
        inner = getattr(module, "model", module)  # InputAffine's
        out["cancelled"] |= {(name, k) for k in out[name]
                             if _bias_cancelled_by_norm(inner, k)}
    return out


def _metrics_list(chunk_metrics, steps):
    return [{k: v[i].clone() for k, v in chunk_metrics.items()}
            for i in range(steps)]


def _models(state):
    return {name: {k: v.detach().clone()
                   for k, v in getattr(state, name).state_dict().items()}
            for name in ("d", "g", "dnn")}


def chunk_against_steps(dp, settings_kw):
    """One chunk of ``steps_per_dispatch`` steps of the crowd app and, on a
    second experiment from the same seed, as many single steps: their
    metrics and models, and the generators' states after."""
    out = {}
    for how in ("chunk", "steps"):
        exp = CrowdExperiment(Settings(**settings_kw), device="cpu",
                              data_parallel=dp)
        exp.dataset_setup()
        exp.models = exp.model_setup()
        exp.state = init_train_state(exp.settings, exp.models, dp)
        exp.prepare_train_step()
        args = exp._patch_args_stream()
        k = exp.settings.steps_per_dispatch
        if how == "chunk":
            metrics = _metrics_list(exp.dispatch_chunk(args), k)
        else:
            data = exp._device_data
            metrics = []
            for _ in range(k):
                batch = exp._sample_batch(
                    data["labeled_images"], data["labeled_density"],
                    data["unlabeled_images"], *next(args))
                exp.state, m = exp._train_step(exp.state, *batch, exp._rng)
                metrics.append(m)
        out[how] = {"metrics": metrics, "models": _models(exp.state),
                    "step": exp.state.step, "rng": exp._rng.get_state(),
                    "next_args": next(args)}
        exp.close()
    return out


def train_chunked(dp, settings_kw, trial_directory):
    """``train()`` on this rank under ``trial_directory``: the models
    after it and the (model, key) of each cancelled conv bias."""
    exp = CrowdExperiment(Settings(**settings_kw), device="cpu",
                          data_parallel=dp)
    exp.given_trial_directory = trial_directory
    return trained_models(exp)


# ------------------------------------------------- tensor parallelism
def _full_models(state):
    """Each model's full parameters and Adam moments on this rank: the
    shards gathered over the model ranks (a collective)."""
    out = {}
    for name in ("d", "g", "dnn"):
        module, opt = getattr(state, name), getattr(state, f"{name}_opt")
        out[name] = {k: v.cpu() for k, v in
                     tp.full_state_dict(module).items()}
        out[f"{name}_opt"] = {
            i: {k: v.cpu() for k, v in entry.items()} for i, entry in
            tp.full_optimizer_state(opt.adam, opt.params).items()}
    return out


def _moments(state, full, names=("d", "g", "dnn")):
    """Each model's full Adam moments by parameter name, from
    :func:`_full_models`' ``full``: after one step, the clipped and
    averaged gradient g as ``exp_avg`` = (1 − β1)·g and ``exp_avg_sq`` =
    (1 − β2)·g²."""
    out = {}
    for name in names:
        opt = full[f"{name}_opt"]
        out[name] = {k: {m: opt[i][m] for m in ("exp_avg", "exp_avg_sq")}
                     for i, (k, _) in enumerate(
                         getattr(state, name).named_parameters())}
    return out


def _local_shapes(state):
    """This rank's shapes of each model's parameters and Adam moments."""
    out = {}
    for name in ("d", "g", "dnn"):
        opt = getattr(state, f"{name}_opt")
        names = [k for k, _ in getattr(state, name).named_parameters()]
        out[name] = {k: tuple(p.shape) for k, p in
                     getattr(state, name).named_parameters()}
        out[f"{name}_opt"] = {
            names[i]: {k: tuple(v.shape) for k, v in entry.items()
                       if k != "step"}
            for i, entry in opt.adam.state_dict()["state"].items()}
    return out


def tp_gan_step(dp, app, settings_kw, weights, batch, draws):
    """One SR-GAN step of ``app`` on a grid (or one rank: ``dp=None``):
    the metrics, the full models and Adam moments after the step and this
    rank's local shapes."""
    exp = _experiment(dp, app, settings_kw, weights)
    step = make_gan_train_step(exp.settings,
                               labeled_loss_fn=exp.labeled_loss_fn(),
                               latent_shape=exp.latent_shape(), dp=dp)
    share = _share(dp, len(batch[0]))
    x, y, u = (torch.from_numpy(np.ascontiguousarray(a[share]))
               for a in batch)
    state, metrics = step(exp.state, model_layout(x), y, model_layout(u),
                          **{k: torch.from_numpy(np.asarray(v))
                             for k, v in draws.items()})
    full = _full_models(state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "models": full, "moments": _moments(state, full),
            "shapes": _local_shapes(state)}


def tp_dnn_step(dp, settings_kw, weights, batch):
    """One DNN-only step of the coefficient app: the metrics and the full
    DNN and its Adam moments after it."""
    exp = _experiment(dp, "coefficient", dict(settings_kw, dnn_only=True),
                      weights)
    step = make_dnn_train_step(exp.settings, dp=dp)
    share = _share(dp, len(batch[0]))
    x, y = (torch.from_numpy(np.ascontiguousarray(a[share]))
            for a in batch[:2])
    state, metrics = step(exp.state, x, y)
    full = _full_models(state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "dnn": full["dnn"], "moments": _moments(state, full, ("dnn",))["dnn"]}


class Block(torch.nn.Module):
    """conv → GroupNorm + LeakyReLU → conv, gathered at the end: the unit
    of the sharded layers' tests."""

    def __init__(self, cin, width, cout, groups, impl, rng):
        super().__init__()
        f32 = torch.float32
        self.conv1 = Conv(cin, width, 3, dtype=f32, rng=rng)
        self.norm = group_norm(width, f32, impl, max_groups=groups)
        self.conv2 = Conv(width, cout, 3, 2, dtype=f32, rng=rng)
        self.cout = cout

    def forward(self, x):
        x = norm_act(self.conv1(x), self.norm, 0.2)
        return gather_channels(self, self.conv2(x), self.cout)


def _penalty_pass(block, x):
    """The block's output, its penalty-style input gradient and penalty,
    and the gradient of (loss + penalty) w.r.t. its parameters, full."""
    x = x.clone().requires_grad_(True)
    y = block(x)
    weight = torch.linspace(0.5, 1.5, y.shape[1], device=y.device)
    loss = (y.square() * weight[:, None, None]).mean()
    (gx,) = torch.autograd.grad(loss, x, create_graph=True)
    penalty = (gx.flatten(1).norm(dim=1) - 1.0).square().mean()
    params = list(block.parameters())
    grads = torch.autograd.grad(loss + penalty, params)
    full = {}
    for (name, p), g in zip(block.named_parameters(), grads):
        shard = tp.shard_of(p)
        full[name] = (g if shard is None
                      else shard[1].gather(g, shard[0])).detach()
    return {"y": y.detach(), "gx": gx.detach(), "penalty": penalty.detach(),
            "grads": full}


def tp_block(dp, cin, width, cout, groups, impl, seed, device="cpu"):
    """The :class:`Block` unsharded and sharded over the model axis, on
    the same input: their penalty passes (on the host), and the sharded
    norm's groups."""
    block = Block(cin, width, cout, groups, impl,
                  torch.Generator().manual_seed(seed))
    x = torch.randn(4, cin, 8, 8, generator=torch.Generator().manual_seed(
        seed + 1)).to(device).contiguous(memory_format=torch.channels_last)
    block = block.to(device, memory_format=torch.channels_last)
    want = _penalty_pass(copy.deepcopy(block), x)
    tp.shard_module(block, dp.model)
    got = _penalty_pass(block, x)
    host = lambda tree: {k: (host(v) if isinstance(v, dict) else v.cpu())
                         for k, v in tree.items()}
    return {"want": host(want), "got": host(got),
            "local_groups": block.norm.num_groups,
            "local_width": block.conv1.weight.shape[0]}


def tp_trained_models(experiment):
    """A grid rank's ``train()``: its step and the full models and Adam
    moments after it."""
    state = experiment.train()
    return dict(_full_models(state), step=state.step)
