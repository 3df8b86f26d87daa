"""Record / compare golden loss traces of the port's fused SR-GAN step.

The port of ``tools/golden_trace.py``. A golden trace is the per-step
metric dict of a fixed-seed float32 run of one app's fused step at a
tiny size (TF32 off): the coefficient MLPs, the age DCGAN, the driving
frame stack or the crowd conv / GroupNorm / two-head models. The batches
are the JAX tool's NumPy draws (index draws with replacement; the crowd
app's fixed top-left patches), so they are the same on every device.

Where the draws come from:

* ``params`` and ``draws`` given (``--draws FILE.npz`` on the command
  line): the JAX package's initial parameters, mapped through
  ``srgan_tpu_torch/convert.py``, and its per-step z_d, α and z_g. With
  them the port replays the JAX package's committed ``traces/*.json``.
  Only JAX can write such a file (``npz_of``'s layout); the port's tests
  do.
* otherwise: the port's own init (``model_setup``) and z_d, α and z_g
  drawn on the host from ``generator_for(seed, "train")`` in the step's
  order, so that a trace recorded on the CPU compares on the card.

Usage:
    python -m srgan_tpu_torch.tools.golden_trace record --out t.json \\
        [--app coefficient|age|crowd|driving] [--device cpu]
    python -m srgan_tpu_torch.tools.golden_trace compare --trace t.json \\
        [--draws jax_draws.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from srgan_tpu_torch import convert
from srgan_tpu_torch.experiment import model_layout
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import (init_train_state, make_gan_train_step,
                                   set_float32_precision)
from srgan_tpu_torch.utils.device import default_device
from srgan_tpu_torch.utils.mixture import sample_offset_normal
from srgan_tpu_torch.utils.seeding import generator_for

APPS = ("coefficient", "age", "crowd", "driving")
_IMAGE_APP = dict(batch_size=4, labeled_dataset_size=8,
                  unlabeled_dataset_size=8, validation_dataset_size=2,
                  test_dataset_size=2, age_image_size=32,
                  model_base_width=8, latent_dimension=8)
# The JAX tool's settings of each app, float32.
APP_SETTINGS = {
    "coefficient": dict(batch_size=16, labeled_dataset_size=32,
                        unlabeled_dataset_size=64,
                        validation_dataset_size=8, test_dataset_size=8),
    "age": _IMAGE_APP,
    "driving": dict(_IMAGE_APP, driving_frame_stack=2),
    "crowd": dict(batch_size=4, labeled_dataset_size=4,
                  unlabeled_dataset_size=4, validation_dataset_size=2,
                  crowd_image_height=64, crowd_image_width=64,
                  image_patch_size=32, crowd_sigma=3.0, model_base_width=8,
                  latent_dimension=8),
}
# flax tree → state_dict, per app and model.
CONVERTERS = {
    "coefficient": dict(d=convert.mlp_state_dict, g=convert.mlp_state_dict,
                        dnn=convert.mlp_state_dict),
    "age": dict(d=convert.conv_regressor_state_dict,
                g=convert.generator_state_dict,
                dnn=convert.conv_regressor_state_dict),
    "crowd": dict(d=convert.joint_cnn_state_dict,
                  g=convert.generator_state_dict,
                  dnn=convert.joint_cnn_state_dict),
}
CONVERTERS["driving"] = CONVERTERS["age"]
DRAWS = ("z_d", "alpha", "z_g")
# (rtol, atol) at which a trace of each app reproduces in another
# environment (another CPU thread count, the card against the CPU): the
# JAX package's 1e-4 / 1e-5, but for driving, whose dnn_loss falls to
# ~0.006 and moves by up to 2.6e-5 with the reduction order alone.
TOLERANCES = {"coefficient": (1e-4, 1e-5), "age": (1e-4, 1e-5),
              "crowd": (1e-4, 1e-5), "driving": (1e-4, 5e-5)}


def app_settings(app: str, seed: int, hidden_size: int) -> dict:
    """The keyword arguments of the trace's ``Settings`` (the JAX
    package's ``Settings`` takes the same)."""
    if app not in APP_SETTINGS:
        raise ValueError(f"unknown app {app!r}; choose "
                         f"coefficient|age|crowd|driving")
    extra = dict(hidden_size=hidden_size) if app == "coefficient" else {}
    return dict(APP_SETTINGS[app], seed=seed, compute_dtype="float32",
                **extra)


def make_experiment(app: str, settings: Settings, device):
    """The app's experiment on ``device``."""
    if app == "coefficient":
        from srgan_tpu_torch.apps.coefficient import CoefficientExperiment
        return CoefficientExperiment(settings, device=device)
    if app == "age":
        from srgan_tpu_torch.apps.age import AgeExperiment
        return AgeExperiment(settings, device=device)
    if app == "driving":
        from srgan_tpu_torch.apps.driving import DrivingExperiment
        return DrivingExperiment(settings, device=device)
    from srgan_tpu_torch.apps.crowd import CrowdExperiment
    return CrowdExperiment(settings, device=device)


def host_batches(app: str, experiment, settings: Settings):
    """The JAX tool's host batches: ``(labeled_x, labels, unlabeled_x)``
    as NumPy arrays, one triple a call."""
    rng = np.random.default_rng(settings.seed)
    b = settings.batch_size
    if app == "crowd":
        p = settings.image_patch_size
        images = experiment.labeled_db.images.astype(np.float32)
        density = experiment.labeled_db.density_maps
        uimages = experiment.unlabeled_db.images.astype(np.float32)
        while True:
            idx = rng.integers(0, len(images), b)
            # fixed top-left patches: host-side, hardware-independent
            patches = images[idx, :p, :p] * (2.0 / 255.0) - 1.0
            labels = density[idx, :p, :p]
            uidx = rng.integers(0, len(uimages), b)
            upatches = uimages[uidx, :p, :p] * (2.0 / 255.0) - 1.0
            yield patches, labels, upatches
    labeled = experiment.labeled_dataset
    unlabeled = experiment.unlabeled_dataset
    while True:
        idx = rng.integers(0, len(labeled), b)
        uidx = rng.integers(0, len(unlabeled), b)
        yield (labeled.examples[idx], labeled.labels[idx],
               unlabeled.examples[uidx])


def host_draws(settings: Settings, steps: int) -> Dict[str, np.ndarray]:
    """The port's own z_d, α and z_g of ``steps`` steps, [steps, B, ...],
    drawn on the host in the step's order from ``(seed, "train")``."""
    rng = generator_for(settings.seed, "train")
    b, shape = settings.batch_size, (settings.batch_size,
                                     settings.latent_dimension)
    out = {name: [] for name in DRAWS}
    for _ in range(steps):
        out["z_d"].append(sample_offset_normal(rng, shape,
                                               settings.mean_offset))
        out["alpha"].append(torch.rand((b,), generator=rng))
        out["z_g"].append(sample_offset_normal(rng, shape,
                                               settings.mean_offset))
    return {k: torch.stack(v).numpy() for k, v in out.items()}


def run_trace(steps: int, seed: int, hidden_size: int,
              app: str = "coefficient", device=None,
              params: Optional[Dict[str, dict]] = None,
              draws: Optional[Dict[str, np.ndarray]] = None) -> list:
    """Per-step metrics of the fused GAN step on the app's tiny config.

    ``params``: ``{"d"|"g"|"dnn": flax parameter tree}`` of NumPy arrays,
    the initial weights (else the port's init). ``draws``: ``{"z_d",
    "alpha", "z_g"}``, each ``[steps, B, ...]`` (else
    :func:`host_draws`). ``device`` None is the CUDA card.
    """
    device = torch.device(device) if device is not None \
        else default_device()
    set_float32_precision()
    settings = Settings(**app_settings(app, seed, hidden_size))
    experiment = make_experiment(app, settings, device)
    experiment.dataset_setup()
    models = experiment.model_setup()
    if params is not None:
        for name, tree in params.items():
            getattr(models, name).load_state_dict(
                CONVERTERS[app][name](tree))
    state = init_train_state(settings, models)
    step_fn = make_gan_train_step(
        settings, labeled_loss_fn=experiment.labeled_loss_fn())
    if draws is None:
        draws = host_draws(settings, steps)
    if len(draws["z_d"]) < steps:
        raise ValueError(f"the draws cover {len(draws['z_d'])} steps, "
                         f"not {steps}")
    batches = host_batches(app, experiment, settings)
    put = lambda a: model_layout(torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(device))
    trace = []
    for i in range(steps):
        labeled_x, labels, unlabeled_x = next(batches)
        given = {k: torch.from_numpy(np.asarray(draws[k][i], np.float32))
                 .to(device) for k in DRAWS}
        state, metrics = step_fn(state, put(labeled_x), put(labels),
                                 put(unlabeled_x), **given)
        names = sorted(metrics)
        values = torch.stack([metrics[k].float() for k in names]).cpu()
        trace.append(dict(zip(names, values.tolist())))
    return trace


def compare_traces(trace: list, golden_trace: list, rtol: float,
                   atol: float) -> Optional[str]:
    """None if every step/metric matches within tolerance, else a
    description of the first mismatch."""
    if len(trace) != len(golden_trace):
        return (f"length mismatch: {len(trace)} steps vs golden "
                f"{len(golden_trace)}")
    for i, (got, want) in enumerate(zip(trace, golden_trace)):
        for key, want_v in want.items():
            got_v = got[key]
            if not (abs(got_v - want_v) <= atol + rtol * abs(want_v)):
                return (f"step {i} {key}: {got_v!r} vs golden {want_v!r}")
    return None


def npz_of(params: Dict[str, dict], draws: Dict[str, np.ndarray]
           ) -> Dict[str, np.ndarray]:
    """The arrays of a ``--draws`` file: ``params/<model>/<path>`` for
    each leaf of the flax trees, and the draws by name."""
    out = {f"draws/{k}": np.asarray(v) for k, v in draws.items()}

    def walk(prefix, tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(f"{prefix}/{key}", value)
            else:
                out[f"{prefix}/{key}"] = np.asarray(value)

    for name, tree in params.items():
        walk(f"params/{name}", dict(tree))
    return out


def load_draws(path: str):
    """(params, draws) of a ``--draws`` file (:func:`npz_of`)."""
    params: Dict[str, dict] = {}
    draws = {}
    with np.load(path) as data:
        for key in data.files:
            kind, *parts = key.split("/")
            if kind == "draws":
                draws[parts[0]] = data[key]
                continue
            node = params
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return params, draws


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", choices=["record", "compare"])
    parser.add_argument("--app", choices=list(APPS), default="coefficient")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hidden-size", type=int, default=10)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--trace", type=str, default=None)
    parser.add_argument("--rtol", type=float, default=1e-5)
    parser.add_argument("--atol", type=float, default=1e-6)
    parser.add_argument("--draws", type=str, default=None,
                        help="an .npz of the JAX package's initial "
                             "parameters and per-step z_d, alpha, z_g")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to run on the "
                             "CPU")
    args = parser.parse_args(argv)

    params, draws = (load_draws(args.draws) if args.draws
                     else (None, None))
    if args.mode == "record":
        trace = run_trace(args.steps, args.seed, args.hidden_size,
                          args.app, args.device, params, draws)
        out = args.out or "golden_trace.json"
        with open(out, "w") as f:
            json.dump({"app": args.app, "steps": args.steps,
                       "seed": args.seed,
                       "hidden_size": args.hidden_size,
                       "trace": trace}, f, indent=1)
        print(f"recorded {args.steps} steps to {out}")
        return 0

    if not args.trace:
        parser.error("compare requires --trace")
    # Config from the recorded file, loaded before the run.
    with open(args.trace) as f:
        golden = json.load(f)
    trace = run_trace(golden["steps"], golden["seed"],
                      golden["hidden_size"],
                      golden.get("app", "coefficient"), args.device,
                      params, draws)
    mismatch = compare_traces(trace, golden["trace"], args.rtol, args.atol)
    if mismatch:
        print(f"MISMATCH {mismatch}")
        return 1
    print(f"trace matches ({golden['steps']} steps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
