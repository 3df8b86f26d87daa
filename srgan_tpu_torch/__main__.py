"""CLI entry: ``python -m srgan_tpu_torch <app> [--setting value ...]``.

The port of ``python -m srgan_tpu``: every field of
:class:`~srgan_tpu_torch.settings.Settings` is a ``--flag``, parsed with
the field's type; ``--preset`` applies a named bundle under the explicit
flags. It trains (with checkpoints every ``--save_step_period`` steps and
at the end; ``--load_model_path`` resumes), or with ``--evaluate_only``
restores ``--load_model_path`` and evaluates, and prints one JSON line of
validation (and test) metrics. It runs on the CUDA card unless given
``--device cpu``.

``--data_parallel_devices N`` (default: every visible card; 1 on the
CPU) trains on N ranks: ``Experiment.train()`` spawns them
(``parallel/launch.py``) under one trial directory, rank 0 writes the
summaries and checkpoints, and the trained state is restored into this
process, which evaluates and exports on its own device. With ``--device
cpu`` the ranks run on the CPU over gloo. ``--model_parallel_devices M``
makes them a grid of data × M ranks, the models' channels sharded over
the M ranks of each data rank (``parallel/tp.py``).

Examples:
  python -m srgan_tpu_torch coefficient --preset coefficient_win
  python -m srgan_tpu_torch age --age_database_path age.npz
  python -m srgan_tpu_torch age --preset age_dnn --steps_to_run 2000
  python -m srgan_tpu_torch driving --driving_frame_stack 3
  python -m srgan_tpu_torch crowd --crowd_database_path /data/ucf_qnrf_npz
  python -m srgan_tpu_torch crowd --preset crowd_flagship \\
      --crowd_database_path DB --save_step_period 1000
  python -m srgan_tpu_torch crowd --crowd_database_path DB --evaluate_only \\
      --load_model_path logs/<trial> --export_density_maps maps.npz
  python -m srgan_tpu_torch crowd --preset crowd_flagship \\
      --crowd_database_path DB --data_parallel_devices 4 \\
      --crowd_shard_dataset true
  python -m srgan_tpu_torch coefficient --device cpu --data_parallel_devices 2
  python -m srgan_tpu_torch coefficient --device cpu --model_parallel_devices 2
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import typing

from srgan_tpu_torch.settings import Settings

APPS = {
    "coefficient": "srgan_tpu_torch.apps.coefficient:CoefficientExperiment",
    "age": "srgan_tpu_torch.apps.age:AgeExperiment",
    "crowd": "srgan_tpu_torch.apps.crowd:CrowdExperiment",
    "driving": "srgan_tpu_torch.apps.driving:DrivingExperiment",
}


def _parse_value(raw: str, field_type):
    origin = typing.get_origin(field_type)
    if origin is typing.Union:  # Optional[T]
        args = [a for a in typing.get_args(field_type)
                if a is not type(None)]
        if raw.lower() in ("none", "null"):
            return None
        field_type = args[0]
        origin = typing.get_origin(field_type)
    if field_type is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if field_type is int:
        return int(raw)
    if field_type is float:
        return float(raw)
    if origin in (tuple, list):
        parsed = json.loads(raw)
        return tuple(parsed) if origin is tuple else list(parsed)
    return raw


def _parse_overrides(rest) -> dict:
    """``--name value`` / ``--name=value`` pairs → Settings fields."""
    overrides = {}
    hints = typing.get_type_hints(Settings)
    i = 0
    while i < len(rest):
        token = rest[i]
        if not token.startswith("--"):
            raise SystemExit(f"unexpected argument {token!r}")
        name = token[2:]
        if "=" in name:
            name, raw = name.split("=", 1)
        else:
            i += 1
            if i >= len(rest):
                raise SystemExit(f"--{name} requires a value")
            raw = rest[i]
        if name not in hints:
            known = ", ".join(sorted(hints))
            raise SystemExit(f"unknown setting --{name}; known: {known}")
        overrides[name] = _parse_value(raw, hints[name])
        i += 1
    return overrides


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="srgan_tpu_torch",
        description="SR-GAN training in PyTorch on a CUDA card",
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("app", choices=sorted(APPS),
                        help="application experiment to run")
    parser.add_argument("--evaluate_only", action="store_true",
                        help="restore load_model_path and evaluate only")
    parser.add_argument("--preset", default=None,
                        help="named settings bundle (srgan_tpu_torch."
                             "presets); explicit --flags override it")
    parser.add_argument("--export_density_maps", default=None,
                        metavar="PATH.npz",
                        help="crowd only: after evaluation, write the "
                             "predicted density canvases of the validation "
                             "(and, if present, test) split to an .npz "
                             "(keys: validation, test, plus *_image_ids "
                             "for tiled databases)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA "
                             "card; 'cpu' to run on the CPU)")
    args, rest = parser.parse_known_args(argv)

    fields = _parse_overrides(rest)
    if args.preset:
        from srgan_tpu_torch.presets import apply_preset
        try:
            fields = apply_preset(args.preset, fields)
        except ValueError as error:
            raise SystemExit(str(error))
    settings = Settings(**fields)
    if args.export_density_maps and args.app != "crowd":
        raise SystemExit("--export_density_maps is crowd-only (density "
                         "maps are a crowd-counting concept)")
    module_name, class_name = APPS[args.app].split(":")
    experiment_cls = getattr(importlib.import_module(module_name),
                             class_name)
    experiment = experiment_cls(settings, device=args.device)
    if args.export_density_maps:
        # Fail on an unwritable destination before the run, not after it.
        _ensure_writable(args.export_density_maps)
    if args.evaluate_only:
        if not settings.load_model_path:
            raise SystemExit("--evaluate_only requires --load_model_path")
        experiment.prepare_for_evaluation(settings.load_model_path)
        result = {}
    else:
        experiment.train()
        result = {"trial_directory": experiment.trial_directory}
    _export_density_maps(experiment, args.export_density_maps)
    result["validation"] = _evaluate_or_null(experiment)
    _add_test_metrics(experiment, result)
    print(json.dumps(result))
    experiment.close()
    return 0


def _ensure_writable(path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    try:
        os.makedirs(parent, exist_ok=True)
    except OSError as error:
        raise SystemExit(f"cannot write {path!r}: {error}")
    if not os.access(parent, os.W_OK):
        raise SystemExit(f"cannot write {path!r}: {parent} not writable")


def _evaluate_or_null(experiment):
    """Validation metrics, or ``None`` for an empty or absent validation
    split: a finished run always reports its JSON line."""
    ds = experiment.validation_dataset
    if ds is None or len(ds) == 0:
        return None
    return experiment.evaluate()


def _export_density_maps(experiment, path) -> None:
    """Write the predicted density canvases, [N, H/4, W/4] per split."""
    if not path:
        return
    import numpy as np

    arrays = {"validation": experiment.predict_density_maps()}
    if experiment.test_dataset is not None and \
            len(experiment.test_dataset) > 0:
        arrays["test"] = experiment.predict_density_maps(
            db=experiment.test_dataset)
    for split in list(arrays):
        db = (experiment.validation_db if split == "validation"
              else experiment.test_dataset)
        if db.image_ids is not None:
            # Tiled databases: each example's (tile's) source image.
            arrays[f"{split}_image_ids"] = db.image_ids
    np.savez(path, **arrays)


def _add_test_metrics(experiment, result: dict) -> None:
    """Test metrics when a test split exists; ``None`` for an empty one
    (``evaluate`` refuses an empty split)."""
    if experiment.test_dataset is None:
        return
    if len(experiment.test_dataset) == 0:
        result["test"] = None
        return
    result["test"] = experiment.test()


if __name__ == "__main__":
    sys.exit(main())
