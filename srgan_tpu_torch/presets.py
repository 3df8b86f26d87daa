"""Named settings presets: the recorded configurations, selectable with
``python -m srgan_tpu_torch <app> --preset <name>``; explicit ``--flags``
override them. The same bundles as ``srgan_tpu.presets``.
"""

from __future__ import annotations

from typing import Dict

PRESETS: Dict[str, Dict] = {
    # The coefficient toy's semi-supervised regime (BASELINE.md).
    "coefficient_win": dict(
        batch_size=32, labeled_dataset_size=16,
        unlabeled_dataset_size=5000, validation_dataset_size=2000,
        hidden_size=100, learning_rate=1e-4,
        unlabeled_loss_multiplier=0.1, fake_loss_multiplier=1.0,
        gradient_penalty_multiplier=10.0, steps_to_run=10000,
        validation_step_period=1000),
    # Few labeled crowd images (BASELINE.md).
    "crowd_fewshot": dict(
        batch_size=32, steps_to_run=3000,
        labeled_dataset_size=4, unlabeled_dataset_size=64,
        image_patch_size=64, model_base_width=32, latent_dimension=100,
        learning_rate=1e-4, unlabeled_loss_multiplier=0.1,
        fake_loss_multiplier=1.0, gradient_penalty_multiplier=10.0,
        compute_dtype="bfloat16", validation_step_period=1000),
    # The flagship crowd configuration of bench.py.
    "crowd_flagship": dict(
        batch_size=120, image_patch_size=224, model_base_width=64,
        latent_dimension=100, compute_dtype="bfloat16",
        crowd_image_height=384, crowd_image_width=512),
    # The supervised-only baseline.
    "age_dnn": dict(dnn_only=True),
}


def apply_preset(name: str, overrides: Dict) -> Dict:
    """Merge ``overrides`` over the named preset (overrides win)."""
    try:
        base = dict(PRESETS[name])
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; "
                         f"choose from {sorted(PRESETS)}") from None
    base.update(overrides)
    return base
