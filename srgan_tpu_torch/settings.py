"""Experiment configuration.

The same dataclass as ``srgan_tpu.settings.Settings``: every field keeps
its name and default, so one configuration drives either package. The
comments on each field live with the JAX package; the ones here say what
the PyTorch port does with it. The port runs every value that JAX runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Settings:
    """Hyperparameter / configuration bag consumed by :class:`Experiment`."""

    # ------------------------------------------------------------------ trial
    trial_name: str = "base"
    logs_directory: str = "logs"
    load_model_path: Optional[str] = None
    seed: int = 0
    dnn_only: bool = False

    # ------------------------------------------------------------- schedule
    batch_size: int = 32
    steps_to_run: int = 1000
    epochs_to_run: Optional[int] = None  # if set, overrides steps_to_run
    summary_step_period: int = 100
    save_step_period: Optional[int] = None
    # None → validate per epoch; a step count decouples it from epochs.
    validation_step_period: Optional[int] = None
    profile_step_range: Optional[Tuple[int, int]] = None
    debug_nans: bool = False
    compilation_cache_dir: Optional[str] = None           # JAX only
    generator_training_step_period: int = 1
    steps_per_dispatch: int = 1

    # ------------------------------------------------------------ optimizers
    learning_rate: float = 1e-4
    weight_decay: float = 0.0  # applied to D/DNN only
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    gradient_clip_norm: float = 0.0  # global-norm clip before Adam; 0 = off

    # ---------------------------------------------------------------- data
    labeled_dataset_size: int = 50
    unlabeled_dataset_size: int = 50000
    validation_dataset_size: int = 1000
    test_dataset_size: int = 1000
    number_of_data_workers: int = 4
    # z ~ equal mixture of N(±mean_offset, I) (utils/mixture.py).
    mean_offset: float = 0.0

    # ---------------------------------------------------------------- model
    latent_dimension: int = 10
    hidden_size: int = 10
    model_base_width: int = 64

    # ---------------------------------------------------------------- losses
    unlabeled_loss_multiplier: float = 1e0
    fake_loss_multiplier: float = 1e0
    gradient_penalty_multiplier: float = 1e1
    labeled_loss_order: float = 2.0
    unlabeled_loss_order: float = 2.0
    fake_loss_order: float = 1.0
    contrasting_distance_function: str = "log"
    # One D forward over the concatenated 3B batch (train.py).
    fuse_discriminator_streams: bool = True

    # ------------------------------------------------------------- precision
    # "float32" or "bfloat16": params stay float32, convs and dense layers
    # compute in this dtype, GroupNorm statistics stay float32.
    compute_dtype: str = "float32"
    # "xla" (a composite GroupNorm, float32 statistics), "fast"
    # (FastGroupNorm: compute-dtype statistics, two-pass variance) or
    # "pallas" (the fused CUDA kernels of ops/fused_norm.py).
    norm_impl: str = "xla"

    # ------------------------------------------------------------ parallelism
    # Data ranks (None: every visible card, or max(1, cards // model) with
    # model ranks; 1 on the CPU) × model ranks (parallel/tp.py).
    data_parallel_devices: Optional[int] = None
    model_parallel_devices: int = 1

    # ------------------------------------------------------------- app extras
    crowd_database_path: Optional[str] = None  # dir of {split}.npz; None → synthetic
    crowd_label_type: str = "density"
    crowd_model: str = "jointcnn"
    zero_init_heads: bool = True
    dnn_use_norm: bool = True
    image_patch_size: int = 224
    crowd_rescale_factors: Tuple[float, ...] = ()
    crowd_image_height: int = 384
    crowd_image_width: int = 512
    crowd_sigma: float = 8.0
    density_loss_multiplier: float = 1e0
    count_loss_multiplier: float = 1e0
    image_normalization: str = "[-1,1]"        # or "meanstd"
    crowd_label_dtype: str = "float32"         # or "bfloat16" on the device
    crowd_summary_image_count: int = 2
    crowd_synthetic_max_heads: int = 64
    crowd_host_pipeline: bool = False
    device_hbm_gb: float = 16.0
    crowd_hbm_window: int = 0
    crowd_window_slices: int = 8
    crowd_window_refresh_period: int = 0
    crowd_shard_dataset: bool = False
    # Age / driving apps:
    age_image_size: int = 64
    age_database_path: Optional[str] = None
    driving_frame_stack: int = 1
    driving_database_path: Optional[str] = None
    driving_image_size: Optional[int] = None

    @property
    def resolved_driving_image_size(self) -> int:
        return (self.driving_image_size if self.driving_image_size
                is not None else self.age_image_size)

    def copy(self, **overrides) -> "Settings":
        return dataclasses.replace(self, **overrides)

    def trial_directory_name(self) -> str:
        from srgan_tpu_torch.utils.scientific import clean_scientific_notation

        tokens = [
            self.trial_name,
            f"ul{clean_scientific_notation(self.unlabeled_loss_multiplier)}",
            f"fl{clean_scientific_notation(self.fake_loss_multiplier)}",
            f"gp{clean_scientific_notation(self.gradient_penalty_multiplier)}",
            f"lr{clean_scientific_notation(self.learning_rate)}",
            f"bs{self.batch_size}",
            f"l{self.labeled_dataset_size}",
            f"u{self.unlabeled_dataset_size}",
        ]
        return "_".join(tokens)
