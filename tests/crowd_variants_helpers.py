"""The tiny configuration and the comparisons shared by the port's
crowd-variant tests (``tests/test_torch_port_crowd_variants.py`` and
``tests/test_torch_port_crowd_variant_steps.py``)."""

import numpy as np
import torch

P, WIDTH, LATENT, B = 32, 8, 16, 4
LR, B1 = 1e-4, 0.9
TINY = dict(batch_size=B, image_patch_size=P, model_base_width=WIDTH,
            latent_dimension=LATENT, labeled_dataset_size=6,
            unlabeled_dataset_size=6, validation_dataset_size=3,
            test_dataset_size=2, crowd_image_height=80,
            crowd_image_width=96, crowd_synthetic_max_heads=12, seed=2,
            learning_rate=LR, adam_b1=B1, mean_offset=0.5,
            zero_init_heads=False, data_parallel_devices=1)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def within(ours, theirs, tol, what=""):
    theirs = np.asarray(theirs, np.float32)
    ours = np.asarray(ours.detach() if isinstance(ours, torch.Tensor)
                      else ours, np.float32)
    assert ours.shape == theirs.shape, what
    scale = float(np.abs(theirs).max())
    assert np.abs(ours - theirs).max() <= tol * scale, what
