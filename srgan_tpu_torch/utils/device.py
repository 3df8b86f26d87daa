"""The device an entry point of the port runs on when none is given."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA card; raises without one, so that nothing falls back to
    the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
