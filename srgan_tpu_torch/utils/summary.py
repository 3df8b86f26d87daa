"""Scalar summaries: ``scalars.jsonl`` per writer, plus TensorBoard events
when tensorboardX imports (``srgan_tpu.utils.summary``, scalars only)."""

from __future__ import annotations

import datetime
import json
import os
from typing import Optional

try:
    from tensorboardX import SummaryWriter as _TBWriter
except ImportError:  # the JSONL file alone carries every scalar
    _TBWriter = None


class SummaryWriter:
    """JSONL (+ tensorboardX) scalar writer with step/period gating."""

    def __init__(self, log_directory: str, summary_period: int = 1,
                 use_tensorboard: bool = True):
        self.step = 0
        self.summary_period = summary_period
        self.log_directory = log_directory
        os.makedirs(log_directory, exist_ok=True)
        self._tb = (_TBWriter(log_directory)
                    if (use_tensorboard and _TBWriter is not None) else None)
        self._jsonl_path = os.path.join(log_directory, "scalars.jsonl")

    def is_summary_step(self) -> bool:
        return self.step % self.summary_period == 0

    def add_scalar(self, tag: str, value, step: Optional[int] = None) -> None:
        step = self.step if step is None else step
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": value, "step": step})
                    + "\n")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


def make_trial_directory(settings) -> str:
    """Unique trial dir: logs/<settings-derived name>_<timestamp>."""
    stamp = datetime.datetime.now().strftime("y%Ym%md%dh%Hm%Ms%S")
    base = os.path.join(settings.logs_directory,
                        f"{settings.trial_directory_name()}_{stamp}")
    # Second-resolution stamps collide when trials start back to back.
    trial_dir = base
    suffix = 1
    while True:
        try:
            os.makedirs(trial_dir)
            return trial_dir
        except FileExistsError:
            trial_dir = f"{base}_{suffix}"
            suffix += 1
