"""Summaries: ``scalars.jsonl`` and ``images/*.png`` per writer, plus
TensorBoard events when tensorboardX imports (``srgan_tpu.utils.summary``).
The PNGs are written with the standard library alone, so that no image
goes missing where PIL is absent."""

from __future__ import annotations

import datetime
import json
import os
import struct
import zlib
from typing import Optional

import numpy as np

try:
    from tensorboardX import SummaryWriter as _TBWriter
except ImportError:  # the JSONL file alone carries every scalar
    _TBWriter = None


class SummaryWriter:
    """JSONL (+ tensorboardX) scalar writer with step/period gating.

    A writer made with ``enabled=False`` (a data-parallel rank other than
    0) keeps the step gating and writes nothing."""

    def __init__(self, log_directory: str, summary_period: int = 1,
                 use_tensorboard: bool = True, enabled: bool = True):
        self.step = 0
        self.summary_period = summary_period
        self.log_directory = log_directory
        self.enabled = enabled
        if enabled:
            os.makedirs(log_directory, exist_ok=True)
        self._tb = (_TBWriter(log_directory)
                    if (enabled and use_tensorboard and _TBWriter is not None)
                    else None)
        self._jsonl_path = os.path.join(log_directory, "scalars.jsonl")

    def is_summary_step(self) -> bool:
        return self.step % self.summary_period == 0

    def add_scalar(self, tag: str, value, step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        step = self.step if step is None else step
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": value, "step": step})
                    + "\n")

    def add_image(self, tag: str, image, step: Optional[int] = None) -> None:
        """image: [H, W, C] float in [0, 1] or [−1, 1] (mapped to [0, 1] if
        any value is negative), C 1 or 3; written as
        ``images/<tag>_<step>.png`` with '/' in the tag as '_'."""
        if not self.enabled:
            return
        step = self.step if step is None else step
        image = np.asarray(image, dtype=np.float32)
        if image.min() < 0:
            image = (image + 1.0) / 2.0
        image = np.clip(image, 0.0, 1.0)
        if self._tb is not None:
            self._tb.add_image(tag, image, step, dataformats="HWC")
        image_dir = os.path.join(self.log_directory, "images")
        os.makedirs(image_dir, exist_ok=True)
        name = f"{tag.replace('/', '_')}_{step}.png"
        write_png(os.path.join(image_dir, name),
                  (image * 255).astype(np.uint8))

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


def write_png(path: str, pixels: np.ndarray) -> None:
    """An 8-bit PNG of [H, W, 1] (grey) or [H, W, 3] (RGB) uint8 pixels:
    one IDAT chunk, filter 0 on every row."""
    h, w, c = pixels.shape
    if pixels.dtype != np.uint8 or c not in (1, 3):
        raise ValueError(f"write_png takes [H, W, 1 or 3] uint8, got "
                         f"{pixels.dtype} {list(pixels.shape)}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           pixels.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))
