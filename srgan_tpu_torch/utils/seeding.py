"""Deterministic seeding: host RNGs and named ``torch.Generator`` streams.

``srgan_tpu.utils.seeding.key_for`` folds the crc32 of a stream name into
the experiment key; :func:`generator_for` derives a ``torch.Generator``
from the same (seed, crc32(name)) pair, so every stochastic site (init,
z-draws, α-draws) has its own reproducible stream and nothing reads the
global torch RNG. The numbers differ from ``jax.random``'s: tests that
compare the two packages draw once and feed both.
"""

from __future__ import annotations

import random
import zlib

import numpy as np
import torch


def seed_all(seed: int = 0) -> None:
    """Seed Python / NumPy global RNGs (host-side data pipelines)."""
    random.seed(seed)
    np.random.seed(seed)


def generator_for(seed: int, name: str, device="cpu",
                  start: int = 0) -> torch.Generator:
    """A generator on ``device`` for the named stream of ``seed``.

    crc32, not ``hash()``: the builtin is salted per process. ``start``
    (a restored step) gives a resumed run a fresh stream instead of a
    replay, as ``KeySequence(seed, name, start)`` does.
    """
    entropy = [seed, zlib.crc32(name.encode()) % (2 ** 31), start]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    generator = torch.Generator(device=device)
    generator.manual_seed(int(state))
    return generator
