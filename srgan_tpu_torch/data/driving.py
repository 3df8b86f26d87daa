"""Driving steering-angle data (dash-cam frame stacks): the port of
``srgan_tpu.data.driving``.

``load_driving_recording`` parses a frames directory and a CSV of
(frame, angle) rows, stacking consecutive frames along channels;
``synthetic_driving_examples`` renders road images whose lane curvature
encodes the angle. NumPy and PIL as in the JAX package (PIL imported
where it is used), so that both give the same arrays.
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Tuple

import numpy as np

from srgan_tpu_torch.data.core import ArrayDataset


def load_driving_recording(frames_directory: str, csv_path: str,
                           image_size: int = 64, frame_stack: int = 1,
                           limit: Optional[int] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a recording: CSV rows of (frame filename, steering angle).

    Consecutive ``frame_stack`` frames are stacked along channels; the
    label is the last frame's angle.
    """
    from PIL import Image

    rows = []
    with open(csv_path) as f:
        for line_no, row in enumerate(csv.reader(f)):
            if len(row) < 2:
                continue
            try:
                angle = float(row[1])
            except ValueError:
                continue  # header
            if not np.isfinite(angle):
                continue  # "nan"/"inf" parse as floats but poison labels
            rows.append((line_no, row[0], angle))
    if limit:
        # limit examples need limit + (frame_stack - 1) source frames
        rows = rows[:limit + frame_stack - 1]

    frames, angles, line_nos = [], [], []
    for line_no, name, angle in rows:
        path = os.path.join(frames_directory, name)
        if not os.path.exists(path):
            continue
        with Image.open(path) as img:
            frames.append(np.asarray(
                img.convert("RGB").resize((image_size, image_size),
                                          Image.BILINEAR), np.float32))
        angles.append(angle)
        line_nos.append(line_no)

    examples, labels = [], []
    for i in range(frame_stack - 1, len(frames)):
        # A stack is only a valid temporal window if its source rows
        # were CONSECUTIVE in the recording — dropped rows (bad angle,
        # missing frame, header) must invalidate the windows that span
        # them, not splice non-adjacent frames together.
        if line_nos[i] - line_nos[i - frame_stack + 1] != frame_stack - 1:
            continue
        stack = np.concatenate(frames[i - frame_stack + 1:i + 1], axis=-1)
        examples.append(stack / 127.5 - 1.0)
        labels.append(angles[i])
    shape = (0, image_size, image_size, 3 * frame_stack)
    if not examples:
        return np.zeros(shape, np.float32), np.zeros((0,), np.float32)
    return (np.asarray(examples, np.float32),
            np.asarray(labels, np.float32))


def synthetic_driving_examples(count: int, image_size: int = 64,
                               frame_stack: int = 1, seed: int = 0
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural road frames: a bright lane curving by the steering angle
    (angle ∈ [−1, 1]); learnable stand-in for hermetic tests."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-1.0, 1.0, count).astype(np.float32)
    examples = np.zeros(
        (count, image_size, image_size, 3 * frame_stack), np.float32)
    ys = np.arange(image_size, dtype=np.float32)
    xs = np.arange(image_size, dtype=np.float32)
    for i, angle in enumerate(angles):
        for f in range(frame_stack):
            # lane center curves with the angle; later frames curve more
            t = (ys / image_size)
            center = (image_size / 2.0
                      + angle * (0.35 + 0.1 * f) * image_size * t ** 2)
            dist = np.abs(xs[None, :] - center[:, None])
            lane = np.clip(1.0 - dist / (image_size * 0.08), 0.0, 1.0)
            img = 30.0 + 200.0 * lane
            frame = np.repeat(img[..., None], 3, axis=-1)
            frame += rng.normal(0, 6.0, frame.shape)
            examples[i, :, :, 3 * f:3 * (f + 1)] = np.clip(frame, 0, 255)
    examples = examples / 127.5 - 1.0
    return examples.astype(np.float32), angles


def driving_datasets(settings) -> Tuple[ArrayDataset, ArrayDataset,
                                        ArrayDataset, ArrayDataset]:
    """(labeled, unlabeled, validation, test) splits from a preprocessed
    ``.npz`` at ``settings.driving_database_path`` or the synthetic
    generator."""
    path = settings.driving_database_path
    # driving_image_size, falling back to the shared image-size knob
    size = settings.resolved_driving_image_size
    stack = settings.driving_frame_stack
    if path:
        data = np.load(path)
        examples = data["examples"].astype(np.float32)
        labels = data["labels"].astype(np.float32)
        bounds = np.cumsum([settings.labeled_dataset_size,
                            settings.unlabeled_dataset_size,
                            settings.validation_dataset_size,
                            settings.test_dataset_size])
        return (ArrayDataset(examples[:bounds[0]], labels[:bounds[0]]),
                ArrayDataset(examples[bounds[0]:bounds[1]]),
                ArrayDataset(examples[bounds[1]:bounds[2]],
                             labels[bounds[1]:bounds[2]]),
                ArrayDataset(examples[bounds[2]:bounds[3]],
                             labels[bounds[2]:bounds[3]]))
    lab = synthetic_driving_examples(settings.labeled_dataset_size, size,
                                     stack, settings.seed)
    unl = synthetic_driving_examples(settings.unlabeled_dataset_size, size,
                                     stack, settings.seed + 1)
    val = synthetic_driving_examples(settings.validation_dataset_size,
                                     size, stack, settings.seed + 2)
    test = synthetic_driving_examples(settings.test_dataset_size, size,
                                      stack, settings.seed + 3)
    return (ArrayDataset(*lab), ArrayDataset(unl[0]), ArrayDataset(*val),
            ArrayDataset(*test))
