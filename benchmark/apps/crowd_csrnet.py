"""The crowd application with CSRNet as D and the DNN: the data, the
loading hook, the checked batches and the reference's sampler of
``crowd.py``; CSRNet's weights (``reference/csrnet.py``), its heads'
dataset-mean cell at its 1/8 resolution, and its loss."""

from __future__ import annotations

from typing import Dict

from benchmark.apps.crowd import (Data, batch_shapes, checked_batches,  # noqa: F401
                                  experiment, make_data, reference_batch)
from benchmark.reference import csrnet
from benchmark.reference import models as ref
from benchmark.reference.step import Models


def weight_shapes(config: Dict) -> Dict[str, Dict[str, tuple]]:
    s = config["settings"]
    d = csrnet.csrnet_shapes(s["model_base_width"])
    return {"d": d, "g": ref.generator_shapes(
        s["image_patch_size"], s["model_base_width"],
        s["latent_dimension"]), "dnn": dict(d)}


def fixed_weights(config: Dict, data: Data) -> Dict[str, Dict[str, float]]:
    """The heads' zero kernels and their biases at the dataset-mean map
    cell (64 pixels of the labeled maps' mean), as ``zero_init_heads``."""
    cell = csrnet.OUTPUT_STRIDE ** 2 * data.mean_density
    heads = {"density_head.weight": 0.0, "density_head.bias": cell,
             "count_head.weight": 0.0, "count_head.bias": cell}
    return {"d": dict(heads), "dnn": dict(heads)}


def reference_models(config: Dict) -> Models:
    patch = config["settings"]["image_patch_size"]
    return Models(d=csrnet.csrnet,
                  g=lambda w, z, q: ref.generator(w, z, patch, q),
                  labeled_loss=csrnet.labeled_loss)
