"""The floating-point operations one step needs, counted by
``torch.utils.flop_counter.FlopCounterMode`` over one step of the
reference (``reference/step.py``) at a configuration's shapes.

The count covers the convolutions and matrix products of the step (the
forwards, the backwards and the gradient penalty's double backward), as
the algorithm needs them: the G forward of the D update and the one of
the G update have different z, and both count; nothing is counted twice
for being computed twice. Elementwise work, norms and Adam are not
counted. On the ``meta`` device the count takes no time; every layer's
work is linear in the batch, so a count at a small batch scales.

    python -m benchmark.counts.flops benchmark/configs/<config>.json
"""

from __future__ import annotations

import importlib
import json
import sys
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.step import Hyper, run_steps


def step_flops(config: Dict, batch: Optional[int] = None,
               device: str = "meta") -> int:
    app = importlib.import_module(f"benchmark.apps.{config['app']}")
    b = batch or config["settings"]["batch_size"]
    latent = config["settings"]["latent_dimension"]
    make = (torch.zeros if device == "meta" else
            lambda *s, **k: torch.randn(*s, **k) * 0.1)
    weights = {m: {k: make(shape, device=device) for k, shape in
                   named.items()}
               for m, named in app.weight_shapes(config).items()}
    batch_tensors = tuple(make(s, device=device)
                          for s in app.batch_shapes(config, b))
    draws = (make((b, latent), device=device),
             torch.rand(b, device=device),
             make((b, latent), device=device))
    with FlopCounterMode(display=False) as counter:
        run_steps(app.reference_models(config), weights, [batch_tensors],
                  [draws], Hyper())
    return int(counter.get_total_flops())


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(step_flops(json.load(f)))
