"""The weights both sides start from, made by the benchmark from the seed.

One generator on the device, one draw for every kernel of the three
models together: kernels are normal with standard deviation
1/√fan_in (LeCun), biases 0, norm scales 1 and norm biases 0, all
float32 as the program keeps its parameters. An application may set
some tensors to given values (the crowd heads' zero kernels and
dataset-mean biases). The same seed gives the same weights.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

Shapes = Dict[str, Dict[str, tuple]]

STREAMS = {"weights": 1, "data": 2, "checked": 3, "draws": 4}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of the named stream of ``seed``."""
    state = np.random.SeedSequence([seed, STREAMS[stream]]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def device_generator(seed: int, stream: str, device) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(stream_seed(seed, stream))
    return generator


def fan_in(name: str, shape: tuple) -> Optional[int]:
    """The fan-in of a kernel, None for a bias or a norm parameter. A
    transposed convolution's kernel is [in, out, k, k]."""
    if not name.endswith(".weight") or len(shape) < 2:
        return None
    if len(shape) == 2:
        return shape[1]
    if name.split(".")[0] == "deconvs":
        return shape[0] * shape[2] * shape[3]
    return shape[1] * shape[2] * shape[3]


def make_weights(shapes: Shapes, seed: int, device,
                 fixed: Optional[Dict[str, Dict[str, float]]] = None
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: {name: tensor}} on ``device``; ``fixed``: {model: {name:
    value}} tensors filled with a constant instead."""
    fixed = fixed or {}
    kernels = [(m, k, s) for m, named in shapes.items()
               for k, s in named.items()
               if fan_in(k, s) is not None and k not in fixed.get(m, {})]
    total = sum(math.prod(s) for _, _, s in kernels)
    draw = torch.randn(total, generator=device_generator(seed, "weights",
                                                         device),
                       device=device)
    out = {m: {} for m in shapes}
    start = 0
    for m, k, s in kernels:
        n = math.prod(s)
        out[m][k] = (draw[start:start + n].view(s)
                     / math.sqrt(fan_in(k, s))).clone()
        start += n
    for m, named in shapes.items():
        for k, s in named.items():
            if k in out[m]:
                continue
            if k in fixed.get(m, {}):
                value = fixed[m][k]
            else:
                value = 1.0 if k.endswith(".scale") else 0.0
            out[m][k] = torch.full(s, float(value), device=device)
    return out
