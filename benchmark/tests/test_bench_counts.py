"""The counts of the configuration files against counts made here: the
operations of a step (FlopCounterMode over the reference) and the norm's
bytes from its shapes and launches."""

import copy
import os

import pytest

from benchmark.counts import flops, norm_bytes
from benchmark.harness.spec import load_benchmark, load_json

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = os.path.join(ROOT, "benchmark", "configs")


CONFIG_NAMES = [c["name"] for c in load_benchmark()["configs"]]


def _config(name):
    return load_json(os.path.join(CONFIGS, f"{name}.json"))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_flops_per_step_is_the_count_at_the_configurations_shapes(name):
    config = _config(name)
    assert config["counts"]["flops_per_step"] == flops.step_flops(config)


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_the_meta_count_is_the_cpu_count_and_linear_in_the_batch(name):
    config = copy.deepcopy(_config(name))
    config["settings"].update(config["tiny"]["settings"])
    on_cpu = flops.step_flops(config, batch=2, device="cpu")
    assert flops.step_flops(config, batch=2) == on_cpu
    assert flops.step_flops(config, batch=6) == 3 * on_cpu


def test_the_flagship_norm_shapes_hold_its_launches_and_bytes():
    counts = _config("crowd_flagship")["counts"]
    shapes = counts["norm_shapes"]
    # chip_smoke.py's accounting: 30 forward and 25 backward launches.
    assert norm_bytes.launches(shapes) == (30, 25)
    by_hand = sum(b * hw * c * 2 * (2 * f + 3 * k)
                  for b, hw, c, f, k in shapes)
    assert norm_bytes.step_bytes(shapes, 2) == by_hand
    # D over 3B at 112² × 64, once each way: 2 + 3 passes of 57.8 MB.
    assert norm_bytes.step_bytes([[360, 12544, 64, 1, 1]], 2) == \
        360 * 12544 * 64 * 2 * 5
