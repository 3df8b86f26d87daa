"""The harness on the CPU: the JAX guard, finding cells, configurations
and metrics by name, the result line, the step-time and rate
arithmetic, BENCHMARK.json's form, and whole runs of every cell at a
tiny size."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.harness import session, spec
from benchmark.harness.session import Window
from benchmark.tests.conftest import CELLS, tiny_cell

ROOT = spec.ROOT


def test_the_guard_compares_whole_top_level_names():
    loaded = ["numpy", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "optax", "orbax.checkpoint", "srgan_tpu", "srgan_tpu.ops",
              "srgan_tpu_torch", "srgan_tpu_torch.apps.crowd", "jaxtyping",
              "optaxx"]
    assert spec.forbidden_loaded(loaded) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
         "orbax.checkpoint", "srgan_tpu", "srgan_tpu.ops"])


def test_the_program_and_the_harness_load_no_jax():
    code = ("import benchmark.run, benchmark.study, srgan_tpu_torch, "
            "srgan_tpu_torch.apps.crowd, srgan_tpu_torch.apps.age; "
            "from benchmark.harness import spec; "
            "print(spec.jax_guard())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _copy_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return str(tmp_path)


def _digests(root):
    out = {}
    for folder, _, files in os.walk(root):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_a_cell_a_configuration_and_a_metric_added_as_files(tmp_path):
    root = _copy_benchmark(tmp_path)
    before = _digests(root)
    config = spec.load_json(os.path.join(
        root, "benchmark", "configs", "crowd_flagship.json"))
    config["name"] = "crowd_wide"
    config["settings"]["model_base_width"] = 96
    with open(os.path.join(root, "benchmark", "configs", "crowd_wide.json"),
              "w") as f:
        json.dump(config, f)
    workload = spec.load_json(os.path.join(
        root, "benchmark", "workloads", "crowd_flagship.xla_resident.json"))
    workload.update(name="crowd_wide.xla_resident", config="crowd_wide")
    with open(os.path.join(root, "benchmark", "workloads",
                           "crowd_wide.xla_resident.json"), "w") as f:
        json.dump(workload, f)
    with open(os.path.join(root, "benchmark", "metrics",
                           "step.window_steps.py"), "w") as f:
        f.write("def read(run):\n    return run.window.steps\n")
    # BENCHMARK.json only gains entries.
    bench = spec.load_benchmark(root)
    bench["configs"].append({"name": "crowd_wide", "source": "x",
                             "file": "benchmark/configs/crowd_wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "crowd_wide.xla_resident",
                               "config": "crowd_wide",
                               "traffic": "xla_resident", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "step.window_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "experiment loop",
                               "moves": "train_images_per_s",
                               "workloads": ["crowd_wide.xla_resident"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items()
               if k != "BENCHMARK.json")
    cell = spec.Cell("crowd_wide.xla_resident", root=root)
    assert cell.settings()["model_base_width"] == 96
    assert cell.settings()["norm_impl"] == "xla"
    names = [m["name"] for m in cell.metrics("per_layer")]
    assert "step.window_steps" in names
    assert "kernels.norm_roofline" not in names
    record = run.RunRecord(window=Window(7, 1.0, [], [], {}), counts={})
    got = spec.read_metrics(cell, "per_layer", record, root=root)
    assert got["step.window_steps"] == {"value": 7, "unit": "steps"}


def test_a_workload_file_that_benchmark_json_does_not_list_is_refused(
        tmp_path):
    root = _copy_benchmark(tmp_path)
    workload = spec.load_json(os.path.join(
        root, "benchmark", "workloads", "crowd_flagship.xla_resident.json"))
    workload["name"] = "crowd_flagship.unlisted"
    with open(os.path.join(root, "benchmark", "workloads",
                           "crowd_flagship.unlisted.json"), "w") as f:
        json.dump(workload, f)
    with pytest.raises(ValueError, match="not a workload"):
        spec.Cell("crowd_flagship.unlisted", root=root)


def test_the_result_line_has_the_drivers_keys_and_the_checks_last():
    line = spec.result_line(True, 12, 0, {"setup_s": {"value": 1.5,
                                                     "unit": "s"}},
                            {"platform": "gpu", "kind": "x", "count": 1,
                             "memory_peak_bytes": 3},
                            {"loss_gap": {"value": 0.1, "limit": 0.2}},
                            {"device_ops": [], "idle_gaps": []})
    parsed = json.loads(line)
    assert list(parsed) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert "breakdown" not in json.loads(spec.result_line(
        False, 1, 1, {}, {}, {}))


def test_step_times_and_the_rate_from_event_times():
    assert spec.step_gaps_ms([10.0, 25.0, 45.0, 50.0]) == [10.0, 15.0,
                                                           20.0, 5.0]
    values = [float(v) for v in range(1, 101)]
    assert spec.percentile(values, 95) == pytest.approx(95.05)
    assert spec.percentile([3.0], 95) == 3.0
    record = run.RunRecord(
        window=Window(4, 2.0, [10.0, 25.0, 45.0, 50.0], [True] * 4, {}),
        settings=type("S", (), {"batch_size": 120})(),
        memory_peak_bytes=3 * 2 ** 30, setup_s=4.0, counts={})
    read = lambda name: spec.metric_reader(name)(record)  # noqa: E731
    assert read("train_images_per_s") == 240.0
    assert read("step_ms_p95") == pytest.approx(
        spec.percentile([10.0, 15.0, 20.0, 5.0], 95))
    assert read("peak_mem_gib") == 3.0
    assert read("setup_s") == 4.0
    assert read("step.mfu") is None  # nothing profiled: nothing to read


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_its_form():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert spec.load_json(os.path.join(ROOT, c["file"]))["name"] == \
            c["name"]
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
            assert "width" not in key and "size" != key
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        spec.Cell(w["name"])  # its files are there and agree
        cells.add(w["name"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           f"{m['name']}.py"))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    for name in cells:
        cell = spec.Cell(name)
        assert len(cell.metrics("end_to_end")) >= 2
        assert cell.metrics("per_layer")
    assert len(json.dumps(bench)) < 64 * 1024


def test_the_set_up_follows_the_programs_train():
    session.check_train_setup()
    assert session.train_calls()  # the guard reads calls at all


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "crowd_flagship.pallas_resident", "--seed", "3000000001",
         "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_of_the_benchmark_alone_fails(tmp_path):
    root = _copy_benchmark(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "crowd_flagship.pallas_resident", "--seed", "1", "--seconds",
         "1", "--trace", "1"], cwd=root, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_whole_run_at_a_tiny_size_is_correct(name, trace):
    cell = tiny_cell(name)
    record = run.run_cell(cell, 2 ** 31 + 7, 1.0, trace,
                          torch.device("cpu"), time.monotonic())
    assert record.window.steps > 0 and record.failed == 0
    assert all(record.numbers[k] <= v
               for k, v in cell.workload["limits"].items()), record.numbers
    kind = "per_layer" if trace else "end_to_end"
    got = spec.read_metrics(cell, kind, record)
    if trace:
        assert {"loop.host_ms_per_step", "input.host_ms_per_step",
                "step.mfu"} <= set(got)
    else:
        assert {"train_images_per_s", "setup_s"} <= set(got)
