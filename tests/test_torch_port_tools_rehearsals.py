"""The port's tools (``srgan_tpu_torch/tools/``) that run end to end at
tiny sizes on the CPU: the window bench, the UCF-QNRF and IMDB-WIKI
rehearsals, the command-line rehearsal and the science re-runs
(``crowd_win``, ``scale_fidelity_ab``).

The science re-runs and the command-line rehearsal train the flagship
widths (224-px patches, base width 64, bfloat16), which a CPU test cannot
afford: their settings helpers (``seed_settings``, ``arm_settings``,
``train_command``) are wrapped to train base width 8 in float32 without
density triptychs (crowd_win also on 4 validation and test images of
128×128; the others on 128-px patches), and the rest of the path runs as
shipped. The ``hyper`` step, the sweep and the golden traces are in
``tests/test_torch_port_tools.py``.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from srgan_tpu_torch.tools import (crowd_win, imdb_wiki_rehearsal,
                                  real_scale_cli_rehearsal,
                                  scale_fidelity_ab, ucf_qnrf_rehearsal,
                                  window_bench)

# The science re-runs' and the command-line rehearsal's training cut for
# the CPU (see the module docstring): base width 8, float32, and patches
# that keep the grid evaluation's patch count small.
TINY_MODEL = dict(model_base_width=8, latent_dimension=8,
                  compute_dtype="float32", crowd_summary_image_count=0)


# ------------------------------------------------------------ window bench
def test_window_bench_runs_on_a_small_database(tmp_path, capsys):
    assert window_bench.main([
        "--device", "cpu", "--total-gb", "0.02", "--window", "4",
        "--slices", "2", "--steps", "3", "--warmup", "1", "--batch", "2",
        "--patch", "32", "--base-width", "8", "--refresh-period", "1",
        "--db-root", str(tmp_path / "db")]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["metric"] == "crowd_srgan_images_per_sec_window_tier"
    assert result["value"] > 0 and result["device"] == "cpu"
    assert result["refreshes_in_timed_region"] == [3, 3]
    assert result["refresh_mb_per_sec"] > 0
    assert not result["disk_limited"]
    assert result["database_gb"] <= 0.02


def test_window_bench_reports_a_disk_too_small(tmp_path):
    free_gb = shutil.disk_usage(tmp_path).free / 1e9
    size, note = window_bench.plan_database(10 * free_gb + 1, str(tmp_path),
                                            torch.device("cpu"))
    assert note is not None and "too little" in note
    assert 0 < size <= free_gb
    assert window_bench.plan_database(0.01, str(tmp_path),
                                      torch.device("cpu")) == (0.01, None)
    with pytest.raises(ValueError, match="total-gb"):
        window_bench.plan_database(None, str(tmp_path), torch.device("cpu"))
    # A database cut below the window: the window is forced under the
    # smaller split.
    window, note = window_bench.window_size(1024, 8, {"n_lab": 100,
                                                      "n_unl": 300})
    assert window == 96 and "forcing" in note


# -------------------------------------------------------------- rehearsals
def test_ucf_qnrf_rehearsal_conserves_mass(tmp_path):
    summary = ucf_qnrf_rehearsal.rehearse(
        str(tmp_path), [(400, 600, 50)], 50, ["density", "knn"], 384, 512,
        8.0, 0, device="cpu")
    assert [r["label_type"] for r in summary["results"]] == ["density",
                                                             "knn"]
    for record in summary["results"]:
        # 50 heads kept; the NaN, the inf and the two out-of-frame points
        # dropped.
        assert record["expected_counts"] == [50]
        assert record["mass_conserved"] and record["max_mass_error"] < 1e-4
        assert record["tiles"] == 4 and record["source_images"] == 1
        assert record["density_finite"] and record["has_stats"]
        for stage in ("annotation_seconds", "label_seconds",
                      "decode_seconds", "npz_write_seconds"):
            assert record[stage] > 0, stage


def test_imdb_wiki_rehearsal(tmp_path, capsys):
    assert imdb_wiki_rehearsal.main([
        "--records", "2000", "--images", "20", "--limit", "50",
        "--image-size", "32", "--out-dir", str(tmp_path / "raw")]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["records"] == 2000
    assert 0 < report["filtered_records"] < 2000
    assert 0 < report["packed_examples"] <= 50
    for key in ("synthesize_secs", "parse_secs", "preprocess_secs",
                "npz_mb", "extrapolated_full_preprocess_hours",
                "full_pack_ram_gb"):
        assert report[key] > 0, key


def test_real_scale_cli_rehearsal(tmp_path, monkeypatch, capsys):
    command = real_scale_cli_rehearsal.train_command
    tiny = [a for k, v in dict(TINY_MODEL, image_patch_size=128).items()
            for a in (f"--{k}", str(v))]
    monkeypatch.setattr(real_scale_cli_rehearsal, "train_command",
                        lambda *args: command(*args) + tiny)
    assert real_scale_cli_rehearsal.main([
        "--images", "2", "--size", "384", "512", "--steps", "2",
        "--batch", "2", "--window", "8", "--device", "cpu",
        "--work-dir", str(tmp_path / "work")]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["db_gb"] > 0
    assert report["generate_secs"] > 0 and report["preprocess_secs"] > 0
    assert report["train_wall_secs"] > 0
    assert set(report["validation"]) == {"MAE", "RMSE", "NVE", "NAE"}
    assert all(np.isfinite(v) for v in report["validation"].values())
    assert not (tmp_path / "work").exists()  # removed on success


def _tiny(helper, **more):
    return lambda *args, **kwargs: helper(*args, **kwargs).copy(
        **TINY_MODEL, **more)


def test_crowd_win(monkeypatch, capsys):
    monkeypatch.setattr(crowd_win, "seed_settings", _tiny(
        crowd_win.seed_settings, validation_dataset_size=4,
        test_dataset_size=4, crowd_image_height=128,
        crowd_image_width=128))
    assert crowd_win.main(["--steps", "2", "--seeds", "0", "--batch", "2",
                           "--labeled", "2", "--unlabeled", "2",
                           "--device", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert set(lines[0]) == {"seed", "MAE", "dnn_MAE", "NAE", "dnn_NAE",
                             "naive_MAE"}
    assert all(np.isfinite(v) for v in lines[0].values())
    assert lines[-1]["summary"]["gan_wins"] in ("0/1", "1/1")


def test_scale_fidelity_ab(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(scale_fidelity_ab, "arm_settings", _tiny(
        scale_fidelity_ab.arm_settings, image_patch_size=128))
    assert scale_fidelity_ab.main([
        "--steps", "2", "--batch", "2", "--images", "1", "--hires", "384",
        "512", "--work_dir", str(tmp_path), "--device", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["arm"] for l in lines[:-1]] == ["resize", "tiles",
                                              "tiles_rescale"]
    for line in lines[:-1]:
        assert all(np.isfinite(line[k]) for k in ("MAE", "NAE", "dnn_MAE",
                                                  "dnn_NAE"))
    assert set(lines[-1]["summary"]) == {"resize", "tiles", "tiles_rescale"}
