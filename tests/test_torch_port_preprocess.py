"""The port's preprocessors of raw crowd databases against the JAX
package's, on the same synthesized raw directories: the four layouts
(UCF-QNRF, ShanghaiTech, UCF-CC-50, WorldExpo'10 with its ROI), in
``resize`` and ``tiles`` mode, with density and iKNN labels. The port
runs on ``device="cpu"`` (its density kernel's plain version).

Everything but the resize-mode density is the same NumPy/PIL/scipy code
and must be equal; the resize-mode density is rendered by
``ops.density.density_maps`` where JAX renders with NumPy, and is held
within 1e-6 + 1e-4·|want| per element.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import savemat

from srgan_tpu.data import crowd as jax_crowd
from srgan_tpu_torch.data import crowd
from srgan_tpu_torch.ops.density import density_maps

RAW_H, RAW_W = 40, 60


def _image(path, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (RAW_H, RAW_W, 3)).astype(np.uint8)
                    ).save(path)


def _heads(seed, n):
    rng = np.random.default_rng(100 + seed)
    return np.stack([rng.uniform(0, RAW_W, n), rng.uniform(0, RAW_H, n)],
                    axis=-1)  # (x, y)


def _ucf_qnrf(raw):
    for i, n in enumerate((5, 0, 9)):
        _image(raw / f"img_{i:04d}.jpg", i)
        savemat(raw / f"img_{i:04d}_ann.mat", {"annPoints": _heads(i, n)})


def _shanghai_tech(raw):
    (raw / "images").mkdir()
    (raw / "ground-truth").mkdir()
    for i, n in enumerate((4, 7), start=1):
        _image(raw / "images" / f"IMG_{i}.jpg", i)
        location = np.empty((1, 1), object)
        location[0, 0] = _heads(i, n)
        info = np.empty((1, 1), object)
        info[0, 0] = location
        savemat(raw / "ground-truth" / f"GT_IMG_{i}.mat",
                {"image_info": info})


def _ucf_cc_50(raw):
    for i, n in enumerate((6, 3), start=1):
        _image(raw / f"{i}.jpg", i)
        savemat(raw / f"{i}_ann.mat", {"annPoints": _heads(i, n)})


def _world_expo(raw):
    scene = raw / "scene_104207"
    scene.mkdir()
    for i, n in enumerate((3, 0), start=1):
        _image(scene / f"104207_{i}.jpg", i)
        savemat(scene / f"104207_{i}.mat",
                {"point_position": _heads(i, n) if n else np.zeros((0, 2))})
    savemat(scene / "roi.mat",
            {"maskVerticesXCoordinates": np.array([[0.0], [40.0], [40.0],
                                                   [0.0]]),
             "maskVerticesYCoordinates": np.array([[0.0], [0.0], [30.0],
                                                   [30.0]])})


LAYOUTS = {"ucf_qnrf": _ucf_qnrf, "shanghai_tech": _shanghai_tech,
           "ucf_cc_50": _ucf_cc_50, "world_expo": _world_expo}
# resize: to 32×48; tiles: native 40×60 cut into 16×24 tiles (3×3 per
# image, the last row and column zero-padded).
SIZES = {"resize": (32, 48), "tiles": (16, 24)}


def _raw(tmp_path, database):
    raw = tmp_path / f"raw_{database}"
    raw.mkdir()
    LAYOUTS[database](raw)
    return raw


def _both(database, mode, label_type, raw):
    h, w = SIZES[mode]
    kw = dict(height=h, width=w, sigma=3.0, label_type=label_type,
              mode=mode)
    ours = crowd.PREPROCESSORS[database](device="cpu", **kw).preprocess(
        str(raw))
    theirs = jax_crowd.PREPROCESSORS[database](**kw).preprocess(str(raw))
    return ours, theirs


def _assert_equal_databases(ours, theirs, mode):
    assert len(ours) == len(theirs) > 0
    for name in ("images", "head_counts", "image_ids", "roi_masks",
                 "aux_maps", "image_mean", "image_std"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.label_type == theirs.label_type
    got, want = ours.density_maps, theirs.density_maps
    assert got.dtype == want.dtype == np.float32
    if mode == "tiles":
        np.testing.assert_array_equal(got, want)
    else:
        assert got.shape == want.shape
        assert (np.abs(got - want) <= 1e-6 + 1e-4 * np.abs(want)).all()


@pytest.mark.parametrize("label_type", ["density", "iknn"])
@pytest.mark.parametrize("mode", ["resize", "tiles"])
@pytest.mark.parametrize("database", sorted(LAYOUTS))
def test_preprocessor_equals_jax(tmp_path, database, mode, label_type):
    raw = _raw(tmp_path, database)
    ours, theirs = _both(database, mode, label_type, raw)
    _assert_equal_databases(ours, theirs, mode)
    if database == "world_expo":
        assert ours.roi_masks is not None and not ours.roi_masks.all()
    if mode == "tiles":
        assert ours.image_ids is not None


def test_resize_mode_renders_one_density_call_per_image(tmp_path,
                                                        monkeypatch):
    """Zero-head images included; the sum of each map is its count."""
    calls = []

    def counting(heads, counts, sigma, *, height, width):
        calls.append(int(counts[0]))
        return density_maps(heads, counts, sigma, height=height,
                            width=width)

    monkeypatch.setattr(crowd, "density_maps", counting)
    db = crowd.UcfQnrfPreprocessor(height=32, width=48, sigma=3.0,
                                   device="cpu").preprocess(
        str(_raw(tmp_path, "ucf_qnrf")))
    assert calls == [5, 0, 9]
    np.testing.assert_allclose(db.density_maps.sum(axis=(1, 2)),
                               db.head_counts, rtol=1e-4, atol=1e-5)


def test_database_files_load_in_either_package(tmp_path):
    raw = _raw(tmp_path, "world_expo")
    ours_path, jax_path = str(tmp_path / "ours.npz"), str(tmp_path / "j.npz")
    kw = dict(height=16, width=24, sigma=3.0, label_type="knn", mode="tiles")
    ours = crowd.WorldExpoPreprocessor(device="cpu", **kw).preprocess(
        str(raw), ours_path)
    theirs = jax_crowd.WorldExpoPreprocessor(**kw).preprocess(str(raw),
                                                              jax_path)
    _assert_equal_databases(jax_crowd.CrowdDatabase.load(ours_path),
                            theirs, "tiles")
    _assert_equal_databases(crowd.CrowdDatabase.load(jax_path), ours,
                            "tiles")


def test_preprocess_cli_equals_jax(tmp_path):
    raw = _raw(tmp_path, "ucf_qnrf")
    flags = ["--height", "32", "--width", "48", "--sigma", "3.0",
             "--label-type", "knn", "--knn-k", "2", "--no-compress"]
    assert crowd.main([str(raw), str(tmp_path / "a.npz"), "--device",
                       "cpu"] + flags) == 0
    assert jax_crowd.main([str(raw), str(tmp_path / "b.npz")] + flags) == 0
    _assert_equal_databases(crowd.CrowdDatabase.load(str(tmp_path / "a.npz")),
                            crowd.CrowdDatabase.load(str(tmp_path / "b.npz")),
                            "resize")


def test_an_archive_is_unpacked(tmp_path):
    raw = _raw(tmp_path, "ucf_cc_50")
    archive = shutil.make_archive(str(tmp_path / "ucf_cc_50"), "gztar",
                                  root_dir=raw)
    pre = crowd.UcfCc50Preprocessor(height=32, width=48, sigma=3.0,
                                    device="cpu")
    from_archive = pre.preprocess(archive)
    assert os.path.isdir(str(tmp_path / "ucf_cc_50_unpacked"))
    _assert_equal_databases(from_archive, pre.preprocess(str(raw)), "tiles")
    with pytest.raises(ValueError, match="archive"):
        pre.resolve_raw_directory(str(next(raw.glob("*.mat"))))


def test_a_url_is_refused_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("SRGAN_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.chdir(tmp_path)
    pre = crowd.UcfQnrfPreprocessor(device="cpu")
    with pytest.raises(RuntimeError, match="SRGAN_ALLOW_DOWNLOAD"):
        pre.resolve_raw_directory("https://example.invalid/qnrf.zip?sig=1")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("k", [1, 3])
def test_knn_maps_equal_jax_and_the_brute_force_form(k):
    rng = np.random.default_rng(k)
    heads = rng.uniform(-4, 30, (7, 2)).astype(np.float32)
    kw = dict(k=k, origin=(3.0, 5.0))
    got = crowd.generate_knn_map(heads, 20, 28, **kw)
    np.testing.assert_array_equal(
        got, jax_crowd.generate_knn_map(heads, 20, 28, **kw))
    np.testing.assert_allclose(
        got, crowd._generate_knn_map_chunked(heads, 20, 28, **kw),
        rtol=1e-5)
    np.testing.assert_array_equal(
        crowd.generate_iknn_map(heads, 20, 28, **kw),
        jax_crowd.generate_iknn_map(heads, 20, 28, **kw))
    empty = crowd.generate_knn_map(np.zeros((0, 2)), 4, 6, empty_value=9.0)
    assert (empty == 9.0).all()


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        crowd.UcfQnrfPreprocessor()
