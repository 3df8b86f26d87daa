"""The rest of the crowd app against the JAX package, on the CPU at a tiny
size: the JointDCNN and SpatialPyramidCNN models (forward), kNN/iKNN
targets (the synthetic database, the stacked labels, the joint loss, the
head biases, the grid counts from the count head), the model choice and
the refusals of incompatible settings. One fused step of each variant is
in ``tests/test_torch_port_crowd_variant_steps.py``.

Same weights (the flax init, converted) and the same synthetic database.
float32, both norm paths ("pallas": JAX's Pallas kernels in interpret
mode, the port's plain versions).

Tolerances: the forwards within 1e-5 of the largest output; the grid
counts rtol 1e-4 with an atol of 1e-3 of the largest
(``tests/test_torch_port_eval.py``).
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowd_variants_helpers import B, P, TINY, WIDTH, nchw, within
from srgan_tpu.apps.crowd import CrowdExperiment as JaxCrowdExperiment
from srgan_tpu.data.crowd import \
    synthetic_crowd_database as jax_synthetic_crowd_database
from srgan_tpu.models.crowd import CROWD_MODELS as JAX_CROWD_MODELS
from srgan_tpu.settings import Settings as JaxSettings
from srgan_tpu.train import init_train_state as jax_init_train_state
from srgan_tpu_torch import convert
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.data.crowd import synthetic_crowd_database
from srgan_tpu_torch.models.crowd import CROWD_MODELS
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state
from srgan_tpu_torch.utils.seeding import generator_for


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("norm_impl", ["xla", "pallas"])
@pytest.mark.parametrize("name,size", [("jointdcnn", P), ("pyramid", P),
                                       ("pyramid", 40)])
def test_models_match_flax(name, size, norm_impl):
    """40 px: a trunk map of 10×10, which level 4 does not divide."""
    kw = dict(zero_init_heads=False, density_head_bias=0.25,
              count_head_bias=-0.5)
    flax_model = JAX_CROWD_MODELS[name](base_width=WIDTH,
                                        norm_impl=norm_impl, **kw)
    x = np.random.default_rng(0).uniform(-1, 1, (3, size, size, 3)).astype(
        np.float32)
    params = flax_model.init(jax.random.key(1), jnp.zeros((1, size, size,
                                                            3)))
    (j_density, j_count), j_feats = flax_model.apply(params, jnp.asarray(x))
    extra = dict(image_size=size) if name == "pyramid" else {}
    model = CROWD_MODELS[name](WIDTH, norm_impl=norm_impl,
                               rng=generator_for(0, "t"), **extra, **kw)
    model.load_state_dict(convert.joint_cnn_state_dict(
        jax.device_get(params)))
    (density, count), feats = model(nchw(x))
    for got, want, what in ((density, j_density, "density"),
                            (count, j_count, "count"),
                            (feats, j_feats, "features")):
        within(got, want, 1e-5, what)


def test_converter_names_follow_the_flax_tree():
    params = jax.device_get(JAX_CROWD_MODELS["pyramid"](
        base_width=WIDTH).init(jax.random.key(0), jnp.zeros((1, 40, 40, 3))))
    assert sorted(params["params"]) == [
        "Conv_0", "Conv_1", "Conv_2", "Conv_3", "GroupNorm_0", "GroupNorm_1",
        "GroupNorm_2", "GroupNorm_3", "count_head", "density_head",
        "pyramid_1", "pyramid_2"]
    state = convert.joint_cnn_state_dict(params)
    assert {k for k in state if k.startswith("pyramid")} == {
        "pyramid.1.weight", "pyramid.1.bias", "pyramid.2.weight",
        "pyramid.2.bias"}
    assert state["density_head.weight"].shape == (1, 32 + 2 * 10, 1, 1)
    deep = jax.device_get(JAX_CROWD_MODELS["jointdcnn"](
        base_width=WIDTH, norm_impl="pallas").init(
            jax.random.key(0), jnp.zeros((1, P, P, 3))))
    state = convert.joint_cnn_state_dict(deep)
    assert state["convs.5.weight"].shape == (8 * WIDTH, 4 * WIDTH, 3, 3)
    assert "norms.5.scale" in state and "convs.6.weight" not in state


@pytest.mark.parametrize("name", ["jointcnn", "jointdcnn", "pyramid"])
def test_model_setup_picks_the_model(name):
    exp = CrowdExperiment(Settings(**dict(TINY, crowd_model=name)),
                          device="cpu")
    exp.dataset_setup()
    bundle = exp.model_setup()
    for model in (bundle.d, bundle.dnn):
        assert type(model) is CROWD_MODELS[name]


def test_an_unknown_model_raises_jax_error():
    exp = CrowdExperiment(Settings(**dict(TINY, crowd_model="unet")),
                          device="cpu")
    exp.dataset_setup()
    with pytest.raises(ValueError, match="unknown crowd_model 'unet'"):
        exp.model_setup()


def test_a_jointdcnn_checkpoint_does_not_restore_into_a_jointcnn(tmp_path):
    kw = dict(TINY, logs_directory=str(tmp_path), steps_to_run=1,
              summary_step_period=1, crowd_model="jointdcnn")
    trained = CrowdExperiment(Settings(**kw), device="cpu")
    trained.train()
    for other in ("jointcnn", "pyramid"):
        exp = CrowdExperiment(trained.settings.copy(crowd_model=other),
                              device="cpu")
        with pytest.raises(ValueError, match="does not match"):
            exp.prepare_for_evaluation(trained.trial_directory)


# --------------------------------------------------------- kNN/iKNN targets
@pytest.mark.parametrize("label_type", ["knn", "iknn"])
def test_synthetic_database_and_stacked_labels_equal_jax(label_type):
    kw = dict(height=24, width=32, max_heads=9, sigma=3.0, seed=5,
              label_type=label_type)
    ours, theirs = (synthetic_crowd_database(4, **kw),
                    jax_synthetic_crowd_database(4, **kw))
    for field in ("images", "density_maps", "head_counts", "aux_maps"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(theirs, field), field)
    assert ours.label_type == label_type
    settings = dict(TINY, crowd_label_type=label_type)
    mine = CrowdExperiment(Settings(**settings), device="cpu")
    jaxs = JaxCrowdExperiment(JaxSettings(**settings))
    mine.dataset_setup()
    jaxs.dataset_setup()
    stacked = mine._stacked_labels()
    assert stacked.shape == (6, 80, 96, 2)
    np.testing.assert_array_equal(stacked, jaxs._stacked_labels())


@pytest.mark.parametrize("label_type", ["density", "iknn"])
def test_loss_and_head_biases_equal_jax(label_type):
    settings = dict(TINY, crowd_label_type=label_type, zero_init_heads=True,
                    density_loss_multiplier=0.7, count_loss_multiplier=1.3)
    mine = CrowdExperiment(Settings(**settings), device="cpu")
    jaxs = JaxCrowdExperiment(JaxSettings(**settings))
    mine.dataset_setup()
    jaxs.dataset_setup()
    rng = np.random.default_rng(3)
    maps = [rng.normal(0, 1, (B, P // 4, P // 4)).astype(np.float32)
            for _ in range(2)]
    shape = (B, P, P) + ((2,) if label_type == "iknn" else ())
    labels = rng.uniform(0, 0.05, shape).astype(np.float32)
    got = mine.labeled_loss_fn()(tuple(map(torch.from_numpy, maps)),
                                 torch.from_numpy(labels))
    want = jaxs.labeled_loss_fn()(tuple(map(jnp.asarray, maps)),
                                  jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    bundle = mine.model_setup()
    _, d_params, _, _ = jaxs.model_setup()
    for head in ("density_head", "count_head"):
        np.testing.assert_allclose(
            float(getattr(bundle.d, head).bias.detach()),
            float(d_params["params"][head]["bias"][0]), rtol=1e-6)


def test_label_type_checks_raise_jax_errors(tmp_path):
    db = synthetic_crowd_database(2, 40, 40, label_type="knn")
    for split in ("labeled", "unlabeled", "validation"):
        db.save(str(tmp_path / f"{split}.npz"))
    exp = CrowdExperiment(Settings(**dict(
        TINY, crowd_database_path=str(tmp_path),
        crowd_label_type="iknn")), device="cpu")
    with pytest.raises(ValueError, match="preprocessed with"):
        exp.dataset_setup()
    plain = synthetic_crowd_database(2, 40, 40)
    plain.save(str(tmp_path / "labeled.npz"))
    with pytest.raises(ValueError, match="aux_maps missing"):
        exp.dataset_setup()
    with pytest.raises(ValueError, match="unknown crowd_label_type"):
        CrowdExperiment(Settings(crowd_label_type="dots"),
                        device="cpu").dataset_setup()


@pytest.fixture(scope="module", params=["xla", "pallas"])
def iknn_grid(request):
    kw = dict(TINY, crowd_label_type="iknn", norm_impl=request.param)
    theirs = JaxCrowdExperiment(JaxSettings(**kw))
    theirs.dataset_setup()
    models, d, g, dnn = theirs.model_setup()
    theirs.models = models
    theirs.state = jax_init_train_state(theirs.settings, d, g, dnn)
    theirs.prepare_mesh()
    theirs.prepare_train_step()
    ours = CrowdExperiment(Settings(**kw), device="cpu")
    ours.dataset_setup()
    bundle = ours.model_setup()
    host = jax.device_get
    bundle.d.load_state_dict(convert.joint_cnn_state_dict(host(d)))
    bundle.dnn.load_state_dict(convert.joint_cnn_state_dict(host(dnn)))
    bundle.g.load_state_dict(convert.generator_state_dict(host(g)))
    ours.models = bundle
    ours.state = init_train_state(ours.settings, bundle)
    ours.prepare_train_step()
    return ours, theirs


@pytest.mark.parametrize("use_dnn", [False, True])
def test_grid_counts_come_from_the_count_head_as_in_jax(iknn_grid, use_dnn):
    ours, theirs = iknn_grid
    got = ours.predict_image_counts(use_dnn=use_dnn)
    want = theirs.predict_image_counts(use_dnn=use_dnn)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-3 * float(np.abs(want).max()))
    # ... and not from the density head, which regresses the aux map.
    model = ours.state.dnn if use_dnn else ours.state.d
    with torch.no_grad():
        model.count_head.bias += 1.0
    try:
        moved = ours.predict_image_counts(use_dnn=use_dnn)
    finally:
        with torch.no_grad():
            model.count_head.bias -= 1.0
    assert np.all(moved > got + 1.0)


# --------------------------------------------------------------- refusals
def test_rescale_with_an_aux_target_raises_jax_error(tmp_path):
    exp = CrowdExperiment(Settings(**dict(
        TINY, logs_directory=str(tmp_path), crowd_label_type="iknn",
        crowd_rescale_factors=(0.75, 1.0))), device="cpu")
    with pytest.raises(ValueError, match="not scale-covariant"):
        exp.train()


@pytest.mark.parametrize("label_type", ["knn", "iknn"])
def test_aux_targets_train_and_evaluate(tmp_path, label_type):
    exp = CrowdExperiment(Settings(**dict(
        TINY, logs_directory=str(tmp_path), crowd_label_type=label_type,
        steps_to_run=2, summary_step_period=1)), device="cpu")
    assert exp.train().step == 2
    assert np.isfinite(exp.evaluate()["MAE"])


def test_the_command_line_trains_and_evaluates_the_new_settings(tmp_path,
                                                                 capsys):
    """An iKNN database through ``python -m srgan_tpu_torch crowd`` with
    the four settings the port took in: iKNN targets, the deeper model and
    a window, then ``--evaluate_only``; and the host tier. Each prints
    JAX's JSON line with finite metrics."""
    from srgan_tpu_torch.__main__ import main

    root = tmp_path / "db"
    root.mkdir()
    for i, split in enumerate(("labeled", "unlabeled", "validation")):
        synthetic_crowd_database(8, 64, 72, max_heads=6, seed=i,
                                 label_type="iknn").save(
            str(root / f"{split}.npz"))
    base = ["crowd", "--device", "cpu", f"--crowd_database_path={root}",
            f"--logs_directory={tmp_path / 'logs'}", "--batch_size=4",
            "--image_patch_size=32", "--model_base_width=8",
            "--latent_dimension=16", "--summary_step_period=1",
            "--crowd_label_type", "iknn"]
    runs = [["--crowd_model", "jointdcnn", "--crowd_hbm_window", "4",
             "--crowd_window_slices", "2", "--crowd_window_refresh_period",
             "1", "--steps_to_run", "2"],
            ["--crowd_model", "pyramid", "--crowd_host_pipeline", "true",
             "--number_of_data_workers", "1", "--steps_to_run", "2"]]
    for flags in runs:
        with pytest.warns(UserWarning) if "--crowd_host_pipeline" in flags \
                else contextlib.nullcontext():
            assert main(base + flags) == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(list(result["validation"].values())).all()
    assert main(base + runs[1][:2] + ["--evaluate_only", "--load_model_path",
                                      result["trial_directory"]]) == 0
    evaluated = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(evaluated["validation"]["MAE"],
                               result["validation"]["MAE"], rtol=1e-6)
