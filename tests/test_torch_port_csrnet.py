"""CSRNet as the crowd D and DNN (``models/crowd.py`` ``CSRNet``), held
to the plain reference ``benchmark/reference/csrnet.py`` on the CPU at a
tiny size: base width 8, 32-px patches, 4×4 maps, float32.

* the forward (maps and features) on seeded random weights;
* one whole SR-GAN step through the port's fused step against the
  reference's ``run_steps`` on the same weights, batches and draws: the
  losses, the first gradients (the penalty's second order through the
  dilated layers and the max-pools included) and the weights after Adam;
* the convolution rule's counters over a GAN step: 16 second orders, 6
  of them dilated;
* the app's loss against 8×8 sum-pooled targets, the evaluation grid's
  reassembly at stride 8 (the grid itself as the JAX package's for every
  model), and the refusals: a patch size the stride does not divide,
  tensor parallelism;
* ``Experiment.train()`` and grid evaluation end to end.

Tolerances, each with its reason: the program and the reference run the
same float32 convolutions, pools and sums, in another order (the rule's
second order through ``convolution_backward``, the reference through
autograd's own), so they agree to float32 rounding amplified by the
depth: 16 layers forward, and the double backward back through them.
On three seeds the step read at most 2.6e-6 (losses), 8.1e-7
(gradients) and 4.6e-6 (weights) of the measures below; the port in
bfloat16 read at least 1.3e-2, 7.6e-2 and 2e-3 on two, 100× each
tolerance or more (the forward's margin is asserted in its test), so a
step computed a precision lower fails them.
"""

import math

import numpy as np
import pytest
import torch

from benchmark.harness.weights import make_weights
from benchmark.reference import csrnet as ref
from benchmark.reference import models as ref_models
from benchmark.reference.step import Hyper, Models, run_steps
from srgan_tpu_torch.apps.crowd import CrowdExperiment
from srgan_tpu_torch.models.crowd import CROWD_MODELS, CSRNet
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import init_train_state, make_gan_train_step
from srgan_tpu_torch.utils import trace

WIDTH, P, LATENT, B = 8, 32, 8, 4
LR = 1e-3
# The forward: float32 against float32, within 1e-5 of the largest
# output (the port in bfloat16 reads 1e-3 and more: asserted below).
FORWARD_TOL = 1e-5
# A step's losses: rtol 1e-4 (the penalty, a norm of a double backward
# through 16 layers, is the least exact of them).
LOSS_RTOL = 1e-4
# The first gradients, each leaf within 1e-4 of the model's largest leaf
# entry: the double backward's sums of 4×4 to 32×32 cells in another
# order.
GRAD_TOL = 1e-4
# The weights after Adam's first step: a move of lr·m̂/(√v̂ + ε), lr·sign(g)
# wherever |g| ≫ ε; within 2e-5 (2% of lr) where the reference's gradient
# is at least 1e-3 of the leaf's largest (a smaller one is rounding that
# Adam scales to a whole step).
WEIGHT_ATOL = 2e-5
CROWD = dict(batch_size=B, image_patch_size=P, model_base_width=WIDTH,
             latent_dimension=LATENT, labeled_dataset_size=6,
             unlabeled_dataset_size=6, validation_dataset_size=3,
             test_dataset_size=2, crowd_image_height=48,
             crowd_image_width=64, crowd_sigma=2.0,
             crowd_synthetic_max_heads=8, seed=3, learning_rate=LR,
             crowd_model="csrnet", data_parallel_devices=1)


def _shapes():
    d = ref.csrnet_shapes(WIDTH)
    return {"d": d, "g": ref_models.generator_shapes(P, WIDTH, LATENT),
            "dnn": dict(d)}


def _weights(seed=5):
    return make_weights(_shapes(), seed, "cpu")


def _close(got, want, tol, what=""):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol * scale,
                               msg=what)


def test_csrnet_has_the_published_layers():
    d = CSRNet(64, rng=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in d.state_dict().items()} == \
        ref.csrnet_shapes(64)
    # 16 263 489 published parameters, and the second 1×1 head's 65.
    assert sum(p.numel() for p in d.parameters()) == 16_263_489 + 65
    assert [c.dilation for c in d.backend] == [2] * 6
    assert {c.dilation for c in d.frontend} == {1}
    assert CROWD_MODELS["csrnet"] is CSRNet and CSRNet.OUTPUT_STRIDE == 8
    assert {CROWD_MODELS[n].OUTPUT_STRIDE for n in
            ("jointcnn", "jointdcnn", "pyramid")} == {4}


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_forward_matches_the_reference(layout):
    w = _weights()["d"]
    x = torch.rand(3, 3, P, P, generator=torch.Generator().manual_seed(1))
    x = x * 2 - 1
    d = CSRNet(WIDTH, rng=torch.Generator().manual_seed(0))
    d.load_state_dict(w)
    if layout == "channels_last":
        d = d.to(memory_format=torch.channels_last)
        x = x.contiguous(memory_format=torch.channels_last)
    (dens, count), feats = ref.csrnet(w, x)
    (pd, pc), pf = d(x)
    assert pd.shape == (3, P // 8, P // 8) and pf.shape == (3, WIDTH)
    for what, got, want in (("density", pd, dens), ("count", pc, count),
                            ("features", pf, feats)):
        _close(got, want, FORWARD_TOL, what)
    # The tolerance tells the precisions apart: the port in bfloat16 is
    # outside it by a wide margin.
    low = CSRNet(WIDTH, dtype=torch.bfloat16,
                 rng=torch.Generator().manual_seed(0))
    low.load_state_dict(w)
    _, lf = low(x)
    assert (lf - feats).abs().max() > 30 * FORWARD_TOL * feats.abs().max()


def _experiment(tmp_path=None, **over):
    kw = dict(CROWD, **over)
    if tmp_path is not None:
        kw["logs_directory"] = str(tmp_path)
    return CrowdExperiment(Settings(**kw), device="cpu")


def _batches(steps, gen):
    out = []
    for _ in range(steps):
        out.append(((torch.rand(B, 3, P, P, generator=gen) * 2 - 1),
                    torch.rand(B, P, P, generator=gen) * 0.01,
                    (torch.rand(B, 3, P, P, generator=gen) * 2 - 1)))
    return out


def _draws(steps, gen):
    return [(torch.randn(B, LATENT, generator=gen),
             torch.rand(B, generator=gen),
             torch.randn(B, LATENT, generator=gen)) for _ in range(steps)]


def _port_step(w, batches, draws):
    """The port's fused step from the weights ``w``: (its metrics a step,
    its state, its first gradients from Adam's first moment)."""
    exp = _experiment()
    settings = exp.settings
    exp.dataset_setup()
    bundle = exp.model_setup()
    for name in ("d", "g", "dnn"):
        getattr(bundle, name).load_state_dict(w[name])
    state = init_train_state(settings, bundle)
    step = make_gan_train_step(settings,
                               labeled_loss_fn=exp.labeled_loss_fn(),
                               latent_shape=(LATENT,))
    metrics, first = [], None
    for batch, (z_d, alpha, z_g) in zip(batches, draws):
        state, m = step(state, *batch, None, z_d=z_d, z_g=z_g, alpha=alpha)
        metrics.append({k: float(v) for k, v in m.items()})
        if first is None:
            first = {}
            for name, opt in (("d", state.d_opt), ("g", state.g_opt),
                              ("dnn", state.dnn_opt)):
                first[name] = {
                    k: opt.adam.state[p]["exp_avg"] / (1 - settings.adam_b1)
                    for k, p in getattr(state, name).named_parameters()}
    return metrics, state, first


def _reference_models():
    return Models(ref.csrnet,
                  lambda ws, z, q: ref_models.generator(ws, z, P, q),
                  ref.labeled_loss)


def test_a_gan_step_matches_the_reference():
    """One fused SR-GAN step (D with the penalty's double backward, G, the
    DNN, Adam on each) from the same weights, batch and draws."""
    gen = torch.Generator().manual_seed(6)
    w = _weights()
    batches, draws = _batches(1, gen), _draws(1, gen)
    metrics, state, first = _port_step(w, batches, draws)
    got = run_steps(_reference_models(), w, batches, draws,
                    Hyper(learning_rate=LR))
    for name, value in got["losses"][0].items():
        assert metrics[0][name] == pytest.approx(value, rel=LOSS_RTOL), name
    assert got["losses"][0]["d_gradient_penalty"] > 0
    for model in ("d", "g", "dnn"):
        want = got["first_grads"][model]
        scale = max(t.abs().max().item() for t in want.values())
        for name, g in want.items():
            torch.testing.assert_close(first[model][name], g, rtol=0,
                                       atol=GRAD_TOL * scale,
                                       msg=f"{model}.{name}")
        module = getattr(state, model)
        for name, p in module.named_parameters():
            g = want[name]
            moving = g.abs() >= 1e-3 * g.abs().max()
            after = got["weights"][model][name]
            diff = (p.detach() - after).abs()[moving]
            assert diff.numel() and diff.max() <= WEIGHT_ATOL, \
                (model, name, diff.max().item())


def test_a_gan_step_counts_16_second_orders_6_dilated(tmp_path):
    exp = _experiment(tmp_path)
    exp.dataset_setup()
    exp.models = exp.model_setup()
    exp.state = init_train_state(exp.settings, exp.models)
    exp.prepare_train_step()
    batch = next(next(exp.epoch_batch_iterators()))
    before = trace.counters()
    exp.state, _ = exp._step(*batch)
    now = trace.counters()
    assert now["conv.second_order"] - before["conv.second_order"] == 16
    assert (now["conv.dilated_second_order"]
            - before["conv.dilated_second_order"]) == 6


@pytest.mark.parametrize("label_type", ["density", "iknn"])
def test_the_apps_loss_pools_its_targets_8x8(label_type):
    exp = _experiment(crowd_label_type=label_type)
    loss = exp.labeled_loss_fn()
    gen = torch.Generator().manual_seed(2)
    density = torch.rand(B, 4, 4, generator=gen)
    count = torch.rand(B, 4, 4, generator=gen)
    labels = torch.rand(B, P, P, generator=gen) * 0.01
    if label_type == "density":
        want = ref.labeled_loss((density, count), labels)
        torch.testing.assert_close(loss((density, count), labels), want,
                                   rtol=1e-6, atol=0)
        return
    aux = torch.rand(B, P, P, generator=gen)
    got = loss((density, count), torch.stack([labels, aux], dim=-1))
    target = aux.reshape(B, 4, 8, 4, 8).mean(dim=(2, 4))
    want = ((density - target).square().mean()
            + (count.sum(dim=(1, 2)) - labels.sum(dim=(1, 2))
               ).square().mean())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_the_head_biases_are_the_dataset_mean_8x8_cell():
    exp = _experiment(zero_init_heads=True)
    exp.dataset_setup()
    bundle = exp.model_setup()
    mean = float(np.mean(exp.labeled_db.density_maps))
    for model in (bundle.d, bundle.dnn):
        for head in (model.density_head, model.count_head):
            assert head.bias.item() == pytest.approx(64 * mean, rel=1e-6)
            assert not head.weight.any()


def test_the_grid_reassembles_maps_at_stride_8(tmp_path):
    """The evaluation grid against a host reassembly: each grid patch
    through D, its 4×4 map added at its offset over 8, the overlaps
    averaged."""
    exp = _experiment(tmp_path, zero_init_heads=False)
    exp.dataset_setup()
    exp.models = exp.model_setup()
    exp.state = init_train_state(exp.settings, exp.models)
    exp.prepare_train_step()
    got = exp.predict_density_maps(use_dnn=False)
    db = exp.validation_db
    h, w = db.image_size
    assert got.shape == (len(db), h // 8, w // 8)
    offsets = exp._grid_offsets((h, w))
    assert not (offsets % 8).any()
    canvas = np.zeros((len(db), h // 8, w // 8))
    weight = np.zeros((h // 8, w // 8))
    images = torch.from_numpy(db.images).float() * (2 / 255) - 1
    with torch.no_grad():
        for oy, ox in offsets:
            patch = images[:, oy:oy + P, ox:ox + P].permute(0, 3, 1, 2)
            (dens, _), _ = exp.state.d(patch)
            canvas[:, oy // 8:(oy + P) // 8, ox // 8:(ox + P) // 8] += \
                dens.numpy()
            weight[oy // 8:(oy + P) // 8, ox // 8:(ox + P) // 8] += 1
    want = canvas / weight
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    counts = exp.predict_image_counts(use_dnn=False)
    np.testing.assert_allclose(counts, got.sum(axis=(1, 2)), rtol=1e-5)


def test_the_grid_steps_half_a_patch_whatever_the_stride():
    """The JAX package's grid, ``max(1, p // 2)`` and the far edges,
    for every model: a 36-px JointCNN patch steps 18 px, not a multiple
    of its stride 4."""
    want = [(y, x) for y in (0, 12) for x in (0, 18, 28)]
    exp = _experiment(image_patch_size=36, crowd_model="jointcnn")
    assert exp._grid_offsets((48, 64)).tolist() == [list(o) for o in want]
    want = [(y, x) for y in (0, 16) for x in (0, 16, 32)]
    assert _experiment()._grid_offsets((48, 64)).tolist() == \
        [list(o) for o in want]


def test_a_patch_size_the_stride_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="output stride 8"):
        _experiment(image_patch_size=36).check_settings()
    # The JointCNN family's stride is 4: the same size passes its check.
    _experiment(image_patch_size=36, crowd_model="jointcnn").check_settings()


def test_tensor_parallelism_refuses_csrnet_before_any_rank(tmp_path):
    exp = _experiment(tmp_path, model_parallel_devices=2)
    with pytest.raises(ValueError, match="'csrnet' does not run under "
                                         "model_parallel_devices > 1"):
        exp.train()
    assert exp.trial_directory is None


def test_train_and_evaluate_end_to_end(tmp_path):
    exp = _experiment(tmp_path, steps_to_run=2, summary_step_period=1,
                      save_step_period=2)
    state = exp.train()
    assert state.step == 2
    assert isinstance(state.d, CSRNet) and isinstance(state.dnn, CSRNet)
    metrics = exp.evaluate()
    assert all(math.isfinite(v) for v in metrics.values()), metrics

