"""The benchmark's plain reference held to the program (srgan_tpu_torch) at
a tiny size on the CPU: the weights' names and shapes, the models, the
patch sampler and three fused steps in float32."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness.check import moving_leaves
from benchmark.harness.weights import make_weights
from benchmark.reference import models as ref
from benchmark.reference import sampler
from benchmark.reference.step import Hyper, Models, run_steps

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _port_crowd(base=8, patch=32, latent=8, impl="xla"):
    from srgan_tpu_torch.models.crowd import CrowdDCGenerator, JointCNN
    rng = torch.Generator().manual_seed(0)
    d = JointCNN(base, dtype=torch.float32, norm_impl=impl, rng=rng)
    g = CrowdDCGenerator(image_size=patch, base_width=base,
                         latent_dimension=latent, dtype=torch.float32,
                         norm_impl=impl, rng=rng)
    return d, g


def _weights(shapes):
    return make_weights(shapes, 3, "cpu")


def test_weight_names_and_shapes_are_the_programs():
    d, g = _port_crowd()
    shapes = {"d": ref.joint_cnn_shapes(8),
              "g": ref.generator_shapes(32, 8, 8)}
    for model, module in (("d", d), ("g", g)):
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert want == shapes[model]


@pytest.mark.parametrize("impl", ["xla", "pallas", "fast"])
def test_crowd_models_match_the_program(impl):
    d, g = _port_crowd(impl=impl)
    w = _weights({"d": ref.joint_cnn_shapes(8),
                  "g": ref.generator_shapes(32, 8, 8)})
    for model, module in (("d", d), ("g", g)):
        module.load_state_dict(w[model])
    z = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    fake = ref.generator(w["g"], z, 32)
    tol = 1e-4 if impl == "fast" else 1e-5
    torch.testing.assert_close(g(z), fake, rtol=tol, atol=tol)
    (dens, count), feats = ref.joint_cnn(w["d"], fake)
    (pd, pc), pf = d(fake)
    torch.testing.assert_close(pd, dens, rtol=tol, atol=tol)
    torch.testing.assert_close(pc, count, rtol=tol, atol=tol)
    torch.testing.assert_close(pf, feats, rtol=tol, atol=tol)


@pytest.mark.parametrize("size", [16, 40, 64, 72, 224])
def test_generator_geometry_is_the_programs(size):
    from srgan_tpu_torch.models.dcgan import generator_geometry
    assert ref.generator_geometry(size) == generator_geometry(size)


def test_sampler_matches_the_programs_patches():
    from srgan_tpu_torch.ops.patches import extract_patches
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, (5, 20, 24, 3),
                                           dtype=np.uint8))
    density = torch.from_numpy(rng.random((5, 20, 24), np.float32))
    idx = torch.tensor([4, 0, 2, 2], dtype=torch.int32)
    offs = torch.tensor([[0, 0], [4, 12], [12, 3], [7, 16]],
                        dtype=torch.int32)
    flips = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    got = extract_patches(images, offs, flips, patch_size=8,
                          scale=2.0 / 255.0, shift=-1.0, indices=idx)
    want = sampler.image_patches(images, idx.long(), offs.long(),
                                 flips.long(), 8)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=0,
                               atol=1e-7)
    got = extract_patches(density[..., None], offs, flips, patch_size=8,
                          indices=idx)[..., 0]
    want = sampler.label_patches(density, idx.long(), offs.long(),
                                 flips.long(), 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_three_steps_match_the_programs_step():
    """Three fused steps of the port (float32, the composite norm) and of
    the reference from the same weights, batches and draws."""
    from srgan_tpu_torch.apps.crowd import CrowdExperiment
    from srgan_tpu_torch.settings import Settings
    from srgan_tpu_torch.train import (ModelBundle, init_train_state,
                                       make_gan_train_step)
    settings = Settings(batch_size=4, image_patch_size=32,
                        model_base_width=8, latent_dimension=8,
                        learning_rate=1e-3)
    d, g = _port_crowd()
    dnn, _ = _port_crowd()
    shapes = {"d": ref.joint_cnn_shapes(8), "g": ref.generator_shapes(
        32, 8, 8), "dnn": ref.joint_cnn_shapes(8)}
    w = _weights(shapes)
    for model, module in (("d", d), ("g", g), ("dnn", dnn)):
        module.load_state_dict(w[model])
    state = init_train_state(settings, ModelBundle(d, g, dnn))
    exp = CrowdExperiment(settings, device="cpu")
    step = make_gan_train_step(settings, labeled_loss_fn=exp.labeled_loss_fn(),
                               latent_shape=(8,))
    gen = torch.Generator().manual_seed(5)
    batches, draws, losses = [], [], []
    for _ in range(3):
        batch = (torch.rand(4, 3, 32, 32, generator=gen) * 2 - 1,
                 torch.rand(4, 32, 32, generator=gen) * 0.01,
                 torch.rand(4, 3, 32, 32, generator=gen) * 2 - 1)
        draw = (torch.randn(4, 8, generator=gen),
                torch.rand(4, generator=gen),
                torch.randn(4, 8, generator=gen))
        state, metrics = step(state, *batch, None, z_d=draw[0], z_g=draw[2],
                              alpha=draw[1])
        batches.append(batch)
        draws.append(draw)
        losses.append({k: float(v) for k, v in metrics.items()})
    models = Models(ref.joint_cnn, lambda ws, z, q: ref.generator(ws, z, 32,
                                                                  q),
                    ref.crowd_labeled_loss)
    got = run_steps(models, w, batches, draws, Hyper(learning_rate=1e-3))
    for program, reference in zip(losses, got["losses"]):
        for name, value in reference.items():
            assert program[name] == pytest.approx(value, rel=1e-4, abs=1e-6)
    # Biases before a GroupNorm have no gradient but rounding, which Adam
    # scales to whole steps: the harness leaves them out, so does this.
    moving = moving_leaves(got["grad_norms"])
    for model, module in (("d", state.d), ("g", state.g),
                          ("dnn", state.dnn)):
        for name, p in module.named_parameters():
            before_norm = (name.startswith(("convs.", "deconvs.0."))
                           and name.endswith(".bias"))
            assert not (before_norm and name in moving[model]), name
            if name not in moving[model]:
                continue
            torch.testing.assert_close(p.detach(), got["weights"][model][name],
                                       rtol=1e-4, atol=2e-5)


def test_the_reference_imports_nothing_of_the_program():
    """Neither its sources nor its import pulls in srgan_tpu_torch, the
    JAX package or JAX."""
    folder = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            with open(os.path.join(folder, name)) as f:
                assert "srgan_tpu" not in f.read(), name
    code = ("import sys, benchmark.reference.step, "
            "benchmark.reference.models, benchmark.reference.sampler, "
            "benchmark.reference.quant; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"srgan_tpu_torch", "srgan_tpu", "jax", "flax"}
