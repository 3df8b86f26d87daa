#!/usr/bin/env python3
"""Drive the PyTorch port (``srgan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. build   — compile every CUDA kernel of the training path from the
             sources in this checkout (``nvcc`` for sm_90a), timed;
2. kernels — the patch-sampler kernel against its plain PyTorch version
             at the flagship shapes, for uint8 images and float32 and
             bfloat16 density labels: labels exactly, images within 1e-6;
             both timed with CUDA events;
3. small   — one float32 training step at a tiny size on the card against
             the same step on the CPU (same weights, patches and draws);
4. train   — ``CrowdExperiment(settings).train()`` at the flagship
             configuration (batch 120, 224-px patches, base width 64,
             bfloat16 compute, a synthetic 384×512 database of 16/16/2
             images) for a few steps: every step's losses finite, and the
             patch kernel launched 3 times per step;
5. time    — 20 more steps between ``torch.cuda.synchronize()`` calls:
             ms/step, images/s and the peak of allocated device memory.

Prints the kernel table as one JSON line, then the card's name and power
limit as nvidia-smi gives them, and last ``{"ok": true, "device": ...}``.
Exits nonzero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

import json
import math
import os
import subprocess
import sys
import time

# Fewer fragmentation OOMs for the large eager double backward.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 8
TIMED_STEPS = 20
FLAGSHIP = dict(  # bench.py's flagship crowd configuration
    trial_name="chip_smoke", batch_size=120, image_patch_size=224,
    model_base_width=64, latent_dimension=100, labeled_dataset_size=16,
    unlabeled_dataset_size=16, validation_dataset_size=2,
    # The test split is not read by training; 2 images keep set-up short.
    test_dataset_size=2, crowd_image_height=384, crowd_image_width=512,
    seed=0, compute_dtype="bfloat16")
TINY = dict(batch_size=4, image_patch_size=32, model_base_width=8,
            latent_dimension=16, labeled_dataset_size=6,
            unlabeled_dataset_size=6, validation_dataset_size=1,
            test_dataset_size=1, crowd_image_height=80, crowd_image_width=96,
            crowd_synthetic_max_heads=12, seed=1, zero_init_heads=False)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters``
    calls after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernels(dev):
    """Phase 2: the patch kernel against the plain version at the
    flagship shapes. Returns the kernel table entry (launches filled in
    by the training phase)."""
    from srgan_tpu_torch.ops.patches import (extract_patches,
                                             extract_patches_plain)
    n, h, w, b, p = 16, 384, 512, FLAGSHIP["batch_size"], 224
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    indices = torch.from_numpy(rng.integers(0, n, b).astype(np.int32))
    offsets = torch.from_numpy(np.stack(
        [rng.integers(0, h - p + 1, b), rng.integers(0, w - p + 1, b)],
        -1).astype(np.int32))
    flips = torch.from_numpy(rng.integers(0, 2, b).astype(np.int32))
    indices, offsets, flips = (t.to(dev) for t in (indices, offsets, flips))
    images = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    labels = torch.rand((n, h, w, 1), generator=gen, device=dev) * 1e-2
    cases = [("images uint8", images, 2.0 / 255.0, -1.0, 1e-6),
             ("labels float32", labels, 1.0, 0.0, 0.0),
             ("labels bfloat16", labels.to(torch.bfloat16), 1.0, 0.0, 0.0)]
    worst = 0.0
    times = {}
    for name, src, scale, shift, tol in cases:
        call = dict(patch_size=p, scale=scale, shift=shift, indices=indices)
        got = extract_patches(src, offsets, flips, **call)
        torch.cuda.synchronize()
        want = extract_patches_plain(src, offsets, flips, **call)
        if (got.shape != (b, p, p, src.shape[-1]) or not got.is_cuda
                or got.dtype != torch.float32):
            raise AssertionError(f"patch kernel returned {got.dtype} "
                                 f"{list(got.shape)} on {got.device}")
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"patch kernel disagrees on {name}: "
                                 f"max |err| {err} > {tol}")
        worst = max(worst, err)
        # Plain, kernel, kernel, plain: both see the same warm-up.
        t_plain = cuda_ms(lambda: extract_patches_plain(src, offsets, flips,
                                                        **call), 20)
        t_kernel = cuda_ms(lambda: extract_patches(src, offsets, flips,
                                                   **call), 20)
        t_kernel = (t_kernel + cuda_ms(
            lambda: extract_patches(src, offsets, flips, **call), 20)) / 2
        t_plain = (t_plain + cuda_ms(
            lambda: extract_patches_plain(src, offsets, flips, **call),
            20)) / 2
        bytes_moved = b * p * p * src.shape[-1] * (src.element_size() + 4)
        log(f"kernel extract_patches [{name}] {list(src.shape)} -> "
            f"{list(got.shape)}: max|err| {err:g}, kernel {t_kernel:.4f} ms "
            f"({bytes_moved / t_kernel / 1e6:.1f} GB/s), plain "
            f"{t_plain:.4f} ms")
        times[name] = (t_kernel, t_plain)
    t_kernel, t_plain = times["images uint8"]
    return {"name": "extract_patches", "route": "cuda",
            "source": "srgan_tpu_torch/csrc/patches.cu",
            "replaces": "srgan_tpu/ops/patches.py:49",
            "launches": None, "max_abs_err": worst, "ms": t_kernel,
            "plain_ms": t_plain}


def check_small_step(dev):
    """Phase 3: one float32 step on the card against the CPU."""
    from srgan_tpu_torch import CrowdExperiment, Settings
    from srgan_tpu_torch.train import init_train_state, set_float32_precision
    set_float32_precision()
    settings = Settings(**TINY)
    results = []
    args = None
    rng = np.random.default_rng(5)
    b, z = settings.batch_size, settings.latent_dimension
    draws = dict(z_d=rng.normal(0, 1, (b, z)), z_g=rng.normal(0, 1, (b, z)),
                 alpha=rng.uniform(0, 1, b))
    for device in ("cpu", dev):
        exp = CrowdExperiment(settings, device=device)
        exp.dataset_setup()
        exp.models = exp.model_setup()
        exp.state = init_train_state(settings, exp.models)
        exp.prepare_train_step()
        if args is None:
            args = next(exp._patch_args_stream())
        data = exp._device_data
        batch = exp._sample_batch(data["labeled_images"],
                                  data["labeled_density"],
                                  data["unlabeled_images"], *args)
        fed = {k: torch.tensor(v, dtype=torch.float32, device=device)
               for k, v in draws.items()}
        _, metrics = exp._train_step(exp.state, *batch, None, **fed)
        results.append(({k: float(v) for k, v in metrics.items()},
                        [t.cpu() for t in batch]))
    (cpu_metrics, cpu_batch), (gpu_metrics, gpu_batch) = results
    for a, c in zip(cpu_batch, gpu_batch):
        if not torch.equal(a, c):
            raise AssertionError("patches on the card differ from the CPU's")
    for k, v in cpu_metrics.items():
        if not math.isclose(gpu_metrics[k], v, rel_tol=1e-3, abs_tol=1e-5):
            raise AssertionError(f"small step: {k} is {gpu_metrics[k]} on "
                                 f"the card, {v} on the CPU")
    log("small fp32 step, card vs CPU (rtol 1e-3): "
        + ", ".join(f"{k} {gpu_metrics[k]:.6g}/{v:.6g}"
                    for k, v in sorted(cpu_metrics.items())))


def read_losses(trial_directory: str):
    steps = {}
    for sub in ("GAN", "DNN"):
        with open(os.path.join(trial_directory, sub, "scalars.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if not rec["tag"].startswith("throughput/"):
                    steps.setdefault(rec["step"], {})[rec["tag"]] = \
                        rec["value"]
    return steps


def train_main_path(settings, dev) -> int:
    """Phases 4 and 5: ``CrowdExperiment(settings).train()``, checked,
    then further steps of the same experiment timed. Returns the patch
    kernel's launches during ``train()``."""
    from srgan_tpu_torch import CrowdExperiment
    from srgan_tpu_torch.ops.patches import extract_patches
    exp = CrowdExperiment(settings, device=dev)
    steps = settings.steps_to_run
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    extract_patches.launches = 0
    t0 = time.perf_counter()
    state = exp.train()
    sync(dev)
    launches = extract_patches.launches
    log(f"train: {steps} steps through CrowdExperiment.train() in "
        f"{time.perf_counter() - t0:.1f} s (data set-up and warm-up "
        f"included); patch kernel launches {launches}")
    if state.step != steps:
        raise AssertionError(f"trained {state.step} steps, not {steps}")
    if dev.type == "cuda" and launches != 3 * steps:
        raise AssertionError(f"patch kernel launched {launches} times in "
                             f"{steps} steps, not {3 * steps}")
    losses = read_losses(exp.trial_directory)
    if sorted(losses) != list(range(steps)):
        raise AssertionError(f"summaries for steps {sorted(losses)}")
    for step, values in sorted(losses.items()):
        if len(values) != 7 or not all(map(math.isfinite, values.values())):
            raise AssertionError(f"step {step}: losses {values}")
    log("losses, first step: " + json.dumps(losses[0]))
    log("losses, last step:  " + json.dumps(losses[steps - 1]))

    epochs = exp.epoch_batch_iterators()

    def batches():
        while True:
            yield from next(epochs)

    stream = batches()
    for _ in range(2):
        exp._train_step(exp.state, *next(stream), exp._rng)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        _, metrics = exp._train_step(exp.state, *next(stream), exp._rng)
    sync(dev)
    elapsed = time.perf_counter() - t0
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"timed steps: losses {metrics}")
    peak = (f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB"
            if dev.type == "cuda" else "not measured")
    log(f"time: {1e3 * elapsed / TIMED_STEPS:.2f} ms/step, "
        f"{settings.batch_size * TIMED_STEPS / elapsed:.2f} images/s "
        f"(batch {settings.batch_size}, {TIMED_STEPS} steps, {dev}), peak "
        f"allocated {peak}")
    return launches


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import srgan_tpu_torch
    from srgan_tpu_torch import Settings
    from srgan_tpu_torch.ops import _build
    if os.path.dirname(os.path.dirname(
            os.path.abspath(srgan_tpu_torch.__file__))) != REPO:
        print("chip_smoke: srgan_tpu_torch is not this checkout's",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"({smi})")

    # 1. build
    t0 = time.perf_counter()
    library = _build.build("patches")
    log(f"build: patches.cu -> {os.path.relpath(library, REPO)} in "
        f"{time.perf_counter() - t0:.2f} s")

    # 2. kernels at the flagship shapes
    entry = check_kernels(dev)

    # 3. small float32 step against the CPU
    check_small_step(dev)

    # 4. the main path through its entry point; 5. timed steps
    settings = Settings(
        logs_directory=os.path.join(REPO, "logs", "chip_smoke"),
        steps_to_run=STEPS, summary_step_period=1,
        validation_step_period=10 ** 9,  # evaluation is not ported yet
        **FLAGSHIP)
    entry["launches"] = train_main_path(settings, dev)
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
