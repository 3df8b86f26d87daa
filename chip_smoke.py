#!/usr/bin/env python3
"""Drive the PyTorch port (``srgan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. build   — compile every CUDA kernel of the training path from the
             sources in this checkout (``nvcc`` for sm_90a, one process
             per source, all started together), timed;
2. kernels — the patch-sampler kernel against its plain PyTorch version
             at the flagship shapes, for uint8 images and float32 and
             bfloat16 density labels: labels exactly, images within 1e-6;
             then the fused GroupNorm + activation forward and backward
             kernels against their plain versions at every norm shape of
             the flagship step, in bfloat16 (tolerances at
             ``check_norm_kernels``); all timed with CUDA events;
3. second  — the gradient penalty's second order through the fused norm
             on the card, float32: the kernel path against autograd
             through the plain forward;
4. small   — one float32 training step at a tiny size on the card against
             the same step on the CPU (same weights, patches and draws),
             for ``norm_impl`` "xla" and "pallas";
5. train   — ``CrowdExperiment(settings).train()`` at the flagship
             configuration (batch 120, 224-px patches, base width 64,
             bfloat16 compute, a synthetic 384×512 database of 16/16/2
             images) for a few steps, with ``norm_impl`` "xla" and then
             "pallas": every step's losses finite, the patch kernel
             launched 3 times per step, and under "pallas" the norm
             kernels the number of times per step that the step's
             structure gives (``NORM_LAUNCHES_PER_STEP``);
6. time    — 20 more steps of each between ``torch.cuda.synchronize()``
             calls: ms/step, images/s and the peak of allocated device
             memory.

Prints the kernel table as one JSON line, then the card's name and power
limit as nvidia-smi gives them, and last ``{"ok": true, "device": ...}``.
Exits nonzero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

import concurrent.futures
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
# Every GroupNorm of the flagship step as (B, H·W, C, slope), 32 groups
# each: D over the 3B batch, D and the DNN over B (the D stages are
# 112²×64, 56²×128 and twice 56²×256, slope 0.2), and G over B (7²×1024
# up to 112²×64, ReLU).
NORM_SHAPES = [(360, 112 * 112, 64, 0.2), (360, 56 * 56, 128, 0.2),
               (360, 56 * 56, 256, 0.2), (120, 112 * 112, 64, 0.2),
               (120, 56 * 56, 128, 0.2), (120, 56 * 56, 256, 0.2),
               (120, 7 * 7, 1024, 0.0), (120, 14 * 14, 512, 0.0),
               (120, 28 * 28, 256, 0.0), (120, 56 * 56, 128, 0.0),
               (120, 112 * 112, 64, 0.0)]
# Fused norm kernel launches in one flagship step (train.py, a generator
# update every step; G has 5 norms, D and the DNN 4 each):
#   forward:  G(z_d) 5 + D(3B) 4 + D(interpolates) 4 + G(z_g) 5
#             + D(unlabeled) 4 + D(fake) 4 + DNN 4 = 30;
#   backward: the penalty's inner grad through D(interpolates) 4; the D
#             update's grad through D(3B) 4 and, from the penalty,
#             through D(interpolates) 4; the G update through D(fake) 4
#             and G 5; the DNN 4 = 25. The penalty's outer grad through
#             the backward kernel's own backward is composite and
#             launches none.
NORM_LAUNCHES_PER_STEP = {"fwd": 30, "bwd": 25}
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


def paired_ms(plain, kernel, iters: int):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain, so that
    both see the same warm-up."""
    t_plain = cuda_ms(plain, iters)
    t_kernel = cuda_ms(kernel, iters) + cuda_ms(kernel, iters)
    t_plain += cuda_ms(plain, iters)
    return t_kernel / 2, t_plain / 2


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
        t_kernel, t_plain = paired_ms(
            lambda: extract_patches_plain(src, offsets, flips, **call),
            lambda: extract_patches(src, offsets, flips, **call), 20)
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


def _assert_within(name, got, want, bound):
    """Every |got − want| within ``bound`` (a tensor or a number)."""
    err = (got.float() - want.float()).abs()
    over = err > bound
    if bool(over.any()):
        i = int(over.flatten().nonzero()[0])
        raise AssertionError(
            f"{name}: {int(over.sum())} elements out of tolerance, first at "
            f"flat index {i}: got {float(got.flatten()[i])}, want "
            f"{float(want.flatten()[i])}")
    return float(err.max())


def check_norm_kernels(dev):
    """Phase 2, fused norm: the forward and backward kernels against their
    plain versions at every norm shape of the flagship step, bfloat16.
    Returns the two kernel table entries (launches filled in by the
    training phase); their times are at the first, largest shape.

    Tolerances. The kernel and the plain version compute the same float32
    formulas but sum in different orders, so:
    * y and dx: within one bfloat16 ulp of each element (2⁻⁷·|want|) —
      a float32 value that lies within rounding of a bfloat16 rounding
      boundary may round the other way — plus 1e-5 of the tensor's largest
      magnitude, for elements that are differences of near-equal terms
      (dx; y0 near 0), whose float32 rounding is relative to the terms;
    * mean and rstd: rtol 1e-5 (x is drawn around 0.5, so the mean is not
      near 0);
    * dscale and dbias, sums over up to 4.5 million terms: within 1e-4 of
      their largest magnitude.
    The backward is held to the plain backward on the kernel's own mean
    and rstd, so that each check sees one kernel.
    """
    from srgan_tpu_torch.ops.fused_norm import (_launch_bwd, _launch_fwd,
                                                group_norm_act_bwd_plain,
                                                group_norm_act_fwd_plain)
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for b, hw, c, slope in NORM_SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = (randn(b, hw, c) + 0.5).to(torch.bfloat16)
        dy = randn(b, hw, c).to(torch.bfloat16)
        scale = 1.0 + 0.1 * randn(c)
        bias = 0.1 * randn(c)
        fwd_args = (x, scale, bias, 32, slope, 1e-6)
        y, mean, rstd = _launch_fwd(*fwd_args)
        torch.cuda.synchronize()
        want_y, want_mean, want_rstd = group_norm_act_fwd_plain(*fwd_args)
        if y.dtype != torch.bfloat16 or y.shape != x.shape:
            raise AssertionError(f"forward kernel returned {y.dtype} "
                                 f"{list(y.shape)}")
        err_y = _assert_within(
            "y", y, want_y, 2 ** -7 * want_y.float().abs()
            + 1e-5 * float(want_y.float().abs().max()))
        torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=0)
        torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
        bwd_args = (x, scale, bias, mean, rstd, dy, 32, slope)
        dx, dscale, dbias = _launch_bwd(*bwd_args)
        torch.cuda.synchronize()
        want_dx, want_dscale, want_dbias = group_norm_act_bwd_plain(
            *bwd_args)
        err_dx = _assert_within(
            "dx", dx, want_dx, 2 ** -7 * want_dx.float().abs()
            + 1e-5 * float(want_dx.float().abs().max()))
        for name, got, want in (("dscale", dscale, want_dscale),
                                ("dbias", dbias, want_dbias)):
            _assert_within(name, got, want,
                           1e-4 * float(want.abs().max()))
        worst["fwd"] = max(worst["fwd"], err_y)
        worst["bwd"] = max(worst["bwd"], err_dx)
        del y, want_y, dx, want_dx
        pairs = {"fwd": (lambda: group_norm_act_fwd_plain(*fwd_args),
                         lambda: _launch_fwd(*fwd_args)),
                 "bwd": (lambda: group_norm_act_bwd_plain(*bwd_args),
                         lambda: _launch_bwd(*bwd_args))}
        shape = f"[{b}, {hw}, {c}] bf16 slope {slope}"
        for kind, (plain, kernel) in pairs.items():
            t_kernel, t_plain = paired_ms(plain, kernel, 10)
            # Bytes of the two-pass kernels: x (and dy) read twice, y (dx)
            # written once.
            moved = x.numel() * x.element_size() * (3 if kind == "fwd"
                                                    else 5)
            log(f"kernel group_norm_act {kind} {shape}: max|err| "
                f"{err_y if kind == 'fwd' else err_dx:g}, kernel "
                f"{t_kernel:.4f} ms ({moved / t_kernel / 1e6:.1f} GB/s), "
                f"plain {t_plain:.4f} ms")
            times.setdefault(kind, (t_kernel, t_plain))
        del x, dy, fwd_args, bwd_args, pairs
        torch.cuda.empty_cache()
    log("kernel group_norm_act: mean/rstd within rtol 1e-5, dscale/dbias "
        "within 1e-4 of their largest, at every shape")
    return [{"name": f"group_norm_act_{kind}", "route": "cuda",
             "source": "srgan_tpu_torch/csrc/fused_norm.cu",
             "replaces": f"srgan_tpu/ops/fused_norm.py:{line}",
             "launches": None, "max_abs_err": worst[kind],
             "ms": times[kind][0], "plain_ms": times[kind][1]}
            for kind, line in (("fwd", 178), ("bwd", 226))]


def check_second_order(dev):
    """Phase 3: ∂/∂scale of mean((‖∂/∂x Σ y²‖ − 1)²), the derivative the
    gradient penalty takes through the norm (tests/test_fused_norm.py), in
    float32 at a D-like shape: the kernel path (forward kernel, backward
    kernel, composite second order) against autograd through the plain
    forward. Value at rtol 1e-4, gradient at rtol 1e-3 and atol 1e-6."""
    from srgan_tpu_torch.ops import fused_norm as fn
    b, c, h, slope = 8, 128, 56, 0.2
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((b, c, h, h), generator=gen, device=dev).contiguous(
        memory_format=torch.channels_last)
    scale = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
    bias = 0.1 * torch.randn((c,), generator=gen, device=dev)

    def plain(xi, s):
        rows = xi.permute(0, 2, 3, 1).reshape(b, h * h, c)
        y, _, _ = fn.group_norm_act_fwd_plain(rows, s, bias, 32, slope, 1e-6)
        return y.view(b, h, h, c).permute(0, 3, 1, 2)

    def kernel(xi, s):
        return fn.group_norm_act(xi, s, bias, groups=32,
                                 negative_slope=slope)

    def penalty(act):
        s = scale.clone().requires_grad_()
        xi = x.clone().requires_grad_()
        (g,) = torch.autograd.grad(act(xi, s).square().sum(), xi,
                                   create_graph=True)
        norms = (g.flatten(1).square().sum(1) + 1e-12).sqrt()
        value = (norms - 1.0).square().mean()
        (grad,) = torch.autograd.grad(value, s)
        return float(value.detach()), grad

    before = (fn._launch_fwd.launches, fn._launch_bwd.launches)
    got_v, got_g = penalty(kernel)
    launched = (fn._launch_fwd.launches - before[0],
                fn._launch_bwd.launches - before[1])
    want_v, want_g = penalty(plain)
    if launched[0] < 1 or launched[1] < 2:
        raise AssertionError(f"second order: kernels launched {launched} "
                             f"(forward, backward) times")
    if not math.isclose(got_v, want_v, rel_tol=1e-4):
        raise AssertionError(f"second order: penalty {got_v} vs {want_v}")
    torch.testing.assert_close(got_g, want_g, rtol=1e-3, atol=1e-6)
    log(f"second order [{b}, {c}, {h}, {h}] f32: penalty {got_v:.7g} "
        f"(plain {want_v:.7g}), ∂/∂scale max|err| "
        f"{float((got_g - want_g).abs().max()):g} of "
        f"{float(want_g.abs().max()):g}; kernel launches (forward, "
        f"backward) {launched}")


def check_small_step(dev, norm_impl):
    """Phase 4: one float32 step on the card against the CPU."""
    from srgan_tpu_torch import CrowdExperiment, Settings
    from srgan_tpu_torch.ops import fused_norm as fn
    from srgan_tpu_torch.train import init_train_state, set_float32_precision
    set_float32_precision()
    settings = Settings(norm_impl=norm_impl, **TINY)
    launches = fn._launch_fwd.launches
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
            raise AssertionError(f"small step ({norm_impl}): {k} is "
                                 f"{gpu_metrics[k]} on the card, {v} on the "
                                 f"CPU")
    launches = fn._launch_fwd.launches - launches
    if (launches > 0) != (norm_impl == "pallas"):
        raise AssertionError(f"small step ({norm_impl}): the fused norm "
                             f"forward kernel launched {launches} times")
    log(f"small fp32 step, norm_impl {norm_impl}, card vs CPU (rtol 1e-3; "
        f"{launches} norm forward launches on the card): "
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


def train_main_path(settings, dev, card: str) -> dict:
    """Phases 5 and 6: ``CrowdExperiment(settings).train()``, checked,
    then further steps of the same experiment timed. Returns the kernels'
    launches during ``train()``, by kernel table name."""
    from srgan_tpu_torch import CrowdExperiment
    from srgan_tpu_torch.ops import fused_norm as fn
    from srgan_tpu_torch.ops.patches import extract_patches
    exp = CrowdExperiment(settings, device=dev)
    steps = settings.steps_to_run
    impl = settings.norm_impl
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    extract_patches.launches = 0
    fn._launch_fwd.launches = 0
    fn._launch_bwd.launches = 0
    fn.group_norm_act.layout_copies = 0
    t0 = time.perf_counter()
    state = exp.train()
    sync(dev)
    launches = {"extract_patches": extract_patches.launches,
                "group_norm_act_fwd": fn._launch_fwd.launches,
                "group_norm_act_bwd": fn._launch_bwd.launches}
    copies = fn.group_norm_act.layout_copies
    log(f"train ({impl}): {steps} steps through CrowdExperiment.train() in "
        f"{time.perf_counter() - t0:.1f} s (data set-up and warm-up "
        f"included); kernel launches {json.dumps(launches)}; fused norm "
        f"layout copies {copies} ({copies / steps:g} per step)")
    if state.step != steps:
        raise AssertionError(f"trained {state.step} steps, not {steps}")
    per_step = {"extract_patches": 3}
    for kind, count in NORM_LAUNCHES_PER_STEP.items():
        per_step[f"group_norm_act_{kind}"] = count if impl == "pallas" else 0
    if dev.type == "cuda":
        for name, count in per_step.items():
            if launches[name] != count * steps:
                raise AssertionError(
                    f"{name} launched {launches[name]} times in {steps} "
                    f"steps, not {count * steps}")
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
    log(f"time ({impl}): {1e3 * elapsed / TIMED_STEPS:.2f} ms/step, "
        f"{settings.batch_size * TIMED_STEPS / elapsed:.2f} images/s "
        f"(batch {settings.batch_size}, {TIMED_STEPS} steps, {dev}: "
        f"{card}), peak allocated {peak}")
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

    # 1. build, one nvcc per source, all at once
    def build(name):
        t0 = time.perf_counter()
        library = _build.build(name)
        return (f"build: {name}.cu -> {os.path.relpath(library, REPO)} in "
                f"{time.perf_counter() - t0:.2f} s")

    names = ("patches", "fused_norm")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for line in pool.map(build, names):
            log(line)

    # 2. kernels at the flagship shapes
    entries = [check_kernels(dev)] + check_norm_kernels(dev)

    # 3. the gradient penalty's second order through the fused norm
    check_second_order(dev)

    # 4. small float32 step against the CPU, both norm paths
    for impl in ("xla", "pallas"):
        check_small_step(dev, impl)

    # 5. the main path through its entry point; 6. timed steps
    for impl in ("xla", "pallas"):
        settings = Settings(
            logs_directory=os.path.join(REPO, "logs", "chip_smoke"),
            steps_to_run=STEPS, summary_step_period=1,
            validation_step_period=10 ** 9,  # evaluation is not ported yet
            norm_impl=impl, **FLAGSHIP)
        launches = train_main_path(settings, dev, smi)
    # The kernel table counts the "pallas" run, the path through every
    # kernel.
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
