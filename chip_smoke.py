#!/usr/bin/env python3
"""Drive the PyTorch port (``srgan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. build   — compile every CUDA kernel of the training path from the
             sources in this checkout (``nvcc`` for sm_90a, one process
             per source, all started together; ``patches.cu`` holds both
             patch samplers), timed;
2. kernels — the patch-sampler kernel against its plain PyTorch version
             at the flagship shapes, for uint8 images and float32 and
             bfloat16 density labels: labels exactly, images within 1e-6;
             the rescale sampler likewise at windows 168/224/280 (images
             within 1e-6, labels within 1e-5 of their largest value);
             then the fused GroupNorm + activation forward and backward
             kernels against their plain versions at every norm shape of
             the flagship step, in bfloat16 (tolerances at
             ``check_norm_kernels``); all timed with CUDA events, beside
             their bound and, where one exists, one PyTorch call that
             computes the same function;
3. second  — the gradient penalty's second order through the fused norm
             on the card, float32: the kernel path against autograd
             through the plain forward;
4. small   — at a tiny size on the card against the CPU, float32, for
             ``norm_impl`` "xla" and "pallas", with fixed and with
             rescaled patches: the grid evaluation's density maps and
             counts on the same weights, then one training step (same
             weights, patches and draws);
5. train   — ``CrowdExperiment(settings).train()`` at the flagship
             configuration (batch 120, 224-px patches, base width 64,
             bfloat16 compute, a synthetic 384×512 database of 16/16/16
             images) for 8 steps with validation every 4, with fixed
             patches under ``norm_impl`` "xla" and "pallas", then with
             ``crowd_rescale_factors`` (0.75, 1.0, 1.25) under "pallas":
             every step's losses finite, every validation scalar finite
             for D and the DNN, the sample and triptych PNGs written, and
             each kernel launched the number of times that the step's and
             the validation pass's structure give
             (``NORM_LAUNCHES_PER_STEP``, ``LAUNCHES_PER_VALIDATION``);
6. time    — 20 more steps of each between ``torch.cuda.synchronize()``
             calls: ms/step, images/s and the peak of allocated device
             memory; and one validation pass.

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
VALIDATION_PERIOD = 4
RESCALE = (0.75, 1.0, 1.25)
# The card's peaks (H100 SXM data sheet, at 700 W): the bound of a call is
# the larger of its bytes over the memory rate and its operations over the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
FLAGSHIP = dict(  # bench.py's flagship crowd configuration
    trial_name="chip_smoke", batch_size=120, image_patch_size=224,
    model_base_width=64, latent_dimension=100, labeled_dataset_size=16,
    unlabeled_dataset_size=16, validation_dataset_size=16,
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
# Kernel launches in one validation pass at the flagship (crowd.py
# validation_summaries): G's sample grid of 4 (5 norms); per model, D and
# then the DNN, the maps of 16 validation images in chunks of 8
# (EVAL_CHUNK_IMAGES), each chunk one patch-kernel call for its 8·12 grid
# patches (384×512 images, 224-px patches, stride 112: 3 rows × 4 columns)
# and one forward (4 norms):
#   extract_patches: 2 models × 2 chunks = 4;
#   norm forward:    G 5 + 2 models × 2 chunks × 4 = 21; backward 0.
LAUNCHES_PER_VALIDATION = {"extract_patches": 4, "group_norm_act_fwd": 21,
                           "group_norm_act_bwd": 0,
                           "extract_rescaled_patches": 0}
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


def least_ms(bytes_moved: float, ops: float):
    """(least ms on the card, what bounds it) for a call that must move
    ``bytes_moved`` and do ``ops`` float32 operations."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    # The image call: u8 windows in, f32 patches out, 4 int32 per example;
    # one multiply and one add per element.
    elems = b * p * p * 3
    bound_ms, bound_by = least_ms(elems * (1 + 4) + b * 16, 2 * elems)
    # No single PyTorch call gathers, crops, flips and normalizes.
    return {"name": "extract_patches", "route": "cuda",
            "source": "srgan_tpu_torch/csrc/patches.cu",
            "replaces": "srgan_tpu/ops/patches.py:49",
            "launches": None, "max_abs_err": worst, "ms": t_kernel,
            "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def check_rescale_kernel(dev):
    """Phase 2: the rescale kernel against its plain version at the
    flagship shapes: 120 examples over a 16×384×512 source, windows
    (168, 224, 280) each used by a third of the batch, flips both ways,
    offsets at both bounds. Tolerances: images max |err| ≤ 1e-6, labels ≤
    1e-5 of their largest value; the two compute the same float32 terms
    in different sum orders. Returns the kernel table entry (the image
    call's times; ``max_abs_err`` the images' absolute error and the
    labels' error relative to their largest value, whichever is larger)."""
    from srgan_tpu_torch.ops.patches import (_tap_table,
                                             extract_rescaled_patches,
                                             extract_rescaled_patches_plain)
    n, h, w, b, p = 16, 384, 512, FLAGSHIP["batch_size"], 224
    windows = tuple(int(round(p * f)) for f in RESCALE)
    rng = np.random.default_rng(1)
    sidx = rng.permutation(np.arange(b) % len(windows)).astype(np.int32)
    win = np.asarray(windows)[sidx]
    offsets = np.stack([rng.integers(0, h - win + 1),
                        rng.integers(0, w - win + 1)], -1).astype(np.int32)
    offsets[:3] = 0
    offsets[3:6] = np.stack([h - win[3:6], w - win[3:6]], -1)
    flips = (np.arange(b) % 2).astype(np.int32)
    indices = rng.integers(0, n, b).astype(np.int32)
    indices, offsets_t, flips, sidx_t = (
        torch.from_numpy(a).to(dev) for a in (indices, offsets, flips, sidx))
    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    labels = torch.rand((n, h, w, 1), generator=gen, device=dev) * 1e-2
    cases = [("images uint8", images, 2.0 / 255.0, -1.0, False),
             ("labels float32", labels, 1.0, 0.0, True),
             ("labels bfloat16", labels.to(torch.bfloat16), 1.0, 0.0, True)]
    taps = _tap_table(windows, p)[2]
    worst = 0.0
    entry = None
    for name, src, scale, shift, mass in cases:
        c = src.shape[-1]
        call = dict(patch_size=p, window_sizes=windows, scale=scale,
                    shift=shift, preserve_mass=mass, indices=indices)
        args = (src, offsets_t, flips, sidx_t)
        got = extract_rescaled_patches(*args, **call)
        torch.cuda.synchronize()
        want = extract_rescaled_patches_plain(*args, **call)
        if got.shape != (b, p, p, c) or got.dtype != torch.float32:
            raise AssertionError(f"rescale kernel returned {got.dtype} "
                                 f"{list(got.shape)}")
        largest = float(want.abs().max())
        tol = 1e-6 if src.dtype == torch.uint8 else 1e-5 * largest
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"rescale kernel disagrees on {name}: "
                                 f"max |err| {err} > {tol}")
        worst = max(worst, err if src.dtype == torch.uint8 else err / largest)
        t_kernel, t_plain = paired_ms(
            lambda: extract_rescaled_patches_plain(*args, **call),
            lambda: extract_rescaled_patches(*args, **call), 20)
        # Each window read once, each patch written once, 5 int32 per
        # example. Operations: per output row of a resized window, K taps
        # across the window (a multiply-add and the normalization's
        # multiply and add), then per element K multiply-adds and the mass
        # factor; a copied window 3 per element.
        bytes_moved = (int((win.astype(np.int64) ** 2).sum()) * c
                       * src.element_size() + b * p * p * c * 4 + b * 20)
        resized = win != p
        ops = (p * c * (int(win[resized].sum()) * taps * 4
                        + int(resized.sum()) * p * (2 * taps + 1))
               + int((~resized).sum()) * p * p * c * 3)
        bound_ms, bound_by = least_ms(bytes_moved, ops)
        log(f"kernel extract_rescaled_patches [{name}] {list(src.shape)} -> "
            f"{list(got.shape)}, windows {windows}, {taps} taps: max|err| "
            f"{err:g} (tolerance {tol:g}), kernel {t_kernel:.4f} ms "
            f"({bytes_moved / t_kernel / 1e6:.1f} GB/s), plain "
            f"{t_plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if entry is None:  # the table holds the image call
            entry = {"name": "extract_rescaled_patches", "route": "cuda",
                     "source": "srgan_tpu_torch/csrc/patches.cu",
                     "replaces": "srgan_tpu/ops/patches.py:49",
                     "launches": None, "ms": t_kernel, "plain_ms": t_plain,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     # No single PyTorch call gathers, crops, resizes with
                     # JAX's weights and flips.
                     "library_ms": None}
    entry["max_abs_err"] = worst
    return entry


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
        if "library" not in times:  # the first, largest shape
            times["library"] = library_norm_ms(x, scale, bias, dy)
            # Least bytes: x (and dy) read once, y (dx) written once, the
            # float32 per-channel and per-group vectors; operations about
            # 8 (forward) and 15 (backward) per element.
            vectors = 4 * (2 * c + 2 * b * 32)
            xb = x.numel() * x.element_size()
            times["bound"] = {
                "fwd": least_ms(2 * xb + vectors, 8 * x.numel()),
                "bwd": least_ms(3 * xb + vectors + 8 * c, 15 * x.numel())}
            log(f"library [{b}, {hw}, {c}] bf16, F.group_norm (no "
                f"activation) on an NCHW copy: forward "
                f"{times['library']['fwd']:.4f} ms, autograd backward "
                f"{times['library']['bwd']:.4f} ms; bounds "
                + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                            for k, v in times["bound"].items()))
        del x, dy, fwd_args, bwd_args, pairs
        torch.cuda.empty_cache()
    log("kernel group_norm_act: mean/rstd within rtol 1e-5, dscale/dbias "
        "within 1e-4 of their largest, at every shape")
    return [{"name": f"group_norm_act_{kind}", "route": "cuda",
             "source": "srgan_tpu_torch/csrc/fused_norm.cu",
             "replaces": f"srgan_tpu/ops/fused_norm.py:{line}",
             "launches": None, "max_abs_err": worst[kind],
             "ms": times[kind][0], "plain_ms": times[kind][1],
             "bound_ms": times["bound"][kind][0],
             "bound_by": times["bound"][kind][1],
             "library_ms": times["library"][kind]}
            for kind, line in (("fwd", 178), ("bwd", 226))]


def library_norm_ms(x, scale, bias, dy):
    """{"fwd", "bwd"}: ms of ``F.group_norm`` (32 groups, the norm without
    the activation) and of its autograd backward, on NCHW-contiguous
    copies of x [B, H·W, C] and dy, H = W, the library's own layout."""
    import torch.nn.functional as F
    b, hw, c = x.shape
    side = math.isqrt(hw)

    def nchw(t):
        return t.view(b, side, side, c).permute(0, 3, 1, 2).contiguous()

    xn, dyn = nchw(x).requires_grad_(), nchw(dy)
    w = scale.to(x.dtype).requires_grad_()
    bb = bias.to(x.dtype).requires_grad_()
    with torch.no_grad():
        fwd = cuda_ms(lambda: F.group_norm(xn, 32, w, bb, 1e-6), 10)
    y = F.group_norm(xn, 32, w, bb, 1e-6)
    bwd = cuda_ms(lambda: torch.autograd.grad(y, (xn, w, bb), dyn,
                                              retain_graph=True), 10)
    return {"fwd": fwd, "bwd": bwd}


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


def check_small_step(dev, norm_impl, factors=()):
    """Phase 4: at a tiny size, float32, on the card against the CPU: the
    grid evaluation on the init weights, then one training step.

    Tolerances. Patches: fixed ones exactly; rescaled ones as the rescale
    kernel's check (images 1e-6, labels 1e-5 of their largest). Step
    metrics: rtol 1e-3. Density maps and counts: rtol 1e-4 plus 1e-3 of
    the largest value, the bound of tests/test_torch_port_eval.py, where
    the tiny models' one-channel GroupNorms amplify the two devices'
    different sum orders."""
    from srgan_tpu_torch import CrowdExperiment, Settings
    from srgan_tpu_torch.ops import fused_norm as fn
    from srgan_tpu_torch.ops.patches import extract_rescaled_patches
    from srgan_tpu_torch.train import init_train_state, set_float32_precision
    set_float32_precision()
    settings = Settings(norm_impl=norm_impl, crowd_rescale_factors=factors,
                        **TINY)
    launches = (fn._launch_fwd.launches, extract_rescaled_patches.launches)
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
        evaluated = (exp.predict_density_maps(use_dnn=False),
                     exp.predict_image_counts(use_dnn=True))
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
                        [t.cpu() for t in batch], evaluated))
    (cpu_metrics, cpu_batch, cpu_eval), (gpu_metrics, gpu_batch, gpu_eval) \
        = results
    for name, a, c in zip(("images", "labels", "unlabeled"), cpu_batch,
                          gpu_batch):
        tol = 0.0 if not factors else (
            1e-5 * float(a.abs().max()) if name == "labels" else 1e-6)
        err = float((a - c).abs().max())
        if not err <= tol:
            raise AssertionError(f"small step ({norm_impl}, factors "
                                 f"{factors}): {name} patches on the card "
                                 f"differ from the CPU's by {err} > {tol}")
    for name, a, c in zip(("maps", "counts"), cpu_eval, gpu_eval):
        np.testing.assert_allclose(
            c, a, rtol=1e-4, atol=1e-3 * float(np.abs(a).max()),
            err_msg=f"small grid evaluation ({norm_impl}): {name}")
    for k, v in cpu_metrics.items():
        if not math.isclose(gpu_metrics[k], v, rel_tol=1e-3, abs_tol=1e-5):
            raise AssertionError(f"small step ({norm_impl}): {k} is "
                                 f"{gpu_metrics[k]} on the card, {v} on the "
                                 f"CPU")
    launches = (fn._launch_fwd.launches - launches[0],
                extract_rescaled_patches.launches - launches[1])
    if dev.type == "cuda" and ((launches[0] > 0) != (norm_impl == "pallas")
                               or launches[1] != (3 if factors else 0)):
        raise AssertionError(f"small step ({norm_impl}, factors {factors}): "
                             f"(norm forward, rescale) kernels launched "
                             f"{launches} times")
    log(f"small fp32, norm_impl {norm_impl}, rescale factors {factors}, "
        f"card vs CPU ((norm forward, rescale) launches on the card "
        f"{launches}): maps max|err| "
        f"{float(np.abs(gpu_eval[0] - cpu_eval[0]).max()):g} of "
        f"{float(np.abs(cpu_eval[0]).max()):g}, counts "
        f"{np.array2string(gpu_eval[1], precision=6)}/"
        f"{np.array2string(cpu_eval[1], precision=6)}; step "
        + ", ".join(f"{k} {gpu_metrics[k]:.6g}/{v:.6g}"
                    for k, v in sorted(cpu_metrics.items())))


def read_scalars(trial_directory: str):
    """{writer: {step: {tag: value}}} of the trial's scalars.jsonl files,
    throughput left out."""
    out = {}
    for sub in ("GAN", "DNN"):
        steps = out.setdefault(sub, {})
        with open(os.path.join(trial_directory, sub, "scalars.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if not rec["tag"].startswith("throughput/"):
                    steps.setdefault(rec["step"], {})[rec["tag"]] = \
                        rec["value"]
    return out


def check_validation(trial_directory: str, steps) -> None:
    """validation/{MAE,RMSE,NVE,NAE} finite at ``steps`` for D and the
    DNN; the triptych and sample PNGs of each step written."""
    scalars = read_scalars(trial_directory)
    tags = {f"validation/{k}" for k in ("MAE", "RMSE", "NVE", "NAE")}
    for sub in ("GAN", "DNN"):
        for step in steps:
            got = {k: v for k, v in scalars[sub].get(step, {}).items()
                   if k.startswith("validation/")}
            if set(got) != tags or not all(map(math.isfinite, got.values())):
                raise AssertionError(f"{sub} validation at step {step}: "
                                     f"{got}")
            names = [f"validation_density_{i}_{step}.png" for i in (0, 1)]
            if sub == "GAN":
                names += [f"generated_sample_{i}_{step}.png" for i in range(4)]
            for name in names:
                path = os.path.join(trial_directory, sub, "images", name)
                with open(path, "rb") as f:
                    if f.read(8) != b"\x89PNG\r\n\x1a\n":
                        raise AssertionError(f"{path} is not a PNG")


def train_main_path(settings, dev, card: str) -> dict:
    """Phases 5 and 6: ``CrowdExperiment(settings).train()`` with
    validation every ``VALIDATION_PERIOD`` steps, checked, then further
    steps of the same experiment timed, and one validation pass timed.
    Returns the kernels' launches during ``train()``, by kernel table
    name."""
    from srgan_tpu_torch import CrowdExperiment
    from srgan_tpu_torch.ops import fused_norm as fn
    from srgan_tpu_torch.ops.patches import (extract_patches,
                                             extract_rescaled_patches)
    exp = CrowdExperiment(settings, device=dev)
    steps = settings.steps_to_run
    impl = settings.norm_impl
    rescale = bool(settings.crowd_rescale_factors)
    what = f"{impl}{', rescale' if rescale else ''}"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters = {"extract_patches": extract_patches,
                "extract_rescaled_patches": extract_rescaled_patches,
                "group_norm_act_fwd": fn._launch_fwd,
                "group_norm_act_bwd": fn._launch_bwd}
    for counter in counters.values():
        counter.launches = 0
    fn.group_norm_act.layout_copies = 0
    t0 = time.perf_counter()
    state = exp.train()
    sync(dev)
    launches = {name: c.launches for name, c in counters.items()}
    copies = fn.group_norm_act.layout_copies
    validations = steps // VALIDATION_PERIOD
    log(f"train ({what}): {steps} steps and {validations} validation passes "
        f"through CrowdExperiment.train() in "
        f"{time.perf_counter() - t0:.1f} s (data set-up and warm-up "
        f"included); kernel launches {json.dumps(launches)}; fused norm "
        f"layout copies {copies} ({copies / steps:g} per step)")
    if state.step != steps:
        raise AssertionError(f"trained {state.step} steps, not {steps}")
    per_step = {"extract_patches": 0 if rescale else 3,
                "extract_rescaled_patches": 3 if rescale else 0}
    for kind, count in NORM_LAUNCHES_PER_STEP.items():
        per_step[f"group_norm_act_{kind}"] = count if impl == "pallas" else 0
    per_validation = {name: count if impl == "pallas"
                      or not name.startswith("group_norm") else 0
                      for name, count in LAUNCHES_PER_VALIDATION.items()}
    if dev.type == "cuda":
        for name, count in per_step.items():
            want = count * steps + per_validation[name] * validations
            if launches[name] != want:
                raise AssertionError(
                    f"{name} launched {launches[name]} times in {steps} "
                    f"steps and {validations} validation passes, not "
                    f"{want} ({count} per step, {per_validation[name]} per "
                    f"validation pass)")
    losses = read_scalars(exp.trial_directory)
    merged = {}
    for sub in ("GAN", "DNN"):
        for step, values in losses[sub].items():
            merged.setdefault(step, {}).update(
                {k: v for k, v in values.items()
                 if not k.startswith("validation/")})
    merged = {k: v for k, v in merged.items() if v}
    if sorted(merged) != list(range(steps)):
        raise AssertionError(f"summaries for steps {sorted(merged)}")
    for step, values in sorted(merged.items()):
        if len(values) != 7 or not all(map(math.isfinite, values.values())):
            raise AssertionError(f"step {step}: losses {values}")
    check_validation(exp.trial_directory,
                     range(VALIDATION_PERIOD, steps + 1, VALIDATION_PERIOD))
    log("losses, first step: " + json.dumps(merged[0]))
    log("losses, last step:  " + json.dumps(merged[steps - 1]))
    log("validation, last:   " + json.dumps(
        {sub: {k: v for k, v in losses[sub][steps].items()
               if k.startswith("validation/")} for sub in ("GAN", "DNN")}))

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
    t0 = time.perf_counter()
    exp.validation_summaries(epoch=0, step=10 ** 6)
    sync(dev)
    t_val = time.perf_counter() - t0
    log(f"time ({what}): {1e3 * elapsed / TIMED_STEPS:.2f} ms/step, "
        f"{settings.batch_size * TIMED_STEPS / elapsed:.2f} images/s "
        f"(batch {settings.batch_size}, {TIMED_STEPS} steps, {dev}: "
        f"{card}), peak allocated {peak}; one validation pass "
        f"({settings.validation_dataset_size} images, D and DNN, "
        f"triptychs and G samples written) {1e3 * t_val:.1f} ms")
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
    entries = ([check_kernels(dev), check_rescale_kernel(dev)]
               + check_norm_kernels(dev))

    # 3. the gradient penalty's second order through the fused norm
    check_second_order(dev)

    # 4. small float32 evaluation and step against the CPU
    for factors in ((), RESCALE):
        for impl in ("xla", "pallas"):
            check_small_step(dev, impl, factors)

    # 5. the main paths through their entry point; 6. timed steps
    for impl, factors in (("xla", ()), ("pallas", ()), ("pallas", RESCALE)):
        settings = Settings(
            logs_directory=os.path.join(REPO, "logs", "chip_smoke"),
            steps_to_run=STEPS, summary_step_period=1,
            validation_step_period=VALIDATION_PERIOD, norm_impl=impl,
            crowd_rescale_factors=factors, **FLAGSHIP)
        launches = train_main_path(settings, dev, smi)
    # The kernel table counts the last run, this slice's path, which
    # launches every kernel.
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
