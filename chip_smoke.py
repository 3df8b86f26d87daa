#!/usr/bin/env python3
"""Drive the PyTorch port (``srgan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. build   — compile every CUDA kernel of the port from the sources in
             this checkout (``nvcc`` for sm_90a, one process per source,
             all started together; ``patches.cu`` holds both patch
             samplers) and, beside them, the host tier's library from
             the port's own ``srgan_tpu_torch/csrc/srgan_io.cc``
             (``g++``), timed;
2. kernels — the patch-sampler kernel against its plain PyTorch version
             at the flagship shapes, for uint8 images and float32 and
             bfloat16 density labels, one and two channels (the kNN/iKNN
             label tensor): labels exactly, images within 1e-6;
             the rescale sampler likewise at windows 168/224/280 (images
             within 1e-6, labels within 1e-5 of their largest value);
             both over a 1000-image source (the flagship's split), timed
             over 8 argument sets in turn so that the windows come from
             device memory, each call and a step's two image calls and
             one label call beside their bounds, and the image call once
             more on a 16-image source as the earlier runs timed it;
             then the fused GroupNorm + activation forward and backward
             kernels against their plain versions at every norm shape of
             the flagship step, of the age SR-GAN step (down to 16
             rows an example) and of JointDCNN's 512-channel stage (a
             backward that streams rows), in bfloat16 (tolerances at
             ``check_norm_kernels``), each shape's tiling and its
             clusters on the card at once printed, the times weighted by
             each shape's launches in each step; the norm's second-order
             kernel against its closed form at D's norms at the
             flagship's interpolates, bfloat16 (tolerances at
             ``check_second_order_kernel``), beside the composite it
             replaced; the density kernel
             against its plain version at 16 maps of 4096 slots, at the
             preprocessing path's one map (phase 7's most crowded image)
             and at one map of 12 865 heads (384×512, σ = 8; tolerance at
             ``_check_density``), each beside its bound; the
             copy probe in both launch layouts at both of the bandwidth
             tool's shapes, bit for bit; all timed with CUDA events (the
             copy kernel in phase 9), beside their bound and, where one
             exists, one PyTorch call that computes the same function;
3. second  — the gradient penalty's second order through the fused norm
             on the card, float32: the kernel path against autograd
             through the plain forward;
4. small   — at a tiny size on the card against the CPU, float32, for
             ``norm_impl`` "xla" and "pallas", with fixed and with
             rescaled patches: the grid evaluation's density maps and
             counts on the same weights, then one training step (same
             weights, patches and draws); and for the other apps one
             coefficient step, one age SR-GAN step under each norm path
             and one DNN-only step, each then ``predict`` on the
             validation split (``check_small_app_step``); and the crowd
             evaluation and step with iKNN targets (both norm paths),
             JointDCNN and the pyramid;
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
             (``NORM_LAUNCHES_PER_STEP``: 30 forward, 25 backward and 4
             second-order norm launches a step; ``LAUNCHES_PER_VALIDATION``);
6. time    — 20 more steps of each between ``torch.cuda.synchronize()``
             calls: ms/step, images/s and the peak of allocated device
             memory; 3 more under ``torch.profiler``: the card's busy
             share; and one validation pass;
7. preprocess — a raw UCF-QNRF-layout database synthesized from seed 0
             (16/16/16/2 JPEGs of 768×1024, up to 2000 heads each)
             through ``python -m srgan_tpu_torch.data.crowd``'s ``main``
             in resize mode at 384×512: one density-kernel launch per
             image, each map against the plain version and its count;
8. cli     — ``python -m srgan_tpu_torch``'s ``main`` on that database at
             the ``crowd_flagship`` preset under ``norm_impl`` "pallas":
             train 4 steps with checkpoints every 2, restore step 4 into a
             fresh experiment (bit for bit), resume to step 6, evaluate
             only and export the density maps;
9. bandwidth — the copy probe's tool, ``python -m
             srgan_tpu_torch.tools.norm_bandwidth_bench``'s ``main``: one
             JSON line per variant, each checked exact and timed; the
             kernel table takes the copy kernel's and ``copy_``'s times
             from it;
10. apps   — each through ``<App>Experiment(settings, device="cuda")
             .train()``, 8 steps with validation every 4 (``APP_FULL``,
             whose comment lists the cuts): the age SR-GAN at full width
             under "xla" and "pallas", the ``age_dnn`` preset and driving
             (frame stack 3) under "pallas", then the coefficient app at
             the ``coefficient_win`` preset for 200 steps (validation
             every 100): losses and validation scalars finite, the sample
             PNGs written, the norm launches asserted
             (``norm_launches_per_step``); then 20 timed steps of each:
             ms/step, examples/s and peak allocated memory, and 5 under
             ``torch.profiler``: the card's busy time a step;
11. app cli — a synthesized IMDB-WIKI layout (scipy's ``savemat``, PIL
             JPEGs) through ``python -m srgan_tpu_torch.data.age``'s
             ``main``, then ``python -m srgan_tpu_torch age`` on its npz
             at full width under "pallas": 4 steps with checkpoints,
             restored bit for bit, evaluate-only; and ``coefficient`` and
             ``driving`` for a few steps, each JSON line's metrics finite;
12. tiers  — the rest of the crowd app through ``CrowdExperiment(
             settings, device="cuda").train()`` at the flagship widths
             under "pallas", 8 steps with validation every 4
             (``CROWD_TIER_RUNS``): iKNN targets (one label call a step
             on two channels), JointDCNN, the pyramid, the window tier
             (32 of 64 images, 4 slices, a refresh every 2 steps, with
             rescale: its refreshes, rotation and buffers checked) and
             the host tier (no sampler launch a step), each run's
             launches asserted, then 20 timed steps of each (ms/step,
             images/s, peak allocated; the window's refreshes' host
             time); then phase 7's raw database preprocessed with
             ``--label-type iknn`` and the command line on it with iKNN
             targets, JointDCNN and a window: 4 steps with checkpoints,
             evaluate-only;
13. parallel — data parallelism through the launcher
             (``srgan_tpu_torch.parallel.launch.run_experiment``, one
             spawned process a rank, each ``train()`` on its device): (a)
             a world of 1 over NCCL at phase 5's "pallas" config, 8 steps
             with validation every 4, then 20 timed steps beside phase
             6's "pallas" step; (b) a world of 2 over gloo on this card
             (NCCL refuses two ranks on one device): ``DP_TINY`` in
             float32 on a sharded odd split, its ranks' models bit-equal,
             held to one rank fed the same global batches and draws, no
             cyclic-pad duplicate drawn; then ``DP_WINDOW`` at the
             flagship widths (batch 120, 60 a rank) with the database and
             a window sharded and rescale on, 4 steps. Every rank's
             launches asserted (3 sampler and 30/25/4 norm launches a
             step, a validation pass's as in phase 5), rank 0 alone
             writing;
             per rank the ms/step, the peak allocated memory and the
             gradient all-reduce's host ms a step;
14. dispatch — ``steps_per_dispatch`` (K steps a CUDA graph replay): (a)
             at a tiny float32 size (base width 16, batch 8), under
             "xla" and under "pallas" with the rescale sampler, 3 chunks
             of 4 (eager, capture and replay, replay) and one eager step
             held bit for bit to 13 single eager steps (metrics, models,
             Adam's state, the generator; tolerance 0), the two
             replays' z_d shown to differ; (b) the flagship "pallas"
             config through ``CrowdExperiment.train()`` at K = 2 and 4,
             with the window tier at K = 2 and on a world of 1 over NCCL
             at K = 2, 8 steps with validation every 4: losses finite
             at the chunks' first steps, validation finite, each
             kernel's launches K steps' a chunk, one capture and a
             replay a later chunk, the last chunk (a replay) traced and
             its kernels counted by name against the counters (exactly
             in the world of 1's fresh rank process: CUPTI drops records
             in a process after several profiler sessions); (c) K =
             1, 2 and 4 at the flagship and at a small config (batch 8,
             64-px patches, base width 16): ms/step, images/s, the
             host's ms a call, the card's busy share under the profiler,
             the peak allocated, the first chunk's and the capture's
             wall ms;
15. tensor — ``model_parallel_devices=2``: the fused norm kernels
             against their plain versions at every sharded norm shape of
             a grid rank's flagship step ([3B, HW, C/2] and [B, HW, C/2],
             16 groups, batch 8), then a grid of data 1 × model 2 over
             gloo on this card (``devices`` naming it twice), one launch:
             (c) a conv → norm of 3 groups (straddling the ranks) → conv
             layer against its unsharded self, forward and double
             backward, under "xla", "fast" and "pallas"; (a) ``TP_TINY`` in
             float32 under "xla", "pallas" and "xla" with the gradient
             clipped (``TP_CLIP``, which every model's gradient
             exceeds), 4 steps, the ranks' full models bit-equal and held
             after every step to one rank fed the same batches and draws
             (metrics rtol 5e-4, atol 5e-5; models 2.1·lr a step;
             Adam's moments after the first step rtol 5e-4, atol
             5e-5); (b) the flagship widths under
             "pallas" at batch 8 (cut from 120 so that gloo's
             host-staged collectives fit the time), 4 steps and a
             validation pass through ``train()``, a rank's launches (3
             sampler, 30/25/4 norm a step) and the shapes its norm
             kernels ran at asserted; per rank the ms/step, the peak allocated
             memory and the host ms of the model-axis collectives a step;
16. tools  — the port's tools (``srgan_tpu_torch/tools/``): (a) the four
             golden traces' configurations recorded on the CPU and
             compared on the card at ``golden_trace.TOLERANCES`` (same
             init, batches and draws); (b) a sweep of 2 combos × 2 seeds
             × 50 steps through the shipped step with ``hyper``, ms per
             lane-step; (c) the window bench at the flagship widths
             ("pallas") on a 2 GB memmap database with a window of 256
             in 4 slices refreshed every 2 steps, 20 timed steps: its
             refreshes, rotation and buffers checked as phase 12 checks
             them, 3 sampler and 30/25/4 norm launches a step asserted;
             (d) the command-line rehearsal (preprocessing and training
             command lines as subprocesses) at 4 images of 3000×4000, a
             window of 64 and 4 steps, its metrics finite; (e) the
             UCF-QNRF rehearsal at 2 images of 6000×4000 and 12 865
             heads with NaN, inf and out-of-frame points, every head's
             mass kept (``mass_conserved``);
17. fast   — ``norm_impl="fast"`` (``FastGroupNorm``, composite torch
             ops with the statistics in the compute dtype; no kernel of
             its own): (a) phase 4's tiny float32 evaluation and step on
             the card against the CPU, and the module in bfloat16 at two
             shapes against the CPU (``check_fast_norm_module``); (b) the
             flagship through ``CrowdExperiment.train()`` as in phases 5
             and 6 (3 sampler launches a step and no norm kernel
             asserted), its ms/step, busy share and peak printed beside
             phase 6's "xla" and "pallas"; (c) the age SR-GAN at full
             width (``APP_FULL``) through ``train()`` as in phase 10; (d)
             phase 14 (a)'s chunk replays bit-equal to eager steps.

Prints the kernel table as one JSON line (each kernel's launches counted
on the path that runs it: the training kernels in the rescale run of
phase 5, the density kernel in phase 7, the copy kernel in phase 9;
phases 4, 10, 11, 12, 13, 14, 15, 16 and 17 count the launches of each
run they drive and assert them),
then the card's name and power limit as nvidia-smi gives them, and last
``{"ok": true, "device": ...}``.
Exits nonzero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

import concurrent.futures
import functools
import gc
import itertools
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

from srgan_tpu_torch.utils import trace  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 8
TIMED_STEPS = 20
PROFILED_STEPS = 5
FLAGSHIP_PROFILED = 3
VALIDATION_PERIOD = 4
RESCALE = (0.75, 1.0, 1.25)
# The samplers' check reads from bench.py's flagship split of 1000 images
# (384×512×3 uint8: 590 MB), so that its windows come from device memory;
# the timing takes ARG_SETS argument sets in turn (8 × 18 MB of windows,
# more than the 50 MB L2), TIMED_CALLS calls of each. The earlier times were
# taken on L2_IMAGES images, which the L2 holds.
SOURCE_IMAGES = 1000
ARG_SETS = 8
TIMED_CALLS = 24
L2_IMAGES = 16
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
    seed=0, compute_dtype="bfloat16",
    # One card: the default, every visible card, spawns a rank on each,
    # and the launch counts of this process would read 0.
    data_parallel_devices=1)
# Every GroupNorm of the flagship step as (B, H·W, C, slope, forward
# launches, backward launches), 32 groups each: D over the 3B batch, D and
# the DNN over B (the D stages are 112²×64, 56²×128 and twice 56²×256,
# slope 0.2), and G over B (7²×1024 up to 112²×64, ReLU). The launches
# per step follow the counts below: at B = 360 the forward and backward
# of D(3B); at B = 120 the forwards of D(interpolates), D(unlabeled),
# D(fake) and the DNN and the backwards through D(interpolates) twice,
# D(fake) and the DNN; G's forward twice and backward once.
NORM_SHAPES = [(360, 112 * 112, 64, 0.2, 1, 1), (360, 56 * 56, 128, 0.2, 1, 1),
               (360, 56 * 56, 256, 0.2, 2, 2), (120, 112 * 112, 64, 0.2, 4, 4),
               (120, 56 * 56, 128, 0.2, 4, 4), (120, 56 * 56, 256, 0.2, 8, 8),
               (120, 7 * 7, 1024, 0.0, 2, 1), (120, 14 * 14, 512, 0.0, 2, 1),
               (120, 28 * 28, 256, 0.0, 2, 1), (120, 56 * 56, 128, 0.0, 2, 1),
               (120, 112 * 112, 64, 0.0, 2, 1)]
# D's norms at the interpolates, whose backward the gradient penalty
# differentiates once more (the second-order kernel), as (B, H·W, C,
# launches a step).
SECOND_ORDER_SHAPES = [(120, 112 * 112, 64, 1), (120, 56 * 56, 128, 1),
                       (120, 56 * 56, 256, 2)]
NORM_LAUNCHES_PER_STEP = {"fwd": 30, "bwd": 25, "second_order": 4}
if dict({kind: sum(shape[4 + i] for shape in NORM_SHAPES)
         for i, kind in enumerate(("fwd", "bwd"))},
        second_order=sum(shape[3] for shape in SECOND_ORDER_SHAPES)
        ) != NORM_LAUNCHES_PER_STEP:
    raise AssertionError("NORM_SHAPES' and SECOND_ORDER_SHAPES' launches do "
                         "not sum to NORM_LAUNCHES_PER_STEP")
# Every GroupNorm of the age (and driving) SR-GAN step at full width
# (64-px images, batch 32, base width 64; the D stages 32²×64, 16²×128,
# 8²×256 and 4²×512, slope 0.2; G 4²×512 up to 32²×64, ReLU), in
# NORM_SHAPES' form. The launches follow the flagship's accounting with 4
# norms in each of D, G and the DNN: D(3B) once each way; D at B forward
# for the interpolates, D(unlabeled), D(fake) and the DNN, backward
# through D(interpolates) twice, D(fake) and the DNN; G twice forward and
# once backward.
AGE_NORM_SHAPES = (
    [(96, hw, c, 0.2, 1, 1) for hw, c in ((1024, 64), (256, 128), (64, 256),
                                         (16, 512))]
    + [(32, hw, c, 0.2, 4, 4) for hw, c in ((1024, 64), (256, 128),
                                            (64, 256), (16, 512))]
    + [(32, hw, c, 0.0, 2, 1) for hw, c in ((16, 512), (64, 256), (256, 128),
                                            (1024, 64))])


def norm_launches_per_step(norms: int, dnn_only: bool = False):
    """(forward, backward, second-order) fused-norm launches of one step
    of a model set with ``norms`` norms in each of D, G and the DNN: the
    SR-GAN step runs 7 model forwards and 6 model backwards (above), and
    the penalty differentiates D's backward at the interpolates once
    more; the DNN-only step one forward and one backward through the
    DNN."""
    return (norms, norms, 0) if dnn_only else (7 * norms, 6 * norms, norms)


if tuple(sum(shape[4 + i] for shape in AGE_NORM_SHAPES)
         for i in range(2)) != norm_launches_per_step(4)[:2]:
    raise AssertionError("AGE_NORM_SHAPES' launches do not sum to 28 and 24")
# JointDCNN's 512-channel last stage (56²×512, slope 0.2) in the flagship
# step, in NORM_SHAPES' form: once each way over the 3B batch, 4 times
# each way over B (as every D and DNN stage). Its backward tiling holds 99
# of each block's 196 rows and streams the rest.
DCNN_NORM_SHAPES = [(360, 56 * 56, 512, 0.2, 1, 1),
                    (120, 56 * 56, 512, 0.2, 4, 4)]

# Kernel launches in one validation pass at the flagship (crowd.py
# validation_summaries): G's sample grid of 4 (5 norms); per model, D and
# then the DNN, the maps of 16 validation images in chunks of 8
# (EVAL_CHUNK_IMAGES), each chunk one patch-kernel call for its 8·12 grid
# patches (384×512 images, 224-px patches, stride 112: 3 rows × 4 columns)
# and one forward (4 norms):
#   extract_patches: 2 models × 2 chunks = 4;
#   norm forward:    G 5 + 2 models × 2 chunks × 4 = 21; backward and
#   second order 0.
LAUNCHES_PER_VALIDATION = {"extract_patches": 4, "group_norm_act_fwd": 21,
                           "group_norm_act_bwd": 0,
                           "group_norm_act_second_order": 0,
                           "extract_rescaled_patches": 0}


def crowd_norm_launches(d_norms: int, g_norms: int = 5):
    """(forward, backward, second-order) fused-norm launches of one crowd
    SR-GAN step whose D and DNN have ``d_norms`` norms and G ``g_norms``:
    D runs 4 forwards (3B, interpolates, unlabeled, fake) and 4 backwards
    (3B, interpolates twice, fake), the DNN one of each, G 2 forwards and
    one backward; the penalty's outer gradient differentiates D's first
    backward at the interpolates once more."""
    return 5 * d_norms + 2 * g_norms, 5 * d_norms + g_norms, d_norms


def crowd_launches_per_validation(d_norms: int):
    """Kernel launches of one flagship validation pass
    (``LAUNCHES_PER_VALIDATION``) for D and DNN models of ``d_norms``
    norms."""
    return dict(LAUNCHES_PER_VALIDATION,
                group_norm_act_fwd=5 + 2 * 2 * d_norms)


if (crowd_norm_launches(4) != tuple(NORM_LAUNCHES_PER_STEP.values())
        or crowd_launches_per_validation(4) != LAUNCHES_PER_VALIDATION):
    raise AssertionError("crowd_norm_launches(4) or "
                         "crowd_launches_per_validation(4) is not the "
                         "flagship's")
# The program's launch counters (``srgan_tpu_torch/utils/trace.py``) by
# the names this script reports them under; the samplers and the norm
# are the kernels of a training step.
LAUNCH_COUNTERS = {
    "extract_patches": "extract_patches.launches",
    "extract_rescaled_patches": "extract_rescaled_patches.launches",
    "group_norm_act_fwd": "fused_norm._launch_fwd.launches",
    "group_norm_act_bwd": "fused_norm._launch_bwd.launches",
    "group_norm_act_second_order": "fused_norm._launch_second_order.launches",
    "density_maps": "density_maps.launches"}
STEP_KERNELS = tuple(LAUNCH_COUNTERS)[:5]
NORM_KERNELS = STEP_KERNELS[2:]


def counted_since(before: dict, names=STEP_KERNELS) -> dict:
    """Each of ``names`` (a key of ``LAUNCH_COUNTERS`` or a counter's own
    name) counted since ``before``, a snapshot of ``trace.counters()``
    (a counter declared since counts from 0)."""
    now = trace.counters()
    return {k: now[LAUNCH_COUNTERS.get(k, k)]
            - before.get(LAUNCH_COUNTERS.get(k, k), 0) for k in names}


# The raw database of the preprocessing phase: images per split, and the
# raw image size (UCF-QNRF's images are photographs of about this size and
# larger; resize mode halves these).
RAW_SPLITS = {"labeled": 16, "unlabeled": 16, "validation": 16, "test": 2}
RAW_H, RAW_W = 768, 1024
TINY = dict(batch_size=4, image_patch_size=32, model_base_width=8,
            latent_dimension=16, labeled_dataset_size=6,
            unlabeled_dataset_size=6, validation_dataset_size=1,
            test_dataset_size=1, crowd_image_height=80, crowd_image_width=96,
            crowd_synthetic_max_heads=12, seed=1, zero_init_heads=False,
            data_parallel_devices=1)
APP_TINY = dict(batch_size=4, age_image_size=32, model_base_width=8,
                latent_dimension=16, hidden_size=8, labeled_dataset_size=6,
                unlabeled_dataset_size=8, validation_dataset_size=5,
                test_dataset_size=3, seed=1, mean_offset=0.5,
                data_parallel_devices=1)
# The age and driving apps at full width: 64-px images (the
# age_image_size and preprocess_imdb_wiki default), base width 64 and a
# 100-d latent (the DCGAN defaults), batch 32 (the Settings default),
# bfloat16 compute. Cut: the synthetic splits to 50 labeled, 1000
# unlabeled and 100 validation/test examples (the defaults' 50 000
# unlabeled would spend the time limit generating them on the host).
APP_FULL = dict(trial_name="chip_smoke_app", batch_size=32,
                age_image_size=64, model_base_width=64, latent_dimension=100,
                compute_dtype="bfloat16", labeled_dataset_size=50,
                unlabeled_dataset_size=1000, validation_dataset_size=100,
                test_dataset_size=100, seed=0, summary_step_period=1,
                steps_to_run=STEPS, validation_step_period=VALIDATION_PERIOD,
                data_parallel_devices=1)
# The image apps' model on the command line: full width, "pallas".
APP_CLI_MODEL = dict(norm_impl="pallas", compute_dtype="bfloat16",
                     model_base_width=64, latent_dimension=100)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int, queued: bool = False) -> float:
    """``srgan_tpu_torch.utils.timing.cuda_ms``, imported at the first
    call: the port is imported only after ``main``'s checks. ``queued``
    for a call that takes the host about as long as the card (a sampler
    call)."""
    from srgan_tpu_torch.utils.timing import cuda_ms as timed
    return timed(fn, iters, queued)


def least_ms(bytes_moved: float, ops: float):
    """(least ms on the card, what bounds it) for a call that must move
    ``bytes_moved`` and do ``ops`` float32 operations."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paired_ms(plain, kernel, iters: int, plain_iters: int = 0,
              queued: bool = False):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain, so that
    both see the same warm-up; the plain version over ``plain_iters``
    calls where given (a slow one), else ``iters``; ``queued`` as in
    ``cuda_ms``."""
    plain_iters = plain_iters or iters
    t_plain = cuda_ms(plain, plain_iters, queued)
    t_kernel = cuda_ms(kernel, iters, queued) + cuda_ms(kernel, iters, queued)
    t_plain += cuda_ms(plain, plain_iters, queued)
    return t_kernel / 2, t_plain / 2


def cycling(calls):
    """One callable that makes the next of ``calls`` each time it is
    called, round and round."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def sampler_step(name, times, bounds):
    """Log and return a sampler's (ms, bound ms) per training step: two
    image calls (uint8, C = 3) and one label call (float32, C = 1)."""
    step_ms = 2 * times["images uint8"][0] + times["labels float32"][0]
    step_bound = 2 * bounds["images uint8"] + bounds["labels float32"]
    log(f"kernel {name}, a step's two image calls and one label call: "
        f"{step_ms:.4f} ms, bound {step_bound:.4f} ms, "
        f"{100 * step_bound / step_ms:.1f}% of the bound")
    return {"step_ms": step_ms, "step_bound_ms": step_bound}


def l2_source_ms(name, fn, src, indices, **call):
    """Log the kernel's time on the first ``L2_IMAGES`` images of ``src``
    with one argument set, the condition of the earlier sampler times: the
    L2 holds that source."""
    small = src[:L2_IMAGES]
    idx = (indices % L2_IMAGES).to(torch.int32)
    t = cuda_ms(lambda: fn(small, **call, indices=idx), TIMED_CALLS,
                queued=True)
    log(f"kernel {name} on a {L2_IMAGES}-image source, one argument set "
        f"(the L2 holds it; the earlier sampler times' condition): "
        f"{t:.4f} ms")


def check_kernels(dev):
    """Phase 2: the patch kernel against the plain version at the
    flagship shapes, over a ``SOURCE_IMAGES``-image source, timed over
    ``ARG_SETS`` argument sets in turn so that the windows come from
    device memory. Returns the kernel table entry (the image call's
    times, and a step's; launches filled in by the training phase)."""
    from srgan_tpu_torch.ops.patches import (extract_patches,
                                             extract_patches_plain)
    n, h, w, b, p = SOURCE_IMAGES, 384, 512, FLAGSHIP["batch_size"], 224
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    draws = []
    for _ in range(ARG_SETS):
        draw = (rng.integers(0, n, b),
                np.stack([rng.integers(0, h - p + 1, b),
                          rng.integers(0, w - p + 1, b)], -1),
                rng.integers(0, 2, b))
        draws.append([torch.from_numpy(a.astype(np.int32)).to(dev)
                      for a in draw])
    images = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    labels = torch.rand((n, h, w, 1), generator=gen, device=dev) * 1e-2
    # The kNN/iKNN label tensor: (density, aux) channels.
    aux_labels = torch.rand((n, h, w, 2), generator=gen, device=dev) * 1e-2
    cases = [("images uint8", images, 2.0 / 255.0, -1.0, 1e-6),
             ("labels float32", labels, 1.0, 0.0, 0.0),
             ("labels bfloat16", labels.to(torch.bfloat16), 1.0, 0.0, 0.0),
             ("labels float32 C=2", aux_labels, 1.0, 0.0, 0.0),
             ("labels bfloat16 C=2", aux_labels.to(torch.bfloat16), 1.0, 0.0,
              0.0)]
    worst = 0.0
    times, bounds = {}, {}
    for name, src, scale, shift, tol in cases:
        call = dict(patch_size=p, scale=scale, shift=shift)
        indices, offsets, flips = draws[0]
        got = extract_patches(src, offsets, flips, indices=indices, **call)
        torch.cuda.synchronize()
        want = extract_patches_plain(src, offsets, flips, indices=indices,
                                     **call)
        if (got.shape != (b, p, p, src.shape[-1]) or not got.is_cuda
                or got.dtype != torch.float32):
            raise AssertionError(f"patch kernel returned {got.dtype} "
                                 f"{list(got.shape)} on {got.device}")
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"patch kernel disagrees on {name}: "
                                 f"max |err| {err} > {tol}")
        worst = max(worst, err)
        del got, want
        t_kernel, t_plain = paired_ms(
            cycling([functools.partial(extract_patches_plain, src, o, f,
                                       indices=i, **call)
                     for i, o, f in draws]),
            cycling([functools.partial(extract_patches, src, o, f,
                                       indices=i, **call)
                     for i, o, f in draws]), TIMED_CALLS, queued=True)
        # Windows in, float32 patches out, 4 int32 per example; one
        # multiply and one add per element.
        elems = b * p * p * src.shape[-1]
        bytes_moved = elems * (src.element_size() + 4) + b * 16
        bounds[name] = least_ms(bytes_moved, 2 * elems)[0]
        log(f"kernel extract_patches [{name}] {list(src.shape)} -> "
            f"[{b}, {p}, {p}, {src.shape[-1]}], {ARG_SETS} argument sets "
            f"in turn: max|err| {err:g}, kernel {t_kernel:.4f} ms "
            f"({bytes_moved / t_kernel / 1e6:.1f} GB/s), plain "
            f"{t_plain:.4f} ms, bound {bounds[name]:.4f} ms, "
            f"{100 * bounds[name] / t_kernel:.1f}% of the bound")
        l2_source_ms(f"extract_patches [{name}]", extract_patches, src,
                     indices, offsets=offsets, flips=flips, **call)
        times[name] = (t_kernel, t_plain)
    del images, labels, aux_labels, cases, src
    torch.cuda.empty_cache()
    t_kernel, t_plain = times["images uint8"]
    bound_ms, bound_by = least_ms(
        b * p * p * 3 * (1 + 4) + b * 16, 2 * b * p * p * 3)
    # No single PyTorch call gathers, crops, flips and normalizes.
    # A kNN/iKNN step's label call takes both channels.
    aux_step = (2 * times["images uint8"][0]
                + times["labels float32 C=2"][0])
    log(f"kernel extract_patches, a kNN/iKNN step's two image calls and "
        f"one two-channel label call: {aux_step:.4f} ms")
    return {"name": "extract_patches", "route": "cuda",
            "source": "srgan_tpu_torch/csrc/patches.cu",
            "replaces": "srgan_tpu/ops/patches.py:49",
            "launches": None, "max_abs_err": worst, "ms": t_kernel,
            "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "aux_step_ms": aux_step,
            "aux_labels_ms": times["labels float32 C=2"][0],
            "aux_labels_bound_ms": bounds["labels float32 C=2"],
            **sampler_step("extract_patches", times, bounds)}


def check_rescale_kernel(dev):
    """Phase 2: the rescale kernel against its plain version at the
    flagship shapes: 120 examples over a ``SOURCE_IMAGES``-image
    384×512 source, windows (168, 224, 280) each used by a third of the
    batch, flips both ways, offsets at both bounds; timed over
    ``ARG_SETS`` argument sets in turn, as ``check_kernels``. Tolerances:
    images max |err| ≤ 1e-6, labels ≤ 1e-5 of their largest value; the two
    compute the same float32 terms in different sum orders. Returns the
    kernel table entry (the image call's times, and a step's;
    ``max_abs_err`` the images' absolute error and the labels' error
    relative to their largest value, whichever is larger)."""
    from srgan_tpu_torch.ops.patches import (_tap_table,
                                             extract_rescaled_patches,
                                             extract_rescaled_patches_plain)
    n, h, w, b, p = SOURCE_IMAGES, 384, 512, FLAGSHIP["batch_size"], 224
    windows = tuple(int(round(p * f)) for f in RESCALE)
    rng = np.random.default_rng(1)
    draws = []
    for k in range(ARG_SETS):
        sidx = rng.permutation(np.arange(b) % len(windows)).astype(np.int32)
        win = np.asarray(windows)[sidx]
        offsets = np.stack([rng.integers(0, h - win + 1),
                            rng.integers(0, w - win + 1)], -1)
        if k == 0:
            offsets[:3] = 0
            offsets[3:6] = np.stack([h - win[3:6], w - win[3:6]], -1)
        flips = (np.arange(b) % 2) if k == 0 else rng.integers(0, 2, b)
        indices = rng.integers(0, n, b)
        draws.append([torch.from_numpy(a.astype(np.int32)).to(dev)
                      for a in (indices, offsets, flips, sidx)])
    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    labels = torch.rand((n, h, w, 1), generator=gen, device=dev) * 1e-2
    cases = [("images uint8", images, 2.0 / 255.0, -1.0, False),
             ("labels float32", labels, 1.0, 0.0, True),
             ("labels bfloat16", labels.to(torch.bfloat16), 1.0, 0.0, True)]
    taps = _tap_table(windows, p)[2]
    # Every argument set uses each window for a third of the batch, so
    # every set has the same bound.
    win = np.asarray(windows)[draws[0][3].cpu().numpy()]
    worst = 0.0
    entry = None
    times, bounds = {}, {}
    for name, src, scale, shift, mass in cases:
        c = src.shape[-1]
        call = dict(patch_size=p, window_sizes=windows, scale=scale,
                    shift=shift, preserve_mass=mass)
        indices, offsets, flips, sidx = draws[0]
        args = (src, offsets, flips, sidx)
        got = extract_rescaled_patches(*args, indices=indices, **call)
        torch.cuda.synchronize()
        want = extract_rescaled_patches_plain(*args, indices=indices, **call)
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
        del got, want
        t_kernel, t_plain = paired_ms(
            cycling([functools.partial(extract_rescaled_patches_plain, src,
                                       o, f, s, indices=i, **call)
                     for i, o, f, s in draws]),
            cycling([functools.partial(extract_rescaled_patches, src, o, f,
                                       s, indices=i, **call)
                     for i, o, f, s in draws]), TIMED_CALLS, queued=True)
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
        bounds[name] = bound_ms
        log(f"kernel extract_rescaled_patches [{name}] {list(src.shape)} -> "
            f"[{b}, {p}, {p}, {c}], windows {windows}, {taps} taps, "
            f"{ARG_SETS} argument sets in turn: max|err| {err:g} "
            f"(tolerance {tol:g}), kernel {t_kernel:.4f} ms "
            f"({bytes_moved / t_kernel / 1e6:.1f} GB/s), plain "
            f"{t_plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / t_kernel:.1f}% of the bound")
        l2_source_ms(f"extract_rescaled_patches [{name}]",
                     extract_rescaled_patches, src, indices,
                     offsets=offsets, flips=flips, scale_idx=sidx, **call)
        times[name] = (t_kernel, t_plain)
        if entry is None:  # the table holds the image call
            entry = {"name": "extract_rescaled_patches", "route": "cuda",
                     "source": "srgan_tpu_torch/csrc/patches.cu",
                     "replaces": "srgan_tpu/ops/patches.py:49",
                     "launches": None, "ms": t_kernel, "plain_ms": t_plain,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     # No single PyTorch call gathers, crops, resizes with
                     # JAX's weights and flips.
                     "library_ms": None}
    del images, labels, cases, src
    torch.cuda.empty_cache()
    entry["max_abs_err"] = worst
    entry.update(sampler_step("extract_rescaled_patches", times, bounds))
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


def _check_norm_shape(dev, gen, b, hw, c, slope, per_step, library=False,
                      queued=False, groups=32):
    """The fused norm's forward and backward kernels against their plain
    versions at x [b, hw, c] bfloat16 with ``groups`` groups (tolerances at
    ``check_norm_kernels``), each timed beside the plain version and its
    bound (``queued`` as in ``cuda_ms``), its tiling logged with
    ``per_step`` (forward, backward) launches and, ``queued``, the
    host's time to enqueue one wrapper call. Returns {"err", "ms",
    "bound"} by kind, and with ``library`` the library call's ms."""
    from srgan_tpu_torch.ops import fused_norm as fn

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = (randn(b, hw, c) + 0.5).to(torch.bfloat16)
    dy = randn(b, hw, c).to(torch.bfloat16)
    scale = 1.0 + 0.1 * randn(c)
    bias = 0.1 * randn(c)
    fwd_args = (x, scale, bias, groups, slope, 1e-6)
    y, mean, rstd = fn._launch_fwd(*fwd_args)
    torch.cuda.synchronize()
    want_y, want_mean, want_rstd = fn.group_norm_act_fwd_plain(*fwd_args)
    if y.dtype != torch.bfloat16 or y.shape != x.shape:
        raise AssertionError(f"forward kernel returned {y.dtype} "
                             f"{list(y.shape)}")
    shape = f"[{b}, {hw}, {c}] bf16 slope {slope}" + (
        f", {groups} groups" if groups != 32 else "")
    err = {"fwd": _assert_within(
        f"y {shape}", y, want_y, 2 ** -7 * want_y.float().abs()
        + 1e-5 * float(want_y.float().abs().max()))}
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
    bwd_args = (x, scale, bias, mean, rstd, dy, groups, slope)
    dx, dscale, dbias = fn._launch_bwd(*bwd_args)
    torch.cuda.synchronize()
    want_dx, want_dscale, want_dbias = fn.group_norm_act_bwd_plain(
        *bwd_args)
    err["bwd"] = _assert_within(
        f"dx {shape}", dx, want_dx, 2 ** -7 * want_dx.float().abs()
        + 1e-5 * float(want_dx.float().abs().max()))
    for name, got, want in (("dscale", dscale, want_dscale),
                            ("dbias", dbias, want_dbias)):
        _assert_within(f"{name} {shape}", got, want,
                       1e-4 * float(want.abs().max()))
    del y, want_y, dx, want_dx
    pairs = {"fwd": (lambda: fn.group_norm_act_fwd_plain(*fwd_args),
                     lambda: fn._launch_fwd(*fwd_args)),
             "bwd": (lambda: fn.group_norm_act_bwd_plain(*bwd_args),
                     lambda: fn._launch_bwd(*bwd_args))}
    # Least bytes: x (and dy) read once, y (dx) written once, the float32
    # per-channel and per-group vectors; operations about 8 (forward) and
    # 15 (backward) per element.
    vectors = 4 * (2 * c + 2 * b * groups)
    xb = x.numel() * x.element_size()
    ops = {"fwd": 8 * x.numel(), "bwd": 15 * x.numel()}
    out = {"err": err, "ms": {}, "traffic_bound": {},
           "bound": {"fwd": least_ms(2 * xb + vectors, ops["fwd"]),
                     "bwd": least_ms(3 * xb + vectors + 8 * c,
                                     ops["bwd"])}}
    for (kind, (plain, kernel)), launches in zip(pairs.items(), per_step):
        t_kernel, t_plain = paired_ms(plain, kernel, 10, queued=queued)
        host = ""
        if queued:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIMED_CALLS):
                kernel()
            host_us = 1e6 * (time.perf_counter() - t0) / TIMED_CALLS
            host = f", host {host_us:.1f} µs a call"
            torch.cuda.synchronize()
        tiling = fn.norm_tiling(b, hw, c, x.dtype, kind)
        # The bytes the launch moved: one pass, plus any streamed rows read
        # again.
        moved = fn.norm_traffic_bytes(b, hw, c, x.dtype, kind, tiling)
        # The bound with the streamed rows' second read added (the same
        # as the bound where every row is resident).
        out["traffic_bound"][kind] = least_ms(
            moved + vectors + (8 * c if kind == "bwd" else 0), ops[kind])
        log(f"kernel group_norm_act {kind} {shape}: max|err| "
            f"{err[kind]:g}, kernel {t_kernel:.4f} ms "
            f"({moved / t_kernel / 1e6:.1f} GB/s of {moved / xb:g} units "
            f"moved{', queued' if queued else ''}{host}), plain "
            f"{t_plain:.4f} ms, bound "
            f"{out['bound'][kind][0]:.4f} ms (with the streamed rows "
            f"read again {out['traffic_bound'][kind][0]:.4f} ms); tiling "
            f"cluster "
            f"{tiling.cluster}, {tiling.rows_per_block} rows a block, "
            f"{tiling.resident_rows} resident, {tiling.smem_bytes} B shared "
            f"memory, max active clusters "
            f"{fn.max_active_clusters(x.dtype, kind, tiling)}; {launches} "
            f"launches a step")
        out["ms"][kind] = (t_kernel, t_plain)
    if library:
        out["library"] = library_norm_ms(x, scale, bias, dy)
    del x, dy, fwd_args, bwd_args, pairs
    torch.cuda.empty_cache()
    return out


def _weighted_norm_step(dev, gen, shapes, what, worst, queued=False,
                        groups=32):
    """Check and time every shape of ``shapes`` (``NORM_SHAPES``' form)
    and return {kind: {"ms", "bound_ms"}}, each shape's kernel time and
    bound weighted by its launches a step; ``worst`` (by kind) takes the
    largest error. The first shape's full results come back too."""
    step = {kind: {"ms": 0.0, "bound_ms": 0.0, "traffic_bound_ms": 0.0}
            for kind in ("fwd", "bwd")}
    first = None
    for b, hw, c, slope, *per_step in shapes:
        got = _check_norm_shape(dev, gen, b, hw, c, slope, per_step,
                                library=first is None, queued=queued,
                                groups=groups)
        first = first or got
        for kind, launches in zip(("fwd", "bwd"), per_step):
            worst[kind] = max(worst[kind], got["err"][kind])
            step[kind]["ms"] += launches * got["ms"][kind][0]
            step[kind]["bound_ms"] += launches * got["bound"][kind][0]
            step[kind]["traffic_bound_ms"] += (
                launches * got["traffic_bound"][kind][0])
    for kind, t in step.items():
        count = sum(shape[4 + (kind == "bwd")] for shape in shapes)
        log(f"kernel group_norm_act {kind}, {what}'s {count} launches: "
            f"{t['ms']:.4f} ms a step, bound {t['bound_ms']:.4f} ms, "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound (with the "
            f"streamed rows read again {t['traffic_bound_ms']:.4f} ms)")
    return step, first


def check_norm_kernels(dev):
    """Phase 2, fused norm: the forward and backward kernels against their
    plain versions at every norm shape of the flagship step
    (``NORM_SHAPES``) and of the age SR-GAN step (``AGE_NORM_SHAPES``),
    bfloat16, then the second-order kernel (``check_second_order_kernel``).
    Returns the three kernel table entries (launches filled in by the
    training phase); the first two's ``ms`` are at the flagship's first,
    largest shape; ``step_ms`` / ``step_bound_ms`` and ``age_step_ms`` /
    ``age_step_bound_ms`` are the launch-weighted sums over each step's
    shapes of the kernel's time and of its bound. The age shapes are
    timed queued (``cuda_ms``): their calls are shorter on the card than
    on the host.

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
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"fwd": 0.0, "bwd": 0.0}
    step, first = _weighted_norm_step(dev, gen, NORM_SHAPES,
                                      "the flagship step", worst)
    b, hw, c = NORM_SHAPES[0][:3]
    log(f"library [{b}, {hw}, {c}] bf16, F.group_norm (no activation) on "
        f"an NCHW copy: forward {first['library']['fwd']:.4f} ms, autograd "
        f"backward {first['library']['bwd']:.4f} ms; bounds "
        + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                    for k, v in first["bound"].items()))
    # The age shapes' calls take the host longer than the card: queued.
    age, _ = _weighted_norm_step(dev, gen, AGE_NORM_SHAPES,
                                 "the age SR-GAN step", worst, queued=True)
    # JointDCNN's last stage, whose backward streams rows.
    dcnn, _ = _weighted_norm_step(dev, gen, DCNN_NORM_SHAPES,
                                  "JointDCNN's 512-channel stage", worst)
    log("kernel group_norm_act: mean/rstd within rtol 1e-5, dscale/dbias "
        "within 1e-4 of their largest, at every shape")
    return [*({"name": f"group_norm_act_{kind}", "route": "cuda",
             "source": "srgan_tpu_torch/csrc/fused_norm.cu",
             "replaces": f"srgan_tpu/ops/fused_norm.py:{line}",
             "launches": None, "max_abs_err": worst[kind],
             "ms": first["ms"][kind][0], "plain_ms": first["ms"][kind][1],
             "bound_ms": first["bound"][kind][0],
             "bound_by": first["bound"][kind][1],
             "library_ms": first["library"][kind],
             "step_ms": step[kind]["ms"],
             "step_bound_ms": step[kind]["bound_ms"],
             "age_step_ms": age[kind]["ms"],
             "age_step_bound_ms": age[kind]["bound_ms"],
             "dcnn_stage_ms": dcnn[kind]["ms"],
             "dcnn_stage_bound_ms": dcnn[kind]["bound_ms"],
             "dcnn_stage_traffic_bound_ms": dcnn[kind]["traffic_bound_ms"]}
            for kind, line in (("fwd", 178), ("bwd", 226))),
            check_second_order_kernel(dev, gen)]


def _composite_second_order(x, scale, bias, dy, cotangents, groups, slope,
                            eps=1e-6):
    """``torch.func.vjp`` of the plain backward map, mean and rstd
    recomputed from x: the composite float32 second order that the
    second-order kernel replaced on the card."""
    from srgan_tpu_torch.ops import fused_norm as fn

    def whole(x, scale, bias, dy):
        mean, rstd = fn._group_stats(x, groups, eps)
        return fn.group_norm_act_bwd_plain(x, scale, bias, mean, rstd, dy,
                                           groups, slope)

    _, vjp = torch.func.vjp(whole, x, scale, bias, dy)
    return vjp(cotangents)


def check_second_order_kernel(dev, gen):
    """Phase 2, the fused norm's second order: the kernel
    (``_launch_second_order``) against its closed form
    (``group_norm_act_bwd_vjp_plain``) at D's norms at the flagship's
    interpolates (``SECOND_ORDER_SHAPES``), bfloat16, 32 groups, slope
    0.2, mean and rstd the forward kernel's, every cotangent drawn
    nonzero. Each shape timed beside the closed form and its bound (x, dy
    and g_dx read once, g_x and g_dy written once: 10 B an element), and
    the first, largest, beside the composite it replaced
    (``_composite_second_order``). Returns the kernel table entry
    (launches filled in by the training phase; ``step_ms`` /
    ``step_bound_ms`` the launch-weighted sums over the shapes).

    Tolerances, the card test's (``tests/test_torch_port_cuda.py``
    ``_second_order_within``): g_x and g_dy within one bfloat16 ulp of
    each element plus 1e-5 of the tensor's largest magnitude, g_scale
    within 1e-5 of its largest, g_bias exactly 0."""
    from srgan_tpu_torch.ops import fused_norm as fn
    groups, slope = 32, 0.2
    worst = 0.0
    step = {"ms": 0.0, "bound_ms": 0.0, "traffic_bound_ms": 0.0}
    first = None
    for b, hw, c, per_step in SECOND_ORDER_SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = (randn(b, hw, c) + 0.5).to(torch.bfloat16)
        dy = randn(b, hw, c).to(torch.bfloat16)
        g_dx = randn(b, hw, c).to(torch.bfloat16)
        scale = 1.0 + 0.1 * randn(c)
        bias = 0.1 * randn(c)
        g_dscale, g_dbias = randn(c), randn(c)
        _, mean, rstd = fn._launch_fwd(x, scale, bias, groups, slope, 1e-6)
        args = (x, scale, bias, mean, rstd, dy, g_dx, g_dscale, g_dbias,
                groups, slope)
        before = trace.counters()
        got = fn._launch_second_order(*args)
        torch.cuda.synchronize()
        if counted_since(before, ["group_norm_act_second_order"]) != {
                "group_norm_act_second_order": 1}:
            raise AssertionError("the second-order launcher did not count "
                                 "its launch")
        want = fn.group_norm_act_bwd_vjp_plain(*args)
        shape = f"[{b}, {hw}, {c}] bf16 slope {slope}"
        err = 0.0
        for name, g, w in (("g_x", got[0], want[0]),
                           ("g_dy", got[3], want[3])):
            if g.dtype != torch.bfloat16 or g.shape != x.shape:
                raise AssertionError(f"second-order kernel returned {name} "
                                     f"{g.dtype} {list(g.shape)}")
            w = w.float()
            err = max(err, _assert_within(
                f"{name} {shape}", g, w,
                2 ** -7 * w.abs() + 1e-5 * float(w.abs().max())))
        worst = max(worst, err)
        _assert_within(f"g_scale {shape}", got[1], want[1],
                       1e-5 * float(want[1].abs().max()))
        if got[2].any():
            raise AssertionError(f"g_bias {shape} is not 0")
        del got, want
        t_kernel, t_plain = paired_ms(
            lambda: fn.group_norm_act_bwd_vjp_plain(*args),
            lambda: fn._launch_second_order(*args), 10)
        xb = x.numel() * x.element_size()
        # Least bytes: x, dy and g_dx read once, g_x and g_dy written once,
        # the float32 vectors (scale, bias, g_dscale, g_dbias, g_scale,
        # g_bias; mean and rstd); operations about 40 an element.
        vectors = 4 * (6 * c + 2 * b * groups)
        ops = 40 * x.numel()
        bound = least_ms(5 * xb + vectors, ops)
        tiling = fn.norm_tiling(b, hw, c, x.dtype, "second_order")
        moved = fn.norm_traffic_bytes(b, hw, c, x.dtype, "second_order",
                                      tiling)
        traffic_bound = least_ms(moved + vectors, ops)[0]
        composite = ""
        if first is None:
            t_composite = cuda_ms(lambda: _composite_second_order(
                x, scale, bias, dy, (g_dx, g_dscale, g_dbias), groups,
                slope), 3)
            composite = f", the composite it replaced {t_composite:.4f} ms"
            first = {"ms": t_kernel, "plain_ms": t_plain, "bound": bound,
                     "composite_ms": t_composite}
        log(f"kernel group_norm_act second order {shape}: max|err| "
            f"{err:g}, kernel {t_kernel:.4f} ms "
            f"({moved / t_kernel / 1e6:.1f} GB/s of {moved / xb:g} units "
            f"moved), closed form {t_plain:.4f} ms{composite}, bound "
            f"{bound[0]:.4f} ms ({bound[1]}; with the streamed rows read "
            f"again {traffic_bound:.4f} ms); tiling cluster "
            f"{tiling.cluster}, {tiling.rows_per_block} rows a block, "
            f"{tiling.resident_rows} resident, {tiling.smem_bytes} B shared "
            f"memory, max active clusters "
            f"{fn.max_active_clusters(x.dtype, 'second_order', tiling)}; "
            f"{per_step} launches a step")
        step["ms"] += per_step * t_kernel
        step["bound_ms"] += per_step * bound[0]
        step["traffic_bound_ms"] += per_step * traffic_bound
        del x, dy, g_dx, args
        torch.cuda.empty_cache()
    count = sum(shape[3] for shape in SECOND_ORDER_SHAPES)
    log(f"kernel group_norm_act second order, the flagship step's {count} "
        f"launches: {step['ms']:.4f} ms a step, bound "
        f"{step['bound_ms']:.4f} ms, {100 * step['bound_ms'] / step['ms']:.1f}"
        f"% of the bound (with the streamed rows read again "
        f"{step['traffic_bound_ms']:.4f} ms)")
    return {"name": "group_norm_act_second_order", "route": "cuda",
            "source": "srgan_tpu_torch/csrc/fused_norm.cu",
            # No TPU kernel: JAX differentiates its plain backward by the
            # custom_jvp rule bwd_op_jvp.
            "replaces": "srgan_tpu/ops/fused_norm.py:425",
            "launches": None, "max_abs_err": worst, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound"][0],
            "bound_by": first["bound"][1],
            # No single PyTorch call differentiates a GroupNorm's backward.
            "library_ms": None, "composite_ms": first["composite_ms"],
            "step_ms": step["ms"], "step_bound_ms": step["bound_ms"],
            "step_traffic_bound_ms": step["traffic_bound_ms"]}


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


def _density_inputs(rng, b, n, counts, h, w):
    """[b, n, 2] float32 heads uniform over the canvas widened by 16 px on
    each side (NaN in the slots past each count)."""
    heads = np.stack([rng.uniform(-16, h + 16, (b, n)),
                      rng.uniform(-16, w + 16, (b, n))], -1).astype(np.float32)
    for i, c in enumerate(counts):
        heads[i, c:] = np.nan
    return heads


def _nonzero_pairs(heads, counts, h, w, sigma) -> int:
    """The (pixel, valid head) pairs of ``heads`` [b, n, 2] (y, x) on the
    h×w canvas whose float32 term exp(−r²/2σ²) is not 0: r² ≤ 300·ln 2·σ²,
    as exp rounds to 0 below 2⁻¹⁵⁰, half the least subnormal. Past that
    radius a term adds an exact 0, so these pairs are the work the maps
    need."""
    r2 = 300.0 * math.log(2.0) * sigma ** 2
    reach = math.ceil(math.sqrt(r2)) + 1
    pts = np.concatenate([heads[i, :c] for i, c in enumerate(counts)]
                         ).astype(np.float64)
    total = 0
    for chunk in np.array_split(pts, max(1, len(pts) // 4096)):
        hy, hx = chunk[:, :1], chunk[:, 1:]
        y = np.floor(hy) + np.arange(-reach, reach + 1)
        half2 = r2 - (y - hy) ** 2
        rows = (half2 >= 0) & (y >= 0) & (y < h)
        half = np.sqrt(np.maximum(half2, 0.0))
        lo = np.maximum(np.ceil(hx - half), 0)
        hi = np.minimum(np.floor(hx + half), w - 1)
        total += int(np.where(rows, np.maximum(hi - lo + 1, 0), 0).sum())
    return total


def _check_density(name, got, want, counts):
    """The density tolerance: |got − want| ≤ 1e-6 + 1e-4·|want| per
    element, and each map's sum within 1e-4·max(count, 1) of its count.
    Returns the largest |got − want|."""
    err = _assert_within(name, got, want, 1e-6 + 1e-4 * want.abs())
    sums = got.double().sum(dim=(1, 2)).cpu().numpy()
    counts = np.asarray(counts, np.float64)
    off = np.abs(sums - counts) / np.maximum(counts, 1.0)
    if not off.max() <= 1e-4:
        i = int(off.argmax())
        raise AssertionError(f"{name}: map {i} sums to {sums[i]}, its count "
                             f"is {counts[i]:g}")
    return err


def check_density_kernel(dev):
    """Phase 2, density: the kernel against ``density_maps_plain`` on the
    card, σ = 8 on 384×512 canvases (the preprocessor's default size and
    the flagship's images): B = 16 maps of N = 4096 slots with counts
    uniform in [0, 4096]; the preprocessing path's shape, one map of the
    most crowded image of phase 7's database (``raw_draws``); and one map
    of 12 865 heads (UCF-QNRF's most crowded image). Tolerance at
    ``_check_density``. Each case's kernel time (queued behind a sleep
    kernel, as a B = 1 call takes the host longer than the card) and its
    share of the bound. Returns the kernel table entry of the B = 16 case
    with the path shape's ``path_ms`` and ``path_bound_ms`` (launches
    filled in by the preprocessing phase)."""
    from srgan_tpu_torch.ops.density import (TILE, density_maps,
                                             density_maps_plain, density_plan)
    h, w, sigma = 384, 512, 8.0
    rng = np.random.default_rng(7)
    b16 = rng.integers(0, 4097, 16)
    crowded = max((xy for *_, xy in raw_draws()), key=len)
    cases = [("16 x 4096 slots", _density_inputs(rng, 16, 4096, b16, h, w),
              b16),
             (f"path, 1 x {len(crowded)} heads", resized_heads(crowded)[None],
              np.array([len(crowded)])),
             ("1 x 12865 heads", _density_inputs(rng, 1, 12865, [12865], h, w),
              np.array([12865]))]
    entry = None
    for name, heads_np, counts in cases:
        b, n, _ = heads_np.shape
        heads = torch.from_numpy(heads_np).to(dev)
        counts_t = torch.from_numpy(counts.astype(np.int32)).to(dev)
        call = dict(height=h, width=w)
        got = density_maps(heads, counts_t, sigma, **call)
        torch.cuda.synchronize()
        want = density_maps_plain(heads, counts_t, sigma, **call)
        if got.shape != (b, h, w) or got.dtype != torch.float32:
            raise AssertionError(f"density kernel returned {got.dtype} "
                                 f"{list(got.shape)}")
        err = _check_density(f"density kernel [{name}]", got, want, counts)

        def plain():
            return density_maps_plain(heads, counts_t, sigma, **call)
        t_plain = cuda_ms(plain, 1)
        t_kernel = cuda_ms(lambda: density_maps(heads, counts_t, sigma,
                                                **call), 20, queued=True)
        t_plain = (t_plain + cuda_ms(plain, 1)) / 2
        # Heads and counts read once, the maps written once; two float32
        # operations (the separable form's multiply-add) per (pixel, valid
        # head) pair whose term is not 0, the least work of the function.
        needed = _nonzero_pairs(heads_np, counts, h, w, sigma)
        bound_ms, bound_by = least_ms(b * n * 8 + b * 4 + b * h * w * 4,
                                      2 * needed)
        plan = density_plan(h, w, sigma, b, n)
        log(f"kernel density_maps [{name}, sigma {sigma:g}] -> "
            f"{list(got.shape)}: max|err| {err:g}, kernel {t_kernel:.4f} ms "
            f"({TILE}x{TILE} tiles, {plan.splits} runs of slots, "
            f"cull radius {plan.radius}; "
            f"{needed:.4g} nonzero (pixel, head) pairs), plain "
            f"{t_plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / t_kernel:.1f}% of the bound")
        if entry is None:
            # No single PyTorch call renders normalized Gaussians.
            entry = {"name": "density_maps", "route": "cuda",
                     "source": "srgan_tpu_torch/csrc/density.cu",
                     "replaces": "srgan_tpu/ops/density.py:30",
                     "launches": None, "max_abs_err": err, "ms": t_kernel,
                     "plain_ms": t_plain, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
        elif name.startswith("path"):
            entry["path_ms"], entry["path_bound_ms"] = t_kernel, bound_ms
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        del heads, got, want
        torch.cuda.empty_cache()
    return entry


def check_copy_kernel(dev):
    """Phase 2, copy probe: the kernel in both launch layouts at both
    shapes of the bandwidth tool, bfloat16, bit-equal to its plain version
    (a Python loop of slab copies) and to its source; the plain version
    timed, beside the bound (each byte read once and written once).
    Returns the kernel table entry of per_example at [360, 12544, 64], the
    yardstick of the fused norm; the kernel's and ``copy_``'s times come
    from the bandwidth tool's run in phase 9."""
    from srgan_tpu_torch.tools import norm_bandwidth_bench as bw
    gen = torch.Generator(device=dev).manual_seed(5)
    entry = None
    for shape in bw.SHAPES:
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        bound_ms, bound_by = least_ms(2 * x.numel() * x.element_size(), 0)
        for layout, rows in (("per_example", 0), ("batch_strided", 6272)):
            got = bw.copy(x, layout, rows)
            want = bw.copy_plain(x, layout, rows)
            if not (torch.equal(got, want) and torch.equal(want, x)):
                raise AssertionError(f"copy kernel ({layout}) is not exact "
                                     f"at {list(shape)}")
            del got, want
            t_plain = cuda_ms(lambda: bw.copy_plain(x, layout, rows), 20)
            log(f"kernel copy [{layout}, rows {rows}] {list(shape)} bf16: "
                f"exact, plain {t_plain:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
            if layout == "per_example" and shape == bw.SHAPES[-1]:
                entry = {"name": "copy", "route": "cuda",
                         "source": "srgan_tpu_torch/csrc/copy.cu",
                         "replaces": "tools/norm_bandwidth_bench.py:38",
                         "launches": None, "max_abs_err": 0.0, "ms": None,
                         "plain_ms": t_plain, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None}
        del x
        torch.cuda.empty_cache()
    return entry


def check_second_order(dev):
    """Phase 3: ∂/∂scale of mean((‖∂/∂x Σ y²‖ − 1)²), the derivative the
    gradient penalty takes through the norm (tests/test_fused_norm.py), in
    float32 at a D-like shape: the kernel path (forward kernel, backward
    kernel, second-order kernel) against autograd through the plain
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

    before = trace.counters()
    got_v, got_g = penalty(kernel)
    launched = tuple(counted_since(before, NORM_KERNELS).values())
    want_v, want_g = penalty(plain)
    if launched[0] < 1 or launched[1] < 2 or launched[2] != 1:
        raise AssertionError(f"second order: kernels launched {launched} "
                             f"(forward, backward, second order) times")
    if not math.isclose(got_v, want_v, rel_tol=1e-4):
        raise AssertionError(f"second order: penalty {got_v} vs {want_v}")
    torch.testing.assert_close(got_g, want_g, rtol=1e-3, atol=1e-6)
    log(f"second order [{b}, {c}, {h}, {h}] f32: penalty {got_v:.7g} "
        f"(plain {want_v:.7g}), ∂/∂scale max|err| "
        f"{float((got_g - want_g).abs().max()):g} of "
        f"{float(want_g.abs().max()):g}; kernel launches (forward, "
        f"backward, second order) {launched}")


def check_small_step(dev, norm_impl, factors=(), **over):
    """Phase 4: at a tiny size, float32, on the card against the CPU: the
    grid evaluation on the init weights, then one training step; ``over``
    sets the model or the label type (``crowd_model``,
    ``crowd_label_type``).

    Tolerances. Patches: fixed ones exactly; rescaled ones as the rescale
    kernel's check (images 1e-6, labels 1e-5 of their largest). Step
    metrics: rtol 1e-3. Density maps and counts: rtol 1e-4 plus 1e-3 of
    the largest value, the bound of tests/test_torch_port_eval.py, where
    the tiny models' one-channel GroupNorms amplify the two devices'
    different sum orders."""
    from srgan_tpu_torch import CrowdExperiment, Settings
    from srgan_tpu_torch.train import init_train_state, set_float32_precision
    set_float32_precision()
    settings = Settings(norm_impl=norm_impl, crowd_rescale_factors=factors,
                        **dict(TINY, **over))
    what = ", ".join([norm_impl, f"factors {factors}"]
                     + [f"{k} {v}" for k, v in over.items()])
    before = trace.counters()
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
            raise AssertionError(f"small step ({what}): {name} patches on "
                                 f"the card differ from the CPU's by {err} "
                                 f"> {tol}")
    for name, a, c in zip(("maps", "counts"), cpu_eval, gpu_eval):
        np.testing.assert_allclose(
            c, a, rtol=1e-4, atol=1e-3 * float(np.abs(a).max()),
            err_msg=f"small grid evaluation ({what}): {name}")
    for k, v in cpu_metrics.items():
        if not math.isclose(gpu_metrics[k], v, rel_tol=1e-3, abs_tol=1e-5):
            raise AssertionError(f"small step ({what}): {k} is "
                                 f"{gpu_metrics[k]} on the card, {v} on the "
                                 f"CPU")
    launches = tuple(counted_since(before, ["group_norm_act_fwd",
                                            "extract_rescaled_patches"]
                                   ).values())
    if ((launches[0] > 0) != (norm_impl == "pallas")
            or launches[1] != (3 if factors else 0)):
        raise AssertionError(f"small step ({what}): (norm forward, rescale) "
                             f"kernels launched {launches} times")
    log(f"small fp32, {what}, card vs CPU ((norm forward, rescale) "
        f"launches on the card {launches}): maps max|err| "
        f"{float(np.abs(gpu_eval[0] - cpu_eval[0]).max()):g} of "
        f"{float(np.abs(cpu_eval[0]).max()):g}, counts "
        f"{np.array2string(gpu_eval[1], precision=6)}/"
        f"{np.array2string(cpu_eval[1], precision=6)}; step "
        + ", ".join(f"{k} {gpu_metrics[k]:.6g}/{v:.6g}"
                    for k, v in sorted(cpu_metrics.items())))


def _app_class(app: str):
    from srgan_tpu_torch import (AgeExperiment, CoefficientExperiment,
                                 DrivingExperiment)
    return {"coefficient": CoefficientExperiment, "age": AgeExperiment,
            "driving": DrivingExperiment}[app]


def check_small_app_step(dev, app, norm_impl="xla", dnn_only=False):
    """Phase 4, the other apps: at a tiny size (``APP_TINY``: 32-px
    images, base width 8, hidden 8, batch 4), float32, on the card
    against the CPU on the same weights (drawn on the host), the same
    first batch of the base input pipeline and the same draws: one step
    (the SR-GAN step, or with ``dnn_only`` the DNN-only one), then
    ``predict`` of the validation split by the trained model.

    Tolerances: step metrics rtol 1e-3 (as the crowd's small step);
    predictions rtol 1e-4 plus 1e-3 of the largest, the crowd grid
    evaluation's bound (the tiny one-channel GroupNorms amplify the two
    devices' sum orders). Under "pallas" the card's norm launches are
    counted: 3 norms a model at 32 px (``norm_launches_per_step``: forward,
    backward and second order), and 3 forwards for each of the 2
    prediction chunks."""
    from srgan_tpu_torch import Settings
    from srgan_tpu_torch.train import init_train_state, set_float32_precision
    set_float32_precision()
    settings = Settings(norm_impl=norm_impl, dnn_only=dnn_only, **APP_TINY)
    rng = np.random.default_rng(6)
    b, z = settings.batch_size, settings.latent_dimension
    draws = dict(z_d=rng.normal(0, 1, (b, z)), z_g=rng.normal(0, 1, (b, z)),
                 alpha=rng.uniform(0, 1, b))
    results = []
    for device in ("cpu", dev):
        before = trace.counters()
        exp = _app_class(app)(settings, device=device)
        exp.dataset_setup()
        exp.models = exp.model_setup()
        exp.state = init_train_state(settings, exp.models)
        exp.prepare_train_step()
        batch = next(next(exp.epoch_batch_iterators()))
        if dnn_only:
            _, metrics = exp._train_step(exp.state, *batch[:2])
        else:
            fed = {k: torch.tensor(v, dtype=torch.float32, device=device)
                   for k, v in draws.items()}
            _, metrics = exp._train_step(exp.state, *batch, None, **fed)
        preds = exp.predict(exp.validation_dataset)
        launches = tuple(counted_since(before, NORM_KERNELS).values())
        results.append(({k: float(v) for k, v in metrics.items()}, preds,
                         launches))
    (cpu_metrics, cpu_preds, _), (gpu_metrics, gpu_preds, launches) = results
    what = f"small {app} ({norm_impl}{', dnn_only' if dnn_only else ''})"
    if set(gpu_metrics) != set(cpu_metrics):
        raise AssertionError(f"{what}: metrics {sorted(gpu_metrics)}")
    for k, v in cpu_metrics.items():
        if not math.isclose(gpu_metrics[k], v, rel_tol=1e-3, abs_tol=1e-5):
            raise AssertionError(f"{what}: {k} is {gpu_metrics[k]} on the "
                                 f"card, {v} on the CPU")
    np.testing.assert_allclose(
        gpu_preds, cpu_preds, rtol=1e-4,
        atol=1e-3 * float(np.abs(cpu_preds).max()),
        err_msg=f"{what}: validation predictions")
    want = (0, 0, 0)
    if norm_impl == "pallas" and app != "coefficient":
        step = norm_launches_per_step(3, dnn_only)
        chunks = -(-settings.validation_dataset_size // b)
        want = (step[0] + 3 * chunks, *step[1:])
    if launches != want:
        raise AssertionError(f"{what}: (norm forward, backward, second "
                             f"order) kernels launched {launches} times, "
                             f"not {want}")
    log(f"{what}, fp32, card vs CPU (norm launches on the card {launches}): "
        f"validation predictions max|err| "
        f"{float(np.abs(gpu_preds - cpu_preds).max()):g} of "
        f"{float(np.abs(cpu_preds).max()):g}; step "
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


def check_crowd_trial(trial_directory: str, steps: int) -> None:
    """A crowd trial's 7 losses finite at every step, its validation
    scalars finite and its PNGs written every ``VALIDATION_PERIOD``
    steps; the first and last losses and the last validation logged."""
    losses = read_scalars(trial_directory)
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
    check_validation(trial_directory,
                     range(VALIDATION_PERIOD, steps + 1, VALIDATION_PERIOD))
    log("losses, first step: " + json.dumps(merged[0]))
    log("losses, last step:  " + json.dumps(merged[steps - 1]))
    log("validation, last:   " + json.dumps(
        {sub: {k: v for k, v in losses[sub][steps].items()
               if k.startswith("validation/")} for sub in ("GAN", "DNN")}))


def train_main_path(settings, dev, card: str) -> tuple:
    """Phases 5 and 6 (and 17 (b)): ``CrowdExperiment(settings).train()``
    with validation every ``VALIDATION_PERIOD`` steps, checked, then
    further steps of the same experiment timed, ``FLAGSHIP_PROFILED``
    more under ``torch.profiler`` (the card's busy share), and one
    validation pass timed. Returns the kernels' launches during
    ``train()``, by kernel table name, and {ms_per_step, peak_gib,
    busy_share}."""
    from srgan_tpu_torch import CrowdExperiment
    # An earlier run's experiment, held by reference cycles, must not
    # count in this one's peak.
    gc.collect()
    torch.cuda.empty_cache()
    exp = CrowdExperiment(settings, device=dev)
    steps = settings.steps_to_run
    impl = settings.norm_impl
    rescale = bool(settings.crowd_rescale_factors)
    what = f"{impl}{', rescale' if rescale else ''}"
    torch.cuda.reset_peak_memory_stats()
    before = trace.counters()
    t0 = time.perf_counter()
    state = exp.train()
    torch.cuda.synchronize()
    launches = counted_since(before)
    copies = counted_since(before, ["group_norm_act.layout_copies"])[
        "group_norm_act.layout_copies"]
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
    for name, count in per_step.items():
        want = count * steps + per_validation[name] * validations
        if launches[name] != want:
            raise AssertionError(
                f"{name} launched {launches[name]} times in {steps} steps "
                f"and {validations} validation passes, not {want} ({count} "
                f"per step, {per_validation[name]} per validation pass)")
    check_crowd_trial(exp.trial_directory, steps)

    epochs = exp.epoch_batch_iterators()

    def batches():
        while True:
            yield from next(epochs)

    stream = batches()
    for _ in range(2):
        exp._train_step(exp.state, *next(stream), exp._rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        _, metrics = exp._train_step(exp.state, *next(stream), exp._rng)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"timed steps: losses {metrics}")
    out = {"ms_per_step": 1e3 * elapsed / TIMED_STEPS,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(FLAGSHIP_PROFILED):
            exp._train_step(exp.state, *next(stream), exp._rng)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, _ = _busy(prof)
    out["busy_share"] = busy / wall
    t0 = time.perf_counter()
    exp.validation_summaries(epoch=0, step=10 ** 6)
    torch.cuda.synchronize()
    t_val = time.perf_counter() - t0
    log(f"time ({what}): {out['ms_per_step']:.2f} ms/step, "
        f"{settings.batch_size * TIMED_STEPS / elapsed:.2f} images/s "
        f"(batch {settings.batch_size}, {TIMED_STEPS} steps, {dev}: "
        f"{card}), peak allocated {out['peak_gib']:.2f} GiB; the card busy "
        f"{100 * out['busy_share']:.1f}% of {FLAGSHIP_PROFILED} steps "
        f"under torch.profiler ({busy:.1f} of {wall:.1f} ms); one "
        f"validation pass ({settings.validation_dataset_size} images, D "
        f"and DNN, triptychs and G samples written) {1e3 * t_val:.1f} ms")
    return launches, out


def app_train_main_path(app, settings, dev, card: str) -> dict:
    """Phase 10: ``<App>Experiment(settings, device="cuda").train()``:
    every step's losses finite, every validation scalar finite for D
    (unless ``dnn_only``) and the DNN, the G sample PNGs written (image
    apps, unless ``dnn_only``), and under "pallas" the fused norm
    launched ``norm_launches_per_step(4)`` times a step (4 norms in each
    of D, G and the DNN at 64 px; forward, backward and second order) and
    4 forwards per model and
    ``batch_size`` chunk of each validation pass, plus G's 4 for the
    samples. Then ``TIMED_STEPS`` more steps of the same experiment
    between synchronizations: ms/step, examples/s and the peak of
    allocated memory; and ``PROFILED_STEPS`` under ``torch.profiler``:
    the card's busy ms a step. Returns the timing line's numbers."""
    exp = _app_class(app)(settings, device=dev)
    steps = settings.steps_to_run
    period = settings.validation_step_period
    pallas = settings.norm_impl == "pallas" and app != "coefficient"
    what = (f"{app} ({settings.norm_impl}, {settings.compute_dtype}"
            f"{', dnn_only' if settings.dnn_only else ''})")
    # An earlier run's experiment, held by reference cycles, must not
    # count in this one's peak.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = trace.counters()
    t0 = time.perf_counter()
    state = exp.train()
    torch.cuda.synchronize()
    launches = counted_since(before, NORM_KERNELS)
    validations = steps // period
    log(f"train {what}: {steps} steps and {validations} validation passes "
        f"through train() in {time.perf_counter() - t0:.1f} s (data set-up "
        f"and warm-up included); kernel launches {json.dumps(launches)}")
    if state.step != steps:
        raise AssertionError(f"{what}: trained {state.step} steps")
    if pallas:
        chunks = -(-settings.validation_dataset_size // settings.batch_size)
        models = 1 if settings.dnn_only else 2
        per_validation = 4 * models * chunks + (0 if settings.dnn_only
                                                else 4)
        per_step = norm_launches_per_step(4, settings.dnn_only)
        want = {"group_norm_act_fwd": per_step[0] * steps
                + per_validation * validations,
                "group_norm_act_bwd": per_step[1] * steps,
                "group_norm_act_second_order": per_step[2] * steps}
    else:
        want = {name: 0 for name in NORM_KERNELS}
    if launches != want:
        raise AssertionError(f"{what}: norm kernels launched {launches}, "
                             f"not {want}")
    scalars = read_scalars(exp.trial_directory)
    losses = 1 if settings.dnn_only else 7
    for step in range(steps):
        values = {k: v for sub in ("GAN", "DNN")
                  for k, v in scalars[sub].get(step, {}).items()
                  if not k.startswith("validation/")}
        if len(values) != losses or not all(map(math.isfinite,
                                                values.values())):
            raise AssertionError(f"{what}: step {step} losses {values}")
    tags = {f"validation/{k}" for k in REGRESSION_METRICS}
    writers = ("DNN",) if settings.dnn_only else ("GAN", "DNN")
    for step in range(period, steps + 1, period):
        for sub in writers:
            got = {k: v for k, v in scalars[sub].get(step, {}).items()
                   if k.startswith("validation/")}
            if set(got) != tags or not all(map(math.isfinite,
                                               got.values())):
                raise AssertionError(f"{what}: {sub} validation at step "
                                     f"{step}: {got}")
        if "GAN" not in writers:
            gan = scalars["GAN"].get(step, {})
            if any(k.startswith("validation/") for k in gan):
                raise AssertionError(f"{what}: D validated: {gan}")
        pngs = [os.path.join(exp.trial_directory, "GAN", "images",
                             f"generated_sample_{i}_{step}.png")
                for i in range(4)]
        written = [os.path.exists(p) for p in pngs]
        expect = app != "coefficient" and not settings.dnn_only
        if written != [expect] * 4:
            raise AssertionError(f"{what}: sample PNGs at step {step}: "
                                 f"{written}")
    log(f"train {what}: last step's losses " + json.dumps(
        {k: v for sub in ("GAN", "DNN")
         for k, v in scalars[sub].get(steps - 1, {}).items()}) +
        "; validation, last: "
        + json.dumps({sub: {k: v for k, v in scalars[sub][steps].items()
                            if k.startswith("validation/")}
                      for sub in writers}))

    epochs = exp.epoch_batch_iterators()

    def batches():
        while True:
            yield from next(epochs)

    stream = batches()
    for _ in range(2):
        exp._step(*next(stream))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        _, metrics = exp._step(*next(stream))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"{what}: timed steps' losses {metrics}")
    out = {"ms_per_step": 1e3 * elapsed / TIMED_STEPS,
           "examples_per_s": settings.batch_size * TIMED_STEPS / elapsed,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    # The card's busy time a step: its kernels' and copies' device time
    # over PROFILED_STEPS steps under torch.profiler, beside the
    # unprofiled ms/step.
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILED_STEPS):
            exp._step(*next(stream))
        torch.cuda.synchronize()
    # The rows of the card's own events (kernels, copies, sets); a host
    # op's row repeats the time of the kernels it launched.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    out["device_ms_per_step"] = sum(
        e.self_device_time_total for e in events) / 1e3 / PROFILED_STEPS
    out["kernels_per_step"] = sum(e.count for e in events) / PROFILED_STEPS
    log(f"time {what}: {out['ms_per_step']:.3f} ms/step, "
        f"{out['examples_per_s']:.1f} examples/s (batch "
        f"{settings.batch_size}, {TIMED_STEPS} steps, {dev}: {card}), peak "
        f"allocated {out['peak_gib']:.3f} GiB; under torch.profiler "
        f"({PROFILED_STEPS} steps) the card is busy "
        f"{out['device_ms_per_step']:.3f} ms a step "
        f"({100 * out['device_ms_per_step'] / out['ms_per_step']:.1f}% of "
        f"the unprofiled step), {out['kernels_per_step']:.0f} device "
        f"operations a step")
    exp.close()
    return out


def raw_draws():
    """The raw database's draws from seed 0, in order: (split, i, the
    image's 24×32 noise, its heads (x, y) float64) per image, up to 2000
    heads each; the test split's first image has none."""
    rng = np.random.default_rng(0)
    for split, count in RAW_SPLITS.items():
        for i in range(count):
            small = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
            n = 0 if (split, i) == ("test", 0) else int(rng.integers(0, 2001))
            yield split, i, small, np.stack(
                [rng.uniform(0, RAW_W, n), rng.uniform(0, RAW_H, n)], -1)


def resized_heads(xy):
    """Raw (x, y) heads → (y, x) on the 384×512 canvas, in float32 as the
    preprocessor scales them."""
    xy = xy.astype(np.float32)
    return np.stack([xy[:, 1] * (384 / RAW_H), xy[:, 0] * (512 / RAW_W)], -1)


def synthesize_raw_database(root: str):
    """A raw UCF-QNRF-layout database of ``raw_draws``: per split
    (``RAW_SPLITS``) a directory of 768×1024 JPEGs ``img_<i>.jpg`` and
    ``img_<i>_ann.mat`` annotations (``annPoints``, [M, 2] (x, y)).
    Returns {split: [heads (x, y) float32 per image]}."""
    from PIL import Image
    from scipy.io import savemat
    heads = {split: [] for split in RAW_SPLITS}
    for split, i, small, xy in raw_draws():
        raw = os.path.join(root, split)
        os.makedirs(raw, exist_ok=True)
        # Smooth pixels (upsampled noise): JPEG-sized like a photo.
        Image.fromarray(small).resize((RAW_W, RAW_H), Image.BILINEAR
                                      ).save(os.path.join(
                                          raw, f"img_{i:04d}.jpg"))
        savemat(os.path.join(raw, f"img_{i:04d}_ann.mat"), {"annPoints": xy})
        heads[split].append(xy.astype(np.float32))
    return heads


def preprocess_main_path(dev, root: str) -> tuple:
    """Phase 7: the raw database through the preprocessing CLI,
    ``srgan_tpu_torch.data.crowd.main`` in resize mode at 384×512, σ = 8,
    one call per split, the density labels rendered by the kernel on the
    card. Checks one density launch per image; each written map against
    ``density_maps_plain`` on the card from the same heads, scaled as the
    preprocessor scales them (tolerance at ``_check_density``); each
    image's count. Returns (database directory, density launches)."""
    import contextlib
    import io
    import shutil

    from srgan_tpu_torch.data.crowd import CrowdDatabase
    from srgan_tpu_torch.data.crowd import main as preprocess
    from srgan_tpu_torch.ops.density import density_maps_plain
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    heads = synthesize_raw_database(os.path.join(root, "raw"))
    t_write = time.perf_counter() - t0
    db_dir = os.path.join(root, "db")
    images = sum(RAW_SPLITS.values())
    before = trace.counters()
    t0 = time.perf_counter()
    for split in RAW_SPLITS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = preprocess([os.path.join(root, "raw", split),
                             os.path.join(db_dir, f"{split}.npz"), "--mode",
                             "resize", "--height", "384", "--width", "512",
                             "--sigma", "8"])
        if rc != 0:
            raise AssertionError(f"preprocessing {split} returned {rc}")
        log("preprocess: " + out.getvalue().strip())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = counted_since(before, ["density_maps"])["density_maps"]
    if launches != images:
        raise AssertionError(f"density kernel launched {launches} times for "
                             f"{images} images")
    worst = 0.0
    for split, split_heads in heads.items():
        db = CrowdDatabase.load(os.path.join(db_dir, f"{split}.npz"))
        n = max(1, max(len(h) for h in split_heads))
        padded = np.zeros((len(split_heads), n, 2), np.float32)
        for i, xy in enumerate(split_heads):
            padded[i, :len(xy)] = resized_heads(xy)
        counts = np.array([len(h) for h in split_heads], np.int32)
        np.testing.assert_array_equal(db.head_counts, counts)
        want = density_maps_plain(torch.from_numpy(padded).to(dev),
                                  torch.from_numpy(counts).to(dev), 8.0,
                                  height=384, width=512)
        worst = max(worst, _check_density(
            f"preprocessed {split} maps", torch.from_numpy(
                db.density_maps).to(dev), want, counts))
    log(f"preprocess: {images} raw 768x1024 images ({t_write:.1f} s to "
        f"synthesize) -> 384x512 in {elapsed:.2f} s, "
        f"{1e3 * elapsed / images:.2f} ms per image (JPEG decode and "
        f"resize, the density label on the card, the npz write); density "
        f"kernel launches {launches}; maps vs plain on the card max|err| "
        f"{worst:g} (the kernel alone on the most crowded image: phase 2's "
        f"path_ms)")
    return db_dir, launches


def _cli(argv) -> dict:
    """``python -m srgan_tpu_torch`` in this process, on one card (the
    default, every visible card, would spawn a rank on each); its JSON
    line."""
    import contextlib
    import io

    from srgan_tpu_torch.__main__ import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv + ["--data_parallel_devices=1"])
    if rc != 0:
        raise AssertionError(f"main({argv}) returned {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


COUNT_METRICS = {"MAE", "RMSE", "NVE", "NAE"}  # crowd's
REGRESSION_METRICS = {"MAE", "RMSE", "NVE"}     # the other apps'


def _finite_metrics(what, result, keys=COUNT_METRICS):
    for split in ("validation", "test"):
        values = result.get(split) or {}
        if set(values) != keys or not all(
                map(math.isfinite, values.values())):
            raise AssertionError(f"{what}: {split} metrics {values}")


def _assert_restored(fresh, step_dir: str) -> int:
    """Every tensor of ``fresh``'s restored state (models and Adam
    moments) bit-equal to the checkpoint file in ``step_dir``; returns
    how many were compared."""
    from srgan_tpu_torch import checkpoint
    saved = torch.load(os.path.join(step_dir, checkpoint.STATE_FILE),
                       map_location="cpu", weights_only=True)
    compared = 0
    for name in ("d", "g", "dnn"):
        module = getattr(fresh.state, name)
        adam = getattr(fresh.state, f"{name}_opt").adam.state_dict()["state"]
        pairs = [(f"{name}.{k}", v, saved[name][k])
                 for k, v in module.state_dict().items()]
        pairs += [(f"{name}_opt.{i}.{s}", v, saved[f"{name}_opt"][i][s])
                  for i, slots in adam.items() for s, v in slots.items()]
        if len(pairs) != len(saved[name]) + sum(
                map(len, saved[f"{name}_opt"].values())):
            raise AssertionError(f"restore: {name} has {len(pairs)} tensors")
        for key, got, want in pairs:
            if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
                raise AssertionError(f"restore: {key} differs from the "
                                     f"checkpoint")
        compared += len(pairs)
    if fresh.state.step != saved["step"]:
        raise AssertionError(f"restored step {fresh.state.step}, saved "
                             f"{saved['step']}")
    return compared


def cli_main_path(dev, db_dir: str, logs: str) -> dict:
    """Phase 8: the command line on the preprocessed database at the
    ``crowd_flagship`` preset under ``norm_impl`` "pallas": train 4 steps
    with checkpoints every 2 and validation every 4; restore step 4 into
    a fresh experiment, every tensor bit-equal to the checkpoint written;
    resume to step 6; evaluate only, exporting the density maps. Returns
    the kernel launches of the first run."""
    from srgan_tpu_torch import CrowdExperiment, Settings, checkpoint
    from srgan_tpu_torch.presets import apply_preset
    flags = dict(norm_impl="pallas", crowd_database_path=db_dir,
                 logs_directory=logs, trial_name="chip_smoke_cli",
                 summary_step_period=1, seed=0)
    base = ["crowd", "--preset", "crowd_flagship"] + [
        f"--{k}={v}" for k, v in flags.items()]
    before = trace.counters()
    t0 = time.perf_counter()
    first = _cli(base + ["--steps_to_run", "4", "--save_step_period", "2",
                         "--validation_step_period", "4"])
    launches = counted_since(before, LAUNCH_COUNTERS)
    trial = first["trial_directory"]
    _finite_metrics("train", first)
    root = os.path.join(trial, "checkpoints")
    if sorted(os.listdir(root)) != ["step_2", "step_4"]:
        raise AssertionError(f"checkpoints {sorted(os.listdir(root))}")
    log(f"cli train: 4 steps in {time.perf_counter() - t0:.1f} s (set-up "
        f"included), checkpoints step_2 and step_4; kernel launches "
        f"{json.dumps(launches)}; {json.dumps(first)}")
    if (min(launches[k] for k in ("extract_patches", "group_norm_act_fwd",
                                  "group_norm_act_bwd",
                                  "group_norm_act_second_order")) < 1
            or launches["density_maps"]
            or launches["extract_rescaled_patches"]):
        raise AssertionError(f"cli train launched {launches}")

    # Restore step 4 into a fresh experiment.
    settings = Settings(**apply_preset("crowd_flagship", flags))
    fresh = CrowdExperiment(settings, device=dev)
    fresh.prepare_for_evaluation(os.path.join(root, "step_4"))
    compared = _assert_restored(fresh, os.path.join(root, "step_4"))
    if fresh.state.step != 4:
        raise AssertionError(f"restored step {fresh.state.step}")
    mae = fresh.evaluate()["MAE"]
    if not math.isclose(mae, first["validation"]["MAE"], rel_tol=1e-3):
        raise AssertionError(f"restored validation MAE {mae}, trained "
                             f"{first['validation']['MAE']}")
    fresh.close()
    del fresh
    log(f"cli restore: step 4, {compared} tensors bit-equal to the "
        f"checkpoint; validation MAE {mae:.6g} (trained {first['validation']['MAE']:.6g})")

    resumed = _cli(base + ["--load_model_path", trial, "--steps_to_run", "6"])
    _finite_metrics("resume", resumed)
    end = checkpoint.latest_checkpoint(resumed["trial_directory"])
    if os.path.basename(end) != "step_6":
        raise AssertionError(f"resume ended at {end}")
    losses = read_scalars(resumed["trial_directory"])
    for step in (4, 5):
        values = {k: v for sub in ("GAN", "DNN")
                  for k, v in losses[sub].get(step, {}).items()
                  if not k.startswith("validation/")}
        if len(values) != 7 or not all(map(math.isfinite, values.values())):
            raise AssertionError(f"resume step {step}: losses {values}")
    log(f"cli resume: steps 4 and 5 from {os.path.basename(trial)}, losses "
        f"finite, ends at step_6; {json.dumps(resumed)}")

    maps_path = os.path.join(logs, "density_maps.npz")
    evaluated = _cli(base + ["--evaluate_only", "--load_model_path", trial,
                             "--export_density_maps", maps_path])
    _finite_metrics("evaluate", evaluated)
    with np.load(maps_path) as maps:
        shapes = {k: maps[k].shape for k in maps}
        finite = all(np.isfinite(maps[k]).all() for k in maps)
    if shapes != {split: (RAW_SPLITS[split], 96, 128)
                  for split in ("validation", "test")} or not finite:
        raise AssertionError(f"exported maps {shapes} (finite: {finite})")
    log(f"cli evaluate: {json.dumps(evaluated)}; exported {shapes}")
    return launches


def synthesize_imdb_wiki(root: str, n: int = 90) -> str:
    """An IMDB-WIKI layout from seed 0: ``wiki.mat`` (scipy) and ``n``
    JPEGs of 80–160 px (PIL) under ``00/``; every tenth record has a
    second face and is filtered out. Returns the .mat's path."""
    from PIL import Image
    from scipy.io import savemat
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "00"), exist_ok=True)
    full_path = np.empty((1, n), object)
    for i in range(n):
        rel = f"00/img_{i}.jpg"
        h, w = rng.integers(80, 161, 2)
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8)).save(os.path.join(root, rel))
        full_path[0, i] = np.array([rel])
    second = np.full((1, n), np.nan)
    second[0, ::10] = 3.0
    wiki = np.zeros((1, 1), dtype=[
        ("dob", object), ("photo_taken", object), ("full_path", object),
        ("face_score", object), ("second_face_score", object)])
    wiki[0, 0] = (rng.uniform(701000.0, 725000.0, (1, n)),  # 1919–1985
                  np.full((1, n), 2010.0), full_path,
                  rng.uniform(1.5, 5.0, (1, n)), second)
    path = os.path.join(root, "wiki.mat")
    savemat(path, {"wiki": wiki})
    return path


def age_cli_main_path(dev, logs: str) -> None:
    """Phase 11: the other apps' command lines. A synthesized IMDB-WIKI
    layout through ``python -m srgan_tpu_torch.data.age``'s ``main`` (64
    px); ``python -m srgan_tpu_torch age`` on its npz at full width under
    "pallas" (bfloat16, batch 32): 4 steps with checkpoints every 2,
    step 4 restored into a fresh experiment bit for bit, evaluate-only;
    then ``coefficient`` and ``driving`` (frame stack 3) for a few steps.
    Each prints one JSON line of finite validation and test metrics."""
    from srgan_tpu_torch import AgeExperiment, Settings
    from srgan_tpu_torch.data.age import main as age_main
    raw = os.path.join(logs, "imdb_wiki")
    mat = synthesize_imdb_wiki(raw)
    npz = os.path.join(logs, "age.npz")
    t0 = time.perf_counter()
    rc = age_main([raw, mat, npz])
    if rc != 0:
        raise AssertionError(f"the age preprocessor returned {rc}")
    with np.load(npz) as z:
        images, ages = z["images"], z["ages"]
    if (images.shape != (81, 64, 64, 3) or images.dtype != np.uint8
            or not np.all((ages >= 0) & (ages <= 100))):
        raise AssertionError(f"age npz: images {images.dtype} "
                             f"{images.shape}, ages {ages.min()}–"
                             f"{ages.max()}")
    log(f"age preprocess: 90 records, 81 kept, {images.shape} uint8 in "
        f"{time.perf_counter() - t0:.2f} s; ages {ages.min():.1f}–"
        f"{ages.max():.1f}")
    flags = dict(age_database_path=npz, labeled_dataset_size=32,
                 unlabeled_dataset_size=32, validation_dataset_size=9,
                 test_dataset_size=8, logs_directory=logs,
                 trial_name="chip_smoke_age_cli", summary_step_period=1,
                 seed=0, **APP_CLI_MODEL)
    base = ["age"] + [f"--{k}={v}" for k, v in flags.items()]
    before = trace.counters()
    first = _cli(base + ["--steps_to_run", "4", "--save_step_period", "2",
                         "--validation_step_period", "4"])
    launches = tuple(counted_since(before, NORM_KERNELS).values())
    _finite_metrics("age train", first, REGRESSION_METRICS)
    trial = first["trial_directory"]
    root = os.path.join(trial, "checkpoints")
    if sorted(os.listdir(root)) != ["step_2", "step_4"]:
        raise AssertionError(f"age checkpoints {sorted(os.listdir(root))}")
    if min(launches) < 1:
        raise AssertionError(f"age cli: norm launches {launches}")
    log(f"age cli train: 4 steps, checkpoints step_2 and step_4, norm "
        f"launches (forward, backward, second order) {launches}; "
        f"{json.dumps(first)}")
    fresh = AgeExperiment(Settings(**flags), device=dev)
    fresh.prepare_for_evaluation(os.path.join(root, "step_4"))
    compared = _assert_restored(fresh, os.path.join(root, "step_4"))
    mae = fresh.evaluate()["MAE"]
    if not math.isclose(mae, first["validation"]["MAE"], rel_tol=1e-3):
        raise AssertionError(f"age restored validation MAE {mae}, trained "
                             f"{first['validation']['MAE']}")
    fresh.close()
    evaluated = _cli(base + ["--evaluate_only", "--load_model_path", trial])
    _finite_metrics("age evaluate", evaluated, REGRESSION_METRICS)
    log(f"age cli restore: step 4, {compared} tensors bit-equal, validation "
        f"MAE {mae:.6g} (trained {first['validation']['MAE']:.6g}); "
        f"evaluate-only {json.dumps(evaluated)}")
    small = dict(logs_directory=logs, summary_step_period=1, seed=0,
                 labeled_dataset_size=64, unlabeled_dataset_size=256,
                 validation_dataset_size=64, test_dataset_size=64)
    for app, extra in (("coefficient", dict(steps_to_run=50)),
                       ("driving", dict(steps_to_run=4, driving_frame_stack=3,
                                        **APP_CLI_MODEL))):
        result = _cli([app] + [f"--{k}={v}" for k, v in
                               dict(small, **extra).items()])
        _finite_metrics(app, result, REGRESSION_METRICS)
        log(f"{app} cli: {json.dumps(result)}")


def bandwidth_main_path(entry: dict) -> None:
    """Phase 9: the copy probe's own path, the bandwidth tool's ``main``
    (every variant at both shapes, each checked exact and timed, one JSON
    line each). Fills the copy kernel's table ``entry`` with its launches
    there and, from the tool's lines at [360, 12544, 64], the per_example
    kernel's and ``copy_``'s ms."""
    import contextlib
    import io

    from srgan_tpu_torch.tools import norm_bandwidth_bench as bw
    before = trace.counters()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bw.main(["--reps", "20"])
    if rc != 0:
        raise AssertionError(f"the bandwidth tool returned {rc}")
    entry["launches"] = counted_since(before, ["copy.launches"])[
        "copy.launches"]
    records = [json.loads(line) for line in out.getvalue().splitlines()]
    for record in records:
        log("bandwidth: " + json.dumps(record))
        if record["shape"] == list(bw.SHAPES[-1]):
            if record["variant"] == "per_example":
                entry["ms"] = record["ms"]
            elif record["variant"] == "copy_":
                entry["library_ms"] = record["ms"]
    if entry["ms"] is None or entry["library_ms"] is None:
        raise AssertionError(f"the bandwidth tool printed {records}")


# Phase 12's runs, each at the flagship (FLAGSHIP, "pallas") with these
# settings over it. The window run's splits are 64 images, so that a
# window of 32 holds half of each.
CROWD_TIER_RUNS = [
    ("iknn", dict(crowd_label_type="iknn")),
    ("jointdcnn", dict(crowd_model="jointdcnn")),
    ("pyramid", dict(crowd_model="pyramid")),
    ("window", dict(crowd_hbm_window=32, crowd_window_slices=4,
                    crowd_window_refresh_period=2, labeled_dataset_size=64,
                    unlabeled_dataset_size=64,
                    crowd_rescale_factors=RESCALE)),
    ("host", dict(crowd_host_pipeline=True)),
]
# Norms in each crowd model's D (and DNN).
D_NORMS = {"jointcnn": 4, "jointdcnn": 6, "pyramid": 4}


def _check_window(exp, settings, steps: int) -> None:
    """The window run: every window refreshed at each period boundary of
    steps 0..steps−1, its resident ids moved away from the initial fill,
    and its device buffers equal to the host rows of ``resident_ids``."""
    from srgan_tpu_torch.data.window import SliceStream
    period = settings.crowd_window_refresh_period
    boundaries = len(range(period, steps, period))
    data = exp._device_data
    host = {"labeled_images": exp.labeled_db.images,
            "labeled_density": exp._stacked_labels(),
            "unlabeled_images": exp.unlabeled_db.images}
    for window, stream in zip(exp._windows, (7, 8)):
        if window.refresh_count != boundaries:
            raise AssertionError(f"window {window.names}: "
                                 f"{window.refresh_count} refreshes in "
                                 f"{steps} steps, not {boundaries}")
        first = SliceStream(window.num_examples, window.slice_size,
                            [settings.seed, stream, 0])
        initial = np.concatenate([first.next_ids()
                                  for _ in range(window.num_slices)])
        resident = window.resident_ids()
        if np.array_equal(resident, initial):
            raise AssertionError(f"window {window.names} never rotated")
        for name in window.names:
            got = data[name].cpu()
            want = torch.from_numpy(host[name][resident]).to(got.dtype)
            if not torch.equal(got, want):
                raise AssertionError(f"window {name} differs from the host "
                                     f"rows of its resident ids")
    log(f"window: {len(exp._windows)} windows of "
        f"{settings.crowd_hbm_window} of {settings.labeled_dataset_size} "
        f"images, {boundaries} refreshes each in {steps} steps (period "
        f"{period}: steps {list(range(period, steps, period))}), resident "
        f"ids moved, buffers equal to the host rows")


def tier_train_main_path(name, settings, dev, card: str) -> dict:
    """Phase 12, one run: ``CrowdExperiment(settings, device="cuda")
    .train()`` for ``settings.steps_to_run`` steps with validation every
    ``VALIDATION_PERIOD``: losses and validation scalars finite, the
    kernels launched as the model and the tier give (no sampler launch a
    step on the host tier; the label call on two channels with a kNN/iKNN
    target), the window run's windows checked (``_check_window``); then
    the inputs rebuilt (``train()`` closed them) and ``TIMED_STEPS``
    steps timed. The host time of every window refresh applied is
    logged."""
    import warnings

    from srgan_tpu_torch import CrowdExperiment
    from srgan_tpu_torch.apps import crowd as crowd_app
    from srgan_tpu_torch.data.window import HBMWindow
    before = trace.counters()
    channels, apply_s = [], []
    real_extract, real_apply = crowd_app.extract_patches, \
        HBMWindow._apply_staged

    def recording_extract(images, *args, **kwargs):
        channels.append(images.shape[-1])
        return real_extract(images, *args, **kwargs)

    def timed_apply(window):
        t0 = time.perf_counter()
        real_apply(window)
        apply_s.append(time.perf_counter() - t0)

    crowd_app.extract_patches = recording_extract
    HBMWindow._apply_staged = timed_apply
    try:
        exp = CrowdExperiment(settings, device=dev)
        steps = settings.steps_to_run
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state = exp.train()
        torch.cuda.synchronize()
        launches = counted_since(before)
        log(f"tier {name}: {steps} steps and {steps // VALIDATION_PERIOD} "
            f"validation passes through CrowdExperiment.train() in "
            f"{time.perf_counter() - t0:.1f} s (data set-up included); "
            f"kernel launches {json.dumps(launches)}; warnings "
            f"{[str(w.message)[:60] for w in caught]}")
        if state.step != steps:
            raise AssertionError(f"trained {state.step} steps, not {steps}")
        host = settings.crowd_host_pipeline
        rescale = bool(settings.crowd_rescale_factors)
        aux = settings.crowd_label_type != "density"
        d_norms = D_NORMS[settings.crowd_model]
        validations = steps // VALIDATION_PERIOD
        per_step = dict(zip(("group_norm_act_fwd", "group_norm_act_bwd",
                             "group_norm_act_second_order"),
                            crowd_norm_launches(d_norms)))
        per_step["extract_patches"] = 0 if host or rescale else 3
        per_step["extract_rescaled_patches"] = 3 if rescale else 0
        per_validation = crowd_launches_per_validation(d_norms)
        for kernel, count in per_step.items():
            want = count * steps + per_validation[kernel] * validations
            if launches[kernel] != want:
                raise AssertionError(
                    f"tier {name}: {kernel} launched {launches[kernel]} "
                    f"times, not {want} ({count} a step, "
                    f"{per_validation[kernel]} a validation pass)")
        two = channels.count(2)
        if two != (steps if aux else 0):
            raise AssertionError(f"tier {name}: {two} label calls on two "
                                 f"channels in {steps} steps")
        if host and not any("crowd_host_pipeline" in str(w.message)
                            for w in caught):
            raise AssertionError("the host tier did not warn")
        check_crowd_trial(exp.trial_directory, steps)
        if settings.crowd_hbm_window:
            _check_window(exp, settings, steps)
        trained_applies = len(apply_s)

        # Timed steps: train() closed the windows and the prefetchers.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            exp.prepare_train_step()
        epochs = exp.epoch_batch_iterators()
        stream = (batch for epoch in epochs for batch in epoch)
        for _ in range(2):
            exp.state, _ = exp._step(*next(stream))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            exp.state, metrics = exp._step(*next(stream))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError(f"tier {name} timed steps: {metrics}")
        out = {"ms_per_step": 1e3 * elapsed / TIMED_STEPS,
               "images_per_s": settings.batch_size * TIMED_STEPS / elapsed,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if apply_s:
            out["apply_ms"] = [round(1e3 * t, 3) for t in apply_s]
            out["applies_in_train"] = trained_applies
        log(f"time (tier {name}): {out['ms_per_step']:.2f} ms/step, "
            f"{out['images_per_s']:.2f} images/s (batch "
            f"{settings.batch_size}, {TIMED_STEPS} steps, {dev}: {card}), "
            f"peak allocated {out['peak_gib']:.2f} GiB"
            + (f"; window refreshes applied {len(apply_s)}, host ms each "
               f"{out['apply_ms']}" if apply_s else ""))
        exp.close()
    finally:
        crowd_app.extract_patches = real_extract
        HBMWindow._apply_staged = real_apply
    del exp, state, stream, epochs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def aux_cli_main_path(dev, raw_root: str, root: str) -> None:
    """Phase 12's command line: phase 7's raw database preprocessed with
    ``--label-type iknn`` (one density launch per image), then ``python
    -m srgan_tpu_torch crowd`` at the ``crowd_flagship`` preset with
    iKNN targets, JointDCNN and a window of 8 of the 16 training images:
    4 steps with checkpoints every 2 (the norm launches of JointDCNN
    asserted), then evaluate-only from the trial, whose validation MAE
    equals the trained one."""
    import contextlib
    import io
    import shutil

    from srgan_tpu_torch.data.crowd import CrowdDatabase
    from srgan_tpu_torch.data.crowd import main as preprocess
    shutil.rmtree(root, ignore_errors=True)
    db_dir = os.path.join(root, "db")
    before = trace.counters()
    t0 = time.perf_counter()
    for split in RAW_SPLITS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = preprocess([os.path.join(raw_root, split),
                             os.path.join(db_dir, f"{split}.npz"),
                             "--height", "384", "--width", "512", "--sigma",
                             "8", "--label-type", "iknn"])
        if rc != 0:
            raise AssertionError(f"preprocessing {split} returned {rc}")
    images = sum(RAW_SPLITS.values())
    density = counted_since(before, ["density_maps"])["density_maps"]
    if density != images:
        raise AssertionError(f"density kernel launched {density} times "
                             f"for {images}")
    labeled = CrowdDatabase.load(os.path.join(db_dir, "labeled.npz"))
    if labeled.label_type != "iknn" or labeled.aux_maps is None or \
            not np.isfinite(labeled.aux_maps).all():
        raise AssertionError("the iKNN database has no finite aux maps")
    log(f"aux cli preprocess: {images} images with --label-type iknn in "
        f"{time.perf_counter() - t0:.2f} s; density launches {density}")
    base = ["crowd", "--preset", "crowd_flagship", "--norm_impl=pallas",
            f"--crowd_database_path={db_dir}",
            f"--logs_directory={os.path.join(root, 'logs')}",
            "--trial_name=chip_smoke_aux_cli", "--summary_step_period=1",
            "--seed=0", "--crowd_label_type", "iknn", "--crowd_model",
            "jointdcnn", "--crowd_hbm_window", "8", "--crowd_window_slices",
            "4", "--crowd_window_refresh_period", "1"]
    before = trace.counters()
    t0 = time.perf_counter()
    first = _cli(base + ["--steps_to_run", "4", "--save_step_period", "2",
                         "--validation_step_period", "4"])
    _finite_metrics("aux cli train", first)
    # 4 steps, the validation pass at step 4, then the command line's
    # evaluate() and test(): D over 2 chunks of validation images and 1
    # of test images.
    fwd, bwd, second = crowd_norm_launches(D_NORMS["jointdcnn"])
    want = (4 * fwd + crowd_launches_per_validation(6)["group_norm_act_fwd"]
            + 6 * (2 + 1), 4 * bwd, 4 * second)
    got = tuple(counted_since(before, NORM_KERNELS).values())
    if got != want:
        raise AssertionError(f"aux cli: norm launches {got}, not {want}")
    trial = first["trial_directory"]
    checkpoints = sorted(os.listdir(os.path.join(trial, "checkpoints")))
    if checkpoints != ["step_2", "step_4"]:
        raise AssertionError(f"aux cli checkpoints {checkpoints}")
    log(f"aux cli train: 4 steps in {time.perf_counter() - t0:.1f} s, norm "
        f"launches {got}; {json.dumps(first)}")
    evaluated = _cli(base + ["--evaluate_only", "--load_model_path", trial])
    _finite_metrics("aux cli evaluate", evaluated)
    if not math.isclose(evaluated["validation"]["MAE"],
                        first["validation"]["MAE"], rel_tol=1e-3):
        raise AssertionError(f"aux cli evaluate-only MAE "
                             f"{evaluated['validation']['MAE']}, trained "
                             f"{first['validation']['MAE']}")
    log(f"aux cli evaluate: {json.dumps(evaluated)}")


# Phase 13, data parallelism on the one card. A world of 1 runs over
# NCCL; a world of 2 shares cuda:0 over gloo (NCCL refuses two ranks on
# one device), its collectives staged through the host, so its times are
# one card shared by two processes, not a speedup. DP_TINY: float32, an
# odd split (7 labeled and 5 unlabeled images over 2 ranks: local counts
# 4 and 3, 3 and 2) sharded; 2 steps, validation at the second. DP_WINDOW:
# the flagship widths at batch 120 (60 a rank), the database sharded and
# a window of 32 of 64 images (16 rows a rank, 4 slices, a refresh every
# 2 steps), rescale on; 4 steps, validation at the fourth.
DP_JOIN_S = 400
DP_TINY = dict(TINY, labeled_dataset_size=7, unlabeled_dataset_size=5,
               validation_dataset_size=3, crowd_shard_dataset=True,
               data_parallel_devices=2, steps_to_run=2,
               summary_step_period=1, validation_step_period=2)
DP_WINDOW = dict(FLAGSHIP, trial_name="chip_smoke_dp", norm_impl="pallas",
                 crowd_shard_dataset=True, data_parallel_devices=2,
                 labeled_dataset_size=64, unlabeled_dataset_size=64,
                 crowd_hbm_window=32, crowd_window_slices=4,
                 crowd_window_refresh_period=2,
                 crowd_rescale_factors=RESCALE,
                 steps_to_run=4, summary_step_period=1,
                 validation_step_period=4)
DP_TIMED_STEPS = 3
DP_DRAWS_CHECKED = 200
DP_REDUCE_REPEATS = 5


def _gradient_reduce_ms(experiment) -> float:
    """The host time of one step's three gradient averages (D, G, the
    DNN: ``average_gradients`` on their last gradients), the card
    synchronized before and after, the least of ``DP_REDUCE_REPEATS``."""
    from srgan_tpu_torch.parallel.mesh import average_gradients
    state = experiment.state
    grads = [[p.grad for p in opt.params]
             for opt in (state.d_opt, state.g_opt, state.dnn_opt)]
    best = math.inf
    for _ in range(DP_REDUCE_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in grads:
            average_gradients(g, experiment.data_parallel)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def dp_train_action(experiment, timed_steps: int) -> dict:
    """A rank of phase 13: ``train()`` with its launches counted (from
    just before), a sharded window's buffers checked against the host rows
    of its ids, then ``timed_steps`` more steps timed (ms/step between
    synchronizations), the peak allocated memory and the gradient
    all-reduce's ms a step."""
    before = trace.counters()
    torch.cuda.reset_peak_memory_stats()
    state = experiment.train()
    torch.cuda.synchronize()
    out = {"launches": counted_since(before), "step": state.step}
    host = {"labeled_images": experiment.labeled_db.images,
            "labeled_density": experiment._stacked_labels(),
            "unlabeled_images": experiment.unlabeled_db.images}
    for window in experiment._windows:
        for name in window.names:
            got = experiment._device_data[name].cpu()
            want = torch.from_numpy(host[name][window.local_ids()])
            if not torch.equal(got, want.to(got.dtype)):
                raise AssertionError(f"rank {experiment.data_parallel.rank}"
                                     f": window {name} differs from the "
                                     f"host rows of its ids")
    out["windows"] = [(w.refresh_count, len(w.local_ids()))
                      for w in experiment._windows]
    experiment.prepare_train_step()  # train() closed the inputs
    stream = (b for epoch in experiment.epoch_batch_iterators()
              for b in epoch)
    for _ in range(2):
        experiment.state, _ = experiment._step(*next(stream))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        experiment.state, metrics = experiment._step(*next(stream))
    torch.cuda.synchronize()
    out["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / timed_steps
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"timed steps: losses {metrics}")
    out["reduce_ms"] = _gradient_reduce_ms(experiment)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    experiment.close()
    return out


def dp_tiny_action(experiment) -> dict:
    """A rank of phase 13's float32 run: ``train()`` with every step's
    global batch gathered from the ranks and its metrics kept; then the
    models, and ``DP_DRAWS_CHECKED`` steps of fresh draws checked below
    the rank's true counts (no cyclic-pad duplicate drawn)."""
    from srgan_tpu_torch.parallel.mesh import gather_rows
    dp = experiment.data_parallel
    step = experiment._step
    batches, metrics = [], []

    def recording(*batch):
        batches.append([gather_rows(t.contiguous(), dp).cpu()
                        for t in batch])
        experiment.state, m = step(*batch)
        metrics.append({k: float(v) for k, v in m.items()})
        return experiment.state, m

    experiment._step = recording
    state = experiment.train()
    args = experiment._patch_args_stream()
    draws = [next(args) for _ in range(DP_DRAWS_CHECKED)]
    bounds = (int(experiment._labeled_local_counts[dp.rank]),
              int(experiment._unlabeled_local_counts[dp.rank]))
    highest = (max(int(d[0].max()) for d in draws),
               max(int(d[4].max()) for d in draws))
    if not (highest[0] < bounds[0] and highest[1] < bounds[1]):
        raise AssertionError(f"rank {dp.rank}: local indices up to "
                             f"{highest}, true counts {bounds}")
    experiment.close()
    return {"batches": batches, "metrics": metrics, "step": state.step,
            "models": {name: {k: v.detach().cpu() for k, v in
                              getattr(state, name).state_dict().items()}
                       for name in ("d", "g", "dnn")},
            "bounds": bounds, "highest": highest}


def _cancelled_biases(module) -> set:
    """The conv biases of ``module`` right before a GroupNorm of one
    channel per group (G's ``norms[0]`` follows its dense layer)."""
    norms = getattr(module, "norms", None)
    out = set()
    for kind, shift in (("convs", 0), ("deconvs", 1)):
        for i, _ in enumerate(getattr(module, kind, ())):
            j = i + shift
            if norms is not None and j < len(norms) and \
                    norms[j].num_groups == norms[j].scale.numel():
                out.add(f"{kind}.{i}.bias")
    return out


def dp_gloo_action(experiment, window_settings, window_trial: str):
    """A rank of phase 13 (b), one process for both runs: the float32
    run (``dp_tiny_action``), then the flagship widths' sharded run
    (``dp_train_action``) as a second experiment in the same group."""
    from srgan_tpu_torch import CrowdExperiment
    tiny = dp_tiny_action(experiment)
    window = CrowdExperiment(window_settings,
                             data_parallel=experiment.data_parallel)
    window.given_trial_directory = window_trial
    return tiny, dp_train_action(window, DP_TIMED_STEPS)


def _written_once(trial_directory: str) -> None:
    """Rank 0 alone writes: every (tag, step) once in each scalars.jsonl."""
    for sub in ("GAN", "DNN"):
        with open(os.path.join(trial_directory, sub, "scalars.jsonl")) as f:
            keys = [(r["tag"], r["step"]) for r in map(json.loads, f)]
        if len(keys) != len(set(keys)):
            raise AssertionError(f"{trial_directory}/{sub}: a scalar "
                                 f"written twice")


def _dp_launches(launches: dict, per_step: dict, steps: int,
                 validations: int, what: str) -> None:
    per_validation = LAUNCHES_PER_VALIDATION
    for name, count in per_step.items():
        want = count * steps + per_validation[name] * validations
        if launches[name] != want:
            raise AssertionError(f"{what}: {name} launched {launches[name]}"
                                 f" times, not {want}")


def dp_main_path(dev, logs: str, card: str, pallas_ms: float) -> dict:
    """Phase 13: (a) the flagship "pallas" config on a world of 1 over
    NCCL through the launcher; (b) on a world of 2 over gloo on this card,
    the float32 run held to one rank on the same global batches and the
    flagship widths with a sharded database and window. Every rank's
    launches asserted; a failed rank fails the phase."""
    from srgan_tpu_torch import CrowdExperiment, Settings
    from srgan_tpu_torch.parallel.launch import run_experiment
    from srgan_tpu_torch.train import (init_train_state, make_gan_train_step,
                                       set_float32_precision)
    from srgan_tpu_torch.utils.seeding import generator_for
    from srgan_tpu_torch.utils.summary import make_trial_directory
    gc.collect()
    torch.cuda.empty_cache()
    out = {}

    def ranks(settings, devices, action, *args):
        trial = make_trial_directory(settings)
        t0 = time.perf_counter()
        results = run_experiment(CrowdExperiment, settings, devices,
                                 action=action, action_args=args,
                                 trial_directory=trial, timeout_s=DP_JOIN_S)
        return trial, results, time.perf_counter() - t0

    # Both (b) runs in one launch: a rank's start takes seconds.
    window_settings = Settings(**dict(DP_WINDOW, logs_directory=logs))
    window_trial = make_trial_directory(window_settings)

    # (a) a world of 1 over NCCL
    settings = Settings(**dict(
        FLAGSHIP, logs_directory=logs, trial_name="chip_smoke_nccl1",
        norm_impl="pallas", data_parallel_devices=1, steps_to_run=STEPS,
        summary_step_period=1, validation_step_period=VALIDATION_PERIOD))
    trial, (got,), seconds = ranks(settings, [dev], dp_train_action,
                                   TIMED_STEPS)
    per_step = {"extract_patches": 3, "extract_rescaled_patches": 0,
                "group_norm_act_fwd": NORM_LAUNCHES_PER_STEP["fwd"],
                "group_norm_act_bwd": NORM_LAUNCHES_PER_STEP["bwd"],
                "group_norm_act_second_order":
                    NORM_LAUNCHES_PER_STEP["second_order"]}
    _dp_launches(got["launches"], per_step, STEPS,
                 STEPS // VALIDATION_PERIOD, "world of 1")
    check_crowd_trial(trial, STEPS)
    _written_once(trial)
    out["nccl_world_1"] = dict(
        ms_per_step=got["ms_per_step"], pallas_ms_per_step=pallas_ms,
        ratio=got["ms_per_step"] / pallas_ms, peak_gib=got["peak_gib"],
        reduce_ms=got["reduce_ms"], launches=got["launches"],
        seconds=seconds)
    log(f"data parallel (a), a world of 1 over NCCL: {STEPS} steps through "
        f"the launcher in {seconds:.1f} s (the rank's start included), "
        f"launches {json.dumps(got['launches'])}; "
        f"{got['ms_per_step']:.2f} ms/step ({TIMED_STEPS} steps) against "
        f"phase 6's \"pallas\" step {pallas_ms:.2f} ms/step "
        f"({got['ms_per_step'] / pallas_ms:.4f}x), peak allocated "
        f"{got['peak_gib']:.2f} GiB, gradient all-reduce "
        f"{got['reduce_ms']:.3f} ms a step ({dev}: {card})")

    # (b) a world of 2 over gloo on this card: float32, held to one rank
    settings = Settings(**dict(DP_TINY, logs_directory=logs,
                               trial_name="chip_smoke_gloo2_fp32"))
    trial, ranks_out, seconds = ranks(settings, [dev, dev], dp_gloo_action,
                                      window_settings, window_trial)
    (a, window_a), (b, window_b) = ranks_out
    for name in ("d", "g", "dnn"):
        for k, v in a["models"][name].items():
            if not torch.equal(v, b["models"][name][k]):
                raise AssertionError(f"world of 2: rank 1's {name} {k} "
                                     f"differs from rank 0's")
    if a["metrics"] != b["metrics"]:
        raise AssertionError("world of 2: the ranks' metrics differ")
    set_float32_precision()
    one = CrowdExperiment(settings.copy(data_parallel_devices=1),
                          device=dev)
    one.models = one.model_setup()
    state = init_train_state(one.settings, one.models)
    step = make_gan_train_step(one.settings,
                               labeled_loss_fn=one.labeled_loss_fn(),
                               latent_shape=one.latent_shape())
    rng = generator_for(settings.seed, "train", dev)
    worst = 0.0
    for i, (batch, want) in enumerate(zip(a["batches"], a["metrics"])):
        x, y, u = (t.to(dev) for t in batch)
        state, metrics = step(state, x.contiguous(
            memory_format=torch.channels_last), y, u.contiguous(
            memory_format=torch.channels_last), rng)
        for k, v in want.items():
            got = float(metrics[k])
            worst = max(worst, abs(got - v) / max(abs(v), 1e-6))
            if not math.isclose(got, v, rel_tol=2e-4, abs_tol=2e-5):
                raise AssertionError(f"world of 2, step {i}: {k} {v} on 2 "
                                     f"ranks, {got} on one")
    lr, steps = settings.learning_rate, settings.steps_to_run
    moved = 0.0
    for name in ("d", "g", "dnn"):
        module = getattr(state, name)
        ours = module.state_dict()
        cancelled = _cancelled_biases(getattr(module, "model", module))
        for k, v in a["models"][name].items():
            err = float((ours[k].cpu() - v).abs().max())
            # A conv bias a one-channel GroupNorm cancels has a
            # noise-level gradient, whose Adam step of ±lr may take either
            # sign: it may differ by 2·lr a step.
            tol = (2 * lr * steps if k in cancelled
                   else 2e-5 + 2e-4 * float(v.abs().max()))
            if k not in cancelled:
                moved = max(moved, err)
            if err > tol:
                raise AssertionError(f"world of 2: {name} {k} differs from "
                                     f"one rank's by {err}")
    losses = read_scalars(trial)
    if sorted(s for s, v in losses["GAN"].items()
              if "d_total_loss" in v) != list(range(steps)):
        raise AssertionError(
            f"world of 2: summaries {sorted(losses['GAN'])}")
    check_validation(trial, [steps])
    _written_once(trial)
    log(f"data parallel (b), a world of 2 over gloo on {dev}, float32, "
        f"sharded odd split: {steps} steps, and the run below, in "
        f"{seconds:.1f} s (the ranks' start included); ranks' "
        f"models bit-equal; one rank on the same global batches and "
        f"draws: metrics within {worst:.2e} (relative), models within "
        f"{moved:.2e} (cancelled biases aside); local indices of "
        f"{DP_DRAWS_CHECKED} steps of draws up to "
        f"{a['highest']}/{b['highest']} below the true counts "
        f"{a['bounds']}/{b['bounds']}")

    # (b) the flagship widths, sharded database and window, rescale
    ranks_out = [window_a, window_b]
    per_step = {"extract_patches": 0, "extract_rescaled_patches": 3,
                "group_norm_act_fwd": NORM_LAUNCHES_PER_STEP["fwd"],
                "group_norm_act_bwd": NORM_LAUNCHES_PER_STEP["bwd"],
                "group_norm_act_second_order":
                    NORM_LAUNCHES_PER_STEP["second_order"]}
    steps = window_settings.steps_to_run
    for r, got in enumerate(ranks_out):
        _dp_launches(got["launches"], per_step, steps, 1, f"rank {r}")
        if got["windows"] != [(steps // 2 - 1, 16)] * 2:
            raise AssertionError(f"rank {r}: windows {got['windows']}")
    check_crowd_trial(window_trial, steps)
    _written_once(window_trial)
    out["gloo_world_2"] = dict(
        ms_per_step=[g["ms_per_step"] for g in ranks_out],
        peak_gib=[g["peak_gib"] for g in ranks_out],
        reduce_ms=[g["reduce_ms"] for g in ranks_out],
        launches=[g["launches"] for g in ranks_out], seconds=seconds)
    log(f"data parallel (b), a world of 2 over gloo on {dev}, flagship "
        f"widths, batch 120 (60 a rank), sharded database, window 32 of 64 "
        f"(16 rows a rank), rescale: {steps} steps; "
        f"launches a rank {json.dumps(ranks_out[0]['launches'])}; "
        + "; ".join(f"rank {r}: {g['ms_per_step']:.2f} ms/step "
                    f"({DP_TIMED_STEPS} steps), peak allocated "
                    f"{g['peak_gib']:.2f} GiB, gradient all-reduce "
                    f"{g['reduce_ms']:.2f} ms a step"
                    for r, g in enumerate(ranks_out)) + f" ({card})")
    return out


# Phase 14, steps_per_dispatch. (a) A tiny float32 config on the card, at
# base width 16 and batch 8: DISPATCH_CHUNKS chunks of DISPATCH_K steps
# (eager, capture and replay, replay) and one eager step, against single
# eager steps from the same state, arguments and generator seed. cuDNN's
# deterministic algorithms in both runs, so that bit-equality is the
# expected result (the tolerance: 0). The first step of a configuration in
# a process may take another path than every later one (at K = 1, without
# a graph: 1 ulp in D's first weight gradient under "xla"), so a
# throwaway step of the configuration runs before both compared runs.
DISPATCH_K = 4
DISPATCH_CHUNKS = 3
DISPATCH_TINY = dict(TINY, batch_size=8, model_base_width=16, mean_offset=0.5,
                     steps_per_dispatch=DISPATCH_K)
# (b) train() at the flagship "pallas" config: K = 2 and 4, K = 2 with the
# window tier (phase 12's window: refresh period 2), and K = 2 on a world
# of 1 over NCCL; the last chunk traced (profile_step_range).
DISPATCH_WINDOW = dict(CROWD_TIER_RUNS)["window"]
DISPATCH_RUNS = [("K=2", dict(steps_per_dispatch=2)),
                 ("K=4", dict(steps_per_dispatch=4)),
                 ("window, K=2", dict(DISPATCH_WINDOW, steps_per_dispatch=2))]
# (c) TIMED_STEPS steps at K = 1, 2 and 4 in the flagship "pallas" config
# and a small one whose step the host paces (batch 8, 64-px patches, base
# width 16, bfloat16).
DISPATCH_KS = (1, 2, 4)
DISPATCH_SMALL = dict(batch_size=8, image_patch_size=64, model_base_width=16)
# Kernel names in a Chrome trace (csrc/patches.cu, csrc/fused_norm.cu).
TRACE_KERNELS = {"extract_patches": "::sampler_kernel<",
                 "group_norm_act_fwd": "::fwd_kernel<",
                 "group_norm_act_bwd": "::bwd_kernel<",
                 "group_norm_act_second_order": "::second_order_kernel<"}


def _manual_crowd(settings, dev):
    """A crowd experiment ready to step, without train(): data, models,
    the state and the input pipeline (and the chunk when K > 1)."""
    from srgan_tpu_torch import CrowdExperiment
    from srgan_tpu_torch.train import init_train_state
    exp = CrowdExperiment(settings, device=dev)
    exp.dataset_setup()
    exp.models = exp.model_setup()
    exp.state = init_train_state(settings, exp.models)
    exp.prepare_train_step()
    return exp


def _single_step(exp, args):
    data = exp._device_data
    batch = exp._sample_batch(data["labeled_images"], data["labeled_density"],
                              data["unlabeled_images"], *next(args))
    exp.state, metrics = exp._train_step(exp.state, *batch, exp._rng)
    return metrics


def _trained_state(exp):
    """{name: tensor} of the models' state and Adam's state, on the host."""
    out = {}
    for name in ("d", "g", "dnn"):
        for k, v in getattr(exp.state, name).state_dict().items():
            out[f"{name}.{k}"] = v.detach().cpu()
        opt = getattr(exp.state, f"{name}_opt")
        for i, p in enumerate(opt.params):
            for k, v in opt.adam.state[p].items():
                out[f"{name}_opt.{i}.{k}"] = v.detach().cpu()
    return out


def dispatch_correctness(dev, norm_impl, factors=()) -> dict:
    """Phase 14 (a): chunks of ``DISPATCH_K`` steps (eager, capture and
    replay, replay) and one eager step against single eager steps from the
    same state, arguments and generator seed: every step's metrics, the
    final models and Adam's state, and the generator, bit for bit; the
    z_d each replay drew (read off a copy of the generator at its start)
    differ; one capture and two replays."""
    from srgan_tpu_torch import Settings
    from srgan_tpu_torch.train import set_float32_precision
    from srgan_tpu_torch.utils.mixture import sample_offset_normal
    set_float32_precision()
    settings = Settings(norm_impl=norm_impl, crowd_rescale_factors=factors,
                        **DISPATCH_TINY)
    what = f"{norm_impl}{', rescale' if factors else ''}"
    k = DISPATCH_K
    steps = k * DISPATCH_CHUNKS + 1
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        warm = _manual_crowd(settings, dev)
        _single_step(warm, warm._patch_args_stream())
        warm.close()
        ref = _manual_crowd(settings, dev)
        args = ref._patch_args_stream()
        want = [{n: v.cpu() for n, v in _single_step(ref, args).items()}
                for _ in range(steps)]
        exp = _manual_crowd(settings, dev)
        args = exp._patch_args_stream()
        before = trace.counters()
        got, z = [], []
        shape = (settings.batch_size, settings.latent_dimension)
        for _ in range(DISPATCH_CHUNKS):
            probe = torch.Generator(dev)
            probe.set_state(exp._rng.get_state())
            z.append(sample_offset_normal(probe, shape, settings.mean_offset))
            metrics = exp.dispatch_chunk(args)
            got += [{n: v[i].cpu() for n, v in metrics.items()}
                    for i in range(k)]
        got.append({n: v.cpu() for n, v in _single_step(exp, args).items()})
        torch.cuda.synchronize()
        counts = tuple(counted_since(before, ["TrainChunk.captures",
                                              "TrainChunk.replays"]
                                     ).values())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if counts != (1, DISPATCH_CHUNKS - 1):
        raise AssertionError(f"dispatch (a) {what}: (captures, replays) "
                             f"{counts}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        for name, v in b.items():
            worst = max(worst, float((a[name] - v).abs()))
            if not torch.equal(a[name], v):
                raise AssertionError(
                    f"dispatch (a) {what}: step {i} {name} {float(a[name])}"
                    f" in chunks, {float(v)} in single steps")
    mine, theirs = _trained_state(exp), _trained_state(ref)
    state_err = max(float((mine[n].float() - v.float()).abs().max())
                    for n, v in theirs.items())
    differ = [n for n, v in theirs.items() if not torch.equal(mine[n], v)]
    if differ or set(mine) != set(theirs):
        raise AssertionError(f"dispatch (a) {what}: {len(differ)} state "
                             f"tensors differ, first {differ[:4]}")
    if not torch.equal(exp._rng.get_state(), ref._rng.get_state()):
        raise AssertionError(f"dispatch (a) {what}: the generators differ")
    z_step = float((z[2] - z[1]).abs().max())
    if not z_step > 0:
        raise AssertionError(f"dispatch (a) {what}: the replays drew the "
                             f"same z_d")
    log(f"dispatch (a), {what}, float32, K={k}: {DISPATCH_CHUNKS} chunks "
        f"(eager, capture + replay, replay) and one eager step against "
        f"{steps} single eager steps: every metric, {len(theirs)} model "
        f"and Adam tensors and the generator bit-equal (tolerance 0; "
        f"largest difference: metrics {worst:g}, state {state_err:g}); "
        f"captures {counts[0]}, replays {counts[1]}; the two replays' z_d "
        f"differ by up to {z_step:.4f}")
    for e in (exp, ref):
        e.close()
    return {"metrics_max_diff": worst, "state_max_diff": state_err,
            "replay_z_max_diff": z_step}


def dispatch_action(experiment) -> dict:
    """A run of phase 14 (b) (a rank's, or this process's): ``train()``
    with the kernels' launches and the chunk's captures and replays
    counted from just before."""
    before = trace.counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = experiment.train()
    torch.cuda.synchronize()
    chunks = counted_since(before, ["TrainChunk.captures",
                                    "TrainChunk.replays"])
    return {"launches": counted_since(before),
            "captures": chunks["TrainChunk.captures"],
            "replays": chunks["TrainChunk.replays"],
            "step": state.step, "seconds": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _trace_kernels(path: str) -> dict:
    """Launches of the samplers and the norm kernels in a Chrome trace, by
    kernel table name (the fixed and rescale samplers are one kernel)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {kernel: sum(marker in n for n in names)
            for kernel, marker in TRACE_KERNELS.items()}


def dispatch_train_main_path(name, settings, dev, card: str,
                             world: bool = False) -> dict:
    """Phase 14 (b), one run: ``CrowdExperiment(settings, device="cuda")
    .train()`` (``world``: on a world of 1 over NCCL through the
    launcher) at K = ``steps_per_dispatch``, ``STEPS`` steps with
    validation every ``VALIDATION_PERIOD``: the losses finite and written
    at the chunks' first steps, the validation scalars finite, each
    kernel launched K times a step's count a chunk (and a validation
    pass's), one capture and a replay for every chunk after the first
    two; the last chunk, a replay, traced under ``torch.profiler``, its
    kernels counted by name against K times a step's."""
    from srgan_tpu_torch import CrowdExperiment
    from srgan_tpu_torch.parallel.launch import run_experiment
    from srgan_tpu_torch.utils.summary import make_trial_directory
    gc.collect()
    torch.cuda.empty_cache()
    k = settings.steps_per_dispatch
    steps = settings.steps_to_run
    if world:
        trial = make_trial_directory(settings)
        (got,) = run_experiment(CrowdExperiment, settings, [dev],
                                action=dispatch_action,
                                trial_directory=trial, timeout_s=DP_JOIN_S)
    else:
        exp = CrowdExperiment(settings, device=dev)
        got = dispatch_action(exp)
        trial = exp.trial_directory
        if settings.crowd_hbm_window:
            _check_window(exp, settings, steps)
        del exp
    rescale = bool(settings.crowd_rescale_factors)
    per_step = {"extract_patches": 0 if rescale else 3,
                "extract_rescaled_patches": 3 if rescale else 0,
                "group_norm_act_fwd": NORM_LAUNCHES_PER_STEP["fwd"],
                "group_norm_act_bwd": NORM_LAUNCHES_PER_STEP["bwd"],
                "group_norm_act_second_order":
                    NORM_LAUNCHES_PER_STEP["second_order"]}
    _dp_launches(got["launches"], per_step, steps, steps // VALIDATION_PERIOD,
                 f"dispatch (b) {name}")
    if got["step"] != steps or (got["captures"], got["replays"]) != (
            1, steps // k - 1):
        raise AssertionError(f"dispatch (b) {name}: step {got['step']}, "
                             f"(captures, replays) ({got['captures']}, "
                             f"{got['replays']})")
    scalars = read_scalars(trial)
    for step in range(steps):
        values = {t: v for sub in ("GAN", "DNN")
                  for t, v in scalars[sub].get(step, {}).items()
                  if not t.startswith("validation/")}
        if len(values) != (7 if step % k == 0 else 0) or not all(
                map(math.isfinite, values.values())):
            raise AssertionError(f"dispatch (b) {name}: step {step}'s "
                                 f"summaries {values}")
    check_validation(trial, range(VALIDATION_PERIOD, steps + 1,
                                  VALIDATION_PERIOD))
    start, end = settings.profile_step_range
    traced = _trace_kernels(os.path.join(trial, "profile",
                                         f"steps_{start}_{end}.json"))
    want = {"extract_patches": k * 3, **{
        kernel: k * per_step[kernel] for kernel in (
            "group_norm_act_fwd", "group_norm_act_bwd",
            "group_norm_act_second_order")}}
    # CUPTI drops kernel records, at a replay's start or in its middle,
    # once a process has run several profiler sessions (seen from the
    # seventh on): the world of 1's rank, a fresh process, is held to the
    # counters exactly; a trace never shows more than they count.
    if (traced != want if world
            else any(traced[k] > v for k, v in want.items())):
        raise AssertionError(f"dispatch (b) {name}: the traced replay ran "
                             f"{traced}, the counters say {want}")
    log(f"dispatch (b), {name}{' on a world of 1 over NCCL' if world else ''}"
        f": {steps} steps and {steps // VALIDATION_PERIOD} validation passes"
        f" through train() in {got['seconds']:.1f} s, kernel launches "
        f"{json.dumps(got['launches'])} ({k} steps' a chunk), captures "
        f"{got['captures']}, replays {got['replays']}, summaries at steps "
        f"{sorted(s for s, v in scalars['GAN'].items() if 'g_loss' in v)}, "
        f"peak allocated {got['peak_gib']:.2f} GiB; the traced replay "
        f"(steps {start}-{end - 1}) ran {json.dumps(traced)} by name, the "
        f"counters {json.dumps(want)}"
        f"{' (held exactly: a fresh process)' if world else ''} "
        f"({dev}: {card})")
    return dict(got, traced=traced)


def _busy(prof) -> tuple:
    """(busy ms, span ms) of the card under ``prof``: the union of its
    operations' intervals (kernels, copies, sets; cuDNN's side streams
    overlap, so a sum would count some twice), and the span from the
    first operation's start to the last one's end. The card's copies of
    host annotations (the program's spans, Adam's ``Optimizer.step``)
    span whole phases and are no operation: they are left out."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, (end - spans[0][0]) / 1e3


def dispatch_timed(name, settings, dev, card: str) -> dict:
    """Phase 14 (c), one run: ``TIMED_STEPS`` steps at K =
    ``steps_per_dispatch`` between synchronizations (K = 1: single steps),
    after the first chunk (timed: the eager warm-up), the second (the
    capture, timed alone, and its replay) and two more; the host's ms a
    chunk call; then ``PROFILED_STEPS`` or more steps, whole chunks, under
    ``torch.profiler``: the card's busy share (``_busy``); the peak
    allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k = settings.steps_per_dispatch
    exp = _manual_crowd(settings, dev)
    args = exp._patch_args_stream()
    capture_s = []
    if k > 1:
        chunk = exp._train_chunk
        real_capture = chunk._capture

        def timed_capture():
            t0 = time.perf_counter()
            graph = real_capture()
            torch.cuda.synchronize()
            capture_s.append(time.perf_counter() - t0)
            return graph

        chunk._capture = timed_capture
        advance = functools.partial(exp.dispatch_chunk, args)
    else:
        advance = functools.partial(_single_step, exp, args)

    def synchronized():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    first_ms = synchronized()
    second_ms = synchronized()
    for _ in range(2):
        advance()
    torch.cuda.synchronize()
    calls = TIMED_STEPS // k
    host = 0.0
    t0 = time.perf_counter()
    for _ in range(calls):
        t1 = time.perf_counter()
        metrics = advance()
        host += time.perf_counter() - t1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if not all(bool(torch.isfinite(v).all()) for v in metrics.values()):
        raise AssertionError(f"dispatch (c) {name}: losses {metrics}")
    profiled = -(-PROFILED_STEPS // k)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(profiled):
            advance()
        torch.cuda.synchronize()
    busy_ms, span_ms = _busy(prof)
    out = {"ms_per_step": 1e3 * elapsed / TIMED_STEPS,
           "images_per_s": settings.batch_size * TIMED_STEPS / elapsed,
           "host_ms_per_call": 1e3 * host / calls,
           "busy_ms_per_step": busy_ms / (profiled * k),
           "busy": busy_ms / span_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first_chunk_ms": first_ms, "second_chunk_ms": second_ms,
           "capture_ms": 1e3 * capture_s[0] if capture_s else None}
    log(f"dispatch (c), {name}, K={k}: {out['ms_per_step']:.3f} ms/step, "
        f"{out['images_per_s']:.1f} images/s (batch {settings.batch_size}, "
        f"{TIMED_STEPS} steps), host {out['host_ms_per_call']:.3f} ms a "
        f"{'chunk' if k > 1 else 'step'} call; under torch.profiler "
        f"({profiled * k} steps) the card is busy "
        f"{out['busy_ms_per_step']:.3f} ms a step, {100 * out['busy']:.1f}% "
        f"of the span from its first operation to its last; peak allocated "
        f"{out['peak_gib']:.2f} GiB; first {'chunk' if k > 1 else 'step'} "
        f"{first_ms:.1f} ms, second {second_ms:.1f} ms"
        + (f" (its capture {out['capture_ms']:.1f} ms)" if capture_s else "")
        + f" ({dev}: {card})")
    exp.close()
    del exp, metrics, advance
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dispatch_main_path(dev, logs: str, card: str) -> dict:
    """Phase 14: ``steps_per_dispatch`` (a) held bit for bit to single
    steps on a tiny float32 config, (b) through ``train()`` at the
    flagship widths, (c) timed at K = 1, 2 and 4."""
    from srgan_tpu_torch import Settings
    out = {"correctness": {
        "xla": dispatch_correctness(dev, "xla"),
        "pallas, rescale": dispatch_correctness(dev, "pallas", RESCALE)}}
    base = dict(FLAGSHIP, logs_directory=logs, norm_impl="pallas",
                steps_to_run=STEPS, validation_step_period=VALIDATION_PERIOD)
    runs = [(name, over, False) for name, over in DISPATCH_RUNS]
    runs.append(("world of 1, K=2", dict(steps_per_dispatch=2), True))
    out["train"] = {}
    for name, over, world in runs:
        k = over["steps_per_dispatch"]
        settings = Settings(**dict(
            base, trial_name=f"chip_smoke_dispatch_k{k}",
            summary_step_period=k, profile_step_range=(STEPS - k, STEPS),
            **over))
        out["train"][name] = dispatch_train_main_path(name, settings, dev,
                                                      card, world)
    out["time"] = {}
    for config, over in (("flagship", {}), ("small", DISPATCH_SMALL)):
        for k in DISPATCH_KS:
            settings = Settings(**dict(base, steps_per_dispatch=k, **over))
            out["time"][f"{config}, K={k}"] = dispatch_timed(
                config, settings, dev, card)
    return out


# Phase 15, tensor parallelism (model_parallel_devices = 2): a grid of
# data 1 × model 2 on this card, cuda:0 named twice, over gloo (NCCL
# refuses two ranks on one device). Every model-axis collective is then
# staged through the host, so the times are one card shared by two
# processes plus the host's copies, not a speedup. One launch runs, in
# each rank: (c) one layer whose norm groups straddle the ranks (conv 3 →
# 96, GroupNorm of 3 groups + LeakyReLU, conv 96 → 6, float32) against
# its unsharded self, forward and double backward; (a) TP_TINY (float32,
# DP_TINY's models, K = 1) under "xla", under "pallas" and under "xla"
# with the gradient clipped at TP_CLIP, 4 steps each, the full models and
# Adam's moments gathered after every step (the first step's record its
# averaged and clipped gradient, which the parameters after Adam's first
# step do not show: it moves each by about lr·sign(g)); (b) the flagship
# widths under "pallas" (bf16, JointCNN, 224-px patches, latent 100) at
# batch 8 a step: the batch is cut from 120 so that gloo's host-staged
# collectives fit the script's time. 4 steps and a validation pass
# through train(), every rank's launches asserted, then timed steps, the
# peak allocated memory and, in one more step with the card synchronized
# around each model-axis collective, their host ms and the shapes at
# which the norm kernels ran.
TP_TINY = dict(DP_TINY, crowd_shard_dataset=False, data_parallel_devices=1,
               model_parallel_devices=2, steps_to_run=4,
               validation_step_period=4)
# Below every model's gradient norm at TP_TINY's first step, so that the
# clip acts in each (_tp_held_to_one_rank asserts it).
TP_CLIP = 0.5
TP_TINY_RUNS = {"xla": dict(norm_impl="xla"),
                "pallas": dict(norm_impl="pallas"),
                "xla-clip": dict(norm_impl="xla",
                                 gradient_clip_norm=TP_CLIP)}
TP_BATCH = 8
TP_FLAGSHIP = dict(FLAGSHIP, trial_name="chip_smoke_tp", norm_impl="pallas",
                   batch_size=TP_BATCH, model_parallel_devices=2,
                   steps_to_run=4, summary_step_period=1,
                   validation_step_period=4)
TP_TIMED_STEPS = 3
# Every norm of the flagship step on a rank of the 1 × 2 grid at batch 8:
# NORM_SHAPES' launches at B = 3·8 and 8, C/2 channels, 16 groups (G's
# first norm too: its Dense's features are gathered before the reshape,
# and the norm takes this rank's channels of them).
TP_NORM_SHAPES = [(3 * TP_BATCH if b == 360 else TP_BATCH, hw, c // 2,
                   slope, fwd, bwd)
                  for b, hw, c, slope, fwd, bwd in NORM_SHAPES]
# tests/torch_dp_workers.py's Block: conv 3 → 96, GroupNorm of 3 groups
# (a group straddles the two ranks' 48 channels), conv 96 → 6.
TP_STRADDLE = dict(cin=3, width=96, cout=6, groups=3)
# The straddling layer against its unsharded self on the card: float32
# convolutions of a block of output channels may take another cuDNN
# algorithm than the whole convolution.
TP_STRADDLE_RTOL = 1e-4


def tp_straddle(dp, impl: str) -> dict:
    """Phase 15 (c) on a rank: the straddling layer sharded and whole on
    the same input, for ``impl`` (``tests/torch_dp_workers.py``'s
    ``tp_block``, which imports no JAX): the largest relative error of
    each tensor, and the sharded norm's groups and channels."""
    import torch_dp_workers as workers
    got = workers.tp_block(dp, impl=impl, seed=5, device=str(dp.device),
                           **TP_STRADDLE)

    def flat(tree):
        return dict({k: v for k, v in tree.items() if k != "grads"},
                    **tree["grads"])

    want, ours = flat(got["want"]), flat(got["got"])
    errors = {k: float((ours[k] - w).abs().max()
                       / max(float(w.abs().max()), 1e-30))
              for k, w in want.items()}
    return {"errors": errors, "groups": got["local_groups"],
            "local_channels": got["local_width"]}


def tp_tiny_action(experiment) -> dict:
    """Phase 15 (a) on a rank: ``train()`` with every step's batch, its
    metrics and the full models and Adam moments after it (gathered over
    the model ranks) kept."""
    from srgan_tpu_torch.parallel import tp
    step = experiment._step
    record = []

    def moments(opt):
        return {i: {k: entry[k].cpu() for k in ("exp_avg", "exp_avg_sq")}
                for i, entry in tp.full_optimizer_state(
                    opt.adam, opt.params).items()}

    def recording(*batch):
        experiment.state, metrics = step(*batch)
        state = experiment.state
        record.append({
            "batch": [t.cpu() for t in batch],
            "metrics": {k: float(v) for k, v in metrics.items()},
            "models": {name: {k: v.cpu() for k, v in tp.full_state_dict(
                getattr(state, name)).items()}
                for name in ("d", "g", "dnn")},
            "moments": {name: moments(getattr(state, f"{name}_opt"))
                        for name in ("d", "g", "dnn")}})
        return experiment.state, metrics

    experiment._step = recording
    state = experiment.train()
    experiment.close()
    return {"steps": record, "step": state.step}


def _instrumented_step(experiment, stream) -> dict:
    """One step with the card synchronized around each model-axis
    collective of ``parallel/tp.py``: their count, bytes and host ms, and
    the shapes at which the norm kernels ran."""
    from srgan_tpu_torch.ops import fused_norm as fn
    from srgan_tpu_torch.parallel import tp
    spent = {"calls": 0, "bytes": 0, "ms": 0.0}
    shapes = {"fwd": [], "bwd": []}
    real = {name: getattr(tp, name) for name in ("_all_gather",
                                                 "_all_reduce")}
    # The dispatchers, not the launchers, which count through their names.
    kernels = {"fwd": fn._fwd, "bwd": fn._bwd}

    def timed(f):
        def call(x, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(x, *args)
            torch.cuda.synchronize()
            spent["ms"] += 1e3 * (time.perf_counter() - t0)
            spent["calls"] += 1
            spent["bytes"] += out.numel() * out.element_size()
            return out
        return call

    def recorded(kind):
        def call(x, *args, **kwargs):
            shapes[kind].append(tuple(x.shape))
            return kernels[kind](x, *args, **kwargs)
        return call

    try:
        for name, f in real.items():
            setattr(tp, name, timed(f))
        fn._fwd, fn._bwd = recorded("fwd"), recorded("bwd")
        experiment.state, metrics = experiment._step(*next(stream))
        torch.cuda.synchronize()
    finally:
        for name, f in real.items():
            setattr(tp, name, f)
        fn._fwd, fn._bwd = kernels["fwd"], kernels["bwd"]
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"instrumented step: losses {metrics}")
    return dict(spent, shapes=shapes)


def tp_flagship_action(experiment) -> dict:
    """Phase 15 (b) on a rank: ``train()`` with its launches counted
    (from just before), then ``TP_TIMED_STEPS`` timed steps (ms/step
    between synchronizations), one instrumented step and the peak
    allocated memory."""
    before = trace.counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = experiment.train()
    torch.cuda.synchronize()
    out = {"launches": counted_since(before),
           "step": state.step, "seconds": time.perf_counter() - t0}
    experiment.prepare_train_step()  # train() closed the inputs
    stream = (b for epoch in experiment.epoch_batch_iterators()
              for b in epoch)
    for _ in range(2):
        experiment.state, _ = experiment._step(*next(stream))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TP_TIMED_STEPS):
        experiment.state, metrics = experiment._step(*next(stream))
    torch.cuda.synchronize()
    out["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / TP_TIMED_STEPS
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"timed steps: losses {metrics}")
    out["collectives"] = _instrumented_step(experiment, stream)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["local_shapes"] = {
        k: tuple(p.shape) for k, p in state.d.named_parameters()}
    experiment.close()
    return out


def tp_gloo_action(experiment, tiny_runs, flagship_settings,
                   flagship_trial):
    """A rank of phase 15, one process for every part: (c) the straddling
    layer, (a) the float32 runs (the launched experiment "xla", then
    ``tiny_runs``: (name, settings, trial) each), (b) the flagship
    widths, each a new experiment in the same grid."""
    from srgan_tpu_torch import CrowdExperiment
    dp = experiment.data_parallel

    def run(settings, trial, action):
        exp = CrowdExperiment(settings, data_parallel=dp)
        exp.given_trial_directory = trial
        return action(exp)

    out = {"straddle": {impl: tp_straddle(dp, impl)
                        for impl in ("xla", "fast", "pallas")}}
    out["tiny"] = {"xla": tp_tiny_action(experiment)}
    for name, settings, trial in tiny_runs:
        out["tiny"][name] = run(settings, trial, tp_tiny_action)
    out["flagship"] = run(flagship_settings, flagship_trial,
                          tp_flagship_action)
    return out


def _tp_held_to_one_rank(dev, settings, got) -> dict:
    """Phase 15 (a): one rank without a grid fed the grid's batches and
    the same draws, step by step: the metrics within the CPU tests' rtol
    5e-4, atol 5e-5, the models within 2.1·lr a step (JAX's tolerances,
    tests/test_tensor_parallel.py), and after the first step Adam's
    moments, (1 − β1)·g and (1 − β2)·g² of that step's averaged and
    clipped gradient g, within the same rtol and atol. Later moments add
    gradients taken at parameters that already differ by rounding, and
    in the unclipped runs they can drift past that tolerance by the
    fourth step. With the clip on, every model's first gradient has the
    clip norm, so that the clip acts in the step held to the grid's."""
    from srgan_tpu_torch import CrowdExperiment
    from srgan_tpu_torch.train import (init_train_state, make_gan_train_step,
                                       set_float32_precision)
    from srgan_tpu_torch.utils.seeding import generator_for
    set_float32_precision()
    one = CrowdExperiment(settings.copy(model_parallel_devices=1),
                          device=dev)
    one.models = one.model_setup()
    state = init_train_state(one.settings, one.models)
    step = make_gan_train_step(one.settings,
                               labeled_loss_fn=one.labeled_loss_fn(),
                               latent_shape=one.latent_shape())
    rng = generator_for(settings.seed, "train", dev)
    lr = settings.learning_rate
    # "models": the largest difference but in a conv bias a one-channel
    # GroupNorm cancels, whose noise-level gradient moves it ±lr a step
    # either way ("cancelled").
    worst = {"metrics": 0.0, "models": 0.0, "cancelled": 0.0,
             "moments": 0.0}
    cancelled = {name: _cancelled_biases(getattr(
        getattr(state, name), "model", getattr(state, name)))
        for name in ("d", "g", "dnn")}
    for i, rec in enumerate(got["steps"]):
        batch = [t.to(dev) for t in rec["batch"]]
        batch = [t.contiguous(memory_format=torch.channels_last)
                 if t.dim() == 4 else t for t in batch]
        state, metrics = step(state, *batch, rng)
        for k, v in rec["metrics"].items():
            ours = float(metrics[k])
            worst["metrics"] = max(worst["metrics"],
                                   abs(ours - v) / max(abs(ours), 1e-6))
            if not math.isclose(v, ours, rel_tol=5e-4, abs_tol=5e-5):
                raise AssertionError(f"grid step {i}: {k} {v}, one rank "
                                     f"{ours}")
        for name in ("d", "g", "dnn"):
            ours = getattr(state, name).state_dict()
            for k, v in rec["models"][name].items():
                err = float((ours[k].cpu() - v).abs().max())
                which = "cancelled" if k in cancelled[name] else "models"
                worst[which] = max(worst[which], err)
                if err > 2.1 * lr * (i + 1):
                    raise AssertionError(f"grid step {i}: {name} {k} "
                                         f"differs by {err}")
            if i > 0:
                continue
            opt = getattr(state, f"{name}_opt").adam.state_dict()["state"]
            for j, entry in rec["moments"][name].items():
                for k, v in entry.items():
                    want = opt[j][k].cpu()
                    excess = float(((v - want).abs() - 5e-4 * want.abs())
                                   .max())
                    worst["moments"] = max(worst["moments"], excess)
                    if excess > 5e-5:
                        raise AssertionError(
                            f"first step: {name} moment {j} {k} "
                            f"differs by {excess} beyond rtol 5e-4")
            if settings.gradient_clip_norm > 0:
                norm = math.sqrt(sum(
                    float((e["exp_avg"] / (1 - settings.adam_b1)).square()
                          .sum()) for e in opt.values()))
                worst[f"{name}_clipped_norm"] = norm
                if not math.isclose(norm, settings.gradient_clip_norm,
                                    rel_tol=5e-4):
                    raise AssertionError(
                        f"clip {settings.gradient_clip_norm}: {name}'s "
                        f"first gradient has norm {norm}")
    return worst


def tp_main_path(dev, logs: str, card: str) -> dict:
    """Phase 15: the fused norm kernels at every sharded norm shape of a
    grid rank's flagship step, then one launch of a 1 × 2 grid on this
    card running (c), (a) and (b) (``tp_gloo_action``); every comparison,
    a rank's launches and its norm shapes asserted."""
    from srgan_tpu_torch import CrowdExperiment, Settings
    from srgan_tpu_torch.parallel.launch import run_experiment
    from srgan_tpu_torch.utils.summary import make_trial_directory
    # The ranks import the straddling layer's worker from tests/.
    sys.path.insert(0, os.path.join(REPO, "tests"))
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(15)
    worst = {"fwd": 0.0, "bwd": 0.0}
    norm_step, _ = _weighted_norm_step(
        dev, gen, TP_NORM_SHAPES, "a grid rank's flagship step at batch "
        f"{TP_BATCH}", worst, groups=16)
    out = {"norm_step": norm_step, "norm_worst": worst}

    tiny = {name: Settings(**dict(TP_TINY, logs_directory=logs,
                                  trial_name=f"chip_smoke_tp_{name}", **over))
            for name, over in TP_TINY_RUNS.items()}
    flagship = Settings(**dict(TP_FLAGSHIP, logs_directory=logs))
    trials = {name: make_trial_directory(s) for name, s in
              list(tiny.items()) + [("flagship", flagship)]}
    t0 = time.perf_counter()
    ranks_out = run_experiment(
        CrowdExperiment, tiny["xla"], [dev, dev], action=tp_gloo_action,
        action_args=([(name, s, trials[name]) for name, s in tiny.items()
                      if name != "xla"], flagship, trials["flagship"]),
        trial_directory=trials["xla"], model=2, timeout_s=DP_JOIN_S)
    seconds = time.perf_counter() - t0

    # (c) the straddling layer
    for r, got in enumerate(ranks_out):
        for impl, s in got["straddle"].items():
            if (s["groups"], s["local_channels"]) != (3, 48):
                raise AssertionError(f"straddle {impl}, rank {r}: groups "
                                     f"{s['groups']}, channels "
                                     f"{s['local_channels']}")
            bad = {k: e for k, e in s["errors"].items()
                   if e > TP_STRADDLE_RTOL}
            if bad:
                raise AssertionError(f"straddle {impl}, rank {r}: {bad}")
    out["straddle"] = ranks_out[0]["straddle"]
    log(f"tensor parallel (c), the straddling layer (conv 3 → 96, 3 groups "
        f"over 2 ranks of 48 channels, conv 96 → 6), forward and double "
        f"backward against its unsharded self, largest relative errors "
        + "; ".join(f"{impl}: " + ", ".join(f"{k} {e:.1e}" for k, e in
                                            s["errors"].items())
                    for impl, s in out["straddle"].items())
        + f" (within {TP_STRADDLE_RTOL:g}; {card})")

    # (a) the float32 runs held to one rank
    out["tiny"] = {}
    for impl, settings in tiny.items():
        a, b = (r["tiny"][impl] for r in ranks_out)
        if a["step"] != settings.steps_to_run or \
                [s["metrics"] for s in a["steps"]] != \
                [s["metrics"] for s in b["steps"]]:
            raise AssertionError(f"tiny {impl}: steps {a['step']}, or the "
                                 f"ranks' metrics differ")
        for sa, sb in zip(a["steps"], b["steps"]):
            for name in ("d", "g", "dnn"):
                for k, v in sa["models"][name].items():
                    if not torch.equal(v, sb["models"][name][k]):
                        raise AssertionError(f"tiny {impl}: the ranks' "
                                             f"{name} {k} differ")
        out["tiny"][impl] = _tp_held_to_one_rank(dev, settings, a)
        check_validation(trials[impl], [settings.steps_to_run])
        _written_once(trials[impl])
        worst = out["tiny"][impl]
        clipped = "".join(
            f", {name}'s first gradient norm {worst[name + '_clipped_norm']}"
            for name in ("d", "g", "dnn") if f"{name}_clipped_norm" in worst)
        log(f"tensor parallel (a), {impl}, float32, a 1 × 2 grid over gloo "
            f"on {dev}, gradient_clip_norm {settings.gradient_clip_norm:g}"
            f"{clipped}: {settings.steps_to_run} steps, the ranks' models "
            f"bit-equal after each; one rank on the same batches and draws:"
            f" metrics within {worst['metrics']:.2e} (relative), models "
            f"within {worst['models']:.2e} (conv biases a one-channel "
            f"GroupNorm cancels: {worst['cancelled']:.2e}; bound 2.1·lr a "
            f"step, lr {settings.learning_rate:g}), Adam's moments after "
            f"the first step {worst['moments']:.2e} beyond rtol 5e-4 "
            f"(bound 5e-5)")

    # (b) the flagship widths
    per_step = {"extract_patches": 3, "extract_rescaled_patches": 0,
                "group_norm_act_fwd": NORM_LAUNCHES_PER_STEP["fwd"],
                "group_norm_act_bwd": NORM_LAUNCHES_PER_STEP["bwd"],
                "group_norm_act_second_order":
                    NORM_LAUNCHES_PER_STEP["second_order"]}
    steps = flagship.steps_to_run
    want_shapes = {kind: sorted(
        shape[:3] for shape in TP_NORM_SHAPES
        for _ in range(shape[4 + (kind == "bwd")])) for kind in ("fwd",
                                                                  "bwd")}
    results = [r["flagship"] for r in ranks_out]
    for r, got in enumerate(results):
        _dp_launches(got["launches"], per_step, steps, 1, f"tp rank {r}")
        ran = {k: sorted(v) for k, v in got["collectives"]["shapes"].items()}
        if ran != want_shapes:
            raise AssertionError(f"tp rank {r}: the norm kernels ran at "
                                 f"{ran}, not {want_shapes}")
    check_crowd_trial(trials["flagship"], steps)
    _written_once(trials["flagship"])
    out["flagship"] = dict(
        ms_per_step=[g["ms_per_step"] for g in results],
        peak_gib=[g["peak_gib"] for g in results],
        collective_ms=[g["collectives"]["ms"] for g in results],
        collective_calls=[g["collectives"]["calls"] for g in results],
        collective_mib=[g["collectives"]["bytes"] / 2 ** 20
                        for g in results],
        launches=[g["launches"] for g in results],
        train_seconds=[g["seconds"] for g in results], seconds=seconds)
    log(f"tensor parallel (b), a 1 × 2 grid over gloo on {dev}, flagship "
        f"widths under \"pallas\", batch {TP_BATCH}: {steps} steps and a "
        f"validation pass through train(); launches a rank "
        f"{json.dumps(results[0]['launches'])}, the norm kernels at the "
        f"sharded shapes {sorted(set(want_shapes['fwd']))}; "
        + "; ".join(
            f"rank {r}: {g['ms_per_step']:.1f} ms/step ({TP_TIMED_STEPS} "
            f"steps), peak allocated {g['peak_gib']:.2f} GiB, model-axis "
            f"collectives {g['collectives']['calls']} a step, "
            f"{g['collectives']['bytes'] / 2 ** 20:.1f} MiB, "
            f"{g['collectives']['ms']:.1f} host ms (card synchronized "
            f"around each)" for r, g in enumerate(results))
        + f"; the launch {seconds:.1f} s, the ranks' start included "
        f"({card})")
    return out


# Phase 16: the port's tools. The committed traces' configurations, the
# sweep's grid, the window bench's database and window, and the two
# rehearsals' sizes.
TRACE_FILES = ("coefficient_h10_s0", "crowd_tiny_s0", "age_dcgan_s0",
               "driving_stack2_s0")
SWEEP_GRID = {"unlabeled_loss_multiplier": [0.1, 1.0],
              "fake_loss_multiplier": [1.0],
              "gradient_penalty_multiplier": [10.0],
              "learning_rate": [1e-3]}
SWEEP_SEEDS, SWEEP_STEPS = 2, 50
WINDOW_BENCH = ["--total-gb", "2", "--window", "256", "--slices", "4",
                "--steps", str(TIMED_STEPS), "--warmup", "2",
                "--refresh-period", "2"]
CLI_REHEARSAL = ["--images", "4", "--steps", "4", "--window", "64"]
UCF_IMAGES = [(4000, 6000, None)] * 2
UCF_HEADS = 12865


def tools_main_path(dev, logs: str, card: str) -> dict:
    """Phase 16: the port's tools on this card. (a) the four golden
    traces recorded on the CPU and compared on the card at
    ``golden_trace.TOLERANCES``; (b) a sweep of 2 combos × 2 seeds × 50
    steps; (c) the window bench at the flagship widths on a 2 GB database
    with a window of 256, its refreshes and windows checked as phase 12
    checks them and its sampler and norm launches counted; (d) the
    command-line rehearsal at 4 images of 3000×4000 and 4 steps; (e) the
    UCF-QNRF rehearsal at 2 images of 6000×4000 and 12 865 heads with its
    junk points, the mass check held."""
    from srgan_tpu_torch.tools import (golden_trace, real_scale_cli_rehearsal,
                                       sweep, ucf_qnrf_rehearsal,
                                       window_bench)
    out = {}
    # (a) golden traces: the CPU's against the card's, same init and draws
    worst = {}
    for name in TRACE_FILES:
        with open(os.path.join(REPO, "traces", f"{name}.json")) as f:
            golden = json.load(f)
        app = golden.get("app", "coefficient")
        args = (golden["steps"], golden["seed"], golden["hidden_size"], app)
        cpu = golden_trace.run_trace(*args, device="cpu")
        gpu = golden_trace.run_trace(*args, device=dev)
        rtol, atol = golden_trace.TOLERANCES[app]
        mismatch = golden_trace.compare_traces(gpu, cpu, rtol, atol)
        if mismatch:
            raise AssertionError(f"golden trace {app} on the card against "
                                 f"the CPU (rtol {rtol}, atol {atol}): "
                                 f"{mismatch}")
        worst[app] = max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
                         for g, c in zip(gpu, cpu) for k in c)
    log(f"tools (a): 4 golden traces on the card within their tolerances "
        f"of the CPU's; largest relative difference {json.dumps(worst)}")
    out["golden_worst_rel"] = worst

    # (b) the sweep's lanes through the shipped step
    lanes = 2 * SWEEP_SEEDS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sweep.run_grid(8, SWEEP_STEPS, SWEEP_SEEDS, 5000, 32, 10, 10,
                          SWEEP_GRID, device=dev)
    seconds = time.perf_counter() - t0
    maes = [v for r in rows for k in ("gan_mae_per_seed", "dnn_mae_per_seed")
            for v in r[k]]
    if len(rows) != 2 or not all(math.isfinite(v) and v > 0 for v in maes):
        raise AssertionError(f"sweep rows: {rows}")
    out["sweep_ms_per_lane_step"] = 1e3 * seconds / (lanes * SWEEP_STEPS)
    log(f"tools (b): sweep of {lanes} lanes x {SWEEP_STEPS} steps in "
        f"{seconds:.2f} s, {out['sweep_ms_per_lane_step']:.4f} ms per "
        f"lane-step ({dev}: {card}); MAEs {maes}")

    # (c) the window bench: refreshes, windows and launches
    before = trace.counters()
    bench_args = window_bench.parse_args(WINDOW_BENCH + [
        "--db-root", os.path.join(logs, "window_db")])
    result, exp, settings = window_bench.run_bench(bench_args, dev)
    torch.cuda.synchronize()
    launches = counted_since(before)
    steps = bench_args.warmup + bench_args.steps
    try:
        _check_window(exp, settings, steps)
    finally:
        exp.close()
    per_step = {"extract_patches": 3, "extract_rescaled_patches": 0,
                "group_norm_act_fwd": NORM_LAUNCHES_PER_STEP["fwd"],
                "group_norm_act_bwd": NORM_LAUNCHES_PER_STEP["bwd"],
                "group_norm_act_second_order":
                    NORM_LAUNCHES_PER_STEP["second_order"]}
    for kernel, count in per_step.items():
        if launches[kernel] != count * steps:
            raise AssertionError(f"window bench: {kernel} launched "
                                 f"{launches[kernel]} times in {steps} "
                                 f"steps, not {count} a step")
    period = bench_args.refresh_period
    timed = len(range(period, steps, period)) - len(
        range(period, bench_args.warmup, period))
    if result["refreshes_in_timed_region"] != [timed, timed]:
        raise AssertionError(f"window bench refreshes: {result}")
    log(f"tools (c): window bench {json.dumps(result)}; launches "
        f"{json.dumps(launches)} ({card})")
    out["window_bench"] = result
    del exp
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the command-line rehearsal: preprocessing and training CLIs
    cli_args = real_scale_cli_rehearsal.parse_args(CLI_REHEARSAL + [
        "--work-dir", os.path.join(logs, "cli_rehearsal")])
    report = real_scale_cli_rehearsal.run(cli_args)
    metrics = report["validation"]
    if set(metrics) != COUNT_METRICS or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"command-line rehearsal: {report}")
    log(f"tools (d): command-line rehearsal {json.dumps(report)} ({card})")
    out["cli_rehearsal"] = report

    # (e) the UCF-QNRF rehearsal at the dataset's largest images
    summary = ucf_qnrf_rehearsal.rehearse(
        os.path.join(logs, "ucf_rehearsal"), UCF_IMAGES, UCF_HEADS,
        ["density"], 384, 512, 8.0, 0, device=dev)
    record = summary["results"][0]
    if (record["expected_counts"] != [UCF_HEADS] * len(UCF_IMAGES)
            or not record["mass_conserved"]
            or not record["density_finite"]):
        raise AssertionError(f"UCF-QNRF rehearsal: {record}")
    log(f"tools (e): UCF-QNRF rehearsal "
        f"{json.dumps(dict(summary, results=None))} "
        f"{json.dumps(record)}")
    out["ucf_rehearsal"] = {k: v for k, v in record.items()
                            if not isinstance(v, list)}
    return out


# Phase 17: norm_impl="fast" (FastGroupNorm: composite torch ops in the
# compute dtype, no kernel of its own). The module's bfloat16 check: the
# JAX test's probe shape and the flagship D's first norm at batch 8, 32
# groups; the forward within FAST_ULPS ulps of the largest output (the
# card and the CPU sum the float32 statistics in other orders, and a
# group's mean or rsqrt may round to the neighbouring bfloat16 value),
# the gradients within FAST_GRAD_TOL of their largest.
FAST_SHAPES = [(4, 64, 14, 14), (8, 64, 112, 112)]
FAST_ULPS = 2
FAST_GRAD_TOL = 1e-2


def check_fast_norm_module(dev) -> dict:
    """Phase 17 (a): ``FastGroupNorm`` in bfloat16 on the card against
    the CPU on the same input, scale and bias: the output and the first
    gradients of sum(w · y) w.r.t. x, scale and bias."""
    from srgan_tpu_torch.models.dcgan import FastGroupNorm
    out = {}
    for shape in FAST_SHAPES:
        gen = torch.Generator().manual_seed(17)
        x = (torch.randn(shape, generator=gen) * 3 + 1).contiguous(
            memory_format=torch.channels_last)
        w = torch.randn(shape, generator=gen)
        params = {"scale": 1 + 0.2 * torch.randn(shape[1], generator=gen),
                  "bias": 0.3 * torch.randn(shape[1], generator=gen)}
        results = []
        for device in ("cpu", dev):
            norm = FastGroupNorm(shape[1], 32, dtype=torch.bfloat16).to(
                device)
            norm.load_state_dict(params)
            xd = x.to(device).requires_grad_(True)
            y = norm(xd)
            grads = torch.autograd.grad((y.float() * w.to(device)).sum(),
                                        [xd, norm.scale, norm.bias])
            results.append([t.detach().float().cpu() for t in (y, *grads)])
        (cpu_y, *cpu_g), (gpu_y, *gpu_g) = results
        top = float(cpu_y.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        err = float((gpu_y - cpu_y).abs().max())
        errors = {"y_ulps": err / ulp,
                  "y_differ": int((gpu_y != cpu_y).sum())}
        if not err <= FAST_ULPS * ulp:
            raise AssertionError(f"fast (a) {shape}: the card's output is "
                                 f"{err} from the CPU's, over {FAST_ULPS} "
                                 f"ulps of the largest ({ulp})")
        for name, a, b in zip(("x", "scale", "bias"), cpu_g, gpu_g):
            rel = float((b - a).abs().max()) / float(a.abs().max())
            errors[f"grad_{name}"] = rel
            if not rel <= FAST_GRAD_TOL:
                raise AssertionError(f"fast (a) {shape}: grad {name} on the "
                                     f"card is {rel} of its largest from "
                                     f"the CPU's")
        out[str(list(shape))] = errors
    log("fast (a), FastGroupNorm in bfloat16 on the card against the CPU "
        f"(forward within {FAST_ULPS} ulps of the largest output, "
        f"gradients within {FAST_GRAD_TOL:g} of their largest): "
        + json.dumps(out))
    return out


def fast_main_path(dev, logs: str, card: str, timed: dict) -> dict:
    """Phase 17: ``norm_impl="fast"``. (a) a tiny float32 crowd evaluation
    and step on the card against the CPU, and the module in bfloat16;
    (b) the flagship through ``CrowdExperiment.train()`` with its
    launches asserted (3 sampler launches a step, no norm kernel), timed
    beside phase 6's "xla" and "pallas" (``timed``); (c) the age SR-GAN
    at full width through ``train()``; (d) chunk replays bit-equal to
    eager steps."""
    from srgan_tpu_torch import Settings
    out = {}
    check_small_step(dev, "fast")
    out["module"] = check_fast_norm_module(dev)
    settings = Settings(
        logs_directory=logs, steps_to_run=STEPS, summary_step_period=1,
        validation_step_period=VALIDATION_PERIOD, norm_impl="fast",
        **dict(FLAGSHIP, trial_name="chip_smoke_fast"))
    out["launches"], flagship = train_main_path(settings, dev, card)
    out["flagship"] = dict(timed, fast=flagship)
    log("fast (b), the flagship (batch 120, 224-px patches, base width 64, "
        "bfloat16), ms/step, busy share, peak allocated: " + "; ".join(
            f"{impl}: {r['ms_per_step']:.2f} ms, "
            f"{100 * r['busy_share']:.1f}%, {r['peak_gib']:.2f} GiB"
            for impl, r in out["flagship"].items())
        + f" ({card})")
    out["age"] = app_train_main_path("age", Settings(**dict(
        APP_FULL, logs_directory=os.path.join(logs, "apps"),
        trial_name="chip_smoke_fast_age", norm_impl="fast")), dev, card)
    out["dispatch"] = dispatch_correctness(dev, "fast")
    return out


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

    def build_native():
        """The host tier's library, built by this run from the port's
        ``csrc/srgan_io.cc``."""
        from srgan_tpu_torch.io import native
        path = native.library_path()
        if os.path.exists(path):
            os.remove(path)
        t0 = time.perf_counter()
        native.build_library()
        return (f"build: {os.path.relpath(native.SOURCE_PATH, REPO)} -> "
                f"{os.path.relpath(path, REPO)} (g++) in "
                f"{time.perf_counter() - t0:.2f} s")

    names = ("patches", "fused_norm", "density", "copy")
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        native_line = pool.submit(build_native)
        for line in pool.map(build, names):
            log(line)
        log(native_line.result())

    # 2. kernels at the shapes of their paths
    entries = ([check_kernels(dev), check_rescale_kernel(dev)]
               + check_norm_kernels(dev)
               + [check_density_kernel(dev), check_copy_kernel(dev)])

    # 3. the gradient penalty's second order through the fused norm
    check_second_order(dev)

    # 4. small float32 evaluation and step against the CPU
    for factors in ((), RESCALE):
        for impl in ("xla", "pallas"):
            check_small_step(dev, impl, factors)
    check_small_app_step(dev, "coefficient")
    for impl in ("xla", "pallas"):
        check_small_app_step(dev, "age", impl)
    check_small_app_step(dev, "age", "pallas", dnn_only=True)
    for impl in ("xla", "pallas"):
        check_small_step(dev, impl, crowd_label_type="iknn")
    for model in ("jointdcnn", "pyramid"):
        check_small_step(dev, "pallas", crowd_model=model)

    # 5. the training paths through their entry point; 6. timed steps
    logs = os.path.join(REPO, "logs", "chip_smoke")
    timed = {}
    for impl, factors in (("xla", ()), ("pallas", ()), ("pallas", RESCALE)):
        settings = Settings(
            logs_directory=logs, steps_to_run=STEPS, summary_step_period=1,
            validation_step_period=VALIDATION_PERIOD, norm_impl=impl,
            crowd_rescale_factors=factors, **FLAGSHIP)
        launches, timed[impl, factors] = train_main_path(settings, dev, smi)
    # The training kernels' launches are those of the last run, the
    # rescale sampler's, which launches all four.

    # 7. preprocessing; 8. the command line on its database
    db_dir, launches["density_maps"] = preprocess_main_path(
        dev, os.path.join(logs, "database"))
    cli_main_path(dev, db_dir, os.path.join(logs, "cli"))

    # 9. the bandwidth tool, the copy probe's path
    bandwidth_main_path(entries[-1])

    # 10. the other apps through their entry points; 11. their command lines
    from srgan_tpu_torch.presets import apply_preset
    app_logs = os.path.join(logs, "apps")
    runs = [("age", dict(norm_impl="xla")), ("age", dict(norm_impl="pallas")),
            ("age", apply_preset("age_dnn", dict(norm_impl="pallas"))),
            ("driving", dict(norm_impl="pallas", driving_frame_stack=3)),
            ("coefficient", apply_preset("coefficient_win", dict(
                steps_to_run=200, validation_step_period=100, seed=0,
                summary_step_period=1)))]
    for app, over in runs:
        kw = dict(APP_FULL, logs_directory=app_logs)
        if app == "coefficient":
            kw = dict(trial_name="chip_smoke_app", test_dataset_size=100,
                      logs_directory=app_logs)
        app_train_main_path(app, Settings(**dict(kw, **over)), dev, smi)
    age_cli_main_path(dev, os.path.join(app_logs, "cli"))

    # 12. the rest of the crowd app: kNN/iKNN targets, the other two
    # models, the window and host tiers; their command line
    tiers = {}
    for name, over in CROWD_TIER_RUNS:
        settings = Settings(**dict(
            FLAGSHIP, logs_directory=os.path.join(logs, "tiers"),
            trial_name=f"chip_smoke_{name}", norm_impl="pallas",
            steps_to_run=STEPS, summary_step_period=1,
            validation_step_period=VALIDATION_PERIOD, **over))
        tiers[name] = tier_train_main_path(name, settings, dev, smi)
    log("tiers: " + json.dumps(tiers))
    aux_cli_main_path(dev, os.path.join(logs, "database", "raw"),
                      os.path.join(logs, "aux_cli"))

    # 13. data parallelism: a world of 1 over NCCL, a world of 2 over gloo
    parallel = dp_main_path(dev, os.path.join(logs, "parallel"), smi,
                            timed["pallas", ()]["ms_per_step"])
    log("data parallel: " + json.dumps(parallel))

    # 14. steps_per_dispatch: K steps a CUDA graph replay
    dispatch = dispatch_main_path(dev, os.path.join(logs, "dispatch"), smi)
    log("dispatch: " + json.dumps(dispatch))

    # 15. tensor parallelism: a 1 × 2 grid over gloo on this card
    tensor = tp_main_path(dev, os.path.join(logs, "tensor"), smi)
    log("tensor parallel: " + json.dumps(tensor))

    # 16. the tools: golden traces, the sweep, the window bench, the
    # rehearsals
    tools = tools_main_path(dev, os.path.join(logs, "tools"), smi)
    log("tools: " + json.dumps(tools))

    # 17. norm_impl="fast": the tiny step and the module, the flagship
    # beside phase 6's, the age app, chunk replays
    fast = fast_main_path(dev, os.path.join(logs, "fast"), smi,
                          {impl: timed[impl, ()] for impl in ("xla",
                                                              "pallas")})
    log("fast: " + json.dumps(fast))

    for entry in entries[:-1]:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
