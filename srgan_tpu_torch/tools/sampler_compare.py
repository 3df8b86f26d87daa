"""Run the patch samplers of one checkout of the port on the card and
record, for each case, the SHA-256 of the output's bytes and the kernel's
time; compare two such records; or time this checkout's kernels over
launch plans.

    python srgan_tpu_torch/tools/sampler_compare.py run OUT.json [--root DIR]
    python srgan_tpu_torch/tools/sampler_compare.py compare A.json B.json
    python srgan_tpu_torch/tools/sampler_compare.py sweep

``run`` imports ``srgan_tpu_torch`` from the checkout at DIR (by default the
one that holds this file), so that an older commit unpacked beside this
one runs on the same inputs through the same wrappers. The cases are the
flagship's calls (B = 120, P = 224 from a 1000-image 384×512 source: uint8
images, float32 and bfloat16 labels, through ``extract_patches`` and
through ``extract_rescaled_patches`` at windows 168/224/280) and small ones
whose rows are not whole 16-byte vectors (W = 97, P = 30, 300 examples).
Inputs come from fixed seeds. The digest is of the first argument set's
output; the time is a CUDA-event mean over ``SETS`` argument sets taken in
turn, ``CALLS`` calls after two warm-up calls queued behind a sleep
kernel, so that the windows come from device memory and the calls run
back to back. ``compare`` prints both records' times side by side
and exits 1 unless every digest is equal. ``sweep`` times both samplers
at the flagship calls (uint8 images, float32 labels) for each plan of
``SWEEP_PLANS`` (rows a tile, threads a block; the shared memory as
``sampler_plan`` lays it out), checking each output bit-equal to the
default plan's, one line each.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import itertools
import json
import os
import subprocess
import sys

SETS = 8
CALLS = 24
# (name, N, H, W, P, B, windows of the rescale)
GEOMETRIES = [("flagship", 1000, 384, 512, 224, 120, (168, 224, 280)),
              ("ragged", 3, 80, 97, 30, 300, (19, 30, 45))]
# (name, channels, source dtype, scale, shift, preserve_mass)
SOURCES = [("images uint8", 3, "uint8", 2.0 / 255.0, -1.0, False),
           ("labels float32", 1, "float32", 1.0, 0.0, True),
           ("labels bfloat16", 1, "bfloat16", 1.0, 0.0, True)]


def _draws(rng, n, h, w, p, b, windows, rescale):
    """SETS argument sets: (indices, offsets, flips[, scale_idx]) as
    int32 numpy arrays, every window inside its image."""
    import numpy as np
    out = []
    for _ in range(SETS):
        sidx = rng.integers(0, len(windows), b)
        side = np.asarray(windows)[sidx] if rescale else np.full(b, p)
        offsets = np.stack([rng.integers(0, h - side + 1),
                            rng.integers(0, w - side + 1)], -1)
        draw = [rng.integers(0, n, b), offsets, rng.integers(0, 2, b)]
        if rescale:
            draw.append(sidx)
        out.append([a.astype(np.int32) for a in draw])
    return out


SWEEP_PLANS = [(rows, threads) for rows in (2, 4, 8, 16)
               for threads in (128, 256, 512)]


def _device_ms(call, draws) -> float:
    """Mean ms of ``call`` over ``CALLS`` calls taking ``draws`` in turn,
    after two warm-up calls, queued behind a sleep kernel that outlasts
    their enqueueing, so that they run back to back on the card whatever
    the host's time per call."""
    turn = itertools.cycle(draws)
    return _timing().cuda_ms(lambda: call(next(turn)), CALLS, queued=True)


@functools.cache
def _timing():
    """``srgan_tpu_torch/utils/timing.py`` of the checkout that holds this
    file, loaded by its path: ``run`` may import the package from an older
    checkout, whose kernels are then timed the same way as this one's."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "utils", "timing.py")
    spec = importlib.util.spec_from_file_location("_sampler_timing", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sweep() -> None:
    import numpy as np
    import torch
    from srgan_tpu_torch.ops import patches
    dev = torch.device("cuda")
    _, n, h, w, p, b, windows = GEOMETRIES[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    sources = {"images uint8": (torch.randint(
        0, 256, (n, h, w, 3), generator=gen, device=dev, dtype=torch.uint8),
        2.0 / 255.0, -1.0), "labels float32": (
        torch.rand((n, h, w, 1), generator=gen, device=dev) * 1e-2, 1.0, 0.0)}
    for rescale in (False, True):
        rng = np.random.default_rng(1)
        draws = [[torch.from_numpy(a).to(dev) for a in d]
                 for d in _draws(rng, n, h, w, p, b, windows, rescale)]
        for name, (src, scale, shift) in sources.items():
            c = src.shape[-1]
            mass = c == 1

            def call(d, plan, src=src, scale=scale, shift=shift, mass=mass):
                if rescale:
                    return patches._launch_rescaled(
                        src, d[0], d[1], d[2], d[3], p, windows, scale,
                        shift, mass, plan)
                return patches._launch_patches(src, d[0], d[1], d[2], p,
                                               scale, shift, plan)
            default = patches.sampler_plan(b, h, w, c, p,
                                           src.element_size(),
                                           windows if rescale else None)
            want = call(draws[0], default)
            line = []
            for rows, threads in SWEEP_PLANS:
                staged, smem = patches._sampler_layout(
                    rows, c, p, src.element_size(),
                    windows if rescale else None)
                plan = patches.SamplerPlan(rows, threads, staged, smem)
                same = torch.equal(call(draws[0], plan), want)
                ms = _device_ms(lambda d: call(d, plan), draws)
                line.append(f"{rows}/{threads} {ms:.4f}"
                            + ("" if same else " DIFFERENT"))
            kind = "rescale" if rescale else "fixed"
            print(f"sweep {kind} [{name}] {[b, p, p, c]}, rows/threads ms "
                  f"(default {default.tile_rows}/{default.threads}): "
                  + ", ".join(line), flush=True)


def run(out_path: str, root: str) -> None:
    import numpy as np
    import torch
    from srgan_tpu_torch.ops import patches
    if not patches.__file__.startswith(os.path.join(root, "")):
        raise RuntimeError(f"imported {patches.__file__}, not {root}'s")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    record = {"package": os.path.dirname(os.path.abspath(patches.__file__)),
              "card": smi, "cases": {}}
    for geo, n, h, w, p, b, windows in GEOMETRIES:
        gen = torch.Generator(device=dev).manual_seed(0)
        images = torch.randint(0, 256, (n, h, w, 3), generator=gen,
                               device=dev, dtype=torch.uint8)
        labels = torch.rand((n, h, w, 1), generator=gen, device=dev) * 1e-2
        sources = {"uint8": images, "float32": labels,
                   "bfloat16": labels.to(torch.bfloat16)}
        for rescale in (False, True):
            rng = np.random.default_rng(1)
            draws = [[torch.from_numpy(a).to(dev) for a in d]
                     for d in _draws(rng, n, h, w, p, b, windows, rescale)]
            for name, c, dtype, scale, shift, mass in SOURCES:
                src = sources[dtype]
                kw = dict(patch_size=p, scale=scale, shift=shift)
                if rescale:
                    kw.update(window_sizes=windows, preserve_mass=mass)
                    fn = patches.extract_rescaled_patches
                else:
                    fn = patches.extract_patches

                def call(d, src=src, fn=fn, kw=kw):
                    return fn(src, *d[1:], indices=d[0], **kw)
                got = call(draws[0])
                digest = hashlib.sha256(
                    got.cpu().numpy().tobytes()).hexdigest()
                ms = _device_ms(call, draws)
                case = (f"{geo} {fn.__name__} [{name}] "
                        f"{[b, p, p, c]}")
                record["cases"][case] = {"sha256": digest, "ms": ms}
                print(f"{case}: {ms:.4f} ms, sha256 {digest[:16]}",
                      flush=True)
        del images, labels, sources
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    print(f"A: {a['package']} ({a['card']})\nB: {b['package']} "
          f"({b['card']})")
    differ = 0
    for case in a["cases"]:
        x, y = a["cases"][case], b["cases"].get(case)
        same = y is not None and x["sha256"] == y["sha256"]
        differ += not same
        print(f"{case}: A {x['ms']:.4f} ms, B "
              f"{y['ms'] if y is None else round(y['ms'], 4)} ms, "
              f"{'bit-equal' if same else 'DIFFERENT'}")
    if set(b["cases"]) != set(a["cases"]):
        differ += 1
        print("the two records hold different cases")
    return 1 if differ else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    p_run = sub.add_parser("run")
    p_run.add_argument("out")
    p_run.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p_cmp = sub.add_parser("compare")
    p_cmp.add_argument("a")
    p_cmp.add_argument("b")
    sub.add_parser("sweep")
    args = parser.parse_args(argv)
    if args.mode == "compare":
        return compare(args.a, args.b)
    if args.mode == "sweep":
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
        sweep()
        return 0
    root = os.path.abspath(args.root)
    if "srgan_tpu_torch" in sys.modules:
        raise RuntimeError("run this file as a script, so that --root "
                           "decides which srgan_tpu_torch it imports")
    sys.path.insert(0, root)
    run(args.out, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
