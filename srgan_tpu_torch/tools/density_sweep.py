"""Time the density kernel of this checkout over runs of slots, on the
card, to choose the launch plan.

    python -m srgan_tpu_torch.tools.density_sweep

For each case, 384×512 maps at σ = 8 (the preprocessor's defaults): one
map of 2000 heads over the canvas (the preprocessing path's shape: one
launch per image, up to 2000 heads in the synthesized database of
``chip_smoke.py``), one map of 12 865 heads (UCF-QNRF's most crowded
image) and 16 maps of 4096 slots with counts uniform in [0, 4096], heads
over the canvas widened by 16 px on each side. The slots in one run and
in each of ``SPLITS`` runs are timed by CUDA events over ``CALLS`` calls
queued behind a sleep kernel, the maps in runs checked within the
kernel's tolerance of those in one run. Prints one line per case: each
run count's ms, the plan of ``density_plan`` marked.
"""

from __future__ import annotations

import numpy as np
import torch

from srgan_tpu_torch.ops import density
from srgan_tpu_torch.utils.timing import cuda_ms

CALLS = 20
SPLITS = (1, 2, 3, 4, 6, 8, 12)
H, W, SIGMA = 384, 512, 8.0


def _cases(rng):
    """(name, heads [B, N, 2] float32, counts [B] int32) as numpy."""
    out = []
    for name, b, n, counts, pad in (
            ("path, 1 x 2000 heads", 1, 2000, np.array([2000]), 0),
            ("1 x 12865 heads", 1, 12865, np.array([12865]), 16),
            ("16 x 4096 slots", 16, 4096, rng.integers(0, 4097, 16), 16)):
        heads = np.stack([rng.uniform(-pad, H + pad, (b, n)),
                          rng.uniform(-pad, W + pad, (b, n))],
                         -1).astype(np.float32)
        out.append((name, heads, counts.astype(np.int32)))
    return out


def main() -> int:
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    for case, heads_np, counts_np in _cases(np.random.default_rng(11)):
        heads = torch.from_numpy(heads_np).to(dev)
        counts = torch.from_numpy(counts_np).to(dev)
        b, n, _ = heads.shape
        default = density.density_plan(H, W, SIGMA, b, n)
        plans = [default._replace(splits=s)
                 for s in sorted({*SPLITS, default.splits})]
        want = density._launch_density(heads, counts, SIGMA, H, W, plans[0])
        line = []
        for plan in plans:
            got = density._launch_density(heads, counts, SIGMA, H, W, plan)
            same = bool(((got - want).abs()
                         <= 1e-6 + 1e-4 * want.abs()).all())
            ms = cuda_ms(lambda: density._launch_density(
                heads, counts, SIGMA, H, W, plan), CALLS, queued=True)
            mark = "*" if plan == default else ""
            line.append(f"{plan.splits}{mark} {ms:.4f}"
                        + ("" if same else " DIFFERENT"))
        print(f"density sweep [{case}] {list(heads.shape)} on {name}, "
              f"{density.TILE}x{density.TILE} tiles, runs of slots: ms "
              f"(* the plan's): " + ", ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
