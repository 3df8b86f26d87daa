"""Measure the device-memory copy ceiling at the fused GroupNorm's shapes.

The port of ``tools/norm_bandwidth_bench.py``. A copy reads every byte
once and writes it once and computes nothing, so its time is the least a
memory-bound kernel of the same bytes can take: the yardstick of the fused
GroupNorm + activation kernels (``ops/fused_norm.py``). It times, on the
CUDA card, the same bfloat16 copy in these variants:

  copy_          — ``torch.Tensor.copy_``, the library's copy (the JAX
                   tool's ``xla`` variant)
  per_example    — the CUDA kernel of ``csrc/copy.cu``, its work cut at
                   each example's [HW, C] slab
  batch_strided  — the same kernel over flat chunks of ``rows`` rows of
                   the [B·HW, C] view

at two shapes: the JAX tool's own, [120, 12544, 64] (its [120·6272, 128]
without the TPU's fold of two pixels into one 128-lane row, the same
bytes), and [360, 12544, 64], the largest norm of the flagship step (D's
first norm over the 3B batch). Every variant's output is checked to equal
its input bit for bit. Every variant writes into one output reused for all
its calls, and its timed calls wait behind a sleep kernel on the card, so
that the times compare the copies on the device and not the host's time
per call. Prints one JSON line per variant::

    python -m srgan_tpu_torch.tools.norm_bandwidth_bench [--reps 30]

The wrapper :func:`copy` launches the kernel on a CUDA tensor (and adds
one to ``copy.launches``) and runs :func:`copy_plain`, a Python loop of
slab assignments, on a CPU tensor.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
from typing import List, Optional, Sequence

import torch

from srgan_tpu_torch.ops import _build
from srgan_tpu_torch.utils.device import default_device
from srgan_tpu_torch.utils.timing import cuda_ms

SHAPES = ((120, 12544, 64), (360, 12544, 64))
LAYOUTS = ("per_example", "batch_strided")
# Rows of the [B·HW, C] view a segment: the JAX tool's chunks of 512 to
# 12544 lane-folded rows, in unfolded rows (the same bytes a segment).
ROWS = (1024, 2048, 6272, 12544, 25088)


@functools.cache
def _library() -> ctypes.CDLL:
    return declare(_build.load_library("copy"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signatures of ``csrc/copy.cu`` declared."""
    lib.srgan_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_longlong, ctypes.c_void_p]
    lib.srgan_copy.restype = ctypes.c_int
    lib.srgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.srgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _segments(x: torch.Tensor, layout: str, rows: int):
    """(segments, bytes each) of ``x`` [B, HW, C] in ``layout``."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; choose {LAYOUTS}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, HW, C], got {list(x.shape)}")
    b, hw, c = x.shape
    row_bytes = c * x.element_size()
    if layout == "per_example":
        return b, hw * row_bytes
    if rows < 1 or (b * hw) % rows:
        raise ValueError(f"rows={rows} does not divide the {b * hw} rows "
                         f"of the [B·HW, C] view")
    return b * hw // rows, rows * row_bytes


def copy(x: torch.Tensor, layout: str, rows: int = 0,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A copy of ``x`` [B, HW, C] (contiguous) made in ``layout``, with
    ``rows`` rows of the [B·HW, C] view a segment for "batch_strided";
    into ``out`` (contiguous, like ``x``) where given."""
    segments, seg_bytes = _segments(x, layout, rows)
    if x.device.type == "cpu":
        return copy_plain(x, layout, rows, out)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"copy runs on a contiguous CUDA or CPU tensor, "
                         f"got one on {x.device}")
    if seg_bytes % 16:
        raise ValueError(f"each {layout} segment is {seg_bytes} bytes; the "
                         f"kernel copies whole 16-byte vectors")
    out = _output(x, out)
    if (x.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("the copy kernel needs 16-byte aligned tensors")
    lib = _library()
    code = lib.srgan_copy(x.data_ptr(), out.data_ptr(), LAYOUTS.index(layout),
                          segments, seg_bytes,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"copy kernel launch failed: "
                           f"{lib.srgan_cuda_error_string(code).decode()}")
    copy.launches += 1
    return out


copy.launches = 0


def _output(x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return torch.empty_like(x)
    if (out.shape != x.shape or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {x.dtype} "
                         f"{list(x.shape)} tensor on {x.device}")
    return out


def copy_plain(x: torch.Tensor, layout: str, rows: int = 0,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same copy in plain PyTorch, on any device: one slab assignment
    per example (per_example) or per chunk of rows (batch_strided)."""
    segments, _ = _segments(x, layout, rows)
    out = _output(x, out)
    src, dst = x.view(segments, -1), out.view(segments, -1)
    for i in range(segments):
        dst[i] = src[i]
    return out


def time_variant(x: torch.Tensor, variant: str, rows: int = 0,
                 reps: int = 30) -> dict:
    """One JSON record: the variant's ms and GB/s (read + write) on ``x``,
    after checking that its output equals ``x`` bit for bit. Every call
    writes into the same output."""
    out = torch.empty_like(x)
    if variant == "copy_":
        fn = functools.partial(out.copy_, x)
    else:
        fn = functools.partial(copy, x, variant, rows, out)
    got = fn()
    if not torch.equal(got, x):
        raise AssertionError(f"{variant} (rows {rows}) did not copy x "
                             f"exactly")
    ms = cuda_ms(fn, reps, queued=True)
    moved = 2 * x.numel() * x.element_size()
    return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "variant": variant, "rows_per_block": rows, "ms": ms,
            "GBps": moved / ms / 1e6}


def run(shapes: Sequence = SHAPES, reps: int = 30,
        device: Optional[torch.device] = None) -> List[dict]:
    """Every variant at every shape on the card; the records in order."""
    device = device if device is not None else default_device()
    if device.type != "cuda":
        raise ValueError(f"the copy ceiling is measured on a CUDA card, "
                         f"not {device}")
    gen = torch.Generator(device=device).manual_seed(0)
    records = []
    for shape in shapes:
        x = torch.randn(tuple(shape), generator=gen, device=device
                        ).to(torch.bfloat16)
        records.append(time_variant(x, "copy_", reps=reps))
        records.append(time_variant(x, "per_example", reps=reps))
        b, hw, _ = shape
        for rows in ROWS:
            if (b * hw) % rows == 0:
                records.append(time_variant(x, "batch_strided", rows, reps))
        del x
        torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="srgan_tpu_torch.tools.norm_bandwidth_bench",
        description="Copy ceiling at the fused GroupNorm shapes, on the "
                    "CUDA card")
    parser.add_argument("--reps", type=int, default=30)
    args = parser.parse_args(argv)
    records = run(reps=args.reps)
    name = torch.cuda.get_device_name(0)
    for record in records:
        print(json.dumps(dict(record, device=name)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
