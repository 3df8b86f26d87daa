"""Time copy kernels of ``csrc/copy.cu``'s C interface beside ``copy_``, on
the card, in one process.

    python -m srgan_tpu_torch.tools.copy_compare [NAME=FILE.cu ...]
        [--rounds 4] [--reps 30]

Each ``FILE.cu`` exports ``srgan_copy`` and ``srgan_cuda_error_string``
with the signatures of ``csrc/copy.cu`` (by default that file of this
checkout, named ``this``); an older commit's, unpacked by ``git archive``
under ``logs/``, or a variant, is timed beside it so. All compile at once
with ``ops/_build.py``'s nvcc flags into a temporary directory. At each
shape of ``norm_bandwidth_bench.SHAPES`` (bfloat16, per_example) every
kernel's output is first checked equal to its input bit for bit; then
``copy_`` and every kernel are timed in ``--rounds`` rounds, the order
reversed every other round, each by ``utils.timing.cuda_ms`` queued behind
a sleep kernel, all writing into one reused output. Prints one line per
shape and variant: the mean, the least and the largest of its rounds, then
every round's ms.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import tempfile

import torch

from srgan_tpu_torch.ops import _build
from srgan_tpu_torch.tools.norm_bandwidth_bench import SHAPES, declare
from srgan_tpu_torch.utils.timing import cuda_ms


def _load(sources: dict, build_dir: str) -> dict:
    """{name: the loaded library} of {name: source path}, compiled in
    parallel."""
    procs = {}
    for name, source in sources.items():
        out = os.path.join(build_dir, f"{name}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{log}")
        libs[name] = declare(ctypes.CDLL(out))
    return libs


def compare(sources: dict, rounds: int = 4, reps: int = 30) -> None:
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as build_dir:
        libs = _load(sources, build_dir)
        for shape in SHAPES:
            x = torch.randn(shape, generator=gen, device=dev
                            ).to(torch.bfloat16)
            out = torch.empty_like(x)
            b, hw, c = shape
            stream = torch.cuda.current_stream(dev).cuda_stream

            def kernel(lib):
                code = lib.srgan_copy(x.data_ptr(), out.data_ptr(), 0, b,
                                      hw * c * x.element_size(), stream)
                if code != 0:
                    raise RuntimeError(
                        lib.srgan_cuda_error_string(code).decode())

            calls = {"copy_": lambda: out.copy_(x)}
            for name, lib in libs.items():
                out.fill_(float("nan"))
                kernel(lib)
                if not torch.equal(out, x):
                    raise AssertionError(f"{name} did not copy x exactly "
                                         f"at {list(shape)}")
                calls[name] = lambda lib=lib: kernel(lib)
            times = {name: [] for name in calls}
            for r in range(rounds):
                for name in (list(calls) if r % 2 == 0
                             else list(calls)[::-1]):
                    times[name].append(cuda_ms(calls[name], reps,
                                               queued=True))
            for name, ts in times.items():
                print(f"copy_compare {list(shape)} bf16 per_example on "
                      f"{card}: {name} mean {sum(ts) / len(ts):.4f} ms, "
                      f"least {min(ts):.4f}, largest {max(ts):.4f}; rounds "
                      + " ".join(f"{t:.4f}" for t in ts), flush=True)
            del x, out
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="srgan_tpu_torch.tools.copy_compare",
        description="Time copy kernels beside copy_ on the CUDA card")
    parser.add_argument("sources", nargs="*", metavar="NAME=FILE.cu")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--reps", type=int, default=30)
    args = parser.parse_args(argv)
    sources = dict(s.split("=", 1) for s in args.sources) or {
        "this": os.path.join(_build.CSRC_DIR, "copy.cu")}
    compare({k: os.path.abspath(v) for k, v in sources.items()},
            args.rounds, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
