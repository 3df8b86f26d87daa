"""Build a CUDA source of ``srgan_tpu_torch/csrc`` with ``nvcc`` and load
it with ctypes.

Each source compiles, at first use, into a shared library with a plain C
interface under ``srgan_tpu_torch/build/``. The file name carries a hash
of the source, of the headers beside it and of the compiler flags, so an
edited source or header builds anew and a stale library is never loaded.
Nothing here runs at import time: the machines without ``nvcc`` import
the package all the same.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(/usr/local/cuda): the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source, the headers of ``csrc/`` (``*.cuh``, any of which it may
    include) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, source), "rb") as f:
            digest.update(source.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path. Raises with nvcc's output if the build fails."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a private name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    try:
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"nvcc failed ({result.returncode}) for "
                               f"{name}.cu:\n{result.stdout}\n"
                               f"{result.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
