"""ctypes bindings for the native host-IO runtime (``csrc/srgan_io.cc``).

The port's copy of ``srgan_tpu.io.native`` (which cannot be imported
without loading JAX): memory-mapped ``.npy`` datasets and a threaded
crop-gather prefetcher with a bounded ring queue, the host-side input of
the crowd app's host tier (``crowd_host_pipeline``).

The shared library builds at first use with ``g++`` from the package's
own ``srgan_tpu_torch/csrc/srgan_io.cc`` into ``srgan_tpu_torch/build/``.
Its file name carries a hash of the source and the flags, and it is
compiled under a private name and renamed into place, so processes that
build at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_PATH = os.path.join(_PACKAGE_DIR, "csrc", "srgan_io.cc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "build")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE_PATH, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libsrgan_io_{digest.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile ``csrc/srgan_io.cc`` unless its library exists; returns
    the library's path. Raises with the compiler's output on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        result = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE_PATH],
                                capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"g++ failed ({result.returncode}) for "
                               f"{SOURCE_PATH}:\n{result.stdout}\n"
                               f"{result.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library())
        lib.sg_open_npy.restype = ctypes.c_void_p
        lib.sg_open_npy.argtypes = [ctypes.c_char_p]
        lib.sg_close.restype = None
        lib.sg_close.argtypes = [ctypes.c_void_p]
        lib.sg_shape.restype = None
        lib.sg_shape.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int64)]
        lib.sg_is_float32.restype = ctypes.c_int
        lib.sg_is_float32.argtypes = [ctypes.c_void_p]
        lib.sg_gather_crops.restype = None
        lib.sg_gather_crops.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float)]
        lib.sg_prefetcher_create.restype = ctypes.c_void_p
        lib.sg_prefetcher_create.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
        lib.sg_prefetcher_create_u8.restype = ctypes.c_void_p
        lib.sg_prefetcher_create_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64]
        lib.sg_prefetcher_next.restype = ctypes.c_int
        lib.sg_prefetcher_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.sg_prefetcher_destroy.restype = None
        lib.sg_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_library_available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def _as_i32_ptr(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeDatasetReader:
    """Memory-mapped [N, H, W, C] ``.npy`` dataset (float32 or uint8)
    with batched crop gathers executed in C++."""

    def __init__(self, path: str):
        self._lib = _load()
        self._handle = self._lib.sg_open_npy(
            os.path.abspath(path).encode())
        if not self._handle:
            raise OSError(
                f"cannot open {path}: must be a C-order 4-D .npy of "
                f"float32 or uint8")
        dims = (ctypes.c_int64 * 4)()
        self._lib.sg_shape(self._handle, dims)
        self.shape: Tuple[int, int, int, int] = tuple(int(d) for d in dims)
        self.dtype = (np.float32 if self._lib.sg_is_float32(self._handle)
                      else np.uint8)

    def gather_crops(self, indices: np.ndarray, offsets: np.ndarray,
                     flips: Optional[np.ndarray], patch_size: int,
                     scale: float = 1.0, shift: float = 0.0) -> np.ndarray:
        """[B] indices + [B, 2] (oy, ox) + flips → [B, P, P, C] float32."""
        if not self._handle:
            raise RuntimeError("the reader is closed")
        indices = np.ascontiguousarray(indices, np.int32)
        offsets = np.ascontiguousarray(offsets, np.int32)
        b = len(indices)
        n, h, w, c = self.shape
        if offsets.shape != (b, 2):
            raise ValueError(f"offsets {offsets.shape} must be [{b}, 2]")
        if b and (indices.min() < 0 or indices.max() >= n
                  or offsets.min() < 0 or offsets[:, 0].max() > h - patch_size
                  or offsets[:, 1].max() > w - patch_size):
            raise ValueError("crop indices or offsets out of bounds")
        out = np.empty((b, patch_size, patch_size, c), np.float32)
        flips = (None if flips is None
                 else np.ascontiguousarray(flips, np.int32))
        self._lib.sg_gather_crops(
            self._handle, _as_i32_ptr(indices), _as_i32_ptr(offsets),
            _as_i32_ptr(flips) if flips is not None else None,
            b, patch_size, scale, shift,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.sg_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativePrefetcher:
    """Threaded random-crop batch prefetcher over a
    :class:`NativeDatasetReader` (bounded ring queue in C++). Each worker
    thread draws from its own seeded generator; with one thread the
    batches are a function of the seed alone."""

    def __init__(self, reader: NativeDatasetReader, batch_size: int,
                 patch_size: int, scale: float = 1.0, shift: float = 0.0,
                 queue_depth: int = 4, num_threads: int = 2,
                 seed: int = 0, output_dtype: str = "float32"):
        self._lib = _load()
        self._reader = reader
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.channels = reader.shape[3]
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"unknown output_dtype {output_dtype!r}; "
                             f"choose float32 or uint8")
        self.output_dtype = np.dtype(output_dtype)
        if output_dtype == "uint8":
            # Raw-byte crops (u8 store only, no scale/shift): the caller
            # normalizes on the device.
            if reader.dtype != np.uint8:
                raise ValueError("output_dtype='uint8' requires a uint8 "
                                 "dataset")
            if scale != 1.0 or shift != 0.0:
                raise ValueError("scale/shift are float32-output "
                                 "features; uint8 output streams raw "
                                 "bytes (normalize on device)")
            self._handle = self._lib.sg_prefetcher_create_u8(
                reader._handle, batch_size, patch_size, queue_depth,
                num_threads, seed)
        else:
            self._handle = self._lib.sg_prefetcher_create(
                reader._handle, batch_size, patch_size, scale, shift,
                queue_depth, num_threads, seed)
        if not self._handle:
            raise ValueError("prefetcher creation failed (patch larger "
                             "than image, or empty dataset)")

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking: → (batch [B, P, P, C] of ``output_dtype``, source
        indices [B])."""
        batch, idx, _, _ = self.next_with_params()
        return batch, idx

    def next_with_params(self) -> Tuple[np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]:
        """Blocking: → (batch, indices [B], offsets [B, 2], flips [B]),
        so that the caller can gather matching label crops with
        :meth:`NativeDatasetReader.gather_crops`."""
        if not self._handle:
            raise RuntimeError("the prefetcher is closed")
        out = np.empty((self.batch_size, self.patch_size, self.patch_size,
                        self.channels), self.output_dtype)
        idx = np.empty((self.batch_size,), np.int32)
        offs = np.empty((self.batch_size, 2), np.int32)
        flips = np.empty((self.batch_size,), np.int32)
        ok = self._lib.sg_prefetcher_next(
            self._handle, out.ctypes.data_as(ctypes.c_void_p),
            _as_i32_ptr(idx), _as_i32_ptr(offs), _as_i32_ptr(flips))
        if not ok:
            raise StopIteration
        return out, idx, offs, flips

    def close(self) -> None:
        if self._handle:
            self._lib.sg_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
