// Random patch sampler: gather, crop, flip and normalize in one pass.
//
// Replaces the TPU kernel srgan_tpu/ops/patches.py::_make_rows_kernel
// together with its XLA tail (the x-window slice and the flip of
// extract_patches). For each output example b:
//
//   out[b, y, x, c] = src[idx[b], oy[b] + y, ox[b] + (flip[b] ? P-1-x : x), c]
//                     * scale + shift
//
// src is [N, H, W, C] (uint8, float32 or bfloat16, contiguous); out is
// [B, P, P, C] float32, contiguous.
//
// What bounds it: bytes. It does one multiply-add per element. At the
// flagship shape (B=120, P=224, C=3) an image call reads about 18 MB of
// uint8 and writes about 72 MB of float32; a label call reads and writes
// 24 MB each way of float32. Each block handles a run of one output row
// (b, y): consecutive threads take consecutive x*C + c, so the stores of
// a warp are one contiguous span and the loads one contiguous span of a
// source row (walked backwards under a flip). Every block reads its own
// idx/offset/flip: there is no scalar prefetch to port.
//
// This first version is a plain coalesced gather. Making it faster, for
// instance one launch for the three calls of a step or bfloat16 output,
// is later work.
//
// The multiply and the add are rounded separately (__fmul_rn, __fadd_rn)
// so that nvcc cannot contract them into an FMA: the kernel then rounds
// exactly as x.float() * scale + shift does in PyTorch.
//
// Bounds are the caller's contract, as in the JAX package: every window
// must lie inside its image.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void extract_patches_kernel(const T* __restrict__ src,
                                       const int32_t* __restrict__ indices,
                                       const int32_t* __restrict__ offsets,
                                       const int32_t* __restrict__ flips,
                                       float* __restrict__ out, int height,
                                       int width, int channels, int patch,
                                       float scale, float shift) {
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int row_len = patch * channels;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // x * C + c
  if (e >= row_len) return;
  const int x = e / channels;
  const int c = e - x * channels;
  const int n = indices[b];
  const int oy = offsets[2 * b];
  const int ox = offsets[2 * b + 1];
  const int sx = ox + (flips[b] != 0 ? patch - 1 - x : x);
  const size_t s =
      ((static_cast<size_t>(n) * height + (oy + y)) * width + sx) * channels + c;
  const size_t o = (static_cast<size_t>(b) * patch + y) * row_len + e;
  out[o] = __fadd_rn(__fmul_rn(to_float(src[s]), scale), shift);
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* src, const int32_t* indices, const int32_t* offsets,
           const int32_t* flips, float* out, int batch, int height, int width,
           int channels, int patch, float scale, float shift,
           cudaStream_t stream) {
  const int row_len = patch * channels;
  const dim3 grid((row_len + kThreads - 1) / kThreads, patch, batch);
  extract_patches_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), indices, offsets, flips, out, height, width,
      channels, patch, scale, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = uint8, 1 = float32, 2 = bfloat16. Returns the launch's
// cudaError_t (0 on success). Enqueues on `stream`; does not synchronize.
int srgan_extract_patches(const void* src, const int32_t* indices,
                          const int32_t* offsets, const int32_t* flips,
                          float* out, int dtype, int batch, int height,
                          int width, int channels, int patch, float scale,
                          float shift, void* stream) {
  if (batch <= 0 || patch <= 0) return 0;
  // gridDim.y and gridDim.z are limited to 65535.
  if (patch > 65535 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<uint8_t>(src, indices, offsets, flips, out, batch, height,
                             width, channels, patch, scale, shift, s);
    case 1:
      return launch<float>(src, indices, offsets, flips, out, batch, height,
                           width, channels, patch, scale, shift, s);
    case 2:
      return launch<__nv_bfloat16>(src, indices, offsets, flips, out, batch,
                                   height, width, channels, patch, scale,
                                   shift, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* srgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
