// Random patch samplers: gather, crop, flip and normalize in one pass,
// and the same with a per-example rescale. Two kernels, two entries.
//
// 1. extract_patches_kernel (srgan_extract_patches).
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


// 2. extract_rescaled_patches_kernel (srgan_extract_rescaled_patches).
//
// Replaces srgan_tpu/ops/patches.py::_make_rows_kernel as called by
// extract_rescaled_patches, together with its XLA tail (the per-scale
// window slices, jax.image.resize, the mass factor, the one-hot select
// and the flip). For each output example b, with s = scale_idx[b] and
// ws = window_sizes[s]:
//
//   win[j, i, c] = src[idx[b], oy[b] + j, ox[b] + i, c] * scale + shift
//   r[y, x, c]   = sum_j sum_i Wy[y, j] Wx[x, i] win[j, i, c]   (ws != P)
//                = win[y, x, c]                                 (ws == P)
//   out[b, y, flip[b] ? P-1-x : x, c] = r[y, x, c] * (preserve_mass ? (ws/P)^2 : 1)
//
// W is JAX's antialiased bilinear weight matrix (ops/patches.py
// resize_weights), given as a tap table: per window size and output
// coordinate o, a first source index first[s, o] and K weights for the
// sources first + k (K = 3 for 280 -> 224). The TPU version DMAs the
// rows of the LARGEST window and resizes every candidate size, then
// selects one; this kernel computes only the selected size (multiplying
// by the one-hot 0/1 changes nothing for finite values).
//
// One block per output row (b, y): it contracts the K source rows of y
// into one f32 row of ws x C values in shared memory (at most
// 280 x 3 x 4 B = 3.4 KB at the flagship shape), then each thread makes
// output elements x*C + c from K taps of that row. What bounds it: bytes.
// At the flagship shape (B = 120, P = 224, windows 168/224/280) an image
// call reads about 19 MB of uint8 windows (rows are re-read by up to K
// blocks, from L2) and writes 72 MB of float32. This first version is
// plain; making it faster is later work.
//
// Rounding: x * scale + shift rounds the multiply and the add separately,
// as in kernel 1; the contractions accumulate with fmaf in tap order. A
// window of side P is copied (and multiplied by the mass factor 1) so it
// equals kernel 1 bit for bit, as JAX skips the resize there.

template <typename T>
__global__ void extract_rescaled_patches_kernel(
    const T* __restrict__ src, const int32_t* __restrict__ indices,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ flips,
    const int32_t* __restrict__ scale_idx,
    const int32_t* __restrict__ window_sizes,
    const int32_t* __restrict__ tap_first,
    const float* __restrict__ tap_weights, const float* __restrict__ mass,
    float* __restrict__ out, int height, int width, int channels, int patch,
    int taps, float scale, float shift, int preserve_mass) {
  extern __shared__ float vrow[];  // [ws * C]: the row contracted along y
  const int b = blockIdx.y;
  const int y = blockIdx.x;
  const int s = scale_idx[b];
  const int ws = window_sizes[s];
  const int n = indices[b];
  const int oy = offsets[2 * b];
  const int ox = offsets[2 * b + 1];
  const bool flip = flips[b] != 0;
  const float factor = preserve_mass ? mass[s] : 1.0f;
  const int row_len = patch * channels;
  float* dst = out + (static_cast<size_t>(b) * patch + y) * row_len;
  const T* image = src + static_cast<size_t>(n) * height * width * channels;

  if (ws == patch) {  // identity: an exact copy of window row y
    const T* line = image + (static_cast<size_t>(oy + y) * width + ox) * channels;
    for (int e = threadIdx.x; e < row_len; e += blockDim.x) {
      const int x = e / channels;
      const int c = e - x * channels;
      const float v = __fadd_rn(__fmul_rn(to_float(line[x * channels + c]), scale), shift);
      dst[(flip ? patch - 1 - x : x) * channels + c] = __fmul_rn(v, factor);
    }
    return;
  }

  const int* first = tap_first + static_cast<size_t>(s) * patch;
  const float* weights = tap_weights + static_cast<size_t>(s) * patch * taps;
  // 1. along y: vrow[i, c] = sum_k Wy[y, k] * win[first[y] + k, i, c]
  const int fy = first[y];
  const float* wy = weights + static_cast<size_t>(y) * taps;
  const int win_len = ws * channels;
  for (int e = threadIdx.x; e < win_len; e += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < taps; ++k) {
      const int j = fy + k;
      if (j >= ws) break;
      const float v = __fadd_rn(
          __fmul_rn(to_float(image[(static_cast<size_t>(oy + j) * width + ox) * channels + e]),
                    scale),
          shift);
      acc = __fmaf_rn(wy[k], v, acc);
    }
    vrow[e] = acc;
  }
  __syncthreads();
  // 2. along x, the mass factor, the flip folded into the store.
  for (int e = threadIdx.x; e < row_len; e += blockDim.x) {
    const int x = e / channels;
    const int c = e - x * channels;
    const int fx = first[x];
    const float* wx = weights + static_cast<size_t>(x) * taps;
    float acc = 0.0f;
    for (int k = 0; k < taps; ++k) {
      const int i = fx + k;
      if (i >= ws) break;
      acc = __fmaf_rn(wx[k], vrow[i * channels + c], acc);
    }
    dst[(flip ? patch - 1 - x : x) * channels + c] = __fmul_rn(acc, factor);
  }
}

template <typename T>
int launch_rescaled(const void* src, const int32_t* indices,
                    const int32_t* offsets, const int32_t* flips,
                    const int32_t* scale_idx, const int32_t* window_sizes,
                    const int32_t* tap_first, const float* tap_weights,
                    const float* mass, float* out, int batch, int height,
                    int width, int channels, int patch, int taps,
                    int max_window, float scale, float shift,
                    int preserve_mass, cudaStream_t stream) {
  const dim3 grid(patch, batch);
  const size_t shared = static_cast<size_t>(max_window) * channels * sizeof(float);
  extract_rescaled_patches_kernel<T><<<grid, kThreads, shared, stream>>>(
      static_cast<const T*>(src), indices, offsets, flips, scale_idx,
      window_sizes, tap_first, tap_weights, mass, out, height, width,
      channels, patch, taps, scale, shift, preserve_mass);
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

// dtype as above; window_sizes [S], tap_first [S, P], tap_weights
// [S, P, taps] and mass [S] are the wrapper's table on the device.
// Returns the launch's cudaError_t (0 on success); does not synchronize.
int srgan_extract_rescaled_patches(
    const void* src, const int32_t* indices, const int32_t* offsets,
    const int32_t* flips, const int32_t* scale_idx,
    const int32_t* window_sizes, const int32_t* tap_first,
    const float* tap_weights, const float* mass, float* out, int dtype,
    int batch, int height, int width, int channels, int patch,
    int num_scales, int taps, int max_window, float scale, float shift,
    int preserve_mass, void* stream) {
  if (batch <= 0 || patch <= 0) return 0;
  if (num_scales <= 0 || taps <= 0 || batch > 65535 ||
      static_cast<size_t>(max_window) * channels * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_rescaled<uint8_t>(src, indices, offsets, flips, scale_idx,
                                      window_sizes, tap_first, tap_weights,
                                      mass, out, batch, height, width,
                                      channels, patch, taps, max_window,
                                      scale, shift, preserve_mass, s);
    case 1:
      return launch_rescaled<float>(src, indices, offsets, flips, scale_idx,
                                    window_sizes, tap_first, tap_weights,
                                    mass, out, batch, height, width, channels,
                                    patch, taps, max_window, scale, shift,
                                    preserve_mass, s);
    case 2:
      return launch_rescaled<__nv_bfloat16>(
          src, indices, offsets, flips, scale_idx, window_sizes, tap_first,
          tap_weights, mass, out, batch, height, width, channels, patch, taps,
          max_window, scale, shift, preserve_mass, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* srgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
