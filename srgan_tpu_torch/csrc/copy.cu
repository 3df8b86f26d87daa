// Copy probe: a plain device-to-device copy in two launch layouts, to
// measure the bandwidth ceiling that the fused GroupNorm kernels are
// judged against.
//
// Replaces the TPU kernel tools/norm_bandwidth_bench.py::_copy_kernel
// (o_ref[...] = x_ref[...]) in the tool's two grids:
//
// * per_example (layout 0): the source is `segments` slabs of `seg_bytes`
//   each, one per example ([HW, C] of a [B, HW, C] tensor). blockIdx.y
//   picks the slab and the blocks along x share it, as the TPU grid's one
//   block per example does.
// * batch_strided (layout 1): the flat tensor cut into `segments` chunks
//   of `rows` rows; one block per chunk, walking it with a block-wide
//   stride.
//
// What bounds it: bytes. Each byte is read once and written once and
// nothing is computed, so its time is the device's copy ceiling. Every
// thread moves 16-byte vectors (uint4), neighbouring threads neighbouring
// vectors, with four loads in flight before their stores. The wrapper
// checks that each segment is a whole number of 16-byte vectors and that
// both pointers are 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVectorsPerThread = 8;  // per_example: a block's share

// Copy the vectors begin, begin + stride, ... below end, kUnroll at a time.
__device__ __forceinline__ void copy_span(const uint4* __restrict__ src,
                                          uint4* __restrict__ dst,
                                          long long begin, long long end,
                                          long long stride) {
  long long v = begin;
  for (; v + (kUnroll - 1) * stride < end; v += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = src[v + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[v + u * stride] = r[u];
  }
  for (; v < end; v += stride) dst[v] = src[v];
}

__global__ void copy_per_example_kernel(const uint4* __restrict__ src,
                                        uint4* __restrict__ dst,
                                        long long seg_vectors) {
  const size_t base = static_cast<size_t>(blockIdx.y) * seg_vectors;
  copy_span(src + base, dst + base,
            static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
            seg_vectors, static_cast<long long>(gridDim.x) * blockDim.x);
}

__global__ void copy_batch_strided_kernel(const uint4* __restrict__ src,
                                          uint4* __restrict__ dst,
                                          long long seg_vectors) {
  const size_t base = static_cast<size_t>(blockIdx.x) * seg_vectors;
  copy_span(src + base, dst + base, threadIdx.x, seg_vectors, blockDim.x);
}

}  // namespace

extern "C" {

// layout: 0 = per_example, 1 = batch_strided. segments copies of
// seg_bytes each, seg_bytes a multiple of 16, both pointers 16-byte
// aligned. Returns the launch's cudaError_t (0 on success). Enqueues on
// `stream`; does not synchronize.
int srgan_copy(const void* src, void* dst, int layout, long long segments,
               long long seg_bytes, void* stream) {
  if (segments <= 0 || seg_bytes <= 0) return 0;
  if (seg_bytes % 16 != 0 || (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vectors = seg_bytes / 16;
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 0) {
    if (segments > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const long long per_block = static_cast<long long>(kThreads) * kVectorsPerThread;
    const dim3 grid(static_cast<unsigned>((vectors + per_block - 1) / per_block),
                    static_cast<unsigned>(segments));
    copy_per_example_kernel<<<grid, kThreads, 0, st>>>(s, d, vectors);
  } else if (layout == 1) {
    if (segments > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    copy_batch_strided_kernel<<<static_cast<unsigned>(segments), kThreads, 0, st>>>(
        s, d, vectors);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
