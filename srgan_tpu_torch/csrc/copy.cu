// Copy probe: a plain device-to-device copy in two launch layouts, to
// measure the bandwidth ceiling that the fused GroupNorm kernels are
// judged against.
//
// Replaces the TPU kernel tools/norm_bandwidth_bench.py::_copy_kernel
// (o_ref[...] = x_ref[...]) in the tool's two grids:
//
// * per_example (layout 0): the source is `segments` slabs of `seg_bytes`
//   each, one per example ([HW, C] of a [B, HW, C] tensor);
// * batch_strided (layout 1): the flat tensor cut into `segments` chunks
//   of `rows` rows.
//
// Both are the same walk here: each segment is cut into work units of
// kThreads * kVectorsPerThread 16-byte vectors (8 KB; a segment's last
// unit may be shorter), and no unit crosses a segment. One block takes one
// unit, in order along a one-dimensional grid (no limit of 65535
// segments): each thread loads its kVectorsPerThread vectors, neighbouring
// threads neighbouring vectors, both in flight at once, then stores them.
//
// What bounds it: bytes. Each byte is read once and written once and
// nothing is computed, so its time is the device's copy ceiling. On an
// H100 this grid of short-lived blocks measured faster than a persistent
// grid, than one-warp blocks that move 32 KB by TMA bulk copies through
// shared memory, and than 1, 4 or 8 vectors a thread; streaming cache
// hints (__ldcs, __stcs) were 0.9% slower in the bandwidth tool, though
// not in tools/copy_compare.py (PERF.md, Findings). The wrapper checks
// that each segment is a whole number of 16-byte vectors and that both
// pointers are 16-byte aligned.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVectorsPerThread = 2;
constexpr long long kUnitVectors = static_cast<long long>(kThreads) * kVectorsPerThread;

__global__ void __launch_bounds__(kThreads) copy_unit_kernel(const uint4* __restrict__ src,
                                                             uint4* __restrict__ dst,
                                                             long long seg_vectors,
                                                             long long units_per_seg) {
  const long long unit = blockIdx.x;
  const long long seg = unit / units_per_seg;
  const long long in_seg = (unit - seg * units_per_seg) * kUnitVectors;
  const long long base = seg * seg_vectors + in_seg;
  const long long left = seg_vectors - in_seg;
  if (left >= kUnitVectors) {
    uint4 r[kVectorsPerThread];
#pragma unroll
    for (int q = 0; q < kVectorsPerThread; ++q) r[q] = src[base + q * kThreads + threadIdx.x];
#pragma unroll
    for (int q = 0; q < kVectorsPerThread; ++q) dst[base + q * kThreads + threadIdx.x] = r[q];
  } else {
    for (long long v = threadIdx.x; v < left; v += kThreads) dst[base + v] = src[base + v];
  }
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
  const long long seg_vectors = seg_bytes / 16;
  const long long units_per_seg = (seg_vectors + kUnitVectors - 1) / kUnitVectors;
  if ((layout != 0 && layout != 1) || seg_bytes % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16 != 0 ||
      segments > INT_MAX / units_per_seg)
    return static_cast<int>(cudaErrorInvalidValue);
  copy_unit_kernel<<<static_cast<unsigned>(segments * units_per_seg), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), seg_vectors, units_per_seg);
  return static_cast<int>(cudaGetLastError());
}

const char* srgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
