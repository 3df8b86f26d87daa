// Gaussian density maps: for each image, the sum over its valid heads of a
// unit-mass Gaussian splat on the H x W canvas. Three kernels, one entry.
//
// Replaces the TPU kernel srgan_tpu/ops/density.py::_density_kernel. For
// image b with c = clamp(counts[b], 0, N) valid head slots and
// k = 0.5 / sigma^2:
//
//   g_j[y, x]  = exp(-((y - hy_j)^2 + (x - hx_j)^2) * k)
//   out[b]     = sum_{j < c} g_j / max(sum_{y,x} g_j, 1e-12)
//
// Slots j >= c are never read, so their contents (NaN included) cannot
// reach the output. The divisor is the TPU kernel's max(mass, 1e-12), not
// the NumPy reference's skip of a head whose mass is <= 1e-12: a head far
// outside the canvas contributes g_j * 1e12 here, as on the TPU.
//
// Pass 1, density_mass_kernel: one warp per (image, valid head). The mass
// is separable, sum_y e^{-(y-hy)^2 k} * sum_x e^{-(x-hx)^2 k}: H + W
// exponentials per head instead of H * W, over the whole canvas. It
// stores w = 1 / max(mass, 1e-12) in a [B, N] scratch buffer (slots
// j >= c are left unwritten).
//
// Pass 2, density_render_kernel: a block of 256 threads per 64 x 64 output
// tile of one image and one of `splits` runs of its valid slots, each
// thread a 4 x 4 micro-tile of pixels in registers.
//
// * Culling. R is the least integer with k R^2 > 150 ln 2 (R = 116 at
//   sigma = 8, 29 at sigma = 2). A pair with |y - hy| > R or |x - hx| > R
//   has exp(-d^2 k) < 2^-150, which float32 rounds to 0: its term is 0
//   even at the largest weight, 1e12. The block walks its slots in slot
//   order, a chunk of one head per thread at a time, drops the heads
//   whose +-R box misses the tile and compacts the rest in slot order (a
//   warp ballot, then a prefix over the warps' counts; no atomics, so a
//   run repeats bit for bit). The test is written "drop if far", and a
//   head with a NaN coordinate is never dropped: its NaN reaches every
//   pixel, as in the plain version. A head at +-inf is dropped and adds 0;
//   heads outside the canvas within R of the tile are kept with their
//   weight.
// * Separable sum, register-tiled. For up to kTableHeads kept heads at a
//   time the block writes ey[j][row] = w_j expf(-dy^2 k) for its rows and
//   ex[j][col] = expf(-dx^2 k) for its columns into shared memory (the
//   accurate expf: 128 exponentials per head and tile, not one per
//   pixel; a row or column more than R away gets the exact 0 that float32
//   rounds its factor to, whatever expf's last ulp), then every thread
//   accumulates acc[r][c] = fma(ey[r], ex[c], acc[r][c]) over them in
//   slot order: one FMA per pair, two 16-byte shared loads per 16 FMAs.
//   A warp takes a 16 x 32 block of pixels, so its ey loads touch 4
//   addresses and its ex loads 128 contiguous bytes.
//
// Pass 3, density_sum_kernel, only where splits > 1: each run's blocks
// wrote their partial maps to a [splits, B, H, W] scratch buffer, and
// out = ((p_0 + p_1) + p_2) + ... in run order. One map has only 48 tiles
// of 64 x 64 at 384 x 512, fewer than the card has SMs; its runs of slots
// give the card more blocks without smaller tiles, whose ey/ex tables and
// looser culling cost more than they gain (32 x 64, 32 x 32 and 16 x 32
// tiles measured slower on an H100 at every case; PERF.md, Findings).
//
// What bounds it: operations, float32 FMAs on the CUDA cores. The least
// work of the function is two operations per (pixel, head) pair whose
// term is not 0 (about 1.2e9 pairs at 16 maps of 384 x 512 with 2048
// heads each, sigma = 8); 64 x 64 tiles keep about 1.7x that many. The
// ey/ex tables add 128 exponentials per kept head and tile. The
// separable product rounds differently from exp of the sum: a few ulp,
// inside the tolerance of 1e-6 + 1e-4 |want|.
//
// The launch plan (R and the runs of slots) is made in Python
// (ops/density.py density_plan) and re-checked here; a plan this file
// does not take returns cudaErrorInvalidValue.
//
// The TPU kernel renders one whole image per grid step with its [H, W]
// canvas resident in VMEM and a fori_loop over every slot, masked; here
// blocks run in parallel over tiles, and each walks only valid slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMassWarps = 8;     // heads per block in pass 1
constexpr int kMicro = 4;         // a thread's pixels: kMicro x kMicro
constexpr int kTableHeads = 64;   // kept heads per ey/ex table
constexpr int kMaxSplits = 64;
constexpr int kSumThreads = 256;
// 150 ln 2: exp(-x) rounds to 0 in float32 for x above it (2^-150 is half
// the least subnormal). The same double literal as ops/density.py.
constexpr double kZeroExponent = 103.97207708399179;

__device__ __forceinline__ int valid_heads(const int32_t* counts, int b, int n) {
  return min(max(counts[b], 0), n);
}

__global__ void density_mass_kernel(const float* __restrict__ heads,
                                    const int32_t* __restrict__ counts,
                                    float* __restrict__ weights, int n,
                                    int height, int width, float k) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kMassWarps + (threadIdx.x >> 5);
  // Uniform per warp: a whole warp leaves together, before its shuffles.
  if (j >= valid_heads(counts, b, n)) return;
  const size_t slot = static_cast<size_t>(b) * n + j;
  const float hy = heads[2 * slot];
  const float hx = heads[2 * slot + 1];
  float sy = 0.0f;
  float sx = 0.0f;
  for (int y = lane; y < height; y += 32) {
    const float d = static_cast<float>(y) - hy;
    sy += expf(-(d * d) * k);
  }
  for (int x = lane; x < width; x += 32) {
    const float d = static_cast<float>(x) - hx;
    sx += expf(-(d * d) * k);
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    sy += __shfl_xor_sync(0xffffffffu, sy, offset);
    sx += __shfl_xor_sync(0xffffffffu, sx, offset);
  }
  if (lane == 0) weights[slot] = 1.0f / fmaxf(sy * sx, 1e-12f);
}

// A block's tile, threads and shared memory: the ey and ex tables, the
// kept heads (hy, hx, w) of one chunk, one count per warp.
constexpr int kTile = 64;
constexpr int kThreads = (kTile / kMicro) * (kTile / kMicro);
constexpr int kWarps = kThreads / 32;
constexpr int kSmem = 4 * (kTableHeads * 2 * kTile + 3 * kThreads + kWarps);
static_assert(kSmem <= 48 * 1024, "launched without a shared-memory opt-in");

__global__ void __launch_bounds__(kThreads)
    density_render_kernel(const float* __restrict__ heads,
                          const int32_t* __restrict__ counts,
                          const float* __restrict__ weights,
                          float* __restrict__ out, int batch, int n,
                          int height, int width, float k, float radius,
                          int splits) {
  constexpr int kCols = kTile / kMicro;  // threads along x
  constexpr int kWarpCols = kCols / 8;   // a warp: 4 x 8 threads
  static_assert(kCols % 8 == 0 && (kTile / kMicro) % 4 == 0, "whole warps of 4 x 8 threads");
  extern __shared__ __align__(16) float smem[];
  float* s_ey = smem;                         // [kTableHeads][kTile]
  float* s_ex = s_ey + kTableHeads * kTile;   // [kTableHeads][kTile]
  float* s_hy = s_ex + kTableHeads * kTile;   // [kThreads] kept heads
  float* s_hx = s_hy + kThreads;
  float* s_w = s_hx + kThreads;
  int* s_warp = reinterpret_cast<int*>(s_w + kThreads);  // [kWarps]

  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int ty = (warp / kWarpCols) * 4 + lane / 8;
  const int tx = (warp % kWarpCols) * 8 + lane % 8;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  // The tile's first and last row and column on the canvas.
  const float lo_y = static_cast<float>(y0);
  const float hi_y = static_cast<float>(min(y0 + kTile, height) - 1);
  const float lo_x = static_cast<float>(x0);
  const float hi_x = static_cast<float>(min(x0 + kTile, width) - 1);
  // This block's run of valid slots: [first, last).
  const int count = valid_heads(counts, b, n);
  const int per_split = (count + splits - 1) / splits;
  const int first = min(count, split * per_split);
  const int last = min(count, first + per_split);
  float acc[kMicro][kMicro] = {};

  for (int c0 = first; c0 < last; c0 += kThreads) {
    // Stage one head per thread and decide whether the tile keeps it.
    const int j = c0 + t;
    bool keep = false;
    float hy = 0.f, hx = 0.f, w = 0.f;
    if (j < last) {
      const size_t slot = static_cast<size_t>(b) * n + j;
      hy = heads[2 * slot];
      hx = heads[2 * slot + 1];
      w = weights[slot];
      const bool far = lo_y - hy > radius || hy - hi_y > radius ||
                       lo_x - hx > radius || hx - hi_x > radius;
      keep = !far || isnan(hy) || isnan(hx);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int base = 0;
    int kept = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = s_warp[i];
      base += i < warp ? c : 0;
      kept += c;
    }
    if (keep) {
      const int pos = base + __popc(ballot & ((1u << lane) - 1u));
      s_hy[pos] = hy;
      s_hx[pos] = hx;
      s_w[pos] = w;
    }
    __syncthreads();

    for (int k0 = 0; k0 < kept; k0 += kTableHeads) {
      const int m = min(kTableHeads, kept - k0);
      for (int e = t; e < m * kTile; e += kThreads) {
        const int i = e / kTile;
        const float d = static_cast<float>(y0 + e % kTile) - s_hy[k0 + i];
        s_ey[e] = fabsf(d) > radius ? 0.f : s_w[k0 + i] * expf(-(d * d) * k);
      }
      for (int e = t; e < m * kTile; e += kThreads) {
        const int i = e / kTile;
        const float d = static_cast<float>(x0 + e % kTile) - s_hx[k0 + i];
        s_ex[e] = fabsf(d) > radius ? 0.f : expf(-(d * d) * k);
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < m; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(s_ey + i * kTile + ty * kMicro);
        const float4 c = *reinterpret_cast<const float4*>(s_ex + i * kTile + tx * kMicro);
        const float ar[kMicro] = {a.x, a.y, a.z, a.w};
        const float cr[kMicro] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
#pragma unroll
          for (int q = 0; q < kMicro; ++q) acc[r][q] = fmaf(ar[r], cr[q], acc[r][q]);
        }
      }
      __syncthreads();
    }
  }

  // With splits > 1, out is the [splits, B, H, W] partial maps.
  float* map = out + (static_cast<size_t>(split) * batch + b) * height * width;
  const int x = x0 + tx * kMicro;
  const bool whole = (width % kMicro) == 0 && x + kMicro <= width;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int y = y0 + ty * kMicro + r;
    if (y >= height) break;
    float* row = map + static_cast<size_t>(y) * width;
    if (whole) {
      __stcs(reinterpret_cast<float4*>(row + x),
             make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    } else {
#pragma unroll
      for (int q = 0; q < kMicro; ++q) {
        if (x + q < width) row[x + q] = acc[r][q];
      }
    }
  }
}

// out[p] = ((partial[0][p] + partial[1][p]) + ...) over the runs in order.
__global__ void density_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   long long elems, int splits) {
  const long long p = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (p >= elems) return;
  float acc = partial[p];
  for (int s = 1; s < splits; ++s) acc += partial[s * elems + p];
  out[p] = acc;
}

// The cull radius of k: the least integer R with k R^2 > 150 ln 2.
bool radius_of(float k, int r) {
  const double kk = static_cast<double>(k);
  const double below = static_cast<double>(r - 1);
  return r >= 1 && kk * r * r > kZeroExponent && kk * below * below <= kZeroExponent;
}

}  // namespace

extern "C" {

// heads [B, N, 2] float32 (y, x), counts [B] int32, weights [B, N] float32
// scratch, partial [splits, B, H, W] float32 scratch where splits > 1
// (unread otherwise), out [B, H, W] float32; all contiguous on the
// device. k is 0.5 / sigma^2 in float32. The plan (radius, splits) is
// ops/density.py density_plan's; one whose radius is not k's or whose
// splits are not in [1, 64] returns cudaErrorInvalidValue. Returns the
// first failed launch's cudaError_t (0 on success). Enqueues on `stream`;
// does not synchronize.
int srgan_density_maps(const float* heads, const int32_t* counts,
                       float* weights, float* partial, float* out, int batch,
                       int n, int height, int width, float k, int radius,
                       int splits, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  // gridDim.y and gridDim.z are limited to 65535.
  if (n < 0 || splits < 1 || splits > kMaxSplits ||
      static_cast<long long>(batch) * splits > 65535 || !radius_of(k, radius) ||
      (height + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const dim3 grid((n + kMassWarps - 1) / kMassWarps, batch);
    density_mass_kernel<<<grid, kMassWarps * 32, 0, s>>>(heads, counts, weights,
                                                        n, height, width, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, batch * splits);
  density_render_kernel<<<grid, kThreads, kSmem, s>>>(heads, counts, weights,
                                                     splits > 1 ? partial : out, batch, n,
                                                     height, width, k,
                                                     static_cast<float>(radius), splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long elems = static_cast<long long>(batch) * height * width;
  density_sum_kernel<<<static_cast<unsigned>((elems + kSumThreads - 1) / kSumThreads),
                       kSumThreads, 0, s>>>(partial, out, elems, splits);
  return static_cast<int>(cudaGetLastError());
}

const char* srgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
