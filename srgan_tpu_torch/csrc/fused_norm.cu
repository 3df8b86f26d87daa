// Fused GroupNorm + LeakyReLU: forward, backward, and the backward's own
// VJP (the second order; see second_order_kernel).
//
// Replaces the TPU kernels srgan_tpu/ops/fused_norm.py::_fwd_kernel and
// ::_bwd_kernel. Over x [B, HW, C] (NHWC flattened; C fastest), with
// per-channel scale/bias and `groups` groups of C/groups channels:
//
//   forward   mean, rstd [B, G] = E[x], rsqrt(E[x²] − E[x]² + eps) per
//             (example, group), in float32, with no clamp of the variance;
//             y = act((x − mean)·rstd·scale + bias), act(v) = v > 0 ? v :
//             slope·v, stored in x's dtype.
//   backward  x̂ = (x − mean)·rstd, dy0 = dy·act′(x̂·scale + bias) with
//             act′ = 1 where the pre-activation is > 0, else slope;
//             dbias = Σ_{b,rows} dy0, dscale = Σ_{b,rows} dy0·x̂,
//             dx = rstd·(dx̂ − mean_g(dx̂) − x̂·mean_g(dx̂·x̂)), dx̂ = dy0·scale.
//
// x and dy are float32 or bfloat16; everything is computed in float32.
//
// What bounds it: bytes. Every element takes a handful of flops. At the
// flagship's first discriminator stage (B = 360, 112²×64, bf16) x is 578 MB;
// the forward must read it and write y, the backward read x and dy and
// write dx.
//
// Design. The TPU kernel holds one example's whole [HW, C] slice in VMEM
// and reads it from HBM once. A Hopper block has at most 227 KB of shared
// memory, so here a thread-block cluster takes one example: its `cluster`
// blocks (one per SM, 512 threads each) each own a run of `rows` rows and
// keep the first `resident` of them in shared memory. One thread of a
// block starts bulk copies (cp.async.bulk, completion on an mbarrier per
// chunk) of all the resident rows at once; the block sums each chunk as
// it lands. Each block folds its per-channel sums into group sums, the
// blocks read each other's through distributed shared memory and add them
// in rank order, so every block derives the same group statistics, and
// each block writes its output from shared memory. So x (and dy) leave
// device memory once, and the forward is one launch; the backward is one
// cluster launch that also writes each block's per-channel sums, and a
// small kernel, launched twice, that folds those into dscale/dbias.
// Cross-block sums are fixed-order reads, never atomics: a run repeats
// bit for bit.
//
// The cluster is the smallest that holds the example (ops/fused_norm.py
// `norm_tiling`): at the flagship's bf16 shapes, 8 blocks of ≈200 KB for
// the forward of 112²×64 and 56²×256 (1.6 MB) and 16 for their backward
// (x and dy, 3.2 MB; a non-portable size). The card runs 15 such clusters
// of 8 at once and 7 of 16. A cluster of 8 that keeps x and part of dy
// and reads the rest again measured slower on the H100 than 16 that keep
// both, and so did two smaller blocks per SM. Rows past the resident
// prefix (a slab larger than the cluster's shared memory: float32 at the
// largest stages) are read from device memory in the statistics pass and
// again in the output pass. The tiling (cluster size, rows per block,
// resident rows, shared-memory bytes) is checked here.
//
// Inside a block, threads are laid out as `ct` lanes of V-element vectors
// by `rt` row lanes (V = 16 bytes of x's dtype where C·sizeof(T) and the
// pointers allow it, else 1): consecutive threads take consecutive
// vectors of a row, so every load and store of a warp is one contiguous
// span of 16-byte accesses.
//
// Products and sums that mirror the plain PyTorch version are rounded
// one by one (__fmul_rn, __fadd_rn, __fsub_rn) so that nvcc does not
// contract them into FMAs: the kernel then differs from the plain version
// only through the order of its sums.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChannels = 6144;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;
// Resident rows arrive in at most this many chunks, one mbarrier each:
// the forward's in 4, the backward's (two sources) and the second order's
// (three) in 2. More chunks let
// the statistics pass start sooner but cost a wait each; on the H100 the
// backward measured faster with 2 than with 4 or 8, the forward no faster
// with 8 than with 4.
constexpr int kChunks = 4;
constexpr int kBwdChunks = 2;
// Shared-memory layout, in bytes (ops/fused_norm.py `_smem_bytes` mirrors
// it): kChunks mbarriers; the block's per-channel sums [2, C], its group
// sums and the example's group statistics [2, G ≤ C] in float32; the
// row-lane reduction scratch of kThreads·8 floats; then the resident rows
// of x (and of dy).
constexpr int kBarrierBytes = 128;
constexpr int kScratchBytes = kThreads * 8 * 4;  // V ≤ 8 floats a thread

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

__host__ __device__ constexpr int fixed_smem(int channels) {
  return kBarrierBytes + 3 * align16(2 * channels * 4) + kScratchBytes;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V consecutive elements at p (shared or global memory) as floats: one
// 16- or 8-byte access when V fills 16 or 8 bytes.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_float(e[i]);
  } else if constexpr (V * sizeof(T) == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_float(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else if constexpr (V * sizeof(T) == 8) {
    uint2 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(v[i]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_float<T>(v[i]);
  }
}

// (x − mean)·rstd, rounded as the plain version rounds it.
__device__ __forceinline__ float normalized(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

// x̂·scale + bias.
__device__ __forceinline__ float pre_activation(float xhat, float scale, float bias) {
  return __fadd_rn(__fmul_rn(xhat, scale), bias);
}

// dy·act′ at one element, with x̂ returned through xhat.
__device__ __forceinline__ float masked_grad(float xv, float g, float m, float rs, float ga,
                                             float be, float slope, float& xhat) {
  xhat = normalized(xv, m, rs);
  return pre_activation(xhat, ga, be) > 0.f ? g : __fmul_rn(g, slope);
}

// ---------------------------------------------------------------------------
// mbarriers, bulk copies and the split cluster barrier (PTX, sm_90).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to this block's shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// One block's share of an example.
// ---------------------------------------------------------------------------

struct Tile {
  int hw, channels, groups, cluster, rows, resident;
  float slope, eps;
};

// The block's threads as ct vector lanes × rt row lanes; a thread takes
// the vectors cc, cc + ct, … (`sets` of them, when a row has more vectors
// than the block has threads) of the rows r, r + rt, ….
template <int V>
struct Lanes {
  int cvn, ct, rt, sets, cc, r;
  bool active;
  __device__ explicit Lanes(int channels) {
    cvn = channels / V;
    ct = cvn < kThreads ? cvn : kThreads;
    rt = kThreads / ct;
    sets = (cvn + kThreads - 1) / kThreads;
    cc = threadIdx.x % ct;
    r = threadIdx.x / ct;  // == rt for the idle tail when ct ∤ kThreads
    active = r < rt;
  }
  // The vector of set s, or −1 where the thread has none.
  __device__ int vector(int s) const {
    const int cv = cc + s * ct;
    return active && s < sets && cv < cvn ? cv : -1;
  }
};

// The second order views part, totals and stats (3·align16(8·C) bytes
// in a row) as one run of [5, C] per-channel sums, later [5, G ≤ C] group
// coefficients.
template <typename T>
struct Smem {
  uint64_t* bars;
  float* part;    // [2, C] this block's per-channel sums
  float* totals;  // [2, G] this block's group sums
  float* stats;   // [2, G] the example's group statistics
  float* red;     // [kThreads · 8] row-lane reduction scratch
  T* xs;          // [resident, C]
  T* dys;         // [resident, C], backward and second order
  T* gdxs;        // [resident, C], the cotangent of dx, second order only
  __device__ Smem(unsigned char* base, const Tile& t) {
    const int vec_bytes = align16(2 * t.channels * 4);
    const int rows_bytes = align16(t.resident * t.channels * static_cast<int>(sizeof(T)));
    bars = reinterpret_cast<uint64_t*>(base);
    part = reinterpret_cast<float*>(base + kBarrierBytes);
    totals = reinterpret_cast<float*>(base + kBarrierBytes + vec_bytes);
    stats = reinterpret_cast<float*>(base + kBarrierBytes + 2 * vec_bytes);
    red = reinterpret_cast<float*>(base + kBarrierBytes + 3 * vec_bytes);
    xs = reinterpret_cast<T*>(base + fixed_smem(t.channels));
    dys = reinterpret_cast<T*>(base + fixed_smem(t.channels) + rows_bytes);
    gdxs = reinterpret_cast<T*>(base + fixed_smem(t.channels) + 2 * rows_bytes);
  }
};

// The block's `nres` resident rows of each of N sources (x, and dy in the
// backward, and the cotangent of dx in the second order), in at most
// `max_chunks` ≤ kChunks chunks. With rows of whole 16-byte vectors
// (kBulk), thread 0 starts every chunk at once with one bulk copy per
// source, completing on the chunk's mbarrier, and wait(k) blocks until
// chunk k has landed; otherwise the block copies the rows element by
// element and every chunk is ready at once.
template <typename T, int V, bool kBulk = V * sizeof(T) == 16>
struct Loader {
  uint64_t* bars;
  int chunk_rows, chunks, nres;
  template <int N>
  __device__ Loader(uint64_t* bars_, const T* const (&src)[N], T* const (&dst)[N], int nres_,
                    int channels, int max_chunks)
      : bars(bars_), nres(nres_) {
    chunk_rows = nres > 0 ? (nres + max_chunks - 1) / max_chunks : 1;
    chunks = (nres + chunk_rows - 1) / chunk_rows;
    if constexpr (kBulk) {
      if (threadIdx.x == 0) {
        for (int k = 0; k < chunks; ++k) mbar_init(&bars[k], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int k = 0; k < chunks; ++k) {
          const size_t off = static_cast<size_t>(begin(k)) * channels;
          const uint32_t bytes = static_cast<uint32_t>(end(k) - begin(k)) * channels * sizeof(T);
          mbar_expect_tx(&bars[k], bytes * N);
#pragma unroll
          for (int i = 0; i < N; ++i) bulk_load(dst[i] + off, src[i] + off, bytes, &bars[k]);
        }
      }
    } else {
      const size_t elems = static_cast<size_t>(nres) * channels;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        for (size_t j = threadIdx.x; j < elems; j += kThreads) dst[i][j] = src[i][j];
      }
    }
    __syncthreads();
  }
  __device__ int begin(int k) const { return k * chunk_rows; }
  __device__ int end(int k) const { return min((k + 1) * chunk_rows, nres); }
  __device__ void wait(int k) const {
    if constexpr (kBulk) mbar_wait(&bars[k], 0);
  }
};

// Per-channel sums of the block's rows into out [N, C] (shared or global
// memory): with one thread per vector (rt == 1) each thread has stored
// its sums already; otherwise (one set, ct·V == C) a[q] are each thread's
// sums over its row lanes, summed here over the rt row lanes of each
// channel in a fixed order, through the scratch `red`. Where a warp holds
// whole rows (ct divides 32), its row lanes are summed with an xor tree of
// shuffles first, then the warps' sums in warp order, two sums at a time;
// otherwise the row lanes in order, a sum at a time.
template <int N, int V>
__device__ void reduce_rows(const Lanes<V>& l, float* red, int channels, float (&a)[N][V],
                            float* out) {
  if (l.rt == 1) {
    __syncthreads();
    return;
  }
  constexpr int kWarps = kThreads / 32;
  if (l.ct < 32 && 32 % l.ct == 0) {
    for (int off = 16; off >= l.ct; off >>= 1) {
#pragma unroll
      for (int q = 0; q < N; ++q) {
#pragma unroll
        for (int i = 0; i < V; ++i) a[q][i] += __shfl_xor_sync(0xffffffffu, a[q][i], off);
      }
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int q0 = 0; q0 < N; q0 += 2) {
      const int pair = q0 + 1 < N ? 2 : 1;
      if (lane < l.ct) {  // [2, kWarps, C]: 2·16·C ≤ kThreads·8 floats, C = ct·V ≤ 16·8
#pragma unroll
        for (int q = 0; q < pair; ++q) {
#pragma unroll
          for (int i = 0; i < V; ++i) red[(q * kWarps + warp) * channels + lane * V + i] = a[q0 + q][i];
        }
      }
      __syncthreads();
      for (int j = threadIdx.x; j < pair * channels; j += kThreads) {
        const int q = j / channels, c = j % channels;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += red[(q * kWarps + w) * channels + c];
        out[q0 * channels + j] = acc;
      }
      __syncthreads();
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
#pragma unroll
    for (int i = 0; i < V; ++i) red[threadIdx.x * V + i] = a[q][i];
    __syncthreads();
    for (int j = threadIdx.x; j < channels; j += kThreads) {
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < l.rt; ++k) acc += red[k * channels + j];
      out[q * channels + j] = acc;
    }
    __syncthreads();
  }
}

// A thread's sums of one set: into out [N, C] at once where it alone owns
// the vector.
template <int N, int V>
__device__ __forceinline__ void own_sums(const Lanes<V>& l, float* out, int channels, int cv,
                                         const float (&a)[N][V]) {
  if (l.rt == 1 && cv >= 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
#pragma unroll
      for (int i = 0; i < V; ++i) out[q * channels + cv * V + i] = a[q][i];
    }
  }
}

// Folds the block's per-channel sums s.part into its group sums s.totals
// [2, G], Σ w·part over each group's channels (w = 1 or scale[c]; a
// segment of lanes per group, a fixed xor tree); then, once every block
// of the cluster has its own, each group's sums over the cluster's ranks
// in rank order, calling done(g, s1, s2) with them. Every block derives
// the same values.
template <typename T, typename Done>
__device__ void fold_cluster(cg::cluster_group& cluster, const Smem<T>& s, int nranks,
                             int channels, int groups, const float* weight, Done done) {
  // A group's channels on a segment of `seg` lanes (the power of two at
  // or above C/G, at most 32), 32/seg groups to a warp.
  const int cg_ = channels / groups;
  int seg = 1;
  while (seg < cg_ && seg < 32) seg *= 2;
  const int lane = threadIdx.x % 32;
  const int per_warp = 32 / seg;
  for (int g0 = threadIdx.x / 32 * per_warp; g0 < groups; g0 += kThreads / 32 * per_warp) {
    const int g = g0 + lane / seg;
    float s1 = 0.f, s2 = 0.f;
    if (g < groups) {
      for (int k = lane % seg; k < cg_; k += seg) {
        const int c = g * cg_ + k;
        const float w = weight ? weight[c] : 1.f;
        s1 += w * s.part[c];
        s2 += w * s.part[channels + c];
      }
    }
    for (int off = seg / 2; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (g < groups && lane % seg == 0) {
      s.totals[g] = s1;
      s.totals[groups + g] = s2;
    }
  }
  cluster.sync();
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float v1[kMaxCluster], v2[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      const float* remote = cluster.map_shared_rank(s.totals, q < nranks ? q : 0);
      v1[q] = remote[g];
      v2[q] = remote[groups + g];
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < nranks) {
        s1 += v1[q];
        s2 += v2[q];
      }
    }
    done(g, s1, s2);
  }
  __syncthreads();
}

// A cluster per example (blockIdx.y): the statistics pass over the
// resident chunks as they land (then the streamed rows), the fold through
// distributed shared memory, the output pass from shared memory (then
// the streamed rows read again). The split cluster barrier keeps a block
// from leaving while another may still read its partials.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean,
               float* __restrict__ rstd, Tile t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> s(smem, t);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int C = t.channels;
  const int cg_ = C / t.groups;
  const int row0 = rank * t.rows;
  const int nrows = max(0, min(t.rows, t.hw - row0));
  const int nres = min(t.resident, nrows);
  const size_t base = (static_cast<size_t>(b) * t.hw + row0) * C;
  const T* xb = x + base;
  T* yb = y + base;
  const Lanes<V> l(C);
  const T* const src[1] = {xb};
  T* const dst[1] = {s.xs};
  const Loader<T, V> loader(s.bars, src, dst, nres, C, kChunks);

  // Σx and Σx² per channel, a set at a time: the resident rows chunk by
  // chunk as they land, then the streamed rows from device memory.
  float a[2][V];
  auto accumulate = [&](int cv, const T* rows, int r0, int r1) {
#pragma unroll 4
    for (int row = r0 + l.r; row < r1; row += l.rt) {
      float v[V];
      load<T, V>(rows + static_cast<size_t>(row) * C + cv * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a[0][i] += v[i];
        a[1][i] += v[i] * v[i];
      }
    }
  };
  for (int si = 0; si < l.sets; ++si) {
    const int cv = l.vector(si);
#pragma unroll
    for (int i = 0; i < V; ++i) a[0][i] = a[1][i] = 0.f;
    for (int k = 0; k < loader.chunks; ++k) {
      loader.wait(k);
      if (cv >= 0) accumulate(cv, s.xs, loader.begin(k), loader.end(k));
    }
    if (cv >= 0) accumulate(cv, xb, nres, nrows);
    own_sums(l, s.part, C, cv, a);
  }
  reduce_rows(l, s.red, C, a, s.part);

  // The example's statistics, the same in every block of the cluster.
  const float n = static_cast<float>(t.hw) * static_cast<float>(cg_);
  fold_cluster(
      cluster, s, t.cluster, C, t.groups, nullptr,
      [&](int g, float s1, float s2) {
        const float m = __fdiv_rn(s1, n);
        const float q = __fdiv_rn(s2, n);
        const float rs = rsqrtf(__fadd_rn(__fsub_rn(q, __fmul_rn(m, m)), t.eps));
        s.stats[g] = m;
        s.stats[t.groups + g] = rs;
        if (rank == 0) {
          mean[b * t.groups + g] = m;
          rstd[b * t.groups + g] = rs;
        }
      });
  cluster_arrive();  // done reading the other blocks' partials

  // y a set at a time, from the resident rows, then from the streamed rows
  // read again.
  for (int si = 0; si < l.sets; ++si) {
    const int cv = l.vector(si);
    if (cv < 0) continue;
    float m[V], rs[V], ga[V], be[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = cv * V + i;
      m[i] = s.stats[c / cg_];
      rs[i] = s.stats[t.groups + c / cg_];
      ga[i] = scale[c];
      be[i] = bias[c];
    }
    auto normalize = [&](const T* rows, int r0, int r1) {
#pragma unroll 4
      for (int row = r0 + l.r; row < r1; row += l.rt) {
        const size_t off = static_cast<size_t>(row) * C + cv * V;
        float v[V];
        load<T, V>(rows + off, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float y0 = pre_activation(normalized(v[i], m[i], rs[i]), ga[i], be[i]);
          v[i] = y0 > 0.f ? y0 : __fmul_rn(t.slope, y0);
        }
        store<T, V>(yb + off, v);
      }
    };
    normalize(s.xs, 0, nres);
    normalize(xb, nres, nrows);
  }
  cluster_wait();  // no block leaves while another may read its partials
}

// The backward's cluster pass, a cluster per example as the forward's.
// sums[b, rank] = (Σdy0, Σdy0·x̂) [2, C] over each block's rows, for
// bwd_params_kernel.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ mean,
               const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ sums,
               Tile t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> s(smem, t);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int C = t.channels;
  const int cg_ = C / t.groups;
  const int row0 = rank * t.rows;
  const int nrows = max(0, min(t.rows, t.hw - row0));
  const int nres = min(t.resident, nrows);
  const size_t base = (static_cast<size_t>(b) * t.hw + row0) * C;
  const T* xb = x + base;
  const T* dyb = dy + base;
  T* dxb = dx + base;
  const Lanes<V> l(C);
  const T* const src[2] = {xb, dyb};
  T* const dst[2] = {s.xs, s.dys};
  const Loader<T, V> loader(s.bars, src, dst, nres, C, kBwdChunks);

  // A vector's per-channel constants: the group's mean and rstd, scale,
  // bias.
  float m[V], rs[V], ga[V], be[V];
  auto constants = [&](int cv) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = cv * V + i;
      const int g = b * t.groups + c / cg_;
      m[i] = mean[g];
      rs[i] = rstd[g];
      ga[i] = scale[c];
      be[i] = bias[c];
    }
  };

  // Σdy0 and Σdy0·x̂ per channel, a set at a time.
  float a[2][V];
  auto accumulate = [&](int cv, const T* xr, const T* dyr, int r0, int r1) {
#pragma unroll 2
    for (int row = r0 + l.r; row < r1; row += l.rt) {
      const size_t off = static_cast<size_t>(row) * C + cv * V;
      float xv[V], gv[V];
      load<T, V>(xr + off, xv);
      load<T, V>(dyr + off, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float xhat;
        const float dy0 = masked_grad(xv[i], gv[i], m[i], rs[i], ga[i], be[i], t.slope, xhat);
        a[0][i] += dy0;
        a[1][i] += dy0 * xhat;
      }
    }
  };
  for (int si = 0; si < l.sets; ++si) {
    const int cv = l.vector(si);
#pragma unroll
    for (int i = 0; i < V; ++i) a[0][i] = a[1][i] = 0.f;
    if (cv >= 0) constants(cv);
    for (int k = 0; k < loader.chunks; ++k) {
      loader.wait(k);
      if (cv >= 0) accumulate(cv, s.xs, s.dys, loader.begin(k), loader.end(k));
    }
    if (cv >= 0) accumulate(cv, xb, dyb, nres, nrows);
    own_sums(l, s.part, C, cv, a);
  }
  reduce_rows(l, s.red, C, a, s.part);

  // The block's per-channel sums for dscale and dbias, and the group means
  // of dx̂ and dx̂·x̂ over the example (Σdx̂ = scale·Σdy0 within a channel,
  // so two accumulators serve all four sums of the TPU kernel).
  float* sb = sums + (static_cast<size_t>(b) * t.cluster + rank) * 2 * C;
  for (int j = threadIdx.x; j < 2 * C; j += kThreads) sb[j] = s.part[j];
  const float n = static_cast<float>(t.hw) * static_cast<float>(cg_);
  fold_cluster(
      cluster, s, t.cluster, C, t.groups, scale,
      [&](int g, float s1, float s2) {
        s.stats[g] = __fdiv_rn(s1, n);
        s.stats[t.groups + g] = __fdiv_rn(s2, n);
      });
  cluster_arrive();

  // dx a set at a time, from the resident rows, then the streamed rows.
  for (int si = 0; si < l.sets; ++si) {
    const int cv = l.vector(si);
    if (cv < 0) continue;
    constants(cv);
    float m1[V], m2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int g = (cv * V + i) / cg_;
      m1[i] = s.stats[g];
      m2[i] = s.stats[t.groups + g];
    }
    auto gradient = [&](const T* xr, const T* dyr, int r0, int r1) {
#pragma unroll 2
      for (int row = r0 + l.r; row < r1; row += l.rt) {
        const size_t off = static_cast<size_t>(row) * C + cv * V;
        float xv[V], gv[V];
        load<T, V>(xr + off, xv);
        load<T, V>(dyr + off, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float xhat;
          const float dxhat = __fmul_rn(
              masked_grad(xv[i], gv[i], m[i], rs[i], ga[i], be[i], t.slope, xhat), ga[i]);
          xv[i] = __fmul_rn(rs[i], __fsub_rn(__fsub_rn(dxhat, m1[i]), __fmul_rn(xhat, m2[i])));
        }
        store<T, V>(dxb + off, xv);
      }
    };
    gradient(s.xs, s.dys, 0, nres);
    gradient(xb, dyb, nres, nrows);
  }
  cluster_wait();
}

// The second order: the VJP of the backward map (x, scale, bias, dy) ↦
// (dx, dscale, dbias) at the cotangents (g_dx, g_dscale, g_dbias), mean
// and rstd differentiated as functions of x, the activation's mask held
// constant (so g_bias = 0); ops/fused_norm.py
// `group_norm_act_bwd_vjp_plain` is its spec and derivation. No TPU
// kernel: the JAX package differentiates `_reference_bwd` by its
// `custom_jvp` rule, and the gradient penalty's outer gradient takes it
// through each of D's norms at the interpolates. With x̂ = (x − mean)·rstd,
// e = dy·mask, a = e·scale and r = rstd, over each (example, group) of
// n = HW·C/G elements:
//
//   α    = r·(g_dx − u − x̂·v),  u = Σg_dx/n, v = Σg_dx·x̂/n
//   g_dy = mask·(g_dscale·x̂ + g_dbias + scale·α)
//   g_x  = r·(g_dscale − scale·r·v)·e − r²·(Σa·x̂/n)·g_dx − r·Σh/n
//          − x̂·r·(Σh·x̂ + ρ·r)/n
//   g_scale = Σ_{b,rows} e·α
//
// with ρ = Σg_dx·a − Σa·u − Σa·x̂·v, Σh = Σg_dscale·e − r·(Σa·v + Σa·x̂·u)
// and Σh·x̂ = Σg_dscale·e·x̂ − 2·r·Σa·x̂·v. Bytes bound it as they bound the
// backward: read x, dy and g_dx, write g_x and g_dy. So it is the
// backward's cluster pass with three sources resident: a first pass of
// per-channel sums (Σe, Σe·x̂, Σg_dx·e, Σg_dx, Σg_dx·x̂) that gives the
// seven group sums of the block, an exchange of those over the cluster,
// and an elementwise pass that writes g_x and g_dy from shared memory and
// sums each channel's e·α for second_order_params_kernel.
//
// The group sums go through device memory, not distributed shared memory:
// seven a group for any group count do not fit beside [5, C] per-channel
// sums at C = G = 6144. Each block writes its own (group_sums[b, rank],
// [7, G]) before the cluster barrier (release, acquire) and reads the
// cluster's through L2 after it, in rank order, so every block derives the
// same coefficients. Vectors are 4 elements (8 bytes of bfloat16): the
// elementwise pass holds 12 per-channel constants a vector in registers.
struct SecondOrder {
  const void* x;
  const void* dy;
  const void* g_dx;
  const float* scale;
  const float* bias;
  const float* mean;
  const float* rstd;
  const float* g_dscale;
  const float* g_dbias;
  void* g_x;
  void* g_dy;
  float* sums;        // [batch·cluster, C] each block's Σe·α, then the fold's [kFoldRuns, C]
  float* group_sums;  // [batch, cluster, 7, G] each block's group sums
};

constexpr int kGroupSums = 7;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) second_order_kernel(SecondOrder p, Tile t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> s(smem, t);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int C = t.channels;
  const int G = t.groups;
  const int cg_ = C / G;
  const int row0 = rank * t.rows;
  const int nrows = max(0, min(t.rows, t.hw - row0));
  const int nres = min(t.resident, nrows);
  const size_t base = (static_cast<size_t>(b) * t.hw + row0) * C;
  const T* xb = static_cast<const T*>(p.x) + base;
  const T* dyb = static_cast<const T*>(p.dy) + base;
  const T* gb = static_cast<const T*>(p.g_dx) + base;
  T* gxb = static_cast<T*>(p.g_x) + base;
  T* gdyb = static_cast<T*>(p.g_dy) + base;
  const Lanes<V> l(C);
  const T* const src[3] = {xb, dyb, gb};
  T* const dst[3] = {s.xs, s.dys, s.gdxs};
  const Loader<T, V, (V != 1)> loader(s.bars, src, dst, nres, C, kBwdChunks);

  float m[V], rs[V], ga[V], be[V];
  auto constants = [&](int cv) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = cv * V + i;
      const int g = b * G + c / cg_;
      m[i] = p.mean[g];
      rs[i] = p.rstd[g];
      ga[i] = p.scale[c];
      be[i] = p.bias[c];
    }
  };

  // Σe, Σe·x̂, Σg_dx·e, Σg_dx and Σg_dx·x̂ per channel, a set at a time.
  float a[5][V];
  auto accumulate = [&](int cv, const T* xr, const T* dyr, const T* gr, int r0, int r1) {
#pragma unroll 2
    for (int row = r0 + l.r; row < r1; row += l.rt) {
      const size_t off = static_cast<size_t>(row) * C + cv * V;
      float xv[V], ev[V], gv[V];
      load<T, V>(xr + off, xv);
      load<T, V>(dyr + off, ev);
      load<T, V>(gr + off, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float xhat;
        const float e = masked_grad(xv[i], ev[i], m[i], rs[i], ga[i], be[i], t.slope, xhat);
        a[0][i] += e;
        a[1][i] += e * xhat;
        a[2][i] += gv[i] * e;
        a[3][i] += gv[i];
        a[4][i] += gv[i] * xhat;
      }
    }
  };
  for (int si = 0; si < l.sets; ++si) {
    const int cv = l.vector(si);
#pragma unroll
    for (int q = 0; q < 5; ++q) {
#pragma unroll
      for (int i = 0; i < V; ++i) a[q][i] = 0.f;
    }
    if (cv >= 0) constants(cv);
    for (int k = 0; k < loader.chunks; ++k) {
      loader.wait(k);
      if (cv >= 0) accumulate(cv, s.xs, s.dys, s.gdxs, loader.begin(k), loader.end(k));
    }
    if (cv >= 0) accumulate(cv, xb, dyb, gb, nres, nrows);
    own_sums(l, s.part, C, cv, a);
  }
  reduce_rows(l, s.red, C, a, s.part);

  // The block's seven group sums, weighted by scale and g_dscale over each
  // group's channels (a segment of lanes per group, a fixed xor tree, as
  // fold_cluster), into device memory: Σa, Σa·x̂, Σg_dx, Σg_dx·x̂, Σg_dx·a,
  // Σg_dscale·e, Σg_dscale·e·x̂.
  {
    float* mine = p.group_sums + (static_cast<size_t>(b) * t.cluster + rank) * kGroupSums * G;
    int seg = 1;
    while (seg < cg_ && seg < 32) seg *= 2;
    const int lane = threadIdx.x % 32;
    const int per_warp = 32 / seg;
    for (int g0 = threadIdx.x / 32 * per_warp; g0 < G; g0 += kThreads / 32 * per_warp) {
      const int g = g0 + lane / seg;
      float v[kGroupSums] = {};
      if (g < G) {
        for (int k = lane % seg; k < cg_; k += seg) {
          const int c = g * cg_ + k;
          const float w = p.scale[c], pd = p.g_dscale[c];
          const float e = s.part[c], ex = s.part[C + c], ge = s.part[2 * C + c];
          v[0] += w * e;
          v[1] += w * ex;
          v[2] += s.part[3 * C + c];
          v[3] += s.part[4 * C + c];
          v[4] += w * ge;
          v[5] += pd * e;
          v[6] += pd * ex;
        }
      }
      for (int off = seg / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < kGroupSums; ++q) v[q] += __shfl_xor_sync(0xffffffffu, v[q], off);
      }
      if (g < G && lane % seg == 0) {
#pragma unroll
        for (int q = 0; q < kGroupSums; ++q) __stcg(mine + q * G + g, v[q]);
      }
    }
  }
  __threadfence();
  cluster_arrive();
  cluster_wait();

  // The example's coefficients of each group, from the cluster's group sums
  // in rank order, over the spent per-channel sums: [5, G] of r·u, r·v,
  // −r²·Σa·x̂/n, −r·Σh/n and −r·(Σh·x̂ + ρ·r)/n.
  float* coef = s.part;
  {
    const float n = static_cast<float>(t.hw) * static_cast<float>(cg_);
    const float* all = p.group_sums + static_cast<size_t>(b) * t.cluster * kGroupSums * G;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      float v[kGroupSums] = {};
      for (int q = 0; q < t.cluster; ++q) {
#pragma unroll
        for (int k = 0; k < kGroupSums; ++k) v[k] += __ldcg(all + (q * kGroupSums + k) * G + g);
      }
      const float r = p.rstd[b * G + g];
      const float u = v[2] / n, vv = v[3] / n;
      const float rho = v[4] - v[0] * u - v[1] * vv;
      const float h0 = v[5] - r * (v[0] * vv + v[1] * u);
      const float h1 = v[6] - 2.f * r * v[1] * vv;
      coef[g] = r * u;
      coef[G + g] = r * vv;
      coef[2 * G + g] = -r * r * v[1] / n;
      coef[3 * G + g] = -r * h0 / n;
      coef[4 * G + g] = -r * (h1 + rho * r) / n;
    }
  }
  __syncthreads();

  // g_x and g_dy a set at a time, from the resident rows, then the
  // streamed rows read again; each channel's Σe·α into sums[b, rank].
  float* row_sums = p.sums + (static_cast<size_t>(b) * t.cluster + rank) * C;
  float ea[1][V];
  for (int si = 0; si < l.sets; ++si) {
    const int cv = l.vector(si);
#pragma unroll
    for (int i = 0; i < V; ++i) ea[0][i] = 0.f;
    if (cv >= 0) {
      constants(cv);
      float ru[V], rv[V], fg[V], f0[V], fx[V], pd[V], qd[V], fe[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = cv * V + i;
        const int g = c / cg_;
        ru[i] = coef[g];
        rv[i] = coef[G + g];
        fg[i] = coef[2 * G + g];
        f0[i] = coef[3 * G + g];
        fx[i] = coef[4 * G + g];
        pd[i] = p.g_dscale[c];
        qd[i] = p.g_dbias[c];
        fe[i] = rs[i] * (pd[i] - ga[i] * rv[i]);
      }
      auto outputs = [&](const T* xr, const T* dyr, const T* gr, int r0, int r1) {
#pragma unroll 2
        for (int row = r0 + l.r; row < r1; row += l.rt) {
          const size_t off = static_cast<size_t>(row) * C + cv * V;
          float xv[V], dv[V], gv[V];
          load<T, V>(xr + off, xv);
          load<T, V>(dyr + off, dv);
          load<T, V>(gr + off, gv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xhat = normalized(xv[i], m[i], rs[i]);
            const bool pos = pre_activation(xhat, ga[i], be[i]) > 0.f;
            const float e = pos ? dv[i] : __fmul_rn(dv[i], t.slope);
            const float alpha = rs[i] * gv[i] - ru[i] - rv[i] * xhat;
            const float inner = pd[i] * xhat + qd[i] + ga[i] * alpha;
            ea[0][i] += e * alpha;
            dv[i] = pos ? inner : t.slope * inner;
            xv[i] = fe[i] * e + fg[i] * gv[i] + f0[i] + fx[i] * xhat;
          }
          store<T, V>(gxb + off, xv);
          store<T, V>(gdyb + off, dv);
        }
      };
      outputs(s.xs, s.dys, s.gdxs, 0, nres);
      outputs(xb, dyb, gb, nres, nrows);
    }
    own_sums(l, row_sums, C, cv, ea);
  }
  reduce_rows(l, s.red, C, ea, row_sums);
}

// dbias[c] = Σ_r sums[r, 0, c], dscale[c] = Σ_r sums[r, 1, c] over the
// batch·cluster rows of [2, C] sums, in two launches of bwd_params_kernel
// and a fixed order, so a run repeats: first kFoldRuns runs of rows, each
// into a row of partial sums [kFoldRuns, 2, C] after the sums; then those
// rows, in run order, into dbias and dscale. In a launch a block takes 32
// entries of [2, C] and one run (blockIdx.y) of `run` rows; each of its
// kParamWarps warps sums every kParamWarps-th row of the run, then warp 0
// adds the warps' sums in warp order. The first launch spreads the sums
// (up to 6 MB) over many SMs: one block per 32 entries would read them
// with the few loads in flight of one SM each. second_order_params_kernel
// folds the second order's [C] rows of Σe·α into g_scale the same way.
constexpr int kParamWarps = 16;
constexpr int kFoldRuns = 32;

// One launch of the fold over rows of `width` entries: into out's row of
// partial sums, or (out null) through store(j, total).
template <typename Store>
__device__ __forceinline__ void fold_rows(const float* __restrict__ in, float* __restrict__ out,
                                          int rows, int run, int width, Store store) {
  __shared__ float part[kParamWarps][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + lane;
  const int seg = static_cast<int>(blockIdx.y);
  const int r1 = min(rows, (seg + 1) * run);
  float acc = 0.f;
  if (j < width) {
#pragma unroll 4
    for (int r = seg * run + w; r < r1; r += kParamWarps) {
      acc += in[static_cast<size_t>(r) * width + j];
    }
  }
  part[w][lane] = acc;
  __syncthreads();
  if (w == 0 && j < width) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kParamWarps; ++k) total += part[k][lane];
    if (out) {
      out[static_cast<size_t>(seg) * width + j] = total;
    } else {
      store(j, total);
    }
  }
}

__global__ void __launch_bounds__(kParamWarps * 32)
    bwd_params_kernel(const float* __restrict__ in, float* __restrict__ out,
                      float* __restrict__ dscale, float* __restrict__ dbias, int rows, int run,
                      int channels) {
  fold_rows(in, out, rows, run, 2 * channels, [=](int j, float total) {
    if (j < channels) {
      dbias[j] = total;
    } else {
      dscale[j - channels] = total;
    }
  });
}

// g_scale[c] = Σ_r sums[r, c]; g_bias = 0.
__global__ void __launch_bounds__(kParamWarps * 32)
    second_order_params_kernel(const float* __restrict__ in, float* __restrict__ out,
                               float* __restrict__ g_scale, float* __restrict__ g_bias,
                               int rows, int run, int channels) {
  fold_rows(in, out, rows, run, channels, [=](int j, float total) {
    g_scale[j] = total;
    g_bias[j] = 0.f;
  });
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

int shape_error(int batch, const Tile& t, int smem, int tensors, int elem) {
  if (batch <= 0 || batch > 65535 || t.hw <= 0 || t.channels <= 0 ||
      t.channels > kMaxChannels || t.groups <= 0 || t.channels % t.groups != 0 ||
      t.cluster <= 0 || t.cluster > kMaxCluster || t.rows <= 0 || t.resident < 0 ||
      t.resident > t.rows || static_cast<long long>(t.rows) * (t.cluster - 1) >= t.hw ||
      static_cast<long long>(t.rows) * t.cluster < t.hw || smem > kMaxSmem ||
      smem < fixed_smem(t.channels) +
                 tensors * ((static_cast<long long>(t.resident) * t.channels * elem + 15) / 16 *
                            16)) {
    return kInvalid;
  }
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Raises the kernel's shared-memory limit to `smem` (where it is lower,
// once per device) and allows clusters of more than 8 blocks; then fills
// `cfg` for a grid of (cluster, batch).
template <auto Kernel>
int configure(const Tile& t, int batch, int smem, cudaStream_t stream, cudaLaunchConfig_t& cfg,
              cudaLaunchAttribute& attr) {
  constexpr int kDevices = 64;
  static int smem_set[kDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && (device >= kDevices || smem > smem_set[device])) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e == cudaSuccess && device < kDevices) smem_set[device] = smem;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(t.cluster, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = t.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

int launched(cudaError_t e) {
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_fwd(const void* x, const float* scale, const float* bias, void* y, float* mean,
               float* rstd, int batch, const Tile& t, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int e = configure<fwd_kernel<T, V>>(t, batch, smem, stream, cfg, attr)) return e;
  return launched(cudaLaunchKernelEx(&cfg, fwd_kernel<T, V>, static_cast<const T*>(x), scale, bias,
                                     static_cast<T*>(y), mean, rstd, t));
}

template <typename T, int V>
int launch_bwd(const void* x, const float* scale, const float* bias, const float* mean,
               const float* rstd, const void* dy, void* dx, float* dscale, float* dbias,
               float* sums, int batch, const Tile& t, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int e = configure<bwd_kernel<T, V>>(t, batch, smem, stream, cfg, attr)) return e;
  if (int e = launched(cudaLaunchKernelEx(&cfg, bwd_kernel<T, V>, static_cast<const T*>(x),
                                          static_cast<const T*>(dy), scale, bias, mean, rstd,
                                          static_cast<T*>(dx), sums, t))) {
    return e;
  }
  const int rows = batch * t.cluster;
  float* partial = sums + static_cast<size_t>(rows) * 2 * t.channels;
  const int blocks = (2 * t.channels + 31) / 32;
  bwd_params_kernel<<<dim3(blocks, kFoldRuns), kParamWarps * 32, 0, stream>>>(
      sums, partial, nullptr, nullptr, rows, (rows + kFoldRuns - 1) / kFoldRuns, t.channels);
  bwd_params_kernel<<<blocks, kParamWarps * 32, 0, stream>>>(
      partial, nullptr, dscale, dbias, kFoldRuns, kFoldRuns, t.channels);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_second_order(const SecondOrder& p, float* g_scale, float* g_bias, int batch,
                        const Tile& t, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int e = configure<second_order_kernel<T, V>>(t, batch, smem, stream, cfg, attr)) return e;
  if (int e = launched(cudaLaunchKernelEx(&cfg, second_order_kernel<T, V>, p, t))) return e;
  const int rows = batch * t.cluster;
  float* partial = p.sums + static_cast<size_t>(rows) * t.channels;
  const int blocks = (t.channels + 31) / 32;
  second_order_params_kernel<<<dim3(blocks, kFoldRuns), kParamWarps * 32, 0, stream>>>(
      p.sums, partial, nullptr, nullptr, rows, (rows + kFoldRuns - 1) / kFoldRuns, t.channels);
  second_order_params_kernel<<<blocks, kParamWarps * 32, 0, stream>>>(
      partial, nullptr, g_scale, g_bias, kFoldRuns, kFoldRuns, t.channels);
  return static_cast<int>(cudaGetLastError());
}

template <auto Kernel>
int max_clusters(const Tile& t, int smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int e = configure<Kernel>(t, 1, smem, nullptr, cfg, attr)) return e;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, Kernel, &cfg));
}

template <typename T>
bool vectorized(int channels, std::initializer_list<const void*> ptrs) {
  if ((channels * sizeof(T)) % 16 != 0) return false;
  for (const void* p : ptrs) {
    if (!aligned16(p)) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// x, y: [batch, hw, channels] in `dtype` (1 = float32, 2 = bfloat16),
// contiguous. scale, bias: [channels] float32. mean, rstd: [batch, groups]
// float32. The tiling: a cluster of `cluster` blocks per example, each
// block owning `rows` rows (the last may own fewer, none owns none) of
// which the first `resident` are held in `smem` bytes of shared memory
// (at least the layout's need, at most 227 KB). Returns cudaErrorInvalidValue for what the kernel
// does not take, else the launch's cudaError_t. Enqueues on `stream`;
// does not synchronize.
int srgan_group_norm_act_fwd(const void* x, const float* scale, const float* bias, void* y,
                             float* mean, float* rstd, int dtype, int batch, int hw, int channels,
                             int groups, int cluster, int rows, int resident, int smem,
                             float slope, float eps, void* stream) {
  const Tile t{hw, channels, groups, cluster, rows, resident, slope, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      if (int e = shape_error(batch, t, smem, 1, 4)) return e;
      return vectorized<float>(channels, {x, y})
                 ? launch_fwd<float, 4>(x, scale, bias, y, mean, rstd, batch, t, smem, s)
                 : launch_fwd<float, 1>(x, scale, bias, y, mean, rstd, batch, t, smem, s);
    case 2:
      if (int e = shape_error(batch, t, smem, 1, 2)) return e;
      return vectorized<__nv_bfloat16>(channels, {x, y})
                 ? launch_fwd<__nv_bfloat16, 8>(x, scale, bias, y, mean, rstd, batch, t, smem,
                                                s)
                 : launch_fwd<__nv_bfloat16, 1>(x, scale, bias, y, mean, rstd, batch, t, smem,
                                                s);
    default:
      return kInvalid;
  }
}

// x, dy, dx: [batch, hw, channels] in `dtype`, contiguous. scale, bias,
// dscale, dbias: [channels] float32. mean, rstd: [batch, groups] float32
// from the forward. sums: scratch [batch·cluster + 32, 2, channels]
// float32 (the blocks' sums, then the fold's partial sums).
// The tiling as the forward's, with x's and dy's resident rows both in
// `smem`. Returns as the forward does.
int srgan_group_norm_act_bwd(const void* x, const float* scale, const float* bias,
                             const float* mean, const float* rstd, const void* dy, void* dx,
                             float* dscale, float* dbias, float* sums, int dtype, int batch, int hw,
                             int channels, int groups, int cluster, int rows, int resident,
                             int smem, float slope, void* stream) {
  const Tile t{hw, channels, groups, cluster, rows, resident, slope, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      if (int e = shape_error(batch, t, smem, 2, 4)) return e;
      return vectorized<float>(channels, {x, dy, dx})
                 ? launch_bwd<float, 4>(x, scale, bias, mean, rstd, dy, dx, dscale, dbias, sums,
                                        batch, t, smem, s)
                 : launch_bwd<float, 1>(x, scale, bias, mean, rstd, dy, dx, dscale, dbias, sums,
                                        batch, t, smem, s);
    case 2:
      if (int e = shape_error(batch, t, smem, 2, 2)) return e;
      return vectorized<__nv_bfloat16>(channels, {x, dy, dx})
                 ? launch_bwd<__nv_bfloat16, 8>(x, scale, bias, mean, rstd, dy, dx, dscale, dbias,
                                                sums, batch, t, smem, s)
                 : launch_bwd<__nv_bfloat16, 1>(x, scale, bias, mean, rstd, dy, dx, dscale, dbias,
                                                sums, batch, t, smem, s);
    default:
      return kInvalid;
  }
}

// x, dy, g_dx, g_x, g_dy: [batch, hw, channels] in `dtype`, contiguous.
// scale, bias, g_dscale, g_dbias, g_scale, g_bias: [channels] float32.
// mean, rstd: [batch, groups] float32 from the forward. sums: scratch
// [batch·cluster + 32, channels] float32 (the blocks' Σe·α, then the
// fold's partial sums); group_sums: scratch [batch, cluster, 7, groups]
// float32. The tiling as the backward's, with x's, dy's and g_dx's
// resident rows in `smem`. Returns as the forward does.
int srgan_group_norm_act_second_order(const void* x, const float* scale, const float* bias,
                                      const float* mean, const float* rstd, const void* dy,
                                      const void* g_dx, const float* g_dscale,
                                      const float* g_dbias, void* g_x, float* g_scale,
                                      float* g_bias, void* g_dy, float* sums, float* group_sums,
                                      int dtype, int batch, int hw, int channels, int groups,
                                      int cluster, int rows, int resident, int smem, float slope,
                                      void* stream) {
  const Tile t{hw, channels, groups, cluster, rows, resident, slope, 0.f};
  const SecondOrder p{x,        dy,      g_dx, scale, bias, mean,      rstd,
                      g_dscale, g_dbias, g_x,  g_dy,  sums, group_sums};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      if (int e = shape_error(batch, t, smem, 3, 4)) return e;
      return vectorized<float>(channels, {x, dy, g_dx, g_x, g_dy})
                 ? launch_second_order<float, 4>(p, g_scale, g_bias, batch, t, smem, s)
                 : launch_second_order<float, 1>(p, g_scale, g_bias, batch, t, smem, s);
    case 2:
      if (int e = shape_error(batch, t, smem, 3, 2)) return e;
      return vectorized<__nv_bfloat16>(channels, {x, dy, g_dx, g_x, g_dy})
                 ? launch_second_order<__nv_bfloat16, 4>(p, g_scale, g_bias, batch, t, smem, s)
                 : launch_second_order<__nv_bfloat16, 1>(p, g_scale, g_bias, batch, t, smem, s);
    default:
      return kInvalid;
  }
}

// How many clusters of the 16-byte-vector kernel (`kind` 0 forward, 1
// backward, 2 second order; the second order's vectors are 4 elements)
// at this tiling the card holds at once (cudaOccupancyMaxActiveClusters),
// through *clusters; returns the cudaError_t.
int srgan_group_norm_act_max_clusters(int dtype, int kind, int cluster, int smem,
                                      int* clusters) {
  const Tile t{1, 8, 1, cluster, 1, 0, 0.f, 0.f};
  if (dtype == 1) {
    switch (kind) {
      case 0: return max_clusters<fwd_kernel<float, 4>>(t, smem, clusters);
      case 1: return max_clusters<bwd_kernel<float, 4>>(t, smem, clusters);
      case 2: return max_clusters<second_order_kernel<float, 4>>(t, smem, clusters);
    }
  } else if (dtype == 2) {
    switch (kind) {
      case 0: return max_clusters<fwd_kernel<__nv_bfloat16, 8>>(t, smem, clusters);
      case 1: return max_clusters<bwd_kernel<__nv_bfloat16, 8>>(t, smem, clusters);
      case 2: return max_clusters<second_order_kernel<__nv_bfloat16, 4>>(t, smem, clusters);
    }
  }
  return kInvalid;
}

const char* srgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
