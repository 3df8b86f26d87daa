// Random patch samplers: gather, crop, flip and normalize in one pass,
// and the same with a per-example rescale. One kernel template,
// sampler_kernel<T, C, rescale>, behind two entries.
//
// Both replace the TPU kernel srgan_tpu/ops/patches.py::_make_rows_kernel
// (:49, launched through pl.pallas_call at :156) together with its XLA
// tail: the x-window slice and the flip of extract_patches, and for the
// rescale the per-scale window slices, jax.image.resize, the mass factor,
// the one-hot select and the flip of extract_rescaled_patches.
//
// 1. The fixed sampler (srgan_extract_patches). For each example b:
//
//   out[b, y, x, c] = src[idx[b], oy[b] + y, ox[b] + (flip[b] ? P-1-x : x), c]
//                     * scale + shift
//
// 2. The rescale sampler (srgan_extract_rescaled_patches). For each
// example b, with s = scale_idx[b] and ws = window_sizes[s]:
//
//   win[j, i, c] = src[idx[b], oy[b] + j, ox[b] + i, c] * scale + shift
//   r[y, x, c]   = sum_j sum_i Wy[y, j] Wx[x, i] win[j, i, c]   (ws != P)
//                = win[y, x, c]                                 (ws == P)
//   out[b, y, flip[b] ? P-1-x : x, c] = r[y, x, c] * (preserve_mass ? (ws/P)^2 : 1)
//
// W is JAX's antialiased bilinear weight matrix (ops/patches.py
// resize_weights), given as a tap table: per window size and output
// coordinate o, a first source index first[s, o] and K weights for the
// sources first + k (K = 3 for 280 -> 224). The TPU version DMAs the rows
// of the largest window and resizes every candidate size, then selects
// one; this kernel computes only the selected size (multiplying by the
// one-hot 0/1 changes nothing for finite values).
//
// src is [N, H, W, C] (uint8, float32 or bfloat16, contiguous); out is
// [B, P, P, C] float32, contiguous. Bounds are the caller's contract, as in
// the JAX package: every window lies inside its image.
//
// What bounds them: bytes. Each output element takes one multiply-add (a
// few K-tap sums for the rescale). At the flagship image call (B = 120,
// P = 224, C = 3, uint8) the fixed sampler reads 18 MB of windows and
// writes 72 MB of float32 (0.027 ms at 3.35 TB/s); the rescale reads
// 19 MB over windows of 168/224/280 and writes the same.
//
// Design. A thread per output element, each with one 1-byte load, keeps
// about 2 KB of reads in flight on an SM where the card needs some 15-20
// KB; a block per output row spends most of its life in a chain of
// dependent loads (the example's draws, then its scale's table, then the
// image) for a few KB of work. So here:
//
// - A block takes a tile of `rows` output rows of one example (the launch
//   plan, ops/patches.py sampler_plan: 8 rows of 128 threads at the
//   flagship's calls, 3360 blocks) and reads the example's draws once.
// - It stages the source rows the tile needs in shared memory: each row's
//   whole 16-byte vectors by cp.async, all of the block's in flight at
//   once, and the partial vectors at the two ends of a row by element
//   copies, so nothing outside the window is read. A row lands at its
//   device address modulo 16, whatever W·C and ox.
// - It writes the tile's rows, contiguous in out, as 16-byte streaming
//   stores (the output is not read again by this kernel, so it does not
//   hold L2 lines that the next blocks' windows could use), reading the
//   staged row backwards pixel by pixel under a flip, channels in order;
//   element stores where a row is not a whole number of float4.
// - The rescale also brings its scale's tap table into shared memory by
//   4-byte cp.async, issued before the rows (a coordinate x at slot(x), so
//   that the x-pass reads consecutive words); stages the window's rows
//   from first[y0] to first[y1] + K - 1, clipped to the window; and, four
//   output rows at a time, contracts them along y into float32 rows in
//   shared memory (four elements a thread) and then along x (four output
//   pixels a thread, C float4 stores). A window of side P takes the fixed
//   sampler's copy.
//
// Measured on the H100 (PERF.md): the fixed sampler's image call at about
// two thirds of its bound; the rescale's at about 40%. A block's life is
// its loads' latency, then its two passes; tried and dropped there, none
// faster: persistent blocks with the next tile's rows in flight, rows
// shifted into alignment and read 16 bytes at a time, the source rows
// normalized once into float32, a register window sliding down the rows.
//
// Rounding, the same as the plain PyTorch version and bit for bit the
// same as this file's earlier one-element-a-thread kernels: x * scale +
// shift rounds the multiply and the add separately (__fmul_rn, __fadd_rn;
// never an FMA), each tap's source value is normalized just before its
// __fmaf_rn, the contractions accumulate from 0 in tap order (y, then x),
// a tap past the window ends the sum, and the mass factor multiplies
// last. A window of side P is copied and multiplied by its factor 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: the most shared memory a block may take
constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
// The rescale contracts a tile's rows along y and then along x this many
// rows at a time, so that its float32 rows take little shared memory.
constexpr int kVrowRows = 4;
// The rescale's tap loops are unrolled up to this many taps (K = 3 for
// windows of 0.75 to 1.25 times the patch), and run as loops beyond.
constexpr int kMaxTaps = 4;

__host__ __device__ constexpr long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

// Shared-memory bytes of one staged row of `elems` elements of `itemsize`
// bytes: the 16-byte vectors that cover a span starting anywhere within
// one.
__host__ __device__ constexpr long long row_stride(long long elems, int itemsize) {
  return align16(elems * itemsize + 15);
}

// A source value as float32, exactly. A uint8 value v becomes the float
// 2^23 + v, by placing its byte in the mantissa of 2^23 (one byte permute),
// less 2^23: two full-rate operations in place of a conversion.
__device__ __forceinline__ float byte_to_float(uint32_t word, int byte) {
  return __fsub_rn(__int_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | byte)), 8388608.0f);
}
__device__ __forceinline__ float to_float(uint8_t v) { return byte_to_float(v, 0); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float normalized(T v, float scale, float shift) {
  return __fadd_rn(__fmul_rn(to_float(v), scale), shift);
}

// Calls body(r, i) for every r < rows and i < per_row, the block's
// threads taking consecutive (r, i) in row-major order.
template <typename F>
__device__ __forceinline__ void for_each_in_rows(int rows, int per_row, F body) {
  int r = threadIdx.x / per_row;
  int i = threadIdx.x - r * per_row;
  while (r < rows) {
    body(r, i);
    i += blockDim.x;
    if (i >= per_row) {
      const int d = i / per_row;
      r += d;
      i -= d * per_row;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The same for 4 bytes (both addresses 4-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `rows` source rows of `elems` elements of T staged in shared memory. Row
// r, at first_row + r·pitch in device memory, is at base + r·stride; its
// element e at byte lead(r) + e·sizeof(T), where lead(r) is the device
// row's address modulo 16.
template <typename T>
struct Staged {
  uint8_t* base;
  int stride;
  int lead0;      // lead(0)
  int pitch_mod;  // the pitch in bytes, modulo 16

  __device__ Staged(uint8_t* base_, int elems, const T* first_row, size_t pitch)
      : base(base_),
        stride(static_cast<int>(row_stride(elems, sizeof(T)))),
        lead0(static_cast<int>(reinterpret_cast<uintptr_t>(first_row) & 15)),
        pitch_mod(static_cast<int>((pitch * sizeof(T)) & 15)) {}

  __device__ __forceinline__ int lead(int r) const { return (lead0 + r * pitch_mod) & 15; }

  __device__ __forceinline__ const T* row(int r) const {
    return reinterpret_cast<const T*>(base + r * stride + lead(r));
  }

  // Copies rows [0, rows) from first_row: each row's whole 16-byte vectors
  // by cp.async, all of the block's in flight at once, and the partial
  // vectors at either end by element copies, so nothing outside the rows
  // is read. The caller waits (cp_async_wait_all) and synchronizes the
  // block before reading.
  __device__ __forceinline__ void load(const T* first_row, size_t pitch, int rows,
                                       int elems) const {
    const int bytes = elems * static_cast<int>(sizeof(T));
    const int vecs = stride / 16;
    for_each_in_rows(rows, vecs, [&](int r, int v) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(first_row + r * pitch);
      const int lo = 16 * v - lead(r);  // vector v holds row bytes [lo, lo + 16)
      if (lo >= bytes) return;
      uint8_t* dst = base + r * stride + 16 * v;
      if (lo >= 0 && lo + 16 <= bytes) {
        cp_async16(dst, src + lo);
      } else {
        const int end = min(lo + 16, bytes);
        for (int k = max(lo, 0); k < end; k += static_cast<int>(sizeof(T))) {
          *reinterpret_cast<T*>(dst + (k - lo)) = *reinterpret_cast<const T*>(src + k);
        }
      }
    });
  }
};

// Writes `rows` output rows of P pixels × C channels, contiguous from dst:
// output pixel x' of row r, channel c, gets value(r, x, c) with x = flip ?
// P-1-x' : x'. 16-byte stores where a row is a whole number of float4 and
// dst is 16-byte aligned, else element stores.
template <int kC, typename F>
__device__ __forceinline__ void write_rows(float* dst, int rows, int patch, int channels,
                                           bool flip, F value) {
  const int C = kC > 0 ? kC : channels;
  const int row_len = patch * C;
  if (row_len % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for_each_in_rows(rows, row_len / 4, [&](int r, int q) {
      int x = 4 * q / C;
      int c = 4 * q - x * C;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = value(r, flip ? patch - 1 - x : x, c);
        if (++c == C) {
          c = 0;
          ++x;
        }
      }
      __stcs(reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * row_len + 4 * q),
             make_float4(v[0], v[1], v[2], v[3]));
    });
  } else {
    for_each_in_rows(rows, row_len, [&](int r, int e) {
      const int x = e / C;
      const int c = e - x * C;
      __stcs(dst + static_cast<size_t>(r) * row_len + e, value(r, flip ? patch - 1 - x : x, c));
    });
  }
}

// The kernels' arguments; the fixed sampler leaves the rescale's null.
struct Params {
  const void* src;
  const int32_t* indices;
  const int32_t* offsets;
  const int32_t* flips;
  const int32_t* scale_idx;
  const int32_t* window_sizes;
  const int32_t* tap_first;
  const float* tap_weights;
  const float* mass;
  float* out;
  int batch, height, width, channels, patch;
  int num_scales, taps, max_window;
  int rows, staged_rows;
  float scale, shift;
  int preserve_mass;
};

// Shared memory (ops/patches.py _sampler_layout mirrors it). The rescale
// first holds its scale's tap table, first [P] int32 and weights [K, P]
// float32 (coordinate x at slot(x), see the kernel), then up to kVrowRows
// of its tile's rows contracted along y, [.., max_window·C] float32. Both
// then hold the staged source rows: `staged_rows` rows of the widest
// window (the fixed sampler's: its `rows` rows of P).
__host__ __device__ long long tables_bytes(int patch, int taps) {
  return align16(4LL * patch) + align16(4LL * patch * taps);
}

long long smem_need(const Params& p, int itemsize, bool rescale) {
  if (!rescale) return p.rows * row_stride(static_cast<long long>(p.patch) * p.channels, itemsize);
  return tables_bytes(p.patch, p.taps) +
         align16(4LL * (p.rows < kVrowRows ? p.rows : kVrowRows) * p.max_window * p.channels) +
         p.staged_rows * row_stride(static_cast<long long>(p.max_window) * p.channels, itemsize);
}

// The rescale's sums over the taps k < nk of one output coordinate, in tap
// order, acc[q] = fma(w[k·P], value(k, q), acc[q]) for k = 0, 1, ...; nk =
// min(K, ws - first) ends them where the window does. The loop is unrolled
// up to kMaxTaps taps.
template <int kN, typename Tap>
__device__ __forceinline__ void over_taps(float (&acc)[kN], int nk, int K, const float* w, int P,
                                          Tap value) {
  if (K <= kMaxTaps) {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      if (k < nk) {
        const float wk = w[k * P];
#pragma unroll
        for (int q = 0; q < kN; ++q) acc[q] = __fmaf_rn(wk, value(k, q), acc[q]);
      }
    }
  } else {
    for (int k = 0; k < nk; ++k) {
      const float wk = w[k * P];
#pragma unroll
      for (int q = 0; q < kN; ++q) acc[q] = __fmaf_rn(wk, value(k, q), acc[q]);
    }
  }
}

// Along y: kN consecutive elements e.. of the staged rows r0 + k, each
// normalized just before its multiply-add.
template <typename T, int kN>
__device__ __forceinline__ void tap_sums(float (&acc)[kN], const Staged<T>& staged, int r0, int e,
                                         int nk, int K, const float* w, int P, float scale,
                                         float shift) {
  over_taps<kN>(acc, nk, K, w, P, [&](int k, int q) {
    return normalized(staged.row(r0 + k)[e + q], scale, shift);
  });
}

// Along x: kN channels of the pixels (first + k) of a y-contracted row, v
// at the first tap's channel c0 (pixels `C` floats apart).
template <int kN>
__device__ __forceinline__ void pixel_sums(float (&acc)[kN], const float* v, int C, int nk, int K,
                                           const float* w, int P) {
  over_taps<kN>(acc, nk, K, w, P, [&](int k, int q) { return v[k * C + q]; });
}

// Grid (tiles, B): block (t, b) writes output rows [t·rows, t·rows + rows)
// of example b.
template <typename T, int kC, bool kRescale>
__global__ void sampler_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int C = kC > 0 ? kC : p.channels;
  const int P = p.patch;
  const int K = p.taps;
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * p.rows;
  const int rows = min(p.rows, P - y0);
  const int n = p.indices[b];
  const int oy = p.offsets[2 * b];
  const int ox = p.offsets[2 * b + 1];
  const bool flip = p.flips[b] != 0;
  const int s = kRescale ? p.scale_idx[b] : 0;
  const int ws = kRescale ? p.window_sizes[s] : P;
  const float factor = kRescale && p.preserve_mass ? p.mass[s] : 1.0f;
  const size_t pitch = static_cast<size_t>(p.width) * C;
  const T* window = static_cast<const T*>(p.src) +
                    ((static_cast<size_t>(n) * p.height + oy) * p.width + ox) * C;
  float* dst = p.out + (static_cast<size_t>(b) * P + y0) * P * C;

  int* s_first = reinterpret_cast<int*>(smem);
  float* s_weights = reinterpret_cast<float*>(smem + align16(4LL * P));
  float* vrows = reinterpret_cast<float*>(smem + tables_bytes(P, K));
  uint8_t* stage = kRescale ? reinterpret_cast<uint8_t*>(vrows) +
                                  align16(4LL * min(p.rows, kVrowRows) * p.max_window * C)
                            : smem;
  const long long capacity =
      p.staged_rows * row_stride(static_cast<long long>(kRescale ? p.max_window : P) * C,
                                 sizeof(T));

  if (!kRescale || ws == P) {  // a copy of the window's rows
    const T* top = window + y0 * pitch;
    const Staged<T> staged(stage, P * C, top, pitch);
    if (static_cast<long long>(rows) * staged.stride > capacity) __trap();
    staged.load(top, pitch, rows, P * C);
    cp_async_wait_all();
    __syncthreads();
    write_rows<kC>(dst, rows, P, C, flip, [&](int r, int x, int c) {
      const float v = normalized(staged.row(r)[x * C + c], p.scale, p.shift);
      return kRescale ? __fmul_rn(v, factor) : v;
    });
    return;
  }

  // The scale's tap table, in flight first, entry x at slot(x): where P is
  // a multiple of 4, by x mod 4, then x / 4, so that the threads of the
  // x-pass, which take pixels 4g + q, read consecutive words; weight k of
  // x at k·P + slot(x).
  const int* first = p.tap_first + static_cast<size_t>(s) * P;
  const float* weights = p.tap_weights + static_cast<size_t>(s) * P * K;
  const bool quads = P % 4 == 0;
  auto slot = [&](int x) { return quads ? (x & 3) * (P >> 2) + (x >> 2) : x; };
  for (int i = threadIdx.x; i < P; i += blockDim.x) cp_async4(s_first + slot(i), first + i);
  for (int i = threadIdx.x; i < P * K; i += blockDim.x) {
    const int x = i / K;
    cp_async4(s_weights + (i - x * K) * P + slot(x), weights + i);
  }
  // The tile's source rows: from its rows' least first tap to their
  // greatest last tap, inside the window.
  int j0 = ws;
  int j1 = 0;
  for (int t = 0; t < rows; ++t) {
    const int f = first[y0 + t];
    j0 = min(j0, f);
    j1 = max(j1, f);
  }
  j1 = min(j1 + K - 1, ws - 1);
  const int count = j1 - j0 + 1;
  const int win_len = ws * C;
  const T* top = window + j0 * pitch;
  const Staged<T> staged(stage, win_len, top, pitch);
  if (static_cast<long long>(count) * staged.stride > capacity) __trap();
  staged.load(top, pitch, count, win_len);
  cp_async_wait_all();
  __syncthreads();

  // The tile's rows go through the two passes kVrowRows at a time.
  const bool grouped =
      kC > 0 && quads && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  for (int c0 = 0; c0 < rows; c0 += kVrowRows) {
    const int nr = min(kVrowRows, rows - c0);
    if (c0 > 0) __syncthreads();  // the last chunk's x-pass is done with vrows

    // 1. along y: vrows[t, i·C + c] = sum_k Wy[y, k] * win[first + k, i, c] for
    // output row y = y0 + c0 + t, four consecutive elements a thread where
    // the row has whole groups of four (the weights and the row address
    // then serve four sums).
    if (win_len % 4 == 0) {
      for_each_in_rows(nr, win_len / 4, [&](int t, int g) {
        const int sy = slot(y0 + c0 + t);
        const int fy = s_first[sy];
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        tap_sums<T, 4>(acc, staged, fy - j0, 4 * g, min(K, ws - fy), K, s_weights + sy, P,
                       p.scale, p.shift);
        *reinterpret_cast<float4*>(vrows + t * win_len + 4 * g) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      });
    } else {
      for_each_in_rows(nr, win_len, [&](int t, int e) {
        const int sy = slot(y0 + c0 + t);
        const int fy = s_first[sy];
        float acc[1] = {0.0f};
        tap_sums<T, 1>(acc, staged, fy - j0, e, min(K, ws - fy), K, s_weights + sy, P, p.scale,
                       p.shift);
        vrows[t * win_len + e] = acc[0];
      });
    }
    __syncthreads();

    // 2. along x, the mass factor, the flip folded into the stores: per
    // output pixel x', the taps of x = flip ? P-1-x' : x' across its C
    // channels.
    float* out = dst + static_cast<size_t>(c0) * P * C;
    if (grouped) {
      constexpr int kCh = kC > 0 ? kC : 1;
      // Four output pixels a thread: 4·C floats, C float4 stores.
      for_each_in_rows(nr, P / 4, [&](int t, int g) {
        float v[4 * kCh];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int xo = 4 * g + q;
          const int sx = slot(flip ? P - 1 - xo : xo);
          const int fx = s_first[sx];
          float acc[kCh];
#pragma unroll
          for (int c = 0; c < kCh; ++c) acc[c] = 0.0f;
          pixel_sums<kCh>(acc, vrows + t * win_len + fx * kCh, kCh, min(K, ws - fx), K,
                          s_weights + sx, P);
#pragma unroll
          for (int c = 0; c < kCh; ++c) v[q * kCh + c] = __fmul_rn(acc[c], factor);
        }
        float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(t) * P * kCh + 4 * g * kCh);
#pragma unroll
        for (int q = 0; q < kCh; ++q) {
          __stcs(o + q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
        }
      });
    } else {
      write_rows<kC>(out, nr, P, C, flip, [&](int t, int x, int c) {
        const int sx = slot(x);
        const int fx = s_first[sx];
        float acc[1] = {0.0f};
        pixel_sums<1>(acc, vrows + t * win_len + fx * C + c, C, min(K, ws - fx), K,
                      s_weights + sx, P);
        return __fmul_rn(acc[0], factor);
      });
    }
  }
}

// ---------------------------------------------------------------------------
// Host side. The launch plan (rows a tile, threads, staged rows, shared
// memory) comes from ops/patches.py sampler_plan and is checked here.
// ---------------------------------------------------------------------------

int plan_error(const Params& p, int threads, int smem, int itemsize, bool rescale) {
  const bool bad = p.batch > 65535 || p.channels <= 0 || p.rows < 1 || p.rows > p.patch ||
                   threads < 32 || threads > 1024 || threads % 32 != 0 || smem > kMaxSmem ||
                   smem < smem_need(p, itemsize, rescale) ||
                   (rescale ? p.num_scales <= 0 || p.taps <= 0 || p.max_window <= 0 ||
                                  p.staged_rows < 1 || p.staged_rows > p.max_window
                            : p.staged_rows != p.rows);
  return bad ? kInvalid : 0;
}

// Raises the kernel's dynamic shared-memory limit to `smem` where it is
// lower (once per device), then launches it on a grid of (tiles, batch).
template <auto Kernel>
int launch(const Params& p, int threads, int smem, cudaStream_t stream) {
  constexpr int kDevices = 64;
  static int smem_set[kDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && smem > 48 * 1024 && (device >= kDevices || smem > smem_set[device])) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && device < kDevices) smem_set[device] = smem;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.patch + p.rows - 1) / p.rows, p.batch);
  Kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn with a value of type T (the source dtype) and an
// std::integral_constant of C (1, 3, or 0 for any other channel count).
template <typename F>
int dispatch(int dtype, int channels, F fn) {
  auto with_c = [&](auto t) {
    switch (channels) {
      case 1:
        return fn(t, std::integral_constant<int, 1>{});
      case 3:
        return fn(t, std::integral_constant<int, 3>{});
      default:
        return fn(t, std::integral_constant<int, 0>{});
    }
  };
  switch (dtype) {
    case 0:
      return with_c(uint8_t{});
    case 1:
      return with_c(float{});
    case 2:
      return with_c(__nv_bfloat16{});
    default:
      return kInvalid;
  }
}

int itemsize(int dtype) { return dtype == 0 ? 1 : dtype == 1 ? 4 : 2; }

template <bool kRescale>
int run(int dtype, const Params& p, int threads, int smem, void* stream) {
  if (p.batch <= 0 || p.patch <= 0) return 0;
  if (dtype < 0 || dtype > 2 || plan_error(p, threads, smem, itemsize(dtype), kRescale)) {
    return kInvalid;
  }
  return dispatch(dtype, p.channels, [&](auto t, auto c) {
    return launch<sampler_kernel<decltype(t), decltype(c)::value, kRescale>>(
        p, threads, smem, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

// dtype: 0 = uint8, 1 = float32, 2 = bfloat16. The plan: a block of
// `threads` threads for each tile of `rows` output rows, staging
// `staged_rows` (= rows) source rows in `smem` bytes of shared memory (at
// least the layout's need, at most 227 KB). Returns cudaErrorInvalidValue for what the kernel
// does not take, else the launch's cudaError_t (0 on success). Enqueues on
// `stream`; does not synchronize.
int srgan_extract_patches(const void* src, const int32_t* indices, const int32_t* offsets,
                          const int32_t* flips, float* out, int dtype, int batch, int height,
                          int width, int channels, int patch, int rows, int threads,
                          int staged_rows, int smem, float scale, float shift, void* stream) {
  const Params p{src,    indices, offsets, flips,    nullptr,     nullptr, nullptr, nullptr,
                 nullptr, out,     batch,   height,   width,       channels, patch,  0,
                 0,       0,       rows,    staged_rows, scale,    shift,   0};
  return run<false>(dtype, p, threads, smem, stream);
}

// dtype as above; window_sizes [S], tap_first [S, P], tap_weights
// [S, P, taps] and mass [S] are the wrapper's table on the device. The plan:
// a block of `threads` threads for each tile of `rows` output rows,
// staging at most `staged_rows` source rows of the widest window
// (`max_window`), in `smem` bytes. Returns as above.
int srgan_extract_rescaled_patches(
    const void* src, const int32_t* indices, const int32_t* offsets, const int32_t* flips,
    const int32_t* scale_idx, const int32_t* window_sizes, const int32_t* tap_first,
    const float* tap_weights, const float* mass, float* out, int dtype, int batch, int height,
    int width, int channels, int patch, int num_scales, int taps, int max_window, int rows,
    int threads, int staged_rows, int smem, float scale, float shift, int preserve_mass,
    void* stream) {
  const Params p{src,        indices,     offsets, flips,      scale_idx,  window_sizes,
                 tap_first,  tap_weights, mass,    out,        batch,      height,
                 width,      channels,    patch,   num_scales, taps,       max_window,
                 rows,       staged_rows, scale,   shift,      preserve_mass};
  return run<true>(dtype, p, threads, smem, stream);
}

const char* srgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
