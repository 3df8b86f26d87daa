// Fused GroupNorm + LeakyReLU: forward and backward.
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
// flagship's first discriminator stage (B = 360, 112²×64, bf16) x is 578 MB.
//
// Design. The TPU kernel holds one example's whole [HW, C] slice in VMEM
// (1.6 MB there), reads it from HBM once, and carries dscale/dbias across
// its sequential batch grid. A Hopper block has at most 227 KB of shared
// memory and its blocks run in parallel in no order, so neither carries
// over. Here an example is cut into slabs of rows; a grid of
// (slab, example) blocks reduces each slab to per-channel partial sums,
// a small kernel folds the partials of an example, and a second pass over
// the slabs writes the output. Cross-block sums go through partials in
// device memory, folded in a fixed order, never atomics: a run repeats.
//
//   forward:  stats (read x) → fold into mean/rstd → normalize (read x,
//             write y). About 1.7 GB of traffic at the shape above.
//   backward: per-channel Σdy0 and Σdy0·x̂ (read x, dy) → fold into the
//             group means of dx̂ and dx̂·x̂ (Σdx̂ = scale·Σdy0 within a
//             channel, so two accumulators serve all four sums of the
//             TPU kernel) → dx (read x, dy, write dx) → dscale/dbias over
//             the batch. About 2.9 GB at the shape above.
//
// So x is read twice in each direction. A later version should keep a
// slab in shared memory or L2 between the two passes (a cluster per
// example, or a persistent block per slab with a grid-wide sync), which
// takes the forward to one read and one write.
//
// Inside a block, threads are laid out as `ct` channel lanes by `rt` row
// lanes (ct = min(C, 256)): consecutive threads read consecutive channels
// of a row, so every load and store of a warp is one contiguous span.
//
// Products and sums that mirror the plain PyTorch version are rounded
// one by one (__fmul_rn, __fadd_rn, __fsub_rn) so that nvcc does not
// contract them into FMAs: the kernel then differs from the plain version
// only through the order of its sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// A block's threads as ct channel lanes × rt row lanes over one slab.
struct Lanes {
  int ct, rt, cc, r, row0, row1;
  __device__ Lanes(int hw, int channels, int rows_per_slab) {
    ct = channels < kThreads ? channels : kThreads;
    rt = kThreads / ct;
    cc = threadIdx.x % ct;
    r = threadIdx.x / ct;  // == rt for the idle tail when ct ∤ kThreads
    row0 = blockIdx.x * rows_per_slab;
    row1 = min(row0 + rows_per_slab, hw);
  }
};

// Sums a and b over the block's row lanes for channel lane cc; the total
// lands in lane r == 0. Every thread of the block must call it.
__device__ __forceinline__ void reduce_rows(const Lanes& l, float& a, float& b,
                                            float (*red)[kThreads]) {
  red[0][threadIdx.x] = a;
  red[1][threadIdx.x] = b;
  __syncthreads();
  if (l.r == 0) {
    for (int k = 1; k < l.rt; ++k) {
      a += red[0][k * l.ct + l.cc];
      b += red[1][k * l.ct + l.cc];
    }
  }
  __syncthreads();
}

// (x − mean)·rstd, rounded as the plain version rounds it.
__device__ __forceinline__ float normalized(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

// x̂·scale + bias.
__device__ __forceinline__ float pre_activation(float xhat, float scale, float bias) {
  return __fadd_rn(__fmul_rn(xhat, scale), bias);
}

// partials[b, s, 0, c] = Σ x, partials[b, s, 1, c] = Σ x² over slab s.
template <typename T>
__global__ void fwd_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                                 int hw, int channels, int rows_per_slab) {
  __shared__ float red[2][kThreads];
  const Lanes l(hw, channels, rows_per_slab);
  const int b = blockIdx.y;
  const T* xb = x + static_cast<size_t>(b) * hw * channels;
  float* out = partials + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 2 * channels;
  for (int c0 = 0; c0 < channels; c0 += l.ct) {
    const int c = c0 + l.cc;
    const bool active = l.r < l.rt && c < channels;
    float sum = 0.f, sq = 0.f;
    if (active) {
      for (int row = l.row0 + l.r; row < l.row1; row += l.rt) {
        const float v = to_float(xb[static_cast<size_t>(row) * channels + c]);
        sum += v;
        sq += v * v;
      }
    }
    reduce_rows(l, sum, sq, red);
    if (active && l.r == 0) {
      out[c] = sum;
      out[channels + c] = sq;
    }
  }
}

// One block per example: fold the slab partials, then each group's
// channels, into mean and rstd. Dynamic shared memory: 2·C floats.
__global__ void fwd_fold_kernel(const float* __restrict__ partials, float* __restrict__ mean,
                                float* __restrict__ rstd, int slabs, int hw, int channels,
                                int groups, float eps) {
  extern __shared__ float sums[];  // [2, C]
  const int b = blockIdx.x;
  const float* p = partials + static_cast<size_t>(b) * slabs * 2 * channels;
  for (int j = threadIdx.x; j < 2 * channels; j += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < slabs; ++s) acc += p[static_cast<size_t>(s) * 2 * channels + j];
    sums[j] = acc;
  }
  __syncthreads();
  const int cg = channels / groups;
  const float n = static_cast<float>(hw) * static_cast<float>(cg);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      s1 += sums[g * cg + k];
      s2 += sums[channels + g * cg + k];
    }
    const float m = __fdiv_rn(s1, n);
    const float q = __fdiv_rn(s2, n);
    mean[b * groups + g] = m;
    rstd[b * groups + g] = rsqrtf(__fadd_rn(__fsub_rn(q, __fmul_rn(m, m)), eps));
  }
}

template <typename T>
__global__ void fwd_normalize_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ rstd, T* __restrict__ y, int hw,
                                     int channels, int groups, int rows_per_slab, float slope) {
  const Lanes l(hw, channels, rows_per_slab);
  const int b = blockIdx.y;
  const int cg = channels / groups;
  const size_t base = static_cast<size_t>(b) * hw * channels;
  if (l.r >= l.rt) return;
  for (int c = l.cc; c < channels; c += l.ct) {
    const int g = b * groups + c / cg;
    const float m = mean[g], rs = rstd[g], ga = scale[c], be = bias[c];
    for (int row = l.row0 + l.r; row < l.row1; row += l.rt) {
      const size_t i = base + static_cast<size_t>(row) * channels + c;
      const float y0 = pre_activation(normalized(to_float(x[i]), m, rs), ga, be);
      y[i] = from_float<T>(y0 > 0.f ? y0 : __fmul_rn(slope, y0));
    }
  }
}

// dy·act′ at one element, with x̂ returned through xhat.
template <typename T>
__device__ __forceinline__ float masked_grad(T xv, T dyv, float m, float rs, float ga, float be,
                                             float slope, float& xhat) {
  xhat = normalized(to_float(xv), m, rs);
  const float g = to_float(dyv);
  return pre_activation(xhat, ga, be) > 0.f ? g : __fmul_rn(g, slope);
}

// partials[b, s, 0, c] = Σ dy0, partials[b, s, 1, c] = Σ dy0·x̂ over slab s.
template <typename T>
__global__ void bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                 const float* __restrict__ scale, const float* __restrict__ bias,
                                 const float* __restrict__ mean, const float* __restrict__ rstd,
                                 float* __restrict__ partials, int hw, int channels, int groups,
                                 int rows_per_slab, float slope) {
  __shared__ float red[2][kThreads];
  const Lanes l(hw, channels, rows_per_slab);
  const int b = blockIdx.y;
  const int cg = channels / groups;
  const size_t base = static_cast<size_t>(b) * hw * channels;
  float* out = partials + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 2 * channels;
  for (int c0 = 0; c0 < channels; c0 += l.ct) {
    const int c = c0 + l.cc;
    const bool active = l.r < l.rt && c < channels;
    float s_dy0 = 0.f, s_dy0_xhat = 0.f;
    if (active) {
      const int g = b * groups + c / cg;
      const float m = mean[g], rs = rstd[g], ga = scale[c], be = bias[c];
      for (int row = l.row0 + l.r; row < l.row1; row += l.rt) {
        const size_t i = base + static_cast<size_t>(row) * channels + c;
        float xhat;
        const float dy0 = masked_grad(x[i], dy[i], m, rs, ga, be, slope, xhat);
        s_dy0 += dy0;
        s_dy0_xhat += dy0 * xhat;
      }
    }
    reduce_rows(l, s_dy0, s_dy0_xhat, red);
    if (active && l.r == 0) {
      out[c] = s_dy0;
      out[channels + c] = s_dy0_xhat;
    }
  }
}

// One block per example: fold the slab partials into per-channel sums
// sums[b] = (Σdy0, Σdy0·x̂) [2, C], and each group's channels into
// means[b] = (mean_g(dx̂), mean_g(dx̂·x̂)) [2, G].
__global__ void bwd_fold_kernel(const float* __restrict__ partials,
                                const float* __restrict__ scale, float* __restrict__ sums,
                                float* __restrict__ means, int slabs, int hw, int channels,
                                int groups) {
  extern __shared__ float folded[];  // [2, C]
  const int b = blockIdx.x;
  const float* p = partials + static_cast<size_t>(b) * slabs * 2 * channels;
  for (int j = threadIdx.x; j < 2 * channels; j += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < slabs; ++s) acc += p[static_cast<size_t>(s) * 2 * channels + j];
    folded[j] = acc;
    sums[static_cast<size_t>(b) * 2 * channels + j] = acc;
  }
  __syncthreads();
  const int cg = channels / groups;
  const float n = static_cast<float>(hw) * static_cast<float>(cg);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      const int c = g * cg + k;
      s1 += scale[c] * folded[c];
      s2 += scale[c] * folded[channels + c];
    }
    means[(static_cast<size_t>(b) * 2) * groups + g] = __fdiv_rn(s1, n);
    means[(static_cast<size_t>(b) * 2 + 1) * groups + g] = __fdiv_rn(s2, n);
  }
}

template <typename T>
__global__ void bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                              const float* __restrict__ scale, const float* __restrict__ bias,
                              const float* __restrict__ mean, const float* __restrict__ rstd,
                              const float* __restrict__ means, T* __restrict__ dx, int hw,
                              int channels, int groups, int rows_per_slab, float slope) {
  const Lanes l(hw, channels, rows_per_slab);
  const int b = blockIdx.y;
  const int cg = channels / groups;
  const size_t base = static_cast<size_t>(b) * hw * channels;
  if (l.r >= l.rt) return;
  for (int c = l.cc; c < channels; c += l.ct) {
    const int gi = c / cg;
    const int g = b * groups + gi;
    const float m = mean[g], rs = rstd[g], ga = scale[c], be = bias[c];
    const float m1 = means[(static_cast<size_t>(b) * 2) * groups + gi];
    const float m2 = means[(static_cast<size_t>(b) * 2 + 1) * groups + gi];
    for (int row = l.row0 + l.r; row < l.row1; row += l.rt) {
      const size_t i = base + static_cast<size_t>(row) * channels + c;
      float xhat;
      const float dxhat = __fmul_rn(masked_grad(x[i], dy[i], m, rs, ga, be, slope, xhat), ga);
      dx[i] = from_float<T>(
          __fmul_rn(rs, __fsub_rn(__fsub_rn(dxhat, m1), __fmul_rn(xhat, m2))));
    }
  }
}

// dbias[c] = Σ_b sums[b, 0, c], dscale[c] = Σ_b sums[b, 1, c], in batch order.
__global__ void bwd_params_kernel(const float* __restrict__ sums, float* __restrict__ dscale,
                                  float* __restrict__ dbias, int batch, int channels) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * channels) return;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) acc += sums[static_cast<size_t>(b) * 2 * channels + j];
  if (j < channels) {
    dbias[j] = acc;
  } else {
    dscale[j - channels] = acc;
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

int shape_error(int batch, int hw, int channels, int groups, int rows_per_slab, int slabs) {
  if (batch <= 0 || hw <= 0 || channels <= 0 || groups <= 0 || channels % groups != 0 ||
      rows_per_slab <= 0 || slabs <= 0 || batch > 65535 ||
      static_cast<long long>(rows_per_slab) * (slabs - 1) >= hw ||
      static_cast<long long>(rows_per_slab) * slabs < hw ||
      2 * channels * static_cast<int>(sizeof(float)) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int launch_fwd(const void* x, const float* scale, const float* bias, void* y, float* mean,
               float* rstd, float* partials, int batch, int hw, int channels, int groups,
               int rows_per_slab, int slabs, float slope, float eps, cudaStream_t stream) {
  const dim3 grid(slabs, batch);
  const size_t fold_smem = 2 * channels * sizeof(float);
  fwd_stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), partials, hw,
                                                      channels, rows_per_slab);
  if (int e = last_error()) return e;
  fwd_fold_kernel<<<batch, kThreads, fold_smem, stream>>>(partials, mean, rstd, slabs, hw,
                                                          channels, groups, eps);
  if (int e = last_error()) return e;
  fwd_normalize_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), scale, bias,
                                                          mean, rstd, static_cast<T*>(y), hw,
                                                          channels, groups, rows_per_slab, slope);
  return last_error();
}

template <typename T>
int launch_bwd(const void* x, const float* scale, const float* bias, const float* mean,
               const float* rstd, const void* dy, void* dx, float* dscale, float* dbias,
               float* partials, float* sums, float* means, int batch, int hw, int channels,
               int groups, int rows_per_slab, int slabs, float slope, cudaStream_t stream) {
  const dim3 grid(slabs, batch);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  bwd_stats_kernel<T><<<grid, kThreads, 0, stream>>>(xt, dyt, scale, bias, mean, rstd, partials,
                                                      hw, channels, groups, rows_per_slab,
                                                      slope);
  if (int e = last_error()) return e;
  bwd_fold_kernel<<<batch, kThreads, 2 * channels * sizeof(float), stream>>>(
      partials, scale, sums, means, slabs, hw, channels, groups);
  if (int e = last_error()) return e;
  bwd_dx_kernel<T><<<grid, kThreads, 0, stream>>>(xt, dyt, scale, bias, mean, rstd, means,
                                                   static_cast<T*>(dx), hw, channels, groups,
                                                   rows_per_slab, slope);
  if (int e = last_error()) return e;
  bwd_params_kernel<<<(2 * channels + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      sums, dscale, dbias, batch, channels);
  return last_error();
}

}  // namespace

extern "C" {

// x, y: [batch, hw, channels] in `dtype` (1 = float32, 2 = bfloat16),
// contiguous. scale, bias: [channels] float32. mean, rstd: [batch, groups]
// float32. partials: scratch [batch, slabs, 2, channels] float32. The rows
// of an example are cut into `slabs` slabs of `rows_per_slab` rows (the
// last may be shorter, none empty). Returns the first launch's
// cudaError_t that is not 0, else 0. Enqueues on `stream`; does not
// synchronize.
int srgan_group_norm_act_fwd(const void* x, const float* scale, const float* bias, void* y,
                             float* mean, float* rstd, float* partials, int dtype, int batch,
                             int hw, int channels, int groups, int rows_per_slab, int slabs,
                             float slope, float eps, void* stream) {
  if (int e = shape_error(batch, hw, channels, groups, rows_per_slab, slabs)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_fwd<float>(x, scale, bias, y, mean, rstd, partials, batch, hw, channels,
                               groups, rows_per_slab, slabs, slope, eps, s);
    case 2:
      return launch_fwd<__nv_bfloat16>(x, scale, bias, y, mean, rstd, partials, batch, hw,
                                       channels, groups, rows_per_slab, slabs, slope, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, dy, dx: [batch, hw, channels] in `dtype`, contiguous. scale, bias,
// dscale, dbias: [channels] float32. mean, rstd: [batch, groups] float32
// from the forward. Scratch, float32: partials [batch, slabs, 2, channels],
// sums [batch, 2, channels], means [batch, 2, groups]. Returns as the
// forward does.
int srgan_group_norm_act_bwd(const void* x, const float* scale, const float* bias,
                             const float* mean, const float* rstd, const void* dy, void* dx,
                             float* dscale, float* dbias, float* partials, float* sums,
                             float* means, int dtype, int batch, int hw, int channels, int groups,
                             int rows_per_slab, int slabs, float slope, void* stream) {
  if (int e = shape_error(batch, hw, channels, groups, rows_per_slab, slabs)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_bwd<float>(x, scale, bias, mean, rstd, dy, dx, dscale, dbias, partials, sums,
                               means, batch, hw, channels, groups, rows_per_slab, slabs, slope,
                               s);
    case 2:
      return launch_bwd<__nv_bfloat16>(x, scale, bias, mean, rstd, dy, dx, dscale, dbias,
                                       partials, sums, means, batch, hw, channels, groups,
                                       rows_per_slab, slabs, slope, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* srgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
