// Norm kernels of the generator for Hopper (sm_90a), with a plain C
// interface that munit_tpu_torch/kernels/norms.py binds through ctypes.
//
// They replace the Pallas TPU kernels of munit_tpu/kernels:
//   - norms.py  _in_fwd_kernel   (instance norm, and AdaIN when affine)
//   - tiled.py  _stats_kernel + _norm_kernel (the large-slab form of it)
//   - norms.py  _ln_fwd_kernel   (the fork's whole-tensor LayerNorm)
// On the TPU each grid step held one sample's whole (H, W, C) slab in VMEM,
// one sample after another. Here the slab is cut into row splits so that
// B x S blocks fill the card's 132 SMs even at batch 1:
//   1. norm_partials: each block reads its rows of the NHWC slab once with
//      16-byte loads and keeps per-channel Welford partials (count, mean,
//      M2) in f32. Welford gives the accuracy of the two-pass form of
//      _in_fwd_kernel in one read; the one-pass sum of squares of
//      tiled.py cancels on conv outputs with a large bias. For the
//      LayerNorm the block also folds its channels together and writes one
//      (mean, M2) per split.
//   2. norm_finalize: merges the S partials with Chan's formula, per
//      (sample, channel) for IN and AdaIN, per sample for the LayerNorm,
//      and folds the affine into three per-(sample, channel) coefficients:
//      mean, scale (times gamma) and shift (beta).
//        IN, AdaIN: scale = rsqrt(biased var + eps)
//        LayerNorm: scale = 1 / (sqrt(M2 / (n - 1)) + eps)
//   3. norm_apply: y = (x - mean) * scale + shift, then the optional ReLU;
//      one read and one write, math in f32, output in the input's type.
//
// Bound: device-memory bytes. A norm does a few operations per element, far
// below the H100's ~20 flops per byte at which f32 compute would limit it.
// The least traffic is one read of x and one write of y; this simple design
// reads x twice (partials, then apply), so it moves 1.5x the bound's bytes
// unless the slab still sits in the 50 MB L2 when apply runs. Partials and
// coefficients are a few hundred kB at most.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// VEC consecutive channels of one row, moved as one (up to 16-byte) access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Chan's merge of partial (nb, mb, m2b) into (n, mean, m2).
__device__ __forceinline__ void merge(float& n, float& mean, float& m2,
                                      float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float total = n + nb;
  const float delta = mb - mean;
  const float fb = nb / total;
  mean += delta * fb;
  m2 += m2b + delta * delta * n * fb;
  n = total;
}

// Rows (pixels) of split s: [s * rows, min((s + 1) * rows, hw)).
__device__ __forceinline__ float split_count(int s, int rows, int hw) {
  return static_cast<float>(min(rows, hw - s * rows));
}

// Grid (S, B). Thread t takes channel group t % G (VEC channels) of every
// (256 / G)-th row of its split, so a warp reads whole rows contiguously.
// Writes part[b][s][0][c] = mean and part[b][s][1][c] = M2; with whole,
// part[b][s][0] = mean and part[b][s][1] = M2 over all the split's values.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_partials(const T* __restrict__ x, float* __restrict__ part, int hw,
              int c, int rows, int whole) {
  const int groups = c / VEC;
  const int lanes = kThreads / groups;
  const int g = threadIdx.x % groups;
  const int lane = threadIdx.x / groups;
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = s * rows;
  const int r1 = min(r0 + rows, hw);

  __shared__ float sh_mean[kThreads * VEC];
  __shared__ float sh_m2[kThreads * VEC];
  __shared__ float sh_n[kThreads];

  if (lane < lanes) {
    float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) mean[v] = m2[v] = 0.f;
    const T* base = x + static_cast<size_t>(b) * hw * c + g * VEC;
    for (int r = r0 + lane; r < r1; r += lanes) {
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(base + static_cast<size_t>(r) * c);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xv = to_float(p.v[v]);
        const float d = xv - mean[v];
        mean[v] += d * inv;
        m2[v] += d * (xv - mean[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sh_mean[lane * c + g * VEC + v] = mean[v];
      sh_m2[lane * c + g * VEC + v] = m2[v];
    }
    if (g == 0) sh_n[lane] = n;
  }
  __syncthreads();

  const int t = threadIdx.x;
  float* out = part + (static_cast<size_t>(b) * gridDim.x + s) * 2 *
                          (whole ? 1 : c);
  float tn = 0.f, tmean = 0.f, tm2 = 0.f;  // this thread's channels (whole)
  for (int ch = t; ch < c; ch += kThreads) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int l = 0; l < lanes; ++l)
      merge(n, mean, m2, sh_n[l], sh_mean[l * c + ch], sh_m2[l * c + ch]);
    if (whole) {
      merge(tn, tmean, tm2, n, mean, m2);
    } else {
      out[ch] = mean;
      out[c + ch] = m2;
    }
  }
  if (!whole) return;  // uniform over the block
  __syncthreads();     // every read of the lanes' partials is done
  sh_n[t] = tn;
  sh_mean[t] = tmean;
  sh_m2[t] = tm2;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) merge(sh_n[t], sh_mean[t], sh_m2[t], sh_n[t + off],
                       sh_mean[t + off], sh_m2[t + off]);
    __syncthreads();
  }
  if (t == 0) {
    out[0] = sh_mean[0];
    out[1] = sh_m2[0];
  }
}

// Grid (ceil(C / 32), B), block (32, 8): per (sample, channel) statistics
// for instance norm and AdaIN. gamma and beta are null or f32 rows with
// stride gs / bs between samples and unit stride over channels.
__global__ void __launch_bounds__(kThreads)
norm_finalize_channels(const float* __restrict__ part, float* __restrict__ coef,
                       const float* __restrict__ gamma, long long gs,
                       const float* __restrict__ beta, long long bs, int hw,
                       int c, int splits, int rows, float eps) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * 32 + tx;
  const int b = blockIdx.y;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (ch < c) {
    for (int s = ty; s < splits; s += 8) {
      const float* p = part + (static_cast<size_t>(b) * splits + s) * 2 * c;
      merge(n, mean, m2, split_count(s, rows, hw), p[ch], p[c + ch]);
    }
  }
  __shared__ float sh_n[8][32], sh_mean[8][32], sh_m2[8][32];
  sh_n[ty][tx] = n;
  sh_mean[ty][tx] = mean;
  sh_m2[ty][tx] = m2;
  __syncthreads();
  if (ty != 0 || ch >= c) return;
  for (int l = 1; l < 8; ++l) merge(n, mean, m2, sh_n[l][tx], sh_mean[l][tx], sh_m2[l][tx]);
  const float scale = rsqrtf(m2 / n + eps);
  float* o = coef + static_cast<size_t>(b) * 3 * c;
  o[ch] = mean;
  o[c + ch] = gamma ? scale * gamma[b * gs + ch] : scale;
  o[2 * c + ch] = beta ? beta[b * bs + ch] : 0.f;
}

// Grid (B), block 256: per-sample statistics over all of H, W, C for the
// whole-tensor LayerNorm (unbiased std, eps added to the std), from the
// per-split partials that norm_partials folded over the channels.
__global__ void __launch_bounds__(kThreads)
norm_finalize_sample(const float* __restrict__ part, float* __restrict__ coef,
                     const float* __restrict__ gamma, long long gs,
                     const float* __restrict__ beta, long long bs, int hw,
                     int c, int splits, int rows, float eps) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* pb = part + static_cast<size_t>(b) * splits * 2;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int s = t; s < splits; s += kThreads)
    merge(n, mean, m2, split_count(s, rows, hw) * c, pb[2 * s], pb[2 * s + 1]);
  __shared__ float sh_n[kThreads], sh_mean[kThreads], sh_m2[kThreads];
  sh_n[t] = n;
  sh_mean[t] = mean;
  sh_m2[t] = m2;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) merge(sh_n[t], sh_mean[t], sh_m2[t], sh_n[t + off],
                       sh_mean[t + off], sh_m2[t + off]);
    __syncthreads();
  }
  const float std = sqrtf(sh_m2[0] / (sh_n[0] - 1.f));
  const float scale = 1.f / (std + eps);
  const float mu = sh_mean[0];
  float* o = coef + static_cast<size_t>(b) * 3 * c;
  for (int ch = t; ch < c; ch += kThreads) {
    o[ch] = mu;
    o[c + ch] = gamma ? scale * gamma[b * gs + ch] : scale;
    o[2 * c + ch] = beta ? beta[b * bs + ch] : 0.f;
  }
}

// Grid (S, B), the same split of rows and threads as norm_partials.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_apply(const T* __restrict__ x, T* __restrict__ y,
           const float* __restrict__ coef, int hw, int c, int rows, int relu) {
  const int groups = c / VEC;
  const int lanes = kThreads / groups;
  const int g = threadIdx.x % groups;
  const int lane = threadIdx.x / groups;
  if (lane >= lanes) return;
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = s * rows;
  const int r1 = min(r0 + rows, hw);
  const float* cb = coef + static_cast<size_t>(b) * 3 * c + g * VEC;
  float mu[VEC], a[VEC], d[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    mu[v] = cb[v];
    a[v] = cb[c + v];
    d[v] = cb[2 * c + v];
  }
  const size_t off = static_cast<size_t>(b) * hw * c + g * VEC;
  for (int r = r0 + lane; r < r1; r += lanes) {
    const size_t at = off + static_cast<size_t>(r) * c;
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + at);
    Pack<T, VEC> q;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float t = (to_float(p.v[v]) - mu[v]) * a[v] + d[v];
      if (relu && t < 0.f) t = 0.f;
      q.v[v] = from_float<T>(t);
    }
    *reinterpret_cast<Pack<T, VEC>*>(y + at) = q;
  }
}

struct Args {
  const void* x;
  void* y;
  float* part;
  float* coef;
  const float* gamma;
  long long gs;
  const float* beta;
  long long bs;
  int b, hw, c, splits, rows, whole, relu;
  float eps;
  cudaStream_t stream;
};

template <typename T, int VEC>
cudaError_t run(const Args& a) {
  const dim3 grid(a.splits, a.b);
  norm_partials<T, VEC><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.part, a.hw, a.c, a.rows, a.whole);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.whole) {
    norm_finalize_sample<<<a.b, kThreads, 0, a.stream>>>(
        a.part, a.coef, a.gamma, a.gs, a.beta, a.bs, a.hw, a.c, a.splits,
        a.rows, a.eps);
  } else {
    norm_finalize_channels<<<dim3((a.c + 31) / 32, a.b), dim3(32, 8), 0,
                             a.stream>>>(a.part, a.coef, a.gamma, a.gs, a.beta,
                                         a.bs, a.hw, a.c, a.splits, a.rows,
                                         a.eps);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  norm_apply<T, VEC><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y), a.coef, a.hw, a.c,
      a.rows, a.relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_vec(const Args& a, int vec) {
  switch (vec) {
    case 8:  // 16 bytes of a 2-byte type; f32 stops at 4
      if constexpr (sizeof(T) <= 2) return run<T, 8>(a);
      return cudaErrorInvalidValue;
    case 4: return run<T, 4>(a);
    case 2: return run<T, 2>(a);
    case 1: return run<T, 1>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One normalization of an NHWC tensor x (B, H*W rows, C channels) into y.
// part: f32 scratch (B, splits, 2, C), or (B, splits, 2) when whole;
// coef: f32 scratch (B, 3, C).
// whole = 0: per-(sample, channel) statistics (IN, AdaIN); 1: per sample
// (LayerNorm). gamma/beta may be null. Returns cudaGetLastError().
extern "C" int munit_norm_forward(const void* x, void* y, void* part,
                                  void* coef, const void* gamma, long long gs,
                                  const void* beta, long long bs, int b, int hw,
                                  int c, int splits, int rows, int is_bf16,
                                  int vec, int whole, int relu, float eps,
                                  void* stream) {
  const Args a{x, y, static_cast<float*>(part), static_cast<float*>(coef),
               static_cast<const float*>(gamma), gs,
               static_cast<const float*>(beta), bs, b, hw, c, splits, rows,
               whole, relu, eps, static_cast<cudaStream_t>(stream)};
  const cudaError_t e = is_bf16 ? run_vec<__nv_bfloat16>(a, vec)
                                : run_vec<float>(a, vec);
  return static_cast<int>(e);
}

extern "C" const char* munit_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
