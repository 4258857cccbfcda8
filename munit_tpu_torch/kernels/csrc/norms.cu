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
// coefficients are a few hundred kB at most. The finalize kernels also hand
// back each (sample, channel)'s mean, 1/scale factor r and the LayerNorm's
// std (stats, B x 3 x C) for the backward below.
//
// Backward (the gradients of all three norms), replacing
//   - tools/normprobe3.py _dot_kernel (:102): the per-sample sums of g and
//     g * (y - mean) of the LayerNorm's closed-form backward, on the TPU;
//   - the JAX package's jnp backward rules munit_tpu/kernels/norms.py
//     _adain_bwd (:152), _in_bwd (:188) and _ln_bwd (:253, the vjp of
//     ops.whole_layer_norm).
// One reduction serves all three. With xh = (x - mean) * r (r = rsqrt(var +
// eps) for IN and AdaIN, 1 / (std + eps) for the LayerNorm) and dy' = dy
// masked by the fused ReLU (xh * gamma + beta > 0, recomputed; gamma = 1,
// beta = 0 for IN), take per (sample, channel) A = sum dy', B = sum dy' * xh.
//   IN, AdaIN: dbeta = A, dgamma = B,
//              dx = r * gamma * (dy' - A / HW - xh * B / HW);
//   LayerNorm: dbeta[c] = sum_b A, dgamma[c] = sum_b B; per sample
//              S1 = sum_c gamma_c A, S2 = sum_c gamma_c B,
//              dx = gamma_c dy' / d - S1 / (n d) - xh S2 / ((n - 1) std),
//              d = std + eps, n = H W C (normprobe3.py:147-148 with
//              y - mean = xh * d).
// Both are dx = k1 * dy' + k2 + k3 * xh with per-(sample, channel) k1..k3:
//   1. norm_bwd_partials: split-HW partial sums of A and B per channel, the
//      forward's split of rows and threads, so batch 1 fills the SMs;
//   2. norm_bwd_merge: sums the splits in a fixed order (no atomics: reruns
//      match bit for bit) and, for IN and AdaIN, writes k1..k3;
//   3. norm_bwd_finalize_sample (LayerNorm only, one block): S1, S2 per
//      sample, k1..k3, and dgamma, dbeta summed over the batch in order;
//   4. norm_bwd_apply: dx from x, dy and k1..k3, in x's type.
// Bound: device-memory bytes. The least traffic is one read of x and dy
// and one write of dx (3 N itemsize); this design reads x and dy twice
// (partials, then apply), 5 N itemsize unless L2 still holds them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

using munit::from_float;
using munit::Pack;
using munit::to_float;

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
                       float* __restrict__ stats,
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
  float* st = stats + static_cast<size_t>(b) * 3 * c;
  st[ch] = mean;
  st[c + ch] = scale;
  st[2 * c + ch] = sqrtf(m2 / n);
}

// Grid (B), block 256: per-sample statistics over all of H, W, C for the
// whole-tensor LayerNorm (unbiased std, eps added to the std), from the
// per-split partials that norm_partials folded over the channels.
__global__ void __launch_bounds__(kThreads)
norm_finalize_sample(const float* __restrict__ part, float* __restrict__ coef,
                     float* __restrict__ stats,
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
  float* st = stats + static_cast<size_t>(b) * 3 * c;
  for (int ch = t; ch < c; ch += kThreads) {
    o[ch] = mu;
    o[c + ch] = gamma ? scale * gamma[b * gs + ch] : scale;
    o[2 * c + ch] = beta ? beta[b * bs + ch] : 0.f;
    st[ch] = mu;
    st[c + ch] = scale;
    st[2 * c + ch] = std;
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

// ------------------------------------------------------------- backward

// Per-(sample, channel) values of VEC consecutive channels: the forward's
// mean and r, and the ReLU mask's gamma and beta (1 and 0 when null).
template <int VEC>
struct ChannelParams {
  float mu[VEC], r[VEC], ga[VEC], be[VEC];

  __device__ __forceinline__ ChannelParams(const float* stats,
                                           const float* gamma, long long gs,
                                           const float* beta, long long bs,
                                           int b, int c, int ch0) {
    const float* st = stats + static_cast<size_t>(b) * 3 * c + ch0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      mu[v] = st[v];
      r[v] = st[c + v];
      ga[v] = gamma ? gamma[b * gs + ch0 + v] : 1.f;
      be[v] = beta ? beta[b * bs + ch0 + v] : 0.f;
    }
  }
};

// Grid (S, B), the forward's split of rows and threads. Writes
// part[b][s][0][c] = sum dy' and part[b][s][1][c] = sum dy' * xh over the
// split's rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_bwd_partials(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ stats,
                  const float* __restrict__ gamma, long long gs,
                  const float* __restrict__ beta, long long bs,
                  float* __restrict__ part, int hw, int c, int rows,
                  int relu) {
  const int groups = c / VEC;
  const int lanes = kThreads / groups;
  const int g = threadIdx.x % groups;
  const int lane = threadIdx.x / groups;
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = s * rows;
  const int r1 = min(r0 + rows, hw);

  __shared__ float sh_a[kThreads * VEC];
  __shared__ float sh_b[kThreads * VEC];

  if (lane < lanes) {
    const ChannelParams<VEC> cp(stats, gamma, gs, beta, bs, b, c, g * VEC);
    float sa[VEC], sb[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) sa[v] = sb[v] = 0.f;
    const size_t off = static_cast<size_t>(b) * hw * c + g * VEC;
    for (int r = r0 + lane; r < r1; r += lanes) {
      const size_t at = off + static_cast<size_t>(r) * c;
      const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(x + at);
      const Pack<T, VEC> pd = *reinterpret_cast<const Pack<T, VEC>*>(dy + at);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xh = (to_float(px.v[v]) - cp.mu[v]) * cp.r[v];
        float d = to_float(pd.v[v]);
        if (relu && !(xh * cp.ga[v] + cp.be[v] > 0.f)) d = 0.f;
        sa[v] += d;
        sb[v] += d * xh;
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sh_a[lane * c + g * VEC + v] = sa[v];
      sh_b[lane * c + g * VEC + v] = sb[v];
    }
  }
  __syncthreads();

  float* out = part + (static_cast<size_t>(b) * gridDim.x + s) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float a = 0.f, bb = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a += sh_a[l * c + ch];
      bb += sh_b[l * c + ch];
    }
    out[ch] = a;
    out[c + ch] = bb;
  }
}

// Grid (ceil(C / 32), B), block (32, 8): red[b][0][c] = A and red[b][1][c] =
// B, the splits summed in a fixed order. For IN and AdaIN (whole = 0) also
// the apply coefficients k1..k3 into bcoef (B x 3 x C).
__global__ void __launch_bounds__(kThreads)
norm_bwd_merge(const float* __restrict__ part, const float* __restrict__ stats,
               const float* __restrict__ gamma, long long gs,
               float* __restrict__ red, float* __restrict__ bcoef, int hw,
               int c, int splits, int whole) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * 32 + tx;
  const int b = blockIdx.y;
  float a = 0.f, bb = 0.f;
  if (ch < c) {
    for (int s = ty; s < splits; s += 8) {
      const float* p = part + (static_cast<size_t>(b) * splits + s) * 2 * c;
      a += p[ch];
      bb += p[c + ch];
    }
  }
  __shared__ float sh_a[8][32], sh_b[8][32];
  sh_a[ty][tx] = a;
  sh_b[ty][tx] = bb;
  __syncthreads();
  if (ty != 0 || ch >= c) return;
  for (int l = 1; l < 8; ++l) {
    a += sh_a[l][tx];
    bb += sh_b[l][tx];
  }
  float* rd = red + static_cast<size_t>(b) * 2 * c;
  rd[ch] = a;
  rd[c + ch] = bb;
  if (whole) return;
  const float r = stats[static_cast<size_t>(b) * 3 * c + c + ch];
  const float k1 = r * (gamma ? gamma[b * gs + ch] : 1.f);
  float* k = bcoef + static_cast<size_t>(b) * 3 * c;
  k[ch] = k1;
  k[c + ch] = -k1 * a / hw;
  k[2 * c + ch] = -k1 * bb / hw;
}

// One block of 256 threads, LayerNorm only: per sample S1 = sum_c gamma_c
// A, S2 = sum_c gamma_c B (a tree in a fixed order), the coefficients
// k1..k3, and dgamma, dbeta (C) summed over the batch in order.
__global__ void __launch_bounds__(kThreads)
norm_bwd_finalize_sample(const float* __restrict__ red,
                         const float* __restrict__ stats,
                         const float* __restrict__ gamma,
                         float* __restrict__ bcoef, float* __restrict__ dgamma,
                         float* __restrict__ dbeta, int nb, int hw, int c) {
  const int t = threadIdx.x;
  const float n = static_cast<float>(hw) * static_cast<float>(c);
  __shared__ float sh1[kThreads], sh2[kThreads];
  for (int b = 0; b < nb; ++b) {
    const float* rd = red + static_cast<size_t>(b) * 2 * c;
    float s1 = 0.f, s2 = 0.f;
    for (int ch = t; ch < c; ch += kThreads) {
      s1 += gamma[ch] * rd[ch];
      s2 += gamma[ch] * rd[c + ch];
    }
    sh1[t] = s1;
    sh2[t] = s2;
    __syncthreads();
    for (int off = kThreads / 2; off > 0; off >>= 1) {
      if (t < off) {
        sh1[t] += sh1[t + off];
        sh2[t] += sh2[t + off];
      }
      __syncthreads();
    }
    const float* st = stats + static_cast<size_t>(b) * 3 * c;
    const float r = st[c];       // 1 / (std + eps), the same for every c
    const float sd = st[2 * c];  // std
    const float k2 = -sh1[0] * r / n;
    const float k3 = -sh2[0] / ((n - 1.f) * sd);
    float* k = bcoef + static_cast<size_t>(b) * 3 * c;
    for (int ch = t; ch < c; ch += kThreads) {
      k[ch] = gamma[ch] * r;
      k[c + ch] = k2;
      k[2 * c + ch] = k3;
    }
    __syncthreads();  // sh1, sh2 are read above before the next sample
  }
  for (int ch = t; ch < c; ch += kThreads) {
    float a = 0.f, bb = 0.f;
    for (int b = 0; b < nb; ++b) {
      a += red[static_cast<size_t>(b) * 2 * c + ch];
      bb += red[static_cast<size_t>(b) * 2 * c + c + ch];
    }
    dbeta[ch] = a;
    dgamma[ch] = bb;
  }
}

// Grid (S, B), the same split as norm_bwd_partials: dx = k1 dy' + k2 + k3 xh.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_bwd_apply(const T* __restrict__ x, const T* __restrict__ dy,
               T* __restrict__ dx, const float* __restrict__ stats,
               const float* __restrict__ gamma, long long gs,
               const float* __restrict__ beta, long long bs,
               const float* __restrict__ bcoef, int hw, int c, int rows,
               int relu) {
  const int groups = c / VEC;
  const int lanes = kThreads / groups;
  const int g = threadIdx.x % groups;
  const int lane = threadIdx.x / groups;
  if (lane >= lanes) return;
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = s * rows;
  const int r1 = min(r0 + rows, hw);
  const ChannelParams<VEC> cp(stats, gamma, gs, beta, bs, b, c, g * VEC);
  const float* kb = bcoef + static_cast<size_t>(b) * 3 * c + g * VEC;
  float k1[VEC], k2[VEC], k3[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    k1[v] = kb[v];
    k2[v] = kb[c + v];
    k3[v] = kb[2 * c + v];
  }
  const size_t off = static_cast<size_t>(b) * hw * c + g * VEC;
  for (int r = r0 + lane; r < r1; r += lanes) {
    const size_t at = off + static_cast<size_t>(r) * c;
    const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(x + at);
    const Pack<T, VEC> pd = *reinterpret_cast<const Pack<T, VEC>*>(dy + at);
    Pack<T, VEC> q;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float xh = (to_float(px.v[v]) - cp.mu[v]) * cp.r[v];
      float d = to_float(pd.v[v]);
      if (relu && !(xh * cp.ga[v] + cp.be[v] > 0.f)) d = 0.f;
      q.v[v] = from_float<T>(k1[v] * d + k2[v] + k3[v] * xh);
    }
    *reinterpret_cast<Pack<T, VEC>*>(dx + at) = q;
  }
}

// ------------------------------------------------------------- dispatch

struct Args {
  const void* x;
  void* y;        // forward: y; backward: dx
  const void* dy;  // backward only
  float* part;
  float* coef;    // forward: mean, scale, shift; backward: k1, k2, k3
  float* stats;   // forward writes, backward reads: mean, r, std
  float* red;     // backward: A, B per (sample, channel)
  float* dgamma;  // backward, LayerNorm: (C)
  float* dbeta;
  const float* gamma;
  long long gs;
  const float* beta;
  long long bs;
  int b, hw, c, splits, rows, whole, relu;
  float eps;
  cudaStream_t stream;
};

struct Forward {
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    const dim3 grid(a.splits, a.b);
    norm_partials<T, VEC><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.part, a.hw, a.c, a.rows, a.whole);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (a.whole) {
      norm_finalize_sample<<<a.b, kThreads, 0, a.stream>>>(
          a.part, a.coef, a.stats, a.gamma, a.gs, a.beta, a.bs, a.hw, a.c,
          a.splits, a.rows, a.eps);
    } else {
      norm_finalize_channels<<<dim3((a.c + 31) / 32, a.b), dim3(32, 8), 0,
                               a.stream>>>(a.part, a.coef, a.stats, a.gamma,
                                           a.gs, a.beta, a.bs, a.hw, a.c,
                                           a.splits, a.rows, a.eps);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    norm_apply<T, VEC><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<T*>(a.y), a.coef, a.hw, a.c,
        a.rows, a.relu);
    return cudaGetLastError();
  }
};

struct Backward {
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    const dim3 grid(a.splits, a.b);
    const T* x = static_cast<const T*>(a.x);
    const T* dy = static_cast<const T*>(a.dy);
    norm_bwd_partials<T, VEC><<<grid, kThreads, 0, a.stream>>>(
        x, dy, a.stats, a.gamma, a.gs, a.beta, a.bs, a.part, a.hw, a.c,
        a.rows, a.relu);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    norm_bwd_merge<<<dim3((a.c + 31) / 32, a.b), dim3(32, 8), 0, a.stream>>>(
        a.part, a.stats, a.gamma, a.gs, a.red, a.coef, a.hw, a.c, a.splits,
        a.whole);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (a.whole) {
      norm_bwd_finalize_sample<<<1, kThreads, 0, a.stream>>>(
          a.red, a.stats, a.gamma, a.coef, a.dgamma, a.dbeta, a.b, a.hw, a.c);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    norm_bwd_apply<T, VEC><<<grid, kThreads, 0, a.stream>>>(
        x, dy, static_cast<T*>(a.y), a.stats, a.gamma, a.gs, a.beta, a.bs,
        a.coef, a.hw, a.c, a.rows, a.relu);
    return cudaGetLastError();
  }
};

template <typename Pass, typename T>
cudaError_t run_vec(const Args& a, int vec) {
  switch (vec) {
    case 8:  // 16 bytes of a 2-byte type; f32 stops at 4
      if constexpr (sizeof(T) <= 2) return Pass::template run<T, 8>(a);
      return cudaErrorInvalidValue;
    case 4: return Pass::template run<T, 4>(a);
    case 2: return Pass::template run<T, 2>(a);
    case 1: return Pass::template run<T, 1>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Pass>
int dispatch(const Args& a, int is_bf16, int vec) {
  const cudaError_t e = is_bf16 ? run_vec<Pass, __nv_bfloat16>(a, vec)
                                : run_vec<Pass, float>(a, vec);
  return static_cast<int>(e);
}

}  // namespace

// One normalization of an NHWC tensor x (B, H*W rows, C channels) into y.
// part: f32 scratch (B, splits, 2, C), or (B, splits, 2) when whole;
// coef: f32 scratch (B, 3, C); stats: f32 output (B, 3, C), per (sample,
// channel) mean, r (the factor that multiplies x - mean before the affine)
// and std, which the backward reads.
// whole = 0: per-(sample, channel) statistics (IN, AdaIN); 1: per sample
// (LayerNorm). gamma/beta may be null. Returns cudaGetLastError().
extern "C" int munit_norm_forward(const void* x, void* y, void* part,
                                  void* coef, void* stats, const void* gamma,
                                  long long gs, const void* beta, long long bs,
                                  int b, int hw, int c, int splits, int rows,
                                  int is_bf16, int vec, int whole, int relu,
                                  float eps, void* stream) {
  Args a{};
  a.x = x;
  a.y = y;
  a.part = static_cast<float*>(part);
  a.coef = static_cast<float*>(coef);
  a.stats = static_cast<float*>(stats);
  a.gamma = static_cast<const float*>(gamma);
  a.gs = gs;
  a.beta = static_cast<const float*>(beta);
  a.bs = bs;
  a.b = b; a.hw = hw; a.c = c; a.splits = splits; a.rows = rows;
  a.whole = whole; a.relu = relu; a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Forward>(a, is_bf16, vec);
}

// The gradient of one normalization: dx (x's type and shape) from x, dy
// (contiguous NHWC, x's type) and the forward's stats. part: f32 scratch
// (B, splits, 2, C); red: f32 (B, 2, C), on return A = sum dy' (row 0,
// AdaIN's dbeta) and B = sum dy' xh (row 1, AdaIN's dgamma); bcoef: f32
// scratch (B, 3, C). whole = 1 (LayerNorm) also writes dgamma, dbeta (C).
extern "C" int munit_norm_backward(const void* x, const void* dy, void* dx,
                                   const void* stats, const void* gamma,
                                   long long gs, const void* beta,
                                   long long bs, void* part, void* red,
                                   void* bcoef, void* dgamma, void* dbeta,
                                   int b, int hw, int c, int splits, int rows,
                                   int is_bf16, int vec, int whole, int relu,
                                   void* stream) {
  Args a{};
  a.x = x;
  a.dy = dy;
  a.y = dx;
  a.stats = static_cast<float*>(const_cast<void*>(stats));
  a.gamma = static_cast<const float*>(gamma);
  a.gs = gs;
  a.beta = static_cast<const float*>(beta);
  a.bs = bs;
  a.part = static_cast<float*>(part);
  a.red = static_cast<float*>(red);
  a.coef = static_cast<float*>(bcoef);
  a.dgamma = static_cast<float*>(dgamma);
  a.dbeta = static_cast<float*>(dbeta);
  a.b = b; a.hw = hw; a.c = c; a.splits = splits; a.rows = rows;
  a.whole = whole; a.relu = relu;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Backward>(a, is_bf16, vec);
}

extern "C" const char* munit_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
