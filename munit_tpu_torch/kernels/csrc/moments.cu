// Per-sample moments and the per-sample affine of the whole-tensor
// LayerNorm for Hopper (sm_90a), with a plain C interface that
// munit_tpu_torch/kernels/moments.py binds through ctypes.
//
// They replace the Pallas TPU kernels of the whole-LN probes:
//   - tools/normprobe.py   _stats_kernel (:97)  P1a: per-(sample, row tile)
//                          sum x and sum x^2 in f32;
//   - tools/normprobe.py   _apply_kernel (:128) P1b: per-sample
//                          (x - mean) * inv * gamma + beta;
//   - tools/normprobe2.py  _stats_kernel (:114) P2 and
//     tools/normprobe3.py  _stats_kernel (:65)  P3a: the same sums kept
//                          per 128-lane vector register, summed after.
// On the TPU the per-lane form kept the reduction on the VPU; on Hopper
// both are one reduction of a sample's H*W*C values, so one kernel serves
// P1a, P2 and P3a. It also takes a second tensor b and sums a * b, which is
// the backward's sums of P3's closed-form v2 (b = y - mean).
//
//   1. sums_partials: grid (S, B); block s of sample b reads its contiguous
//      chunk of the sample once with 16-byte loads (four in flight per
//      thread), sums a and a * b in f32 per thread, then over the block in
//      a fixed tree (warp shuffles, then shared memory);
//   2. sums_merge: grid (B); sums the S partials of each sample in a fixed
//      order. No atomics: reruns match bit for bit.
//   3. sample_affine: grid (S, B), the same chunks; y = (x - mean_b) *
//      inv_b * gamma_c + beta_c, optional ReLU, math in f32, output in x's
//      type. gamma and beta sit in shared memory.
//
// Bound: device-memory bytes. The sums read each input once (2 flops per
// element, far below the ~20 flops per byte at which f32 compute would
// limit); the apply reads x once and writes y once. Partials are a few kB.
// The split aims at 4 blocks per SM over the batch so that every SM
// streams; the chunks are long and contiguous, so loads coalesce whole.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // 16-byte loads in flight per thread
constexpr int kMaxChannels = 1024;

using munit::from_float;
using munit::Pack;
using munit::to_float;

// Sum of v over the block in a fixed order; the result in thread 0.
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    if (lane < kThreads / 32) v = sh[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();  // sh may be reused by the caller
  return v;
}

// Grid (S, B). part[b][s][0] = sum a, part[b][s][1] = sum a * b over the
// elements [s * chunk, min((s + 1) * chunk, n)) of sample b (b = a when
// bv is null). n and chunk are multiples of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
sums_partials(const T* __restrict__ a, const T* __restrict__ bv,
              float* __restrict__ part, int n, int chunk) {
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int e0 = s * chunk;
  const int e1 = min(e0 + chunk, n);
  const T* pa = a + static_cast<size_t>(b) * n;
  const T* pb = bv ? bv + static_cast<size_t>(b) * n : nullptr;
  float s1 = 0.f, s2 = 0.f;
  constexpr int kStep = kThreads * VEC;
  for (int i0 = e0 + threadIdx.x * VEC; i0 < e1; i0 += kStep * kUnroll) {
    Pack<T, VEC> xa[kUnroll], xb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kStep;
      if (i < e1) {
        xa[u] = *reinterpret_cast<const Pack<T, VEC>*>(pa + i);
        if (pb) xb[u] = *reinterpret_cast<const Pack<T, VEC>*>(pb + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kStep < e1) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float x = to_float(xa[u].v[v]);
          const float y = pb ? to_float(xb[u].v[v]) : x;
          s1 += x;
          s2 = fmaf(x, y, s2);
        }
      }
    }
  }
  __shared__ float sh[kThreads / 32];
  s1 = block_sum(s1, sh);
  s2 = block_sum(s2, sh);
  if (threadIdx.x == 0) {
    float* out = part + (static_cast<size_t>(b) * gridDim.x + s) * 2;
    out[0] = s1;
    out[1] = s2;
  }
}

// Grid (B): sums[b][0..1] = the S partials of sample b, summed in a fixed
// order.
__global__ void __launch_bounds__(kThreads)
sums_merge(const float* __restrict__ part, float* __restrict__ sums,
           int splits) {
  const int b = blockIdx.x;
  const float* p = part + static_cast<size_t>(b) * splits * 2;
  float s1 = 0.f, s2 = 0.f;
  for (int s = threadIdx.x; s < splits; s += kThreads) {
    s1 += p[2 * s];
    s2 += p[2 * s + 1];
  }
  __shared__ float sh[kThreads / 32];
  s1 = block_sum(s1, sh);
  s2 = block_sum(s2, sh);
  if (threadIdx.x == 0) {
    sums[2 * b] = s1;
    sums[2 * b + 1] = s2;
  }
}

// Grid (S, B), the chunks of sums_partials. Element i of a sample is
// channel i % c; c is a multiple of VEC, so a pack never wraps a row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
sample_affine(const T* __restrict__ x, T* __restrict__ y,
              const float* __restrict__ mean, const float* __restrict__ inv,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              int n, int c, int chunk, int relu) {
  __shared__ float sg[kMaxChannels], sb[kMaxChannels];
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    sg[ch] = gamma[ch];
    sb[ch] = beta[ch];
  }
  __syncthreads();
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int e0 = s * chunk;
  const int e1 = min(e0 + chunk, n);
  const float mu = mean[b];
  const float r = inv[b];
  const size_t off = static_cast<size_t>(b) * n;
  constexpr int kStep = kThreads * VEC;
  for (int i0 = e0 + threadIdx.x * VEC; i0 < e1; i0 += kStep * kUnroll) {
    Pack<T, VEC> p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kStep;
      if (i < e1) p[u] = *reinterpret_cast<const Pack<T, VEC>*>(x + off + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kStep;
      if (i < e1) {
        const int c0 = i % c;
        Pack<T, VEC> q;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float t = (to_float(p[u].v[v]) - mu) * r;
          t = t * sg[c0 + v] + sb[c0 + v];
          if (relu && t < 0.f) t = 0.f;
          q.v[v] = from_float<T>(t);
        }
        *reinterpret_cast<Pack<T, VEC>*>(y + off + i) = q;
      }
    }
  }
}

struct Args {
  const void* a;
  const void* b;   // sums: the second tensor or null
  void* y;         // affine: the output
  float* part;
  float* sums;
  const float* mean;
  const float* inv;
  const float* gamma;
  const float* beta;
  int nb, n, c, splits, chunk, relu;
  cudaStream_t stream;
};

struct Sums {
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    sums_partials<T, VEC><<<dim3(a.splits, a.nb), kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.a), static_cast<const T*>(a.b), a.part, a.n,
        a.chunk);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    sums_merge<<<a.nb, kThreads, 0, a.stream>>>(a.part, a.sums, a.splits);
    return cudaGetLastError();
  }
};

struct Affine {
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    if (a.c > kMaxChannels) return cudaErrorInvalidValue;
    sample_affine<T, VEC><<<dim3(a.splits, a.nb), kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.a), static_cast<T*>(a.y), a.mean, a.inv,
        a.gamma, a.beta, a.n, a.c, a.chunk, a.relu);
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

// Per-sample sums of a contiguous (B, n) tensor a (f32 or bf16): sums[b] =
// (sum a, sum a * b), b = a when b is null (then sum a^2). part: f32
// scratch (B, splits, 2); sums: f32 (B, 2). Returns cudaGetLastError().
extern "C" int munit_sample_sums(const void* a, const void* b, void* part,
                                 void* sums, int nb, int n, int splits,
                                 int chunk, int is_bf16, int vec,
                                 void* stream) {
  Args g{};
  g.a = a;
  g.b = b;
  g.part = static_cast<float*>(part);
  g.sums = static_cast<float*>(sums);
  g.nb = nb; g.n = n; g.splits = splits; g.chunk = chunk;
  g.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Sums>(g, is_bf16, vec);
}

// y = (x - mean[b]) * inv[b] * gamma[c] + beta[c] (+ReLU) over a contiguous
// (B, n) tensor whose last axis is c channels (n a multiple of c); mean,
// inv: f32 (B); gamma, beta: f32 (c), c <= 1024. y has x's type.
extern "C" int munit_sample_affine(const void* x, void* y, const void* mean,
                                   const void* inv, const void* gamma,
                                   const void* beta, int nb, int n, int c,
                                   int splits, int chunk, int is_bf16,
                                   int vec, int relu, void* stream) {
  Args g{};
  g.a = x;
  g.y = y;
  g.mean = static_cast<const float*>(mean);
  g.inv = static_cast<const float*>(inv);
  g.gamma = static_cast<const float*>(gamma);
  g.beta = static_cast<const float*>(beta);
  g.nb = nb; g.n = n; g.c = c; g.splits = splits; g.chunk = chunk;
  g.relu = relu;
  g.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Affine>(g, is_bf16, vec);
}

extern "C" const char* munit_moments_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
