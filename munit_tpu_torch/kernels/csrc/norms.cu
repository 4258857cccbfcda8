// Norm kernels of the generator for Hopper (sm_90a), with a plain C
// interface that munit_tpu_torch/kernels/norms.py binds through ctypes.
//
// They replace the Pallas TPU kernels of munit_tpu/kernels:
//   - norms.py  _in_fwd_kernel   (instance norm, and AdaIN when affine)
//   - tiled.py  _stats_kernel + _norm_kernel (the large-slab form of it)
//   - norms.py  _ln_fwd_kernel   (the fork's whole-tensor LayerNorm)
// and the backward rules below. Bound: device-memory bytes (a few flops an
// element, far below the ~20 flops per byte at which f32 compute would
// limit); the least traffic is one read of x (and dy) and one write. Every
// call runs as one launch each way, in one of two designs that
// kernels/norms.py picks from the shape alone, before the launch
// (cluster_plan, then grid_plan); a third, older split design stays for
// timing the others against.
//
// The cluster design (norm_cluster_fwd, norm_cluster_bwd), for IN and AdaIN
// where a (sample, channel group) slab fits one cluster: at config_256
// every AdaIN and the IN at (64, 64, 256). On the TPU one grid
// step held a sample's whole (H, W, C) slab in VMEM and took a two-pass
// mean and variance, the affine and the ReLU from that copy: one read, one
// write. Here one thread block cluster takes one (sample, channel group)
// slab, the group one 128-byte line of channels (32 f32 or 64 bf16). Its K
// blocks (K <= 16) split the H*W rows; each copies its rows x group tile
// into shared memory once (cp.async, 16 bytes a thread, neighbouring
// threads on neighbouring addresses) and keeps it there, as VMEM did. The
// per-channel sums go over the block in a fixed tree, then over the
// cluster through distributed shared memory in rank order 0..K-1, so every
// block gets the same totals and reruns match bit for bit:
//   forward:  sum x -> mean; sum (x - mean)^2 -> var (the two-pass form of
//             _in_fwd_kernel, free from the on-chip copy); then each block
//             writes y = (x - mean) * rsqrt(var + eps) * gamma + beta (+ReLU)
//             from its tile, and rank 0 the stats (mean, r, std);
//   backward: x and dy on chip, x^ and the ReLU mask recomputed from the
//             stats, A = sum dy', B = sum dy' x^ over the cluster, then
//             dx = r gamma (dy' - A / HW - x^ B / HW) from the tiles; rank 0
//             writes dbeta = A, dgamma = B.
// The plan gives a block at most 64 kB of tiles (one tile forward, two
// backward); a slab that does not fit 16 blocks goes to the grid design.
//
// The grid design (norm_grid_fwd, norm_grid_bwd), for every other call: IN
// and AdaIN at 128^2 and 256^2 (2 MB and 8 MB a (sample, group) slab, more
// than a cluster holds) and every whole-tensor LayerNorm, which reduces
// over a whole sample (8-16 MB). What one cluster cannot hold, the whole
// card can: 132 SMs of up to 227 kB of shared memory. So one cooperative
// launch runs exactly as many blocks as are resident at once (one an SM:
// the plan's count, which the cooperative launch refuses rather than
// deadlock if the card holds fewer) and keeps a sample on chip across grid
// barriers, as VMEM did on the TPU:
//   phase 1:  block j takes a contiguous run of rows of one sample (all C
//             channels: one byte range of the NHWC tensor), copies the first
//             res rows into shared memory in four cp.async groups and reads
//             any rest from device memory meanwhile; per-thread Welford
//             (per-thread sums backward), merged over the block in lane
//             order, gives the segment's partials in global scratch: per
//             (sample, channel) forward, folded over the channels for the
//             LN; A, B per channel backward, and the LN's gamma-weighted
//             sums S1, S2 per segment;
//   barrier;  IN/AdaIN: the grid's warps each take a (sample, channel),
//             merge its segments in index order (two-pass Chan, no atomics)
//             and write the coefficients; a second barrier; every block
//             copies its sample's 3 x C coefficients into shared memory
//             once. LN: one warp of each block merges its sample's
//             segments itself, in the same order, so every block gets the
//             same bits with one barrier; the LN's dgamma, dbeta are summed
//             over segments and samples in order by the grid's warps;
//   phase 2:  y (dx) from the tile, then the rows beyond it re-read last
//             first (the likeliest to be in L2).
// At batch 1 the whole tensor stays on chip forward (8 and 16 MB over 132
// blocks of up to 192 kB) and at 128^2 backward too: one read, one write.
// Above that each block keeps as many rows as fit (the resident share is
// per block, not all-or-nothing) and re-reads the rest once. Measured on an
// H100 80GB HBM3 at 700 W, per call, f32, flushed L2: keeping what fits
// beat keeping nothing at batch 8 (128^2 forward 0.0828 against 0.0837 ms;
// bf16 backward 0.0735 against 0.0781); the owner merge with its second
// barrier beat every block merging all channels itself (0.0216 against
// 0.0588 ms at (1, 128, 128, 128)); one block an SM beat two at batch 1
// (0.0216 against 0.0279). The tiles stay within the 200 kB cap below
// (192 kB), and the static scratch (3 x 256 x VEC floats) beside it within
// the 227 kB a block may hold.
//
// The split design (three kernels each way), the first port's, reached
// only by the wrappers' private split=True, to time the other two against
// it. On the TPU the grid went one sample after another; here the slab is
// cut into row splits so that B x S blocks fill the card's 132 SMs even at
// batch 1:
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
// It reads x twice (partials, then apply), so it moves 1.5x the bound's
// bytes unless the slab still sits in the 50 MB L2 when apply runs.
// Partials and coefficients are a few hundred kB at most. The finalize
// kernels also hand back each (sample, channel)'s mean, 1/scale factor r
// and the LayerNorm's std (stats, B x 3 x C) for the backward below; the
// cluster forward writes the same stats.
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
// Both are dx = k1 * dy' + k2 + k3 * xh with per-(sample, channel) k1..k3.
// The cluster and grid designs take A and B (and S1, S2) in the same
// launch as dx, as above. The split design's four kernels:
//   1. norm_bwd_partials: split-HW partial sums of A and B per channel, the
//      forward's split of rows and threads, so batch 1 fills the SMs;
//   2. norm_bwd_merge: sums the splits in a fixed order (no atomics: reruns
//      match bit for bit) and, for IN and AdaIN, writes k1..k3;
//   3. norm_bwd_finalize_sample (LayerNorm only, one block): S1, S2 per
//      sample, k1..k3, and dgamma, dbeta summed over the batch in order;
//   4. norm_bwd_apply: dx from x, dy and k1..k3, in x's type.
// The least traffic is one read of x and dy and one write of dx (3 N
// itemsize); this design reads x and dy twice (partials, then apply), 5 N
// itemsize unless L2 still holds them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

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

// Threads of a block over a row of C channels: thread t takes channel
// group g = t % (C / VEC), VEC channels, of rows lane, lane + lanes, ...
// (lane = t / (C / VEC)), so a warp reads whole rows contiguously.
struct Lanes {
  int g, lane, lanes;
  bool active;  // lane < lanes: the block's last threads may have no row

  __device__ __forceinline__ Lanes(int c, int vec) {
    const int groups = c / vec;
    lanes = kThreads / groups;
    g = threadIdx.x % groups;
    lane = threadIdx.x / groups;
    active = lane < lanes;
  }
};

// Merges each thread's Welford state (n rows; mean, m2 of its VEC channels
// from g * VEC) over the lanes in lane order, per channel, into out[ch] =
// mean and out[c + ch] = M2; with whole, also folds the channels (in
// channel order per thread, then a fixed tree) into out[0] = mean and
// out[1] = M2 over all the block's values. Every thread of the block calls
// it; it ends in a barrier, so the scratch (kThreads * VEC, kThreads * VEC,
// kThreads floats) can be reused at once.
template <int VEC>
__device__ void block_welford(const Lanes& l, int c, float n,
                              const float (&mean)[VEC],
                              const float (&m2)[VEC], int whole, float* out,
                              float* sh_mean, float* sh_m2, float* sh_n) {
  if (l.active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sh_mean[l.lane * c + l.g * VEC + v] = mean[v];
      sh_m2[l.lane * c + l.g * VEC + v] = m2[v];
    }
    if (l.g == 0) sh_n[l.lane] = n;
  }
  __syncthreads();

  const int t = threadIdx.x;
  float tn = 0.f, tmean = 0.f, tm2 = 0.f;  // this thread's channels (whole)
  for (int ch = t; ch < c; ch += kThreads) {
    float cn = 0.f, cmean = 0.f, cm2 = 0.f;
    for (int q = 0; q < l.lanes; ++q)
      merge(cn, cmean, cm2, sh_n[q], sh_mean[q * c + ch], sh_m2[q * c + ch]);
    if (whole) {
      merge(tn, tmean, tm2, cn, cmean, cm2);
    } else {
      out[ch] = cmean;
      out[c + ch] = cm2;
    }
  }
  __syncthreads();  // every read of the lanes' partials is done
  if (!whole) return;  // uniform over the block
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
  __syncthreads();
}

// Grid (S, B), the threads as Lanes. Writes part[b][s][0][c] = mean and
// part[b][s][1][c] = M2; with whole, part[b][s][0] = mean and
// part[b][s][1] = M2 over all the split's values.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_partials(const T* __restrict__ x, float* __restrict__ part, int hw,
              int c, int rows, int whole) {
  const Lanes l(c, VEC);
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = s * rows;
  const int r1 = min(r0 + rows, hw);

  __shared__ float sh_mean[kThreads * VEC];
  __shared__ float sh_m2[kThreads * VEC];
  __shared__ float sh_n[kThreads];

  float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) mean[v] = m2[v] = 0.f;
  if (l.active) {
    const T* base = x + static_cast<size_t>(b) * hw * c + l.g * VEC;
    for (int r = r0 + l.lane; r < r1; r += l.lanes) {
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
  }
  block_welford<VEC>(l, c, n, mean, m2, whole,
                     part + (static_cast<size_t>(b) * gridDim.x + s) * 2 *
                                (whole ? 1 : c),
                     sh_mean, sh_m2, sh_n);
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

// ------------------------------------------------------ cluster design

constexpr int kLineBytes = 128;  // a group's row segment: 32 f32, 64 bf16
// Dynamic shared memory a cluster kernel may take; the plan stays below.
constexpr int kMaxDynamicSmem = 200 * 1024;
constexpr int kMaxCluster = 16;  // above 8 only with the non-portable flag
constexpr int kMaxDevices = 64;

// Copies BYTES (4, 8 or 16) from global into shared memory without
// staging them in registers, so every load of the tile is in flight at once.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES) : "memory");
  }
}

// Waits for this thread's cp.async copies, then for the block's.
__device__ __forceinline__ void landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The two halves of cluster.sync(): a block arrives once it has read the
// others' shared memory, and waits only before it exits, so that its own
// shared memory outlives every read of it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One block's share of its cluster's (sample b, channel group) slab: rows
// [r0, r0 + n) of the sample and channels [ch0, ch0 + kCg). Thread t holds
// VEC channels from ch of rows t / kLanes, + kRowStep, ...; the tile keeps
// the rows x kCg share row-major in shared memory. Grid (groups x K, B),
// clusters of K blocks along x.
template <typename T, int VEC>
struct Share {
  static constexpr int kCg = kLineBytes / sizeof(T);
  static constexpr int kLanes = kCg / VEC;            // threads along a row
  static constexpr int kRowStep = kThreads / kLanes;  // rows per block pass
  // threads per row group after the warp shuffles, and the groups
  static constexpr int kSpan = kLanes < 32 ? 32 : kLanes;
  static constexpr int kGroups = kThreads / kSpan;

  int b, ch0, lane, row, ch, r0, n, hw, c;  // n: 0 where !active
  bool active;  // C % VEC == 0, so a thread's vector is whole or outside

  __device__ __forceinline__ Share(int hw_, int c_, int rows)
      : hw(hw_), c(c_) {
    cg::cluster_group cluster = cg::this_cluster();
    b = blockIdx.y;
    ch0 = (blockIdx.x / cluster.num_blocks()) * kCg;
    lane = threadIdx.x % kLanes;
    row = threadIdx.x / kLanes;
    ch = ch0 + lane * VEC;
    active = ch < c;
    r0 = min(static_cast<int>(cluster.block_rank()) * rows, hw);
    n = active ? min(rows, hw - r0) : 0;  // rows this thread's vector sees
  }

  // Offset of this thread's vector in row r of the share, in the tensor.
  __device__ __forceinline__ size_t at(int r) const {
    return (static_cast<size_t>(b) * hw + r0 + r) * c + ch;
  }
  __device__ __forceinline__ T* slot(T* tile, int r) const {
    return tile + r * kCg + lane * VEC;
  }

  // Starts the copy of the share of src into tile; landed() waits for it.
  __device__ __forceinline__ void fetch(const T* __restrict__ src,
                                        T* tile) const {
    if (active) {
      for (int r = row; r < n; r += kRowStep) {
        if constexpr (VEC * sizeof(T) >= 4) {
          cp_async<static_cast<int>(VEC * sizeof(T))>(slot(tile, r),
                                                      src + at(r));
        } else {
          *slot(tile, r) = src[at(r)];
        }
      }
    }
  }
};

// Per-channel sums over the block of each thread's NV x VEC partials v, in
// a fixed order (warp shuffles, then the row groups in order): out[i * kCg
// + j] holds value i of channel ch0 + j. scratch: NV x kGroups x kCg.
template <typename S, int NV, int VEC>
__device__ __forceinline__ void block_channel_sums(float (&v)[NV][VEC],
                                                   float* scratch,
                                                   float* out) {
  if constexpr (S::kLanes < 32) {
#pragma unroll
    for (int off = S::kLanes; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          v[i][u] += __shfl_xor_sync(0xffffffffu, v[i][u], off);
  }
  const int g = threadIdx.x / S::kSpan;
  const int t = threadIdx.x % S::kSpan;
  if (t < S::kLanes) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        scratch[(i * S::kGroups + g) * S::kCg + t * VEC + u] = v[i][u];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < NV * S::kCg; j += kThreads) {
    const int i = j / S::kCg, k = j % S::kCg;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < S::kGroups; ++q)
      s += scratch[(i * S::kGroups + q) * S::kCg + k];
    out[j] = s;
  }
}

// After a cluster barrier: tot[j] = sum over the cluster's blocks, in rank
// order, of their part[j], j < len, read through distributed shared
// memory; then a block barrier.
__device__ __forceinline__ void cluster_totals(float* part, float* tot,
                                               int len) {
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  for (int j = threadIdx.x; j < len; j += kThreads) {
    float got[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < blocks) got[q] = *cluster.map_shared_rank(part + j, q);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < blocks) s += got[q];
    tot[j] = s;
  }
  __syncthreads();
}

// One IN or AdaIN (+ReLU) forward in one launch: grid (groups x K, B),
// clusters of K blocks, rows x kCg tile of x in dynamic shared memory.
// gamma/beta: null or f32 rows with stride gs / bs between samples.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_cluster_fwd(const T* __restrict__ x, T* __restrict__ y,
                 float* __restrict__ stats, const float* __restrict__ gamma,
                 long long gs, const float* __restrict__ beta, long long bs,
                 int hw, int c, int rows, int relu, float eps) {
  using S = Share<T, VEC>;
  cg::cluster_group cluster = cg::this_cluster();
  const S s(hw, c, rows);
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  __shared__ float scratch[S::kGroups * S::kCg];
  __shared__ float part[2][S::kCg];  // this block's sums; the cluster reads
  __shared__ float sum1[S::kCg], sum2[S::kCg];  // the cluster's totals
  s.fetch(x, tile);
  landed();

  float v[1][VEC] = {};
  for (int r = s.row; r < s.n; r += S::kRowStep) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(s.slot(tile, r));
#pragma unroll
    for (int u = 0; u < VEC; ++u) v[0][u] += to_float(p.v[u]);
  }
  block_channel_sums<S>(v, scratch, part[0]);
  cluster.sync();
  cluster_totals(part[0], sum1, S::kCg);
  const float count = static_cast<float>(hw);
  float mu[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    mu[u] = sum1[s.lane * VEC + u] / count;
    v[0][u] = 0.f;
  }
  for (int r = s.row; r < s.n; r += S::kRowStep) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(s.slot(tile, r));
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const float d = to_float(p.v[u]) - mu[u];
      v[0][u] += d * d;
    }
  }
  block_channel_sums<S>(v, scratch, part[1]);
  cluster.sync();
  cluster_totals(part[1], sum2, S::kCg);
  cluster_arrive();  // done with the other blocks' shared memory

  float a[VEC], d[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    const float scale = rsqrtf(sum2[s.lane * VEC + u] / count + eps);
    a[u] = (gamma && s.active) ? scale * gamma[s.b * gs + s.ch + u] : scale;
    d[u] = (beta && s.active) ? beta[s.b * bs + s.ch + u] : 0.f;
  }
  for (int r = s.row; r < s.n; r += S::kRowStep) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(s.slot(tile, r));
    Pack<T, VEC> q;
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      float t = (to_float(p.v[u]) - mu[u]) * a[u] + d[u];
      if (relu && t < 0.f) t = 0.f;
      q.v[u] = from_float<T>(t);
    }
    *reinterpret_cast<Pack<T, VEC>*>(y + s.at(r)) = q;
  }
  if (cluster.block_rank() == 0) {
    for (int j = threadIdx.x; j < S::kCg && s.ch0 + j < c; j += kThreads) {
      const float var = sum2[j] / count;
      float* st = stats + static_cast<size_t>(s.b) * 3 * c + s.ch0 + j;
      st[0] = sum1[j] / count;
      st[c] = rsqrtf(var + eps);
      st[2 * c] = sqrtf(var);
    }
  }
  cluster_wait();
}

// The gradient of one IN or AdaIN (+ReLU) in one launch, the forward's grid
// and clusters: x and dy tiles in dynamic shared memory, A and B over the
// cluster, dx from the tiles. red: null (IN) or f32 (B, 2, C), dbeta = A
// and dgamma = B, written by rank 0.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_cluster_bwd(const T* __restrict__ x, const T* __restrict__ dy,
                 T* __restrict__ dx, const float* __restrict__ stats,
                 const float* __restrict__ gamma, long long gs,
                 const float* __restrict__ beta, long long bs,
                 float* __restrict__ red, int hw, int c, int rows, int relu) {
  using S = Share<T, VEC>;
  cg::cluster_group cluster = cg::this_cluster();
  const S s(hw, c, rows);
  extern __shared__ __align__(16) unsigned char smem[];
  T* tx = reinterpret_cast<T*>(smem);
  T* tdy = tx + static_cast<size_t>(rows) * S::kCg;
  __shared__ float scratch[2 * S::kGroups * S::kCg];
  __shared__ float part[2 * S::kCg];  // A, B of this block; the cluster reads
  __shared__ float tot[2 * S::kCg];
  s.fetch(x, tx);
  s.fetch(dy, tdy);
  landed();

  const ChannelParams<VEC> cp(stats, gamma, gs, beta, bs, s.b, c,
                              s.active ? s.ch : 0);
  float v[2][VEC] = {};
  for (int r = s.row; r < s.n; r += S::kRowStep) {
    const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(s.slot(tx, r));
    const Pack<T, VEC> pd = *reinterpret_cast<const Pack<T, VEC>*>(s.slot(tdy, r));
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const float xh = (to_float(px.v[u]) - cp.mu[u]) * cp.r[u];
      float g = to_float(pd.v[u]);
      if (relu && !(xh * cp.ga[u] + cp.be[u] > 0.f)) g = 0.f;
      v[0][u] += g;
      v[1][u] += g * xh;
    }
  }
  block_channel_sums<S>(v, scratch, part);
  cluster.sync();
  cluster_totals(part, tot, 2 * S::kCg);
  cluster_arrive();  // done with the other blocks' shared memory

  float k1[VEC], k2[VEC], k3[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    k1[u] = cp.r[u] * cp.ga[u];
    k2[u] = -k1[u] * tot[s.lane * VEC + u] / hw;
    k3[u] = -k1[u] * tot[S::kCg + s.lane * VEC + u] / hw;
  }
  for (int r = s.row; r < s.n; r += S::kRowStep) {
    const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(s.slot(tx, r));
    const Pack<T, VEC> pd = *reinterpret_cast<const Pack<T, VEC>*>(s.slot(tdy, r));
    Pack<T, VEC> q;
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const float xh = (to_float(px.v[u]) - cp.mu[u]) * cp.r[u];
      float g = to_float(pd.v[u]);
      if (relu && !(xh * cp.ga[u] + cp.be[u] > 0.f)) g = 0.f;
      q.v[u] = from_float<T>(k1[u] * g + k2[u] + k3[u] * xh);
    }
    *reinterpret_cast<Pack<T, VEC>*>(dx + s.at(r)) = q;
  }
  if (red && cluster.block_rank() == 0) {
    for (int j = threadIdx.x; j < S::kCg && s.ch0 + j < c; j += kThreads) {
      float* rd = red + static_cast<size_t>(s.b) * 2 * c + s.ch0 + j;
      rd[0] = tot[j];
      rd[c] = tot[S::kCg + j];
    }
  }
  cluster_wait();
}

// --------------------------------------------------------- grid design

// Loads of a thread's rows that stay in flight at once where the rows are
// read from device memory rather than from the on-chip tile.
constexpr int kGridUnroll = 8;
constexpr int kWarps = kThreads / 32;
// Splits a lane of a merging warp loads at once (32 x 8 = 256 splits in one
// round trip to L2).
constexpr int kMergeUnroll = 8;
// Rows a thread of the grid backward sums before it adds them to its
// running sums.
constexpr int kSumBlock = 16;

// Segment seg of a grid launch: rows [r0, r0 + n) of sample b, split s of
// the sample's splits. A block keeps on chip (res rows) only its first
// segment, blockIdx.x; any later one (batches above the grid) streams.
struct Segment {
  int b, s, r0, n, res;

  __device__ __forceinline__ Segment(int seg, int splits, int rows, int hw,
                                     int res_rows) {
    b = seg / splits;
    s = seg % splits;
    r0 = s * rows;
    n = min(rows, hw - r0);
    res = seg == static_cast<int>(blockIdx.x) ? min(res_rows, n) : 0;
  }
  // Element offset of the segment's first row in the tensor.
  __device__ __forceinline__ size_t at(int hw, int c) const {
    return (static_cast<size_t>(b) * hw + r0) * c;
  }
};

// The tile is filled in kFillChunks runs of rows, each its own cp.async
// group, so that the block reduces one run while the later ones land.
constexpr int kFillChunks = 4;

__device__ __forceinline__ int chunk_row(int j, int res) {
  return j * res / kFillChunks;
}

// Starts the copy of rows [0, res) of C channels of each src[t] (16-byte or
// VEC x itemsize aligned) into tile[t], in kFillChunks commit groups.
template <typename T, int VEC, int NT>
__device__ __forceinline__ void fetch_rows(const T* const (&src)[NT],
                                           T* const (&tile)[NT], int res,
                                           int c) {
  for (int j = 0; j < kFillChunks; ++j) {
    const int hi = chunk_row(j + 1, res) * c;
    for (int i = chunk_row(j, res) * c + threadIdx.x * VEC; i < hi;
         i += kThreads * VEC) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if constexpr (VEC * sizeof(T) >= 4) {
          cp_async<static_cast<int>(VEC * sizeof(T))>(tile[t] + i, src[t] + i);
        } else {
          tile[t][i] = src[t][i];
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// Waits until at most N of this thread's copy groups are in flight, then
// for the block's.
template <int N>
__device__ __forceinline__ void landed_but() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncthreads();
}

// Calls f(lo, hi) for each run of rows of a tile that fetch_rows started,
// in order, as soon as it has landed. Every thread of the block calls it.
template <typename F>
__device__ __forceinline__ void over_chunks(int res, F&& f) {
  static_assert(kFillChunks == 4, "one wait per chunk below");
  landed_but<3>();
  f(chunk_row(0, res), chunk_row(1, res));
  landed_but<2>();
  f(chunk_row(1, res), chunk_row(2, res));
  landed_but<1>();
  f(chunk_row(2, res), chunk_row(3, res));
  landed_but<0>();
  f(chunk_row(3, res), res);
}

// Calls f(p, r) for this thread's rows r >= res of a segment of n rows,
// p[t] the VEC channels of row r of tensor t, read from device memory
// (src[t]: the segment's first row, at this thread's channels), with
// kGridUnroll rows of loads in flight. kReverse visits the rows last
// first: a second pass then starts with the rows the first pass read last,
// which L2 is the likeliest to still hold.
template <typename T, int VEC, int NT, bool kReverse = false, typename F>
__device__ __forceinline__ void visit_global(const T* const (&src)[NT],
                                             const Lanes& l, int n, int res,
                                             int c, F&& f) {
  using P = Pack<T, VEC>;
  int first = l.lane;
  if (first < res) first += (res - l.lane + l.lanes - 1) / l.lanes * l.lanes;
  const int count = first < n ? (n - first + l.lanes - 1) / l.lanes : 0;
  for (int k = 0; k < count; k += kGridUnroll) {
    P p[kGridUnroll][NT];
    int rr[kGridUnroll];
#pragma unroll
    for (int u = 0; u < kGridUnroll; ++u) {
      const int j = kReverse ? count - 1 - (k + u) : k + u;
      rr[u] = k + u < count ? first + j * l.lanes : -1;
      if (rr[u] >= 0) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
          p[u][t] = *reinterpret_cast<const P*>(
              src[t] + static_cast<size_t>(rr[u]) * c);
      }
    }
#pragma unroll
    for (int u = 0; u < kGridUnroll; ++u)
      if (rr[u] >= 0) f(p[u], rr[u]);
  }
}

// The same for the rows lo <= r < hi, from the tiles (tile[t]: row 0 of
// the segment at this thread's channels, rows of C channels).
template <typename T, int VEC, int NT, typename F>
__device__ __forceinline__ void visit_tile(T* const (&tile)[NT],
                                           const Lanes& l, int lo, int hi,
                                           int c, F&& f) {
  using P = Pack<T, VEC>;
  for (int r = lo + l.lane; r < hi; r += l.lanes) {
    P p[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t)
      p[t] = *reinterpret_cast<const P*>(tile[t] + r * c);
    f(p, r);
  }
}

// The sum over a warp of each lane's v, in a fixed shuffle tree; every
// lane returns it.
__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Merges over a warp the splits' (mean, M2) partials at p[s * stride] and
// p[s * stride + off], split s counting split_count(s) x per_row values,
// with the two-pass form of Chan's formula: n = sum n_s, mean = sum n_s
// mean_s / n, M2 = sum (M2_s + n_s (mean_s - mean)^2). Lane l takes splits
// l, l + 32, ..., the first 32 x kMergeUnroll of them held in registers
// from one round of loads; the sums go in a fixed order, and every lane
// returns the same totals. The partials were written by other blocks of
// this launch before a grid barrier, so they are read through L2
// (__ldcg), never from a stale L1 line.
__device__ __forceinline__ void warp_welford(const float* p, size_t stride,
                                             int off, int splits, int rows,
                                             int hw, float per_row, float& n,
                                             float& mean, float& m2) {
  const int lane = threadIdx.x & 31;
  float k[kMergeUnroll], m[kMergeUnroll], q[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int s = u * 32 + lane;
    const bool in = s < splits;
    k[u] = in ? split_count(s, rows, hw) * per_row : 0.f;
    m[u] = in ? __ldcg(p + s * stride) : 0.f;
    q[u] = in ? __ldcg(p + s * stride + off) : 0.f;
  }
  float sn = 0.f, sx = 0.f;
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    sn += k[u];
    sx += k[u] * m[u];
  }
  for (int s = 32 * kMergeUnroll + lane; s < splits; s += 32) {
    const float ks = split_count(s, rows, hw) * per_row;
    sn += ks;
    sx += ks * __ldcg(p + s * stride);
  }
  n = warp_total(sn);
  mean = warp_total(sx) / n;
  float sq = 0.f;
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const float d = m[u] - mean;
    sq += q[u] + k[u] * d * d;
  }
  for (int s = 32 * kMergeUnroll + lane; s < splits; s += 32) {
    const float d = __ldcg(p + s * stride) - mean;
    sq += __ldcg(p + s * stride + off) + split_count(s, rows, hw) * per_row *
                                             d * d;
  }
  m2 = warp_total(sq);
}

// The same for plain sums of the pairs (p[s * stride], p[s * stride + off]).
__device__ __forceinline__ void warp_sums(const float* p, size_t stride,
                                          int off, int splits, float& a,
                                          float& b) {
  const int lane = threadIdx.x & 31;
  a = b = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32 * kMergeUnroll) {
    float x[kMergeUnroll], y[kMergeUnroll];  // every load in flight at once
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      const int s = s0 + u * 32 + lane;
      x[u] = s < splits ? __ldcg(p + s * stride) : 0.f;
      y[u] = s < splits ? __ldcg(p + s * stride + off) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      a += x[u];
      b += y[u];
    }
  }
  a = warp_total(a);
  b = warp_total(b);
}

// Copies the 3 x C coefficients of one sample (written by other blocks
// before a grid barrier) into shared memory, one coalesced pass through L2
// for the whole block: every thread then reads its channels' values there
// rather than each warp of the grid asking L2 for the same few lines.
__device__ __forceinline__ void stage(const float* src, float* dst, int n) {
  __syncthreads();  // the previous use of dst is done
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = __ldcg(src + i);
  __syncthreads();
}

// Sums each thread's (sa, sb) of its VEC channels over the lanes in order:
// out[ch] = A, out[c + ch] = B. With gamma (the LayerNorm), also s1 =
// sum_c gamma_c A_c and s2 = sum_c gamma_c B_c in a fixed tree into
// out2[0], out2[1]. Every thread calls it; it ends in a barrier.
template <int VEC>
__device__ void block_sums(const Lanes& l, int c, const float (&sa)[VEC],
                           const float (&sb)[VEC], float* out,
                           const float* __restrict__ gamma, float* out2,
                           float* sh_a, float* sh_b) {
  if (l.active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sh_a[l.lane * c + l.g * VEC + v] = sa[v];
      sh_b[l.lane * c + l.g * VEC + v] = sb[v];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  for (int ch = t; ch < c; ch += kThreads) {
    float a = 0.f, bb = 0.f;
    for (int q = 0; q < l.lanes; ++q) {
      a += sh_a[q * c + ch];
      bb += sh_b[q * c + ch];
    }
    out[ch] = a;
    out[c + ch] = bb;
    if (gamma) {
      s1 += gamma[ch] * a;
      s2 += gamma[ch] * bb;
    }
  }
  __syncthreads();
  if (!gamma) return;  // uniform over the block
  sh_a[t] = s1;
  sh_b[t] = s2;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) {
      sh_a[t] += sh_a[t + off];
      sh_b[t] += sh_b[t + off];
    }
    __syncthreads();
  }
  if (t == 0) {
    out2[0] = sh_a[0];
    out2[1] = sh_b[0];
  }
  __syncthreads();
}

// One IN, AdaIN or (whole) LayerNorm (+ReLU) forward in one cooperative
// launch of blocks that are all resident at once. Block j takes segment j
// (and j + gridDim.x, ... where the batch exceeds the grid): it copies its
// first res_rows rows into shared memory (cp.async) and, while they land,
// reads the rest from device memory; per-thread Welford, merged over the
// block in lane order, gives the segment's partial (per channel, or per
// sample with whole) in part. Grid barrier. IN/AdaIN: the warps of the grid
// take the (sample, channel) items, merge the splits in index order (Chan)
// and write coef (mean, scale x gamma, beta) and stats; a second grid
// barrier. LN: every warp merges its sample's splits itself, in the same
// order, so every block gets the same bits without a second barrier. Then
// each block applies from its tile (and re-reads the rows beyond it).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_grid_fwd(const T* __restrict__ x, T* __restrict__ y, float* part,
              float* coef, float* __restrict__ stats,
              const float* __restrict__ gamma, long long gs,
              const float* __restrict__ beta, long long bs, int nb, int hw,
              int c, int splits, int rows, int res_rows, int whole, int relu,
              float eps) {
  using P = Pack<T, VEC>;
  cg::grid_group grid = cg::this_grid();
  const Lanes l(c, VEC);
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  // block_welford's scratch, then a sample's coefficients (3 C <= 3 x 256
  // x VEC: a block's threads cover at most 256 vectors of a row)
  __shared__ float sh[3 * kThreads * VEC];
  float* sh_mean = sh;
  float* sh_m2 = sh + kThreads * VEC;
  float* sh_n = sh + 2 * kThreads * VEC;
  const int nseg = nb * splits;
  const size_t pstride = whole ? 2 : 2 * static_cast<size_t>(c);
  T* const tiles[1] = {tile + l.g * VEC};

  for (int seg = blockIdx.x; seg < nseg; seg += gridDim.x) {
    const Segment sg(seg, splits, rows, hw, res_rows);
    const T* xs = x + sg.at(hw, c);
    const T* const seg_rows[1] = {xs};
    T* const tile_rows[1] = {tile};
    fetch_rows<T, VEC, 1>(seg_rows, tile_rows, sg.res, c);
    float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) mean[v] = m2[v] = 0.f;
    auto welford = [&](const P (&p)[1], int) {
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xv = to_float(p[0].v[v]);
        const float d = xv - mean[v];
        mean[v] += d * inv;
        m2[v] += d * (xv - mean[v]);
      }
    };
    const T* const src[1] = {xs + l.g * VEC};
    if (l.active) visit_global<T, VEC, 1>(src, l, sg.n, sg.res, c, welford);
    over_chunks(sg.res, [&](int lo, int hi) {
      if (l.active) visit_tile<T, VEC, 1>(tiles, l, lo, hi, c, welford);
    });
    block_welford<VEC>(l, c, n, mean, m2, whole, part + seg * pstride,
                       sh_mean, sh_m2, sh_n);
  }
  grid.sync();

  if (!whole) {
    const int warp = threadIdx.x / 32;
    for (int it = blockIdx.x * kWarps + warp; it < nb * c;
         it += gridDim.x * kWarps) {
      const int b = it / c, ch = it % c;
      float n, mean, m2;
      warp_welford(part + static_cast<size_t>(b) * splits * pstride + ch,
                   pstride, c, splits, rows, hw, 1.f, n, mean, m2);
      if ((threadIdx.x & 31) == 0) {
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
    }
    grid.sync();
  }

  for (int seg = blockIdx.x; seg < nseg; seg += gridDim.x) {
    const Segment sg(seg, splits, rows, hw, res_rows);
    const int ch0 = l.g * VEC;
    float mu[VEC], a[VEC], d[VEC];
    if (whole) {
      __syncthreads();  // sh's previous use is done
      if (threadIdx.x < 32) {  // one warp merges, the block shares it
        float n, mean, m2;
        warp_welford(part + static_cast<size_t>(sg.b) * splits * 2, 2, 1,
                     splits, rows, hw, static_cast<float>(c), n, mean, m2);
        if (threadIdx.x == 0) {
          sh[0] = mean;
          sh[1] = sqrtf(m2 / (n - 1.f));
        }
      }
      __syncthreads();
      const float mean = sh[0], sd = sh[1];
      const float scale = 1.f / (sd + eps);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        mu[v] = mean;
        a[v] = gamma ? scale * gamma[sg.b * gs + ch0 + v] : scale;
        d[v] = beta ? beta[sg.b * bs + ch0 + v] : 0.f;
      }
      if (sg.s == 0) {
        float* st = stats + static_cast<size_t>(sg.b) * 3 * c;
        for (int ch = threadIdx.x; ch < c; ch += kThreads) {
          st[ch] = mean;
          st[c + ch] = scale;
          st[2 * c + ch] = sd;
        }
      }
    } else {
      stage(coef + static_cast<size_t>(sg.b) * 3 * c, sh, 3 * c);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        mu[v] = sh[ch0 + v];
        a[v] = sh[c + ch0 + v];
        d[v] = sh[2 * c + ch0 + v];
      }
    }
    T* ys = y + sg.at(hw, c) + ch0;
    auto apply = [&](const P (&p)[1], int r) {
      P q;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float t = (to_float(p[0].v[v]) - mu[v]) * a[v] + d[v];
        if (relu && t < 0.f) t = 0.f;
        q.v[v] = from_float<T>(t);
      }
      *reinterpret_cast<P*>(ys + static_cast<size_t>(r) * c) = q;
    };
    const T* const src[1] = {x + sg.at(hw, c) + ch0};
    if (l.active) {
      visit_tile<T, VEC, 1>(tiles, l, 0, sg.res, c, apply);
      visit_global<T, VEC, 1, true>(src, l, sg.n, sg.res, c, apply);
    }
  }
}

// The gradient of one IN, AdaIN or (whole) LayerNorm (+ReLU) in one
// cooperative launch, the forward's grid: x and dy tiles on chip, per
// segment A = sum dy' and B = sum dy' xh per channel into part (B x S x 2 x
// C), and for the LN s1 = sum_c gamma_c A, s2 = sum_c gamma_c B into part2
// (B x S x 2). Grid barrier. IN/AdaIN: the grid's warps merge each
// (sample, channel) over the splits in order into bcoef (k1..k3) and red
// (dbeta = A, dgamma = B, AdaIN only); a second barrier. LN: the warps of
// the grid sum dbeta, dgamma per channel over splits and samples in order,
// and every warp merges its sample's s1, s2 itself (no second barrier).
// Then dx = k1 dy' + k2 + k3 xh from the tiles.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_grid_bwd(const T* __restrict__ x, const T* __restrict__ dy,
              T* __restrict__ dx, const float* __restrict__ stats,
              const float* __restrict__ gamma, long long gs,
              const float* __restrict__ beta, long long bs, float* part,
              float* red, float* bcoef, float* dgamma, float* dbeta, int nb,
              int hw, int c, int splits, int rows, int res_rows, int whole,
              int relu) {
  using P = Pack<T, VEC>;
  cg::grid_group grid = cg::this_grid();
  const Lanes l(c, VEC);
  extern __shared__ __align__(16) unsigned char smem[];
  T* tx = reinterpret_cast<T*>(smem);
  T* tdy = tx + static_cast<size_t>(res_rows) * c;
  // block_sums' scratch, then a sample's coefficients (3 C <= 3 x 256 x
  // VEC, as in the forward)
  __shared__ float sh[3 * kThreads * VEC];
  float* sh_a = sh;
  float* sh_b = sh + kThreads * VEC;
  const int nseg = nb * splits;
  const size_t pstride = 2 * static_cast<size_t>(c);
  float* part2 = part + nseg * pstride;
  const int ch0 = l.g * VEC;
  T* const tiles[2] = {tx + ch0, tdy + ch0};

  for (int seg = blockIdx.x; seg < nseg; seg += gridDim.x) {
    const Segment sg(seg, splits, rows, hw, res_rows);
    const size_t at = sg.at(hw, c);
    const T* const seg_rows[2] = {x + at, dy + at};
    T* const tile_rows[2] = {tx, tdy};
    fetch_rows<T, VEC, 2>(seg_rows, tile_rows, sg.res, c);
    const ChannelParams<VEC> cp(stats, gamma, gs, beta, bs, sg.b, c, ch0);
    // A thread sums up to a few thousand rows (one block an SM), so it sums
    // them in blocks of kSumBlock rows (ia, ib), each added to the running
    // sums (sa, sb) when full: every rounding chain is then at most
    // kSumBlock + rows / kSumBlock long, shorter than the split design's,
    // for one add per kSumBlock rows. The LN's batch-summed dgamma, dbeta
    // need it (phase 6 of chip_smoke.py holds them against float64).
    float sa[VEC], sb[VEC], ia[VEC], ib[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) sa[v] = sb[v] = ia[v] = ib[v] = 0.f;
    int in_block = 0;
    auto sums = [&](const P (&p)[2], int) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xh = (to_float(p[0].v[v]) - cp.mu[v]) * cp.r[v];
        float g = to_float(p[1].v[v]);
        if (relu && !(xh * cp.ga[v] + cp.be[v] > 0.f)) g = 0.f;
        ia[v] += g;
        ib[v] += g * xh;
      }
      if (++in_block == kSumBlock) {
        in_block = 0;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          sa[v] += ia[v];
          sb[v] += ib[v];
          ia[v] = ib[v] = 0.f;
        }
      }
    };
    const T* const src[2] = {x + at + ch0, dy + at + ch0};
    if (l.active) visit_global<T, VEC, 2>(src, l, sg.n, sg.res, c, sums);
    over_chunks(sg.res, [&](int lo, int hi) {
      if (l.active) visit_tile<T, VEC, 2>(tiles, l, lo, hi, c, sums);
    });
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sa[v] += ia[v];
      sb[v] += ib[v];
    }
    block_sums<VEC>(l, c, sa, sb, part + seg * pstride,
                    whole ? gamma : nullptr, part2 + seg * 2, sh_a, sh_b);
  }
  grid.sync();

  const int warp = threadIdx.x / 32;
  const bool lead = (threadIdx.x & 31) == 0;
  if (!whole) {
    for (int it = blockIdx.x * kWarps + warp; it < nb * c;
         it += gridDim.x * kWarps) {
      const int b = it / c, ch = it % c;
      float a, bb;
      warp_sums(part + static_cast<size_t>(b) * splits * pstride + ch,
                pstride, c, splits, a, bb);
      if (lead) {
        const float r = stats[static_cast<size_t>(b) * 3 * c + c + ch];
        const float k1 = r * (gamma ? gamma[b * gs + ch] : 1.f);
        float* k = bcoef + static_cast<size_t>(b) * 3 * c;
        k[ch] = k1;
        k[c + ch] = -k1 * a / hw;
        k[2 * c + ch] = -k1 * bb / hw;
        if (red) {
          red[static_cast<size_t>(b) * 2 * c + ch] = a;
          red[static_cast<size_t>(b) * 2 * c + c + ch] = bb;
        }
      }
    }
    grid.sync();
  } else {
    for (int ch = blockIdx.x * kWarps + warp; ch < c;
         ch += gridDim.x * kWarps) {
      float ta = 0.f, tb = 0.f;
      for (int b = 0; b < nb; ++b) {
        float a, bb;
        warp_sums(part + static_cast<size_t>(b) * splits * pstride + ch,
                  pstride, c, splits, a, bb);
        ta += a;
        tb += bb;
      }
      if (lead) {
        dbeta[ch] = ta;
        dgamma[ch] = tb;
      }
    }
  }

  for (int seg = blockIdx.x; seg < nseg; seg += gridDim.x) {
    const Segment sg(seg, splits, rows, hw, res_rows);
    const size_t at = sg.at(hw, c);
    const ChannelParams<VEC> cp(stats, gamma, gs, beta, bs, sg.b, c, ch0);
    float k1[VEC], k2[VEC], k3[VEC];
    if (whole) {
      __syncthreads();  // sh's previous use is done
      if (threadIdx.x < 32) {  // one warp sums, the block shares it
        float s1, s2;
        warp_sums(part2 + static_cast<size_t>(sg.b) * splits * 2, 2, 1,
                  splits, s1, s2);
        if (threadIdx.x == 0) {
          sh[0] = s1;
          sh[1] = s2;
        }
      }
      __syncthreads();
      const float* st = stats + static_cast<size_t>(sg.b) * 3 * c;
      const float r = st[c];       // 1 / (std + eps), the same for every c
      const float sd = st[2 * c];  // std
      const float n = static_cast<float>(hw) * static_cast<float>(c);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        k1[v] = cp.ga[v] * r;
        k2[v] = -sh[0] * r / n;
        k3[v] = -sh[1] / ((n - 1.f) * sd);
      }
    } else {
      stage(bcoef + static_cast<size_t>(sg.b) * 3 * c, sh, 3 * c);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        k1[v] = sh[ch0 + v];
        k2[v] = sh[c + ch0 + v];
        k3[v] = sh[2 * c + ch0 + v];
      }
    }
    T* out = dx + at + ch0;
    auto apply = [&](const P (&p)[2], int r) {
      P q;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xh = (to_float(p[0].v[v]) - cp.mu[v]) * cp.r[v];
        float g = to_float(p[1].v[v]);
        if (relu && !(xh * cp.ga[v] + cp.be[v] > 0.f)) g = 0.f;
        q.v[v] = from_float<T>(k1[v] * g + k2[v] + k3[v] * xh);
      }
      *reinterpret_cast<P*>(out + static_cast<size_t>(r) * c) = q;
    };
    const T* const src[2] = {x + at + ch0, dy + at + ch0};
    if (l.active) {
      visit_tile<T, VEC, 2>(tiles, l, 0, sg.res, c, apply);
      visit_global<T, VEC, 2, true>(src, l, sg.n, sg.res, c, apply);
    }
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
  int cluster, smem;  // cluster design: blocks per cluster, dynamic smem
  int res_rows, blocks;  // grid design: rows kept on chip, blocks
  int* active;        // occupancy query: clusters (blocks an SM) at once
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

// Lets a kernel take kMaxDynamicSmem of dynamic shared memory and, for a
// cluster kernel, clusters of up to 16 blocks, once per kernel and device
// (the kernel is a template argument, so that each kernel has its own
// flags).
template <auto kernel, bool kCluster>
cudaError_t allow_kernel() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxDynamicSmem);
  if (kCluster && e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

// Grid (groups x K, B) of 256 threads in clusters of K blocks along x.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  ClusterLaunch(const Args& a, int cg_channels) {
    const int groups = (a.c + cg_channels - 1) / cg_channels;
    cfg.gridDim = dim3(groups * a.cluster, a.b);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = a.smem;
    cfg.stream = a.stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T, auto kernel, typename... A>
cudaError_t launch_cluster(const Args& a, A... args) {
  if (a.cluster < 1 || a.cluster > kMaxCluster || a.smem > kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_kernel<kernel, true>();
  if (e != cudaSuccess) return e;
  const ClusterLaunch l(a, Share<T, 1>::kCg);
  e = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

struct ClusterForward {
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    return launch_cluster<T, norm_cluster_fwd<T, VEC>>(
        a, static_cast<const T*>(a.x), static_cast<T*>(a.y), a.stats, a.gamma,
        a.gs, a.beta, a.bs, a.hw, a.c, a.rows, a.relu, a.eps);
  }
};

struct ClusterBackward {
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    return launch_cluster<T, norm_cluster_bwd<T, VEC>>(
        a, static_cast<const T*>(a.x),
        static_cast<const T*>(a.dy), static_cast<T*>(a.y),
        static_cast<const float*>(a.stats), a.gamma, a.gs, a.beta, a.bs,
        a.red, a.hw, a.c, a.rows, a.relu);
  }
};

// How many clusters of the forward (whole = 0) or backward (whole = 1)
// kernel fit on the card at once: cudaOccupancyMaxActiveClusters.
struct ClusterOccupancy {
  template <typename T, auto kernel>
  static cudaError_t query(const Args& a) {
    cudaError_t e = allow_kernel<kernel, true>();
    if (e != cudaSuccess) return e;
    const ClusterLaunch l(a, Share<T, 1>::kCg);
    return cudaOccupancyMaxActiveClusters(
        a.active, reinterpret_cast<const void*>(kernel), &l.cfg);
  }
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    return a.whole ? query<T, norm_cluster_bwd<T, VEC>>(a)
                   : query<T, norm_cluster_fwd<T, VEC>>(a);
  }
};

// Grid (blocks) of 256 threads, launched cooperatively: the launch is
// refused (cudaErrorCooperativeLaunchTooLarge) unless every block can be
// resident at once, so a grid barrier can never wait on a block that has
// not started.
struct GridLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  explicit GridLaunch(const Args& a) {
    cfg.gridDim = dim3(a.blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = a.smem;
    cfg.stream = a.stream;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <auto kernel, typename... A>
cudaError_t launch_grid(const Args& a, A... args) {
  if (a.blocks < 1 || a.smem < 0 || a.smem > kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_kernel<kernel, false>();
  if (e != cudaSuccess) return e;
  const GridLaunch l(a);
  e = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

struct GridForward {
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    return launch_grid<norm_grid_fwd<T, VEC>>(
        a, static_cast<const T*>(a.x), static_cast<T*>(a.y), a.part, a.coef,
        a.stats, a.gamma, a.gs, a.beta, a.bs, a.b, a.hw, a.c, a.splits,
        a.rows, a.res_rows, a.whole, a.relu, a.eps);
  }
};

struct GridBackward {
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    return launch_grid<norm_grid_bwd<T, VEC>>(
        a, static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
        static_cast<T*>(a.y), static_cast<const float*>(a.stats), a.gamma,
        a.gs, a.beta, a.bs, a.part, a.red, a.coef, a.dgamma, a.dbeta, a.b,
        a.hw, a.c, a.splits, a.rows, a.res_rows, a.whole, a.relu);
  }
};

// How many blocks of the grid forward (whole = 0) or backward (whole = 1)
// kernel with smem bytes of dynamic shared memory one SM holds at once.
struct GridOccupancy {
  template <auto kernel>
  static cudaError_t query(const Args& a) {
    cudaError_t e = allow_kernel<kernel, false>();
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.active, reinterpret_cast<const void*>(kernel), kThreads, a.smem);
  }
  template <typename T, int VEC>
  static cudaError_t run(const Args& a) {
    return a.whole ? query<norm_grid_bwd<T, VEC>>(a)
                   : query<norm_grid_fwd<T, VEC>>(a);
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

// One IN or AdaIN (whole = 0 only) in the cluster design: one launch,
// grid (ceil(C / group) x cluster, B), rows per block, smem bytes of
// dynamic shared memory per block (rows x group x itemsize). Writes y and
// stats as munit_norm_forward does. Returns the launch's error.
extern "C" int munit_norm_cluster_forward(const void* x, void* y, void* stats,
                                          const void* gamma, long long gs,
                                          const void* beta, long long bs,
                                          int b, int hw, int c, int cluster,
                                          int rows, int smem, int is_bf16,
                                          int vec, int relu, float eps,
                                          void* stream) {
  Args a{};
  a.x = x;
  a.y = y;
  a.stats = static_cast<float*>(stats);
  a.gamma = static_cast<const float*>(gamma);
  a.gs = gs;
  a.beta = static_cast<const float*>(beta);
  a.bs = bs;
  a.b = b; a.hw = hw; a.c = c; a.cluster = cluster; a.rows = rows;
  a.smem = smem; a.relu = relu; a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<ClusterForward>(a, is_bf16, vec);
}

// Its gradient in one launch (smem: two tiles, x and dy): dx, and with red
// (f32 (B, 2, C), null for IN) A = dbeta and B = dgamma per (sample,
// channel), as munit_norm_backward writes them.
extern "C" int munit_norm_cluster_backward(const void* x, const void* dy,
                                           void* dx, const void* stats,
                                           const void* gamma, long long gs,
                                           const void* beta, long long bs,
                                           void* red, int b, int hw, int c,
                                           int cluster, int rows, int smem,
                                           int is_bf16, int vec, int relu,
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
  a.red = static_cast<float*>(red);
  a.b = b; a.hw = hw; a.c = c; a.cluster = cluster; a.rows = rows;
  a.smem = smem; a.relu = relu;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<ClusterBackward>(a, is_bf16, vec);
}

// Into *active: how many clusters of the cluster forward (backward = 0) or
// backward (1) at this launch shape the card holds at once.
extern "C" int munit_norm_cluster_occupancy(int backward, int b, int c,
                                            int cluster, int smem,
                                            int is_bf16, int vec,
                                            int* active) {
  Args a{};
  a.whole = backward;
  a.b = b; a.c = c; a.cluster = cluster; a.smem = smem;
  a.active = active;
  return dispatch<ClusterOccupancy>(a, is_bf16, vec);
}

// One normalization in the grid design: one cooperative launch of blocks
// blocks (all resident at once), splits segments of rows rows per sample,
// the first res_rows rows of each block's first segment kept on chip (smem
// bytes: res_rows x C x itemsize). part: f32 scratch (B, splits, 2, C), or
// (B, splits, 2) when whole; coef: f32 scratch (B, 3, C) (unused when
// whole). Writes y and stats as munit_norm_forward does.
extern "C" int munit_norm_grid_forward(const void* x, void* y, void* part,
                                       void* coef, void* stats,
                                       const void* gamma, long long gs,
                                       const void* beta, long long bs, int b,
                                       int hw, int c, int splits, int rows,
                                       int res_rows, int blocks, int smem,
                                       int is_bf16, int vec, int whole,
                                       int relu, float eps, void* stream) {
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
  a.res_rows = res_rows; a.blocks = blocks; a.smem = smem;
  a.whole = whole; a.relu = relu; a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<GridForward>(a, is_bf16, vec);
}

// Its gradient in one cooperative launch (smem: two tiles, x and dy, of
// res_rows rows each). part: f32 scratch (B, splits, 2, C + 1); bcoef: f32
// scratch (B, 3, C) (unused when whole); red: null or f32 (B, 2, C), A =
// dbeta and B = dgamma per (sample, channel) (not whole); whole also
// writes dgamma, dbeta (C) summed over the batch.
extern "C" int munit_norm_grid_backward(const void* x, const void* dy,
                                        void* dx, const void* stats,
                                        const void* gamma, long long gs,
                                        const void* beta, long long bs,
                                        void* part, void* red, void* bcoef,
                                        void* dgamma, void* dbeta, int b,
                                        int hw, int c, int splits, int rows,
                                        int res_rows, int blocks, int smem,
                                        int is_bf16, int vec, int whole,
                                        int relu, void* stream) {
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
  a.res_rows = res_rows; a.blocks = blocks; a.smem = smem;
  a.whole = whole; a.relu = relu;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<GridBackward>(a, is_bf16, vec);
}

// Into *per_sm: how many blocks of the grid forward (backward = 0) or
// backward (1) kernel with smem bytes of dynamic shared memory one SM
// holds at once.
extern "C" int munit_norm_grid_occupancy(int backward, int smem, int is_bf16,
                                         int vec, int* per_sm) {
  Args a{};
  a.whole = backward;
  a.smem = smem;
  a.active = per_sm;
  return dispatch<GridOccupancy>(a, is_bf16, vec);
}

extern "C" const char* munit_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
