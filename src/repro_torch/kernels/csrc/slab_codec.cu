// slab_codec: the coded consensus round on the packed (K, D) slab, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/slab_codec.py:
//   slab_encode_combine  (one coded round: wire view, per-layer Gram, DRT
//                         eqs. 12-14, off-diagonal combine of the wire view
//                         plus the full-precision self term), and
//   slab_quant_encode    (the int8 encode: f32 slab in, int8 wire out).
//
// The TPU kernel is one launch because its grid runs in order: a VMEM scratch
// carries the Gram from the first phase to the second.  CUDA blocks run in no
// order, so a DRT round here is a split reduction in four launches, each
// fixed in its order of summation (no atomics: two runs give the same bits):
//
//   1. gram_partial   one block per 128-column block: the block's wire view
//                     (in shared memory, never in device memory) and its
//                     partial (K, K) Gram -> partial (n_blocks, K, K);
//   2. layer_reduce   per (layer, 32 Gram entries): the layer's partials in a
//                     fixed order -> G (L, K, K);
//   3. drt_mix        one block per layer: eqs. 12-14 on G -> A (L, K, K);
//                     log_prod sums over ALL layers, so each block reads all
//                     of G (L K^2 floats, a few KB);
//   4. combine        one block per 128-column block: the wire view again and
//                     out = A_off^T dec + diag(A) x.
//
// A classical round needs no Gram: one combine launch with the Metropolis
// matrix.  Every mode's wire view, the int8 counter hash included, is
// recomputed in-kernel in each pass that reads it (launches 1 and 4 of a DRT
// round); the wire never reaches device memory.  slab_quant_encode runs the
// same wire_view.cuh encode and writes the int8 wire out: it is the bit-parity
// probe of the in-kernel wire.
//
// Bound: device memory.  A DRT round reads the f32 slab twice (phases 1 and
// 4) and writes it once; the Gram (2 K^2 flops per column) and combine
// (2 K^2) come to ~4 flops per byte at K = 16, far below the card's f32
// ratio.  The partials are n_blocks K^2 floats (2.5 MB at the main shape).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_view.cuh"

using namespace slab_wire;

namespace {

constexpr int kPadRow = kLanes + 1;  // shared-memory row stride: no bank conflicts
constexpr float kNeg = -1e30f;       // the reference's non-edge sentinel
constexpr int kReduceWarps = 8;

__device__ __forceinline__ bool needs_x(int mode) { return mode != kSent; }

__global__ void __launch_bounds__(kLanes)
quant_encode_kernel(Wire w, const float* __restrict__ slab, int8_t* __restrict__ q, int K,
                    int64_t D) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const Column col = load_column(w, c);
  for (int a = 0; a < K; ++a) {
    float s;
    const float v = int8_encode(w, col, a, slab[a * D + c], &s);
    q[a * D + c] = static_cast<int8_t>(__float2int_rn(v));
  }
}

__global__ void __launch_bounds__(kLanes)
gram_partial_kernel(Wire w, const float* __restrict__ slab, float* __restrict__ partial, int K,
                    int64_t D) {
  extern __shared__ float dec[];  // dec[a * kPadRow + t]
  const int t = threadIdx.x;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kLanes + t;
  const Column col = load_column(w, c);
  const bool use_x = needs_x(w.mode);
  for (int a = 0; a < K; ++a)
    dec[a * kPadRow + t] = wire_view(w, col, a, D, use_x ? slab[a * D + c] : 0.0f);
  __syncthreads();
  const int KK = K * K;
  float* pb = partial + static_cast<int64_t>(blockIdx.x) * KK;
  for (int e = t; e < KK; e += kLanes) {
    const float* di = dec + (e / K) * kPadRow;
    const float* dj = dec + (e % K) * kPadRow;
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < kLanes; ++s) acc = fmaf(di[s], dj[s], acc);
    pb[e] = acc;
  }
}

// first block b with block_layer[b] >= p (block_layer is non-decreasing)
__device__ __forceinline__ int first_block_of(const int32_t* bl, int n, int p) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (bl[mid] < p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(32 * kReduceWarps)
layer_reduce_kernel(const float* __restrict__ partial, const int32_t* __restrict__ block_layer,
                    float* __restrict__ G, int K, int n_blocks) {
  __shared__ float part[kReduceWarps][32];
  const int p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.y * 32 + lane;
  const int KK = K * K;
  const int b0 = first_block_of(block_layer, n_blocks, p);
  const int b1 = first_block_of(block_layer, n_blocks, p + 1);
  float acc = 0.0f;
  if (e < KK)
    for (int b = b0 + warp; b < b1; b += kReduceWarps)
      acc += partial[static_cast<int64_t>(b) * KK + e];
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && e < KK) {
    float s = 0.0f;
    for (int i = 0; i < kReduceWarps; ++i) s += part[i][lane];
    G[static_cast<int64_t>(p) * KK + e] = s;
  }
}

// squared distance d2[l, k] of layer Gram g (clamped at 0), as
// repro_torch.core.packing.gram_sq_dists computes it
__device__ __forceinline__ float sq_dist(const float* g, int K, int l, int k) {
  const float d2 = __fsub_rn(__fadd_rn(g[l * K + l], g[k * K + k]), __fmul_rn(2.0f, g[l * K + k]));
  return fmaxf(d2, 0.0f);
}

// Eqs. 12-14 (repro_torch/core/drt.py, in log space) for layer blockIdx.x.
__global__ void drt_mix_kernel(const float* __restrict__ G, const float* __restrict__ C,
                               float* __restrict__ A, int K, int L, float kappa, float log_n,
                               float log_2_l1, int exact_grad) {
  extern __shared__ float la[];  // la[l * K + k]: log a~ of this layer
  const int p = blockIdx.x;
  const int KK = K * K;
  const float* gp = G + static_cast<int64_t>(p) * KK;
  for (int e = threadIdx.x; e < KK; e += blockDim.x) {
    const int l = e / K, k = e % K;
    const float c = C[e];
    if (l == k || !(c > 0.0f)) {
      la[e] = kNeg;
      continue;
    }
    float log_prod = 0.0f;  // sum over every layer q of log1p(d2 / (n2_l + kappa))
    for (int q = 0; q < L; ++q) {
      const float* g = G + static_cast<int64_t>(q) * KK;
      log_prod = __fadd_rn(log_prod,
                           log1pf(__fdiv_rn(sq_dist(g, K, l, k), __fadd_rn(g[l * K + l], kappa))));
    }
    const float d2 = sq_dist(gp, K, l, k);
    const float log_denom = exact_grad ? logf(__fadd_rn(__fadd_rn(gp[l * K + l], kappa), d2))
                                       : logf(__fadd_rn(d2, kappa));
    la[e] = __fadd_rn(__fsub_rn(__fadd_rn(log_prod, log_2_l1), log_denom), logf(c));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    // eq. 13: clip at N x the column's smallest edge weight
    float log_min = -kNeg;
    int n_k = 0;
    for (int l = 0; l < K; ++l) {
      const float c = C[l * K + k];
      if (c > 0.0f) ++n_k;
      if (l != k && c > 0.0f) log_min = fminf(log_min, la[l * K + k]);
    }
    const float cap = __fadd_rn(log_n, log_min);
    float mx = kNeg;
    for (int l = 0; l < K; ++l) {
      const int e = l * K + k;
      const bool edge = l != k && C[e] > 0.0f;
      la[e] = edge ? fminf(la[e], cap) : kNeg;
      mx = fmaxf(mx, la[e]);
    }
    float sum = 0.0f;
    for (int l = 0; l < K; ++l) sum = __fadd_rn(sum, expf(__fsub_rn(la[l * K + k], mx)));
    const float log_sum = __fadd_rn(logf(sum), mx);
    const float denom = fmaxf(static_cast<float>(n_k) - 1.0f, 1.0f);
    la[k * K + k] = __fadd_rn(logf(__fdiv_rn(C[k * K + k], denom)), log_sum);
    // eq. 12: normalise over the support of C
    mx = kNeg;
    for (int l = 0; l < K; ++l)
      if (C[l * K + k] > 0.0f) mx = fmaxf(mx, la[l * K + k]);
    float total = 0.0f;
    for (int l = 0; l < K; ++l) {
      const int e = l * K + k;
      la[e] = C[e] > 0.0f ? expf(__fsub_rn(la[e], mx)) : 0.0f;
      total = __fadd_rn(total, la[e]);
    }
    float* ap = A + static_cast<int64_t>(p) * KK;
    for (int l = 0; l < K; ++l) ap[l * K + k] = __fdiv_rn(la[l * K + k], total);
  }
}

__global__ void __launch_bounds__(kLanes)
combine_kernel(Wire w, const float* __restrict__ slab, const float* __restrict__ A,
               const int32_t* __restrict__ block_layer, float* __restrict__ out, int K,
               int64_t D) {
  extern __shared__ float smem[];
  float* a_s = smem;           // a_s[l * K + k]: this block's layer's mixing matrix
  float* dec = smem + K * K;   // dec[l * kLanes + t]
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* ab = A + (block_layer ? static_cast<int64_t>(block_layer[b]) * K * K : 0);
  for (int i = t; i < K * K; i += kLanes) a_s[i] = ab[i];
  const int64_t c = static_cast<int64_t>(b) * kLanes + t;
  const Column col = load_column(w, c);
  const bool use_x = needs_x(w.mode);
  for (int l = 0; l < K; ++l)
    dec[l * kLanes + t] = wire_view(w, col, l, D, use_x ? slab[l * D + c] : 0.0f);
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    float acc = 0.0f;
    for (int l = 0; l < K; ++l)
      if (l != k) acc = fmaf(a_s[l * K + k], dec[l * kLanes + t], acc);
    out[k * D + c] = __fadd_rn(acc, __fmul_rn(a_s[k * K + k], slab[k * D + c]));
  }
}

Wire make_wire(int mode, const void* scales, const void* col_seg,
               const void* col_leaf, const void* col_idx, const void* w0, const void* w1,
               const void* sent, int n_segs, int n_leaves, float qmax) {
  Wire w;
  w.mode = mode;
  w.scales = static_cast<const float*>(scales);
  w.col_seg = static_cast<const int32_t*>(col_seg);
  w.col_leaf = static_cast<const int32_t*>(col_leaf);
  w.col_idx = static_cast<const uint32_t*>(col_idx);
  w.w0 = static_cast<const uint32_t*>(w0);
  w.w1 = static_cast<const uint32_t*>(w1);
  w.sent = static_cast<const float*>(sent);
  w.n_segs = n_segs;
  w.n_leaves = n_leaves;
  w.qmax = qmax;
  return w;
}

bool bad_shape(int K, int n_blocks) { return K < 1 || K > kMaxAgents || n_blocks < 1; }

}  // namespace

// Every entry point launches on `stream` (a cudaStream_t), does not
// synchronise, allocates nothing, and returns cudaGetLastError(): 0 when the
// launch was accepted.  Wire pointers a mode does not read may be null.

extern "C" int slab_quant_encode_i8(const void* slab, const void* scales, const void* col_seg,
                                    const void* col_leaf, const void* col_idx, const void* w0,
                                    const void* w1, int n_segs, int n_leaves, float qmax,
                                    void* q, int K, int n_blocks, void* stream) {
  if (bad_shape(K, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const Wire w = make_wire(kInt8, scales, col_seg, col_leaf, col_idx, w0, w1, nullptr,
                           n_segs, n_leaves, qmax);
  quant_encode_kernel<<<n_blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float*>(slab), static_cast<int8_t*>(q), K,
      static_cast<int64_t>(n_blocks) * kLanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sec_gram_partial(int mode, const void* slab, const void* scales,
                                const void* col_seg, const void* col_leaf, const void* col_idx,
                                const void* w0, const void* w1, const void* sent, int n_segs,
                                int n_leaves, float qmax, void* partial, int K, int n_blocks,
                                void* stream) {
  if (bad_shape(K, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const Wire w = make_wire(mode, scales, col_seg, col_leaf, col_idx, w0, w1, sent, n_segs,
                           n_leaves, qmax);
  const size_t smem = static_cast<size_t>(K) * kPadRow * sizeof(float);
  gram_partial_kernel<<<n_blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float*>(slab), static_cast<float*>(partial), K,
      static_cast<int64_t>(n_blocks) * kLanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sec_layer_reduce(const void* partial, const void* block_layer, void* G, int K,
                                int n_blocks, int L, void* stream) {
  if (bad_shape(K, n_blocks) || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(L, (K * K + 31) / 32);
  layer_reduce_kernel<<<grid, 32 * kReduceWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<const int32_t*>(block_layer),
      static_cast<float*>(G), K, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sec_drt_mix(const void* G, const void* C, void* A, int K, int L, float kappa,
                           float log_n, float log_2_l1, int exact_grad, void* stream) {
  if (K < 1 || K > kMaxAgents || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(K) * K * sizeof(float);
  drt_mix_kernel<<<L, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(C), static_cast<float*>(A), K, L,
      kappa, log_n, log_2_l1, exact_grad);
  return static_cast<int>(cudaGetLastError());
}

// A is (L, K, K) indexed through block_layer, or one (K, K) matrix for every
// block when block_layer is null (the classical round).
extern "C" int sec_combine(int mode, const void* slab, const void* scales,
                           const void* col_seg, const void* col_leaf, const void* col_idx,
                           const void* w0, const void* w1, const void* sent, int n_segs,
                           int n_leaves, float qmax, const void* A, const void* block_layer,
                           void* out, int K, int n_blocks, void* stream) {
  if (bad_shape(K, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const Wire w = make_wire(mode, scales, col_seg, col_leaf, col_idx, w0, w1, sent, n_segs,
                           n_leaves, qmax);
  const size_t smem = static_cast<size_t>(K * K + K * kLanes) * sizeof(float);
  combine_kernel<<<n_blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float*>(slab), static_cast<const float*>(A),
      static_cast<const int32_t*>(block_layer), static_cast<float*>(out), K,
      static_cast<int64_t>(n_blocks) * kLanes);
  return static_cast<int>(cudaGetLastError());
}
