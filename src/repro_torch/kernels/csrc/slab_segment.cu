// slab_segment: the sparse (edge-list) consensus round on the packed (K, D)
// slab, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/slab_segment.py:
//   slab_edge_encode_combine  (one round reading the compact wire: in-kernel
//                              decode, per-edge stats, the edge factors of
//                              eqs. 12-14, the per-destination CSR combine),
//   slab_edge_combine         (the same round over a decoded f32 slab, with
//                              the scatter-by-destination combine).
//
// The TPU kernels are one launch: their grid runs in order and carries the
// stats n2 (L, K) and d2e (L, E) in VMEM from phase 0 to phase 1.  CUDA
// blocks run in no order, so a DRT round here is a split reduction in four
// launches, each fixed in its order of summation (no atomics anywhere: two
// runs give the same bits):
//
//   1. stats_partial   one block per 128-column block: the block's decoded
//                      wire (shared memory only) and its partial squared norms
//                      of every agent and squared distances of every edge
//                      -> partial (n_blocks, K + E);
//   2. layer_reduce    per (layer, 32 entries): the layer's partials in a
//                      fixed order -> stats (L, K + E);
//   3. edge_factors    one block per layer: eqs. 12-14 on the edge list
//                      (repro_torch.core.drt.drt_edge_mixing), each per-column
//                      reduction a loop over the edge list in list order
//                      -> A_self (L, K), A_e (L, E).  log_prod sums over ALL
//                      layers, so each block reads all of stats (a few KB);
//   4. combine         one block per 128-column block: the decoded wire again
//                      and either the CSR combine (slab_edge_encode_combine)
//                      or the scatter combine (slab_edge_combine).
//
// A classical round needs no stats: launch 3 computes the Metropolis edge
// factors (D-free edge algebra, a tiny launch), then the combine: two
// launches.  The decoded wire is rebuilt in each pass that reads it and never
// reaches device memory: int8 is q * scale (one rounded multiply, as the
// port's slab_decode), bf16/f16 an exact upcast, exact/sent the f32 values.
//
// The combines spell every step with _rn intrinsics in the reference's
// order (self term first, then one rounded product and one rounded sum per
// CSR slot or per edge), so for the same factors the exact and sent modes
// match the plain PyTorch version bit for bit.
//
// Bound: device memory.  A DRT round reads the wire twice (stats and combine
// passes) and the self slab and the output once each; the stats take
// ~3 (K + E) flops per column and the combine ~2 (Kl + Dmax Kl), a few flops
// per byte.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;          // column-block width (SlabLayout.lane)
constexpr int kMaxAgents = 64;       // largest K the kernels take
constexpr int kMaxEdges = kMaxAgents * kMaxAgents;
constexpr int kPadRow = kLanes + 1;  // shared-memory row stride: no bank conflicts
constexpr float kNeg = -1e30f;       // the reference's non-edge sentinel
constexpr int kReduceWarps = 8;
constexpr int kFactorThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

enum WireMode : int {
  kF32 = 0,   // exact / sent: the f32 slab itself
  kInt8 = 1,  // q (int8) * scales[agent, col_seg[c]]
  kBf16 = 2,
  kF16 = 3,
};

struct EdgeWire {
  int mode;
  const void* data;         // (K, D) f32 | int8 | bf16 | f16
  const float* scales;      // kInt8: (K, n_segs)
  const int32_t* col_seg;   // kInt8: (D,) scale segment of each column
  int n_segs;
};

// The decoded f32 view of agent a's element at column c (seg = col_seg[c]
// for int8, loaded once per column).
__device__ __forceinline__ float decode(const EdgeWire& w, int a, int64_t c, int64_t D,
                                        int32_t seg) {
  const int64_t i = static_cast<int64_t>(a) * D + c;
  switch (w.mode) {
    case kInt8:
      return __fmul_rn(static_cast<float>(static_cast<const int8_t*>(w.data)[i]),
                       w.scales[a * w.n_segs + seg]);
    case kBf16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(w.data)[i]);
    case kF16:
      return __half2float(static_cast<const __half*>(w.data)[i]);
    default:
      return static_cast<const float*>(w.data)[i];
  }
}

// Stage the decoded wire of every agent at this thread's column into
// dec[a * stride + threadIdx.x].
__device__ __forceinline__ void stage_wire(const EdgeWire& w, float* dec, int stride, int K,
                                           int64_t c, int64_t D) {
  const int32_t seg = w.mode == kInt8 ? w.col_seg[c] : 0;
  for (int a = 0; a < K; ++a) dec[a * stride + threadIdx.x] = decode(w, a, c, D, seg);
}

__global__ void __launch_bounds__(kLanes)
stats_partial_kernel(EdgeWire w, const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                     float* __restrict__ partial, int K, int E, int64_t D) {
  extern __shared__ float dec[];  // dec[a * kPadRow + t]
  const int t = threadIdx.x;
  stage_wire(w, dec, kPadRow, K, static_cast<int64_t>(blockIdx.x) * kLanes + t, D);
  __syncthreads();
  const int width = K + E;
  float* pb = partial + static_cast<int64_t>(blockIdx.x) * width;
  for (int i = t; i < width; i += kLanes) {
    float acc = 0.0f;
    if (i < K) {
      const float* x = dec + i * kPadRow;
      for (int s = 0; s < kLanes; ++s) acc = fmaf(x[s], x[s], acc);
    } else {
      const float* xs = dec + src[i - K] * kPadRow;
      const float* xd = dec + dst[i - K] * kPadRow;
      for (int s = 0; s < kLanes; ++s) {
        const float d = __fsub_rn(xs[s], xd[s]);
        acc = fmaf(d, d, acc);
      }
    }
    pb[i] = acc;
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
                    float* __restrict__ stats, int width, int n_blocks) {
  __shared__ float part[kReduceWarps][32];
  const int p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.y * 32 + lane;
  const int b0 = first_block_of(block_layer, n_blocks, p);
  const int b1 = first_block_of(block_layer, n_blocks, p + 1);
  float acc = 0.0f;
  if (i < width)
    for (int b = b0 + warp; b < b1; b += kReduceWarps)
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(b) * width + i]);
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && i < width) {
    float s = 0.0f;
    for (int j = 0; j < kReduceWarps; ++j) s = __fadd_rn(s, part[j][lane]);
    stats[static_cast<int64_t>(p) * width + i] = s;
  }
}

// The edge factors of layer blockIdx.x.  DRT (stats != null): eqs. 12-14 as
// repro_torch.core.drt.drt_edge_mixing computes them; classical: the
// Metropolis edge weights of repro_torch.core.dynamic.metropolis_edge_weights
// (the same for every layer).  Per-destination reductions walk the edge list
// in list order, as the reference's scatter-adds do.
__global__ void __launch_bounds__(kFactorThreads)
edge_factors_kernel(const float* __restrict__ stats, const int32_t* __restrict__ src,
                    const int32_t* __restrict__ dst, const float* __restrict__ w,
                    float* __restrict__ A_self, float* __restrict__ A_e, int K, int E, int L,
                    float kappa, float log_n, float log_2_l1, int exact_grad) {
  extern __shared__ float smem[];
  float* la = smem;           // la[e]: log a~ (DRT) or m_e (classical)
  float* cap = smem + E;      // per agent: log N + the column's smallest log a~, or its degree
  float* shift = cap + K;     // per agent: the normalizing shift m
  float* colsum = shift + K;  // per agent: the column sum
  const int p = blockIdx.x;
  const int width = K + E;

  if (stats == nullptr) {  // classical
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float deg = 1.0f;
      for (int e = 0; e < E; ++e)
        if (dst[e] == k) deg = __fadd_rn(deg, w[e] > 0.0f ? 1.0f : 0.0f);
      cap[k] = deg;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      la[e] = w[e] > 0.0f ? __fdiv_rn(1.0f, fmaxf(cap[src[e]], cap[dst[e]])) : 0.0f;
      A_e[static_cast<int64_t>(p) * E + e] = la[e];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float s = 0.0f;
      for (int e = 0; e < E; ++e)
        if (dst[e] == k) s = __fadd_rn(s, la[e]);
      A_self[p * K + k] = __fsub_rn(1.0f, s);
    }
    return;
  }

  // eq. 14 per edge, against the SOURCE agent's layer norms
  const float* sp = stats + static_cast<int64_t>(p) * width;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    if (!(w[e] > 0.0f)) {
      la[e] = kNeg;
      continue;
    }
    const int s = src[e];
    float log_prod = 0.0f;
    for (int q = 0; q < L; ++q) {
      const float* sq = stats + static_cast<int64_t>(q) * width;
      log_prod = __fadd_rn(log_prod, log1pf(__fdiv_rn(sq[K + e], __fadd_rn(sq[s], kappa))));
    }
    log_prod = __fadd_rn(log_prod, log_2_l1);
    const float d2 = sp[K + e];
    const float log_denom = exact_grad ? logf(__fadd_rn(__fadd_rn(sp[s], kappa), d2))
                                       : logf(__fadd_rn(d2, kappa));
    la[e] = __fadd_rn(__fsub_rn(log_prod, log_denom), logf(w[e]));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    // eq. 13: clip at N x the column's smallest edge weight
    float log_min = -kNeg;
    int n = 0;
    for (int e = 0; e < E; ++e)
      if (dst[e] == k && w[e] > 0.0f) {
        log_min = fminf(log_min, la[e]);
        ++n;
      }
    const float c = __fadd_rn(log_n, log_min);
    // self weight: c_kk / (n_k - 1) x the sum of the clipped in-edges (a
    // two-pass segment logsumexp)
    float m1 = kNeg;
    for (int e = 0; e < E; ++e)
      if (dst[e] == k && w[e] > 0.0f) m1 = fmaxf(m1, fminf(la[e], c));
    float sumexp = 0.0f;
    for (int e = 0; e < E; ++e)
      if (dst[e] == k && w[e] > 0.0f) sumexp = __fadd_rn(sumexp, expf(__fsub_rn(fminf(la[e], c), m1)));
    const float log_sum = sumexp > 0.0f ? __fadd_rn(m1, logf(fmaxf(sumexp, 1e-30f))) : kNeg;
    const float log_self = __fadd_rn(-logf(fmaxf(static_cast<float>(n), 1.0f)), log_sum);
    // eq. 12: shifted exponentials over {self} u {in-edges}
    const float m = fmaxf(log_self, m1);
    const float a_self = expf(__fsub_rn(log_self, m));
    float s = 0.0f;
    for (int e = 0; e < E; ++e)
      if (dst[e] == k && w[e] > 0.0f) s = __fadd_rn(s, expf(__fsub_rn(fminf(la[e], c), m)));
    const float total = __fadd_rn(a_self, s);
    A_self[p * K + k] = __fdiv_rn(a_self, total);
    cap[k] = c;
    shift[k] = m;
    colsum[k] = total;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float a = 0.0f;
    if (w[e] > 0.0f) {
      const int k = dst[e];
      a = __fdiv_rn(expf(__fsub_rn(fminf(la[e], cap[k]), shift[k])), colsum[k]);
    }
    A_e[static_cast<int64_t>(p) * E + e] = a;
  }
}

// out[k] = A_self[p, base + k] self[k] + sum_j a_csr[k, j] dec[nbr[k, j]],
// a_csr = valid ? A_e[p, pos] : 0, slot by slot.
__global__ void __launch_bounds__(kLanes)
csr_combine_kernel(EdgeWire w, const float* __restrict__ self,
                   const int32_t* __restrict__ block_layer, const float* __restrict__ A_self,
                   const float* __restrict__ A_e, const int32_t* __restrict__ nbr,
                   const int32_t* __restrict__ pos, const int32_t* __restrict__ valid, int base,
                   float* __restrict__ out, int K, int Kl, int E, int dmax, int64_t D) {
  extern __shared__ float smem[];
  float* dec = smem;                    // dec[a * kLanes + t]
  float* a_self = dec + K * kLanes;     // (Kl,)
  float* a_csr = a_self + Kl;           // (Kl, dmax)
  int* nbr_s = reinterpret_cast<int*>(a_csr + Kl * dmax);  // (Kl, dmax)
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int p = block_layer[b];
  for (int i = t; i < Kl; i += kLanes) a_self[i] = A_self[p * K + base + i];
  for (int i = t; i < Kl * dmax; i += kLanes) {
    a_csr[i] = valid[i] ? A_e[static_cast<int64_t>(p) * E + pos[i]] : 0.0f;
    nbr_s[i] = nbr[i];
  }
  const int64_t c = static_cast<int64_t>(b) * kLanes + t;
  stage_wire(w, dec, kLanes, K, c, D);
  __syncthreads();
  for (int k = 0; k < Kl; ++k) {
    float acc = __fmul_rn(self[k * D + c], a_self[k]);
    for (int j = 0; j < dmax; ++j) {
      const int i = k * dmax + j;
      acc = __fadd_rn(acc, __fmul_rn(a_csr[i], dec[nbr_s[i] * kLanes + t]));
    }
    out[k * D + c] = acc;
  }
}

// out[k] = A_self[p, k] self[k] + sum_{e: dst[e] = k} A_e[p, e] dec[src[e]],
// walking the edges in list order with the K outputs in shared memory.
__global__ void __launch_bounds__(kLanes)
scatter_combine_kernel(const float* __restrict__ self, const float* __restrict__ dec_slab,
                       const int32_t* __restrict__ block_layer, const float* __restrict__ A_self,
                       const float* __restrict__ A_e, const int32_t* __restrict__ src,
                       const int32_t* __restrict__ dst, float* __restrict__ out, int K, int E,
                       int64_t D) {
  extern __shared__ float smem[];
  float* dec = smem;               // dec[a * kLanes + t]
  float* acc = dec + K * kLanes;   // acc[k * kLanes + t]
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int p = block_layer[b];
  const int64_t c = static_cast<int64_t>(b) * kLanes + t;
  for (int a = 0; a < K; ++a) {
    dec[a * kLanes + t] = dec_slab[a * D + c];
    acc[a * kLanes + t] = __fmul_rn(self[a * D + c], A_self[p * K + a]);
  }
  // each thread touches only its own column: no synchronisation needed
  const float* ae = A_e + static_cast<int64_t>(p) * E;
  for (int e = 0; e < E; ++e) {
    float* o = acc + dst[e] * kLanes + t;
    *o = __fadd_rn(*o, __fmul_rn(ae[e], dec[src[e] * kLanes + t]));
  }
  for (int a = 0; a < K; ++a) out[a * D + c] = acc[a * kLanes + t];
}

EdgeWire make_wire(int mode, const void* data, const void* scales, const void* col_seg,
                   int n_segs) {
  EdgeWire w;
  w.mode = mode;
  w.data = data;
  w.scales = static_cast<const float*>(scales);
  w.col_seg = static_cast<const int32_t*>(col_seg);
  w.n_segs = n_segs;
  return w;
}

bool bad_shape(int K, int E, int n_blocks) {
  return K < 1 || K > kMaxAgents || E < 1 || E > kMaxEdges || n_blocks < 1;
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Every entry point launches on `stream` (a cudaStream_t), does not
// synchronise, allocates nothing, and returns cudaGetLastError(): 0 when the
// launch was accepted.  Wire pointers a mode does not read may be null.

extern "C" int seg_stats_partial(int mode, const void* wire, const void* scales,
                                 const void* col_seg, int n_segs, const void* src,
                                 const void* dst, void* partial, int K, int E, int n_blocks,
                                 void* stream) {
  if (bad_shape(K, E, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const EdgeWire w = make_wire(mode, wire, scales, col_seg, n_segs);
  const size_t smem = static_cast<size_t>(K) * kPadRow * sizeof(float);
  stats_partial_kernel<<<n_blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<float*>(partial), K, E, static_cast<int64_t>(n_blocks) * kLanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seg_layer_reduce(const void* partial, const void* block_layer, void* stats,
                                int width, int n_blocks, int L, void* stream) {
  if (width < 1 || n_blocks < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(L, (width + 31) / 32);
  layer_reduce_kernel<<<grid, 32 * kReduceWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<const int32_t*>(block_layer),
      static_cast<float*>(stats), width, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// stats (L, K + E) for DRT; null for classical.
extern "C" int seg_edge_factors(const void* stats, const void* src, const void* dst,
                                const void* w, void* A_self, void* A_e, int K, int E, int L,
                                float kappa, float log_n, float log_2_l1, int exact_grad, int drt,
                                void* stream) {
  if (bad_shape(K, E, 1) || L < 1 || (drt != 0) != (stats != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(E + 3 * K) * sizeof(float);
  edge_factors_kernel<<<L, kFactorThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stats), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), static_cast<const float*>(w),
      static_cast<float*>(A_self), static_cast<float*>(A_e), K, E, L, kappa, log_n, log_2_l1,
      exact_grad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seg_csr_combine(int mode, const void* wire, const void* scales,
                               const void* col_seg, int n_segs, const void* self,
                               const void* block_layer, const void* A_self, const void* A_e,
                               const void* nbr, const void* pos, const void* valid, int dst_base,
                               void* out, int K, int K_local, int E, int dmax, int n_blocks,
                               void* stream) {
  if (bad_shape(K, E, n_blocks) || K_local < 1 || dst_base < 0 || dst_base + K_local > K ||
      dmax < 1 || dmax > kMaxAgents)
    return static_cast<int>(cudaErrorInvalidValue);
  const EdgeWire w = make_wire(mode, wire, scales, col_seg, n_segs);
  const size_t smem = static_cast<size_t>(K * kLanes + K_local + 2 * K_local * dmax) * 4;
  const cudaError_t attr = allow_smem(csr_combine_kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  csr_combine_kernel<<<n_blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float*>(self), static_cast<const int32_t*>(block_layer),
      static_cast<const float*>(A_self), static_cast<const float*>(A_e),
      static_cast<const int32_t*>(nbr), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(valid), dst_base, static_cast<float*>(out), K, K_local, E,
      dmax, static_cast<int64_t>(n_blocks) * kLanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seg_scatter_combine(const void* self, const void* dec, const void* block_layer,
                                   const void* A_self, const void* A_e, const void* src,
                                   const void* dst, void* out, int K, int E, int n_blocks,
                                   void* stream) {
  if (bad_shape(K, E, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2 * K * kLanes) * sizeof(float);
  const cudaError_t attr = allow_smem(scatter_combine_kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  scatter_combine_kernel<<<n_blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(self), static_cast<const float*>(dec),
      static_cast<const int32_t*>(block_layer), static_cast<const float*>(A_self),
      static_cast<const float*>(A_e), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), static_cast<float*>(out), K, E,
      static_cast<int64_t>(n_blocks) * kLanes);
  return static_cast<int>(cudaGetLastError());
}
