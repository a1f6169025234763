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
// blocks run in no order, so a DRT round here is two launches:
//
//   1. stats     one block per chunk of up to 10 column blocks of one layer
//                (the host's plan, layer_chunks.py), streamed through a ring
//                of shared-memory tiles (cp.async).  Two threads a column:
//                each decodes half the agents into the column's row of shared
//                memory, then sums in registers its agents' squared norms and
//                half the edges' squared distances.  The block sums its
//                columns in a fixed order into one partial; an integer ticket
//                per layer picks the layer's last block, which sums the
//                partials in chunk order into stats (L, K + E); a round
//                ticket picks the block that finishes the last layer, which
//                computes the edge factors of every layer (eqs. 12-14 as
//                repro_torch.core.drt.drt_edge_mixing: per (layer, edge),
//                then per (layer, destination) over its in-edges in list
//                order) -> A_self (L, K), A_e (L, E) (split_reduce.cuh).  No
//                float atomics: two runs give the same bits.
//   2. combine   the CSR combine (slab_edge_encode_combine; one 128-column
//                block a CUDA block, two columns a thread, the layer's CSR
//                factors and neighbour table in shared memory read as
//                broadcasts) or the scatter combine (slab_edge_combine).
//
// The edge list is data, so a thread cannot pick its decoded values out of a
// register array by src[e] / nbr[k, j] (a register array indexed by data
// goes to local memory): the stats and CSR kernels keep each column's
// decoded values in shared memory, one row a column, read back by that
// column's threads alone, without bank conflicts.  K <= 16 and E <= 64 (the
// paper's ring, Erdos-Renyi and hypercube at K = 16) take the register stats
// kernel; up to K = 64 and E = 4096 a kernel that stages each column block
// and gives each thread its own statistics.
//
// A classical round needs no stats: one launch computes the Metropolis edge
// factors (D-free edge algebra), then the combine: two launches.  The decoded
// wire is rebuilt in each pass that reads it and never reaches device
// memory: int8 is q * scale (one rounded multiply, as the port's
// slab_decode), bf16/f16 an exact upcast, exact/sent the f32 values.
//
// The combines spell every step with _rn intrinsics in the reference's
// order (self term first, then one rounded product and one rounded sum per
// CSR slot or per edge), so for the same factors the exact and sent modes
// match the plain PyTorch version bit for bit.
//
// Bound: device memory.  A DRT round reads the wire twice (stats and combine
// launches) and the self slab and the output once each; the stats take
// ~3 (K + E) flops per column and the combine ~2 (Kl + Dmax Kl), a few flops
// per byte.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_reduce.cuh"

using namespace split_reduce;

namespace {

constexpr int kLanes = 128;          // column-block width (SlabLayout.lane)
constexpr int kMaxAgents = 64;       // largest K the kernels take
constexpr int kMaxEdges = kMaxAgents * kMaxAgents;
constexpr int kPadRow = kLanes + 1;  // shared-memory row stride: no bank conflicts
constexpr float kNeg = -1e30f;       // the reference's non-edge sentinel
constexpr int kRegAgents = 16;       // the register stats kernel: K <= 16 ...
constexpr int kRegEdges = 64;        // ... and E <= 64
constexpr int kStatsThreads = 256;   // its block: two threads a column
constexpr int kAnyThreads = 256;     // the K <= 64, E <= 4096 stats kernel's block
constexpr int kAnyEntries = (kMaxAgents + kMaxEdges + kAnyThreads - 1) / kAnyThreads;
constexpr int kFactorThreads = 256;  // the classical factors' block
constexpr int kCombineCols = 2;      // columns a CSR-combine thread takes
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kStageFloats = 40 * 1024;  // shared memory the factors may stage into (160 KB)

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
template <int MODE>
__device__ __forceinline__ float decode_as(const EdgeWire& w, int a, int64_t c, int64_t D,
                                           int32_t seg) {
  const int64_t i = static_cast<int64_t>(a) * D + c;
  if constexpr (MODE == kInt8) {
    return __fmul_rn(static_cast<float>(static_cast<const int8_t*>(w.data)[i]),
                     w.scales[a * w.n_segs + seg]);
  } else if constexpr (MODE == kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w.data)[i]);
  } else if constexpr (MODE == kF16) {
    return __half2float(static_cast<const __half*>(w.data)[i]);
  } else {
    return static_cast<const float*>(w.data)[i];
  }
}

__device__ __forceinline__ float decode(const EdgeWire& w, int a, int64_t c, int64_t D, int32_t seg) {
  switch (w.mode) {
    case kInt8:
      return decode_as<kInt8>(w, a, c, D, seg);
    case kBf16:
      return decode_as<kBf16>(w, a, c, D, seg);
    case kF16:
      return decode_as<kF16>(w, a, c, D, seg);
    default:
      return decode_as<kF32>(w, a, c, D, seg);
  }
}

// The edge list of the round (w == 0 marks padding).
struct Edges {
  const int32_t* src;
  const int32_t* dst;
  const float* w;
  int K;
  int E;
};

// What the stats launch writes: the plan's tables, the chunk partials
// (n_chunks, K + E), stats (L, K + E: the K squared norms, then the E
// squared edge distances), the tickets (L + 1), A_self (L, K), A_e (L, E)
// and a scratch (L, E).
struct Round {
  const int32_t* chunks;
  const int32_t* layers;
  float* partial;
  float* stats;
  unsigned* tickets;
  float* A_self;
  float* A_e;
  float* la;  // (L, E) scratch of the log weights when they are not staged
  int L;
  int n_busy;
};

// Eqs. 12-14's constants: kappa, log N, (L + 1) log 2, the weight mode.
struct Factor {
  float kappa;
  float log_n;
  float log_2_l1;
  int exact_grad;
};

// Shared memory of edge_factors_all, in floats.
__host__ __device__ constexpr int factor_smem_floats(int K, int E, int L, int threads, bool staged) {
  return 2 * E + L + K + 1 + threads + (staged ? L * (K + 2 * E) : 0);
}

// The edge factors of every layer (repro_torch.core.drt.drt_edge_mixing), by
// the block that finished the last layer.  Every layer's stats (when
// `staged`) and the destinations' in-edge lists are put in shared memory
// first; each per-destination reduction walks its in-edges in edge-list
// order, as the reference's scatter-adds do.  Empty layers (no chunk) have
// zero stats.  STAGED: the stats and log weights in shared memory, else the
// stats read from device memory and the log weights kept in r.la.  smem:
// factor_smem_floats(K, E, L, blockDim.x, STAGED).
template <bool STAGED>
__device__ __forceinline__ void edge_factors_all(const Round& r, const Edges& g, const Factor& f,
                                                 float* smem) {
  const int K = g.K, E = g.E, W = K + E, L = r.L;
  float* lp = smem;                                  // (E,): eq. 14's product over layers
  int* busy = reinterpret_cast<int*>(lp + E);        // (L,): layer q has a chunk
  int* off = busy + L;                               // (K + 1,): in-edge list offsets
  int* in = off + K + 1;                             // (E,): in-edges by destination
  float* part = reinterpret_cast<float*>(in + E);    // (blockDim.x,): layer-group sums
  float* la = r.la;                                  // log a~ (L, E), in in-list order
  const float* ss = r.stats;
  if constexpr (STAGED) {
    float* st_s = part + blockDim.x;                 // stats (L, W), then log a~ (L, E)
    stage(r.stats, static_cast<int64_t>(L) * W, st_s);
    ss = st_s;
    la = st_s + L * W;
  }
  const auto st = [&](int64_t i) {
    if constexpr (STAGED) return ss[i];
    else return __ldcg(ss + i);
  };
  for (int q = threadIdx.x; q < L; q += blockDim.x) busy[q] = layer_chunks(r.layers, q).y > 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int n = 0;
#pragma unroll 8
    for (int e = 0; e < E; ++e) n += g.dst[e] == k && g.w[e] > 0.0f;
    off[k + 1] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int k = 0; k < K; ++k) off[k + 1] += off[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int n = off[k];
#pragma unroll 8
    for (int e = 0; e < E; ++e)
      if (g.dst[e] == k && g.w[e] > 0.0f) in[n++] = e;
  }
  // eq. 14's product over ALL layers, per edge, against the SOURCE's norms:
  // (edge, group of layers) per thread, then the groups in order
  const int groups = max(1, min(static_cast<int>(blockDim.x) / E, L));
  const int per = (L + groups - 1) / groups;
  for (int base = 0; base < E * groups; base += blockDim.x) {
    const int item = base + threadIdx.x;
    float s = 0.0f;
    if (item < E * groups) {
      const int e = item % E, h = item / E;
      if (g.w[e] > 0.0f)
        for (int q = h * per; q < min(L, (h + 1) * per); ++q) {
          if (!busy[q]) continue;  // log1p(0 / kappa) = 0
          const int64_t sq = static_cast<int64_t>(q) * W;
          s = __fadd_rn(s, log1pf(__fdiv_rn(st(sq + K + e), __fadd_rn(st(sq + g.src[e]), f.kappa))));
        }
    }
    part[threadIdx.x] = s;
    __syncthreads();
    if (item < E) {
      for (int h = 1; h < groups; ++h) s = __fadd_rn(s, part[threadIdx.x + h * E]);
      lp[item] = __fadd_rn(s, f.log_2_l1);
    }
    __syncthreads();
  }
  // log a~ per (layer, in-edge), destination by destination in list order;
  // padding edges' factors are 0
  const int ni = off[K];
  for (int pe = threadIdx.x; pe < L * E; pe += blockDim.x)
    if (!(g.w[pe % E] > 0.0f)) r.A_e[pe] = 0.0f;
  for (int pj = threadIdx.x; pj < L * ni; pj += blockDim.x) {
    const int p = pj / ni, e = in[pj % ni];
    const int64_t sp = static_cast<int64_t>(p) * W;
    const float d2 = busy[p] ? st(sp + K + e) : 0.0f;
    const float n2 = busy[p] ? st(sp + g.src[e]) : 0.0f;
    const float log_denom = f.exact_grad ? logf(__fadd_rn(__fadd_rn(n2, f.kappa), d2))
                                         : logf(__fadd_rn(d2, f.kappa));
    la[static_cast<int64_t>(p) * E + pj % ni] = __fadd_rn(__fsub_rn(lp[e], log_denom), logf(g.w[e]));
  }
  __syncthreads();
  // per (layer, destination), over its in-edges' contiguous log weights:
  // eq. 13's clip, the self weight, eq. 12
  for (int pk = threadIdx.x; pk < L * K; pk += blockDim.x) {
    const int p = pk / K, k = pk % K;
    float* v = la + static_cast<int64_t>(p) * E + off[k];
    const int n = off[k + 1] - off[k];
    float log_min = -kNeg, top = kNeg;
    for (int j = 0; j < n; ++j) {
      log_min = fminf(log_min, v[j]);
      top = fmaxf(top, v[j]);
    }
    const float c = __fadd_rn(f.log_n, log_min);
    const float m1 = fminf(top, c);  // the largest clipped in-edge (kNeg without one)
    // self weight: c_kk / (n_k - 1) x the sum of the clipped in-edges (a
    // two-pass segment logsumexp)
    float sumexp = 0.0f;
    for (int j = 0; j < n; ++j) {
      v[j] = fminf(v[j], c);
      sumexp = __fadd_rn(sumexp, expf(__fsub_rn(v[j], m1)));
    }
    const float log_sum = sumexp > 0.0f ? __fadd_rn(m1, logf(fmaxf(sumexp, 1e-30f))) : kNeg;
    const float log_self = __fadd_rn(-logf(fmaxf(static_cast<float>(n), 1.0f)), log_sum);
    // eq. 12: shifted exponentials over {self} u {in-edges}
    const float m = fmaxf(log_self, m1);
    const float a_self = expf(__fsub_rn(log_self, m));
    float s = 0.0f;
    for (int j = 0; j < n; ++j) {
      v[j] = expf(__fsub_rn(v[j], m));
      s = __fadd_rn(s, v[j]);
    }
    const float total = __fadd_rn(a_self, s);
    r.A_self[pk] = __fdiv_rn(a_self, total);
    float* ae = r.A_e + static_cast<int64_t>(p) * E;
    const int* ins = in + off[k];
    for (int j = 0; j < n; ++j) ae[ins[j]] = __fdiv_rn(v[j], total);
  }
}

// After a block's chunk statistics: the round's tickets, stats and factors
// (split_reduce.cuh).  value(i) (i < K + E) is the block's sum, read before
// the first ticket; smem (which may alias what value reads):
// max(blockDim.x, factor_smem_floats(K, E, L, blockDim.x, staged)) floats.
template <typename Value>
__device__ __forceinline__ void finish_chunk(const Round& r, const Edges& g, const Factor& f, Value value,
                             float* smem, bool* flag, bool staged) {
  const Chunk ch = load_chunk(r.chunks, blockIdx.x);
  const int2 lay = layer_chunks(r.layers, ch.layer);
  const int W = g.K + g.E;
  float* sp = r.stats + static_cast<int64_t>(ch.layer) * W;
  if (lay.y == 1) {
    for (int i = threadIdx.x; i < W; i += blockDim.x) sp[i] = value(i);
  } else {
    float* part = r.partial + static_cast<int64_t>(blockIdx.x) * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) part[i] = value(i);
    if (!draw_last(&r.tickets[ch.layer], lay.y, flag)) return;
    sum_chunks(r.partial, lay.x, lay.y, W, smem, [&](int i, float s) { sp[i] = s; });
    if (threadIdx.x == 0) r.tickets[ch.layer] = 0u;
  }
  if (!draw_last(&r.tickets[r.L], r.n_busy, flag)) return;
  if (staged)
    edge_factors_all<true>(r, g, f, smem);
  else
    edge_factors_all<false>(r, g, f, smem);
  if (threadIdx.x == 0) r.tickets[r.L] = 0u;
}

template <int MODE>
__host__ __device__ constexpr int elem_bytes() { return MODE == kF32 ? 4 : MODE == kInt8 ? 1 : 2; }

// Bytes of one ring stage of the register stats kernel: KT rows of 128 wire
// elements, then for int8 the column-to-scale-segment map's row.
template <int MODE>
__host__ __device__ constexpr int edge_tile_bytes() {
  return kRegAgents * kLanes * elem_bytes<MODE>() + (MODE == kInt8 ? kLanes * 4 : 0);
}

// Agent a's decoded value at tile column t.
template <int MODE>
__device__ __forceinline__ float tile_value(const EdgeWire& w, const char* tile, int a, int t, int32_t seg) {
  const int i = a * kLanes + t;
  if constexpr (MODE == kInt8) {
    return __fmul_rn(static_cast<float>(reinterpret_cast<const int8_t*>(tile)[i]), w.scales[a * w.n_segs + seg]);
  } else if constexpr (MODE == kBf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(tile)[i]);
  } else if constexpr (MODE == kF16) {
    return __half2float(reinterpret_cast<const __half*>(tile)[i]);
  } else {
    return reinterpret_cast<const float*>(tile)[i];
  }
}

// Launch 1 for K <= 16, E <= 64: the chunk's column blocks streamed through
// the tile ring; two threads a column (the block's halves): each decodes
// half the agents into the column's row of shared memory (the edges' lookups
// index it by agent), then sums in registers its agents' squared norms and
// half the edges' squared distances.  Dynamic smem: the ring and the rows,
// then (aliased) the reduction and the factors.
template <int MODE>
__global__ void __launch_bounds__(kStatsThreads, 2)
edge_stats_kernel(EdgeWire w, Edges g, Round r, Factor f, int64_t D, int staged) {
  constexpr int KT = kRegAgents, ET = kRegEdges;
  constexpr int KH = KT / 2, EH = ET / 2;  // the agents and edges a half holds at most
  constexpr int kTile = edge_tile_bytes<MODE>();
  constexpr int kRow = kLanes + 1;         // the reduction's row
  extern __shared__ __align__(16) float dyn[];
  float* col = dyn + kStages * kTile / 4;  // col[a * kLanes + c]: column c's decoded value of agent a
  __shared__ int2 sd[ET];                  // (src, dst) * kLanes
  __shared__ int src_s[ET], dst_s[ET];
  __shared__ float w_s[ET];
  __shared__ bool flag;
  const int K = g.K, E = g.E;
  const int c = threadIdx.x % kLanes, h = threadIdx.x / kLanes;
  const int a0 = h == 0 ? 0 : (K + 1) / 2, a1 = h == 0 ? (K + 1) / 2 : K;  // this half's agents
  const int e0 = h == 0 ? 0 : (E + 1) / 2, e1 = h == 0 ? (E + 1) / 2 : E;  // and edges
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    src_s[e] = g.src[e];
    dst_s[e] = g.dst[e];
    w_s[e] = g.w[e];
    sd[e] = make_int2(g.src[e] * kLanes, g.dst[e] * kLanes);
  }
  const Chunk ch = load_chunk(r.chunks, blockIdx.x);
  float acc[KH + EH];
#pragma unroll
  for (int i = 0; i < KH + EH; ++i) acc[i] = 0.0f;
  stream_blocks(
      ch.begin, ch.end,
      [&](int st, int b) {
        char* dst = reinterpret_cast<char*>(dyn) + st * kTile;
        const int64_t c0 = static_cast<int64_t>(b) * kLanes;
        constexpr int row = kLanes * elem_bytes<MODE>();  // bytes of one agent's row
        const char* data = static_cast<const char*>(w.data);
        copy_rows(dst, K, row, [&](int a) { return data + (a * D + c0) * elem_bytes<MODE>(); });
        if constexpr (MODE == kInt8) copy_rows(dst + KT * row, 1, kLanes * 4, [&](int) { return w.col_seg + c0; });
      },
      [&](int st, int) {
        const char* tile = reinterpret_cast<const char*>(dyn) + st * kTile;
        int32_t seg = 0;
        if constexpr (MODE == kInt8) seg = reinterpret_cast<const int32_t*>(tile + KT * kLanes)[c];
#pragma unroll
        for (int i = 0; i < KH; ++i) {
          if (a0 + i >= a1) break;
          const float v = tile_value<MODE>(w, tile, a0 + i, c, seg);
          acc[i] = fmaf(v, v, acc[i]);
          col[(a0 + i) * kLanes + c] = v;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < EH; ++i) {
          if (e0 + i >= e1) break;
          const int2 p = sd[e0 + i];
          const float d = __fsub_rn(col[p.x + c], col[p.y + c]);
          acc[KH + i] = fmaf(d, d, acc[KH + i]);
        }
      });
  // the block's sums: row i of `dyn` gathers statistic i (norms, then edges)
  // over the 128 columns
#pragma unroll
  for (int i = 0; i < KH; ++i)
    if (a0 + i < a1) dyn[(a0 + i) * kRow + c] = acc[i];
#pragma unroll
  for (int i = 0; i < EH; ++i)
    if (e0 + i < e1) dyn[(K + e0 + i) * kRow + c] = acc[KH + i];
  __syncthreads();
  for (int i = threadIdx.x; i < K + E; i += blockDim.x) {
    const float* row = dyn + i * kRow;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int u = 0; u < kLanes; u += 4) {
      s0 += row[u];
      s1 += row[u + 1];
      s2 += row[u + 2];
      s3 += row[u + 3];
    }
    dyn[i * kRow] = (s0 + s1) + (s2 + s3);
  }
  __syncthreads();
  const Edges gs{src_s, dst_s, w_s, K, E};
  finish_chunk(r, gs, f, [&](int i) { return dyn[i * kRow]; }, dyn, &flag, staged != 0);
}

// Launch 1 for any K <= 64, E <= 4096: each column block's decoded wire
// staged in shared memory, each thread summing its own statistics.
__global__ void __launch_bounds__(kAnyThreads)
edge_stats_any_kernel(EdgeWire w, Edges g, Round r, Factor f, int64_t D, int staged) {
  extern __shared__ float dec[];  // dec[a * kPadRow + s]; then the sums and finish_chunk's
  __shared__ bool flag;
  const int K = g.K, W = g.K + g.E;
  const Chunk ch = load_chunk(r.chunks, blockIdx.x);
  float acc[kAnyEntries];
  int2 ab[kAnyEntries];  // rows of the entry's two values (a norm: the same row twice)
#pragma unroll
  for (int n = 0; n < kAnyEntries; ++n) {
    const int i = threadIdx.x + n * kAnyThreads;
    acc[n] = 0.0f;
    ab[n] = i < K ? make_int2(i, -1) : i < W ? make_int2(g.src[i - K], g.dst[i - K]) : make_int2(0, 0);
  }
  const int s = threadIdx.x & (kLanes - 1);
  for (int b = ch.begin; b < ch.end; ++b) {
    __syncthreads();  // the previous column block is read
    const int64_t c = static_cast<int64_t>(b) * kLanes + s;
    const int32_t seg = w.mode == kInt8 ? w.col_seg[c] : 0;
    for (int a = threadIdx.x / kLanes; a < K; a += kAnyThreads / kLanes)
      dec[a * kPadRow + s] = decode(w, a, c, D, seg);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kAnyEntries; ++n) {
      if (threadIdx.x + n * kAnyThreads >= W) break;
      const float* x = dec + ab[n].x * kPadRow;
      if (ab[n].y < 0) {
        for (int t = 0; t < kLanes; ++t) acc[n] = fmaf(x[t], x[t], acc[n]);
      } else {
        const float* y = dec + ab[n].y * kPadRow;
        for (int t = 0; t < kLanes; ++t) {
          const float d = __fsub_rn(x[t], y[t]);
          acc[n] = fmaf(d, d, acc[n]);
        }
      }
    }
  }
  __syncthreads();  // dec becomes the sums, then finish_chunk's scratch
  float* own = dec;
#pragma unroll
  for (int n = 0; n < kAnyEntries; ++n) {
    const int i = threadIdx.x + n * kAnyThreads;
    if (i < W) own[i] = acc[n];
  }
  __syncthreads();
  finish_chunk(r, g, f, [&](int i) { return own[i]; }, dec + W, &flag, staged != 0);
}

// The classical round's Metropolis edge factors
// (repro_torch.core.dynamic.metropolis_edge_weights), the same for every
// layer, in one block.  smem: K + E floats.
__global__ void __launch_bounds__(kFactorThreads)
metropolis_kernel(Edges g, float* __restrict__ A_self, float* __restrict__ A_e, int L) {
  extern __shared__ float smem[];
  float* deg = smem;       // per agent: 1 + its in-degree
  float* m = smem + g.K;   // per edge
  const int K = g.K, E = g.E;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float d = 1.0f;
    for (int e = 0; e < E; ++e)
      if (g.dst[e] == k) d = __fadd_rn(d, g.w[e] > 0.0f ? 1.0f : 0.0f);
    deg[k] = d;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    m[e] = g.w[e] > 0.0f ? __fdiv_rn(1.0f, fmaxf(deg[g.src[e]], deg[g.dst[e]])) : 0.0f;
    for (int p = 0; p < L; ++p) A_e[static_cast<int64_t>(p) * E + e] = m[e];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.0f;
    for (int e = 0; e < E; ++e)
      if (g.dst[e] == k) s = __fadd_rn(s, m[e]);
    for (int p = 0; p < L; ++p) A_self[p * K + k] = __fsub_rn(1.0f, s);
  }
}

// out[k] = A_self[p, base + k] self[k] + sum_j a_csr[k, j] dec[nbr[k, j]],
// a_csr = valid ? A_e[p, pos] : 0 (valid: bool bytes), slot by slot; CPT
// columns a thread, one column block a CUDA block.
template <int MODE, int CPT>
__global__ void __launch_bounds__(kLanes / CPT)
csr_combine_kernel(EdgeWire w, const float* __restrict__ self,
                   const int32_t* __restrict__ block_layer, const float* __restrict__ A_self,
                   const float* __restrict__ A_e, const int32_t* __restrict__ nbr,
                   const int32_t* __restrict__ pos, const uint8_t* __restrict__ valid, int base,
                   float* __restrict__ out, int K, int Kl, int E, int dmax, int64_t D) {
  constexpr int NT = kLanes / CPT;
  extern __shared__ float smem[];
  float2* slot = reinterpret_cast<float2*>(smem);          // (Kl, dmax): (a_csr, nbr's row)
  float* a_self = smem + 2 * Kl * dmax;                    // (Kl,)
  float* col = a_self + Kl;                                // col[(j K + a) NT + t]
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  int64_t cols[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    cols[j] = static_cast<int64_t>(b) * kLanes + t + j * NT;
    const int32_t seg = MODE == kInt8 ? w.col_seg[cols[j]] : 0;
    for (int a = 0; a < K; ++a) col[(j * K + a) * NT + t] = decode_as<MODE>(w, a, cols[j], D, seg);
  }
  const int p = block_layer[b];
  for (int i = t; i < Kl; i += NT) a_self[i] = A_self[p * K + base + i];
  for (int i = t; i < Kl * dmax; i += NT)
    slot[i] = make_float2(valid[i] ? A_e[static_cast<int64_t>(p) * E + pos[i]] : 0.0f,
                          __int_as_float(nbr[i] * NT));
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < Kl; ++k) {
    float acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = __fmul_rn(self[k * D + cols[j]], a_self[k]);
    for (int i = k * dmax; i < (k + 1) * dmax; ++i) {
      const float2 s = slot[i];
      const int row = __float_as_int(s.y);
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(s.x, col[j * K * NT + row + t]));
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) out[k * D + cols[j]] = acc[j];
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

// Launch `kernel` with `floats` floats of dynamic shared memory, with the
// SM's whole carveout for shared memory so that several blocks fit on an SM.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int grid, int threads, int floats, cudaStream_t stream, Args... args) {
  const size_t bytes = static_cast<size_t>(floats) * sizeof(float);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream` (a cudaStream_t), does not
// synchronise, allocates nothing, and returns cudaGetLastError(): 0 when the
// launch was accepted.  Wire pointers a mode does not read may be null.

// Launch 1 of a DRT round over the plan's n_chunks chunks.  partial:
// n_chunks (K + E) floats; stats: L (K + E); tickets: L + 1 zeroed words
// (left zeroed); A_self (L, K) and A_e (L, E) out; scratch: L E floats.
extern "C" int seg_stats(int mode, const void* wire, const void* scales, const void* col_seg,
                         int n_segs, const void* src, const void* dst, const void* w,
                         const void* chunks, const void* layers, int n_chunks, int n_busy,
                         void* partial, void* stats, void* tickets, void* A_self, void* A_e,
                         void* scratch, int K, int E, int L, float kappa, float log_n,
                         float log_2_l1, int exact_grad, int n_blocks, void* stream) {
  if (bad_shape(K, E, n_blocks) || L < 1 || n_chunks < 1 || n_busy < 1 || n_busy > L)
    return static_cast<int>(cudaErrorInvalidValue);
  const EdgeWire wire_ = make_wire(mode, wire, scales, col_seg, n_segs);
  const Edges g{static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
                static_cast<const float*>(w), K, E};
  const Round r{static_cast<const int32_t*>(chunks), static_cast<const int32_t*>(layers),
                static_cast<float*>(partial), static_cast<float*>(stats),
                static_cast<unsigned*>(tickets), static_cast<float*>(A_self),
                static_cast<float*>(A_e), static_cast<float*>(scratch), L, n_busy};
  const Factor f{kappa, log_n, log_2_l1, exact_grad};
  const int64_t D = static_cast<int64_t>(n_blocks) * kLanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = K + E;
  // the factors stage every layer's stats in shared memory when that fits
  const int threads = K <= kRegAgents && E <= kRegEdges ? kStatsThreads : kAnyThreads;
  const int staged = factor_smem_floats(K, E, L, threads, true) <= kStageFloats;
  const int fac = max(threads, factor_smem_floats(K, E, L, threads, staged));
  if (K <= kRegAgents && E <= kRegEdges) {
    decltype(&edge_stats_kernel<kF32>) kernel;
    switch (mode) {
      case kF32: kernel = edge_stats_kernel<kF32>; break;
      case kInt8: kernel = edge_stats_kernel<kInt8>; break;
      case kBf16: kernel = edge_stats_kernel<kBf16>; break;
      case kF16: kernel = edge_stats_kernel<kF16>; break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    const int ring = kStages * edge_tile_bytes<kF32>() / 4 + kRegAgents * kLanes;
    const int floats = max(max(ring, (kRegAgents + kRegEdges) * (kLanes + 1)), fac);
    return static_cast<int>(launch(kernel, n_chunks, kStatsThreads, floats, s, wire_, g, r, f, D, staged));
  }
  const int floats = max(K * kPadRow, W + fac);
  return static_cast<int>(launch(edge_stats_any_kernel, n_chunks, kAnyThreads, floats, s, wire_, g, r, f, D, staged));
}

// Launch 1 of a classical round: the Metropolis factors of every layer.
extern "C" int seg_metropolis(const void* src, const void* dst, const void* w, void* A_self,
                              void* A_e, int K, int E, int L, void* stream) {
  if (bad_shape(K, E, 1) || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Edges g{static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
                static_cast<const float*>(w), K, E};
  const size_t smem = static_cast<size_t>(K + E) * sizeof(float);
  metropolis_kernel<<<1, kFactorThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<float*>(A_self), static_cast<float*>(A_e), L);
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
  constexpr int NT = kLanes / kCombineCols;
  const EdgeWire w = make_wire(mode, wire, scales, col_seg, n_segs);
  const size_t smem =
      static_cast<size_t>(2 * K_local * dmax + K_local + kCombineCols * K * NT) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(self);
  const int32_t* bl = static_cast<const int32_t*>(block_layer);
  const float* as = static_cast<const float*>(A_self);
  const float* ae = static_cast<const float*>(A_e);
  const int32_t* nb = static_cast<const int32_t*>(nbr);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  const uint8_t* vd = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  const int64_t D = static_cast<int64_t>(n_blocks) * kLanes;
  decltype(&csr_combine_kernel<kF32, kCombineCols>) kernel;
  switch (mode) {
    case kF32: kernel = csr_combine_kernel<kF32, kCombineCols>; break;
    case kInt8: kernel = csr_combine_kernel<kInt8, kCombineCols>; break;
    case kBf16: kernel = csr_combine_kernel<kBf16, kCombineCols>; break;
    case kF16: kernel = csr_combine_kernel<kF16, kCombineCols>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<n_blocks, NT, smem, s>>>(w, x, bl, as, ae, nb, ps, vd, dst_base, o, K, K_local, E, dmax, D);
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
