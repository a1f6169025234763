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
// order, so a DRT round here is two launches:
//
//   1. stats    one block per chunk of up to 10 column blocks of one layer
//               (the host's plan, layer_chunks.py), streamed through a ring
//               of shared-memory tiles (cp.async).  Two threads a column:
//               each makes the wire view of half the agents in place in the
//               tile, then holds the column's K values and half of the
//               K(K+1)/2 upper-triangle Gram entries in registers.  The block
//               sums its columns in a fixed order into one partial; an
//               integer ticket per layer picks the layer's last block, which
//               sums the partials in chunk order into G (L, K, K); a round
//               ticket picks the block that finishes the last layer, which
//               runs eqs. 12-14 for every layer in short parallel pieces over
//               each column's support (drt_mix_all) into A (L, K, K)
//               (split_reduce.cuh).  No float atomics: two runs give the
//               same bits.
//   2. combine  one block per 128-column block: each thread's two columns' K
//               wire values and K iterates in registers, the layer's mixing
//               matrix in shared memory (transposed, its diagonal zeroed when
//               it is staged) read as broadcasts: out = A_off^T dec + diag(A) x.
//
// A classical round needs no Gram: one combine launch with the Metropolis
// matrix.  The int8 wire is hashed in-kernel (wire_view.cuh), once a round:
// a DRT round's stats launch stores q as a (K, D) int8 buffer that the
// combine reads back (mode int8q; the same bits as hashing again, and
// faster: PERF.md).  slab_quant_encode runs the same int8 arithmetic and
// writes the int8 wire out: the permute engine and the edge path encode
// their wires with it, and it is the bit-parity probe of the in-kernel wire.
//
// K is a compile-time parameter: the register kernels take K <= 16 (the
// paper's K); the stats kernel for 16 < K <= 64 stages each column block's
// wire view in shared memory (threads over Gram entries), and the combine
// has a K <= 64 instantiation.
//
// Bound: device memory.  A DRT round reads the f32 slab twice (launches 1 and
// 2) and writes it once; the Gram (K(K+1) flops a column) and the combine
// (2 K^2) come to ~4 flops per byte at K = 16, far below the card's f32
// ratio.  The int8 hash (integer multiplies, an IEEE division) costs several
// times the Gram's instructions, but slab_quant_encode, which runs it alone,
// issues it in about the time its bytes take and runs as fast as a cast of
// the same bytes (PERF.md): a stats launch's time is not the hash's issue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_reduce.cuh"
#include "wire_view.cuh"

using namespace slab_wire;
using namespace split_reduce;

namespace {

constexpr float kNeg = -1e30f;       // the reference's non-edge sentinel
constexpr int kRegAgents = 16;       // K of the register-resident stats kernel
constexpr int kStatsThreads = 256;   // its block: two threads a column
constexpr int kAnyThreads = 256;     // the K <= 64 stats kernel's block
constexpr int kPadRow = kLanes + 1;  // its shared-memory row stride: no bank conflicts
constexpr int kAnyEntries =          // Gram entries a thread of it owns, at most
    (kMaxAgents * (kMaxAgents + 1) / 2 + kAnyThreads - 1) / kAnyThreads;
constexpr int kStageFloats = 40 * 1024;  // shared memory the mixing may stage G into (160 KB)

// Gram entry (i, j), i <= j < n, in the row-major upper triangle.
__host__ __device__ constexpr int tri(int i, int j, int n) { return i * n - i * (i - 1) / 2 + (j - i); }

// The (i, j) of upper-triangle entry e of an n x n matrix.
__device__ __forceinline__ int2 untri(int e, int n) {
  int i = 0;
  while (e >= n - i) {
    e -= n - i;
    ++i;
  }
  return make_int2(i, i + e);
}

// What the stats launch writes besides the wire: the plan's tables, the
// chunk partials (n_chunks, K(K+1)/2), G (L, K, K), the tickets (L + 1), A
// (L, K, K) and, for int8, the wire q (K, D).
struct Round {
  const int32_t* chunks;
  const int32_t* layers;
  float* partial;
  float* G;
  unsigned* tickets;
  float* A;
  int8_t* q_out;
  int L;
  int n_busy;
};

// Eqs. 12-14's constants: C the (K, K) support, kappa, log N, (L + 1) log 2.
struct Mix {
  const float* C;
  float kappa;
  float log_n;
  float log_2_l1;
  int exact_grad;
};

// squared distance of agents l and k from Gram entries (clamped at 0), as
// repro_torch.core.packing.gram_sq_dists computes it
__device__ __forceinline__ float sq_dist(float gll, float gkk, float glk) {
  return fmaxf(__fsub_rn(__fadd_rn(gll, gkk), __fmul_rn(2.0f, glk)), 0.0f);
}

// the full (K, K) G[p] from upper-triangle entry e's sum
__device__ __forceinline__ void store_gram(float* gp, int K, int e, float s) {
  const int2 ij = untri(e, K);
  gp[ij.x * K + ij.y] = s;
  gp[ij.y * K + ij.x] = s;
}

// Shared memory of drt_mix_all, in floats.
__host__ __device__ constexpr int mix_smem_floats(int K, int L, int threads, bool staged) {
  return 4 * K * K + K + 1 + L + threads * (K + 1) + (staged ? 2 * L * K * K : 0);
}

// Eqs. 12-14 (repro_torch/core/drt.py, in log space) for every layer, by the
// block that finished the last layer.  This block alone stands between the
// two launches, so the work is cut into short independent pieces:
//   1. C and each column's support S_k = {l : C[l, k] > 0} (ascending) in
//      shared memory, and (when `staged`) every layer's G;
//   2. log_prod[l, k] (a sum over ALL layers) for each edge of the support,
//      its layers split over several threads, then their sums in order;
//   3. eq. 14's log weight of every (layer, edge), in shared memory (or in A
//      when not staged);
//   4. one thread per (layer, column): its support's log weights copied to
//      its own shared-memory row, then eq. 13's clip, the self weight and
//      eq. 12 over the support alone (a non-edge's weight is exp(-1e30 -
//      max) = 0, so it adds nothing);
//   5. A written whole, every entry in parallel.
// Empty layers (no chunk) have G = 0.  STAGED: G and the log weights in
// shared memory, else G read from device memory and the log weights kept in
// A.  smem: mix_smem_floats(K, L, blockDim.x, STAGED).
template <bool STAGED>
__device__ __forceinline__ void drt_mix_all(const Round& r, const Mix& m, int K, float* smem) {
  const int KK = K * K, L = r.L, nt = blockDim.x;
  float* c_s = smem;                                      // C
  float* lp = c_s + KK;                                   // log_prod[l * K + k]
  float* part = lp + KK;                                  // (nt,): layer-group sums
  float* row = part + nt + threadIdx.x;                   // (K,) a thread: row[i * nt]
  int* busy = reinterpret_cast<int*>(part + nt * (K + 1));  // (L,): layer q has a chunk
  int* off = busy + L;                                    // (K + 1,): support offsets
  int* sup = off + K + 1;                                 // (KK,): support rows l, column by column
  int* col = sup + KK;                                    // (KK,): the column k of each
  float* la = r.A;                                        // log weights (L, K, K)
  const float* gs = r.G;
  if constexpr (STAGED) {
    la = reinterpret_cast<float*>(col + KK);
    gs = la + L * KK;
    stage(r.G, static_cast<int64_t>(L) * KK, la + L * KK);
  }
  const auto G = [&](int64_t i) {
    if constexpr (STAGED) return gs[i];
    else return __ldcg(gs + i);
  };
  for (int e = threadIdx.x; e < KK; e += nt) c_s[e] = m.C[e];
  for (int q = threadIdx.x; q < L; q += nt) busy[q] = layer_chunks(r.layers, q).y > 0;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += nt) {
    int n = 0;
    for (int l = 0; l < K; ++l) n += c_s[l * K + k] > 0.0f;
    off[k + 1] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int k = 0; k < K; ++k) off[k + 1] += off[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += nt) {
    int n = off[k];
    for (int l = 0; l < K; ++l)
      if (c_s[l * K + k] > 0.0f) {
        sup[n] = l;
        col[n++] = k;
      }
  }
  __syncthreads();
  // log_prod: (support entry, group of layers) per thread, then the groups in order
  const int ns = off[K];
  const int groups = max(1, min(nt / max(ns, 1), L));
  const int per = (L + groups - 1) / groups;
  for (int base = 0; base < ns * groups; base += nt) {
    const int item = base + threadIdx.x;
    float s = 0.0f;
    int l = 0, k = 0;
    if (item < ns * groups) {
      const int j = item % ns, g = item / ns;
      l = sup[j];
      k = col[j];
      if (l != k)
        for (int q = g * per; q < min(L, (g + 1) * per); ++q) {
          if (!busy[q]) continue;  // log1p(0 / kappa) = 0
          const int64_t o = static_cast<int64_t>(q) * KK;
          const float gll = G(o + l * K + l);
          const float d2 = sq_dist(gll, G(o + k * K + k), G(o + l * K + k));
          s = __fadd_rn(s, log1pf(__fdiv_rn(d2, __fadd_rn(gll, m.kappa))));
        }
    }
    part[threadIdx.x] = s;
    __syncthreads();
    if (item < ns) {
      for (int g = 1; g < groups; ++g) s = __fadd_rn(s, part[threadIdx.x + g * ns]);
      lp[l * K + k] = s;
    }
    __syncthreads();
  }
  // eq. 14's log weight of every (layer, edge)
  for (int pj = threadIdx.x; pj < L * ns; pj += nt) {
    const int p = pj / ns, j = pj % ns;
    const int l = sup[j], k = col[j];
    if (l == k) continue;
    const int64_t o = static_cast<int64_t>(p) * KK;
    const bool bz = busy[p];
    const float gll = bz ? G(o + l * K + l) : 0.0f;
    const float d2 = sq_dist(gll, bz ? G(o + k * K + k) : 0.0f, bz ? G(o + l * K + k) : 0.0f);
    const float log_denom = m.exact_grad ? logf(__fadd_rn(__fadd_rn(gll, m.kappa), d2))
                                         : logf(__fadd_rn(d2, m.kappa));
    la[o + l * K + k] = __fadd_rn(__fsub_rn(__fadd_rn(lp[l * K + k], m.log_2_l1), log_denom), logf(c_s[l * K + k]));
  }
  __syncthreads();
  for (int pk = threadIdx.x; pk < L * K; pk += nt) {
    const int p = pk / K, k = pk % K;
    float* lak = la + static_cast<int64_t>(p) * KK + k;  // lak[l * K]: this column
    const int j0 = off[k], n = off[k + 1] - j0;
    int self = -1;  // the self entry's place in the support
    for (int i = 0; i < n; ++i) {
      const int l = sup[j0 + i];
      if (l == k) self = i;
      row[i * nt] = lak[l * K];
    }
    // eq. 13: clip at N x the column's smallest edge weight
    float log_min = -kNeg;
    for (int i = 0; i < n; ++i)
      if (i != self) log_min = fminf(log_min, row[i * nt]);
    const float cap = __fadd_rn(m.log_n, log_min);
    float mx = kNeg;
    for (int i = 0; i < n; ++i)
      if (i != self) {
        const float v = fminf(row[i * nt], cap);
        row[i * nt] = v;
        mx = fmaxf(mx, v);
      }
    // the sum over all l of exp(la - mx): with no edge, K terms exp(0)
    const int n_e = n - (self >= 0);
    float sum = n_e == 0 ? static_cast<float>(K) : 0.0f;
    for (int i = 0; i < n; ++i)
      if (i != self) sum = __fadd_rn(sum, expf(__fsub_rn(row[i * nt], mx)));
    const float log_sum = __fadd_rn(logf(sum), mx);
    const float denom = fmaxf(static_cast<float>(n) - 1.0f, 1.0f);
    const float log_self = __fadd_rn(logf(__fdiv_rn(c_s[k * K + k], denom)), log_sum);
    if (self >= 0) row[self * nt] = log_self;
    // eq. 12: normalise over the support of C
    mx = kNeg;
    for (int i = 0; i < n; ++i) mx = fmaxf(mx, row[i * nt]);
    float total = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float v = expf(__fsub_rn(row[i * nt], mx));
      row[i * nt] = v;
      total = __fadd_rn(total, v);
    }
    for (int i = 0; i < n; ++i) lak[sup[j0 + i] * K] = __fdiv_rn(row[i * nt], total);
  }
  __syncthreads();
  for (int p = 0; p < L; ++p)
    for (int e = threadIdx.x; e < KK; e += nt) r.A[p * KK + e] = c_s[e] > 0.0f ? la[p * KK + e] : 0.0f;
}

// After a block's chunk Gram: the round's tickets, G and A (module comment).
// value(i, j) (i <= j < K) is the block's sum, read before the first ticket;
// smem (which may alias what value reads): max(blockDim.x,
// mix_smem_floats(K, L, blockDim.x, staged)) floats.
template <typename Value>
__device__ __forceinline__ void finish_chunk(const Round& r, const Mix& m, int K, Value value, float* smem,
                                             bool* flag, bool staged) {
  const Chunk ch = load_chunk(r.chunks, blockIdx.x);
  const int2 lay = layer_chunks(r.layers, ch.layer);
  const int T = K * (K + 1) / 2;
  float* gp = r.G + static_cast<int64_t>(ch.layer) * K * K;
  if (lay.y == 1) {
    for (int idx = threadIdx.x; idx < K * K; idx += blockDim.x) {
      const int i = idx / K, j = idx % K;
      gp[idx] = i <= j ? value(i, j) : value(j, i);
    }
  } else {
    float* part = r.partial + static_cast<int64_t>(blockIdx.x) * T;
    for (int idx = threadIdx.x; idx < K * K; idx += blockDim.x) {
      const int i = idx / K, j = idx % K;
      if (i <= j) part[tri(i, j, K)] = value(i, j);
    }
    if (!draw_last(&r.tickets[ch.layer], lay.y, flag)) return;
    sum_chunks(r.partial, lay.x, lay.y, T, smem, [&](int e, float s) { store_gram(gp, K, e, s); });
    if (threadIdx.x == 0) r.tickets[ch.layer] = 0u;
  }
  if (!draw_last(&r.tickets[r.L], r.n_busy, flag)) return;
  if (staged)
    drt_mix_all<true>(r, m, K, smem);
  else
    drt_mix_all<false>(r, m, K, smem);
  if (threadIdx.x == 0) r.tickets[r.L] = 0u;
}

// The wire view of agent a at column col (x its slab value), storing the
// int8 wire for the combine.
template <int MODE>
__device__ __forceinline__ float stats_view(const Wire& w, const Round& r, const Column& col, int a,
                                            int64_t D, float x) {
  if constexpr (MODE == kInt8) {
    float s;
    const float q = int8_encode(w, col, a, x, &s);
    r.q_out[a * D + col.c] = static_cast<int8_t>(__float2int_rn(q));
    return __fmul_rn(q, s);
  } else if constexpr (MODE == kSent) {
    return x;  // the sent wire itself
  } else {
    return wire_view_as<MODE>(w, col, a, D, x);
  }
}

// Floats of one ring stage of the register stats kernel: KT rows of 128
// (the agents' slab, or sent, values), then for int8 the column maps' rows.
template <int KT, int MODE>
__host__ __device__ constexpr int gram_tile_floats() { return (KT + (MODE == kInt8 ? 3 : 0)) * kLanes; }

// Half H of the Gram's upper triangle (entries H * N .. H * N + N - 1 in
// tri order, N = KT (KT + 1) / 4) of one column's values v.
template <int KT, int H>
__device__ __forceinline__ void gram_half(const float (&v)[KT], float (&acc)[KT * (KT + 1) / 4]) {
  constexpr int N = KT * (KT + 1) / 4;
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int j = i; j < KT; ++j) {
      const int e = tri(i, j, KT) - H * N;
      if (e >= 0 && e < N) acc[e] = fmaf(v[i], v[j], acc[e]);
    }
}

// Launch 1 for K <= KT: the chunk's column blocks streamed through the tile
// ring; two threads a column (the block's halves): each makes the wire view
// of half the agents in place in the tile, then holds the column's values
// and half of the Gram's upper triangle in registers.  Dynamic smem: the
// ring, then (aliased) the reduction and the mixing (see sec_stats).
template <int KT, int MODE>
__global__ void __launch_bounds__(kStatsThreads)
gram_stats_kernel(Wire w, const float* __restrict__ slab, Round r, Mix m, int K, int64_t D,
                  int staged) {
  static_assert(KT * (KT + 1) % 4 == 0, "the Gram splits into two halves");
  constexpr int N = KT * (KT + 1) / 4;     // Gram entries a thread holds
  constexpr int kTile = gram_tile_floats<KT, MODE>();
  constexpr int kRow = kLanes + 1;         // the reduction's row
  extern __shared__ __align__(16) float smem[];
  __shared__ bool flag;
  const int c = threadIdx.x % kLanes;      // this thread's column of the tile
  const int h = threadIdx.x / kLanes;      // its half
  const int a0 = h == 0 ? 0 : (K + 1) / 2, a1 = h == 0 ? (K + 1) / 2 : K;  // its agents
  const Chunk ch = load_chunk(r.chunks, blockIdx.x);
  const float* src = MODE == kSent ? w.sent : slab;
  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.0f;
  stream_blocks(
      ch.begin, ch.end,
      [&](int st, int b) {
        char* dst = reinterpret_cast<char*>(smem + st * kTile);
        const int64_t c0 = static_cast<int64_t>(b) * kLanes;
        copy_rows(dst, K, kLanes * 4, [&](int a) { return src + a * D + c0; });
        if constexpr (MODE == kInt8) {
          copy_rows(dst + KT * kLanes * 4, 3, kLanes * 4, [&](int i) {
            return (i == 0 ? w.col_seg : i == 1 ? w.col_leaf : reinterpret_cast<const int32_t*>(w.col_idx)) + c0;
          });
        }
      },
      [&](int st, int b) {
        float* tile = smem + st * kTile;
        if constexpr (MODE != kSent) {
          Column col{static_cast<int64_t>(b) * kLanes + c, 0, 0, 0u};
          if constexpr (MODE == kInt8) {
            const int32_t* maps = reinterpret_cast<const int32_t*>(tile + KT * kLanes);
            col.seg = maps[c];
            col.leaf = maps[kLanes + c];
            col.idx = static_cast<uint32_t>(maps[2 * kLanes + c]);
          }
          for (int a = a0; a < a1; ++a) tile[a * kLanes + c] = stats_view<MODE>(w, r, col, a, D, tile[a * kLanes + c]);
          __syncthreads();
        }
        float v[KT];
#pragma unroll
        for (int a = 0; a < KT; ++a) v[a] = a < K ? tile[a * kLanes + c] : 0.0f;
        if (h == 0)
          gram_half<KT, 0>(v, acc);
        else
          gram_half<KT, 1>(v, acc);
      });
  // the block's sums: thread (h, c) holds entries h N .. h N + N - 1 of
  // column c; row e of `smem` gathers entry e over the 128 columns
#pragma unroll
  for (int e = 0; e < N; ++e) smem[(h * N + e) * kRow + c] = acc[e];
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * N; e += blockDim.x) {
    const float* row = smem + e * kRow;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int u = 0; u < kLanes; u += 4) {
      s0 += row[u];
      s1 += row[u + 1];
      s2 += row[u + 2];
      s3 += row[u + 3];
    }
    smem[e * kRow] = (s0 + s1) + (s2 + s3);
  }
  __syncthreads();
  finish_chunk(r, m, K, [&](int i, int j) { return smem[tri(i, j, KT) * kRow]; }, smem, &flag,
               staged != 0);
}

// Launch 1 for any K <= 64: each column block's wire view staged in shared
// memory, each thread summing its own Gram entries over the chunk.
__global__ void __launch_bounds__(kAnyThreads)
gram_stats_any_kernel(Wire w, const float* __restrict__ slab, Round r, Mix m, int K, int64_t D,
                      int staged) {
  extern __shared__ float dec[];  // dec[a * kPadRow + s]; then finish_chunk's
  __shared__ bool flag;
  const Chunk ch = load_chunk(r.chunks, blockIdx.x);
  const int T = K * (K + 1) / 2;
  float acc[kAnyEntries];
  int2 ij[kAnyEntries];
#pragma unroll
  for (int n = 0; n < kAnyEntries; ++n) {
    const int e = threadIdx.x + n * kAnyThreads;
    acc[n] = 0.0f;
    ij[n] = e < T ? untri(e, K) : make_int2(0, 0);
  }
  const bool use_x = w.mode != kSent;
  const int s = threadIdx.x & (kLanes - 1);
  for (int b = ch.begin; b < ch.end; ++b) {
    __syncthreads();  // the previous column block is read
    const int64_t c = static_cast<int64_t>(b) * kLanes + s;
    const Column col = load_column(w, c);
    for (int a = threadIdx.x / kLanes; a < K; a += kAnyThreads / kLanes) {
      const float x = use_x ? slab[a * D + c] : 0.0f;
      dec[a * kPadRow + s] = w.mode == kInt8 ? stats_view<kInt8>(w, r, col, a, D, x)
                                             : wire_view(w, col, a, D, x);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kAnyEntries; ++n) {
      if (threadIdx.x + n * kAnyThreads >= T) break;
      const float* di = dec + ij[n].x * kPadRow;
      const float* dj = dec + ij[n].y * kPadRow;
#pragma unroll 8
      for (int t = 0; t < kLanes; ++t) acc[n] = fmaf(di[t], dj[t], acc[n]);
    }
  }
  __syncthreads();  // dec becomes finish_chunk's scratch
  float* own = dec;  // the block's sums, entry by entry, for value()
  for (int n = 0; n < kAnyEntries; ++n) {
    const int e = threadIdx.x + n * kAnyThreads;
    if (e < T) own[e] = acc[n];
  }
  __syncthreads();
  // own[] (T floats) must outlive the partial writes: finish_chunk's scratch
  // starts after it
  finish_chunk(r, m, K, [&](int i, int j) { return own[tri(i, j, K)]; }, dec + T, &flag,
                           staged != 0);
}

// slab_quant_encode: the int8 wire of a (K, D) slab, written out.
//
// Bound: device memory.  Per element it reads 4 bytes of slab and writes 1
// byte of wire, plus 12 bytes of column maps per column (whatever K):
// 0.0085 ms at K = 16 and 0.0016 ms at K = 1 on the main slab.  The
// arithmetic is int8_encode's (wire_view.cuh): two fmix32 rounds, the IEEE
// division's fast path, the add, floor, clamp and conversions.  With the
// thread's loads and addresses, the built kernel issues ~56 instructions an
// element on its fast path (PERF.md): ~8.3 us at K = 16 on 132 SMs, about
// what its bytes take.
//
// Design: one thread per (agent, four-column group): a float4 of the
// agent's slab row (a streaming load: it is read once), the three column
// maps as 16-byte vectors, and the agent's four int8 values stored as one
// 32-bit word.  The grid is (column tiles of 128 groups, K), so each thread
// encodes 4 elements at ~32 registers and an SM holds 64 warps: every
// element's IEEE division is a branch of its own (FCHK, then the slow path
// out of line), so a thread's elements run one after another, and the
// load and hash latencies are hidden by warps rather than by a thread's
// unrolled work: a thread that encoded all K agents of its group (K at
// compile time, all K loads issued first) ran twice as long (PERF.md).
// The per-agent words (scales per agent and segment, w0 / w1 per agent and
// leaf) are gathered through the read-only path: once for the four columns
// when the whole warp's columns share their segment and leaf (all but one
// of the main slab's four-column groups do), else once per column; the
// test is warp-wide so that the rare path is a branch that the common one
// does not issue.  Staging the tables in shared memory measured no faster.

constexpr int kQuantThreads = 128;

__global__ void __launch_bounds__(kQuantThreads)
quant_encode_kernel(Wire w, const float4* __restrict__ slab, uint32_t* __restrict__ q, int64_t groups) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kQuantThreads + threadIdx.x;
  const int a = blockIdx.y;
  if (g >= groups) return;
  const float4 x4 = __ldcs(slab + a * groups + g);
  const int4 seg = __ldg(reinterpret_cast<const int4*>(w.col_seg) + g);
  const int4 leaf = __ldg(reinterpret_cast<const int4*>(w.col_leaf) + g);
  const uint4 idx = __ldg(reinterpret_cast<const uint4*>(w.col_idx) + g);
  const float x[4] = {x4.x, x4.y, x4.z, x4.w};
  const uint32_t sg[4] = {static_cast<uint32_t>(seg.x), static_cast<uint32_t>(seg.y),
                          static_cast<uint32_t>(seg.z), static_cast<uint32_t>(seg.w)};
  const uint32_t lf[4] = {static_cast<uint32_t>(leaf.x), static_cast<uint32_t>(leaf.y),
                          static_cast<uint32_t>(leaf.z), static_cast<uint32_t>(leaf.w)};
  const uint32_t ix[4] = {idx.x, idx.y, idx.z, idx.w};
  const float* scales = w.scales + static_cast<uint32_t>(a * w.n_segs);
  const uint32_t* w0 = w.w0 + static_cast<uint32_t>(a * w.n_leaves);
  const uint32_t* w1 = w.w1 + static_cast<uint32_t>(a * w.n_leaves);
  const bool same = sg[0] == sg[1] && sg[0] == sg[2] && sg[0] == sg[3] && lf[0] == lf[1] && lf[0] == lf[2] &&
                    lf[0] == lf[3];
  float s[4], u[4];
  uint32_t k0[4], k1[4];
  if (__all_sync(__activemask(), same)) {  // a warp-wide branch: the rare path is not issued
    s[0] = s[1] = s[2] = s[3] = __ldg(scales + sg[0]);
    k0[0] = k0[1] = k0[2] = k0[3] = __ldg(w0 + lf[0]);
    k1[0] = k1[1] = k1[2] = k1[3] = __ldg(w1 + lf[0]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = __ldg(scales + sg[j]);
      k0[j] = __ldg(w0 + lf[j]);
      k1[j] = __ldg(w1 + lf[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) u[j] = bits_to_uniform(counter_bits(k0[j], k1[j], ix[j]));
  // int8_encode's rounding (wire_view.cuh), the hashes above all issued first
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = floorf(__fadd_rn(__fdiv_rn(x[j], s[j]), u[j]));
    word |= (static_cast<uint32_t>(__float2int_rn(fminf(fmaxf(v, -w.qmax), w.qmax))) & 0xFFu) << (8 * j);
  }
  q[a * groups + g] = word;
}

// Launch 2 (and the whole classical round): CPT columns a thread, one
// column block a CUDA block.  A is (L, K, K) indexed through block_layer, or
// one (K, K) matrix for every block when block_layer is null.
template <int KT, int MODE, int CPT>
__global__ void __launch_bounds__(kLanes / CPT)
combine_kernel(Wire w, const float* __restrict__ slab, const float* __restrict__ A,
               const int32_t* __restrict__ block_layer, float* __restrict__ out, int K,
               int64_t D) {
  constexpr int NT = kLanes / CPT;
  __shared__ __align__(16) float a_t[KT * KT];  // a_t[k * KT + l] = A[l, k], l != k; else 0
  __shared__ float diag[KT];
  const int b = blockIdx.x;
  int64_t cols[CPT];
  float x[CPT][KT], v[CPT][KT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    cols[j] = static_cast<int64_t>(b) * kLanes + threadIdx.x + j * NT;
#pragma unroll
    for (int a = 0; a < KT; ++a) x[j][a] = a < K ? slab[a * D + cols[j]] : 0.0f;
  }
  const float* ab = A + (block_layer ? static_cast<int64_t>(block_layer[b]) * K * K : 0);
  for (int i = threadIdx.x; i < KT * KT; i += NT) {
    const int k = i / KT, l = i % KT;
    a_t[i] = k < K && l < K && l != k ? ab[l * K + k] : 0.0f;
  }
  for (int k = threadIdx.x; k < KT; k += NT) diag[k] = k < K ? ab[k * K + k] : 0.0f;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const Column col = load_column_as<MODE>(w, cols[j]);
#pragma unroll
    for (int a = 0; a < KT; ++a) v[j][a] = a < K ? wire_view_as<MODE>(w, col, a, D, x[j][a]) : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k >= K) break;
    float acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = 0.0f;
    const float4* row = reinterpret_cast<const float4*>(a_t + k * KT);
#pragma unroll
    for (int l4 = 0; l4 < KT / 4; ++l4) {
      const float4 a = row[l4];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        acc[j] = fmaf(a.x, v[j][4 * l4], acc[j]);
        acc[j] = fmaf(a.y, v[j][4 * l4 + 1], acc[j]);
        acc[j] = fmaf(a.z, v[j][4 * l4 + 2], acc[j]);
        acc[j] = fmaf(a.w, v[j][4 * l4 + 3], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) out[k * D + cols[j]] = __fadd_rn(acc[j], __fmul_rn(diag[k], x[j][k]));
  }
}

Wire make_wire(int mode, const void* scales, const void* col_seg, const void* col_leaf,
               const void* col_idx, const void* w0, const void* w1, const void* sent,
               const void* q, int n_segs, int n_leaves, float qmax) {
  Wire w;
  w.mode = mode;
  w.scales = static_cast<const float*>(scales);
  w.col_seg = static_cast<const int32_t*>(col_seg);
  w.col_leaf = static_cast<const int32_t*>(col_leaf);
  w.col_idx = static_cast<const uint32_t*>(col_idx);
  w.w0 = static_cast<const uint32_t*>(w0);
  w.w1 = static_cast<const uint32_t*>(w1);
  w.sent = static_cast<const float*>(sent);
  w.q = static_cast<const int8_t*>(q);
  w.n_segs = n_segs;
  w.n_leaves = n_leaves;
  w.qmax = qmax;
  return w;
}

bool bad_shape(int K, int n_blocks) { return K < 1 || K > kMaxAgents || n_blocks < 1; }

// Launch `kernel` with `floats` floats of dynamic shared memory (opting in
// above the default 48 KB), with the SM's whole carveout for shared memory
// so that several blocks fit on an SM.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int grid, int threads, int floats, cudaStream_t stream, Args... args) {
  const size_t bytes = static_cast<size_t>(floats) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
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

extern "C" int slab_quant_encode_i8(const void* slab, const void* scales, const void* col_seg,
                                    const void* col_leaf, const void* col_idx, const void* w0,
                                    const void* w1, int n_segs, int n_leaves, float qmax,
                                    void* q, int K, int n_blocks, void* stream) {
  if (bad_shape(K, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const Wire w = make_wire(kInt8, scales, col_seg, col_leaf, col_idx, w0, w1, nullptr, nullptr,
                           n_segs, n_leaves, qmax);
  const int64_t groups = static_cast<int64_t>(n_blocks) * kLanes / 4;
  const dim3 grid(static_cast<unsigned>((groups + kQuantThreads - 1) / kQuantThreads), static_cast<unsigned>(K));
  quant_encode_kernel<<<grid, kQuantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float4*>(slab), static_cast<uint32_t*>(q), groups);
  return static_cast<int>(cudaGetLastError());
}

// Launch 1 of a DRT round over the plan's n_chunks chunks (mode int8, bf16,
// f16 or sent).  partial: n_chunks K(K+1)/2 floats; G and A: L K^2; tickets:
// L + 1 zeroed words (left zeroed); q_out: (K, D) int8 for int8, else null.
extern "C" int sec_stats(int mode, const void* slab, const void* scales, const void* col_seg,
                         const void* col_leaf, const void* col_idx, const void* w0, const void* w1,
                         const void* sent, const void* q, int n_segs, int n_leaves, float qmax,
                         const void* chunks, const void* layers, int n_chunks, int n_busy,
                         void* partial, void* G, void* tickets, void* q_out, const void* C,
                         void* A, int K, int L, float kappa, float log_n, float log_2_l1,
                         int exact_grad, int n_blocks, void* stream) {
  if (bad_shape(K, n_blocks) || L < 1 || n_chunks < 1 || n_busy < 1 || n_busy > L ||
      mode == kInt8Q || (q_out != nullptr) != (mode == kInt8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Wire w = make_wire(mode, scales, col_seg, col_leaf, col_idx, w0, w1, sent, q, n_segs,
                           n_leaves, qmax);
  const Round r{static_cast<const int32_t*>(chunks), static_cast<const int32_t*>(layers),
                static_cast<float*>(partial), static_cast<float*>(G),
                static_cast<unsigned*>(tickets), static_cast<float*>(A),
                static_cast<int8_t*>(q_out), L, n_busy};
  const Mix m{static_cast<const float*>(C), kappa, log_n, log_2_l1, exact_grad};
  const int64_t D = static_cast<int64_t>(n_blocks) * kLanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(slab);
  const int T = K * (K + 1) / 2;
  // the mixing stages every layer's G in shared memory when that fits
  const int threads = K <= kRegAgents ? kStatsThreads : kAnyThreads;
  const int staged = mix_smem_floats(K, L, threads, true) <= kStageFloats;
  const int mix = max(threads, mix_smem_floats(K, L, threads, staged));
  if (K <= kRegAgents) {
    decltype(&gram_stats_kernel<kRegAgents, kInt8>) kernel;
    switch (mode) {
      case kInt8: kernel = gram_stats_kernel<kRegAgents, kInt8>; break;
      case kBf16: kernel = gram_stats_kernel<kRegAgents, kBf16>; break;
      case kF16: kernel = gram_stats_kernel<kRegAgents, kF16>; break;
      case kSent: kernel = gram_stats_kernel<kRegAgents, kSent>; break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr int NT = kRegAgents * (kRegAgents + 1) / 2;
    const int floats = max(max(kStages * gram_tile_floats<kRegAgents, kInt8>(), NT * (kLanes + 1)), mix);
    return static_cast<int>(launch(kernel, n_chunks, kStatsThreads, floats, s, w, x, r, m, K, D, staged));
  }
  const int floats = max(K * kPadRow, T + mix);
  return static_cast<int>(launch(gram_stats_any_kernel, n_chunks, kAnyThreads, floats, s, w, x, r, m, K, D, staged));
}

// Launch 2 of a DRT round, or the whole classical round.  A is (L, K, K)
// indexed through block_layer, or one (K, K) matrix for every block when
// block_layer is null.
extern "C" int sec_combine(int mode, const void* slab, const void* scales, const void* col_seg,
                           const void* col_leaf, const void* col_idx, const void* w0,
                           const void* w1, const void* sent, const void* q, int n_segs,
                           int n_leaves, float qmax, const void* A, const void* block_layer,
                           void* out, int K, int n_blocks, void* stream) {
  if (bad_shape(K, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const Wire w = make_wire(mode, scales, col_seg, col_leaf, col_idx, w0, w1, sent, q, n_segs,
                           n_leaves, qmax);
  const int64_t D = static_cast<int64_t>(n_blocks) * kLanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(slab);
  const float* a = static_cast<const float*>(A);
  const int32_t* bl = static_cast<const int32_t*>(block_layer);
  float* o = static_cast<float*>(out);
  decltype(&combine_kernel<kRegAgents, kInt8, 2>) kernel;
  const bool small = K <= kRegAgents;  // else the K <= 64 instantiation, one column a thread
  switch (mode) {
    case kInt8: kernel = small ? combine_kernel<kRegAgents, kInt8, 2> : combine_kernel<kMaxAgents, kInt8, 1>; break;
    case kBf16: kernel = small ? combine_kernel<kRegAgents, kBf16, 2> : combine_kernel<kMaxAgents, kBf16, 1>; break;
    case kF16: kernel = small ? combine_kernel<kRegAgents, kF16, 2> : combine_kernel<kMaxAgents, kF16, 1>; break;
    case kSent: kernel = small ? combine_kernel<kRegAgents, kSent, 2> : combine_kernel<kMaxAgents, kSent, 1>; break;
    case kInt8Q: kernel = small ? combine_kernel<kRegAgents, kInt8Q, 2> : combine_kernel<kMaxAgents, kInt8Q, 1>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<n_blocks, small ? kLanes / 2 : kLanes, 0, s>>>(w, x, a, bl, o, K, D);
  return static_cast<int>(cudaGetLastError());
}
