// combine_rows.cuh: the batched neighbour combine shared by weighted_combine
// (csrc/combine.cu) and dequant_combine (csrc/quantize.cu), over a table of
// column segments in ONE launch.
//
//   out[m, c] = sum_n w_p[m, n] * x[n, c]   for c in a segment with weights p
//   out[m, c] = 0                           for c in no segment
//
// (m < M, n < N).  dequant_combine's weights are w_p[m, n] = a_p[m, n] *
// s[n, sid], one f32 rounding (__fmul_rn), as its plain version forms them.
// The sum runs in the Pallas bodies' order: acc = w[m, 0] * x[0, c], then
// acc += w[m, j] * x[j, c] for j = 1 .. N - 1, product and sum rounded apart
// (__fmul_rn, __fadd_rn: nvcc would otherwise contract them into an fma),
// then one rounding to the output dtype, so the kernels equal their plain
// PyTorch versions bit for bit.  (acc starts at -0.0f: -0 + y == y for every
// y, so the first step is the product itself.)
//
// Operands are read where they lie, through strides: the weights as a stacked
// (P, M, N) view (w_p[m, n] = w[p ws_p + m ws_m + n ws_n]; the per-slot
// combines pass their (L, K, K) mixing matrices transposed as a view), the
// scales of source n in column sid at s[n ss_n + sid ss_col] (the wire's
// (K, n_scale) scales), source n's column c at x[n ldx + c] and output row m's
// column c at out[m ldo + c].
//
// Work items: tiles of at most kTile = 512 columns of one segment, or of a
// run of columns in no segment (written 0), from a table the host builds
// (repro_torch.kernels.combine.plan_tiles: int64 rows (first column, end
// column, p, sid), p < 0 for zeros; tiles split at multiples of 512 columns).
// A null table is one segment over [0, n_cols) with p = sid = 0, in tiles
// of 256 columns: the single-call API.  A one-wave grid of 64-thread blocks strides over the
// tiles, each tile in passes of up to 16 output rows (a step).
//
// Bound: device memory.  A launch reads N n input elements and writes M n
// output elements (the per-slot f32 combine on the K=16 slab: 4 flops per
// byte; the int8 one 6), below the H100's ~20 f32 flops per byte of HBM
// bandwidth.  Product and sum rounded apart are two FP32 instructions a
// term, not one fma: on the K=16 slab their issue alone is about 40% of the
// bytes' time, so the kernel must keep memory and FP32 issue overlapped.
//
// Design: four columns a thread.  Where a tile's source and output rows share
// their phase modulo four elements and every row stride is a multiple of
// four (the slab's segments), a thread owns four consecutive columns of the
// address-aligned frame: one 16-byte (f32), 8-byte (bf16) or 4-byte (int8)
// load per source, one float4 or 4-bf16 store per output row, neighbouring
// threads on neighbouring addresses; the frame's partial groups at a
// segment's head and tail take the per-column path.  Otherwise (an unaligned
// view, an odd stride) a thread takes columns c0 + 256 j + t + 64 k, k < 4,
// one element at a time.  A 64-thread block gives each thread two groups of
// a tile (kGroups).  A thread keeps kRows x 4 f32 accumulators (kRows = 16
// for M > 8: the main path's K = 16 in one pass) and streams the N sources
// through a ring of kRing = 8 loads in flight (held as loaded, widened at
// use; int8 through an integer trick, not the slower conversion unit), in a
// rolled loop of 8 sources a turn whose code every turn and every warp reuses.
// M > 16 goes in passes of 16 output rows, each reading the tile's sources
// again (from L1/L2).  A step's (kRows, N) weights (dequant: a * s, rounded
// once) sit in shared memory, read as float4 broadcasts (one address for the
// block).  The steps are software-pipelined: while a step computes, the next
// step's weights copy into the other half of a double buffer with cp.async,
// and a thread refills its ring with its next group's first sources before
// it stores this group's outputs; one barrier a step.  A scratch comparison
// of variants on the card (PERF.md; its script is not kept) ranked this
// above fully unrolled source loops, weights through __ldg, 128-thread
// blocks, one group a thread, other ring depths, I2F conversions and no
// pipelining; the launch bounds cap a thread at 170 registers (6 blocks, 12
// warps an SM) with no spills.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace combine_rows {

constexpr int kThreads = 64;
constexpr int kMinBlocks = 6;        // blocks an SM: the launch bounds' register cap (170)
constexpr int kGroups = 2;           // groups of four columns a thread takes in a tile
constexpr int kTile = 4 * kGroups * kThreads;  // columns of a tile; plan_tiles (TILE_COLS) uses the same
// A null table's tiles (the single-call API): one group a thread, so a call
// of a few hundred tiles puts twice the blocks in flight (a slab layout's
// tables keep two groups a thread: a thread then loads its second group's
// sources while it stores its first's).
constexpr int kSingleTile = kTile / 2;
// Largest N taken; the Python wrappers check the same limit (MAX_SOURCES).
constexpr int kMaxSources = 64;
constexpr int kRing = 8;  // source loads a thread keeps in flight

struct Params {
  const float* w;  // w_p[m, n] = w[p * ws_p + m * ws_m + n * ws_n]
  const float* s;  // dequant: scale of source n in column sid = s[n * ss_n + sid * ss_col]
  const void* x;   // source n, column c: x[n * ldx + c]
  void* out;       // output row m, column c: out[m * ldo + c]
  const int64_t* tiles;  // (n_tiles, 4): first column, end column, p, sid; null: one segment
  int64_t ldx, ldo, n_tiles, n_cols;
  int ws_p, ws_m, ws_n, ss_n, ss_col;  // element strides; the wrappers check they fit
  int M, N;
};

// Loads of four columns of one source row, kept as loaded (Raw) until used.
template <typename T> struct Src;

template <> struct Src<float> {
  using Raw = float4;
  __device__ static Raw load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static Raw load_each(const float* p, int64_t step, unsigned ok) {
    return make_float4(ok & 1 ? __ldg(p) : 0.0f, ok & 2 ? __ldg(p + step) : 0.0f,
                       ok & 4 ? __ldg(p + 2 * step) : 0.0f, ok & 8 ? __ldg(p + 3 * step) : 0.0f);
  }
  __device__ static float4 widen(Raw r) { return r; }
};

template <> struct Src<__nv_bfloat16> {
  using Raw = uint2;  // four bf16, element 0 in the low half of .x
  __device__ static Raw load4(const __nv_bfloat16* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ static Raw load_each(const __nv_bfloat16* p, int64_t step, unsigned ok) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    const unsigned e0 = ok & 1 ? __ldg(h) : 0u, e1 = ok & 2 ? __ldg(h + step) : 0u;
    const unsigned e2 = ok & 4 ? __ldg(h + 2 * step) : 0u, e3 = ok & 8 ? __ldg(h + 3 * step) : 0u;
    return make_uint2(e0 | (e1 << 16), e2 | (e3 << 16));
  }
  __device__ static float4 widen(Raw r) {  // a bf16's bits are the f32's upper half: exact
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
  }
};

template <> struct Src<int8_t> {
  using Raw = unsigned;  // four int8, element 0 in the low byte
  __device__ static Raw load4(const int8_t* p) { return __ldg(reinterpret_cast<const unsigned*>(p)); }
  __device__ static Raw load_each(const int8_t* p, int64_t step, unsigned ok) {
    const unsigned char* b = reinterpret_cast<const unsigned char*>(p);
    const unsigned e0 = ok & 1 ? __ldg(b) : 0u, e1 = ok & 2 ? __ldg(b + step) : 0u;
    const unsigned e2 = ok & 4 ? __ldg(b + 2 * step) : 0u, e3 = ok & 8 ? __ldg(b + 3 * step) : 0u;
    return e0 | e1 << 8 | e2 << 16 | e3 << 24;
  }
  // Without the conversion unit (an eighth of the FP32 rate): byte b + 128
  // placed in the mantissa of 2^23 + 2^22 (0x4B400000), the float minus
  // 2^23 + 2^22 + 128 is b exactly; one PRMT and one FADD an element.
  __device__ static float to_float(unsigned biased, unsigned k) {
    return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B400000u, 0x7650u + k)), 12583040.0f);
  }
  __device__ static float4 widen(Raw r) {
    const unsigned biased = r ^ 0x80808080u;
    return make_float4(to_float(biased, 0), to_float(biased, 1), to_float(biased, 2), to_float(biased, 3));
  }
};

// Stores of four columns of one output row, each rounded once to Out.
template <typename T> struct Dst;

template <> struct Dst<float> {
  __device__ static void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
  __device__ static void store1(float* p, float v) { *p = v; }
};

template <> struct Dst<__nv_bfloat16> {
  __device__ static unsigned bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
  __device__ static void store4(__nv_bfloat16* p, float4 v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bits(v.x) | (bits(v.y) << 16), bits(v.z) | (bits(v.w) << 16));
  }
  __device__ static void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

template <typename Out>
__device__ __forceinline__ void store_row(Out* row, int64_t step, bool whole, unsigned ok, float4 v) {
  if (whole) {
    Dst<Out>::store4(row, v);
  } else {
    if (ok & 1) Dst<Out>::store1(row, v.x);
    if (ok & 2) Dst<Out>::store1(row + step, v.y);
    if (ok & 4) Dst<Out>::store1(row + 2 * step, v.z);
    if (ok & 8) Dst<Out>::store1(row + 3 * step, v.w);
  }
}

__device__ __forceinline__ void mul_add(float4& acc, float w, float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, x.w));
}

// Source row n's four columns as loaded.
template <typename In>
__device__ __forceinline__ typename Src<In>::Raw load_src(const In* row, int64_t step, bool whole, unsigned ok) {
  return whole ? Src<In>::load4(row) : Src<In>::load_each(row, step, ok);
}

// A thread's four columns of a tile: col + k step (k < 4), bit k of ok set
// where the column lies inside the tile, whole where they are four
// consecutive aligned columns, all inside.
struct Group {
  int64_t col, step;
  unsigned ok;
  bool whole;
};

// The first kRing sources of a group: the ring's first fill.
template <typename In>
__device__ __forceinline__ void fill_ring(typename Src<In>::Raw* v, const In* x, int64_t ldx, int N, const Group& q) {
#pragma unroll
  for (int i = 0; i < kRing; ++i)
    if (i < N) v[i] = load_src(x + q.col + i * ldx, q.step, q.whole, q.ok);
}

// One pass of kRows output rows from m0 (kFull: all of them below M) over
// one thread's group of four columns, the pass's weights in shared memory
// (w_s[n kRows + r]: row m0 + r's weight on source n, 0 past M).  The
// sources stream through a ring of kRing loads in flight, filled by the
// caller: source n is refilled with source n + kRing as it is used.  The
// loop over the sources stays rolled (kRing sources a turn), so its code is
// fetched once and reused by every turn and every warp.  Once the last
// source is read, and before the stores, the ring is filled with the first
// sources of the thread's next group (pf), if it has one.
template <typename In, typename Out, int kRows, bool kFull>
__device__ __forceinline__ void combine_pass(const Params& prm, const float* w_s, typename Src<In>::Raw* v,
                                             const In* __restrict__ x, Out* __restrict__ out, int m0,
                                             const Group& q, bool has_pf, const Group& pf) {
  const int M = prm.M, N = prm.N;
  const int64_t ldx = prm.ldx, step = q.step;
  const bool whole = q.whole;
  const unsigned ok = q.ok;
  const In* xq = x + q.col;
  float4 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = make_float4(-0.0f, -0.0f, -0.0f, -0.0f);
  const In* xr = xq + kRing * ldx;  // the row that refills the ring next
#pragma unroll 1
  for (int n0 = 0; n0 < N; n0 += kRing) {
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      const int n = n0 + i;
      if (n < N) {
        const float4 xn = Src<In>::widen(v[i]);
        if (n + kRing < N) v[i] = load_src(xr, step, whole, ok);
        xr += ldx;
        const float* wn = w_s + n * kRows;  // one address for the whole block: a broadcast
        if (kRows % 4 == 0) {
#pragma unroll
          for (int j = 0; j < kRows / 4; ++j) {
            const float4 t = reinterpret_cast<const float4*>(wn)[j];
            mul_add(acc[4 * j], t.x, xn);
            mul_add(acc[4 * j + 1], t.y, xn);
            mul_add(acc[4 * j + 2], t.z, xn);
            mul_add(acc[4 * j + 3], t.w, xn);
          }
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r) mul_add(acc[r], wn[r], xn);
        }
      }
    }
  }
  if (has_pf) fill_ring(v, x, ldx, N, pf);
  Out* oq = out + q.col;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (kFull || m0 + r < M) store_row(oq + (m0 + r) * prm.ldo, step, whole, ok, acc[r]);
}

// Tile t: (first column, end column, p, sid).
__device__ __forceinline__ longlong4 tile_at(const Params& prm, int64_t t) {
  if (prm.tiles == nullptr) {
    const long long c0 = t * kSingleTile;
    return make_longlong4(c0, c0 + kSingleTile < prm.n_cols ? c0 + kSingleTile : prm.n_cols, 0, 0);
  }
  const longlong2* e = reinterpret_cast<const longlong2*>(prm.tiles + 4 * t);
  const longlong2 a = __ldg(e), b = __ldg(e + 1);
  return make_longlong4(a.x, a.y, b.x, b.y);
}

// One step of a block: one pass (output rows m0 .. m0 + kRows - 1) over one
// tile.  vec: the tile's groups are the address-aligned frame's columns
// [f + 4 g, f + 4 g + 4); else group 64 j + t is the columns c0 + 256 j + t
// + 64 k (a tile never holds more than 512).
struct Step {
  int64_t c0, c1, p, sid, f;
  int m0, groups;
  bool vec;
};

template <typename In, typename Out>
__device__ __forceinline__ Step step_at(const Params& prm, int64_t t, int m0) {
  const longlong4 tile = tile_at(prm, t);
  Step st;
  st.c0 = tile.x;
  st.c1 = tile.y;
  st.p = tile.z;
  st.sid = tile.w;
  st.m0 = m0;
  const In* x = static_cast<const In*>(prm.x);
  const Out* out = static_cast<const Out*>(prm.out);
  // every source row, and every output row, at the phase of row 0
  const bool rows_in_phase = (prm.N == 1 || (prm.ldx & 3) == 0) && (prm.M == 1 || (prm.ldo & 3) == 0);
  const int ph_x = static_cast<int>((reinterpret_cast<uintptr_t>(x + st.c0) / sizeof(In)) & 3);
  const int ph_o = static_cast<int>((reinterpret_cast<uintptr_t>(out + st.c0) / sizeof(Out)) & 3);
  st.vec = rows_in_phase && ph_x == ph_o;  // uniform over the block
  st.f = st.vec ? st.c0 - ph_x : st.c0;
  st.groups = st.vec ? static_cast<int>((st.c1 - st.f + 3) / 4)
                     : st.c1 - st.c0 > 4 * kThreads ? kGroups * kThreads : kThreads;
  return st;
}

// Group g of a step's tile.
__device__ __forceinline__ Group group_at(const Step& st, int g) {
  Group q;
  q.col = st.vec ? st.f + 4 * g : st.c0 + (g / kThreads) * 4 * kThreads + g % kThreads;
  q.step = st.vec ? 1 : kThreads;
  q.ok = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) q.ok |= (q.col + k * q.step >= st.c0 && q.col + k * q.step < st.c1) << k;
  q.whole = st.vec && q.ok == 15;
  return q;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

// Starts copying a step's (kRows, N) weights into w_s (dequant: its a, and
// the scale each multiplies into s_s) with cp.async; rows past M get 0.
template <bool kDequant, int kRows>
__device__ __forceinline__ void stage_weights(const Params& prm, const Step& st, float* w_s, float* s_s) {
  if (st.p < 0) return;
  const float* w = prm.w + st.p * prm.ws_p + st.m0 * prm.ws_m;
  const float* s = kDequant ? prm.s + st.sid * prm.ss_col : nullptr;
  for (int e = threadIdx.x; e < kRows * prm.N; e += kThreads) {
    const int n = e / kRows, r = e - n * kRows;
    if (st.m0 + r < prm.M) {
      cp_async4(w_s + e, w + r * prm.ws_m + n * prm.ws_n);
      if (kDequant) cp_async4(s_s + e, s + n * prm.ss_n);
    } else {
      w_s[e] = 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for this thread's copies of a step's weights; dequant: forms its
// elements' a * s (one f32 rounding).  A barrier then makes them the block's.
template <bool kDequant, int kRows>
__device__ __forceinline__ void finish_weights(const Params& prm, const Step& st, float* w_s, const float* s_s) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (!kDequant || st.p < 0) return;
  for (int e = threadIdx.x; e < kRows * prm.N; e += kThreads)
    if (st.m0 + e % kRows < prm.M) w_s[e] = __fmul_rn(w_s[e], s_s[e]);
}


// A block walks its steps: tiles blockIdx.x, + gridDim.x, ..., each in
// passes of kRows output rows.  Software-pipelined: while a step computes,
// the next step's weights copy into the other half of the shared buffers
// (cp.async), and each thread's ring already holds its next group's first
// sources when the group starts (filled at the end of its last pass).  One
// barrier a step: the one after which the step's weights are the block's.
template <typename In, typename Out, bool kDequant, int kRows>
__global__ void __launch_bounds__(kThreads, kMinBlocks) combine_segments_kernel(const Params prm) {
  __shared__ __align__(16) float w_s[2][kMaxSources * kRows];
  __shared__ float s_s[kDequant ? 2 : 1][kDequant ? kMaxSources * kRows : 1];
  const In* x = static_cast<const In*>(prm.x);
  Out* out = static_cast<Out*>(prm.out);
  int64_t t = blockIdx.x;
  if (t >= prm.n_tiles) return;
  Step cur = step_at<In, Out>(prm, t, 0);
  int buf = 0;
  stage_weights<kDequant, kRows>(prm, cur, w_s[0], s_s[0]);
  typename Src<In>::Raw v[kRing];
  bool ready = cur.p >= 0 && threadIdx.x < cur.groups;
  if (ready) fill_ring(v, x, prm.ldx, prm.N, group_at(cur, threadIdx.x));
  for (;;) {
    Step nxt = cur;
    bool has_next = true;
    if (cur.p >= 0 && cur.m0 + kRows < prm.M) {
      nxt.m0 += kRows;
    } else {
      t += gridDim.x;
      has_next = t < prm.n_tiles;
      if (has_next) nxt = step_at<In, Out>(prm, t, 0);
    }
    finish_weights<kDequant, kRows>(prm, cur, w_s[buf], s_s[kDequant ? buf : 0]);
    __syncthreads();  // the step's weights are the block's; the other half is free again
    if (has_next) stage_weights<kDequant, kRows>(prm, nxt, w_s[buf ^ 1], s_s[kDequant ? buf ^ 1 : 0]);
    if (cur.p < 0) {  // a run of columns in no segment
      for (int g = threadIdx.x; g < cur.groups; g += kThreads) {
        const Group q = group_at(cur, g);
        for (int m = 0; m < prm.M; ++m)
          store_row(out + m * prm.ldo + q.col, q.step, q.whole, q.ok, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
      }
    } else {
      const bool full = cur.m0 + kRows <= prm.M;
      for (int g = threadIdx.x; g < cur.groups; g += kThreads) {
        const Group q = group_at(cur, g);
        if (!ready) fill_ring(v, x, prm.ldx, prm.N, q);
        // the ring's next fill: this thread's next group in the step, or its
        // first group of the next step
        const bool more = g + kThreads < cur.groups;
        const bool has_pf = more || (has_next && nxt.p >= 0 && threadIdx.x < nxt.groups);
        const Group pf = more ? group_at(cur, g + kThreads) : group_at(nxt, threadIdx.x);
        if (full)
          combine_pass<In, Out, kRows, true>(prm, w_s[buf], v, x, out, cur.m0, q, has_pf, pf);
        else
          combine_pass<In, Out, kRows, false>(prm, w_s[buf], v, x, out, cur.m0, q, has_pf, pf);
        ready = has_pf;
      }
    }
    if (!has_next) break;
    cur = nxt;
    buf ^= 1;
  }
}

// The blocks of one wave (every SM's resident blocks), or fewer when the
// tiles need fewer.
template <typename Kernel>
cudaError_t one_wave(Kernel kernel, int64_t tiles, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(tiles < wave ? tiles : wave);
  return cudaSuccess;
}

template <typename In, typename Out, bool kDequant, int kRows>
cudaError_t launch_rows(const Params& prm, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = one_wave(combine_segments_kernel<In, Out, kDequant, kRows>, prm.n_tiles, &grid);
  if (err != cudaSuccess) return err;
  combine_segments_kernel<In, Out, kDequant, kRows><<<grid, kThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

// Checks the shape arguments, fills n_tiles for a null table, picks kRows
// (1, 4, 8 or 16 output rows a pass) and launches on `stream`; returns the
// CUDA error, 0 when the launch was accepted.  Does not synchronise and
// allocates nothing.
template <typename In, typename Out, bool kDequant>
int launch(Params prm, void* stream) {
  if (prm.M < 1 || prm.N < 1 || prm.N > kMaxSources || prm.n_cols < 1 ||
      (prm.N > 1 && prm.ldx < prm.n_cols) || (prm.M > 1 && prm.ldo < prm.n_cols) ||
      (kDequant && prm.s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (prm.tiles == nullptr) prm.n_tiles = (prm.n_cols + kSingleTile - 1) / kSingleTile;
  if (prm.n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (prm.M > 8)
    err = launch_rows<In, Out, kDequant, 16>(prm, st);
  else if (prm.M > 4)
    err = launch_rows<In, Out, kDequant, 8>(prm, st);
  else if (prm.M > 1)
    err = launch_rows<In, Out, kDequant, 4>(prm, st);
  else
    err = launch_rows<In, Out, kDequant, 1>(prm, st);
  return static_cast<int>(err);
}

}  // namespace combine_rows
