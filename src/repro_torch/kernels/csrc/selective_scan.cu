// selective_scan: the Mamba-1 selective scan (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/selective_scan.py::selective_scan.
//
//   h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t,   y_t = <h_t, C_t>,   h_0 = 0
//
// per batch row b and channel d, with the state h (ds values) carried over
// the whole sequence.  dt (B, S, di) f32, A (di, ds) f32 (already -exp(A_log)),
// B and C (B, S, ds) f32, x (B, S, di) f32 or bf16; writes y (B, S, di) f32
// and the last state h_last (B, di, ds) f32, which the decode step starts
// from (the TPU kernel returns y only).  All contiguous; ds <= 16.
//
// Bound: at the falcon-mamba-7b prefill shape (B 4, S 2048, di 8192, ds 16,
// x bf16) a call moves 0.67 GB (dt and y f32, x bf16) and evaluates
// B S di ds = 1.07e9 exponentials: at 16 exp per clock per SM (the SM's
// multi-function units) that is 0.26 ms against 0.20 ms of bytes, so the
// exponentials bound it.  expf is the accurate one (no --use_fast_math), the
// one the plain version's torch.exp runs, so both see the same exp(dt A): it
// is 8 instructions around its MUFU.EX2, and with the product, the state
// update and y's multiply-add a state-step issues about 12 instructions, so
// instruction issue (~0.4 ms at this shape) sits above the exponentials.
//
// Design: the TPU kernel carries h (di, ds) in VMEM scratch across a
// SEQUENTIAL grid of 64-step chunks.  CUDA blocks run in no order, so each
// (b, d) channel scans all S itself; what the card needs is enough warps to
// hide latency and loads that never stall the scan.
//   * A channel's states are spread over G lanes (1 or 2, a template
//     parameter the wrapper picks by the grid's size), NSL states each, in
//     registers with their row of A.  With 2, y_t is reduced over the lanes
//     with __shfl_xor_sync, in a fixed order, so two runs give the same
//     bits.  A block is kThreads lanes: kThreads/G channels of one batch
//     row.  One lane a channel issues the fewest instructions (no shuffle,
//     one load of dt and x for 16 states) but needs ~2 blocks an SM to hide
//     the scan's latency; below that 2 lanes are faster.
//   * Time tiles are prefetched: a ring of kStages shared-memory stages holds
//     kTile steps of the block's dt and x and of B_t and C_t (which every
//     channel of the row reads); cp.async fills the stage of tile k+2 while
//     tile k computes, so a step reads shared memory only.  One
//     __syncthreads per tile.  A whole tile of a whole block whose rows all
//     start 16-byte aligned (di a multiple of 4, 8 for bf16 x; ds 16;
//     aligned operands) goes in 16-byte pieces; otherwise cp.async copies 4
//     bytes a thread (any di, any offset of an f32 operand), bf16 x in
//     pairs when di is even and x 4-byte aligned, else element by element
//     with plain loads.
//   * The tile loop is unrolled 8 steps: unrolled whole, 16 steps of 16
//     states a lane are ~3,400 instructions, and that measured slower.
//   * y_t goes to the stage's y tile (a shared store a step, no branch);
//     after the tile each warp stores its channels' rows, float4s along a
//     row when di % 4 == 0.
//   * State columns ds..15 of B and C are zero in every stage, and A's are
//     0, so a lane's padding states stay 0 and add nothing to y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // lanes per block: kThreads / G channels of G lanes
constexpr int kMaxState = 16;  // largest ds the kernel takes
constexpr int kTile = 16;      // time steps per stage
constexpr int kStages = 3;     // ring depth: tiles k+1 and k+2 load while tile k computes

template <typename TX, int G>
struct __align__(16) Stage {
  static constexpr int kChannels = kThreads / G;
  float B[kTile][kMaxState];  // 16-byte aligned rows for vector reads
  float C[kTile][kMaxState];
  float y[kTile][kChannels];  // the tile's outputs, stored row by row after it
  float dt[kTile][kChannels];
  TX x[kTile][kChannels];
};

// Blocks per SM the registers are sized for: with G lanes a channel the
// grid has B di G / kThreads blocks, at B 4, di 8192 about 2 and 4 per SM
// for G = 1 and 2.
template <int G>
constexpr int min_blocks() {
  return G == 1 ? 2 : 4;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of `n` steps (rows row0.. of the (B S) axis) of the
// block's channels d0..d0+nc-1 into `st`; FULL: n == kTile, no row test.
// Each thread walks its rows with a pointer.
template <typename TX, int G, bool FULL>
__device__ __forceinline__ void load_tile(Stage<TX, G>& st, const float* dt, const float* Bm, const float* Cm,
                                          const TX* x, int64_t row0, int n, int di, int d0, int nc, int ds,
                                          bool x_pairs) {
  constexpr int CB = kThreads / G;
  const int tid = threadIdx.x;
  // dt, and x when it is f32 or not copied in pairs: channel tid % CB, rows tid / CB + G q
  const int c = tid % CB, r0 = tid / CB;
  if (c < nc) {
    const int64_t off = (row0 + r0) * di + d0 + c, step = static_cast<int64_t>(G) * di;
    const float* src = dt + off;
    const TX* xsrc = x + off;
#pragma unroll
    for (int q = 0; q < kTile / G; ++q, src += step, xsrc += step) {
      const int r = r0 + q * G;
      if (FULL || r < n) {
        cp_async4(&st.dt[r][c], src);
        if constexpr (std::is_same<TX, float>::value) {
          cp_async4(&st.x[r][c], xsrc);
        } else if (!x_pairs) {
          st.x[r][c] = *xsrc;
        }
      }
    }
  }
  if constexpr (!std::is_same<TX, float>::value) {
    if (x_pairs) {  // bf16 pairs: pair tid % P, rows tid / P + kRows q
      constexpr int P = CB / 2, kRows = kThreads / P;
      static_assert(kTile % kRows == 0, "whole passes of pair rows");
      const int p = tid % P, rp = tid / P;
      if (2 * p < nc) {
        const TX* src = x + (row0 + rp) * di + d0 + 2 * p;
        const int64_t step = static_cast<int64_t>(kRows) * di;
#pragma unroll
        for (int q = 0; q < kTile / kRows; ++q, src += step)
          if (FULL || rp + q * kRows < n) cp_async4(&st.x[rp + q * kRows][2 * p], src);
      }
    }
  }
  // B and C: state tid % 16, rows tid / 16 + 8 q
  constexpr int kRowsBC = kThreads / kMaxState;
  const int s = tid % kMaxState, rb = tid / kMaxState;
  if (s < ds) {
    const float* bsrc = Bm + (row0 + rb) * ds + s;
    const float* csrc = Cm + (row0 + rb) * ds + s;
#pragma unroll
    for (int q = 0; q < kTile / kRowsBC; ++q, bsrc += kRowsBC * ds, csrc += kRowsBC * ds) {
      if (FULL || rb + q * kRowsBC < n) {
        cp_async4(&st.B[rb + q * kRowsBC][s], bsrc);
        cp_async4(&st.C[rb + q * kRowsBC][s], csrc);
      }
    }
  }
}

// Copy kTile rows of kBytes (a multiple of 16) from src, rows src_stride
// bytes apart, to dst, rows packed, in 16-byte pieces spread over the block.
template <int kBytes>
__device__ __forceinline__ void copy_rows16(void* dst, const void* src, int64_t src_stride) {
  constexpr int kPieces = kBytes / 16, kTotal = kTile * kPieces;
#pragma unroll
  for (int i0 = 0; i0 < kTotal; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    if (kTotal % kThreads == 0 || i < kTotal) {
      const int r = i / kPieces, q = i % kPieces;
      cp_async16(static_cast<char*>(dst) + r * kBytes + q * 16,
                 static_cast<const char*>(src) + r * src_stride + q * 16);
    }
  }
}

// load_tile for a whole tile of a whole block with every row 16-byte
// aligned (di a multiple of 16 bytes' elements, ds 16, aligned operands):
// 16-byte copies.
template <typename TX, int G>
__device__ __forceinline__ void load_tile16(Stage<TX, G>& st, const float* dt, const float* Bm, const float* Cm,
                                            const TX* x, int64_t row0, int di, int d0) {
  constexpr int CB = kThreads / G;
  const int64_t off = row0 * di + d0;
  copy_rows16<CB * 4>(&st.dt[0][0], dt + off, static_cast<int64_t>(di) * 4);
  copy_rows16<CB * static_cast<int>(sizeof(TX))>(&st.x[0][0], x + off, static_cast<int64_t>(di) * sizeof(TX));
  copy_rows16<kMaxState * 4>(&st.B[0][0], Bm + row0 * kMaxState, kMaxState * 4);
  copy_rows16<kMaxState * 4>(&st.C[0][0], Cm + row0 * kMaxState, kMaxState * 4);
}

template <int NSL>
__device__ __forceinline__ void load_states(float (&v)[NSL], const float* p) {
  if constexpr (NSL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NSL; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (NSL == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// One step of one lane: its NSL states of channel c, then y reduced over the
// channel's G lanes (the butterfly leaves the same sum in each of them, and
// each writes it to the stage's y row).
template <typename TX, int G, int NSL>
__device__ __forceinline__ void scan_step(Stage<TX, G>& st, int tt, int c, int j, const float (&a)[NSL],
                                          float (&h)[NSL]) {
  const float dtv = st.dt[tt][c];
  const float dx = dtv * to_f32(st.x[tt][c]);
  float bv[NSL], cv[NSL];
  load_states<NSL>(bv, &st.B[tt][j * NSL]);
  load_states<NSL>(cv, &st.C[tt][j * NSL]);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < NSL; ++i) {
    h[i] = fmaf(expf(dtv * a[i]), h[i], dx * bv[i]);
    acc = fmaf(h[i], cv[i], acc);
  }
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  st.y[tt][c] = acc;
}

// Store the first n rows of a warp's channels of the stage's y tile to
// y_t0 (y at step t0, channel 0).  A whole tile of a warp whose channels
// all exist goes as float4s along rows when di % 4 == 0 (then d0 + c0 is a
// multiple of 4 and y, a fresh allocation, is 16-byte aligned).
template <typename TX, int G>
__device__ __forceinline__ void store_y(const Stage<TX, G>& st, float* y_t0, int n, int di, int d0, int nc) {
  constexpr int CW = 32 / G;  // a warp's channels
  const int lane = threadIdx.x & 31;
  const int c0 = (threadIdx.x >> 5) * CW;
  if (n == kTile && c0 + CW <= nc && di % 4 == 0) {
    constexpr int Q = CW / 4, R = 32 / Q;  // float4s a row, rows a pass
    const int r = lane / Q, c = c0 + 4 * (lane % Q);
    float* dst = y_t0 + static_cast<int64_t>(r) * di + d0 + c;
    const int64_t step = static_cast<int64_t>(R) * di;
#pragma unroll
    for (int m = 0; m < (kTile + R - 1) / R; ++m, dst += step)
      if (R <= kTile || r < kTile)
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&st.y[r + m * R][c]);
  } else {
    for (int i = lane; i < kTile * CW; i += 32) {
      const int r = i / CW, c = c0 + i % CW;
      if (r < n && c < nc) y_t0[static_cast<int64_t>(r) * di + d0 + c] = st.y[r][c];
    }
  }
}

template <typename TX, int G, int NSL>
__global__ void __launch_bounds__(kThreads, min_blocks<G>())
selective_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ Bm,
                      const float* __restrict__ Cm, const TX* __restrict__ x, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int di, int ds, int x_pairs, int aligned16) {
  constexpr int CB = kThreads / G;
  using St = Stage<TX, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  St* stages = reinterpret_cast<St*>(smem);
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CB;
  const int nc = min(CB, di - d0);
  const int c = threadIdx.x / G;  // the lane's channel in the block
  const int j = threadIdx.x % G;  // its place in the channel's group: states j NSL ..
  const int d = d0 + c;
  const bool active = c < nc;

  // the state columns ds.. are never copied: zero them in every stage
  for (int i = threadIdx.x; i < kStages * kTile * kMaxState; i += kThreads) {
    const int s = i % kMaxState;
    if (s >= ds) {
      St& st = stages[i / (kTile * kMaxState)];
      st.B[(i / kMaxState) % kTile][s] = 0.0f;
      st.C[(i / kMaxState) % kTile][s] = 0.0f;
    }
  }

  float a[NSL], h[NSL];
#pragma unroll
  for (int i = 0; i < NSL; ++i) {
    const int s = j * NSL + i;
    a[i] = active && s < ds ? A[static_cast<int64_t>(d) * ds + s] : 0.0f;
    h[i] = 0.0f;
  }

  const int64_t row_b = static_cast<int64_t>(b) * S;
  const int n_tiles = (S + kTile - 1) / kTile;
  const bool vec16 = aligned16 && nc == CB;
  const auto load = [&](int k) {  // one commit group per tile, empty past the end
    const int64_t row0 = row_b + static_cast<int64_t>(k) * kTile;
    if (k * kTile + kTile <= S && vec16)
      load_tile16<TX, G>(stages[k % kStages], dt, Bm, Cm, x, row0, di, d0);
    else if (k * kTile + kTile <= S)
      load_tile<TX, G, true>(stages[k % kStages], dt, Bm, Cm, x, row0, kTile, di, d0, nc, ds, x_pairs != 0);
    else if (k < n_tiles)
      load_tile<TX, G, false>(stages[k % kStages], dt, Bm, Cm, x, row0, S - k * kTile, di, d0, nc, ds,
                              x_pairs != 0);
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) load(k);

  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile k have landed
    __syncthreads();               // everyone's have, and tile k-1's stage is free
    load(k + kStages - 1);
    St& st = stages[k % kStages];
    const int t0 = k * kTile;
    const int n = min(kTile, S - t0);
    if (n == kTile) {
#pragma unroll 8
      for (int tt = 0; tt < kTile; ++tt) scan_step<TX, G, NSL>(st, tt, c, j, a, h);
    } else {
#pragma unroll 1
      for (int tt = 0; tt < n; ++tt) scan_step<TX, G, NSL>(st, tt, c, j, a, h);
    }
    __syncwarp();  // a warp stores the y rows of its own channels
    store_y<TX, G>(st, y + (row_b + t0) * di, n, di, d0, nc);
  }
  if (active) {
    float* hp = h_last + (static_cast<int64_t>(b) * di + d) * ds;
#pragma unroll
    for (int i = 0; i < NSL; ++i)
      if (j * NSL + i < ds) hp[j * NSL + i] = h[i];
  }
}

template <typename TX>
struct Args {
  const float *dt, *A, *Bm, *Cm;
  const TX* x;
  float *y, *h_last;
  int B, S, di, ds, x_pairs, aligned16;
  cudaStream_t stream;
};

template <typename TX, int G, int NSL>
cudaError_t launch(const Args<TX>& a) {
  const auto kern = selective_scan_kernel<TX, G, NSL>;
  const int smem = kStages * static_cast<int>(sizeof(Stage<TX, G>));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int CB = kThreads / G;
  const dim3 grid((a.di + CB - 1) / CB, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(a.dt, a.A, a.Bm, a.Cm, a.x, a.y, a.h_last, a.S, a.di, a.ds, a.x_pairs,
                                                    a.aligned16);
  return cudaGetLastError();
}

// The instance with `nsl` states a lane, for NSL = 1, 2, 4, .. while G NSL <= 16.
template <typename TX, int G, int NSL = 1>
cudaError_t launch_states(const Args<TX>& a, int nsl) {
  if constexpr (G * NSL <= kMaxState) {
    if (nsl == NSL) return launch<TX, G, NSL>(a);
    return launch_states<TX, G, NSL * 2>(a, nsl);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t launch_lanes(const Args<TX>& a, int lanes) {
  // states a lane: the smallest power of two with lanes * nsl >= ds
  int nsl = 1;
  while (lanes * nsl < a.ds) nsl *= 2;
  switch (lanes) {
    case 1: return launch_states<TX, 1>(a, nsl);
    case 2: return launch_states<TX, 2>(a, nsl);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch on `stream` (a cudaStream_t), `lanes` (1 or 2) lanes a
// channel.  x_dtype: 0 = f32, 1 = bf16.  Returns cudaGetLastError() after the
// launch (0 when it was accepted); does not synchronise and allocates nothing.
extern "C" int selective_scan_fwd(const void* dt, const void* A, const void* Bm, const void* Cm, const void* x,
                                  int x_dtype, void* y, void* h_last, int B, int S, int di, int ds, int lanes,
                                  void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || ds < 1 || ds > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // every row of dt, x, B and C starts 16-byte aligned: whole tiles take 16-byte copies
  const bool rows16 = ds == kMaxState && di % 4 == 0 && a16(dt) && a16(Bm) && a16(Cm) && a16(x);
  if (x_dtype == 0) {
    const Args<float> a{dtf, Af, Bf, Cf, static_cast<const float*>(x), yf, hf, B, S, di, ds, 0, rows16, s};
    return static_cast<int>(launch_lanes(a, lanes));
  }
  if (x_dtype == 1) {
    const int pairs = di % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
    const Args<__nv_bfloat16> a{dtf, Af, Bf, Cf, static_cast<const __nv_bfloat16*>(x), yf, hf, B, S, di, ds, pairs,
                                rows16 && di % 8 == 0, s};
    return static_cast<int>(launch_lanes(a, lanes));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
