// weighted_combine: the batched weighted neighbour combine for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/combine.py::weighted_combine.
//
//   out[m, c] = sum_n W_p[m, n] * xs[n, c]   over a table of column segments
//
// in ONE launch.  The TPU kernel takes one weight vector (M = 1); the
// reference's per-slot consensus combine vmaps it over the output agents and
// calls it once per layer slot, which here is one launch over every slot's
// columns, each slot with its own (K, K) matrix (M = N = K).  The single call
// of the kernel API is the one-segment case.  xs is f32 or bf16 (out in the
// same dtype, accumulated in f32).
//
// Bound: device memory.  The per-slot call reads 4 K D bytes and writes 4 K D
// (K = 16 on the K=16 slab: 2 K^2 D flops against 8 K D bytes, 4 flops per
// byte, far below the H100's ~20 f32 flops per byte of HBM bandwidth).
//
// Design: csrc/combine_rows.cuh (four columns a thread, vector loads and
// stores where a segment's rows are aligned, weights through __ldg; the
// Pallas body's summation order, product and sum rounded apart).

#include "combine_rows.cuh"

// w: the stacked (P, M, N) weights through their element strides; tiles: the
// (n_tiles, 4) int64 tile table, or null for one segment over [0, n_cols).
// xs_bf16 = 0: xs and out are f32; 1: both bf16.  Launches on `stream` and
// returns the CUDA error: 0 when the launch was accepted.
extern "C" int weighted_combine_segments(const void* w, int ws_p, int ws_m, int ws_n, const void* xs,
                                         int64_t ldx, void* out, int64_t ldo, const void* tiles,
                                         int64_t n_tiles, int64_t n_cols, int M, int N, int xs_bf16,
                                         void* stream) {
  combine_rows::Params prm{};
  prm.w = static_cast<const float*>(w);
  prm.x = xs;
  prm.out = out;
  prm.tiles = static_cast<const int64_t*>(tiles);
  prm.ldx = ldx;
  prm.ldo = ldo;
  prm.n_tiles = n_tiles;
  prm.n_cols = n_cols;
  prm.ws_p = ws_p;
  prm.ws_m = ws_m;
  prm.ws_n = ws_n;
  prm.M = M;
  prm.N = N;
  if (xs_bf16) return combine_rows::launch<__nv_bfloat16, __nv_bfloat16, false>(prm, stream);
  return combine_rows::launch<float, float, false>(prm, stream);
}
