// weighted_combine: the batched weighted neighbour combine for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/combine.py::weighted_combine.
//
//   out[m, i] = sum_n a[m, n] * xs[n, i]
//
// a is (M, N) f32, contiguous; xs is (N, n) f32 or bf16 with rows ldx
// elements apart (each row contiguous); out is (M, n) contiguous in xs's
// dtype, accumulated in f32.  The TPU kernel takes one weight vector
// (M = 1); the reference's per-slot consensus combine vmaps it over the
// output agents, which here is one launch with M = K weight rows.
//
// Bound: device memory.  A call must read N n input elements and write M n
// output elements (N = M = 16 on the K=16 slab: 2 M N n flops against 8 M n
// bytes in f32, 4 flops per byte, far below the H100's ~20 f32 flops per
// byte of HBM bandwidth).
//
// Design: csrc/combine_rows.cuh (one 128-column tile of xs staged in shared
// memory, read from device memory once; the M rows walked from it; the
// Pallas body's summation order, product and sum rounded apart).

#include "combine_rows.cuh"

// xs_bf16 = 0: xs and out are f32; 1: both bf16.
extern "C" int weighted_combine_rows(const void* a, const void* xs, void* out, int M, int N,
                                     int64_t n_cols, int64_t ldx, int xs_bf16, void* stream) {
  if (xs_bf16)
    return combine_rows::launch<__nv_bfloat16, __nv_bfloat16>(a, xs, out, M, N, n_cols, ldx,
                                                              stream);
  return combine_rows::launch<float, float>(a, xs, out, M, N, n_cols, ldx, stream);
}
