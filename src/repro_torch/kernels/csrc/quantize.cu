// The int8 wire kernels for Hopper (sm_90a): int8_quantize, int8_dequantize
// and dequant_combine.
//
// Replace the Pallas TPU kernels of repro/kernels/quantize.py:
//
//   int8_quantize    q[i] = clip(floor(x[i] * (1 / s) + u[i]), -127, 127)
//   int8_dequantize  out[i] = q[i] * s
//   dequant_combine  out[m, c] = sum_n (a[m, n] * s[n]) * q[n, c]  over a
//                    table of column segments, each with its own a and s
//
// s is one f32 scale on the device (int8_quantize: absmax / 127, computed by
// the wrapper with a torch reduction, as the reference computes it outside
// its Pallas body); u is the f32 uniform field, an operand as in the TPU
// kernel's body.  int8_quantize computes 1 / s in f32 (IEEE division: the
// build has no --use_fast_math) and rounds the product and the sum apart
// (__fmul_rn, __fadd_rn), so it equals its plain PyTorch version bit for
// bit; nvcc would otherwise contract x * inv + u into an fma.
//
// Bound: device memory.  int8_quantize reads 4 n bytes of x (2 n in bf16 or
// f16) and 4 n of u and writes n; int8_dequantize reads n and writes 4 n;
// dequant_combine reads N n int8 and writes 4 M n (the per-slot call on the
// K=16 slab: 2 K^2 D flops against 5 K D bytes, about 6 flops per byte).
//
// Design: the two streams are grid-stride loops, one element per thread and
// step, every access coalesced; the scale is read once per thread.
// dequant_combine is csrc/combine_rows.cuh with int8 input (one 4-byte load
// a source per four columns where a segment is aligned): every output agent's
// row is combined from the int8 values in registers, so the dequantized f32
// neighbours never reach device memory.  The reference's per-(slot, leaf)
// combine is one launch over all its pieces, each with its layer's matrix and
// its leaf's scale column, and the columns in no piece (lane padding) are
// written 0 by the same launch.

#include <cuda_fp16.h>

#include "combine_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kQmax = 127.0f;

__device__ __forceinline__ float load_any(const void* x, int dtype, int64_t i) {
  if (dtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  if (dtype == 2) return __half2float(static_cast<const __half*>(x)[i]);
  return static_cast<const float*>(x)[i];
}

__global__ void __launch_bounds__(kThreads)
int8_quantize_kernel(const void* __restrict__ x, int dtype, const float* __restrict__ u,
                     const float* __restrict__ s, int8_t* __restrict__ q, int64_t n) {
  const float inv = 1.0f / s[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    const float y = __fadd_rn(__fmul_rn(load_any(x, dtype, i), inv), u[i]);
    q[i] = static_cast<int8_t>(fminf(fmaxf(floorf(y), -kQmax), kQmax));
  }
}

__global__ void __launch_bounds__(kThreads)
int8_dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                       float* __restrict__ out, int64_t n) {
  const float scale = s[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride)
    out[i] = __fmul_rn(static_cast<float>(q[i]), scale);
}

// Enough blocks to fill the card several times over; the grid-stride loop
// takes the rest.
int grid_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 16 ? want : 132 * 16);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError(): 0
// when the launch was accepted.  None synchronises or allocates.

// x_dtype: 0 f32, 1 bf16, 2 f16.
extern "C" int int8_quantize_i8(const void* x, int x_dtype, const void* u, const void* s, void* q,
                                int64_t n, void* stream) {
  if (n < 1 || x_dtype < 0 || x_dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  int8_quantize_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_dtype, static_cast<const float*>(u), static_cast<const float*>(s),
      static_cast<int8_t*>(q), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int int8_dequantize_f32(const void* q, const void* s, void* out, int64_t n,
                                   void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int8_dequantize_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// a: the stacked (P, M, N) off-diagonal weights through their element
// strides; s: the scales, source n's in column sid at s[n ss_n + sid ss_col]
// (the kernel forms a[m, n] * s[n] with one f32 rounding, as the plain
// version does); tiles: the (n_tiles, 4) int64 tile table, or null for one
// segment over [0, n_cols).
extern "C" int dequant_combine_segments(const void* a, int ws_p, int ws_m, int ws_n, const void* s, int ss_n,
                                        int ss_col, const void* q, int64_t ldq, void* out, int64_t ldo,
                                        const void* tiles, int64_t n_tiles, int64_t n_cols, int M, int N,
                                        void* stream) {
  combine_rows::Params prm{};
  prm.w = static_cast<const float*>(a);
  prm.s = static_cast<const float*>(s);
  prm.x = q;
  prm.out = out;
  prm.tiles = static_cast<const int64_t*>(tiles);
  prm.ldx = ldq;
  prm.ldo = ldo;
  prm.n_tiles = n_tiles;
  prm.n_cols = n_cols;
  prm.ws_p = ws_p;
  prm.ws_m = ws_m;
  prm.ws_n = ws_n;
  prm.ss_n = ss_n;
  prm.ss_col = ss_col;
  prm.M = M;
  prm.N = N;
  return combine_rows::launch<int8_t, float, true>(prm, stream);
}
