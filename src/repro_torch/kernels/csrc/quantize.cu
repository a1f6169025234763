// The int8 wire kernels for Hopper (sm_90a): int8_quantize, int8_dequantize
// and dequant_combine.
//
// Replace the Pallas TPU kernels of repro/kernels/quantize.py:
//
//   int8_quantize    q[i] = clip(floor(x[i] * (1 / s) + u[i]), -127, 127)
//   int8_dequantize  out[i] = q[i] * s
//   dequant_combine  out[m, i] = sum_n w[m, n] * q[n, i],  w = a * scales
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
// dequant_combine reads N n int8 and writes 4 M n (1 flop per byte or less).
//
// Design: the two streams are grid-stride loops, one element per thread and
// step, every access coalesced; the scale is read once per thread.
// dequant_combine is csrc/combine_rows.cuh with int8 input: the tile of q
// is staged in shared memory once and every output agent's row is combined
// from it, so the dequantized f32 neighbours never reach device memory.

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

// w is the (M, N) f32 product a * scales, formed by the wrapper as the
// reference forms it outside its Pallas body.
extern "C" int dequant_combine_rows(const void* w, const void* q, void* out, int M, int N,
                                    int64_t n_cols, int64_t ldq, void* stream) {
  return combine_rows::launch<int8_t, float>(w, q, out, M, N, n_cols, ldq, stream);
}
