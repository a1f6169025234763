// combine_rows.cuh: the batched neighbour combine shared by weighted_combine
// (csrc/combine.cu) and dequant_combine (csrc/quantize.cu).
//
//   out[m, i] = sum_n w[m, n] * x[n, i]      (m < M, n < N, i < n_cols)
//
// summed in the Pallas bodies' order: acc = w[m, 0] * x[0, i], then
// acc += w[m, j] * x[j, i] for j = 1 .. N - 1, product and sum rounded
// apart (__fmul_rn, __fadd_rn: nvcc would otherwise contract them into an
// fma), so the kernels equal their plain PyTorch versions bit for bit.
//
// Design: one 128-thread block per 128 columns.  The block stages its N x
// 128 tile of x in shared memory once (each row load is 128 contiguous
// elements across the block, coalesced; kRows loads in flight per thread,
// not one load waiting on the last), so x is read from device memory once
// whatever M is.  It then walks the M output rows kRows at a time:
// the chunk's weights go to shared memory (one address for the whole block
// at each read: a broadcast), and every thread keeps kRows accumulators of
// its column in registers, so each step over n issues kRows independent
// products instead of one dependent chain (a chain of N dependent loads
// and adds per row leaves a small grid latency-bound).  Each output byte
// is written once (coalesced).  x rows may sit ldx elements apart (a
// column slice of a slab, no copy); out is contiguous (M, n_cols).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace combine_rows {

constexpr int kCols = 128;
// Largest N taken: the N x 128 f32 tile fills 32 KB of shared memory.  The
// Python wrappers check the same limit (MAX_SOURCES).
constexpr int kMaxSources = 64;
constexpr int kRows = 16;  // output rows a thread accumulates at once, in registers

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load(const int8_t* p) { return static_cast<float>(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename In, typename Out>
__global__ void __launch_bounds__(kCols)
combine_rows_kernel(const float* __restrict__ w, const In* __restrict__ x, Out* __restrict__ out,
                    int M, int N, int64_t n_cols, int64_t ldx) {
  __shared__ float x_s[kMaxSources * kCols];  // x_s[n * 128 + t] = x[n, i]
  __shared__ float w_s[kRows * kMaxSources];  // w_s[r * N + n] = w[m0 + r, n]
  const int t = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kCols + t;
  const bool live = i < n_cols;
  for (int n0 = 0; n0 < N; n0 += kRows) {  // kRows loads in flight, then their stores
    float v[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) v[j] = live && n0 + j < N ? load(x + (n0 + j) * ldx + i) : 0.0f;
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (n0 + j < N) x_s[(n0 + j) * kCols + t] = v[j];
  }
  for (int m0 = 0; m0 < M; m0 += kRows) {
    const int rows = min(kRows, M - m0);
    __syncthreads();  // the previous chunk's weights are read
    for (int e = t; e < kRows * N; e += kCols)
      w_s[e] = e < rows * N ? w[static_cast<int64_t>(m0) * N + e] : 0.0f;
    __syncthreads();
    float acc[kRows];
    const float x0 = x_s[t];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = __fmul_rn(w_s[r * N], x0);
    for (int n = 1; n < N; ++n) {
      const float xn = x_s[n * kCols + t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(w_s[r * N + n], xn));
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) store(out + static_cast<int64_t>(m0 + r) * n_cols + i, acc[r]);
    }
  }
}

// Launches on `stream` and returns cudaGetLastError(): 0 when the launch was
// accepted.  Does not synchronise and allocates nothing.
template <typename In, typename Out>
int launch(const void* w, const void* x, void* out, int M, int N, int64_t n_cols, int64_t ldx,
           void* stream) {
  if (M < 1 || N < 1 || N > kMaxSources || n_cols < 1 || ldx < n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_cols + kCols - 1) / kCols;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  combine_rows_kernel<In, Out><<<static_cast<unsigned>(blocks), kCols, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const In*>(x), static_cast<Out*>(out), M, N,
      n_cols, ldx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace combine_rows
