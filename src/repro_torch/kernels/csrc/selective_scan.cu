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
// exponentials bound it.  expf is the accurate one (no --use_fast_math): a
// faster __expf would move the results.
//
// Design: the TPU kernel carries h (di, ds) in VMEM scratch across a
// SEQUENTIAL grid of 64-step chunks.  CUDA blocks run in no order, so each
// thread owns one (b, d) channel and loops over all S itself, its ds states
// and its row of A in registers; y needs no reduction across threads.  A
// block of 64 channels of one batch row stages each 16-step chunk of B_t and
// C_t in shared memory (every channel reads them) and loads the chunk's dt
// and x into registers before it computes, so the loads of a chunk are in
// flight together; neighbouring threads read neighbouring channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kMaxState = 16;  // largest ds the kernel takes
constexpr int kChunk = 16;     // time steps staged at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TX>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ Bm,
                      const float* __restrict__ Cm, const TX* __restrict__ x, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int di, int ds) {
  __shared__ float sB[kChunk * kMaxState];
  __shared__ float sC[kChunk * kMaxState];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < di;

  float a[kMaxState], h[kMaxState];
#pragma unroll
  for (int s = 0; s < kMaxState; ++s) {
    a[s] = active && s < ds ? A[static_cast<int64_t>(d) * ds + s] : 0.0f;
    h[s] = 0.0f;
  }

  const int64_t row0 = static_cast<int64_t>(b) * S;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk's reads of sB and sC are done
    for (int i = threadIdx.x; i < n * ds; i += kThreads) {
      const int tt = i / ds, s = i % ds;
      sB[tt * kMaxState + s] = Bm[(row0 + t0) * ds + i];
      sC[tt * kMaxState + s] = Cm[(row0 + t0) * ds + i];
    }
    __syncthreads();
    if (!active) continue;

    float dtv[kChunk], xv[kChunk];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < n) {
        const int64_t off = (row0 + t0 + tt) * di + d;
        dtv[tt] = dt[off];
        xv[tt] = to_f32(x[off]);
      }
    }
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < n) {
        const float dx = dtv[tt] * xv[tt];
        float acc = 0.0f;
#pragma unroll
        for (int s = 0; s < kMaxState; ++s) {
          if (s < ds) {
            const float abar = expf(dtv[tt] * a[s]);
            h[s] = abar * h[s] + dx * sB[tt * kMaxState + s];
            acc += h[s] * sC[tt * kMaxState + s];
          }
        }
        y[(row0 + t0 + tt) * di + d] = acc;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < kMaxState; ++s)
      if (s < ds) h_last[(static_cast<int64_t>(b) * di + d) * ds + s] = h[s];
  }
}

}  // namespace

// One launch on `stream` (a cudaStream_t).  x_dtype: 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 when it was accepted); does
// not synchronise and allocates nothing.
extern "C" int selective_scan_fwd(const void* dt, const void* A, const void* Bm, const void* Cm, const void* x,
                                  int x_dtype, void* y, void* h_last, int B, int S, int di, int ds,
                                  void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || ds < 1 || ds > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  if (x_dtype == 0) {
    selective_scan_kernel<float><<<grid, kThreads, 0, s>>>(dtf, Af, Bf, Cf, static_cast<const float*>(x), yf, hf,
                                                           S, di, ds);
  } else if (x_dtype == 1) {
    selective_scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        dtf, Af, Bf, Cf, static_cast<const __nv_bfloat16*>(x), yf, hf, S, di, ds);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
