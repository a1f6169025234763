// drt_dist: fused DRT distance statistics for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/drt_dist.py::drt_dist.
//
//   out[0] = sum_i (x[i] - y[i])^2,   out[1] = sum_i y[i]^2
//
// over n f32 elements (any n >= 1; x, y and out contiguous).  The permute
// consensus engine calls it once per DRT layer slot and neighbour: x is the
// agent's own (decoded) layer segment, y the neighbour's, and out[1] is the
// NEIGHBOUR's squared norm.
//
// Bound: device memory, and at the engine's sizes launch latency.  A call
// reads 8 n bytes and does 5 n flops (0.6 flops per byte); the layer slots
// of the width-16 ResNet-20 hold 512..78,080 columns, so one call moves at
// most 0.62 MB (0.19 us at 3.35 TB/s) and its two launches dominate.
//
// Design: the TPU kernel carries both sums across a SEQUENTIAL grid in VMEM
// scratch and writes them on the last step.  CUDA blocks run in no fixed
// order, so the reduction is restructured into two launches, no atomics:
//   1. drt_dist_partial_kernel: a grid-stride pass; each thread sums its
//      elements in index order, each block reduces its threads in a fixed
//      tree (warp shuffles, then the warps in shared memory) and writes one
//      (d2, n2) pair;
//   2. drt_dist_finalize_kernel: one block sums the per-block pairs in the
//      same fixed order and writes out.
// The block count depends on n alone (the wrapper computes it), so two runs
// on the same inputs give identical bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The wrapper sizes the grid at one block per kThreads * 8 elements, capped
// here; drt_dist_f32 refuses more.
constexpr int kMaxBlocks = 1024;

// Fixed-order sum of (a, b) over the block; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* sh) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[2 * warp] = a;
    sh[2 * warp + 1] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    a = lane < n_warps ? sh[2 * lane] : 0.0f;
    b = lane < n_warps ? sh[2 * lane + 1] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
drt_dist_partial_kernel(const float* __restrict__ x, const float* __restrict__ y, int64_t n,
                        float* __restrict__ partial) {
  __shared__ float sh[2 * (kThreads / 32)];
  float d2 = 0.0f, n2 = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    const float yv = y[i];
    const float d = x[i] - yv;
    d2 = fmaf(d, d, d2);
    n2 = fmaf(yv, yv, n2);
  }
  block_sum2(d2, n2, sh);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = d2;
    partial[2 * blockIdx.x + 1] = n2;
  }
}

__global__ void __launch_bounds__(kThreads)
drt_dist_finalize_kernel(const float* __restrict__ partial, int n_blocks, float* __restrict__ out) {
  __shared__ float sh[2 * (kThreads / 32)];
  float d2 = 0.0f, n2 = 0.0f;
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) {
    d2 += partial[2 * i];
    n2 += partial[2 * i + 1];
  }
  block_sum2(d2, n2, sh);
  if (threadIdx.x == 0) {
    out[0] = d2;
    out[1] = n2;
  }
}

}  // namespace

// Two launches on `stream` (a cudaStream_t): the partial pass into
// `partial` (2 * n_blocks floats of scratch) and the finalize into `out`
// (2 floats).  Returns cudaGetLastError() after the launches: 0 when both
// were accepted.  Does not synchronise and allocates nothing.
extern "C" int drt_dist_f32(const void* x, const void* y, int64_t n, int n_blocks,
                            void* partial, void* out, void* stream) {
  if (n < 1 || n_blocks < 1 || n_blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  drt_dist_partial_kernel<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), n, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  drt_dist_finalize_kernel<<<1, kThreads, 0, s>>>(static_cast<const float*>(partial), n_blocks,
                                                  static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
