// drt_dist: fused DRT distance statistics for Hopper (sm_90a), every layer
// slot of an exchange in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/drt_dist.py::drt_dist.
//
//   out[p] = ( sum_{i in slot p} (x[i] - y[i])^2,  sum_{i in slot p} y[i]^2 )
//
// over f32 rows x and y (contiguous) and L slots [begin_p, end_p).  The
// permute consensus engine calls it once per neighbour exchange: x is the
// agent's own (decoded) slab row, y the neighbour's, the slots its DRT layer
// segments, and out[p, 1] the NEIGHBOUR's squared norm.  The reference calls
// its kernel once per slot and stacks the (2,) results to (L, 2); the
// one-slot case here (no table) is that kernel's (2,).
//
// Bound: device memory, and at the engine's sizes launch latency.  An
// exchange reads 8 D bytes and does 5 D flops (0.6 flops per byte); the
// width-16 ResNet-20 slab has D = 309,248 columns in 11 slots, 2.47 MB
// (0.74 us at 3.35 TB/s), well under one launch's cost.
//
// Design: the TPU kernel carries both sums across a SEQUENTIAL grid in VMEM
// scratch.  CUDA blocks run in no fixed order, so each block takes one
// (slot, chunk) pair of kChunk elements (the wrapper's table lists them,
// slot by slot), sums its thread's elements in index order and the block's
// threads in a fixed tree, and writes one partial pair.  Then it takes an
// integer ticket of its slot; the block that draws the slot's last ticket
// sums the slot's partials in chunk order, writes out[p] and resets the
// ticket to 0 for the next launch.  A slot of one chunk writes out[p]
// directly.  No floating-point atomics: the chunks, hence every sum's
// order, depend on the slots alone, so two runs give identical bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // elements a block sums

// Fixed-order sum of (a, b) over the block; the result is valid in thread 0.
// Starts with a barrier, so `sh` may be reused by consecutive calls.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* sh) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    sh[2 * warp] = a;
    sh[2 * warp + 1] = b;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int n_warps = kThreads / 32;
    a = lane < n_warps ? sh[2 * lane] : 0.0f;
    b = lane < n_warps ? sh[2 * lane + 1] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
  }
}

// table: per block (chunk) five int64 words (begin, end, slot, first chunk of
// the slot, chunks of the slot), or null for one slot [0, n) cut into
// gridDim.x chunks.  partial: 2 floats per chunk; tickets: one per slot, 0
// between launches.
__global__ void __launch_bounds__(kThreads)
drt_dist_kernel(const float* __restrict__ x, const float* __restrict__ y, const int64_t* __restrict__ table,
                int64_t n, float* __restrict__ partial, unsigned int* __restrict__ tickets,
                float* __restrict__ out) {
  __shared__ float sh[2 * (kThreads / 32)];
  __shared__ bool last;
  int64_t begin, end;
  int slot, first, count;
  if (table != nullptr) {
    const int64_t* row = table + 5 * static_cast<int64_t>(blockIdx.x);
    begin = row[0];
    end = row[1];
    slot = static_cast<int>(row[2]);
    first = static_cast<int>(row[3]);
    count = static_cast<int>(row[4]);
  } else {
    begin = static_cast<int64_t>(blockIdx.x) * kChunk;
    end = begin + kChunk < n ? begin + kChunk : n;
    slot = 0;
    first = 0;
    count = gridDim.x;
  }
  float d2 = 0.0f, n2 = 0.0f;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int64_t i = begin + q * kThreads + threadIdx.x;
    if (i < end) {
      const float yv = y[i];
      const float d = x[i] - yv;
      d2 = fmaf(d, d, d2);
      n2 = fmaf(yv, yv, n2);
    }
  }
  block_sum2(d2, n2, sh);
  if (count == 1) {
    if (threadIdx.x == 0) {
      out[2 * slot] = d2;
      out[2 * slot + 1] = n2;
    }
    return;
  }
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = d2;
    partial[2 * blockIdx.x + 1] = n2;
    __threadfence();  // the partial is visible before the ticket is
    last = atomicAdd(&tickets[slot], 1u) == static_cast<unsigned int>(count - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other blocks' partials, fenced before their tickets
  d2 = n2 = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    d2 += __ldcg(&partial[2 * (first + i)]);
    n2 += __ldcg(&partial[2 * (first + i) + 1]);
  }
  block_sum2(d2, n2, sh);
  if (threadIdx.x == 0) {
    out[2 * slot] = d2;
    out[2 * slot + 1] = n2;
    tickets[slot] = 0u;
  }
}

}  // namespace

// One launch of `n_chunks` blocks on `stream` (a cudaStream_t).  `table`:
// n_chunks rows of (begin, end, slot, first, count) on the device, or null
// for the one slot [0, n) in ceil(n / kChunk) chunks.  `partial` holds 2
// floats a chunk, `tickets` one zeroed word a slot (left zeroed), `out` 2
// floats a slot.  Returns cudaGetLastError() after the launch: 0 when it was
// accepted.  Does not synchronise and allocates nothing.
extern "C" int drt_dist_f32(const void* x, const void* y, const void* table, int64_t n, int n_chunks,
                            void* partial, void* tickets, void* out, void* stream) {
  if (n < 1 || n_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (table == nullptr && n_chunks != (n + kChunk - 1) / kChunk) return static_cast<int>(cudaErrorInvalidValue);
  drt_dist_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const int64_t*>(table), n,
      static_cast<float*>(partial), static_cast<unsigned int*>(tickets), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
