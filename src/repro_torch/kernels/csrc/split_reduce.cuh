// split_reduce.cuh: the per-layer split reduction of a DRT round's stats
// launch, shared by slab_codec.cu and slab_segment.cu.
//
// The TPU kernels carry their per-layer statistics across a SEQUENTIAL grid
// in VMEM.  CUDA blocks run in no order, so the stats launch cuts every
// layer into chunks of consecutive 128-column blocks (the host's plan,
// repro_torch/kernels/layer_chunks.py), one CUDA block a chunk:
//
//   1. each block streams its chunk's column blocks through a ring of
//      shared-memory tiles (cp.async), sums its statistics in a fixed order
//      (each thread its column's over the chunk's column blocks, then the
//      128 columns in order through a transposed shared-memory tile) and
//      writes one partial per chunk;
//   2. it draws its layer's integer ticket; the block that draws the
//      layer's last ticket sums the layer's partials in chunk order into the
//      layer's statistic (a layer of one chunk writes it directly);
//   3. that block draws the round's ticket; the block that finishes the
//      last layer stages every layer's statistics in shared memory (when
//      they fit: a template parameter, so its shared-memory accesses stay
//      typed) and computes the mixing weights of every layer.
//
// No floating-point atomics: every sum's order depends on the plan alone,
// so two runs give the same bits.  The block that draws a ticket's last
// number resets it to 0; the tickets live in a per-(device, stream)
// workspace that stays zeroed between launches.

#pragma once

#include <stdint.h>

namespace split_reduce {

// One row of the plan's chunk table: the chunk's layer and its column
// blocks [begin, end).
struct Chunk {
  int layer;
  int begin;
  int end;
};

__device__ __forceinline__ Chunk load_chunk(const int32_t* chunks, int i) {
  const int4 r = reinterpret_cast<const int4*>(chunks)[i];
  return Chunk{r.x, r.y, r.z};
}

// The plan's layer table: (first chunk, chunks) of layer p.
__device__ __forceinline__ int2 layer_chunks(const int32_t* layers, int p) {
  return reinterpret_cast<const int2*>(layers)[p];
}

// True in every thread of the block that draws the last of `count` numbers
// of *ticket.  Every thread fences its own global writes first, so what the
// block wrote before the call is visible to the block that draws the last
// number; that block fences again before it reads the others' writes
// (which it must read with __ldcg: L1 is not coherent across SMs).
__device__ __forceinline__ bool draw_last(unsigned* ticket, unsigned count, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1u) == count - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// store(i, s) for i < width, s the sum over chunks first .. first + count -
// 1, in chunk order, of partial[chunk * width + i].  When the block has
// threads to spare, each entry is split into `groups` runs of chunks summed
// in order, then the runs in order.  Each thread keeps 32 loads in flight.
// `scratch`: blockDim.x floats of shared memory.  Ends with a barrier.
template <typename Store>
__device__ __forceinline__ void sum_chunks(const float* __restrict__ partial, int first, int count,
                                           int width, float* scratch, Store store) {
  constexpr int kBatch = 32;
  const int groups = max(1, min(static_cast<int>(blockDim.x) / width, count));
  const int per = (count + groups - 1) / groups;
  for (int base = 0; base < width * groups; base += blockDim.x) {
    const int item = base + threadIdx.x;
    float s = 0.0f;
    if (item < width * groups) {
      const int i = item % width;
      const int g = item / width;
      const int c1 = min(count, (g + 1) * per);
      const float* p = partial + static_cast<int64_t>(first) * width + i;
      for (int c = g * per; c < c1; c += kBatch) {
        float b[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) b[j] = c + j < c1 ? __ldcg(p + static_cast<int64_t>(c + j) * width) : 0.0f;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) s += b[j];
      }
    }
    scratch[threadIdx.x] = s;
    __syncthreads();
    if (item < width) {
      for (int g = 1; g < groups; ++g) s += scratch[threadIdx.x + g * width];
      store(item, s);
    }
    __syncthreads();
  }
}

// Copy n floats of global memory that other blocks wrote into shared
// memory, each thread keeping 32 loads in flight.
__device__ __forceinline__ void stage(const float* __restrict__ src, int64_t n, float* __restrict__ into) {
  constexpr int kBatch = 32;
  for (int64_t i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    float b[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int64_t i = i0 + j * blockDim.x;
      b[j] = i < n ? __ldcg(src + i) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (i0 + j * blockDim.x < n) into[i0 + j * blockDim.x] = b[j];
  }
}

// -- the stats launch's streaming: a ring of column-block tiles that cp.async
// fills kStages - 1 tiles ahead of the one the threads read, so the bytes in
// flight do not depend on the registers a thread holds.

constexpr int kStages = 6;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of `row_bytes` bytes (a multiple of 16) into dst, row r
// from src(r) (16-byte aligned), by the block's threads in 16-byte pieces.
template <typename RowSrc>
__device__ __forceinline__ void copy_rows(char* dst, int rows, int row_bytes, RowSrc src) {
  const int pieces = row_bytes / 16;
  for (int i = threadIdx.x; i < rows * pieces; i += blockDim.x) {
    const int r = i / pieces, q = i % pieces;
    cp_async16(dst + r * row_bytes + q * 16, reinterpret_cast<const char*>(src(r)) + q * 16);
  }
}

// Walk the column blocks [begin, end) of a chunk: fill(stage, b) issues the
// copies of column block b into ring stage `stage`; use(stage, b) reads it
// after every thread's copies have landed.
template <typename Fill, typename Use>
__device__ __forceinline__ void stream_blocks(int begin, int end, Fill fill, Use use) {
  const int n = end - begin;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) fill(s, begin + s);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) fill((i + kStages - 1) % kStages, begin + i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    use(i % kStages, begin + i);
    __syncthreads();
  }
}

}  // namespace split_reduce
