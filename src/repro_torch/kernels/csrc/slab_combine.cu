// slab_combine: whole-slab per-layer agent mixing for Hopper (sm_90a), and
// slab_source_combine, the permute engine's combine (at the end of the file).
//
// Replaces the Pallas TPU kernel repro/kernels/slab_combine.py::slab_combine.
//
//   out[k, c] = sum_l A_blocks[c / 128, l, k] * slab[l, c]
//
// A_blocks is (n_blocks, K, K) f32, slab and out are (K, n_blocks * 128) f32,
// all row-major and contiguous.  Every DRT layer segment of the slab is padded
// to a multiple of 128 columns, so one 128-column block belongs to one layer
// and takes one K x K mixing matrix.
//
// Bound: device memory.  Per call the kernel must read the slab (4 K D bytes)
// and A_blocks (4 K^2 D / 128 bytes) and write the output (4 K D bytes), for
// 2 K^2 D flops: at K = 16 that is 4 flops per byte, far below the H100's
// ~20 f32 flops per byte of HBM bandwidth, so the time floor is the bytes over
// the memory rate.
//
// Design: one CUDA block of 128 threads per 128-column block (blocks are
// independent: no cross-block reduction, so their order does not matter).
// The block stages its K x K matrix in shared memory; each thread owns one
// column, loads its K slab values (each row load is 512 contiguous bytes
// across the block, coalesced), accumulates sum_l A[l, k] x_l in f32 with
// fma, and writes out[k, c] (coalesced the same way).  Each input byte is
// read once and each output byte written once.  The slab column is staged in
// shared memory rather than registers so K can stay a runtime value.
// Padding columns hold zeros and the map is linear, so they stay exactly 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
// Largest agent count taken: A (K^2) plus the staged columns (128 K) floats
// fill 48 KB of shared memory at K = 64, the most a block gets without an
// opt-in.  The Python wrapper checks the same limit (MAX_AGENTS).
constexpr int kMaxAgents = 64;

__global__ void __launch_bounds__(kLanes)
slab_combine_kernel(const float* __restrict__ a_blocks,
                    const float* __restrict__ slab,
                    float* __restrict__ out,
                    int K, int64_t D) {
  extern __shared__ float smem[];
  float* a_s = smem;               // a_s[l * K + k] = A_blocks[b, l, k]
  float* x_s = smem + K * K;       // x_s[l * 128 + t] = slab[l, b * 128 + t]
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* a = a_blocks + static_cast<int64_t>(b) * K * K;
  for (int i = t; i < K * K; i += kLanes) a_s[i] = a[i];
  const int64_t c = static_cast<int64_t>(b) * kLanes + t;
  for (int l = 0; l < K; ++l) x_s[l * kLanes + t] = slab[l * D + c];
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    float acc = 0.0f;
    for (int l = 0; l < K; ++l) acc = fmaf(a_s[l * K + k], x_s[l * kLanes + t], acc);
    out[k * D + c] = acc;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): 0 when
// the launch was accepted.  Does not synchronise and allocates nothing.
extern "C" int slab_combine_f32(const void* a_blocks, const void* slab, void* out,
                                int K, int n_blocks, void* stream) {
  if (K < 1 || K > kMaxAgents || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(K * K + K * kLanes) * sizeof(float);
  const int64_t D = static_cast<int64_t>(n_blocks) * kLanes;
  slab_combine_kernel<<<n_blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_blocks), static_cast<const float*>(slab),
      static_cast<float*>(out), K, D);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// slab_source_combine: replaces repro/kernels/slab_combine.py::
// slab_source_combine, the permute engine's {self} + neighbours combine.
//
//   out[c] = sum_n w_blocks[c / 128, n] * srcs[n, c]
//
// w_blocks is (n_blocks, N) f32 (each block's layer's mixing column),
// srcs (N, n_blocks * 128) f32 (the agent's own slab, then the received
// ones), out (n_blocks * 128) f32; all contiguous.
//
// Bound: device memory.  A call reads 4 N D bytes of sources and writes 4 D,
// for 2 N D flops (N = 3 on the ring: 0.4 flops per byte).
//
// Design: one 128-thread block per column block; the block's N weights go
// to shared memory, each thread owns one column and walks n = 0 .. N-1 in
// order (each row load is 512 contiguous bytes across the block), rounding
// product and sum apart (__fmul_rn, __fadd_rn: no contraction into an fma),
// as the plain PyTorch version's separate multiply and add do.  So the
// kernel equals the plain version bit for bit.

namespace {

constexpr int kMaxSources = 64;  // the wrapper checks the same (MAX_SOURCES)

__global__ void __launch_bounds__(kLanes)
slab_source_combine_kernel(const float* __restrict__ w_blocks,
                           const float* __restrict__ srcs,
                           float* __restrict__ out, int N, int64_t D) {
  __shared__ float w_s[kMaxSources];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  if (t < N) w_s[t] = w_blocks[static_cast<int64_t>(b) * N + t];
  __syncthreads();
  const int64_t c = static_cast<int64_t>(b) * kLanes + t;
  float acc = 0.0f;
  for (int n = 0; n < N; ++n) acc = __fadd_rn(acc, __fmul_rn(w_s[n], srcs[n * D + c]));
  out[c] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): 0 when the launch was
// accepted.  Does not synchronise and allocates nothing.
extern "C" int slab_source_combine_f32(const void* w_blocks, const void* srcs, void* out,
                                       int N, int n_blocks, void* stream) {
  if (N < 1 || N > kMaxSources || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t D = static_cast<int64_t>(n_blocks) * kLanes;
  slab_source_combine_kernel<<<n_blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_blocks), static_cast<const float*>(srcs),
      static_cast<float*>(out), N, D);
  return static_cast<int>(cudaGetLastError());
}
