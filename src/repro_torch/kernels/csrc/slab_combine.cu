// slab_combine: whole-slab per-layer agent mixing for Hopper (sm_90a);
// slab_dequant_combine, its fused int8 form; and slab_source_combine, the
// permute engine's combine (at the end of the file).
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
// Design: a TMA ring.  To run at HBM's rate the card needs ~2.7 MB of loads
// in flight (3.35 TB/s x ~0.8 us); a thread that stages its column with one
// dependent 4-byte load after another keeps ~1 MB in flight across the card.
// Here a persistent grid (as many 160-thread blocks as fit, about 2 per SM,
// at most n_blocks) walks the 128-column blocks b = blockIdx.x, + gridDim.x,
// ...  In each block one producer thread (warp 4) keeps a ring of `stages`
// (2..8, sized from K so that two blocks fit on an SM) shared-memory tiles
// loading: per column block, one TMA box of (K rows, 128 columns) f32 from a
// 2-D tensor map over the slab (D, K), and the block's K x K matrix from a
// 1-D tensor map over A_blocks, both completing on the stage's `full`
// mbarrier.  A box must start on a 16-byte boundary and K^2 floats are not a
// multiple of 16 bytes for K % 4 != 0 (nor could a plain bulk copy take
// them), so the producer loads the aligned span of up to K^2 + 3 floats
// around the block's matrix and the consumers read it at its offset.
// The 128 consumer threads (warps 0-3) each own one column: for l = 0 ..
// K-1 in order they read x[l] from the tile and add A[l, k] x[l] into K f32
// registers with fmaf (the order and rounding of the earlier
// one-block-per-column kernel, and of the plain version's terms), then
// write the K outputs back over their own column of the tile, and one
// thread stores the tile with a TMA bulk store through a map over the
// output (measured faster than each thread storing its K values, PERF.md).
// It releases a stage on its `empty` mbarrier once the store has read it,
// while the next tiles are already loading.  A[l, k .. k+3] is read as one
// broadcast float4 when K % 4 == 0.  Padding columns hold zeros and the map
// is linear, so they stay exactly 0.  At K = 64 the K^2 multiply-adds a
// thread make the kernel compute-bound (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kLanes = 128;
// Largest agent count taken (the Python wrapper checks the same limit,
// MAX_AGENTS): a stage then holds 32 KB of slab and 16 KB of A.
constexpr int kMaxAgents = 64;
constexpr int kConsumers = kLanes;          // one column each
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kMaxStages = 8;
constexpr int kMinStages = 2;
constexpr int kStageBudget = 110 * 1024;    // ring bytes per block: two blocks per SM
constexpr int kAlign = 128;

// Floats of A_blocks one column block loads: its K^2, plus up to 3 before
// them when b K^2 is not a multiple of 4 (the box starts 16-byte aligned).
inline int a_span(int K) { return K * K + (K % 4 ? 3 : 0); }

struct Ring {
  int stages, a_box, a_boxes;
  uint32_t x_bytes, a_bytes, stage_bytes;  // a_bytes: the A boxes, whole
  size_t smem;                             // barriers + ring + alignment slack
};

Ring ring_for(int K, int a_box) {
  Ring r;
  r.a_box = a_box;
  r.a_boxes = (a_span(K) + a_box - 1) / a_box;
  r.x_bytes = static_cast<uint32_t>(K) * kLanes * sizeof(float);
  r.a_bytes = static_cast<uint32_t>(r.a_boxes * a_box) * sizeof(float);
  const uint32_t a_pad = (r.a_bytes + kAlign - 1) / kAlign * kAlign;
  r.stage_bytes = r.x_bytes + a_pad;
  r.stages = static_cast<int>(kStageBudget / r.stage_bytes);
  r.stages = r.stages < kMinStages ? kMinStages : (r.stages > kMaxStages ? kMaxStages : r.stages);
  r.smem = kAlign + static_cast<size_t>(r.stages) * r.stage_bytes + kAlign;
  return r;
}

template <int KMAX, bool VEC>
__global__ void __launch_bounds__(kThreads)
slab_combine_kernel(const __grid_constant__ CUtensorMap slab_map, const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap out_map, int K, int n_blocks, int64_t D, Ring r) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte aligned: barriers (full[0..stages), empty[0..stages)), then the
  // stages, each the slab tile (K x 128 f32) and the A boxes.
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) /
                                              kAlign * kAlign);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // TMA bytes
  // empty: one arrival, by consumer thread 0 once the tile's store has read the stage
  uint64_t* empty = full + kMaxStages;
  uint8_t* ring = base + kAlign;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < r.stages; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], 1);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (t >= kConsumers) {  // the producer warp; one thread issues the loads
    if (t == kConsumers) {
      int it = 0;
      for (int b = blockIdx.x; b < n_blocks; b += gridDim.x, ++it) {
        const int s = it % r.stages;
        const uint32_t phase = (it / r.stages) & 1;
        tma::mbar_wait(&empty[s], phase ^ 1);
        uint8_t* stage = ring + static_cast<size_t>(s) * r.stage_bytes;
        tma::mbar_expect_tx(&full[s], r.x_bytes + r.a_bytes);
        tma::load_2d(stage, &slab_map, &full[s], b * kLanes, 0);
        const int a_start = (b * K * K) & ~3;  // 16-byte aligned
        for (int j = 0; j < r.a_boxes; ++j)
          tma::load_1d(stage + r.x_bytes + j * r.a_box * sizeof(float), &a_map, &full[s], a_start + j * r.a_box);
      }
    }
    return;
  }

  int it = 0;
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x, ++it) {
    const int s = it % r.stages;
    tma::mbar_wait(&full[s], (it / r.stages) & 1);
    const uint8_t* stage = ring + static_cast<size_t>(s) * r.stage_bytes;
    const float* x = reinterpret_cast<const float*>(stage);
    const float* a = reinterpret_cast<const float*>(stage + r.x_bytes) + ((b * K * K) & 3);
    float acc[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) acc[k] = 0.0f;
    for (int l = 0; l < K; ++l) {
      const float xv = x[l * kLanes + t];
      if constexpr (VEC) {
        const float4* a4 = reinterpret_cast<const float4*>(a + l * K);
#pragma unroll
        for (int k4 = 0; k4 < KMAX / 4; ++k4) {
          if (4 * k4 < K) {
            const float4 w = a4[k4];
            acc[4 * k4 + 0] = fmaf(w.x, xv, acc[4 * k4 + 0]);
            acc[4 * k4 + 1] = fmaf(w.y, xv, acc[4 * k4 + 1]);
            acc[4 * k4 + 2] = fmaf(w.z, xv, acc[4 * k4 + 2]);
            acc[4 * k4 + 3] = fmaf(w.w, xv, acc[4 * k4 + 3]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K) acc[k] = fmaf(a[l * K + k], xv, acc[k]);
      }
    }
    // the outputs replace this thread's own column of the tile, then one TMA store per tile
    float* xo = reinterpret_cast<float*>(ring + static_cast<size_t>(s) * r.stage_bytes);
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < K) xo[k * kLanes + t] = acc[k];
    tma::fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");  // the consumers' named barrier
    if (t == 0) {
      tma::store_2d(&out_map, xo, b * kLanes, 0);
      tma::bulk_commit();
      tma::bulk_wait_read<1>();  // the previous tile's store has read its stage
      if (it > 0) tma::mbar_arrive(&empty[(it - 1) % r.stages]);
    }
  }
  if (t == 0) tma::bulk_wait<0>();
}

template <int KMAX, bool VEC>
int launch_combine(const CUtensorMap& slab_map, const CUtensorMap& a_map, const CUtensorMap& out, int K, int n_blocks,
                   const Ring& r, cudaStream_t stream) {
  auto kernel = slab_combine_kernel<KMAX, VEC>;
  static size_t ready_smem = 0;  // the shared-memory size set up last, and its occupancy
  static int per_sm = 0;
  if (ready_smem != r.smem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(r.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, r.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready_smem = r.smem;
  }
  const int sms = tma::sm_count();
  if (per_sm < 1 || sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = n_blocks < per_sm * sms ? n_blocks : per_sm * sms;
  const int64_t D = static_cast<int64_t>(n_blocks) * kLanes;
  kernel<<<grid, kThreads, r.smem, stream>>>(slab_map, a_map, out, K, n_blocks, D, r);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch_k(const CUtensorMap& slab_map, const CUtensorMap& a_map, const CUtensorMap& out, int K, int n_blocks,
               const Ring& r, cudaStream_t stream) {
  if (K <= 4) return launch_combine<4, VEC>(slab_map, a_map, out, K, n_blocks, r, stream);
  if (K <= 8) return launch_combine<8, VEC>(slab_map, a_map, out, K, n_blocks, r, stream);
  if (K <= 16) return launch_combine<16, VEC>(slab_map, a_map, out, K, n_blocks, r, stream);
  if (K <= 32) return launch_combine<32, VEC>(slab_map, a_map, out, K, n_blocks, r, stream);
  return launch_combine<64, VEC>(slab_map, a_map, out, K, n_blocks, r, stream);
}

}  // namespace

// Launches on `stream` (a cudaStream_t).  `slab_tma`, `a_tma` and
// `out_tma` are the packed tensor-map words (tma.cuh) of the slab and of
// out, 2-D maps (D, K) with box (128, K), and of A_blocks seen flat, a 1-D
// map with box (a_box), a multiple of 4 up to 256 (kernels/slab_combine.py
// picks it).  Returns 0 when the launch was accepted,
// cudaGetLastError() or another CUDA error code when it was not, and a
// negative value when the driver refused a tensor map (tma::encode).  Does
// not synchronise and allocates nothing.
extern "C" int slab_combine_f32(const void* a_blocks, const void* slab, void* out, int K, int n_blocks,
                                const int64_t* slab_tma, const int64_t* a_tma, const int64_t* out_tma, void* stream) {
  if (K < 1 || K > kMaxAgents || n_blocks < 1 || slab_tma[10] != kLanes || slab_tma[11] != K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int a_box = static_cast<int>(a_tma[10]);
  if (a_tma[0] != 1 || a_box < 4 || a_box > 256 || a_box % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap slab_map, a_map;
  int err = tma::encode(&slab_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, slab, slab_tma, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  err = tma::encode(&a_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a_blocks, a_tma, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  CUtensorMap o;
  err = tma::encode(&o, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, out_tma, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const Ring r = ring_for(K, a_box);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K % 4 == 0 ? dispatch_k<true>(slab_map, a_map, o, K, n_blocks, r, s)
                    : dispatch_k<false>(slab_map, a_map, o, K, n_blocks, r, s);
}

// ---------------------------------------------------------------------------
// slab_dequant_combine: replaces repro/kernels/slab_combine.py::
// slab_dequant_combine, the fused int8 dequantize + whole-slab combine.
//
//   out[k, c] = sum_l A_blocks[c / 128, l, k] * (scales[l, col_seg[c]] * q[l, c])
//
// A_blocks is (n_blocks, K, K) f32, scales (K, n_segs) f32 (each agent's
// int8 scale per segment), col_seg (n_blocks * 128) int32 (each column's
// scale segment, checked by the wrapper to lie in [0, n_segs)), q (K,
// n_blocks * 128) int8, out (K, n_blocks * 128) f32; all contiguous.
//
// Bound: device memory.  A call reads K D int8 values, D int32 segment ids,
// A_blocks (4 K^2 D / 128 bytes) and writes 4 K D bytes, for 2 K^2 D flops
// (about 5 flops per byte at K = 16).
//
// Design: one 128-thread block per column block, each thread one column
// (the structure slab_combine had before its TMA ring).  The TPU rebuilds the
// per-column scales with a one-hot matmul (it has no fast gather); here each
// thread reads its column's segment id once and gathers its K scales
// directly (the K x n_segs table is small and stays in L1/L2).  The thread
// stages the dequantized column (one rounded product per agent, as the
// reference's s_cols * q) in shared memory, then mixes it as slab_combine
// does.  The decoded f32 slab never reaches device memory.  Padding columns
// carry q = 0 and stay exactly 0.  (Staging 16 loads in flight before their
// stores made it slower on the H100, 39.0 against 33.1 us: PERF.md.)

namespace {

__global__ void __launch_bounds__(kLanes)
slab_dequant_combine_kernel(const float* __restrict__ a_blocks,
                            const float* __restrict__ scales,
                            const int* __restrict__ col_seg,
                            const int8_t* __restrict__ q,
                            float* __restrict__ out,
                            int K, int n_segs, int64_t D) {
  extern __shared__ float smem[];
  float* a_s = smem;               // a_s[l * K + k] = A_blocks[b, l, k]
  float* x_s = smem + K * K;       // x_s[l * 128 + t] = scales[l, seg] * q[l, c]
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* a = a_blocks + static_cast<int64_t>(b) * K * K;
  for (int i = t; i < K * K; i += kLanes) a_s[i] = a[i];
  const int64_t c = static_cast<int64_t>(b) * kLanes + t;
  const int seg = col_seg[c];
  for (int l = 0; l < K; ++l)
    x_s[l * kLanes + t] = __fmul_rn(scales[l * n_segs + seg], static_cast<float>(q[l * D + c]));
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    float acc = 0.0f;
    for (int l = 0; l < K; ++l) acc = fmaf(a_s[l * K + k], x_s[l * kLanes + t], acc);
    out[k * D + c] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): 0 when the launch was
// accepted.  Does not synchronise and allocates nothing.
extern "C" int slab_dequant_combine_f32(const void* a_blocks, const void* scales,
                                        const void* col_seg, const void* q, void* out, int K,
                                        int n_segs, int n_blocks, void* stream) {
  if (K < 1 || K > kMaxAgents || n_segs < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(K * K + K * kLanes) * sizeof(float);
  const int64_t D = static_cast<int64_t>(n_blocks) * kLanes;
  slab_dequant_combine_kernel<<<n_blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_blocks), static_cast<const float*>(scales),
      static_cast<const int*>(col_seg), static_cast<const int8_t*>(q), static_cast<float*>(out),
      K, n_segs, D);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// slab_source_combine: replaces repro/kernels/slab_combine.py::
// slab_source_combine, the permute engine's {self} + neighbours combine.
//
//   out[c] = sum_n w_blocks[c / 128, n] * src_n[c]
//
// w_blocks is (n_blocks, N) f32 (each block's layer's mixing column), each
// source src_n an (n_blocks * 128) f32 row where it lies (the agent's own
// slab, then the received ones: no stacked copy), out (n_blocks * 128) f32;
// every row contiguous and 16-byte aligned.  The N source pointers travel
// by value in the kernel's parameters (Sources, N <= kMaxSources).
//
// Bound: device memory.  A call reads 4 N D bytes of sources and writes 4 D,
// for 2 N D flops (N = 3 on the ring: 0.4 flops per byte).  At the main
// shape (D = 309,248) that is ~5 MB, about 1.5 us at HBM's rate: a launch's
// own latency and one DRAM round trip are most of the time.
//
// Design: each thread owns 4 consecutive columns (a float4 of every source
// and one float4 store); 4 columns never straddle a 128-column block, so
// they share one weight per source.  A thread issues all its source loads
// (up to 8 at once; N > 8 in batches of 8) and its weight loads (read-only
// path, no shared memory, no barrier) before the first product, so a
// thread has N 16-byte loads in flight and the whole slab is requested in
// one round trip.  The grid is at most one wave (SMs x resident blocks) and
// strides over the column groups; at the main shape one group a thread
// needs 604 blocks of 128 threads, under one wave.  The sum walks n = 0 ..
// N-1 in order, rounding product and sum apart (__fmul_rn, __fadd_rn: no
// contraction into an fma), as the plain PyTorch version's separate
// multiply and add do, so the kernel equals it bit for bit.

namespace {

constexpr int kMaxSources = 64;  // the wrapper checks the same (MAX_SOURCES)
constexpr int kSrcThreads = 128;
constexpr int kSrcBatch = 8;           // source loads a thread keeps in flight
constexpr int kGroupsPerBlock = kLanes / 4;  // float4 column groups of a 128-column block

struct Sources {
  const float* p[kMaxSources];
};

// NS = N when N <= kSrcBatch (every loop unrolled whole); NS = 0 for any N
// up to kMaxSources, in unrolled batches that stop at N (the pointers are
// still indexed by constants, so the parameters stay in the constant bank).
template <int NS>
__global__ void __launch_bounds__(kSrcThreads)
slab_source_combine_kernel(const Sources src, const float* __restrict__ w_blocks,
                           float4* __restrict__ out, int N, int64_t groups) {
  constexpr int kBatch = NS > 0 ? NS : kSrcBatch;
  constexpr int kTotal = NS > 0 ? NS : kMaxSources;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kSrcThreads + threadIdx.x; g < groups;
       g += static_cast<int64_t>(gridDim.x) * kSrcThreads) {
    const float* w = w_blocks + (g / kGroupsPerBlock) * N;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int n0 = 0; n0 < kTotal; n0 += kBatch) {
      if (NS == 0 && n0 >= N) break;
      float4 x[kBatch];
      float wn[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (NS > 0 || n0 + i < N) x[i] = __ldg(reinterpret_cast<const float4*>(src.p[n0 + i]) + g);
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (NS > 0 || n0 + i < N) wn[i] = __ldg(w + n0 + i);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (NS > 0 || n0 + i < N) {
          acc.x = __fadd_rn(acc.x, __fmul_rn(wn[i], x[i].x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(wn[i], x[i].y));
          acc.z = __fadd_rn(acc.z, __fmul_rn(wn[i], x[i].z));
          acc.w = __fadd_rn(acc.w, __fmul_rn(wn[i], x[i].w));
        }
      }
    }
    out[g] = acc;
  }
}

// The blocks of one wave (every SM's resident blocks), or fewer when the
// column groups need fewer.
template <typename Kernel>
cudaError_t one_wave(Kernel kernel, int64_t groups, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSrcThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t need = (groups + kSrcThreads - 1) / kSrcThreads;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(need < wave ? need : wave);
  return cudaSuccess;
}

template <int NS>
cudaError_t launch_source_combine(const Sources& src, const float* w_blocks, float* out, int N,
                                  int n_blocks, cudaStream_t stream) {
  const int64_t groups = static_cast<int64_t>(n_blocks) * kGroupsPerBlock;
  int grid = 0;
  cudaError_t err = one_wave(slab_source_combine_kernel<NS>, groups, &grid);
  if (err != cudaSuccess) return err;
  slab_source_combine_kernel<NS><<<grid, kSrcThreads, 0, stream>>>(
      src, w_blocks, reinterpret_cast<float4*>(out), N, groups);
  return cudaGetLastError();
}

}  // namespace

// srcs: a host array of N device pointers, one (n_blocks * 128) f32 row
// each.  Launches on `stream` and returns the CUDA error: 0 when the launch
// was accepted.  Does not synchronise and allocates nothing.
extern "C" int slab_source_combine_f32(const void* w_blocks, const void* const* srcs, void* out,
                                       int N, int n_blocks, void* stream) {
  if (N < 1 || N > kMaxSources || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  Sources src{};
  for (int n = 0; n < N; ++n) src.p[n] = static_cast<const float*>(srcs[n]);
  const float* w = static_cast<const float*>(w_blocks);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 1: err = launch_source_combine<1>(src, w, o, N, n_blocks, s); break;
    case 2: err = launch_source_combine<2>(src, w, o, N, n_blocks, s); break;
    case 3: err = launch_source_combine<3>(src, w, o, N, n_blocks, s); break;
    case 4: err = launch_source_combine<4>(src, w, o, N, n_blocks, s); break;
    case 5: err = launch_source_combine<5>(src, w, o, N, n_blocks, s); break;
    case 6: err = launch_source_combine<6>(src, w, o, N, n_blocks, s); break;
    case 7: err = launch_source_combine<7>(src, w, o, N, n_blocks, s); break;
    case 8: err = launch_source_combine<8>(src, w, o, N, n_blocks, s); break;
    default: err = launch_source_combine<0>(src, w, o, N, n_blocks, s); break;
  }
  return static_cast<int>(err);
}
