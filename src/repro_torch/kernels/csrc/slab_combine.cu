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

#include "combine_rows.cuh"
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
//   out[k, c] = sum_l A[m(c / 128), l, k] * fl(scales[l, col_seg[c]] * q[l, c])
//
// A is a (P, K, K) f32 stack of mixing matrices and m the block-to-matrix
// map, an (n_blocks) int32 array; without a map P = n_blocks and m(b) = b
// (the API's A_blocks).  scales is (K, n_segs) f32 (each agent's int8 scale
// per segment), col_seg (n_blocks * 128) int32 (each column's scale
// segment), q (K, n_blocks * 128) int8, out (K, n_blocks * 128) f32; all
// contiguous, q and col_seg 16-byte aligned.  The wrapper checks the ids of
// col_seg and of the map before any launch.  fl(s q) is one rounded product
// (the reference's s_cols * q), and the sum runs l = 0 .. K-1 with fmaf from
// 0, as the kernel this one replaced summed.  Padding columns carry q = 0
// and stay exactly 0.
//
// Bound: device memory.  A call reads K D int8 values, 4 D bytes of segment
// ids and the matrices, and writes 4 K D bytes: at the main shape (K = 16,
// D = 309,248) 28.5 MB with A_blocks (0.0085 ms at 3.35 TB/s), 26.0 MB with
// the (L, K, K) stack and the map (0.0078 ms), 70% of it the output.  The
// 2 K^2 D flops are about 6 a byte, under the H100's ~20 f32 flops per byte.
//
// Design.  The kernel it replaces ran one column a thread with K a runtime
// int, so every product read both its weight and its source from shared
// memory: 2 LDS per FFMA, about 19 us of shared-memory issue per SM at the
// main shape against an 8.5 us byte bound.  Here K is bounded by a template
// parameter (KMAX = 4, 8, 16, 32, 64) and a thread owns four consecutive
// columns, so its K sources (one 4-byte word of four int8 each) stay in
// registers for the whole column block:
// - one warp takes one 128-column block (32 threads x 4 columns), so the
//   block's matrix is the warp's: each warp copies it into its own half of
//   a shared-memory double buffer (cp.async, padded to KMAX x KMAX);
// - a pass runs over the sources in order, each widened to f32 by an
//   integer trick (combine_rows.cuh, not I2F) and scaled (the fl(s q)
//   product); the weights A[l, k..k+3] of four output rows come as one
//   float4 broadcast, so 16 FFMA cost one LDS.128 (and each source one
//   scale load).  K <= 16 takes one pass over all its output rows (4 x KMAX
//   accumulators); K > 16 passes of four rows (kDqRows) over the sources
//   still held, the pass loop rolled.  Each output row leaves as one float4
//   store a thread (512 contiguous bytes a warp);
// - the sources run to KMAX with no branch, those past K as zeros (a row
//   of zeros in the matrix, a scale of 1), so a pass is one straight run.
//   With a branch a source (K a runtime bound), ptxas rebuilt addresses and
//   constants in every source's block: 4.8 instructions a product at four
//   rows a pass, and the kernel ran slower (PERF.md);
// - the (K, n_segs) scale table is staged once per block in shared memory
//   (its rows past K as ones) where it fits (kScaleSmemBytes), else read
//   with __ldg; a group's four segment ids come in one 16-byte load, and
//   where the ids of every group of the warp agree (all but one group at
//   the main shape) a source takes one scale, else one per column;
// - a persistent one-wave grid of 128-thread blocks walks the column
//   blocks.  The prologue puts the first block's loads, the scale table's
//   copy and the first matrix's copy in flight together; then each thread
//   loads its next block's ids and matrix while it computes the current
//   one, refills each source's register in the last pass right after its
//   last use, and loads the matrix index of the block after next (so no
//   copy waits on its index).

namespace {

constexpr int kDqThreads = 128;                 // four warps, each on its own column blocks
constexpr int kDqWarps = kDqThreads / 32;
constexpr int kDqRows = 4;                      // output rows a pass accumulates where KMAX > 16
constexpr int kScaleSmemBytes = 32 * 1024;      // the scale table is staged when it fits

struct DqParams {
  const float* a;          // (P, K, K): block b's matrix is a + m(b) K^2
  const int* block_mat;    // m: (n_blocks), or null for m(b) = b
  const float* scales;     // (K, n_segs)
  const int4* col_seg;     // the segment ids in groups of four columns: (D / 4)
  const unsigned* q;       // row l's group g (four int8) at q[l * ldq4 + g]
  float4* out;             // row k's group g at out[k * ldq4 + g]
  int64_t ldq4;            // D / 4
  int K, n_segs, n_blocks;
  bool a_vec;              // 16-byte matrix copies (K % 4 == 0, A 16-byte aligned)
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// Matrix index of column block b.
__device__ __forceinline__ int matrix_of(const DqParams& p, int b) {
  return p.block_mat != nullptr ? __ldg(p.block_mat + b) : b;
}

// Starts copying matrix m (K x K) into dst, row l at dst + l KMAX, and
// commits the copies as one group.
template <int KMAX>
__device__ __forceinline__ void stage_matrix(const DqParams& p, int m, float* dst, int lane) {
  const int K = p.K;
  const float* src = p.a + static_cast<int64_t>(m) * K * K;
  if (p.a_vec) {
    for (int i = lane; i < K * (KMAX / 4); i += 32) {
      const int l = i / (KMAX / 4), k = 4 * (i % (KMAX / 4));
      if (k < K) cp_async16(dst + l * KMAX + k, src + l * K + k);
    }
  } else {
    for (int i = lane; i < K * KMAX; i += 32) {
      const int l = i / KMAX, k = i % KMAX;
      if (k < K) combine_rows::cp_async4(dst + l * KMAX + k, src + l * K + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// One column block for one thread: its four columns from the sources in
// raw, the block's matrix at a_s, the ids of its columns, out at the
// thread's column group of output row 0.  kSame: the four ids agree.  In
// the last pass each source's register is refilled, once used, with the
// same source of the thread's next block (qn: its group in source row 0).
// The sources run l = 0 .. KMAX-1 with no branch: past K a source is 0, its
// matrix row 0 and its scale 1 (the staged table's padding; from device
// memory, 1 in place of a load), so it adds exactly nothing.
template <int KMAX, bool kSame, bool kSmemScales>
__device__ __forceinline__ void dq_block(const DqParams& p, const float* a_s, const float* s_s,
                                         unsigned (&raw)[KMAX], int4 ids, float4* out, const unsigned* qn,
                                         bool has_next) {
  constexpr int kRows = KMAX <= 16 ? KMAX : kDqRows;
  constexpr bool kOnePass = kRows == KMAX;
  const int K = p.K, ns = p.n_segs;
  const int64_t ld = p.ldq4;
  const float* table = kSmemScales ? s_s : p.scales;
#pragma unroll 1
  for (int m0 = 0; m0 < K && (!kOnePass || m0 == 0); m0 += kRows) {
    const bool refill = has_next && m0 + kRows >= K;
    // the scale addresses through an opaque zero, new each pass: ptxas would
    // otherwise hoist every source's scale address (and its scale) out of
    // the pass loop, and KMAX = 64 spilled
    int zero;
    asm volatile("mov.b32 %0, 0;\n" : "=r"(zero));
    const float* sx = table + ids.x + zero;  // source l's scales: + l ns
    const float* sy = table + ids.y + zero;
    const float* sz = table + ids.z + zero;
    const float* sw = table + ids.w + zero;
    const unsigned* qr = qn;
    float4 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int l = 0; l < KMAX; ++l) {
      const float4 xq = combine_rows::Src<int8_t>::widen(raw[l]);
      if (refill && l < K) raw[l] = __ldg(qr);
      qr += ld;
      float4 x;
      if (kSame) {
        const float s = kSmemScales ? *sx : l < K ? __ldg(sx) : 1.0f;
        x = make_float4(__fmul_rn(s, xq.x), __fmul_rn(s, xq.y), __fmul_rn(s, xq.z), __fmul_rn(s, xq.w));
      } else if (kSmemScales) {
        x = make_float4(__fmul_rn(*sx, xq.x), __fmul_rn(*sy, xq.y), __fmul_rn(*sz, xq.z), __fmul_rn(*sw, xq.w));
      } else {
        x = l < K ? make_float4(__fmul_rn(__ldg(sx), xq.x), __fmul_rn(__ldg(sy), xq.y), __fmul_rn(__ldg(sz), xq.z),
                                __fmul_rn(__ldg(sw), xq.w))
                  : xq;
      }
      sx += ns;
      sy += ns;
      sz += ns;
      sw += ns;
      // A[l, m0 .. m0 + kRows - 1] (columns past K: padding, into rows never stored)
      const float4* w = reinterpret_cast<const float4*>(a_s + l * KMAX + m0);
#pragma unroll
      for (int j = 0; j < kRows / 4; ++j) {
        const float4 a = w[j];
        fma4(acc[4 * j], a.x, x);
        fma4(acc[4 * j + 1], a.y, x);
        fma4(acc[4 * j + 2], a.z, x);
        fma4(acc[4 * j + 3], a.w, x);
      }
    }
    float4* o = out + m0 * ld;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (m0 + r < K) o[r * ld] = acc[r];
  }
}

template <int KMAX, bool kSmemScales>
__global__ void __launch_bounds__(kDqThreads)
slab_dequant_combine_kernel(const DqParams p) {
  extern __shared__ __align__(16) float dq_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int a_floats = KMAX * KMAX;  // one matrix, padded to KMAX x KMAX
  float* a_buf = dq_smem + warp * 2 * a_floats;
  float* s_s = dq_smem + kDqWarps * 2 * a_floats;
  const int n_warps = gridDim.x * kDqWarps;
  const int64_t ld = p.ldq4;
  int b = blockIdx.x * kDqWarps + warp;
  const bool busy = b < p.n_blocks;
  // the first block's matrix index, sources and ids, and the second block's
  // matrix index: the prologue's loads all in flight at once
  int m = 0, mn = 0;
  unsigned raw[KMAX];
  int4 ids = make_int4(0, 0, 0, 0);
  if (busy) {
    m = matrix_of(p, b);
    if (b + n_warps < p.n_blocks) mn = matrix_of(p, b + n_warps);
    const unsigned* qr = p.q + static_cast<int64_t>(b) * 32 + lane;
#pragma unroll
    for (int l = 0; l < KMAX; ++l) raw[l] = l < p.K ? __ldg(qr + l * ld) : 0u;
    ids = __ldg(p.col_seg + static_cast<int64_t>(b) * 32 + lane);
  }
  const int pad = (KMAX - p.K) * KMAX;  // the matrix rows past K: 0 in both buffers, never copied over
  for (int i = lane; i < pad; i += 32) a_buf[p.K * KMAX + i] = a_buf[a_floats + p.K * KMAX + i] = 0.0f;
  if (kSmemScales) {
    for (int i = threadIdx.x; i < p.K * p.n_segs; i += kDqThreads) combine_rows::cp_async4(s_s + i, p.scales + i);
    for (int i = p.K * p.n_segs + threadIdx.x; i < KMAX * p.n_segs; i += kDqThreads) s_s[i] = 1.0f;
  }
  if (busy) stage_matrix<KMAX>(p, m, a_buf, lane);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the scale table, the padding and each warp's first matrix are the block's
  if (!busy) return;
  for (int buf = 0;; buf ^= 1) {
    const int bn = b + n_warps;
    const bool has_next = bn < p.n_blocks;
    const int64_t g = static_cast<int64_t>(b) * 32 + lane, gn = static_cast<int64_t>(bn) * 32 + lane;
    int4 nids = ids;
    if (has_next) {
      nids = __ldg(p.col_seg + gn);
      stage_matrix<KMAX>(p, mn, a_buf + (buf ^ 1) * a_floats, lane);  // its index was loaded a block ago
      if (bn + n_warps < p.n_blocks) mn = matrix_of(p, bn + n_warps);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();  // this block's matrix is the warp's
    const float* a_s = a_buf + buf * a_floats;
    const bool same = ids.x == ids.y && ids.x == ids.z && ids.x == ids.w;
    if (__all_sync(0xffffffffu, same))
      dq_block<KMAX, true, kSmemScales>(p, a_s, s_s, raw, ids, p.out + g, p.q + gn, has_next);
    else
      dq_block<KMAX, false, kSmemScales>(p, a_s, s_s, raw, ids, p.out + g, p.q + gn, has_next);
    if (!has_next) break;
    __syncwarp();  // every lane is done with a_s before the block after next copies into it
    b = bn;
    ids = nids;
  }
}

template <int KMAX, bool kSmemScales>
cudaError_t launch_dequant(const DqParams& p, size_t smem, cudaStream_t stream) {
  auto kernel = slab_dequant_combine_kernel<KMAX, kSmemScales>;
  static size_t ready_smem = 0;  // the shared-memory size set up last, and its occupancy
  static int per_sm = 0;
  if (ready_smem != smem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDqThreads, smem);
    if (err != cudaSuccess) return err;
    ready_smem = smem;
  }
  const int sms = tma::sm_count();
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  const int need = (p.n_blocks + kDqWarps - 1) / kDqWarps;
  const int grid = need < per_sm * sms ? need : per_sm * sms;
  kernel<<<grid, kDqThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t dispatch_scales(const DqParams& p, cudaStream_t stream) {
  const size_t a_bytes = static_cast<size_t>(kDqWarps) * 2 * KMAX * KMAX * sizeof(float);
  const size_t s_bytes = static_cast<size_t>(KMAX) * p.n_segs * sizeof(float);  // rows past K: 1
  return s_bytes <= kScaleSmemBytes ? launch_dequant<KMAX, true>(p, a_bytes + s_bytes, stream)
                                    : launch_dequant<KMAX, false>(p, a_bytes, stream);
}

}  // namespace

// block_mat: the (n_blocks) int32 block-to-matrix map, or null (a_blocks
// then holds n_blocks matrices).  Launches on `stream` and returns the CUDA
// error: 0 when the launch was accepted.  Does not synchronise and
// allocates nothing.
extern "C" int slab_dequant_combine_f32(const void* a_blocks, const void* block_mat, const void* scales,
                                        const void* col_seg, const void* q, void* out, int K, int n_segs,
                                        int n_blocks, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(col_seg) | reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (K < 1 || K > kMaxAgents || n_segs < 1 || n_blocks < 1 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  DqParams p;
  p.a = static_cast<const float*>(a_blocks);
  p.block_mat = static_cast<const int*>(block_mat);
  p.scales = static_cast<const float*>(scales);
  p.col_seg = static_cast<const int4*>(col_seg);
  p.q = static_cast<const unsigned*>(q);
  p.out = static_cast<float4*>(out);
  p.ldq4 = static_cast<int64_t>(n_blocks) * kLanes / 4;
  p.K = K;
  p.n_segs = n_segs;
  p.n_blocks = n_blocks;
  p.a_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a_blocks) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (K <= 4)
    err = dispatch_scales<4>(p, s);
  else if (K <= 8)
    err = dispatch_scales<8>(p, s);
  else if (K <= 16)
    err = dispatch_scales<16>(p, s);
  else if (K <= 32)
    err = dispatch_scales<32>(p, s);
  else
    err = dispatch_scales<64>(p, s);
  return static_cast<int>(err);
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
