// flash_attention: causal online-softmax attention (forward) for Hopper (sm_90a),
// in two kernels chosen by the inputs' dtype: bf16 on the tensor cores
// (wgmma, with TMA loads; the LM's serving path) and f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention.
//
//   o[b, h, i] = sum_j softmax_j(scale * <q[b, h, i], k[b, h / n_rep, j]>) v[b, h / n_rep, j]
//
// over the keys j <= i (causal only), scale = 1 / sqrt(hd), masked scores
// -1e30, the softmax statistics and the accumulator in f32, the result divided
// by max(l, 1e-30) and rounded to q's type.  q, k, v and o are (B, heads, S,
// hd) views with any batch, head and row strides and unit stride along hd; k
// and v hold Hkv = H / n_rep heads and query head h reads key/value head
// h / n_rep (the reference's GQA expansion repeats each KV head n_rep times in
// a row), so the grouped heads are never expanded in memory.
//
// Bound: at the qwen3-4b prefill shape (B 4, H 32, Hkv 8, S 2048, hd 128, bf16)
// a causal call does 2 B H S^2 hd = 137 GFLOP (q k^T and p v over the lower
// triangle) against 168 MB of q, k, v and o: operations, by far (0.139 ms at
// the tensor cores' 989 TFLOP/s in bf16).
//
// bf16 kernel (flash_attention_bf16_kernel).  A persistent grid, one block
// of 384 threads per SM, walks the work tiles (a 128-row query tile of one
// (b, h)) longest causal tiles first, block c taking tiles c, c + grid, ...
// (the longest block then does 3% more than the mean at the qwen3-4b shape).
// Two consumer warpgroups of 64 rows each and one producer warpgroup
// (setmaxnreg moves its registers to the consumers: 24 against 240 a
// thread).  Since the block stays, the next tile's Q, K and V load while
// the consumers finish the last P V and store O.
//   * Loads: one producer thread issues TMA loads through 4-D tensor maps over
//     (hd, S, heads, B) with the views' own strides (built by the Python
//     wrapper, kernels/tma.py), so the strided (B, S, H, hd) projections need
//     no copy: Q once per work tile (reloaded once both warpgroups' last
//     Q K^T of the tile is done: `q_empty`), then K and V per 128-key tile,
//     each into its own 2-stage ring that runs on across work tiles, each
//     stage with a `full` mbarrier (TMA bytes) and an `empty` one (256
//     consumer arrivals).  Boxes are 64 (hd 32: 32) bf16
//     wide with 128-byte (64-byte) swizzle, so an hd-128 row is two boxes in
//     two smem regions.
//     Rows past S are zero-filled by TMA and masked by bounds; nothing is
//     padded.
//   * S = Q K^T: wgmma m64n128k16, bf16 in, f32 accumulate, both operands
//     K-major in shared memory (the descriptor steps 32 bytes per k16 inside
//     a swizzle row and one region per 64 hd).  Only tiles that cross the
//     diagonal or the end of the keys are masked; tiles above the diagonal
//     are never loaded.
//   * Online softmax on the accumulator fragment: each thread holds two rows'
//     scores, 32 each, spread over a quad of lanes; row max of the raw f32
//     scores by two shuffles; p = 2^(s scale log2(e) - m) as one fma and one
//     ex2.approx (the scale applies to the f32 scores, not to the bf16 q);
//     l is summed from the f32 p before any rounding.
//   * O += P V: P rounded to bf16 in registers is wgmma's A operand (the
//     m64nN f32 accumulator layout is the k16 A-fragment layout, 8 values
//     per k16 step), V read from shared memory in the transposed-B
//     (N-major) form, since the V tile is [keys, hd] row-major.
//   * FA3's ping-pong: the two consumer warpgroups take turns (named
//     barriers) to issue their products, so one's softmax runs while the
//     other's products hold the tensor cores.  Within a warpgroup, tile j's
//     Q K^T and tile j-1's P V are issued together (FA3's intra-warpgroup
//     overlap); ptxas places the wait for P V before the softmax all the
//     same, and pinning it behind the softmax measured no faster (PERF.md).
//     K_j is released once Q K_j^T is done and V_j once P_j V_j is, so the
//     separate rings let the producer load the next tiles meanwhile.
//   * Epilogue: O / max(l, 1e-30), rounded to bf16, stored as bf16 pairs to
//     the (B, Sq, H, hd) output.
//   * Optional log-sum-exp (training): with a non-null `lse`, each row's
//     lse = m + log(l) of the scaled scores (natural log, f32) is written
//     to the contiguous (B, H, Sq) buffer beside O, for the backward
//     kernels (csrc/flash_attention_bwd.cu).  Serving passes null: one
//     predicate in the epilogue, nothing else changes.
// Rounding P to bf16 is the one step the plain version does not take:
// |o - o_plain| <= 2^-9 sum_j softmax_j |v_j| (tests and chip_smoke.py hold
// the kernel to rtol 2^-7 plus atol 2^-8 max|v|).
//
// f32 kernel (flash_attention_f32_kernel): the first port of this kernel, on
// the CUDA cores (67 TFLOP/s peak).  The TPU kernel walks the KV tiles on a
// sequential minor grid axis and carries m, l and acc in VMEM scratch.  Here
// one block of 128 threads owns one (b*h, 64-row query tile) and loops over
// the 32-key tiles itself, with m, l and acc in registers:
//   * the q tile, scaled by 1/sqrt(hd) in f32, stays in shared memory for the
//     whole loop; each key tile is loaded transposed (k) and as is (v);
//   * thread (ty, tx) of a 16 x 8 grid computes the scores of rows ty + 16 i
//     and columns tx + 8 j (i, j < 4), reduces its rows' max and sum over the
//     8 lanes of the row with shuffles, writes exp(s - m) to shared memory,
//     and accumulates rows ty + 16 i, columns tx + 8 c of the output;
//   * each block stops at its diagonal tile, and the last query tiles (the
//     longest) are scheduled first;
//   * rows past Sq and keys past Skv are masked by bounds: nothing is padded;
//   * with a non-null `lse`, the row's m + log(l) is written as the bf16
//     kernel does.
// Leading dimensions are padded (hd + 1, 33, 40 floats) so that the shared
// memory reads and writes of a warp hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 32;               // keys per tile
constexpr int kTX = 8;                // threads across a tile's columns
constexpr int kTY = 16;               // threads across its rows
constexpr int kThreads = kTX * kTY;   // 128
constexpr int kRows = kBQ / kTY;      // 4 query rows per thread
constexpr int kCols = kBK / kTX;      // 4 score columns per thread
constexpr float kMasked = -1e30f;

template <int HD>
struct Smem {
  static constexpr int q_ld = HD + 1;    // sQ[row][d]
  static constexpr int kt_ld = kBK + 1;  // sKt[d][key]
  static constexpr int v_ld = HD;        // sV[key][d]
  static constexpr int p_ld = kBK + 8;   // sP[row][key]
  static constexpr int q = 0;
  static constexpr int kt = q + kBQ * q_ld;
  static constexpr int v = kt + HD * kt_ld;
  static constexpr int p = v + kBK * v_ld;
  static constexpr size_t bytes = sizeof(float) * (p + kBQ * p_ld);
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, n_rep, Sq, Skv;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  float* lse;  // (B, H, Sq) f32, or null
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(const Args a) {
  constexpr int kOut = HD / kTX;  // output columns per thread
  using L = Smem<HD>;
  extern __shared__ float smem[];
  float* sQ = smem + L::q;
  float* sKt = smem + L::kt;
  float* sV = smem + L::v;
  float* sP = smem + L::p;

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, hk = h / a.n_rep;
  const int q0 = qt * kBQ;
  const float* Q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* K = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* V = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* O = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * L::q_ld + d] = q0 + r < a.Sq ? Q[(q0 + r) * a.q_ss + d] * a.scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int k_end = min(a.Skv, q_last + 1);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of sKt, sV and sP are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const bool in = k0 + c < a.Skv;
      sKt[d * L::kt_ld + c] = in ? K[(k0 + c) * a.k_ss + d] : 0.0f;
      sV[c * L::v_ld + d] = in ? V[(k0 + c) * a.v_ss + d] : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty + kTY * i) * L::q_ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sKt[d * L::kt_ld + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + ty + kTY * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + tx + kTX * j;
        const bool keep = k_pos < a.Skv && k_pos <= q_pos;
        s[i][j] = keep ? s[i][j] : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = expf(s[i][j] - m_new);
        sP[(ty + kTY * i) * L::p_ld + tx + kTX * j] = e;
        row_sum += e;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty + kTY * i) * L::p_ld + key];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float vv = sV[key * L::v_ld + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + kTY * i;
    if (r >= a.Sq) continue;
    if (a.lse != nullptr && tx == 0) a.lse[static_cast<int64_t>(blockIdx.y) * a.Sq + r] = m[i] + logf(l[i]);
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c) O[r * a.o_ss + tx + kTX * c] = acc[i][c] / denom;
  }
}

template <int HD>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.H);
  flash_attention_f32_kernel<HD><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel.

constexpr int kTcBQ = 128;          // query rows per block: two consumer warpgroups of 64
constexpr int kTcBN = 128;          // keys per tile
constexpr int kTcStages = 2;        // K/V ring depth
constexpr int kTcThreads = 384;     // warpgroups 0, 1: consumers; 2: producer
constexpr int kTcConsumers = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>  // wait until at most N committed groups are pending (groups retire in order)
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments in registers, which a wgmma reads until it retires.
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) asm volatile("" : "+r"(d[i][k])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode (1: 128-byte, 2: 64-byte).
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// D (64 x 128, f32) (+)= A (64 x 16, shared, K-major) B (128 x 16, shared, K-major)^T;
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 16, bf16 fragment in registers) B (16 x 32, shared,
// N-major: trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 fragment in registers) B (16 x 64, shared,
// N-major: trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 fragment in registers) B (16 x 128, shared,
// N-major: trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// 2^x on the multi-function unit (relative error ~2^-22; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct TcArgs {
  __nv_bfloat16* o;
  int B, H, n_rep, Sq, Skv;
  int64_t o_sb, o_sh, o_ss;
  float scale_log2;  // log2(e) / sqrt(hd)
  float* lse;        // (B, H, Sq) f32, or null
};

// Shared memory of one block: Q (kTcBQ rows), then kTcStages x (K, V)
// (kTcBN rows each), each `regions` regions of rows x SW bytes, every region
// 1024-byte aligned; then the barriers.
template <int HD>
struct TcSmem {
  static constexpr int SW = HD >= 64 ? 128 : 64;  // swizzle span = box row bytes
  static constexpr int box_d = SW / 2;            // bf16 per box row
  static constexpr int regions = HD / box_d;
  static constexpr int q_region = kTcBQ * SW;
  static constexpr int kv_region = kTcBN * SW;
  static constexpr int q_bytes = regions * q_region;
  static constexpr int kv_bytes = regions * kv_region;  // one of K or V, one stage
  static constexpr int q = 0;
  static constexpr int k = q + q_bytes;
  static constexpr int v = k + kTcStages * kv_bytes;
  // q_full; k_full, k_empty, v_full, v_empty, kTcStages each; q_empty
  static constexpr int bars = v + kTcStages * kv_bytes;
  static constexpr size_t bytes = 1024 + bars + 8 * (2 + 4 * kTcStages);  // + alignment slack
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, const TcArgs a) {
  using L = TcSmem<HD>;
  constexpr int SW = L::SW;
  constexpr int NS = kTcBN / 2;  // score registers per thread
  constexpr int NO = HD / 2;     // output registers per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) / 1024 * 1024);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* q_empty = q_full + 1 + 4 * kTcStages;
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kTcStages;
  uint64_t* v_full = k_empty + kTcStages;
  uint64_t* v_empty = v_full + kTcStages;

  // Persistent: block c takes work tiles t = c, c + gridDim.x, ..., ordered
  // longest causal first (t -> query tile nq - 1 - t / BH of head t % BH).
  const int BH = a.B * a.H, nq = (a.Sq + kTcBQ - 1) / kTcBQ, n_work = nq * BH;
  struct Work { int q0, b, h, n_tiles; };
  auto work = [&](int t) {
    Work w;
    w.q0 = (nq - 1 - t / BH) * kTcBQ;
    w.b = (t % BH) / a.H;
    w.h = (t % BH) % a.H;
    w.n_tiles = (min(a.Skv, min(w.q0 + kTcBQ, a.Sq)) + kTcBN - 1) / kTcBN;
    return w;
  };

  if (threadIdx.x == 0) {
    tma::mbar_init(q_full, 1);
    tma::mbar_init(q_empty, kTcConsumers);
    for (int s = 0; s < kTcStages; ++s) {
      tma::mbar_init(&k_full[s], 1);
      tma::mbar_init(&k_empty[s], kTcConsumers);
      tma::mbar_init(&v_full[s], 1);
      tma::mbar_init(&v_empty[s], kTcConsumers);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kTcConsumers) {
      int kv = 0;  // key tiles loaded so far: the K and V rings run on across work tiles
      for (int t = blockIdx.x, n = 0; t < n_work; t += gridDim.x, ++n) {
        const Work w = work(t);
        const int b = w.b, h = w.h, hk = w.h / a.n_rep;
        tma::mbar_wait(q_empty, (n & 1) ^ 1);  // the last work tile's Q K^T products are done
        tma::mbar_expect_tx(q_full, L::q_bytes);
        for (int r = 0; r < L::regions; ++r)
          tma::load_4d(smem + L::q + r * L::q_region, &q_map, q_full, r * L::box_d, w.q0, h, b);
        // K_j's slot frees when S_{j-2} is done, V_j's when P_{j-2} V_{j-2} is
        for (int j = 0; j < w.n_tiles; ++j) {
          const int s = (kv + j) % kTcStages;
          const uint32_t free_parity = (((kv + j) / kTcStages) & 1) ^ 1;
          tma::mbar_wait(&k_empty[s], free_parity);
          tma::mbar_expect_tx(&k_full[s], L::kv_bytes);
          for (int r = 0; r < L::regions; ++r)
            tma::load_4d(smem + L::k + s * L::kv_bytes + r * L::kv_region, &k_map, &k_full[s], r * L::box_d,
                         j * kTcBN, hk, b);
          tma::mbar_wait(&v_empty[s], free_parity);
          tma::mbar_expect_tx(&v_full[s], L::kv_bytes);
          for (int r = 0; r < L::regions; ++r)
            tma::load_4d(smem + L::v + s * L::kv_bytes + r * L::kv_region, &v_map, &v_full[s], r * L::box_d,
                         j * kTcBN, hk, b);
        }
        kv += w.n_tiles;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // consumer warpgroup wg: rows q0 + 64 wg + 16 warp + {g, g + 8} of each work tile
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, tq = lane % 4;
  int row_lo = 0, r0 = 0, r1 = 0;  // the warpgroup's first row, this thread's two (per work tile)
  const uint32_t q_base = tma::smem_u32(smem + L::q) + 64 * wg * SW;
  const uint32_t k_base = tma::smem_u32(smem + L::k);
  const uint32_t v_base = tma::smem_u32(smem + L::v);

  float o[NO];
  float m0, m1, l0, l1;  // l: this thread's share of the row sum
  float sc[NS];                 // scores of the tile in flight, then its p
  using Frags = uint32_t[kTcBN / 16][4];
  Frags pa;  // the previous tile's p in bf16: P V's A fragments

  // S = Q K_j^T for the tile in stage s (asynchronous: commit and wait apart)
  auto issue_qk = [&](int s) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      constexpr int per_row = SW / 32;              // k16 steps per swizzle row
      const uint32_t off = (ks % per_row) * 32;     // bytes into the row
      const uint64_t da = smem_desc<SW>(q_base + (ks / per_row) * L::q_region + off, 16, 8 * SW);
      const uint64_t db =
          smem_desc<SW>(k_base + s * L::kv_bytes + (ks / per_row) * L::kv_region + off, 16, 8 * SW);
      wgmma_ss(sc, da, db, ks > 0);
    }
  };
  // O += P V for the tile in stage s
  auto issue_pv = [&](int s, Frags& pa) {
#pragma unroll
    for (int kk = 0; kk < kTcBN / 16; ++kk) {
      // V rows 16 kk .. + 15 of the tile: 16 swizzle rows; hd regions L::kv_region apart
      const uint64_t db = smem_desc<SW>(v_base + s * L::kv_bytes + kk * 16 * SW, L::kv_region, 8 * SW);
      wgmma_rs(o, pa[kk], db);
    }
  };
  // Scale (log2 units) and mask the scores of tile j, update the row max
  // and sum, leave p in sc; returns the factors for the earlier sum of P V.
  auto softmax = [&](int j, float& corr0, float& corr1) {
    const int k0 = j * kTcBN;
    const bool masked_tile = k0 + kTcBN - 1 > row_lo || k0 + kTcBN > a.Skv;
    float mx0 = kMasked, mx1 = kMasked;  // of the raw scores (scale > 0)
#pragma unroll
    for (int c = 0; c < kTcBN / 8; ++c) {
      if (masked_tile) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * c + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (key >= a.Skv || key > row) sc[4 * c + e] = kMasked;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the row's four lanes
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * a.scale_log2), mn1 = fmaxf(m1, mx1 * a.scale_log2);  // log2 units
    corr0 = ex2(m0 - mn0);
    corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int c = 0; c < kTcBN / 8; ++c) {
      sc[4 * c] = ex2(fmaf(sc[4 * c], a.scale_log2, -mn0));
      sc[4 * c + 1] = ex2(fmaf(sc[4 * c + 1], a.scale_log2, -mn0));
      sc[4 * c + 2] = ex2(fmaf(sc[4 * c + 2], a.scale_log2, -mn1));
      sc[4 * c + 3] = ex2(fmaf(sc[4 * c + 3], a.scale_log2, -mn1));
      sum0 += sc[4 * c] + sc[4 * c + 1];
      sum1 += sc[4 * c + 2] + sc[4 * c + 3];
    }
    l0 = l0 * corr0 + sum0;  // from the f32 p, before rounding
    l1 = l1 * corr1 + sum1;
  };
  // p to bf16 A fragments: k16 step c / 2 holds (row g, keys +0..7),
  // (row g + 8, keys +0..7), then the same for keys +8..15
  auto pack_p = [&](Frags& pa) {
#pragma unroll
    for (int c = 0; c < kTcBN / 8; ++c) {
      pa[c / 2][2 * (c % 2) + 0] = pack_bf16(sc[4 * c], sc[4 * c + 1]);
      pa[c / 2][2 * (c % 2) + 1] = pack_bf16(sc[4 * c + 2], sc[4 * c + 3]);
    }
  };

  // Tile j's Q K^T and tile j-1's P V are issued together.  Ping-pong: each
  // warpgroup issues its products only in its turn (named barrier 1 + wg,
  // released by the other warpgroup once it has issued its own): n_tiles +
  // 1 issue points per work tile; warpgroup 0 takes the first turn unasked
  // and warpgroup 1 hands back no turn after its last.
  bool first_issue = true, last_work = false;
  auto take_turn = [&]() {
    if (!(wg == 0 && first_issue)) asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kTcConsumers) : "memory");
    first_issue = false;
  };
  auto pass_turn = [&](bool last_of_work) {
    if (!(wg == 1 && last_work && last_of_work))
      asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(kTcConsumers) : "memory");
  };

  int kv = 0;  // key tiles consumed so far, as the producer counts them
  for (int t = blockIdx.x, n = 0; t < n_work; t += gridDim.x, ++n) {
    const Work w = work(t);
    const int n_tiles = w.n_tiles;
    last_work = t + static_cast<int>(gridDim.x) >= n_work;
    row_lo = w.q0 + 64 * wg;
    r0 = row_lo + 16 * warp + g;
    r1 = r0 + 8;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    m0 = m1 = kMasked;
    l0 = l1 = 0.0f;

    float corr0, corr1;
    tma::mbar_wait(q_full, n & 1);
    tma::mbar_wait(&k_full[kv % kTcStages], (kv / kTcStages) & 1);
    take_turn();
    fence_regs(sc);
    wgmma_fence();
    issue_qk(kv % kTcStages);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<0>();
    fence_regs(sc);
    tma::mbar_arrive(&k_empty[kv % kTcStages]);
    if (n_tiles == 1) tma::mbar_arrive(q_empty);  // Q is read
    softmax(0, corr0, corr1);
    pack_p(pa);
    for (int j = 1; j < n_tiles; ++j) {
      const int s = (kv + j) % kTcStages, sp = (kv + j - 1) % kTcStages;
      tma::mbar_wait(&k_full[s], ((kv + j) / kTcStages) & 1);
      tma::mbar_wait(&v_full[sp], ((kv + j - 1) / kTcStages) & 1);
      take_turn();
      fence_regs(sc);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_qk(s);
      wgmma_commit();
      issue_pv(sp, pa);
      wgmma_commit();
      pass_turn(false);
      wgmma_wait<1>();
      fence_regs(sc);
      tma::mbar_arrive(&k_empty[s]);
      if (j == n_tiles - 1) tma::mbar_arrive(q_empty);  // Q is read
      softmax(j, corr0, corr1);
      fence_regs(sc);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      tma::mbar_arrive(&v_empty[sp]);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        o[4 * c] *= corr0;
        o[4 * c + 1] *= corr0;
        o[4 * c + 2] *= corr1;
        o[4 * c + 3] *= corr1;
      }
      pack_p(pa);
    }
    const int s_last = (kv + n_tiles - 1) % kTcStages;
    tma::mbar_wait(&v_full[s_last], ((kv + n_tiles - 1) / kTcStages) & 1);
    take_turn();
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(s_last, pa);
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    tma::mbar_arrive(&v_empty[s_last]);
    kv += n_tiles;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    if (a.lse != nullptr && tq == 0) {  // m is in log2 units: lse = (m + log2 l) ln 2
      float* L = a.lse + (static_cast<int64_t>(w.b) * a.H + w.h) * a.Sq;
      if (r0 < a.Sq) L[r0] = (m0 + log2f(l0)) * kLn2;
      if (r1 < a.Sq) L[r1] = (m1 + log2f(l1)) * kLn2;
    }
    __nv_bfloat16* O = a.o + w.b * a.o_sb + w.h * a.o_sh;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int col = 8 * c + 2 * tq;
      if (r0 < a.Sq)
        *reinterpret_cast<uint32_t*>(O + r0 * a.o_ss + col) = pack_bf16(o[4 * c] / d0, o[4 * c + 1] / d0);
      if (r1 < a.Sq)
        *reinterpret_cast<uint32_t*>(O + r1 * a.o_ss + col) = pack_bf16(o[4 * c + 2] / d1, o[4 * c + 3] / d1);
    }
  }
}

template <int HD>
int launch_bf16(const int64_t* const maps[3], const void* const bases[3], const TcArgs& a, cudaStream_t stream) {
  using L = TcSmem<HD>;
  const CUtensorMapSwizzle sw = L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const int rows[3] = {kTcBQ, kTcBN, kTcBN};
  CUtensorMap m[3];
  for (int i = 0; i < 3; ++i) {
    const int64_t* w = maps[i];
    if (w[0] != 4 || w[1] != HD || w[10] != L::box_d || w[11] != rows[i] || w[12] != 1 || w[13] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = tma::encode(&m[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bases[i], w, sw);
    if (err != 0) return err;
  }
  auto kernel = flash_attention_bf16_kernel<HD>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int sms = tma::sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_work = (a.Sq + kTcBQ - 1) / kTcBQ * a.B * a.H;
  kernel<<<n_work < sms ? n_work : sms, kTcThreads, L::bytes, stream>>>(m[0], m[1], m[2], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 attention on the CUDA cores: one launch on `stream` (a cudaStream_t).
// Strides are in elements: for each of q, k, v, o its batch, head and row
// strides; the hd axis has unit stride.  `lse`: null, or a contiguous (B, H,
// Sq) f32 buffer for each row's log-sum-exp.  Returns cudaGetLastError()
// after the launch (0 when it was accepted); does not synchronise and
// allocates nothing.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                                   int Sq, int Skv, int hd, const int64_t* strides, float scale, float* lse,
                                   void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Skv < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, H, H / Hkv, Sq, Skv,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
         scale, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_f32<32>(a, B, s);
    case 64: return launch_f32<64>(a, B, s);
    case 128: return launch_f32<128>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 attention on the tensor cores: one launch on `stream`.  q_tma, k_tma,
// v_tma are the packed tensor-map words (tma.cuh) of q, k and v over (hd, S,
// heads, B) with boxes (min(hd, 64), 128, 1, 1); o_strides the output's
// batch, head and row strides in elements (unit stride along hd); `lse`
// null or a contiguous (B, H, Sq) f32 buffer, as the f32 entry's.  Returns
// 0 when the launch was accepted, a CUDA error code when it was not, and a
// negative value when the driver refused a tensor map.  Does not
// synchronise and allocates nothing.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                                    int Sq, int Skv, int hd, const int64_t* q_tma, const int64_t* k_tma,
                                    const int64_t* v_tma, const int64_t* o_strides, float scale, float* lse,
                                    void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Skv < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs a{static_cast<__nv_bfloat16*>(o), B, H, H / Hkv, Sq, Skv,
                 o_strides[0], o_strides[1], o_strides[2], scale * kLog2e, lse};
  const int64_t* const maps[3] = {q_tma, k_tma, v_tma};
  const void* const bases[3] = {q, k, v};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_bf16<32>(maps, bases, a, s);
    case 64: return launch_bf16<64>(maps, bases, a, s);
    case 128: return launch_bf16<128>(maps, bases, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
