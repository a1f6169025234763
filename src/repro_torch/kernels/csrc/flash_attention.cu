// flash_attention: causal online-softmax attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention.
//
//   o[b, h, i] = sum_j softmax_j(scale * <q[b, h, i], k[b, h / n_rep, j]>) v[b, h / n_rep, j]
//
// over the keys j <= i (causal only), with scale = 1 / sqrt(hd) applied
// to q in f32 before the product, masked scores set to -1e30, the softmax
// statistics and the accumulator in f32, the result divided by max(l, 1e-30)
// and rounded to q's type (f32 or bf16).  q, k, v and o are (B, heads, S, hd)
// views with any batch, head and row strides and unit stride along hd; k and v
// hold Hkv = H / n_rep heads and query head h reads key/value head h / n_rep
// (the reference's GQA expansion repeats each KV head n_rep times in a row),
// so the grouped heads are never expanded in memory.
//
// Bound: at the qwen3-4b prefill shape (B 4, H 32, Hkv 8, S 2048, hd 128, bf16)
// a causal call does 2 B H S^2 hd = 137 GFLOP (q k^T and p v over the lower
// triangle) against 168 MB of q, k, v and o: operations, by far.  This first
// kernel runs on the CUDA cores in f32 (67 TFLOP/s peak, not the tensor
// cores' 989 in bf16), so it sits far from the bound; wgmma tiles are later
// work.
//
// Design: the TPU kernel walks the KV tiles on a sequential minor grid axis
// and carries m, l and acc in VMEM scratch.  Here one block of 128 threads
// owns one (b*h, 64-row query tile) and loops over the 32-key tiles itself,
// with m, l and acc in registers:
//   * the scaled q tile stays in shared memory for the whole loop; each key
//     tile is loaded transposed (k) and as is (v) into shared memory, as f32;
//   * thread (ty, tx) of a 16 x 8 grid computes the scores of rows ty + 16 i
//     and columns tx + 8 j (i, j < 4), reduces its rows' max and sum over the
//     8 lanes of the row with shuffles, writes exp(s - m) to shared memory,
//     and accumulates rows ty + 16 i, columns tx + 8 c of the output;
//   * each block stops at its diagonal tile, and the last query tiles (the
//     longest) are scheduled first;
//   * rows past Sq and keys past Skv are masked by bounds: nothing is padded.
// Leading dimensions are padded (hd + 1, 33, 40 floats) so that the shared
// memory reads and writes of a warp hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 32;               // keys per tile
constexpr int kTX = 8;                // threads across a tile's columns
constexpr int kTY = 16;               // threads across its rows
constexpr int kThreads = kTX * kTY;   // 128
constexpr int kRows = kBQ / kTY;      // 4 query rows per thread
constexpr int kCols = kBK / kTX;      // 4 score columns per thread
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Args a) {
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
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * L::q_ld + d] = q0 + r < a.Sq ? to_f32(Q[(q0 + r) * a.q_ss + d]) * a.scale : 0.0f;
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
      sKt[d * L::kt_ld + c] = in ? to_f32(K[(k0 + c) * a.k_ss + d]) : 0.0f;
      sV[c * L::v_ld + d] = in ? to_f32(V[(k0 + c) * a.v_ss + d]) : 0.0f;
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
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c) store(O + r * a.o_ss + tx + kTX * c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.H);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const Args& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch on `stream` (a cudaStream_t).  dtype: 0 = f32, 1 = bf16 (q, k, v
// and o alike).  Strides are in elements: for each of q, k, v, o its batch,
// head and row strides; the hd axis has unit stride.  Returns
// cudaGetLastError() after the launch (0 when it was accepted); does not
// synchronise and allocates nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                                   int H, int Hkv, int Sq, int Skv, int hd, const int64_t* strides,
                                   float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Skv < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, H, H / Hkv, Sq, Skv,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(a, B, hd, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, B, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
