// flash_attention_bwd: the gradients of causal GQA attention (the backward of
// csrc/flash_attention.cu) for Hopper (sm_90a), on the CUDA cores, f32 or
// bf16 inputs, f32 arithmetic.
//
// Replaces no TPU kernel: the reference differentiates its plain-jnp
// attention (repro/models/layers.py::flash_attention) with XLA and has no
// Pallas backward.  The port's forward is a hand-written kernel that autograd
// cannot see through, so its gradient is this kernel
// (kernels/flash_attention.py::FlashAttention).
//
// With s = <q_i, k_j> scale (scale = 1 / sqrt(hd)), the forward's per-row
// log-sum-exp lse_i of the scaled scores, O the forward's output and dO its
// gradient, for the keys j <= i (the forward's mask; keys past Skv and rows
// past Sq are masked by bounds, nothing is padded):
//   D_i  = sum_d dO_id O_id
//   P_ij = exp(s_ij - lse_i)
//   dV_j = sum_i P_ij dO_i          dP_ij = <dO_i, V_j>
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i = scale sum_j dS_ij K_j     dK_j = scale sum_i dS_ij Q_i
// summed over the n_rep query heads of a KV head's group for dK and dV.  q,
// k, v, o, dO and the three outputs are (B, heads, S, hd) views with any
// batch, head and row strides and unit stride along hd; lse and D are
// contiguous (B, H, Sq) f32.  The outputs are rounded once, to the inputs'
// type.
//
// Three launches a call (kernels/flash_attention.py BWD_LAUNCHES_PER_CALL).
// CUDA blocks run in no order, so no block sums into another's output and
// nothing uses atomics:
//   1. delta_kernel: D, one warp a row (a shuffle sum over hd).
//   2. dkdv_kernel: one block of 128 threads per (KV head, 32-key tile).
//      The K and V tiles stay in shared memory; the block walks the group's
//      query heads and, from the diagonal on, their 32-row query tiles,
//      recomputing P and dS per tile and accumulating dK and dV in
//      registers (2 keys by hd / 8 columns a thread).
//   3. dq_kernel: one block of 128 threads per (query head, 64-row query
//      tile), longest causal tiles first.  Q, dO, lse and D stay in shared
//      memory; the block walks the key tiles up to its diagonal and
//      accumulates dQ in registers (4 rows by hd / 8 columns a thread).
// S and dP are recomputed in both 2 and 3: seven products of the causal
// triangle against the five a single pass needs, the price of no atomics.
//
// Bound: 2.5x the forward's causal FLOPs (five products of the triangle); at
// the qwen3-4b training shape (B 1, H 32, Hkv 8, S 2048, hd 128, bf16) 86
// GFLOP, 0.087 ms at the tensor cores' 989 TFLOP/s.  This first kernel runs
// on the CUDA cores (67 TFLOP/s f32 peak) from shared-memory tiles, as the
// f32 forward kernel does; tensor cores (mma.sync / wgmma) wait for a later
// change.  Leading dimensions are padded (hd + 1, 33 floats) so that a
// warp's shared-memory reads hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 8;               // threads across a tile's columns
constexpr int kTY = 16;              // threads across its rows
constexpr int kThreads = kTX * kTY;  // 128
constexpr int kBK = 32;              // keys a tile
constexpr int kBQkv = 32;            // query rows a tile in dkdv_kernel
constexpr int kBQ = 64;              // query rows a block in dq_kernel
constexpr int kDeltaWarps = 8;       // rows a block in delta_kernel
constexpr int kPld = kBK + 1;        // leading dimension of the P and dS tiles

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dO;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int H, Hkv, n_rep, Sq, Skv;
  // batch, head and row strides, in elements, of q k v o dO dq dk dv
  int64_t q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  float scale;
};

// rows [r0, r0 + ROWS) of a (S, HD) head into a padded f32 tile (zeros past S)
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t row_stride, int r0, int S) {
  for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] = r0 + r < S ? load(src + (r0 + r) * row_stride + d) : 0.0f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDeltaWarps * 32) delta_kernel(const Args a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kDeltaWarps + warp;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const T* O = static_cast<const T*>(a.o) + b * a.o_s[0] + h * a.o_s[1];
  const T* dO = static_cast<const T*>(a.dO) + b * a.do_s[0] + h * a.do_s[1];
  float sum = 0.0f;
  if (row < a.Sq)
    for (int d = lane; d < HD; d += 32) sum = fmaf(load(dO + row * a.do_s[2] + d), load(O + row * a.o_s[2] + d), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0 && row < a.Sq) a.delta[static_cast<int64_t>(blockIdx.y) * a.Sq + row] = sum;
}

template <int HD>
struct DkdvSmem {
  static constexpr int ld = HD + 1;
  static constexpr int k = 0;                       // sK[key][d]
  static constexpr int v = k + kBK * ld;            // sV[key][d]
  static constexpr int q = v + kBK * ld;            // sQ[row][d]
  static constexpr int dO = q + kBQkv * ld;         // sdO[row][d]
  static constexpr int p = dO + kBQkv * ld;         // sP[row][key]
  static constexpr int ds = p + kBQkv * kPld;       // sdS[row][key]
  static constexpr int lse = ds + kBQkv * kPld;     // sL[row]
  static constexpr int delta = lse + kBQkv;         // sD[row]
  static constexpr size_t bytes = sizeof(float) * (delta + kBQkv);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using L = DkdvSmem<HD>;
  constexpr int ld = L::ld;
  constexpr int RQ = kBQkv / kTY;  // score rows a thread
  constexpr int CK = kBK / kTX;    // score columns (keys) a thread
  constexpr int RK = kBK / kTY;    // dK, dV rows (keys) a thread
  constexpr int NC = HD / kTX;     // dK, dV columns a thread
  extern __shared__ float smem[];
  float* sK = smem + L::k;
  float* sV = smem + L::v;
  float* sQ = smem + L::q;
  float* sdO = smem + L::dO;
  float* sP = smem + L::p;
  float* sdS = smem + L::ds;
  float* sL = smem + L::lse;
  float* sD = smem + L::delta;

  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  load_tile<T, HD, kBK>(sK, static_cast<const T*>(a.k) + b * a.k_s[0] + hk * a.k_s[1], a.k_s[2], k0, a.Skv);
  load_tile<T, HD, kBK>(sV, static_cast<const T*>(a.v) + b * a.v_s[0] + hk * a.v_s[1], a.v_s[2], k0, a.Skv);

  float dk[RK][NC], dv[RK][NC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  const int q_first = k0 / kBQkv * kBQkv;  // the first query tile that sees key k0
  for (int r = 0; r < a.n_rep; ++r) {
    const int h = hk * a.n_rep + r;
    const T* Q = static_cast<const T*>(a.q) + b * a.q_s[0] + h * a.q_s[1];
    const T* dO = static_cast<const T*>(a.dO) + b * a.do_s[0] + h * a.do_s[1];
    const float* lse = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.Sq;
    const float* delta = a.delta + (static_cast<int64_t>(b) * a.H + h) * a.Sq;
    for (int q0 = q_first; q0 < a.Sq; q0 += kBQkv) {
      __syncthreads();  // the previous tile's reads of sQ, sdO, sP and sdS are done (and sK, sV are loaded)
      load_tile<T, HD, kBQkv>(sQ, Q, a.q_s[2], q0, a.Sq);
      load_tile<T, HD, kBQkv>(sdO, dO, a.do_s[2], q0, a.Sq);
      if (tid < kBQkv) {
        const bool in = q0 + tid < a.Sq;
        sL[tid] = in ? lse[q0 + tid] : 0.0f;
        sD[tid] = in ? delta[q0 + tid] : 0.0f;
      }
      __syncthreads();

      // S and dP of rows ty + 16 i, keys tx + 8 j
      float s[RQ][CK], dp[RQ][CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          qv[i] = sQ[(ty + kTY * i) * ld + d];
          ov[i] = sdO[(ty + kTY * i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          kv[j] = sK[(tx + kTX * j) * ld + d];
          vv[j] = sV[(tx + kTX * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CK; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int row = ty + kTY * i, q_pos = q0 + row;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          const int key = tx + kTX * j, k_pos = k0 + key;
          const bool keep = q_pos < a.Sq && k_pos < a.Skv && k_pos <= q_pos;
          const float p = keep ? expf(s[i][j] * a.scale - sL[row]) : 0.0f;
          sP[row * kPld + key] = p;
          sdS[row * kPld + key] = p * (dp[i][j] - sD[row]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for keys ty + 16 i, columns tx + 8 c
#pragma unroll 2
      for (int row = 0; row < kBQkv; ++row) {
        float pk[RK], dsk[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pk[i] = sP[row * kPld + ty + kTY * i];
          dsk[i] = sdS[row * kPld + ty + kTY * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = sdO[row * ld + tx + kTX * c];
          const float qv = sQ[row * ld + tx + kTX * c];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            dv[i][c] = fmaf(pk[i], ov, dv[i][c]);
            dk[i][c] = fmaf(dsk[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  T* dK = static_cast<T*>(a.dk) + b * a.dk_s[0] + hk * a.dk_s[1];
  T* dV = static_cast<T*>(a.dv) + b * a.dv_s[0] + hk * a.dv_s[1];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int k_pos = k0 + ty + kTY * i;
    if (k_pos >= a.Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dK + k_pos * a.dk_s[2] + tx + kTX * c, dk[i][c] * a.scale);
      store(dV + k_pos * a.dv_s[2] + tx + kTX * c, dv[i][c]);
    }
  }
}

template <int HD>
struct DqSmem {
  static constexpr int ld = HD + 1;
  static constexpr int q = 0;                    // sQ[row][d]
  static constexpr int dO = q + kBQ * ld;        // sdO[row][d]
  static constexpr int k = dO + kBQ * ld;        // sK[key][d]
  static constexpr int v = k + kBK * ld;         // sV[key][d]
  static constexpr int ds = v + kBK * ld;        // sdS[row][key]
  static constexpr int lse = ds + kBQ * kPld;    // sL[row]
  static constexpr int delta = lse + kBQ;        // sD[row]
  static constexpr size_t bytes = sizeof(float) * (delta + kBQ);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using L = DqSmem<HD>;
  constexpr int ld = L::ld;
  constexpr int RQ = kBQ / kTY;  // rows a thread (scores and dQ)
  constexpr int CK = kBK / kTX;  // score columns (keys) a thread
  constexpr int NC = HD / kTX;   // dQ columns a thread
  extern __shared__ float smem[];
  float* sQ = smem + L::q;
  float* sdO = smem + L::dO;
  float* sK = smem + L::k;
  float* sV = smem + L::v;
  float* sdS = smem + L::ds;
  float* sL = smem + L::lse;
  float* sD = smem + L::delta;

  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal tiles first
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, hk = h / a.n_rep;
  load_tile<T, HD, kBQ>(sQ, static_cast<const T*>(a.q) + b * a.q_s[0] + h * a.q_s[1], a.q_s[2], q0, a.Sq);
  load_tile<T, HD, kBQ>(sdO, static_cast<const T*>(a.dO) + b * a.do_s[0] + h * a.do_s[1], a.do_s[2], q0, a.Sq);
  if (tid < kBQ) {
    const int64_t at = static_cast<int64_t>(blockIdx.y) * a.Sq + q0 + tid;
    const bool in = q0 + tid < a.Sq;
    sL[tid] = in ? a.lse[at] : 0.0f;
    sD[tid] = in ? a.delta[at] : 0.0f;
  }
  const T* K = static_cast<const T*>(a.k) + b * a.k_s[0] + hk * a.k_s[1];
  const T* V = static_cast<const T*>(a.v) + b * a.v_s[0] + hk * a.v_s[1];

  float acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;

  const int k_end = min(a.Skv, min(q0 + kBQ, a.Sq));  // keys past the tile's last row are masked
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of sK, sV and sdS are done
    load_tile<T, HD, kBK>(sK, K, a.k_s[2], k0, a.Skv);
    load_tile<T, HD, kBK>(sV, V, a.v_s[2], k0, a.Skv);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = sQ[(ty + kTY * i) * ld + d];
        ov[i] = sdO[(ty + kTY * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kv[j] = sK[(tx + kTX * j) * ld + d];
        vv[j] = sV[(tx + kTX * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = ty + kTY * i, q_pos = q0 + row;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int key = tx + kTX * j, k_pos = k0 + key;
        const bool keep = q_pos < a.Sq && k_pos < a.Skv && k_pos <= q_pos;
        const float p = keep ? expf(s[i][j] * a.scale - sL[row]) : 0.0f;
        sdS[row * kPld + key] = p * (dp[i][j] - sD[row]);
      }
    }
    __syncthreads();

    // dQ += dS K for rows ty + 16 i, columns tx + 8 c
#pragma unroll 2
    for (int key = 0; key < kBK; ++key) {
      float dsv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = sdS[(ty + kTY * i) * kPld + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sK[key * ld + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

  T* dQ = static_cast<T*>(a.dq) + b * a.dq_s[0] + h * a.dq_s[1];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int q_pos = q0 + ty + kTY * i;
    if (q_pos >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(dQ + q_pos * a.dq_s[2] + tx + kTX * c, acc[i][c] * a.scale);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  int err = allow_smem(dkdv_kernel<T, HD>, DkdvSmem<HD>::bytes);
  if (err == 0) err = allow_smem(dq_kernel<T, HD>, DqSmem<HD>::bytes);
  if (err != 0) return err;
  delta_kernel<T, HD><<<dim3((a.Sq + kDeltaWarps - 1) / kDeltaWarps, B * a.H), kDeltaWarps * 32, 0, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dkdv_kernel<T, HD><<<dim3((a.Skv + kBK - 1) / kBK, B * a.Hkv), kThreads, DkdvSmem<HD>::bytes, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dq_kernel<T, HD><<<dim3((a.Sq + kBQ - 1) / kBQ, B * a.H), kThreads, DqSmem<HD>::bytes, stream>>>(a);
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

// The backward of causal GQA attention: three launches on `stream` (delta,
// dK/dV, dQ).  `bf16` picks the element type of q, k, v, o, dO and the
// outputs (1: bf16, 0: f32).  `strides`: 24 element strides, the batch, head
// and row strides of q, k, v, o, dO, dq, dk and dv in that order (unit stride
// along hd).  lse: the forward's (B, H, Sq) f32 log-sum-exp; delta: (B, H,
// Sq) f32 scratch.  Returns 0 when every launch was accepted, else the CUDA
// error of the first that was not; does not synchronise and allocates
// nothing.
extern "C" int flash_attention_bwd(int bf16, const void* q, const void* k, const void* v, const void* o,
                                   const void* dO, const float* lse, float* delta, void* dq, void* dk, void* dv,
                                   int B, int H, int Hkv, int Sq, int Skv, int hd, const int64_t* strides,
                                   float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Skv < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dO, lse, delta, dq, dk, dv, H, Hkv, H / Hkv, Sq, Skv};
  int64_t* dst[8] = {a.q_s, a.k_s, a.v_s, a.o_s, a.do_s, a.dq_s, a.dk_s, a.dv_s};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_hd<__nv_bfloat16>(a, B, hd, s) : dispatch_hd<float>(a, B, hd, s);
}
