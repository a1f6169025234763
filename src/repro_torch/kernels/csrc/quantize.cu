// The int8 wire kernels for Hopper (sm_90a): int8_quantize, int8_dequantize
// and dequant_combine.
//
// Replace the Pallas TPU kernels of repro/kernels/quantize.py:
//
//   int8_quantize    q[i] = clip(floor(x[i] * (1 / s) + u[i]), -127, 127)
//   int8_dequantize  out[i] = q[i] * s
//   dequant_combine  out[m, c] = sum_n (a[m, n] * s[n]) * q[n, c]  over a
//                    table of column segments, each with its own a and s
//
// s is one f32 scale on the device (int8_quantize: absmax / 127, computed by
// the wrapper with a torch reduction, as the reference computes it outside
// its Pallas body); u is the f32 uniform field, an operand as in the TPU
// kernel's body.  int8_quantize computes 1 / s in f32 (IEEE division: the
// build has no --use_fast_math) and rounds the product and the sum apart
// (__fmul_rn, __fadd_rn), so it equals its plain PyTorch version bit for
// bit; nvcc would otherwise contract x * inv + u into an fma.
//
// Bound: device memory.  int8_quantize reads 4 n bytes of x (2 n in bf16 or
// f16) and 4 n of u and writes n (the K=16 slab in f32: 44.5 MB, 0.0133 ms
// at 3.35 TB/s); int8_dequantize reads n and writes 4 n; dequant_combine
// reads N n int8 and writes 4 M n (the per-slot call on the K=16 slab: 2 K^2
// D flops against 5 K D bytes, about 6 flops per byte).
//
// Design.  int8_quantize: the kernel it replaced took one element a thread
// and step (a 4-byte load of x and of u, a 1-byte store, a runtime dtype
// branch and 64-bit index arithmetic on every element), three memory
// instructions an element.  Here the input dtype is a template parameter
// and a thread takes 16 elements a step: x in 16-byte loads (four in f32,
// two in bf16 or f16), u in four, q in one 16-byte store; the rounded
// values are moved into bytes without the conversion unit (the clipped
// floor plus 2^23 + 2^22 holds the int8 in its low byte, exactly) and packed
// with PRMT.  Indices are 32-bit where n < 2^31.  A one-wave grid of two
// blocks an SM strides over the 16-element steps two at a time, so a thread
// has both steps' loads in flight before it rounds.  The vector path needs
// x and u 16-byte aligned (q is the wrapper's own allocation); the ragged
// tail, and every element of an operand that is contiguous but not
// aligned, take the same kernel's per-element path, chosen at launch.  At
// the main shape it moves its bytes near the rate of a torch copy of the
// slab (PERF.md).  int8_dequantize: the kernel it replaced was a
// grid-stride loop of one element a thread and step (a 1-byte load, a 4-byte
// store and 64-bit index arithmetic on every element).  Here a thread takes
// 16 elements a step: one 16-byte load of q and four 16-byte stores of out,
// the warp's loads staged in shared memory so that each of its stores
// writes 512 contiguous bytes; each int8 is widened without the conversion
// unit (combine_rows.cuh's PRMT and FADD, exact) and multiplied by s once
// (__fmul_rn), so out is q.float() * s bit for bit.  Indices are 32-bit
// where n < 2^31; the grid is one wave of kDequantBlocksPerSm blocks an SM.
// A q off a 16-byte boundary, and the
// ragged tail, take the same kernel's per-element path, chosen at launch.
// dequant_combine is csrc/combine_rows.cuh with int8 input
// (one 4-byte load a source per four columns where a segment is aligned):
// every output agent's row is combined from the int8 values in registers,
// so the dequantized f32 neighbours never reach device memory.  The
// reference's per-(slot, leaf) combine is one launch over all its pieces,
// each with its layer's matrix and its leaf's scale column, and the columns
// in no piece (lane padding) are written 0 by the same launch.

#include <cuda_fp16.h>

#include "combine_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kQmax = 127.0f;
constexpr int kStep = 16;  // int8_quantize: elements a thread takes a step
// int8_quantize's blocks an SM: 512 threads with two steps of loads each in
// flight (128 KB an SM).  More read no faster from a clean L2 and slower
// from one a flush left dirty (PERF.md).
constexpr int kQuantBlocksPerSm = 2;
// int8_dequantize's blocks an SM: a full SM (2,048 threads, one 16-byte load
// each in flight).  Of 1, 2, 4 and 8 it read fastest behind either flush
// (PERF.md).
constexpr int kDequantBlocksPerSm = 8;

// int8_quantize's input types: one element as f32, and element k of a step's
// 16 as loaded (kWords 16-byte words; k a constant once unrolled).
template <typename T> struct QuantIn;

__device__ __forceinline__ unsigned word(const uint4* w, int i) {
  const uint4 v = w[i / 4];
  return i % 4 == 0 ? v.x : i % 4 == 1 ? v.y : i % 4 == 2 ? v.z : v.w;
}

template <> struct QuantIn<float> {
  static constexpr int kWords = 4;
  __device__ static float one(const float* x) { return *x; }
  __device__ static float at(const uint4* w, int k) { return __uint_as_float(word(w, k)); }
};

template <> struct QuantIn<__nv_bfloat16> {
  static constexpr int kWords = 2;
  __device__ static float one(const __nv_bfloat16* x) { return __bfloat162float(*x); }
  __device__ static float at(const uint4* w, int k) {  // a bf16's bits are the f32's upper half: exact
    const unsigned v = word(w, k / 2);
    return __uint_as_float(k % 2 ? v & 0xffff0000u : v << 16);
  }
};

template <> struct QuantIn<__half> {
  static constexpr int kWords = 2;
  __device__ static float one(const __half* x) { return __half2float(*x); }
  __device__ static float at(const uint4* w, int k) {
    const unsigned v = word(w, k / 2);
    return __half2float(__ushort_as_half(static_cast<unsigned short>(k % 2 ? v >> 16 : v & 0xffffu)));
  }
};

// clip(floor(x * inv + u), -127, 127), product and sum rounded apart.
__device__ __forceinline__ float round_q(float x, float inv, float u) {
  return fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(x, inv), u)), -kQmax), kQmax);
}

// An integral f in [-127, 127] as the bits of 2^23 + 2^22 + f (exact): its
// low byte is f's int8.
__device__ __forceinline__ unsigned byte_of(float f) { return __float_as_uint(__fadd_rn(f, 12582912.0f)); }

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ unsigned pack4(unsigned b0, unsigned b1, unsigned b2, unsigned b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

template <typename T, typename Idx>
__device__ __forceinline__ void load_step(const T* x, const float* u, Idx c, uint4 (&xw)[QuantIn<T>::kWords],
                                          uint4 (&uw)[4]) {
  const uint4* xp = reinterpret_cast<const uint4*>(x + c * kStep);
  const uint4* up = reinterpret_cast<const uint4*>(u + c * kStep);
#pragma unroll
  for (int i = 0; i < QuantIn<T>::kWords; ++i) xw[i] = __ldg(xp + i);
#pragma unroll
  for (int i = 0; i < 4; ++i) uw[i] = __ldg(up + i);
}

template <typename T>
__device__ __forceinline__ uint4 round_step(const uint4 (&xw)[QuantIn<T>::kWords], const uint4 (&uw)[4],
                                            float inv) {
  unsigned b[kStep];
#pragma unroll
  for (int k = 0; k < kStep; ++k) b[k] = byte_of(round_q(QuantIn<T>::at(xw, k), inv, __uint_as_float(word(uw, k))));
  return make_uint4(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]), pack4(b[8], b[9], b[10], b[11]),
                    pack4(b[12], b[13], b[14], b[15]));
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
int8_quantize_kernel(const T* __restrict__ x, const float* __restrict__ u, const float* __restrict__ s,
                     int8_t* __restrict__ q, Idx n, bool vec) {
  const float inv = 1.0f / __ldg(s);
  const Idx t = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  const Idx threads = static_cast<Idx>(gridDim.x) * kThreads;
  Idx done = 0;
  if (vec) {
    const Idx steps = n / kStep;
    uint4* q4 = reinterpret_cast<uint4*>(q);
    for (Idx c = t; c < steps; c += 2 * threads) {
      const bool two = c + threads < steps;
      uint4 xw[2][QuantIn<T>::kWords], uw[2][4];
      load_step(x, u, c, xw[0], uw[0]);
      if (two) load_step(x, u, c + threads, xw[1], uw[1]);
      q4[c] = round_step<T>(xw[0], uw[0], inv);
      if (two) q4[c + threads] = round_step<T>(xw[1], uw[1], inv);
    }
    done = steps * kStep;
  }
  for (Idx i = done + t; i < n; i += threads)
    q[i] = static_cast<int8_t>(byte_of(round_q(QuantIn<T>::one(x + i), inv, __ldg(u + i))));
}

// Four int8 (element 0 in the low byte) times s, each product rounded once.
__device__ __forceinline__ float4 dequant4(unsigned w, float s) {
  const float4 f = combine_rows::Src<int8_t>::widen(w);
  return make_float4(__fmul_rn(f.x, s), __fmul_rn(f.y, s), __fmul_rn(f.z, s), __fmul_rn(f.w, s));
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
int8_dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s, float* __restrict__ out, Idx n,
                       bool vec) {
  // a warp's 32 16-byte loads, staged so that each of its four stores writes
  // 512 contiguous bytes (a thread's own four stores, 16 bytes of every 64 at
  // each instruction, took 1.75x as long: PERF.md)
  __shared__ uint4 stage[kThreads];
  const float scale = __ldg(s);
  const int lane = threadIdx.x % 32;
  const Idx t = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  const Idx threads = static_cast<Idx>(gridDim.x) * kThreads;
  Idx done = 0;
  if (vec) {
    const Idx steps = n / kStep;
    const uint4* q4 = reinterpret_cast<const uint4*>(q);
    float4* o4 = reinterpret_cast<float4*>(out);
    uint4* mine = stage + (threadIdx.x - lane);
    const unsigned* words = reinterpret_cast<const unsigned*>(mine);
    for (Idx base = t - lane; base < steps; base += threads) {  // warp-uniform: the warp's 32 steps
      if (base + lane < steps) mine[lane] = __ldg(q4 + base + lane);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // the warp's word 32 k + lane: step base + 8 k + lane / 4's
        const int w = 32 * k + lane;
        if (base + w / 4 < steps) o4[4 * base + w] = dequant4(words[w], scale);
      }
      __syncwarp();
    }
    done = steps * kStep;
  }
  for (Idx i = done + t; i < n; i += threads) out[i] = __fmul_rn(static_cast<float>(q[i]), scale);
}

// Blocks of one wave of `kernel` at `per_sm` blocks an SM (or fewer where the
// occupancy allows fewer); 0 on an error.
template <typename Kernel>
int wave_of(Kernel kernel, int per_sm, cudaError_t* err) {
  int device = 0, sms = 0, fit = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err == cudaSuccess) *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, 0);
  if (*err != cudaSuccess) return 0;
  return sms * (fit < 1 ? 1 : fit < per_sm ? fit : per_sm);
}

// The grid for `items` thread-steps: one wave, or fewer blocks where the
// steps need fewer.
int grid_of(int64_t items, int wave) {
  const int64_t need = (items + kThreads - 1) / kThreads;
  return static_cast<int>(need < wave ? (need > 0 ? need : 1) : wave);
}

// Launches int8_dequantize_kernel<Idx> with a one-wave grid
// (kDequantBlocksPerSm blocks an SM).
template <typename Idx>
cudaError_t launch_dequantize(const void* q, const void* s, void* out, int64_t n, cudaStream_t stream) {
  auto kernel = int8_dequantize_kernel<Idx>;
  static int wave = 0;  // blocks of one wave, found at the first launch
  if (wave == 0) {
    cudaError_t err;
    wave = wave_of(kernel, kDequantBlocksPerSm, &err);
    if (err != cudaSuccess) return err;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int grid = grid_of(vec ? n / kStep : n, wave);
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const int8_t*>(q), static_cast<const float*>(s),
                                        static_cast<float*>(out), static_cast<Idx>(n), vec);
  return cudaGetLastError();
}

// Launches int8_quantize_kernel<T, Idx> with a one-wave grid (kQuantBlocksPerSm
// an SM, or fewer where the occupancy allows fewer or the steps need fewer);
// the vector path when x, u and q all start 16-byte aligned.
template <typename T, typename Idx>
cudaError_t launch_quantize(const void* x, const void* u, const void* s, void* q, int64_t n, cudaStream_t stream) {
  auto kernel = int8_quantize_kernel<T, Idx>;
  static int wave = 0;  // blocks of one wave, found at the first launch
  if (wave == 0) {
    cudaError_t err;
    wave = wave_of(kernel, kQuantBlocksPerSm, &err);
    if (err != cudaSuccess) return err;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(u) |
                    reinterpret_cast<uintptr_t>(q)) % 16 == 0;
  const int grid = grid_of(vec ? n / kStep : n, wave);
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const float*>(u),
                                        static_cast<const float*>(s), static_cast<int8_t*>(q),
                                        static_cast<Idx>(n), vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_quantize(const void* x, const void* u, const void* s, void* q, int64_t n, cudaStream_t stream) {
  return n < (int64_t{1} << 31) ? launch_quantize<T, int>(x, u, s, q, n, stream)
                                : launch_quantize<T, int64_t>(x, u, s, q, n, stream);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError(): 0
// when the launch was accepted.  None synchronises or allocates.

// x_dtype: 0 f32, 1 bf16, 2 f16.
extern "C" int int8_quantize_i8(const void* x, int x_dtype, const void* u, const void* s, void* q,
                                int64_t n, void* stream) {
  if (n < 1 || x_dtype < 0 || x_dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 1)
    err = dispatch_quantize<__nv_bfloat16>(x, u, s, q, n, st);
  else if (x_dtype == 2)
    err = dispatch_quantize<__half>(x, u, s, q, n, st);
  else
    err = dispatch_quantize<float>(x, u, s, q, n, st);
  return static_cast<int>(err);
}

extern "C" int int8_dequantize_f32(const void* q, const void* s, void* out, int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(n < (int64_t{1} << 31) ? launch_dequantize<int>(q, s, out, n, st)
                                                 : launch_dequantize<int64_t>(q, s, out, n, st));
}

// a: the stacked (P, M, N) off-diagonal weights through their element
// strides; s: the scales, source n's in column sid at s[n ss_n + sid ss_col]
// (the kernel forms a[m, n] * s[n] with one f32 rounding, as the plain
// version does); tiles: the (n_tiles, 4) int64 tile table, or null for one
// segment over [0, n_cols).
extern "C" int dequant_combine_segments(const void* a, int ws_p, int ws_m, int ws_n, const void* s, int ss_n,
                                        int ss_col, const void* q, int64_t ldq, void* out, int64_t ldo,
                                        const void* tiles, int64_t n_tiles, int64_t n_cols, int M, int N,
                                        void* stream) {
  combine_rows::Params prm{};
  prm.w = static_cast<const float*>(a);
  prm.s = static_cast<const float*>(s);
  prm.x = q;
  prm.out = out;
  prm.tiles = static_cast<const int64_t*>(tiles);
  prm.ldx = ldq;
  prm.ldo = ldo;
  prm.n_tiles = n_tiles;
  prm.n_cols = n_cols;
  prm.ws_p = ws_p;
  prm.ws_m = ws_m;
  prm.ws_n = ws_n;
  prm.ss_n = ss_n;
  prm.ss_col = ss_col;
  prm.M = M;
  prm.N = N;
  return combine_rows::launch<int8_t, float, true>(prm, stream);
}
