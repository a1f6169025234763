// wire_view.cuh: the receiver's view of one slab element under a wire codec,
// shared by every kernel of slab_codec.cu.
//
// Bit for bit the reference's wire (repro/comm/rng.py, repro/core/packing.py
// slab_encode_batched / slab_decode):
//
//   int8   q = clip(floor(x / s + u), -qmax, qmax), seen as q * s, with
//          s = scales[agent, col_seg[c]] and
//          u = bits_to_uniform(counter_bits(w0[agent, leaf], w1[agent, leaf], col_idx[c])),
//          leaf = col_leaf[c];
//   bf16 / f16  the f32 round trip of a round-to-nearest-even cast;
//   sent   a given f32 wire (top-k's sent values);
//   int8q  the int8 wire q stored as (K, D) int8 (by a pass that encoded
//          it), seen as q * s: the same bits as int8 without the hash.
//
// Every float step is spelled with an _rn intrinsic, so nvcc's fma contraction
// cannot merge x / s + u or q * s into one rounding.  The library is built
// without --use_fast_math: x / s must be IEEE division.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace slab_wire {

constexpr int kLanes = 128;     // column-block width (SlabLayout.lane)
constexpr int kMaxAgents = 64;  // largest K the kernels take

enum Mode : int {
  kInt8 = 0,  // int8 encoded here from x (counter hash, scale, stochastic round)
  kBf16 = 1,
  kF16 = 2,
  kSent = 3,
  kInt8Q = 4,  // int8 read back from a stored (K, D) int8 wire
};

struct Wire {
  int mode;
  const float* scales;       // kInt8: (K, n_segs)
  const int32_t* col_seg;    // kInt8: (D,) scale segment of each column
  const int32_t* col_leaf;   // kInt8: (D,) tree leaf of each column
  const uint32_t* col_idx;   // kInt8: (D,) reference element index within its leaf
  const uint32_t* w0;        // kInt8: (K, n_leaves) leaf key words
  const uint32_t* w1;
  const float* sent;         // kSent: (K, D)
  const int8_t* q;           // kInt8Q: (K, D)
  int n_segs;
  int n_leaves;
  float qmax;
};

// The per-column part of the wire, loaded once per column.
struct Column {
  int64_t c;
  int32_t seg;
  int32_t leaf;
  uint32_t idx;
};

template <int MODE>
__device__ __forceinline__ Column load_column_as(const Wire& w, int64_t c) {
  Column col{c, 0, 0, 0u};
  if constexpr (MODE == kInt8 || MODE == kInt8Q) col.seg = w.col_seg[c];
  if constexpr (MODE == kInt8) {
    col.leaf = w.col_leaf[c];
    col.idx = w.col_idx[c];
  }
  return col;
}

__device__ __forceinline__ Column load_column(const Wire& w, int64_t c) {
  switch (w.mode) {
    case kInt8:
      return load_column_as<kInt8>(w, c);
    case kInt8Q:
      return load_column_as<kInt8Q>(w, c);
    default:
      return load_column_as<kSent>(w, c);
  }
}

// murmur3 fmix32; uint32 products wrap mod 2^32 as in repro/comm/rng.py.
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t counter_bits(uint32_t w0, uint32_t w1, uint32_t idx) {
  uint32_t x = idx * 0x9E3779B9u + w0;
  x = fmix32(x) ^ w1;
  return fmix32(x);
}

// top 24 bits times 2^-24: exact, in [0, 1)
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
}

// The int8 value (held in f32) and its scale for agent a at column col.
__device__ __forceinline__ float int8_encode(const Wire& w, const Column& col, int a, float x,
                                             float* scale) {
  const float s = w.scales[a * w.n_segs + col.seg];
  const int kw = a * w.n_leaves + col.leaf;
  const float u = bits_to_uniform(counter_bits(w.w0[kw], w.w1[kw], col.idx));
  const float q = floorf(__fadd_rn(__fdiv_rn(x, s), u));
  *scale = s;
  return fminf(fmaxf(q, -w.qmax), w.qmax);
}

// The decoded (receiver's) f32 view of agent a's element x at column col,
// for a mode known at compile time (x is not read for kSent and kInt8Q).
template <int MODE>
__device__ __forceinline__ float wire_view_as(const Wire& w, const Column& col, int a, int64_t D,
                                              float x) {
  if constexpr (MODE == kInt8) {
    float s;
    const float q = int8_encode(w, col, a, x, &s);
    return __fmul_rn(q, s);
  } else if constexpr (MODE == kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (MODE == kF16) {
    return __half2float(__float2half_rn(x));
  } else if constexpr (MODE == kInt8Q) {
    return __fmul_rn(static_cast<float>(w.q[a * D + col.c]), w.scales[a * w.n_segs + col.seg]);
  } else {
    return w.sent[a * D + col.c];
  }
}

__device__ __forceinline__ float wire_view(const Wire& w, const Column& col, int a, int64_t D,
                                           float x) {
  switch (w.mode) {
    case kInt8:
      return wire_view_as<kInt8>(w, col, a, D, x);
    case kBf16:
      return wire_view_as<kBf16>(w, col, a, D, x);
    case kF16:
      return wire_view_as<kF16>(w, col, a, D, x);
    case kInt8Q:
      return wire_view_as<kInt8Q>(w, col, a, D, x);
    default:
      return wire_view_as<kSent>(w, col, a, D, x);
  }
}

}  // namespace slab_wire
