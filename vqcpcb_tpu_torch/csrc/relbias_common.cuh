// Shared pieces of the attention kernels (relbias_attention.cu,
// relbias_attention_bwd.cu, fused_attention.cu, fused_attention_bwd.cu): the
// dot-type rounding rules, input/output element conversions, the layout and
// bias strides, and the in-kernel dropout hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace relbias {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

enum : int {
  kErrHeadDim = -1,
  kErrSharedMemory = -2,
  kErrDtype = -3,
  kErrAlign = -4,
  kErrScratch = -5
};

// Dot type: the type q, k, v, E (and in the backward do, ds, dc, w) are
// rounded to before a product. Staged operands live in shared memory in it.
template <typename Elem> struct Dot;

template <> struct Dot<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return make_float2(p[0], p[1]);
  }
};

template <> struct Dot<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// Input / output elements (q, k, v, do, out, dq, dk, dv): f32 or bf16.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of a (B, H, L, d) view whose last axis is contiguous:
// (B, H, L, d) itself is (H*L*d, L*d, d); the packed (B, L, H*d) layout is
// (L*H*d, d, H*d); a k or v slice of a packed (B, L, 3*H*d) projection has
// row stride 3*H*d.
struct Layout {
  long long b, h, l;
};

// An explicit (B*H, T, S) f32 bias read through element strides (plane,
// row, column): zero strides broadcast a (B*H, 1, 1) placeholder, and
// p == nullptr means no bias (fused_attention.cu, fused_attention_bwd.cu).
struct Bias {
  const float* p;
  long long bh, t, s;
};

// ---- in-kernel dropout (pallas_attention.py:_hash_u32, _dropout_keep) ----
// keep(t, s) = lowbias32((t*S + s) ^ lowbias32(stream * 0x9E3779B9))
//              >= threshold, all in wrapping uint32, with stream =
// seed + h*B + b for the relative-bias kernels (pallas_attention.py:574,883)
// and threshold = min(round(rate * 2^32), 2^32 - 1).
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t stream_key(uint32_t seed, int h, int b,
                                               int B) {
  return hash_u32((seed + (uint32_t)h * (uint32_t)B + (uint32_t)b) *
                  0x9E3779B9u);
}

// The fused-attention kernels (K6) run on a flat (B*H,) grid: their stream
// is seed + b*H + h, the plane index (pallas_attention.py:203-204).
__device__ __forceinline__ uint32_t plane_key(uint32_t seed, int plane) {
  return hash_u32((seed + (uint32_t)plane) * 0x9E3779B9u);
}

__device__ __forceinline__ bool dropout_keep(uint32_t key, int t, int s, int S,
                                             uint32_t threshold) {
  return hash_u32(((uint32_t)t * (uint32_t)S + (uint32_t)s) ^ key) >= threshold;
}

// Warp-wide reductions.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace relbias
