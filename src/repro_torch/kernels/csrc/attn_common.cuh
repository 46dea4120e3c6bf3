// Helpers shared by the attention kernels' FFMA bodies (flash_attn.cu, the
// forward; flash_attn_bwd.cu, the backward): 8-element loads of float32 or
// bfloat16 rows into float32, 4-element stores back, a tile of rows staged
// into shared memory as float32, and the reductions over the 16 lanes of a
// row group.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

constexpr float kNegInf = -1e30f;  // the masked score of the reference (not -inf)

__device__ __forceinline__ void load8(const float* __restrict__ p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [row0, row0 + kRows) of one head of a (.., n, heads, hd) tensor
// (`base` points at row 0 of the head, rows `stride` elements apart), times
// `scale`, into the float32 tile s[kRows][ld]; rows at or past n are zeros.
// The kThreads threads of the block take consecutive 8-element chunks of a
// row: coalesced 16- or 32-byte loads.
template <int kRows, int kThreads, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, int64_t stride,
                                          int64_t row0, int64_t n, int hd, float scale,
                                          float* s, int ld) {
  const int chunks = hd >> 3;
  for (int c = threadIdx.x; c < kRows * chunks; c += kThreads) {
    const int r = c / chunks, col = (c - r * chunks) << 3;
    float v[8];
    if (row0 + r < n) {
      load8(base + (row0 + r) * stride + col, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float* dst = s + r * ld + col;
    store4(dst, make_float4(v[0], v[1], v[2], v[3]));
    store4(dst + 4, make_float4(v[4], v[5], v[6], v[7]));
  }
}

// Component i of v (i a compile-time constant after unrolling).
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Reductions over the 16 lanes that share a row group (xor butterflies:
// every lane ends with the same bits).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace attn
