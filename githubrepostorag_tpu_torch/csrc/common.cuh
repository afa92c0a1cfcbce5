// Shared helpers for the hand-written Hopper attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace port {

constexpr float NEG_INF = -1e30f;  // masked score, as in the JAX kernels

// dtype codes passed from the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// page-pool element codes passed from the Python wrappers
constexpr int POOL_FP = 0;    // pools in the activation dtype
constexpr int POOL_INT8 = 1;  // int8 codes, one f32 scale per (kv head, page)
constexpr int POOL_INT4 = 2;  // uint8 nibble planes [ps, hd/2], per-page scales

// 16-byte vector load / store of a row segment, widened to / narrowed from
// float32: 4 floats or 8 bf16 values per access.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One head-dim row of a K/V pool or staged buffer whose elements are P,
// read as 16-byte chunks and widened to float32.  STORED is the row's
// length in elements of P, CHUNKS its number of 16-byte chunks.  load()
// writes chunk ch's components, each times `mult`, into dst[0, HD); zero()
// writes 0 to the same components.
template <typename P, int HD>
struct PoolRow;

template <int HD>
struct PoolRow<float, HD> {
  static constexpr int STORED = HD, CHUNKS = HD / 4;
  __device__ static void load(const float* row, int ch, float* dst, float mult) {
    float v[4];
    Vec<float>::load(row + 4 * ch, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[4 * ch + j] = v[j] * mult;
  }
  __device__ static void zero(int ch, float* dst) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[4 * ch + j] = 0.f;
  }
};

template <int HD>
struct PoolRow<__nv_bfloat16, HD> {
  static constexpr int STORED = HD, CHUNKS = HD / 8;
  __device__ static void load(const __nv_bfloat16* row, int ch, float* dst, float mult) {
    float v[8];
    Vec<__nv_bfloat16>::load(row + 8 * ch, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[8 * ch + j] = v[j] * mult;
  }
  __device__ static void zero(int ch, float* dst) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[8 * ch + j] = 0.f;
  }
};

// int8 codes: component c is byte c
template <int HD>
struct PoolRow<int8_t, HD> {
  static constexpr int STORED = HD, CHUNKS = HD / 16;
  __device__ static void load(const int8_t* row, int ch, float* dst, float mult) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + 16 * ch);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[16 * ch + j] = static_cast<float>(b[j]) * mult;
  }
  __device__ static void zero(int ch, float* dst) {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[16 * ch + j] = 0.f;
  }
};

// int4 nibble planes (kv_cache.pack_int4): byte c holds component c in its
// low nibble and component c + HD/2 in its high nibble, two's complement,
// sign-extended as ((x & 0xF) ^ 8) - 8
template <int HD>
struct PoolRow<uint8_t, HD> {
  static constexpr int STORED = HD / 2, CHUNKS = HD / 32;
  __device__ static void load(const uint8_t* row, int ch, float* dst, float mult) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + 16 * ch);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int x = b[j];
      dst[16 * ch + j] = static_cast<float>(((x & 0xF) ^ 8) - 8) * mult;
      dst[16 * ch + j + HD / 2] = static_cast<float>(((x >> 4) ^ 8) - 8) * mult;
    }
  }
  __device__ static void zero(int ch, float* dst) {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[16 * ch + j] = dst[16 * ch + j + HD / 2] = 0.f;
  }
};

__device__ __forceinline__ float warp_max(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace port
