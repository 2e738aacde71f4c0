// A 16-byte vector of channels (4 float or 8 bfloat16), as the kernels of
// this directory load and store it: unpack to fp32, pack with one rounding
// to nearest even, and round an fp32 value to the element type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void unpack(const uint4& q, float (&v)[N]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // a 32-bit word holds two bf16: element 2i in the low half, 2i+1 in the high
  static __device__ __forceinline__ void unpack(const uint4& q, float (&v)[N]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
    return a | (b << 16);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                      pack2(v[6], v[7]));
  }
};

}  // namespace
