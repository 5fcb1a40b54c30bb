// Element types of the paged K/V pool, shared by the paged attention
// kernels (paged_attention.cuh, paged_prefill.cu).
//
// A pool holds __nv_bfloat16, or the frames of a quantized pool: int8_t,
// or __nv_fp8_e4m3 (OCP E4M3: no infinity, largest finite 448, the same
// format as torch.float8_e4m3fn).  A quantized frame comes with one f32
// scale per (frame, KV head), laid out (N, Hkv): the value of an element
// is float(q) * scale, the JAX package's dequant (`k.astype(f32) * ks`).
//
// load8 reads the 8 consecutive elements at p (a lane's share of a K or V
// row) and widens them to f32: one 16-byte load for bf16, one 8-byte load
// for the 1-byte types.  Rows are D elements (a multiple of 8), Hkv * D
// apart, and a lane starts at a multiple of 8 elements, so both loads are
// aligned whenever the pool's base is.  int8 and fp8 widen exactly.
//
// widen16 (the quantized paged prefill, which feeds the bf16 tensor
// cores the raw codes and scales outside the products) widens sixteen
// 1-byte codes, one 16-byte load, to sixteen bf16 values, exactly: every
// int8 code has at most 8 significant bits, as bf16, and every finite
// E4M3 code 4 significant bits and an exponent in bf16's range.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace repro_kv {

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kScaled = false;
};
template <>
struct Elem<int8_t> {
  static constexpr bool kScaled = true;
};
template <>
struct Elem<__nv_fp8_e4m3> {
  static constexpr bool kScaled = true;
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float (&f)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8_e4m3* b = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(b[i]);
}

// Four int8 codes (w, code 0 in the low byte) as two bf16x2 words, with
// no conversion instruction: a byte permute puts x ^ 0x80 = x + 128 into
// the low mantissa of the f32 2^23, giving 2^23 + 128 + x; less 2^23 +
// 128 that is x, exactly, and the upper half of an f32 integer of at
// most 8 significant bits is its bf16.
__device__ __forceinline__ uint2 widen4(uint32_t w, int8_t) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i))
        - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}

__device__ __forceinline__ uint32_t bf16x2_of(__half2_raw h) {
  const __nv_bfloat162 b = __float22bfloat162_rn(__half22float2(__half2(h)));
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Four E4M3 codes as two bf16x2 words: two at a time to f16x2 (cvt,
// exact), then through f32 to bf16 (exact).
__device__ __forceinline__ uint2 widen4(uint32_t w, __nv_fp8_e4m3) {
  return make_uint2(
      bf16x2_of(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w & 0xFFFFu), __NV_E4M3)),
      bf16x2_of(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3)));
}

// Sixteen codes of type T (raw, code 0 in the low byte) as sixteen bf16:
// codes 0-7 in lo, 8-15 in hi.
template <typename T>
__device__ __forceinline__ void widen16(uint4 raw, uint4& lo, uint4& hi) {
  const uint2 a = widen4(raw.x, T()), b = widen4(raw.y, T());
  const uint2 c = widen4(raw.z, T()), d = widen4(raw.w, T());
  lo = make_uint4(a.x, a.y, b.x, b.y);
  hi = make_uint4(c.x, c.y, d.x, d.y);
}

}  // namespace repro_kv
