// Element types of the paged K/V pool, shared by the paged attention
// kernels (paged_attention.cuh, paged_prefill.cu).
//
// A pool holds __nv_bfloat16, or the frames of a quantized pool: int8_t,
// or __nv_fp8_e4m3 (OCP E4M3: no infinity, largest finite 448, the same
// format as torch.float8_e4m3fn).  A quantized frame comes with one f32
// scale per (frame, KV head), laid out (N, Hkv): the value of an element
// is float(q) * scale, the JAX package's dequant (`k.astype(f32) * ks`),
// applied here to every element as it is loaded, one f32 product each, so
// a kernel sees exactly the values its plain version gathers.
//
// load8 reads the 8 consecutive elements at p (a lane's share of a K or V
// row) and widens them to f32: one 16-byte load for bf16, one 8-byte load
// for the 1-byte types.  Rows are D elements (a multiple of 8), Hkv * D
// apart, and a lane starts at a multiple of 8 elements, so both loads are
// aligned whenever the pool's base is.  int8 and fp8 widen exactly.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
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

// load8, then the dequant multiply by scales[scale_index] for a quantized
// pool; for bf16 the scales are never read (and may be null).
template <typename T>
__device__ __forceinline__ void load8_dequant(const T* p, const float* scales,
                                              long scale_index, float (&f)[8]) {
  load8(p, f);
  if constexpr (Elem<T>::kScaled) {
    const float s = scales[scale_index];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] *= s;
  }
}

}  // namespace repro_kv
