// Dense blocked flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (its pallas_call at line 114).
// Same function: for batch row b, query t at absolute position
// q_offset + t and query head h, softmax(q . K^T / sqrt(D)) . V over
// the KV positions p < kv_valid of KV head h / G that the mask lets
// through — p <= q_pos when causal, p > q_pos - window when window > 0 —
// with an f32 online softmax and the output in the operands' type.
// Entry points flash_attention_f32 and flash_attention_bf16 (q, k, v and
// out all of that type), head dims 16, 32, 64, 80 and 128 (a thread holds
// D / 16 float4 chunks of its query row), any G.
//
// Layout: the model layout, read in place (no transposes): q and out
// (B, Sq, H, D), k and v (B, Skv, Hkv, D).  H = G * Hkv.
//
// Design: paged_prefill.cu's, on a dense cache.  One block of 256
// threads per (64-query tile, query head, batch row).  Four threads share
// a query row, each holding a quarter of q and of the accumulator in
// registers.  The block walks the KV axis in tiles of 32 positions: K
// and V rows are read with 16-byte loads, widened to f32 into shared
// memory, and every query row scores, rescales and accumulates against
// them.  A tile outside the mask for every query of the block is skipped
// (`continue`), the TPU kernel's block liveness (lines 51-58):
// first_kv < kv_valid, first_kv <= last_q when causal, last_kv > first_q
// - window with a window.  Masked scores are -1e30, finite as in the TPU
// kernel, so a row that meets only masked positions in a live tile
// carries exp(0) weights until its first visible key, where the rescale
// exp(-1e30 - m) = 0 removes them exactly, as the reference's does.  A
// query that sees no key at all (possible only with kv_valid or a window
// that leaves it nothing) is don't-care, as in the reference, whose
// result there depends on its block shapes.
//
// Bound on the card: operations.  A causal prompt of S = 2048 does
// ~4 * S^2 / 2 * D flops per head against ~4 * S * D bytes of q, K, V
// and out per head: far above the ~295 flop/byte bf16 ridge.  This first
// version multiplies on the CUDA cores in f32, so it sits far from the
// tensor-core bound; mma/wgmma tiles for Q.K^T and P.V are the known
// next step, as for the paged prefill kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_io.cuh"

namespace {

using repro_dense::load4;
using repro_dense::load8;
using repro_dense::store4;

constexpr int kThreads = 256;
constexpr int kThreadsPerRow = 4;
constexpr int kBlockQ = kThreads / kThreadsPerRow;   // 64 query rows
constexpr int kBlockK = 32;                          // KV positions per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
    int num_heads, int num_kv_heads, int causal, int window, int q_offset,
    int kv_valid, float scale) {
  constexpr int kChunks = D / 4;                  // float4 chunks per row
  constexpr int kMine = kChunks / kThreadsPerRow; // chunks per thread
  constexpr int kVecs = D / 8;                    // 8-element loads per row
  __shared__ float4 k_s[kBlockK][kChunks];
  __shared__ float4 v_s[kBlockK][kChunks];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (num_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow, sub = tid % kThreadsPerRow;
  const int t_first = qt * kBlockQ;
  const int t = t_first + row;
  const long row_off = ((static_cast<long>(b) * Sq + t) * num_heads + h) * D;
  const int q_pos = q_offset + t;
  const int first_q = q_offset + t_first;
  const int last_q = q_offset + min(t_first + kBlockQ, Sq) - 1;

  float4 qr[kMine], acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = acc[i];
    if (t < Sq) {
      const float4 x = load4(q + row_off + (sub + kThreadsPerRow * i) * 4);
      qr[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
  }
  float m = kNegInf, l = 0.f;
  const long kv_base = static_cast<long>(b) * Skv * num_kv_heads * D
                       + static_cast<long>(kvh) * D;
  const long kv_stride = static_cast<long>(num_kv_heads) * D;

  for (int k0 = 0; k0 < Skv; k0 += kBlockK) {
    // block liveness: skip tiles fully outside the mask
    bool live = k0 < kv_valid;
    if (causal) live = live && k0 <= last_q;
    if (window > 0) live = live && k0 + kBlockK - 1 > first_q - window;
    if (!live) continue;

    __syncthreads();             // the previous tile's reads are done
    for (int i = tid; i < kBlockK * kVecs; i += kThreads) {
      const int r = i / kVecs, vec = i % kVecs;
      const int pos = k0 + r;
      float kf[8], vf[8];
      if (pos < kv_valid) {
        const long off = kv_base + pos * kv_stride + vec * 8;
        load8(k + off, kf);
        load8(v + off, vf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
      }
      k_s[r][2 * vec] = make_float4(kf[0], kf[1], kf[2], kf[3]);
      k_s[r][2 * vec + 1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
      v_s[r][2 * vec] = make_float4(vf[0], vf[1], vf[2], vf[3]);
      v_s[r][2 * vec + 1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    __syncthreads();

    float s[kBlockK];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMine; ++i)
        part += dot4(qr[i], k_s[j][sub + kThreadsPerRow * i]);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int pos = k0 + j;
      bool ok = pos < kv_valid;
      if (causal) ok = ok && pos <= q_pos;
      if (window > 0) ok = ok && pos > q_pos - window;
      s[j] = ok ? part : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      sum += s[j];
    }
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      float4 a = acc[i];
      a.x *= corr; a.y *= corr; a.z *= corr; a.w *= corr;
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        const float4 vv = v_s[j][sub + kThreadsPerRow * i];
        a.x += s[j] * vv.x; a.y += s[j] * vv.y;
        a.z += s[j] * vv.z; a.w += s[j] * vv.w;
      }
      acc[i] = a;
    }
  }

  if (t < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const float4 a = acc[i];
      store4(out + row_off + (sub + kThreadsPerRow * i) * 4,
             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int Sq, int Skv, int num_heads, int num_kv_heads, int head_dim,
           int causal, int window, int q_offset, int kv_valid, float scale,
           void* stream) {
  if (batch <= 0 || Sq <= 0 || Skv <= 0 || num_kv_heads <= 0
      || num_heads % num_kv_heads || q_offset < 0)
    return cudaErrorInvalidValue;
  kv_valid = min(kv_valid, Skv);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  auto qq = static_cast<const T*>(q);
  auto kk = static_cast<const T*>(k);
  auto vv = static_cast<const T*>(v);
  auto oo = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(DD)                                                  \
  case DD:                                                                    \
    flash_attention_kernel<T, DD><<<grid, kThreads, 0, s>>>(                  \
        qq, kk, vv, oo, Sq, Skv, num_heads, num_kv_heads, causal, window,     \
        q_offset, kv_valid, scale);                                           \
    break;
  switch (head_dim) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)
    REPRO_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
  return cudaGetLastError();
}

}  // namespace

#define REPRO_FLASH_ENTRY(SUFFIX, ELEM)                                       \
  extern "C" int flash_attention_##SUFFIX(                                    \
      const void* q, const void* k, const void* v, void* out, int batch,      \
      int Sq, int Skv, int num_heads, int num_kv_heads, int head_dim,         \
      int causal, int window, int q_offset, int kv_valid, float scale,        \
      void* stream) {                                                         \
    return launch<ELEM>(q, k, v, out, batch, Sq, Skv, num_heads,              \
                        num_kv_heads, head_dim, causal, window, q_offset,     \
                        kv_valid, scale, stream);                             \
  }

REPRO_FLASH_ENTRY(f32, float)
REPRO_FLASH_ENTRY(bf16, __nv_bfloat16)
#undef REPRO_FLASH_ENTRY
