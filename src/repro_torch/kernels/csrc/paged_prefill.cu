// Paged chunked-prefill flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_prefill_kernel` / `paged_prefill_flash`
// of src/repro/kernels/flash_attention.py (its pallas_call at line 279).
// It computes the same function: C prompt-chunk rows, each a different
// sequence at its own depth.  Query t of row c sits at absolute position
// offset[c] + t and attends, causally, to the KV positions below
// kv_valid = offset[c] + lengths[c] that the row's page table maps
// (position p lives in frame page_rows[c, p / page] at row p % page),
// optionally inside a sliding window.  Online softmax in f32, bf16 q and
// store.  Query rows t >= lengths[c] are don't-care, as on the TPU.
//
// Layout: q and out (C, T, H, D), the model layout; k_pages / v_pages
// (N, page, Hkv, D); page_rows (C, pages_per_seq) int32; offset and
// lengths (C,) int32.  H = G * Hkv, query head h reads KV head h / G,
// any G; head dims 16, 32, 64, 80 and 128 (a thread holds D / 16 float4
// chunks of its query row, so any multiple of 16 fits the design).
//
// Entry points: paged_prefill_attention_bf16 for a bf16 pool, and _int8 /
// _fp8 for the frames of a quantized pool (element types in
// kv_types.cuh), which take k_scales / v_scales (N, Hkv) f32: the TPU
// kernel's quantized instance (its scale BlockSpecs at line 257).  Each
// staged K or V row is multiplied, element by element, by the scale of
// the frame it was read from (a 32-position tile straddles two frames at
// page 16), as the plain version dequantizes its gathered view.  No
// position at or past the tile's last visible one is read, scale
// included.
//
// Design: one block of 256 threads per (64-query tile, query head, chunk
// row).  Four threads share a query row, each holding a quarter of q and
// of the output accumulator in registers (interleaved float4 chunks, so
// the four read neighbouring shared-memory words).  The block walks the
// KV positions its tile can see in tiles of 32: K and V rows are gathered
// through the page table with 16-byte loads, converted to f32 into shared
// memory, and every query row scores, rescales and accumulates against
// them.  The KV range starts at the window's first tile (or 0) and ends
// at the last position the tile's live queries may attend, which is the
// TPU kernel's frame-liveness test; a tile whose queries all lie at or
// past lengths[c] writes zeros and reads nothing.
//
// Bound on the card: at the main path's shapes (T = 256 chunk rows over a
// prefix of up to ~1.5k positions, D = 128) the work is ~4 * T * S * D
// flops per head against ~4 * S * D bytes of K/V per KV head: operations,
// at the 989 TFLOP/s bf16 tensor-core rate.  This simple version does its
// products on the CUDA cores in f32, so it sits far from that bound;
// moving Q.K^T and P.V onto wgmma/mma tiles is the known next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kv_types.cuh"

namespace {

using repro_kv::load8_dequant;

constexpr int kThreads = 256;
constexpr int kThreadsPerRow = 4;
constexpr int kBlockQ = kThreads / kThreadsPerRow;   // 64 query rows
constexpr int kBlockK = 32;                          // KV positions per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// KV: the pool's element type (T is the chunk length here).
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ page_rows,
    const int* __restrict__ offsets, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int T, int num_heads, int num_kv_heads,
    int page, int pages_per_seq, int window, float scale) {
  constexpr int kChunks = D / 4;                  // float4 chunks per row
  constexpr int kMine = kChunks / kThreadsPerRow; // chunks per thread
  constexpr int kVecs = D / 8;                    // 8-element loads per row
  __shared__ float4 k_s[kBlockK][kChunks];
  __shared__ float4 v_s[kBlockK][kChunks];

  const int qt = blockIdx.x, h = blockIdx.y, c = blockIdx.z;
  const int kvh = h / (num_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow, sub = tid % kThreadsPerRow;
  const int off = offsets[c], len = lengths[c];
  const int kv_valid = off + len;
  const int t_first = qt * kBlockQ;
  const int t = t_first + row;
  const long row_off = ((static_cast<long>(c) * T + t) * num_heads + h) * D;

  if (t_first >= len) {          // the whole tile is padding: don't-care
    if (t < T) {
      for (int i = 0; i < kMine; ++i) {
        const int d = (sub + kThreadsPerRow * i) * 4;
        for (int e = 0; e < 4; ++e) out[row_off + d + e] = __float2bfloat16(0.f);
      }
    }
    return;
  }

  const int q_pos = off + t;
  const int last_live = min(t_first + kBlockQ, len) - 1;
  const int hi = min(kv_valid, off + last_live + 1);
  int lo = 0;
  if (window > 0) lo = max(0, off + t_first - window + 1) / kBlockK * kBlockK;

  float4 qr[kMine], acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = acc[i];
    if (t < T) {
      const int d = (sub + kThreadsPerRow * i) * 4;
      const uint2 raw = *reinterpret_cast<const uint2*>(q + row_off + d);
      const __nv_bfloat162* hq = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(hq[0]), b = __bfloat1622float2(hq[1]);
      qr[i] = make_float4(a.x * scale, a.y * scale, b.x * scale, b.y * scale);
    }
  }
  float m = kNegInf, l = 0.f;
  const int* rows = page_rows + static_cast<long>(c) * pages_per_seq;
  const long row_stride = static_cast<long>(num_kv_heads) * D;

  for (int k0 = lo; k0 < hi; k0 += kBlockK) {
    __syncthreads();             // the previous tile's reads are done
    for (int i = tid; i < kBlockK * kVecs; i += kThreads) {
      const int r = i / kVecs, vec = i % kVecs;
      const int pos = k0 + r;
      float kf[8], vf[8];
      if (pos < hi) {
        const int frame = rows[min(pos / page, pages_per_seq - 1)];
        const long base = (static_cast<long>(frame) * page + pos % page) * row_stride
                          + static_cast<long>(kvh) * D + vec * 8;
        const long si = static_cast<long>(frame) * num_kv_heads + kvh;
        load8_dequant(k_pages + base, k_scales, si, kf);
        load8_dequant(v_pages + base, v_scales, si, vf);
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
      bool ok = pos < kv_valid && pos <= q_pos;
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

  if (t < T) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int d = (sub + kThreadsPerRow * i) * 4;
      __nv_bfloat162 lo2 = __floats2bfloat162_rn(acc[i].x * inv, acc[i].y * inv);
      __nv_bfloat162 hi2 = __floats2bfloat162_rn(acc[i].z * inv, acc[i].w * inv);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + row_off + d);
      dst[0] = lo2;
      dst[1] = hi2;
    }
  }
}

// One entry point's body: element type KV of the pool; k_scales /
// v_scales are null for bf16.
template <typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* page_rows,
           const void* offsets, const void* lengths, void* out,
           int chunk_rows, int T_len, int num_heads, int num_kv_heads,
           int head_dim, int page, int pages_per_seq, int window, float scale,
           void* stream) {
  if (num_kv_heads <= 0 || num_heads % num_kv_heads) return cudaErrorInvalidValue;
  if (repro_kv::Elem<KV>::kScaled && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((T_len + kBlockQ - 1) / kBlockQ, num_heads, chunk_rows);
  auto qq = static_cast<const __nv_bfloat16*>(q);
  auto kk = static_cast<const KV*>(k_pages);
  auto vv = static_cast<const KV*>(v_pages);
  auto ks = static_cast<const float*>(k_scales);
  auto vs = static_cast<const float*>(v_scales);
  auto pr = static_cast<const int*>(page_rows);
  auto of = static_cast<const int*>(offsets);
  auto ln = static_cast<const int*>(lengths);
  auto oo = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_PREFILL_CASE(DD)                                                \
  case DD:                                                                    \
    paged_prefill_kernel<KV, DD><<<grid, kThreads, 0, s>>>(                   \
        qq, kk, vv, ks, vs, pr, of, ln, oo, T_len, num_heads, num_kv_heads,   \
        page, pages_per_seq, window, scale);                                  \
    break;
  switch (head_dim) {
    REPRO_PREFILL_CASE(16)
    REPRO_PREFILL_CASE(32)
    REPRO_PREFILL_CASE(64)
    REPRO_PREFILL_CASE(80)
    REPRO_PREFILL_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PREFILL_CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_prefill_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_rows, const void* offsets, const void* lengths, void* out,
    int chunk_rows, int T, int num_heads, int num_kv_heads, int head_dim,
    int page, int pages_per_seq, int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                               page_rows, offsets, lengths, out, chunk_rows, T,
                               num_heads, num_kv_heads, head_dim, page,
                               pages_per_seq, window, scale, stream);
}

// The quantized pool's instances: k_scales / v_scales (N, Hkv) f32.
#define REPRO_QUANT_ENTRY(SUFFIX, ELEM)                                       \
  extern "C" int paged_prefill_attention_##SUFFIX(                            \
      const void* q, const void* k_pages, const void* v_pages,                \
      const void* k_scales, const void* v_scales, const void* page_rows,      \
      const void* offsets, const void* lengths, void* out, int chunk_rows,    \
      int T, int num_heads, int num_kv_heads, int head_dim, int page,         \
      int pages_per_seq, int window, float scale, void* stream) {             \
    return launch<ELEM>(q, k_pages, v_pages, k_scales, v_scales, page_rows,   \
                        offsets, lengths, out, chunk_rows, T, num_heads,      \
                        num_kv_heads, head_dim, page, pages_per_seq, window,  \
                        scale, stream);                                       \
  }

REPRO_QUANT_ENTRY(int8, int8_t)
REPRO_QUANT_ENTRY(fp8, __nv_fp8_e4m3)
#undef REPRO_QUANT_ENTRY

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
