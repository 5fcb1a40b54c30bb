// Paged GQA attention of a few query rows per sequence, for Hopper
// (sm_90a): the one template behind the decode kernel (paged_decode.cu,
// one row per sequence) and the speculative verify kernel
// (paged_verify.cu, S = K + 1 rows per sequence).
//
// Function: for each sequence b, query row s and query head h,
// softmax(q . K^T / sqrt(D)) . V over the first lengths[b, s] KV
// positions, where position p lives in pool frame page_table[b, p / page]
// at row p % page.  Online softmax in f32, bf16 q, bf16 store.  A row
// with lengths[b, s] == 0 stores zeros.
//
// Layout: q and out (B, S, H, D) (S = 1 for decode: (B, H, D)); k_pages /
// v_pages (N, page, Hkv, D), so one pool row of one KV head is D
// contiguous elements (256 bytes of bf16 at D = 128, 128 bytes of int8 or
// fp8) and rows are Hkv * D apart; page_table (B, pages_per_seq) int32;
// lengths (B, S) int32.  H = G * Hkv, query head h reads KV head h / G.
//
// Element type T (kv_types.cuh): bf16, or the int8 / fp8 (e4m3) frames of
// a quantized pool with k_scales / v_scales (N, Hkv) f32.  The scale is
// per frame and a 64-position tile is not (at page 16 it straddles four
// frames), so each K or V row takes the scale of the frame it was read
// from, looked up beside the row, k_scales[frame * Hkv + kv head], and
// multiplies each of its elements as it is widened to f32 (the JAX
// package's dequant of the gathered view, element by element).  Decode
// and verify share that code, so verify row s stays bitwise the decode
// kernel at lengths[:, s] for every element type.  No scale is read for
// a position at or past the longest row length, so the trash frame's junk
// scale is never touched.
//
// Design: one block of 128 threads per (KV head, sequence, group of SB
// query rows).  The block stages its R = SB * G query rows (SB rows s of
// G heads each) and walks the sequence's KV positions in tiles of 64, each
// position mapped through the table, so a tile may straddle several
// frames.  All R rows share each K/V row it loads, which is what the
// verify kernel is for: one pass over a sequence's pages scores K + 1
// tokens.
//   1. scores: a K row is read by D/8 lanes, 16 bytes each; the R partial
//      dot products are reduced with warp shuffles;
//   2. softmax: one warp per query row updates the running max and sum;
//   3. P.V: each thread owns 8 dims of the output for a subset of the
//      tile's positions, and the position groups are summed once at the
//      end, one row at a time.
// The tile loop ends at the last tile that holds a position below the
// largest of the block's row lengths, and every row is masked by its own
// length: a row sees exactly what the decode kernel (SB = 1) would see at
// that length, through the same arithmetic in the same order.  Past its
// own length a row's tiles add exact zeros (p = 0, rescale by exp(0) = 1),
// so row s of the verify kernel is bitwise the decode kernel at
// lengths[:, s].  Table indices are clamped to pages_per_seq - 1, and no
// position at or past the largest row length is read.
//
// Bound on the card: bytes.  A step reads every valid K and V row once
// (2 * len * D * sizeof(T) bytes per sequence and KV head, plus a scale
// pair per frame when quantized) and does 4 * R * D flops per position,
// far below the ~295 flop/byte ridge of an H100.  A 1-byte pool halves
// the bytes, and with them the bound; this version is not near it.
// What limits this simple version is parallelism: B * Hkv blocks (64 at
// B = 8, Hkv = 8) leave most of the 132 SMs idle, and each block walks its
// tiles one after another.  Splitting the KV axis across blocks with a
// second reduction pass (flash-decoding) is the known next step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kv_types.cuh"

namespace repro_paged {

using repro_kv::load8_dequant;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr float kNegInf = -1e30f;

// Grid (Hkv, B, ceil(S / SB)); block z covers query rows s0 .. s0 + SB - 1.
template <typename T, int G, int D, int SB>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ page_table,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    int num_kv_heads, int S, int page, int pages_per_seq, float scale) {
  constexpr int R = SB * G;                            // query rows per block
  constexpr int kLanesPerRow = D / 8;                  // 8 elements per lane
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kRowGroups = kThreads / kLanesPerRow;  // P.V position split
  static_assert(kTile % (kWarps * kRowsPerWarp) == 0, "tile rows");
  static_assert(kTile % kRowGroups == 0, "tile rows");

  __shared__ float q_s[R][D];
  __shared__ float p_s[R][kTile];
  __shared__ float m_s[R], l_s[R], corr_s[R];
  __shared__ int len_s[SB];
  __shared__ float red_s[kRowGroups][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * SB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* pt = page_table + static_cast<long>(b) * pages_per_seq;
  const long row_stride = static_cast<long>(num_kv_heads) * D;
  const long head_off = static_cast<long>(kvh) * D;
  // (b, s, kvh, g, :) of q / out: rows s of one KV head are H * D apart
  const long q_row = static_cast<long>(num_kv_heads) * G * D;
  const long q_base = (static_cast<long>(b) * S + s0) * q_row
                      + static_cast<long>(kvh) * G * D;

  if (tid < SB) len_s[tid] = s0 + tid < S ? lengths[b * S + s0 + tid] : 0;
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int sl = r / G, g = r % G;
    q_s[r][d] = s0 + sl < S
        ? __bfloat162float(q[q_base + sl * q_row + g * D + d]) * scale
        : 0.f;
  }
  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int sub = tid % kLanesPerRow;   // 8 dims [sub*8, sub*8+8)
  const int grp = tid / kLanesPerRow;   // P.V positions grp, grp+kRowGroups, ...
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  __syncthreads();

  int len_max = 0;
#pragma unroll
  for (int sl = 0; sl < SB; ++sl) len_max = max(len_max, len_s[sl]);

  const int n_tiles = (len_max + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kTile;
    // 1. scores for the tile's positions, all R rows at once
    for (int c = warp * kRowsPerWarp + lane / kLanesPerRow; c < kTile;
         c += kWarps * kRowsPerWarp) {
      const int pos = t0 + c;
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
      if (pos < len_max) {
        const int frame = pt[min(pos / page, pages_per_seq - 1)];
        const long base = (static_cast<long>(frame) * page + pos % page) * row_stride
                          + head_off + sub * 8;
        float kf[8];
        load8_dequant(k_pages + base, k_scales,
                      static_cast<long>(frame) * num_kv_heads + kvh, kf);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) part[r] += q_s[r][sub * 8 + e] * kf[e];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
      if (sub == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          p_s[r][c] = pos < len_s[r / G] ? part[r] : kNegInf;
      }
    }
    __syncthreads();
    // 2. online softmax: one warp per query row; positions past the row's
    //    own length weigh exactly 0
    for (int r = warp; r < R; r += kWarps) {
      const int len = len_s[r / G];
      float mx = kNegInf;
      for (int c = lane; c < kTile; c += 32) mx = fmaxf(mx, p_s[r][c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < kTile; c += 32) {
        const float e = t0 + c < len ? expf(p_s[r][c] - m_new) : 0.f;
        p_s[r][c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + P . V over this thread's positions and dims
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float corr = corr_s[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
    }
    for (int c = grp; c < kTile; c += kRowGroups) {
      const int pos = t0 + c;
      if (pos >= len_max) break;
      const int frame = pt[min(pos / page, pages_per_seq - 1)];
      const long base = (static_cast<long>(frame) * page + pos % page) * row_stride
                        + head_off + sub * 8;
      float vf[8];
      load8_dequant(v_pages + base, v_scales,
                    static_cast<long>(frame) * num_kv_heads + kvh, vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = p_s[r][c];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] += p * vf[e];
      }
    }
    __syncthreads();   // p_s and corr_s are rewritten by the next tile
  }

  // per row: sum the position groups' partial outputs, normalise, store
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red_s[grp][sub * 8 + e] = acc[r][e];
    __syncthreads();
    const int sl = r / G;
    if (s0 + sl < S) {
      for (int d = tid; d < D; d += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kRowGroups; ++j) s += red_s[j][d];
        out[q_base + sl * q_row + (r % G) * D + d] =
            __float2bfloat16(s / fmaxf(l_s[r], 1e-30f));
      }
    }
    __syncthreads();   // red_s is rewritten for the next row
  }
}

// The operands of one launch, element type T for the pool.
template <typename T>
struct Args {
  const __nv_bfloat16* q;
  const T* k;
  const T* v;
  const float* ks;   // null for bf16
  const float* vs;
  const int* pt;
  const int* len;
  __nv_bfloat16* out;
  int batch, S, num_kv_heads, page, pps;
  float scale;
};

// Launch one instance; returns the launch's CUDA error.
template <typename T, int G, int D, int SB>
cudaError_t launch_gd(const Args<T>& a, cudaStream_t stream) {
  const dim3 grid(a.num_kv_heads, a.batch, (a.S + SB - 1) / SB);
  paged_attention_kernel<T, G, D, SB><<<grid, kThreads, 0, stream>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.pt, a.len, a.out, a.num_kv_heads, a.S,
      a.page, a.pps, a.scale);
  return cudaGetLastError();
}

// Rows per block: 1 for decode; for verify, as many whole rows s as keep
// R = SB * G <= 16 (the per-thread accumulator is R * 8 f32 registers).
template <bool kVerify, int G>
constexpr int rows_per_block() {
  return kVerify ? (16 / G > 0 ? 16 / G : 1) : 1;
}

template <bool kVerify, typename T, int D>
cudaError_t launch_d(int groups, const Args<T>& a, cudaStream_t stream) {
#define REPRO_PAGED_CASE(GG)                                                  \
  case GG:                                                                    \
    return launch_gd<T, GG, D, rows_per_block<kVerify, GG>()>(a, stream);
  switch (groups) {
    REPRO_PAGED_CASE(1)
    REPRO_PAGED_CASE(2)
    REPRO_PAGED_CASE(3)
    REPRO_PAGED_CASE(4)
    REPRO_PAGED_CASE(6)
    REPRO_PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_CASE
}

// One entry point's body: element type T of the pool; k_scales /
// v_scales are null for bf16.
template <bool kVerify, typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* page_table,
           const void* lengths, void* out, int batch, int S, int num_heads,
           int num_kv_heads, int head_dim, int page, int pages_per_seq,
           float scale, void* stream) {
  if (num_kv_heads <= 0 || num_heads % num_kv_heads || S <= 0)
    return cudaErrorInvalidValue;
  if (repro_kv::Elem<T>::kScaled && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  const int groups = num_heads / num_kv_heads;
  const Args<T> a{static_cast<const __nv_bfloat16*>(q),
                  static_cast<const T*>(k_pages),
                  static_cast<const T*>(v_pages),
                  static_cast<const float*>(k_scales),
                  static_cast<const float*>(v_scales),
                  static_cast<const int*>(page_table),
                  static_cast<const int*>(lengths),
                  static_cast<__nv_bfloat16*>(out),
                  batch, S, num_kv_heads, page, pages_per_seq, scale};
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_d<kVerify, T, 64>(groups, a, s);
    case 128:
      return launch_d<kVerify, T, 128>(groups, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro_paged

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
