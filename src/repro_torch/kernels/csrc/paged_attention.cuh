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
// Design: one block of 128 threads per (KV head, sequence, group of R
// query rows).  A (KV head, sequence) has S * G query rows, row i = s * G
// + g (verify row s, group head g), and G is a runtime value: block z
// stages rows z * R .. z * R + R - 1.  R is the least of 1, 2, 3, 4, 5,
// 6, 8, 10, 12, 15, 16 that holds the rows, or, past 16 rows, that holds
// an equal share of them over the fewest blocks of at most 16 (rows_for):
// a row slot without a row costs about as much as a row (on the card a
// 16-row block over 15 rows was slower than a 15-row one), so the set
// fits the decode rows of G = 1..6, 8, 12 and the verify rows S * G of
// K = 4 exactly.
// The head dim D is a runtime value too, on a lane width DP of 64 or 128
// (D <= DP, a multiple of 8): a K or V row is read by DP/8 lanes, 8
// elements each, and a lane past D reads the last live lane's elements
// again against q = 0, so head dims 16, 32, 64, 80 and 128 run on two
// widths.  The block walks
// the sequence's KV positions in tiles of 64, each position mapped
// through the table, so a tile may straddle several frames.  All R rows
// share each K/V row it loads, which is what the verify kernel is for:
// one pass over a sequence's pages scores K + 1 tokens.
//   1. scores: the R partial dot products of a K row are reduced with
//      warp shuffles (a lane past D adds an exact 0);
//   2. softmax: one warp per query row updates the running max and sum;
//   3. P.V: each thread owns 8 dims of the output for a subset of the
//      tile's positions, and the position groups are summed once at the
//      end, one row at a time.
// The tile loop ends at the last tile that holds a position below the
// largest of the block's row lengths, and every row is masked by its own
// length.  A row's arithmetic, in its order, depends on its own q and
// length and on DP only, never on R, G or the rows that share its block:
// past its own length a row's tiles add exact zeros (p = 0, rescale by
// exp(0) = 1), and a block's slots past the S * G rows are never stored.
// So row s of the verify kernel is bitwise the decode kernel at
// lengths[:, s], and the (G, D = 128) instances that ran before compute
// the same bits (G = 3: three rows for decode, fifteen for verify).
// Table indices are clamped to pages_per_seq - 1, and no position at or
// past the largest row length is read.
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
constexpr int kMaxRows = 16;   // the per-thread accumulator is R * 8 f32
// the row counts with an instance (see rows_for)
constexpr int kRowCounts[] = {1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 16};

// Grid (Hkv, B, ceil(S * G / R)); block z covers rows i = z * R + r.
template <typename T, int DP, int R>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ page_table,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    int num_kv_heads, int G, int S, int D, int page, int pages_per_seq,
    float scale) {
  constexpr int kLanesPerRow = DP / 8;                 // 8 elements per lane
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kRowGroups = kThreads / kLanesPerRow;  // P.V position split
  static_assert(kTile % (kWarps * kRowsPerWarp) == 0, "tile rows");
  static_assert(kTile % kRowGroups == 0, "tile rows");

  __shared__ float q_s[R][DP];
  __shared__ float p_s[R][kTile];
  __shared__ float m_s[R], l_s[R], corr_s[R];
  __shared__ int len_s[R];
  __shared__ float red_s[kRowGroups][DP];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.z * R;
  const int rows = S * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* pt = page_table + static_cast<long>(b) * pages_per_seq;
  const long row_stride = static_cast<long>(num_kv_heads) * D;
  const long head_off = static_cast<long>(kvh) * D;
  // (b, s, kvh * G + g, :) of q / out for row i = s * G + g
  const long num_heads = static_cast<long>(num_kv_heads) * G;
  auto q_off = [&](int i) {
    return ((static_cast<long>(b) * S + i / G) * num_heads
            + static_cast<long>(kvh) * G + i % G) * D;
  };

  if (tid < R) {
    const int i = i0 + tid;
    len_s[tid] = i < rows ? lengths[b * S + i / G] : 0;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  for (int x = tid; x < R * DP; x += kThreads) {
    const int r = x / DP, d = x % DP;
    q_s[r][d] = i0 + r < rows && d < D
        ? __bfloat162float(q[q_off(i0 + r) + d]) * scale
        : 0.f;
  }
  const int sub = tid % kLanesPerRow;   // 8 dims [sub*8, sub*8+8)
  const int grp = tid / kLanesPerRow;   // P.V positions grp, +kRowGroups..
  // a lane past D loads the last live lane's 8 elements again and
  // multiplies them by q = 0: it adds an exact 0 to every score, and its
  // dims are never stored (a branch on the lane instead made the 15-row
  // verify block slower on the card)
  const int ld = min(sub, D / 8 - 1) * 8;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  __syncthreads();

  int len[R];   // the rows' lengths, in registers for the tile loop (read
                // from shared memory there, they slowed the 15-row block)
  int len_max = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    len[r] = len_s[r];
    len_max = max(len_max, len[r]);
  }

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
        const long base =
            (static_cast<long>(frame) * page + pos % page) * row_stride
            + head_off + ld;
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
          p_s[r][c] = pos < len[r] ? part[r] : kNegInf;
      }
    }
    __syncthreads();
    // 2. online softmax: one warp per query row; positions past the row's
    //    own length weigh exactly 0
    for (int r = warp; r < R; r += kWarps) {
      const int row_len = len_s[r];
      float mx = kNegInf;
      for (int c = lane; c < kTile; c += 32) mx = fmaxf(mx, p_s[r][c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < kTile; c += 32) {
        const float e = t0 + c < row_len ? expf(p_s[r][c] - m_new) : 0.f;
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
      const long base =
          (static_cast<long>(frame) * page + pos % page) * row_stride
          + head_off + ld;
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
    if (i0 + r >= rows) break;   // the same for every thread of the block
#pragma unroll
    for (int e = 0; e < 8; ++e) red_s[grp][sub * 8 + e] = acc[r][e];
    __syncthreads();
    const long o = q_off(i0 + r);
    for (int d = tid; d < D; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kRowGroups; ++j) s += red_s[j][d];
      out[o + d] = __float2bfloat16(s / fmaxf(l_s[r], 1e-30f));
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
  int batch, S, num_kv_heads, groups, head_dim, page, pps;
  float scale;
};

// Rows per block for n rows of a (KV head, sequence): the least row
// count of the instance set that holds an equal share of the rows over
// the fewest blocks of at most kMaxRows.
inline int rows_for(int n) {
  const int blocks = (n + kMaxRows - 1) / kMaxRows;
  const int share = (n + blocks - 1) / blocks;
  for (int r : kRowCounts) {
    if (r >= share) return r;
  }
  return kMaxRows;
}

// Launch one instance; returns the launch's CUDA error.
template <typename T, int DP, int R>
cudaError_t launch_dr(const Args<T>& a, cudaStream_t stream) {
  const dim3 grid(a.num_kv_heads, a.batch, (a.S * a.groups + R - 1) / R);
  paged_attention_kernel<T, DP, R><<<grid, kThreads, 0, stream>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.pt, a.len, a.out, a.num_kv_heads,
      a.groups, a.S, a.head_dim, a.page, a.pps, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_d(const Args<T>& a, cudaStream_t stream) {
#define REPRO_PAGED_ROWS(RR) \
  case RR:                   \
    return launch_dr<T, DP, RR>(a, stream);
  switch (rows_for(a.S * a.groups)) {
    REPRO_PAGED_ROWS(1)
    REPRO_PAGED_ROWS(2)
    REPRO_PAGED_ROWS(3)
    REPRO_PAGED_ROWS(4)
    REPRO_PAGED_ROWS(5)
    REPRO_PAGED_ROWS(6)
    REPRO_PAGED_ROWS(8)
    REPRO_PAGED_ROWS(10)
    REPRO_PAGED_ROWS(12)
    REPRO_PAGED_ROWS(15)
    REPRO_PAGED_ROWS(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_ROWS
}

// One entry point's body: element type T of the pool; k_scales /
// v_scales are null for bf16.  Decode and verify share it (S = 1 for
// decode).
template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* page_table,
           const void* lengths, void* out, int batch, int S, int num_heads,
           int num_kv_heads, int head_dim, int page, int pages_per_seq,
           float scale, void* stream) {
  if (num_kv_heads <= 0 || num_heads % num_kv_heads || S <= 0
      || head_dim <= 0 || head_dim % 8 || head_dim > 128)
    return cudaErrorInvalidValue;
  if (repro_kv::Elem<T>::kScaled
      && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  const Args<T> a{static_cast<const __nv_bfloat16*>(q),
                  static_cast<const T*>(k_pages),
                  static_cast<const T*>(v_pages),
                  static_cast<const float*>(k_scales),
                  static_cast<const float*>(v_scales),
                  static_cast<const int*>(page_table),
                  static_cast<const int*>(lengths),
                  static_cast<__nv_bfloat16*>(out),
                  batch, S, num_kv_heads, num_heads / num_kv_heads, head_dim,
                  page, pages_per_seq, scale};
  auto s = static_cast<cudaStream_t>(stream);
  return head_dim <= 64 ? launch_d<T, 64>(a, s) : launch_d<T, 128>(a, s);
}

}  // namespace repro_paged

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
