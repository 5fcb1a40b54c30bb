// Paged GQA attention of a few query rows per sequence, for Hopper
// (sm_90a): the one template behind the decode kernel (paged_decode.cu,
// one row per sequence) and the speculative verify kernel
// (paged_verify.cu, S = K + 1 rows per sequence).
//
// Function: for each sequence b, query row s and query head h,
// softmax(q . K^T / sqrt(D)) . V over the first lengths[b, s] KV
// positions, where position p lives in pool frame page_table[b, p / page]
// at row p % page.  Online softmax in f32, bf16 q, bf16 store.  A row
// with lengths[b, s] == 0 stores zeros; a length past the table's
// capacity (pages_per_seq * page) counts as the capacity.
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
// from, k_scales[frame * Hkv + kv head], staged beside the row, and
// multiplies each of its elements as it is widened to f32 on its way out
// of shared memory (the JAX package's dequant of the gathered view,
// element by element).
//
// Design: split-KV (flash-decoding) through the page table.
//   * Rows.  A (KV head, sequence) has S * G query rows, row i = s * G + g
//     (verify row s, group head g), G a runtime value; a block stages R of
//     them, rows z * R .. z * R + R - 1.  R is the least of 1, 2, 3, 4, 5,
//     6, 8, 10, 12, 15, 16 that holds the rows, or, past 16 rows, an equal
//     share of them over the fewest blocks of at most 16 (rows_for): the
//     decode rows of G = 1..6, 8, 12 and the verify rows S * G of K = 4
//     fit exactly.  All R rows share each K/V row the block loads: one
//     pass over a sequence's pages scores K + 1 tokens.
//   * Ranges.  The table's positions [0, capacity) are cut into n_ranges
//     ranges of `span` positions, a multiple of 64 (the wrapper's
//     decode_attention.paged_split_positions picks it from B, Hkv, G, the
//     capacity and the SM count, never from S or the lengths, which live
//     on the device).  The grid is (Hkv, B, row blocks * n_ranges), one
//     block per range; a block walks its range's positions below the
//     longest of its rows' lengths in tiles of 64, each position mapped
//     through the table, so a tile may straddle several frames.
//   * The ring.  K and V rows of tile t + 1 go into a 2-stage ring in
//     shared memory by 16-byte cp.async (one group per tile) while tile t
//     is used, with their frame scales (4-byte cp.async) and the table
//     entries of tile t + 2's pages; one wait_group and one barrier a tile
//     make them visible.  Bf16 and 1-byte rows of head dims 16-128 are
//     whole 16-byte pieces.
//   * A tile: 1. scores: a K row is read from the ring by DP/8 lanes, 8
//     elements each (a lane past D reads the last live lane's elements
//     against q = 0 and adds an exact 0); the R partial dot products are
//     reduced with warp shuffles; 2. softmax: one warp per row updates
//     its running max and sum; 3. P.V: each thread owns 8 dims of the
//     output for a subset of the tile's positions, and the position
//     groups are summed once at the end through shared memory that
//     reuses the ring.
//   * The combine.  With one range the block stores acc / max(l, 1e-30)
//     itself.  With more, each block writes its rows' f32 state (m, l,
//     acc) to a workspace, and the combine of split_kv.cuh, enqueued by
//     the same call on the same stream, merges a row's ranges below its
//     own length in range order.
//
// Traps, and what the design does about them:
//   * Empty ranges.  A block whose range starts at or past the longest
//     length of its rows writes nothing and exits; the combine merges a
//     row's first ceil(len / span) ranges only, so it never reads such a
//     range's workspace, and a row of length 0 merges none and stores
//     zeros, never workspace junk.  A row shorter than its block's
//     longest leaves the empty state (m = -1e30, l = 0, acc = 0) in the
//     ranges it does not reach, which the combine skips all the same.
//   * The trash frame.  No K/V row or scale is read for a position at or
//     past the block's longest row length: the trash frame's scale is
//     junk, and junk * p = 0 can be NaN.  The ring rows past the end are
//     zero-filled (cp.async with a source size of 0) and never used.  (The
//     first tile's table entries are loaded beside the lengths, before
//     the block knows where its rows end: entries, clamped to the table,
//     never the frames they name.)
//   * Table indices are clamped to pages_per_seq - 1.
//   * Verify row s is bitwise the decode kernel at lengths[:, s].  A row's
//     arithmetic, in its order, depends on its own q and length, on DP
//     and on the range cuts only, never on R, G or the rows that share
//     its block: past its own length a row's tiles add exact zeros (p = 0,
//     rescale by exp(0) = 1), and a block's slots past the S * G rows are
//     never stored.  Decode and verify of one (B, Hkv, G, capacity) cut
//     alike, since the span depends on nothing else, and the combine
//     merges the same ranges of a row (those below its length) in the
//     same order.
//
// Bound on the card: bytes.  A step reads every valid K and V row once
// (2 * len * D * sizeof(T) bytes per sequence and KV head, plus a scale
// pair per frame when quantized) and does 4 * R * D flops per position,
// far below the ~295 flop/byte ridge of an H100.  The unsplit kernel ran
// B * Hkv blocks (64 at B = 8, Hkv = 8) on 132 SMs, each walking a whole
// sequence with one 16-byte load in flight per lane; the ranges make
// several blocks per sequence and KV head, each with a 64-row tile of K
// and V in flight (32 KiB at D 128 in bf16) while it computes the last.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kv_types.cuh"
#include "split_kv.cuh"

namespace repro_paged {

using repro_kv::Elem;
using repro_kv::load8;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kStages = 2;        // K/V ring depth, tiles
constexpr int kTilePages = kTile; // table entries a tile can span (page 1)
constexpr int kMaxRows = 16;      // the per-thread accumulator is R * 8 f32
static_assert(kThreads >= kMaxRows + kTilePages, "prologue loads");
// the row counts with an instance (see rows_for)
constexpr int kRowCounts[] = {1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 16};
constexpr float kNegInf = repro_split::kEmptyMax;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One 16-byte piece, global -> shared, through L2 only; zeros if !live
// (a source size of 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(live ? 16 : 0));
}

// One 4-byte element (a scale, a table entry); zero if !live.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Dynamic shared memory of one block: the K and V rings (kStages tiles of
// kTile rows of D elements each), their frame scales for a quantized pool
// ([kStages][kTile] f32 each) and the table entries of a tile's pages
// ([kStages][kTilePages] int32).  The position groups' partial outputs
// ([kThreads / (DP / 8)][DP] f32) reuse the rings after the last tile.
// ring_region: the bytes before the scales (rings or partial outputs).
template <typename T, int DP>
__host__ __device__ inline size_t ring_region(int D) {
  const size_t ring = static_cast<size_t>(2) * kStages * kTile * D * sizeof(T);
  const size_t red = static_cast<size_t>(kThreads / (DP / 8)) * DP * 4;
  return ring > red ? ring : red;
}
template <typename T, int DP>
size_t smem_bytes(int D) {
  const size_t scales = Elem<T>::kScaled ? 2 * kStages * kTile * 4 : 0;
  return ring_region<T, DP>(D) + scales + kStages * kTilePages * 4;
}

// One block of the grid (Hkv, B, ceil(S * G / R) * n_ranges): block z
// covers rows i = (z % ceil(S * G / R)) * R + r over range
// z / ceil(S * G / R), positions [range * span, range * span + span).
// ws: the split partials (split_kv.cuh) of the B * S * H output rows,
// null when n_ranges == 1.
template <typename T, int DP, int R>
__global__ void __launch_bounds__(kThreads, 2) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ page_table,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws, int num_kv_heads, int G, int S, int D, int page,
    int page_shift, int pages_per_seq, int span, int n_ranges, float scale) {
  constexpr bool kScaled = Elem<T>::kScaled;
  constexpr int kLanesPerRow = DP / 8;                 // 8 elements per lane
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kRowGroups = kThreads / kLanesPerRow;  // P.V position split
  constexpr int kPiece = 16 / sizeof(T);               // elements per cp.async
  static_assert(kTile % (kWarps * kRowsPerWarp) == 0, "tile rows");
  static_assert(kTile % kRowGroups == 0, "tile rows");
  static_assert(kStages == 2, "the table entries alternate two slots");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float q_s[R][DP];
  __shared__ float p_s[R][kTile];
  __shared__ float m_s[R], l_s[R], corr_s[R];
  __shared__ int len_s[R];

  const int rows = S * G;
  const int row_blocks = (rows + R - 1) / R;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int i0 = (blockIdx.z % row_blocks) * R;
  const int split = blockIdx.z / row_blocks;
  const int capacity = pages_per_seq * page;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* pt = page_table + static_cast<long>(b) * pages_per_seq;
  const long row_stride = static_cast<long>(num_kv_heads) * D;
  const long head_off = static_cast<long>(kvh) * D;
  // output row of row i = s * G + g: (b, s, kvh * G + g) of (B, S, H)
  const int num_heads = num_kv_heads * G;
  auto out_row = [&](int i) {
    return (static_cast<long>(b) * S + i / G) * num_heads
           + static_cast<long>(kvh) * G + i % G;
  };

  T* ks = reinterpret_cast<T*>(smem);           // [kStages][kTile][D]
  T* vs = ks + kStages * kTile * D;             // [kStages][kTile][D]
  const size_t ring_end = ring_region<T, DP>(D);
  float* ksc = reinterpret_cast<float*>(smem + ring_end);  // [kStages][kTile]
  float* vsc = ksc + kStages * kTile;
  int* pts = reinterpret_cast<int*>(smem + ring_end)
             + (kScaled ? 2 * kStages * kTile : 0);  // [kStages][kTilePages]
  // the page of a position: a shift for a power-of-two page
  auto page_of = [&](int pos) {
    return page_shift >= 0 ? pos >> page_shift : pos / page;
  };
  const int first = split * span;
  if (tid < R) {
    const int i = i0 + tid;
    len_s[tid] = i < rows
        ? min(max(lengths[b * S + i / G], 0), capacity) : 0;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  } else if (tid >= kMaxRows && tid - kMaxRows < kTilePages) {
    // the first tile's table entries, loaded beside the lengths: entries
    // only (clamped to the table), no K/V row or scale
    const int x = tid - kMaxRows;
    pts[x] = pt[min(page_of(min(first, capacity - 1)) + x,
                    pages_per_seq - 1)];
  }
  __syncthreads();
  int len[R];   // the rows' lengths, in registers for the tile loop (read
                // from shared memory there, they slowed the 15-row block)
  int len_max = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    len[r] = len_s[r];
    len_max = max(len_max, len[r]);
  }
  // this block's positions [first, end): the range, cut at the longest
  // row; a split range past it is written by no one and merged by no one
  if (ws != nullptr && first >= len_max) return;   // the same for the block
  const int end = min(first + span, len_max);
  const int n_tiles = end > first ? (end - first + kTile - 1) / kTile : 0;

  const int pieces = D / kPiece;                // per row
  // this thread's pieces of a tile, (row, piece) = divmod(tid + k *
  // kThreads, pieces) for k = 0, 1, ..., stepped without a division
  const int first_r = tid / pieces, first_c = tid % pieces;
  const int step_r = kThreads / pieces, step_c = kThreads % pieces;

  // the table entries of tile t's pages (positions below `end` only)
  auto tile_pages = [&](int t, int& p0) {
    const int t0 = first + t * kTile;
    p0 = page_of(t0);
    return page_of(min(t0 + kTile, end) - 1) - p0 + 1;
  };
  // aload: tile t's K and V rows (those before `end`; the others zeroed)
  // and their scales into `slot`, and tile t + 1's table entries into the
  // other slot of pts, all by cp.async
  auto aload = [&](int t, int slot) {
    const int t0 = first + t * kTile;
    const int p0 = page_of(t0);
    const int* fr = pts + slot * kTilePages;
    T* kd = ks + slot * kTile * D;
    T* vd = vs + slot * kTile * D;
    for (int r = first_r, piece = first_c; r < kTile;) {
      const int c = piece * kPiece;
      const int pos = t0 + r;
      const bool live = pos < end;
      long frame = 0, src = 0;
      if (live) {
        const int pg = page_of(pos);
        frame = fr[pg - p0];
        src = (frame * page + (pos - pg * page)) * row_stride + head_off + c;
      }
      cp_async16(kd + r * D + c, k_pages + src, live);
      cp_async16(vd + r * D + c, v_pages + src, live);
      if constexpr (kScaled) {
        if (c == 0) {
          const long si = frame * num_kv_heads + kvh;
          cp_async4(ksc + slot * kTile + r, k_scales + si, live);
          cp_async4(vsc + slot * kTile + r, v_scales + si, live);
        }
      }
      r += step_r;
      piece += step_c;
      if (piece >= pieces) {
        piece -= pieces;
        ++r;
      }
    }
    if (t + 1 < n_tiles) {
      int n1p0;
      const int n1 = tile_pages(t + 1, n1p0);
      if (tid < n1)
        cp_async4(pts + (slot ^ 1) * kTilePages + tid,
                  pt + min(n1p0 + tid, pages_per_seq - 1), true);
    }
  };
  if (n_tiles > 0) aload(0, 0);
  cp_async_commit();

  for (int x = tid; x < R * DP; x += kThreads) {
    const int r = x / DP, d = x % DP;
    q_s[r][d] = i0 + r < rows && d < D
        ? __bfloat162float(q[out_row(i0 + r) * D + d]) * scale
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

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = first + tile * kTile;
    const int slot = tile % kStages;
    // getfin: tile `tile` (and tile + 1's table entries) landed, every
    // thread's pieces; every thread is done with tile - 1, whose slot the
    // next aload refills
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < n_tiles) aload(tile + 1, slot ^ 1);
    cp_async_commit();
    const T* kt = ks + slot * kTile * D;
    const T* vt = vs + slot * kTile * D;
    const float* kst = ksc + slot * kTile;
    const float* vst = vsc + slot * kTile;
    // 1. scores for the tile's positions, all R rows at once
    for (int c = warp * kRowsPerWarp + lane / kLanesPerRow; c < kTile;
         c += kWarps * kRowsPerWarp) {
      const int pos = t0 + c;
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
      if (pos < end) {
        float kf[8];
        load8(kt + c * D + ld, kf);
        if constexpr (kScaled) {
          const float s = kst[c];
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] *= s;
        }
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
      if (t0 + c >= end) break;
      float vf[8];
      load8(vt + c * D + ld, vf);
      if constexpr (kScaled) {
        const float s = vst[c];
#pragma unroll
        for (int e = 0; e < 8; ++e) vf[e] *= s;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = p_s[r][c];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] += p * vf[e];
      }
    }
    // p_s, corr_s and the slot are rewritten only after the next tile's
    // barrier
  }
  cp_async_wait_all();   // the empty group past the last tile
  __syncthreads();
  // the ring is free: the position groups' partial outputs go there,
  // red[row of the pass][group][DP], as many rows a pass as it holds
  float* red = reinterpret_cast<float*>(smem);
  constexpr int kRedRow = kRowGroups * DP;
  const int per_pass = static_cast<int>(ring_end / (kRedRow * 4));
  const int live_rows = min(R, rows - i0);

  // per row: sum the position groups' partial outputs in group order; one
  // range stores acc / max(l, 1e-30), a split writes its partial state
  const repro_split::Partials partials(ws, gridDim.y * S * num_heads,
                                       n_ranges, D);
  for (int r0 = 0; r0 < live_rows; r0 += per_pass) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= r0 && r < r0 + per_pass) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red[(r - r0) * kRedRow + grp * DP + sub * 8 + e] = acc[r][e];
      }
    }
    __syncthreads();
    const int n = min(per_pass, live_rows - r0);
    for (int x = tid; x < n * D; x += kThreads) {
      const int r = x / D, d = x - r * D;
      const long orow = out_row(i0 + r0 + r);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kRowGroups; ++j) s += red[r * kRedRow + j * DP + d];
      if (ws == nullptr) {
        out[orow * D + d] =
            __float2bfloat16(s / fmaxf(l_s[r0 + r], 1e-30f));
      } else {
        partials.acc[(orow * n_ranges + split) * D + d] = s;
      }
    }
    if (ws != nullptr && tid < n) {
      const long slot = out_row(i0 + r0 + tid) * n_ranges + split;
      partials.m[slot] = m_s[r0 + tid];
      partials.l[slot] = l_s[r0 + tid];
    }
    __syncthreads();   // red is rewritten by the next pass
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
  float* ws;         // null with one range
  int batch, S, num_kv_heads, groups, head_dim, page, page_shift, pps, span,
      n_ranges;
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

// Launch one instance and, with more than one range, the combine;
// returns the first CUDA error.
template <typename T, int DP, int R>
cudaError_t launch_dr(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DP>(a.head_dim);
  constexpr auto kernel = paged_attention_kernel<T, DP, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long blocks_z =
      static_cast<long>((a.S * a.groups + R - 1) / R) * a.n_ranges;
  if (blocks_z > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.num_kv_heads, a.batch, static_cast<unsigned>(blocks_z));
  kernel<<<grid, kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.pt, a.len, a.out, a.ws, a.num_kv_heads,
      a.groups, a.S, a.head_dim, a.page, a.page_shift, a.pps, a.span,
      a.n_ranges, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ws == nullptr) return err;
  const int heads = a.num_kv_heads * a.groups;
  return repro_split::launch_combine<__nv_bfloat16>(
      a.ws, a.out, a.batch * a.S * heads, a.n_ranges, a.head_dim, stream,
      a.len, heads, a.span);
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
// decode).  span: positions per range, a multiple of 64; ws: B * S * H *
// n_ranges * (D + 2) f32 of workspace when the capacity pages_per_seq *
// page holds more than one range (n_ranges = ceil(capacity / span)),
// else null.  The pools 16-byte aligned.
template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* page_table,
           const void* lengths, void* out, void* ws, int batch, int S,
           int num_heads, int num_kv_heads, int head_dim, int page,
           int pages_per_seq, int span, float scale, void* stream) {
  if (batch <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads || S <= 0
      || head_dim <= 0 || head_dim % 8 || head_dim > 128
      || (head_dim * sizeof(T)) % 16 || page <= 0 || pages_per_seq <= 0
      || span <= 0 || span % kTile)
    return cudaErrorInvalidValue;
  if (Elem<T>::kScaled && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  const long capacity = static_cast<long>(pages_per_seq) * page;
  const long n_ranges = (capacity + span - 1) / span;
  if (capacity > (1L << 30) || (n_ranges > 1) != (ws != nullptr))
    return cudaErrorInvalidValue;
  int page_shift = -1;   // log2(page) for a power of two
  for (int x = 0; x < 31; ++x) {
    if ((1 << x) == page) page_shift = x;
  }
  const Args<T> a{static_cast<const __nv_bfloat16*>(q),
                  static_cast<const T*>(k_pages),
                  static_cast<const T*>(v_pages),
                  static_cast<const float*>(k_scales),
                  static_cast<const float*>(v_scales),
                  static_cast<const int*>(page_table),
                  static_cast<const int*>(lengths),
                  static_cast<__nv_bfloat16*>(out),
                  static_cast<float*>(ws),
                  batch, S, num_kv_heads, num_heads / num_kv_heads, head_dim,
                  page, page_shift, pages_per_seq, span,
                  static_cast<int>(n_ranges), scale};
  auto s = static_cast<cudaStream_t>(stream);
  return head_dim <= 64 ? launch_d<T, 64>(a, s) : launch_d<T, 128>(a, s);
}

}  // namespace repro_paged

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
