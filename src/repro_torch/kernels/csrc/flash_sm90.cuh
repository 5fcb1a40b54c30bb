// The flash-attention block for Hopper (sm_90a) shared by the dense
// kernel (flash_attention_sm90.cu) and the paged prefill kernels
// (paged_prefill_sm90.cu for a bf16 pool, paged_prefill.cu for the int8
// and fp8 frames of a quantized pool): the tile plan, the shared-memory
// layout, and the consumer warpgroups' loop.  The sources differ only in
// their producer (which tensor maps, which coordinates; the quantized
// kernel widens its 1-byte frames into the bf16 stages) and their masks,
// and the quantized kernel scales the score and weight columns
// (consume's Scales hook, the identity for bf16).
//
// A block holds kBlockQ = 128 query rows of one query head: two consumer
// warpgroups of 64 rows and one producer warpgroup, of which one thread
// issues every TMA load.  The block's q tile lands once (its own
// barrier); K and V tiles of kBlockKV = 64 positions stream through a
// ring of kStages stages, each completing on its full barrier (expect_tx
// counts whole boxes, out-of-bounds zeros included) and freed on its
// empty barrier by the consumer warps.  Head dims pad up to 64 or 128
// (kDPad) by the boxes' zero fill: the zero columns add nothing to Q K^T,
// and the output columns past D are not stored.  The tiles depend on the
// head dim alone, never on the batch, the chunk rows or the lengths, and
// KV tiles start at absolute multiples of kBlockKV.
//
// Per KV tile a consumer warpgroup computes S = Q K^T (wgmma, both
// K-major along D, D / 16 products of m64n64k16), masks it (a finite
// -1e30, as the TPU kernels use), runs the online softmax in f32
// registers in base 2 (the scale folded into log2(e) / sqrt(D)), the row
// max reduced across the 4 threads that share a row, rounds P to bf16
// (as SDPA does) and accumulates O += P V (wgmma with P from registers:
// the accumulator fragment rounded to bf16 is the A fragment; V is
// MN-major, D contiguous: the transpose-B flag).  The row sum stays a
// per-thread partial until the epilogue.  The loop is pipelined by one
// tile: a tile's Q K^T and the previous tile's P V are issued together,
// and the softmax runs while P V is on the tensor cores.
//
// Bits: a row's result depends on its own q, the tiles' absolute
// positions and its mask only.  A tile wholly masked for a row changes
// none of its bits (rescale 1, weights exp2(-1e30 - m) = 0, and the zero
// products add nothing), so neither the chunk split, the rows
// sharing the block nor the block's tile range change a row's output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace repro_flash {

using namespace repro_sm90;

constexpr int kConsumers = 2;                  // warpgroups of 64 query rows
constexpr int kBlockQ = 64 * kConsumers;       // query rows a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockKV = 64;                   // KV positions a tile
constexpr int kStages = 4;
constexpr int kAtom = 64;                      // bf16 columns of a box
constexpr int kRowBytes = kAtom * 2;           // 128: the swizzle's span
constexpr int kAlign = 1024;                   // an 8-row swizzle group
constexpr int kSmemOptin = 232448;             // H100: opt-in per block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The plan of a head dim: D padded to whole 64-column atoms; the q tile,
// then kStages stages of a K and a V tile, each atom-major (atom a of a
// tile of R rows at a * R * 128 bytes), then the barriers.
template <int D>
struct Plan {
  static constexpr int kDPad = D <= 64 ? 64 : 128;
  static constexpr int kAtoms = kDPad / kAtom;
  static constexpr int kQBytes = kBlockQ * kDPad * 2;
  static constexpr int kTileBytes = kBlockKV * kDPad * 2;   // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kAlign + kBarOffset + (2 * kStages + 1) * 8;
  static_assert(D % 16 == 0 && D <= 128, "head dims: multiples of 16, <= 128");
  static_assert(kSmem <= kSmemOptin, "the plan must fit one block");
};

// The block's shared memory, aligned to the swizzle's 1024-byte groups.
template <int D>
struct Smem {
  unsigned char* q;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qbar;

  __device__ explicit Smem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + kAlign - 1)
        & ~static_cast<uintptr_t>(kAlign - 1));
    ring = q + Plan<D>::kQBytes;
    full = reinterpret_cast<uint64_t*>(q + Plan<D>::kBarOffset);
    empty = full + kStages;
    qbar = empty + kStages;
  }
  __device__ unsigned char* k(int stage) const {
    return ring + stage * Plan<D>::kStageBytes;
  }
  __device__ unsigned char* v(int stage) const {
    return k(stage) + Plan<D>::kTileBytes;
  }
  // thread 0: `producers` arrivals for a stage's loads (one thread issuing
  // TMA loads, or every thread that fills the stage), one per consumer
  // warp freeing it, one for the q tile
  __device__ void init(uint32_t producers = 1) const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], producers);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
};

// The paged prefill's mask: keys below kv_valid, causal, inside the
// window; a tile at k0 is interior when every query of the block, from
// first_q to last_q, sees all of it.
struct PagedMask {
  int kv_valid, window, first_q, last_q;

  __device__ bool interior(int k0) const {
    return k0 + kBlockKV <= kv_valid && k0 + kBlockKV - 1 <= first_q
           && (window <= 0 || k0 > last_q - window);
  }
  __device__ bool visible(int p, int q) const {
    return p < kv_valid && p <= q && (window <= 0 || p > q - window);
  }
};

// The TMA map of a paged prefill's q (C, T, H, D) bf16, the model
// layout, as a 4-D map (D, H, T, C) read in boxes of one head's 64 rows
// by 64 columns; rows past T and columns past D arrive as zeros.
inline bool paged_q_map(CUtensorMap* map, const void* q, int D,
                        int num_heads, int T, int chunk_rows) {
  const cuuint64_t row = static_cast<cuuint64_t>(num_heads) * D * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(num_heads),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(chunk_rows)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row,
                                 row * T};
  const cuuint32_t box[4] = {kAtom, 1, 64, 1};
  return encode_bf16(map, q, 4, dims, strides, box);
}

// The column scales of a tile's scores and weights: none for a bf16
// tile.  A quantized kernel's policy loads this thread's columns' scales
// of stage `st` (keys / values: issued before a wgmma wait, so the loads
// overlap the products) and applies them: column j of S times the keys'
// (before the mask), of P times the values' (before P is rounded to
// bf16); the row sums add the unscaled weights.
struct NoScales {
  struct Cols {};
  __device__ Cols keys(int) const { return {}; }
  __device__ Cols values(int) const { return {}; }
  __device__ void apply(float (&)[kBlockKV / 2], const Cols&) const {}
};

// The number of KV tiles from `lo` (a multiple of kBlockKV) up to `hi`.
__device__ __forceinline__ int tile_count(int lo, int hi) {
  return hi > lo ? (hi - lo + kBlockKV - 1) / kBlockKV : 0;
}

// The first KV tile a sliding window leaves to query positions from
// first_q on (keys p > q - window), or 0 without a window.
__device__ __forceinline__ int window_start(int first_q, int window) {
  return window > 0 ? max(0, first_q - window + 1) / kBlockKV * kBlockKV : 0;
}

// 2^x on the special-function unit (subnormal results flush to 0).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the A fragments of an in-flight wgmma in their registers until
// here: the product reads them after its issue.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// S = Q K^T of one stage: 16 columns of D are 32 bytes along the
// swizzled rows, and the 64-column atoms of a tile of R rows lie R * 128
// bytes apart.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBlockKV / 2],
                                         uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < Plan<D>::kDPad / 16; ++kk) {
    const int atom = kk / 4, col = (kk % 4) * 32;
    wgmma_kk(s, sw128_desc(q_addr + atom * kBlockQ * kRowBytes + col, 16,
                           1024),
             sw128_desc(k_addr + atom * kBlockKV * kRowBytes + col, 16, 1024),
             kk > 0);
  }
  wgmma_commit();
}

// O += P V of one stage: 16 KV rows of V are two 8-row groups, 2048
// bytes; V's 64-column atoms of D lie kBlockKV rows apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Plan<D>::kDPad / 2],
                                         const uint32_t (&p)[kBlockKV / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBlockKV / 16; ++kk)
    wgmma_rs(o, p[kk],
             sw128_desc(v_addr + kk * 16 * kRowBytes, kBlockKV * kRowBytes,
                        1024),
             1);
  wgmma_commit();
}

// The online softmax of one tile at k0 on S in registers: mask, scale to
// base 2, the rows' new maxima (across the 4 threads of a row), the
// weights exp2(s - m) in s, the rescale of the running sums l; returns
// the rescale of O in corr (exactly 1 where a row's maximum held).
template <class Mask>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockKV / 2], int k0,
                                             float scale_log2,
                                             const int (&q_pos)[2],
                                             const Mask& mask, float (&m)[2],
                                             float (&l)[2], float (&corr)[2]) {
  const int lane = threadIdx.x % 32;
  const bool interior = mask.interior(k0);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBlockKV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = k0 + 8 * j + 2 * (lane % 4) + e;
        float& x = s[4 * j + 2 * h + e];
        x = interior || mask.visible(pos, q_pos[h]) ? x * scale_log2
                                                    : kNegInf;
        mx[h] = fmaxf(mx[h], x);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = mx[h] == m[h] ? 1.f : exp2_fast(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < kBlockKV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = exp2_fast(x - m[h]);
        l[h] += x;
      }
}

// O *= corr per row, then P = bf16(S) as the A fragments of O += P V.
template <int D>
__device__ __forceinline__ void rescale_and_pack(
    float (&o)[Plan<D>::kDPad / 2], const float (&corr)[2],
    const float (&s)[kBlockKV / 2], uint32_t (&p)[kBlockKV / 16][4]) {
#pragma unroll
  for (int j = 0; j < Plan<D>::kDPad / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * j + 2 * h] *= corr[h];
      o[4 * j + 2 * h + 1] *= corr[h];
    }
#pragma unroll
  for (int kk = 0; kk < kBlockKV / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Consumer warpgroup wg (0 or 1) of a block: walk n_tiles KV tiles from
// position lo through the ring and leave O unnormalised in o and the
// row sums' per-thread partials in l.  Rows h = 0, 1 of this thread
// (16 warp + lane / 4 + 8 h of the warpgroup's 64) sit at query
// positions q_pos[h]; mask.interior(k0) says a tile is visible to every
// row of the block, mask.visible(p, q) that key p is to the query at q.
//
// Software-pipelined by one tile: tile t's Q K^T is issued together with
// tile t - 1's P V, and tile t's softmax runs while that P V is still on
// the tensor cores; O is rescaled only after it has retired.  Each row
// still accumulates O = O * corr_t + P_t V_t in tile order.  `scales`
// scales the columns of S and P of the stage a tile is in (NoScales:
// none), while the stage is held.
template <int D, class Mask, class Scales = NoScales>
__device__ __forceinline__ void consume(const Smem<D>& sm, int wg, int lo,
                                        int n_tiles, float scale_log2,
                                        const int (&q_pos)[2],
                                        const Mask& mask,
                                        float (&o)[Plan<D>::kDPad / 2],
                                        float (&l)[2],
                                        const Scales& scales = Scales()) {
  const int lane = threadIdx.x % 32;
  float s[kBlockKV / 2], m[2] = {kNegInf, kNegInf}, corr[2];
  uint32_t p[kBlockKV / 16][4];
#pragma unroll
  for (int i = 0; i < kBlockKV / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Plan<D>::kDPad / 2; ++i) o[i] = 0.f;
  l[0] = l[1] = 0.f;
  const uint32_t q_addr = smem_u32(sm.q) + wg * 64 * kRowBytes;
  mbar_wait(sm.qbar, 0);
  if (n_tiles == 0) return;

  mbar_wait(&sm.full[0], 0);
  wgmma_fence();
  fence_regs(s);
  issue_qk<D>(s, q_addr, smem_u32(sm.k(0)));
  const auto k0_cols = scales.keys(0);
  wgmma_wait<0>();
  fence_regs(s);
  scales.apply(s, k0_cols);
  softmax_tile(s, lo, scale_log2, q_pos, mask, m, l, corr);
  scales.apply(s, scales.values(0));
  rescale_and_pack<D>(o, corr, s, p);

  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % kStages, prev = (it - 1) % kStages;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    wgmma_fence();
    fence_regs(s);
    fence_regs(o);
    issue_qk<D>(s, q_addr, smem_u32(sm.k(st)));
    issue_pv<D>(o, p, smem_u32(sm.v(prev)));
    const auto k_cols = scales.keys(st);
    wgmma_wait<1>();                     // Q K^T of this tile retired
    fence_regs(s);
    scales.apply(s, k_cols);
    softmax_tile(s, lo + it * kBlockKV, scale_log2, q_pos, mask, m, l, corr);
    const auto v_cols = scales.values(st);
    wgmma_wait<0>();                     // P V of the previous tile too
    fence_regs(o);
    fence_frags(p);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);   // its stage is free
    scales.apply(s, v_cols);
    rescale_and_pack<D>(o, corr, s, p);
  }

  const int last = (n_tiles - 1) % kStages;
  wgmma_fence();
  fence_regs(o);
  issue_pv<D>(o, p, smem_u32(sm.v(last)));
  wgmma_wait<0>();
  fence_regs(o);
  fence_frags(p);
  if (lane == 0) mbar_arrive(&sm.empty[last]);
}

// Store this thread's rows of O / l, bf16, to out + row * row_stride for
// the rows below rows_end (the row index local to the block's first row
// row0); columns past D are not stored.  A row that saw no key at all
// stores 0 (don't-care, as in the reference).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           long row_stride, int wg, int rows,
                                           const float (&o)[Plan<D>::kDPad / 2],
                                           const float (&l)[2]) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    if (row >= rows) continue;
    __nv_bfloat16* dst = out + row * row_stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

// This thread's two query rows, local to the block's first row.
__device__ __forceinline__ int thread_row(int wg, int h) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  return 64 * wg + 16 * warp + lane / 4 + 8 * h;
}

}  // namespace repro_flash
