// Dense one-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention` of
// src/repro/kernels/decode_attention.py (its pallas_call at line 109).
// Same function: for each sequence b and query head h,
// softmax(q . K^T / sqrt(D)) . V over the first valid_len positions of a
// dense cache — valid_len one scalar for the whole batch, as in the
// reference — with an f32 online softmax and the output in the operands'
// type.  Entry points decode_attention_f32 and decode_attention_bf16
// (q, k, v and out all of that type), head dims 16, 32, 64, 80 and 128,
// any G = H / Hkv.  valid_len = 0 stores zeros (the TPU kernel's output
// when no block is live).
//
// Layout: q and out (B, H, D); k and v (B, Skv, Hkv, D), read in place.
//
// Design: the paged decode kernel's (paged_attention.cuh, one query row
// per sequence) on a dense cache, standalone so the paged kernels stay as
// they are.  As in `_decode_kernel`, one block (128 threads) per
// (KV head, sequence) computes the G query heads of the KV head, which
// share each K/V row it loads: R of them at a time, G a runtime value and
// R from the paged kernels' set (1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 16:
// the least that holds G, or an equal share of it over blocks of at most
// 16).  D is a runtime value on a lane width DP of 64 or 128.  It walks
// the first valid_len positions in tiles of 64, the TPU kernel's live
// blocks:
//   1. scores: a K row is read by DP/8 lanes, 8 elements each (a lane
//      past D reads the last live lane's elements against q = 0 and adds
//      an exact 0); the R partial dot products are reduced with warp
//      shuffles;
//   2. softmax: one warp per query head updates the running max and sum;
//   3. P.V: each thread owns 8 dims of the output for a subset of the
//      tile's positions; the position groups are summed once at the end.
// No position at or past valid_len is read.
//
// Bound on the card: bytes.  A call reads every valid K and V row once
// (2 * valid_len * D elements per sequence and KV head) and does 4 * G *
// D flops per position, far below the ~295 flop/byte ridge of an H100.
// B * Hkv blocks (64 at B = 8, Hkv = 8) leave most of the 132 SMs idle:
// splitting the KV axis across blocks with a second reduction pass
// (flash-decoding) is the known next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_io.cuh"

namespace {

using repro_dense::load8;
using repro_dense::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kMaxRows = 16;   // the per-thread accumulator is R * 8 f32
// the row counts with an instance (see rows_for)
constexpr int kRowCounts[] = {1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 16};
constexpr float kNegInf = -1e30f;

// Grid (Hkv, B, ceil(G / R)); block z covers query heads g = z * R + r of
// its KV head.
template <typename T, int DP, int R>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Skv, int num_kv_heads,
    int G, int D, int valid_len, float scale) {
  constexpr int kLanesPerRow = DP / 8;                 // 8 elements per lane
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kRowGroups = kThreads / kLanesPerRow;  // P.V position split
  static_assert(kTile % (kWarps * kRowsPerWarp) == 0, "tile rows");
  static_assert(kTile % kRowGroups == 0, "tile rows");

  __shared__ float q_s[R][DP];
  __shared__ float p_s[R][kTile];
  __shared__ float m_s[R], l_s[R], corr_s[R];
  __shared__ float red_s[kRowGroups][DP];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g0 = blockIdx.z * R;
  const int live = min(R, G - g0);      // query heads of this block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long kv_stride = static_cast<long>(num_kv_heads) * D;
  const long kv_base = static_cast<long>(b) * Skv * kv_stride
                       + static_cast<long>(kvh) * D;
  // (b, kvh * G + g0, :) of q / out; the block's heads are D apart
  const long q_base =
      ((static_cast<long>(b) * num_kv_heads + kvh) * G + g0) * D;

  for (int i = tid; i < R * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    q_s[r][d] =
        r < live && d < D ? to_f32(q[q_base + r * D + d]) * scale : 0.f;
  }
  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
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

  const int n_tiles = (valid_len + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kTile;
    // 1. scores for the tile's positions, all R heads at once
    for (int c = warp * kRowsPerWarp + lane / kLanesPerRow; c < kTile;
         c += kWarps * kRowsPerWarp) {
      const int pos = t0 + c;
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
      if (pos < valid_len) {
        float kf[8];
        load8(k + kv_base + pos * kv_stride + ld, kf);
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
          p_s[r][c] = pos < valid_len ? part[r] : kNegInf;
      }
    }
    __syncthreads();
    // 2. online softmax: one warp per query head
    for (int r = warp; r < R; r += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < kTile; c += 32) mx = fmaxf(mx, p_s[r][c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < kTile; c += 32) {
        const float e = t0 + c < valid_len ? expf(p_s[r][c] - m_new) : 0.f;
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
      if (pos >= valid_len) break;
      float vf[8];
      load8(v + kv_base + pos * kv_stride + ld, vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = p_s[r][c];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] += p * vf[e];
      }
    }
    __syncthreads();   // p_s and corr_s are rewritten by the next tile
  }

  // per head: sum the position groups' partial outputs, normalise, store
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= live) break;   // the same for every thread of the block
#pragma unroll
    for (int e = 0; e < 8; ++e) red_s[grp][sub * 8 + e] = acc[r][e];
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kRowGroups; ++j) s += red_s[j][d];
      s /= fmaxf(l_s[r], 1e-30f);
      if constexpr (sizeof(T) == 4) {
        out[q_base + r * D + d] = s;
      } else {
        out[q_base + r * D + d] = __float2bfloat16(s);
      }
    }
    __syncthreads();   // red_s is rewritten for the next head
  }
}

// The operands of one launch.
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  int batch, Skv, num_kv_heads, groups, head_dim, valid_len;
  float scale;
};

// Heads per block: the least of the set that holds an equal share of the
// G heads over the fewest blocks of at most kMaxRows.
inline int rows_for(int n) {
  const int blocks = (n + kMaxRows - 1) / kMaxRows;
  const int share = (n + blocks - 1) / blocks;
  for (int r : kRowCounts) {
    if (r >= share) return r;
  }
  return kMaxRows;
}

template <typename T, int DP, int R>
cudaError_t launch_dr(const Args<T>& a, cudaStream_t s) {
  const dim3 grid(a.num_kv_heads, a.batch, (a.groups + R - 1) / R);
  decode_attention_kernel<T, DP, R><<<grid, kThreads, 0, s>>>(
      a.q, a.k, a.v, a.out, a.Skv, a.num_kv_heads, a.groups, a.head_dim,
      a.valid_len, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_d(const Args<T>& a, cudaStream_t s) {
#define REPRO_DECODE_ROWS(RR) \
  case RR:                    \
    return launch_dr<T, DP, RR>(a, s);
  switch (rows_for(a.groups)) {
    REPRO_DECODE_ROWS(1)
    REPRO_DECODE_ROWS(2)
    REPRO_DECODE_ROWS(3)
    REPRO_DECODE_ROWS(4)
    REPRO_DECODE_ROWS(5)
    REPRO_DECODE_ROWS(6)
    REPRO_DECODE_ROWS(8)
    REPRO_DECODE_ROWS(10)
    REPRO_DECODE_ROWS(12)
    REPRO_DECODE_ROWS(15)
    REPRO_DECODE_ROWS(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_ROWS
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int Skv, int num_heads, int num_kv_heads, int head_dim,
           int valid_len, float scale, void* stream) {
  if (batch <= 0 || Skv <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads
      || valid_len < 0 || head_dim <= 0 || head_dim % 8 || head_dim > 128)
    return cudaErrorInvalidValue;
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(out), batch, Skv,
                  num_kv_heads, num_heads / num_kv_heads, head_dim,
                  min(valid_len, Skv), scale};
  auto s = static_cast<cudaStream_t>(stream);
  return head_dim <= 64 ? launch_d<T, 64>(a, s) : launch_d<T, 128>(a, s);
}

}  // namespace

#define REPRO_DECODE_ENTRY(SUFFIX, ELEM)                                      \
  extern "C" int decode_attention_##SUFFIX(                                   \
      const void* q, const void* k, const void* v, void* out, int batch,      \
      int Skv, int num_heads, int num_kv_heads, int head_dim, int valid_len,  \
      float scale, void* stream) {                                            \
    return launch<ELEM>(q, k, v, out, batch, Skv, num_heads, num_kv_heads,    \
                        head_dim, valid_len, scale, stream);                  \
  }

REPRO_DECODE_ENTRY(f32, float)
REPRO_DECODE_ENTRY(bf16, __nv_bfloat16)
#undef REPRO_DECODE_ENTRY
