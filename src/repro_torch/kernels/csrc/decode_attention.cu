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
// Design: split-KV (flash-decoding).  As in `_decode_kernel`, a block
// computes the G query heads of one KV head of one sequence, which share
// each K/V row it loads: R of them at a time, G a runtime value and R
// from the paged kernels' set (1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 16: the
// least that holds G, or an equal share of it over blocks of at most 16).
// The valid_len positions are cut into `splits` contiguous ranges at
// multiples of 64 (decode_attention.decode_splits picks the count from
// the shape and the SM count); the grid is (Hkv, B, ceil(G / R) * splits),
// one block per range.  Each block (128 threads) walks its range in tiles
// of 64 positions, the TPU kernel's live blocks:
//   0. aload: K and V rows of tile t + 1 go into a 2-stage ring in shared
//      memory by 16-byte cp.async (one group per tile) while tile t is
//      used; getfin is cp.async.wait_group 0 and a barrier;
//   1. scores: a K row is read from the ring by DP/8 lanes, 8 elements
//      each (a lane past D reads the last live lane's elements against
//      q = 0 and adds an exact 0); the R partial dot products are reduced
//      with warp shuffles;
//   2. softmax: one warp per query head updates the running max and sum;
//   3. P.V: each thread owns 8 dims of the output for a subset of the
//      tile's positions; the position groups are summed once at the end.
// No position at or past the range's end is read.  With one range the
// block stores acc / max(l, 1e-30) itself; with more, it writes its f32
// state (m, l, acc) to the workspace and a second kernel on the same
// stream merges the ranges in order (split_kv.cuh), both enqueued by one
// call of the entry point.
//
// Bound on the card: bytes.  A call reads every valid K and V row once
// (2 * valid_len * D elements per sequence and KV head) and does 4 * G *
// D flops per position, far below the ~295 flop/byte ridge of an H100.
// B * Hkv blocks (64 at B = 8, Hkv = 8) each with one 16-byte load in
// flight per lane held about 128 KiB in flight across the card; the split
// makes at least 2 blocks per SM (3 fit at D 128 in bf16: a 64 KiB ring),
// each with a 64-row tile of K and V in flight (32 KiB at D 128 in bf16),
// several MB across the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_io.cuh"
#include "split_kv.cuh"

namespace {

using repro_dense::load8;
using repro_dense::store1;
using repro_dense::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kStages = 2;     // K/V ring depth, tiles
constexpr int kMaxRows = 16;   // the per-thread accumulator is R * 8 f32
// the row counts with an instance (see rows_for)
constexpr int kRowCounts[] = {1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 16};
constexpr float kNegInf = repro_split::kEmptyMax;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory of one block: the K and V rings of kStages tiles
// of kTile rows of D elements, which the position groups' partial outputs
// ([kThreads / (DP / 8)][DP] f32) reuse after the last tile.
template <typename T, int DP>
size_t ring_bytes(int D) {
  const size_t ring = static_cast<size_t>(2) * kStages * kTile * D * sizeof(T);
  const size_t red = static_cast<size_t>(kThreads / (DP / 8)) * DP * 4;
  return ring > red ? ring : red;
}

// One block of the grid (Hkv, B, ceil(G / R) * splits): block z covers
// query heads g = (z % ceil(G / R)) * R + r of its KV head over range
// z / ceil(G / R).  ws: the split partials (split_kv.cuh), null when
// splits == 1.
template <typename T, int DP, int R>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ ws,
    int Skv, int num_kv_heads, int G, int D, int valid_len, int splits,
    float scale) {
  constexpr int kLanesPerRow = DP / 8;                 // 8 elements per lane
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kRowGroups = kThreads / kLanesPerRow;  // P.V position split
  static_assert(kTile % (kWarps * kRowsPerWarp) == 0, "tile rows");
  static_assert(kTile % kRowGroups == 0, "tile rows");

  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float q_s[R][DP];
  __shared__ float p_s[R][kTile];
  __shared__ float m_s[R], l_s[R], corr_s[R];

  const int n_groups = (G + R - 1) / R;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g0 = (blockIdx.z % n_groups) * R;
  const int split = blockIdx.z / n_groups;
  const int live = min(R, G - g0);      // query heads of this block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long kv_stride = static_cast<long>(num_kv_heads) * D;
  const long kv_base = static_cast<long>(b) * Skv * kv_stride
                       + static_cast<long>(kvh) * D;
  // (b, kvh * G + g0, :) of q / out; the block's heads are D apart
  const int row0 = (b * num_kv_heads + kvh) * G + g0;
  const long q_base = static_cast<long>(row0) * D;

  // this block's range [first, end): whole tiles, the last cut at
  // valid_len; empty past it
  const int n_all = (valid_len + kTile - 1) / kTile;
  const int per = max(1, (n_all + splits - 1) / splits);
  const int first = min(split * per * kTile, valid_len);
  const int end = min(first + per * kTile, valid_len);
  const int n_tiles = (end - first + kTile - 1) / kTile;

  T* ks = reinterpret_cast<T*>(ring);          // [kStages][kTile][D]
  T* vs = ks + kStages * kTile * D;            // [kStages][kTile][D]
  constexpr int kPiece = 16 / sizeof(T);       // elements per cp.async
  const int pieces = D / kPiece;               // per row

  // aload: tile t's K and V rows (those before `end`) into `slot`
  auto aload = [&](int t, int slot) {
    const int t0 = first + t * kTile;
    const int rows = min(kTile, end - t0);
    T* kd = ks + slot * kTile * D;
    T* vd = vs + slot * kTile * D;
    for (int p = tid; p < rows * pieces; p += kThreads) {
      const int r = p / pieces, c = (p % pieces) * kPiece;
      const long src = kv_base + (t0 + r) * kv_stride + c;
      cp_async16(kd + r * D + c, k + src);
      cp_async16(vd + r * D + c, v + src);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) aload(t, t);
    cp_async_commit();
  }

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

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = first + tile * kTile;
    const int slot = tile % kStages;
    // getfin: tile `tile` has landed, every thread's pieces of it; every
    // thread is done with tile - 1, whose slot the next aload refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (tile + kStages - 1 < n_tiles)
      aload(tile + kStages - 1, (tile + kStages - 1) % kStages);
    cp_async_commit();
    const T* kt = ks + slot * kTile * D;
    const T* vt = vs + slot * kTile * D;
    // 1. scores for the tile's positions, all R heads at once
    for (int c = warp * kRowsPerWarp + lane / kLanesPerRow; c < kTile;
         c += kWarps * kRowsPerWarp) {
      const int pos = t0 + c;
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
      if (pos < end) {
        float kf[8];
        load8(kt + c * D + ld, kf);
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
          p_s[r][c] = pos < end ? part[r] : kNegInf;
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
        const float e = t0 + c < end ? expf(p_s[r][c] - m_new) : 0.f;
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
  cp_async_wait<0>();   // the empty groups past the last tile
  __syncthreads();
  // the ring is free: the position groups' partial outputs go there
  auto red_s = reinterpret_cast<float(*)[DP]>(ring);   // [kRowGroups][DP]

  // per head: sum the position groups' partial outputs; one range stores
  // acc / max(l, 1e-30), a split writes its partial state
  const int H = num_kv_heads * G;
  const repro_split::Partials partials(ws, gridDim.y * H, splits, D);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= live) break;   // the same for every thread of the block
#pragma unroll
    for (int e = 0; e < 8; ++e) red_s[grp][sub * 8 + e] = acc[r][e];
    __syncthreads();
    const long slot = (static_cast<long>(row0) + r) * splits + split;
    for (int d = tid; d < D; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kRowGroups; ++j) s += red_s[j][d];
      if (ws == nullptr) {
        store1(out + q_base + r * D + d, s / fmaxf(l_s[r], 1e-30f));
      } else {
        partials.acc[slot * D + d] = s;
      }
    }
    if (ws != nullptr && tid == 0) {
      partials.m[slot] = m_s[r];
      partials.l[slot] = l_s[r];
    }
    __syncthreads();   // red_s is rewritten for the next head
  }
}

#define REPRO_DECODE_PARAMS                                                \
  const T *__restrict__ q, const T *__restrict__ k,                        \
      const T *__restrict__ v, T *__restrict__ out, float *__restrict__ ws, \
      int Skv, int num_kv_heads, int G, int D, int valid_len, int splits,  \
      float scale
#define REPRO_DECODE_ARGS \
  q, k, v, out, ws, Skv, num_kv_heads, G, D, valid_len, splits, scale

// The register hint.  Without one, ptxas (CUDA 12.8) spilled a few bytes
// in one or two instances, which moved as the source changed (R = 5,
// f32 R = 4); asking for two blocks an SM (a cap of 255 registers, not
// reached) spilled none.  But for bf16 R = 12 that hint (or one of three
// blocks) cost registers: 194 instead of 168, two blocks an SM held
// instead of three, and 8 x 2000 positions at G 12 took 0.143 ms instead
// of 0.112 on an H100 (a hint of three spilled); that instance keeps the
// bare bound, under which it spills nothing.
template <typename T, int DP, int R>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_kernel(REPRO_DECODE_PARAMS) {
  decode_block<T, DP, R>(REPRO_DECODE_ARGS);
}

template <typename T, int DP, int R>
__global__ void __launch_bounds__(kThreads)
    decode_bare_attention_kernel(REPRO_DECODE_PARAMS) {
  decode_block<T, DP, R>(REPRO_DECODE_ARGS);
}
#undef REPRO_DECODE_PARAMS
#undef REPRO_DECODE_ARGS

template <typename T, int DP, int R>
constexpr auto kernel_of() {
  if constexpr (sizeof(T) == 2 && R == 12) {
    return decode_bare_attention_kernel<T, DP, R>;
  } else {
    return decode_attention_kernel<T, DP, R>;
  }
}

// The operands of one launch.
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  float* ws;
  int batch, Skv, num_kv_heads, groups, head_dim, valid_len, splits;
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
  const size_t smem = ring_bytes<T, DP>(a.head_dim);
  constexpr auto kernel = kernel_of<T, DP, R>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.num_kv_heads, a.batch,
                  (a.groups + R - 1) / R * a.splits);
  kernel<<<grid, kThreads, smem, s>>>(
      a.q, a.k, a.v, a.out, a.ws, a.Skv, a.num_kv_heads, a.groups,
      a.head_dim, a.valid_len, a.splits, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ws == nullptr) return err;
  return repro_split::launch_combine<T>(
      a.ws, a.out, a.batch * a.num_kv_heads * a.groups, a.splits,
      a.head_dim, s);
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

// ws: B * H * splits * (D + 2) f32 of workspace when splits > 1, else
// null; k and v 16-byte aligned.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* ws,
           int batch, int Skv, int num_heads, int num_kv_heads, int head_dim,
           int valid_len, int splits, float scale, void* stream) {
  if (batch <= 0 || Skv <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads
      || valid_len < 0 || head_dim <= 0 || head_dim % 8 || head_dim > 128
      || splits <= 0 || (splits > 1) != (ws != nullptr))
    return cudaErrorInvalidValue;
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(out),
                  static_cast<float*>(ws), batch, Skv, num_kv_heads,
                  num_heads / num_kv_heads, head_dim, min(valid_len, Skv),
                  splits, scale};
  auto s = static_cast<cudaStream_t>(stream);
  return head_dim <= 64 ? launch_d<T, 64>(a, s) : launch_d<T, 128>(a, s);
}

}  // namespace

#define REPRO_DECODE_ENTRY(SUFFIX, ELEM)                                      \
  extern "C" int decode_attention_##SUFFIX(                                   \
      const void* q, const void* k, const void* v, void* out, void* ws,       \
      int batch, int Skv, int num_heads, int num_kv_heads, int head_dim,      \
      int valid_len, int splits, float scale, void* stream) {                 \
    return launch<ELEM>(q, k, v, out, ws, batch, Skv, num_heads,              \
                        num_kv_heads, head_dim, valid_len, splits, scale,     \
                        stream);                                              \
  }

REPRO_DECODE_ENTRY(f32, float)
REPRO_DECODE_ENTRY(bf16, __nv_bfloat16)
#undef REPRO_DECODE_ENTRY
