// Dense blocked flash attention for Hopper (sm_90a), f32, on the tensor
// cores in 3xTF32.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (its pallas_call at line 114) for
// f32 operands; bf16 operands have their own kernel on wgmma,
// flash_attention_sm90.cu.  Same function: for batch row b, query t at
// absolute position q_offset + t and query head h, softmax(q . K^T /
// sqrt(D)) . V over the KV positions p < kv_valid of KV head h / G that
// the mask lets through — p <= q_pos when causal, p > q_pos - window when
// window > 0 — with an f32 online softmax.  Entry point
// flash_attention_f32 (q, k, v and out f32), head dims 16, 32, 64, 80 and
// 128, any G.
//
// Layout: the model layout, read in place (no transposes): q and out
// (B, Sq, H, D), k and v (B, Skv, Hkv, D).  H = G * Hkv.
//
// Products: mma.sync m16n8k8 TF32 with an f32 accumulator, for Q K^T and
// for P V.  One TF32 product keeps 11 significant bits of each operand,
// about 5e-4 of error, a hundred times the reference's f32 bar (5e-6 of
// max |ref|); so every operand x is split into a TF32 head and tail,
// x = hi + lo: hi is x rounded to nearest (ties away from zero, the
// rounding of cvt.rna.tf32.f32 for a finite x, in two integer ops), lo =
// x - hi is exact in f32 and goes to the tensor core as it is (the unit
// reads its top 19 bits).  a . b is then lo_a . hi_b + hi_a . lo_b +
// hi_a . hi_b, the two small products added first; what is dropped
// (lo_a . lo_b and lo's low bits) is about 2^-21 of each product
// (CUTLASS's OpMultiplyAddFastF32 is the same split).  The tensor core
// truncates as it accumulates, so no accumulator runs long: each 16-dim
// chunk of a score (six products) and each stage's P V (twelve or fewer)
// start from zero and join their sums by f32 adds, O = O * corr + P V
// in one fmaf (a chain through every stage of a 2048-long row measured
// 1.2e-5 of max |ref|, over the bar).
//
// Fragments: a warp owns 16 query rows.  Thread (g = lane / 4, t = lane %
// 4) holds rows g and g + 8.  The sums over head dims and over positions
// are order-free, so both are permuted once, identically on both sides:
//   * Q K^T: within each 16-dim chunk, k-step 2m takes dims 16m + 4t + {0,
//     1} and k-step 2m + 1 dims 16m + 4t + {2, 3} as the k-indices t and
//     t + 4, so a thread reads its four K elements of a chunk with one
//     16-byte shared load, and its q elements the same way;
//   * P V: the accumulator of S = Q K^T holds columns 2t and 2t + 1 of
//     each 8-position group, where the A operand of the next mma wants
//     columns t and t + 4; so P's k-index t is position 2t and t + 4 is
//     2t + 1, and V's B operand reads rows 2t and 2t + 1 of the group.
//     P never leaves registers.
// Shared rows are padded (K: a multiple of 32 floats plus 16, V: of 16
// plus 4) so that these loads meet no bank conflict.
//
// Block: 4 warps.  The plan (flash_attention.f32_flash_plan, from B, H,
// Sq and the SM count) sets how many of them stack along the queries,
// warps_q in {4, 2, 1}, rows a block = 16 * warps_q; the other 4 /
// warps_q warps split each ring stage's positions between them (the KV
// axis split inside the block), and their partial states (m, l, O) meet
// in shared memory at the end, merged in warp order by the log-sum-exp
// rule of split_kv.cuh: one launch, no workspace, the same bits every
// call.  Fewer rows a block make more blocks where q-tiles x heads x
// batch would leave SMs idle (the reference benchmark's B1 H4 S256: 64
// blocks of 16 rows instead of 16 of 64).  The grid is (H * B, q-tiles),
// the last q-tile first: under a causal mask it walks the most positions,
// so the heaviest blocks start first and the light ones fill the tail.
//
// Shared memory: the block's q rows (kept there, not in registers, which
// the f32 accumulator fills at D 128), then a ring of stages of 32
// positions of K and V (rows past kv_valid zero-filled), 3 deep (2 at D
// 128, so that two blocks fit an SM), in dynamic shared memory (above 48
// KB), by 16-byte cp.async (one group per stage, q with the first):
// stage i + 2 (i + 1) loads while stage i is used.  Block liveness (the
// TPU kernel's lines 51-58) bounds the stages a block walks: positions
// from first_q - window + 1 (with a window) to min(kv_valid, last_q + 1)
// (causal); a warp also skips the
// part of a stage that its 16 rows cannot see, and masks scores only in
// a part that some row sees partly.  Masked scores are -1e30, finite as
// in the TPU kernel, so a row that meets only masked positions carries
// exp(0) weights until its first visible key, where the rescale
// exp(-1e30 - m) = 0 removes them exactly, as the reference's does; a
// query that sees no key at all (possible only with kv_valid or a window
// that leaves it nothing) is don't-care, as in the reference.  Scores are
// kept in base 2: q is scaled by log2(e) / sqrt(D) as it is read.
//
// Bound on the card: operations — 4 * D flops per visible (query,
// position) pair, three TF32 products each at 495 TFLOP/s, or the same
// flops at the 67 TFLOP/s of the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_io.cuh"

namespace {

using repro_dense::store4;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;        // query rows a warp: the mma's M
constexpr int kBlockKV = 32;     // positions a ring stage
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in floats: the q tile and the ring, which
// the warps' partial states reuse after the last stage; 3 stages, 2 at
// D 128, so that two blocks fit an SM (flash_attention.f32_flash_smem
// mirrors it).
template <int D>
struct Layout {
  static constexpr int kStages = D >= 128 ? 2 : 3;
  static constexpr int kK = D % 32 == 16 ? D : D + 16;   // q and K rows
  static constexpr int kV = D + 4;                       // V rows
  static constexpr int kO = D + 4;                       // partial O rows
  static constexpr int kQ = kWarps * kRows * kK;         // the q tile
  static constexpr int kStage = kBlockKV * (kK + kV);
  static constexpr int kAll = kQ + kStages * kStage;
  static constexpr int kParts = kWarps * kRows * (kO + 2);
  static constexpr int kFloats = kAll > kParts ? kAll : kParts;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi the TF32 head of x rounded to nearest, ties away from
// zero (low 13 bits zero), lo = x - hi, exact.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32, the two small products first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int D, int WKV>
__global__ void __launch_bounds__(kThreads, 2) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Sq, int Skv,
    int num_heads, int num_kv_heads, int causal, int window, int q_offset,
    int kv_valid, float scale2) {
  using L = Layout<D>;
  constexpr int kStages = L::kStages;
  constexpr int WQ = kWarps / WKV;          // warps along the queries
  constexpr int kBlockQ = kRows * WQ;
  constexpr int PW = kBlockKV / WKV;        // a warp's positions of a stage
  constexpr int NT = PW / 8;                // ... in 8-position groups
  constexpr int KC = D / 16;                // 16-dim chunks (two k-steps)
  constexpr int NN = D / 8;                 // 8-dim groups of the output
  constexpr int kVecs = D / 4;              // 16-byte pieces of a row
  extern __shared__ __align__(16) float smem[];

  const int h = blockIdx.x % num_heads, b = blockIdx.x / num_heads;
  const int qt = gridDim.y - 1 - blockIdx.y;      // heaviest first
  const int kvh = h / (num_heads / num_kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tg = lane % 4;
  const int wq = warp / WKV, wk = warp % WKV;
  const int t_first = qt * kBlockQ;
  const int first_q = q_offset + t_first;
  const int last_q = q_offset + min(t_first + kBlockQ, Sq) - 1;
  const int w_t0 = t_first + kRows * wq;          // this warp's rows
  const bool w_rows = w_t0 < Sq;
  const int w_first = q_offset + w_t0;
  const int w_last = q_offset + min(w_t0 + kRows, Sq) - 1;

  // the block's q rows go to shared memory with the first stage (zeros
  // past Sq): registers hold the accumulator, not q
  float* const qs = smem;
  float* const ring = smem + L::kQ;
  for (int e = threadIdx.x; e < kBlockQ * kVecs; e += kThreads) {
    const int r = e / kVecs, c = e % kVecs;
    const int t = t_first + r;
    const bool ok = t < Sq;
    cp_async16(qs + r * L::kK + 4 * c,
               q + ((static_cast<long>(b) * Sq + (ok ? t : 0)) * num_heads
                    + h) * D + 4 * c, ok);
  }

  // the block's stages: positions [lo, hi) that any of its rows can see
  int lo = 0, hi = kv_valid;
  if (causal) hi = min(hi, last_q + 1);
  if (window > 0) lo = max(0, first_q - window + 1);
  const int tile_lo = lo / kBlockKV;
  const int n_tiles = hi > lo ? (hi + kBlockKV - 1) / kBlockKV - tile_lo : 0;

  const long kv_stride = static_cast<long>(num_kv_heads) * D;
  const long kv_base = static_cast<long>(b) * Skv * kv_stride
                       + static_cast<long>(kvh) * D;

  // aload: stage i's K and V rows by 16-byte cp.async, zeros past kv_valid
  auto load_tile = [&](int i) {
    float* ks = ring + (i % kStages) * L::kStage;
    float* vs = ks + kBlockKV * L::kK;
    const int k0 = (tile_lo + i) * kBlockKV;
    for (int e = threadIdx.x; e < kBlockKV * kVecs; e += kThreads) {
      const int r = e / kVecs, c = e % kVecs;
      const int pos = k0 + r;
      const bool ok = pos < kv_valid;
      const long off = kv_base + static_cast<long>(ok ? pos : 0) * kv_stride
                       + 4 * c;
      cp_async16(ks + r * L::kK + 4 * c, k + off, ok);
      cp_async16(vs + r * L::kV + 4 * c, v + off, ok);
    }
  };

  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    // getfin: stage i landed, and every warp is done with stage i - 1,
    // whose slot stage i + kStages - 1 now takes
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();

    const int p0 = (tile_lo + i) * kBlockKV + wk * PW;  // this warp's part
    const int p1 = p0 + PW - 1;
    bool live = w_rows && p0 < kv_valid;
    if (causal) live = live && p0 <= w_last;
    if (window > 0) live = live && p1 > w_first - window;
    if (!live) continue;
    const bool full = p1 < kv_valid && (!causal || p1 <= w_first)
                      && (window <= 0 || p0 > w_last - window);
    const float* ks = ring + (i % kStages) * L::kStage;
    const float* vs = ks + kBlockKV * L::kK;
    const float* qb = qs + (kRows * wq + gr) * L::kK + 4 * tg;

    // S = Q K^T over the warp's PW positions, each 16-dim chunk's six
    // products into a fresh accumulator, added to S in f32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const float* kb = ks + (wk * PW + gr) * L::kK + 4 * tg;
#pragma unroll
    for (int m = 0; m < KC; ++m) {
      // q in base 2, rows g (x0) and g + 8 (x1), dims 16m + 4t .. + 3.
      // k-step 2m: a = (row g, dim 4t), (g + 8, 4t), (g, 4t + 1),
      // (g + 8, 4t + 1) of the chunk; k-step 2m + 1: dims 4t + 2, 4t + 3
      const float4 x0 = *reinterpret_cast<const float4*>(qb + 16 * m);
      const float4 x1 =
          *reinterpret_cast<const float4*>(qb + 8 * L::kK + 16 * m);
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      split(x0.x * scale2, ah0[0], al0[0]);
      split(x1.x * scale2, ah0[1], al0[1]);
      split(x0.y * scale2, ah0[2], al0[2]);
      split(x1.y * scale2, ah0[3], al0[3]);
      split(x0.z * scale2, ah1[0], al1[0]);
      split(x1.z * scale2, ah1[1], al1[1]);
      split(x0.w * scale2, ah1[2], al1[2]);
      split(x1.w * scale2, ah1[3], al1[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kb + j * 8 * L::kK + 16 * m);
        uint32_t bh[4], bl[4];
        split(kk.x, bh[0], bl[0]);
        split(kk.y, bh[1], bl[1]);
        split(kk.z, bh[2], bl[2]);
        split(kk.w, bh[3], bl[3]);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(part, ah0, al0, bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(part, ah1, al1, bh[2], bh[3], bl[2], bl[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[e];
      }
    }
    if (!full) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q_pos = w_first + gr + 8 * (e / 2);
          const int pos = p0 + 8 * j + 2 * tg + (e & 1);
          bool ok = pos < kv_valid;
          if (causal) ok = ok && pos <= q_pos;
          if (window > 0) ok = ok && pos > q_pos - window;
          if (!ok) s[j][e] = kNegInf;
        }
    }

    // online softmax of rows g (i = 0) and g + 8 (i = 1): a quad of
    // threads shares a row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - m_run[0]);
      s[j][1] = exp2f(s[j][1] - m_run[0]);
      s[j][2] = exp2f(s[j][2] - m_run[1]);
      s[j][3] = exp2f(s[j][3] - m_run[1]);
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
    // O = O * corr + P V, the stage's P V into a fresh accumulator: the
    // tensor core truncates as it accumulates, and a chain over every
    // stage of a 2048-long row drifts past the f32 bar.  P's k-index t is
    // position 2t of the group, t + 4 is 2t + 1
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split(s[j][0], ph[j][0], pl[j][0]);
      split(s[j][2], ph[j][1], pl[j][1]);
      split(s[j][1], ph[j][2], pl[j][2]);
      split(s[j][3], ph[j][3], pl[j][3]);
    }
    const float* vb = vs + (wk * PW + 2 * tg) * L::kV + gr;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* vr = vb + j * 8 * L::kV + 8 * n;
        uint32_t vh0, vl0, vh1, vl1;
        split(vr[0], vh0, vl0);
        split(vr[L::kV], vh1, vl1);
        mma_3xtf32(pv, ph[j], pl[j], vh0, vh1, vl0, vl1);
      }
      o[n][0] = fmaf(o[n][0], corr[0], pv[0]);
      o[n][1] = fmaf(o[n][1], corr[0], pv[1]);
      o[n][2] = fmaf(o[n][2], corr[1], pv[2]);
      o[n][3] = fmaf(o[n][3], corr[1], pv[3]);
    }
  }

  // the warps' partial states meet in shared memory (the ring is free)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* o_part = smem + warp * kRows * L::kO;
  float* m_part = smem + kWarps * kRows * L::kO;
  float* l_part = m_part + kWarps * kRows;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    *reinterpret_cast<float2*>(o_part + gr * L::kO + 8 * n + 2 * tg) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(o_part + (gr + 8) * L::kO + 8 * n + 2 * tg) =
        make_float2(o[n][2], o[n][3]);
  }
  if (tg == 0) {
    m_part[warp * kRows + gr] = m_run[0];
    m_part[warp * kRows + gr + 8] = m_run[1];
    l_part[warp * kRows + gr] = l_run[0];
    l_part[warp * kRows + gr + 8] = l_run[1];
  }
  __syncthreads();

  // merge each row's WKV parts in warp order and store, 16 bytes a thread
  for (int e = threadIdx.x; e < kBlockQ * kVecs; e += kThreads) {
    const int r = e / kVecs, c = e % kVecs;
    const int t = t_first + r;
    if (t >= Sq) continue;
    const int w0 = (r / kRows) * WKV, rr = r % kRows;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < WKV; ++w) mx = fmaxf(mx, m_part[(w0 + w) * kRows + rr]);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < WKV; ++w) {
      const int part = (w0 + w) * kRows + rr;
      const float wgt = exp2f(m_part[part] - mx);
      den += l_part[part] * wgt;
      const float4 x = *reinterpret_cast<const float4*>(
          smem + part * L::kO + 4 * c);
      acc.x += x.x * wgt;
      acc.y += x.y * wgt;
      acc.z += x.z * wgt;
      acc.w += x.w * wgt;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    store4(out + ((static_cast<long>(b) * Sq + t) * num_heads + h) * D + 4 * c,
           make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  }
}

template <int D, int WKV>
cudaError_t launch_plan(const float* q, const float* k, const float* v,
                        float* out, int batch, int Sq, int Skv, int num_heads,
                        int num_kv_heads, int causal, int window,
                        int q_offset, int kv_valid, float scale2,
                        cudaStream_t s) {
  constexpr int kBlockQ = kRows * (kWarps / WKV);
  const size_t smem = sizeof(float) * Layout<D>::kFloats;
  const auto kernel = flash_f32_kernel<D, WKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long q_tiles = (Sq + kBlockQ - 1) / kBlockQ;
  const long bh = static_cast<long>(batch) * num_heads;
  if (q_tiles > 65535 || bh > 0x7fffffffL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>(q_tiles));
  kernel<<<grid, kThreads, smem, s>>>(q, k, v, out, Sq, Skv, num_heads,
                                      num_kv_heads, causal, window, q_offset,
                                      kv_valid, scale2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int warps_q, const float* q, const float* k,
                     const float* v, float* out, int batch, int Sq, int Skv,
                     int num_heads, int num_kv_heads, int causal, int window,
                     int q_offset, int kv_valid, float scale2,
                     cudaStream_t s) {
  switch (warps_q) {
    case 4:
      return launch_plan<D, 1>(q, k, v, out, batch, Sq, Skv, num_heads,
                               num_kv_heads, causal, window, q_offset,
                               kv_valid, scale2, s);
    case 2:
      return launch_plan<D, 2>(q, k, v, out, batch, Sq, Skv, num_heads,
                               num_kv_heads, causal, window, q_offset,
                               kv_valid, scale2, s);
    case 1:
      return launch_plan<D, 4>(q, k, v, out, batch, Sq, Skv, num_heads,
                               num_kv_heads, causal, window, q_offset,
                               kv_valid, scale2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int Sq, int Skv, int num_heads, int num_kv_heads, int head_dim,
           int causal, int window, int q_offset, int kv_valid, float scale,
           int warps_q, void* stream) {
  if (batch <= 0 || Sq <= 0 || Skv <= 0 || num_kv_heads <= 0
      || num_heads % num_kv_heads || q_offset < 0)
    return cudaErrorInvalidValue;
  kv_valid = min(kv_valid, Skv);
  const auto qq = static_cast<const float*>(q);
  const auto kk = static_cast<const float*>(k);
  const auto vv = static_cast<const float*>(v);
  const auto oo = static_cast<float*>(out);
  const float scale2 = scale * kLog2e;
  const auto s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(DD)                                                  \
  case DD:                                                                    \
    return launch_d<DD>(warps_q, qq, kk, vv, oo, batch, Sq, Skv, num_heads,   \
                        num_kv_heads, causal, window, q_offset, kv_valid,     \
                        scale2, s);
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
}

}  // namespace

// warps_q: the plan's warps along the queries, 4, 2 or 1
// (flash_attention.f32_flash_plan).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int batch,
                                   int Sq, int Skv, int num_heads,
                                   int num_kv_heads, int head_dim, int causal,
                                   int window, int q_offset, int kv_valid,
                                   float scale, int warps_q, void* stream) {
  return launch(q, k, v, out, batch, Sq, Skv, num_heads, num_kv_heads,
                head_dim, causal, window, q_offset, kv_valid, scale, warps_q,
                stream);
}
