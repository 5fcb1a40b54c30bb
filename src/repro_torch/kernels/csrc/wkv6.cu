// Chunk-parallel RWKV-6 ("Finch") WKV for Hopper (sm_90a), its products
// on the tensor cores.
//
// Replaces the TPU kernel `_wkv6_kernel` / `wkv6` of
// src/repro/kernels/rwkv6.py (its pallas_call at line 93).  Same
// function: per batch row b and head h, with log decay w <= 0 and bonus u,
//   o_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t,
//   S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T,   S_0 = 0 (K x V, f32).
// Entry points wkv6_f32 and wkv6_bf16: r, k, v and out of that type; w
// and u f32 (the decay path stays f32, as in the model).
//
// Layout: the model layout, read in place: r, k, w (B, T, H, K), v and
// out (B, T, H, V), u (H, K).
//
// Design: the sequence is cut into pieces of `rows` rows (the chunk or a
// divisor of it) and the pieces into segments of `seg`, as the plan
// rwkv6.wkv6_plan sets (build.recurrence_plan).  Inside a piece, with W
// the inclusive cumulative sum of w down each key column and W_{t-1} the
// exclusive one (0 at the piece's first row; the kernel keeps both in
// base 2, W log2(e), and takes 2^x in one MUFU op):
//   inter-piece  o_t += (r_t * e^{W_{t-1}}) . S_in
//   intra-piece  att[t][s] = sum_k r_tk k_sk e^{W_{t-1,k} - W_{s,k}}, s < t,
//                att[t][t] = r_t . (u * k_t) (the bonus); o_t += att[t] . v
//   state        S_out = e^{W_last} S_in + (k * e^{W_last - W})^T v.
// One call enqueues three kernels on the stream:
//   (A) one block per (segment but the last, head, batch row): the state
//       its segment builds from zero, and its log decay (the sum of its
//       pieces' W_last), into a workspace;
//   (B) repro_ssm::state_scan: S_{g+1} = e^{d_g} S_g + U_g in place, a
//       thread per 4 state elements, the segments in a loop;
//   (C) one block per (segment, head, batch row): its outputs, from the
//       state entering it (zero for the first), carried through its
//       pieces.
// With one segment (A) and (B) are skipped.  At rwkv6-7b's width (B 1,
// T 2048, H 64, chunk 64) the plan takes pieces of 64 rows, segments of
// 4: 512 blocks of (C) and 448 of (A), where the kernel before them ran
// 128 blocks that each walked 32 chunks in turn.
//
// Inside a piece (8 warps; sub-chunks of 16 rows, a warp's mma rows; the
// widths K = V in {32, 64, 128} are template constants):
//   * the tiles by cp.async (f32) or 8-byte loads widened in registers
//     (bf16), every tile's loads in flight together; W by a thread per
//     key column;
//   * att off the diagonal blocks on the tensor cores, one exponential
//     reference per row sub-chunk i (fla's chunk_rwkv6): with ref =
//     W_{16i-1}, att[t][s] = (r_t e^{W_{t-1} - ref}) . (k_s e^{ref - W_s})
//     for t in sub-chunk i and s < 16 i; both exponents are <= 0 (W falls
//     down a column), so neither factor overflows where the e^{-W} form
//     does;
//   * inside a diagonal block the same split again: its 8-row halves and
//     4-row quarters on the tensor cores about the W of the row before,
//     the pairs inside a quarter on the CUDA cores, an exponential per
//     (t, s, k) (e^{min(W_{t-1} - W_s, 0)}), and the bonus;
//   * out = (r e^{W_{t-1}}) . S + att . v and U = (k e^{W_last - W})^T v
//     on the tensor cores (repro_ssm::warp_mma); every exponent <= 0.
// Products are 3xTF32; v is exact in TF32 in the bf16 instance, so its
// products there are two (ssm_chunks.cuh).
//
// Bound on the card: bytes (r, k, v, w read once, out written once:
// ~100 MB at rwkv6-7b's T = 2048; the chunked form's ~3.2 GFLOP take a
// tenth of that time at the bf16 tensor rate).  The
// limiter: (C), where the pairs inside the quarters on the CUDA cores,
// the staging of each piece's tiles and the product with S_in take the
// most time, each block serial in its phases at two blocks an SM; and
// the inputs (A) reads again, with the workspace's round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "dense_io.cuh"
#include "ssm_chunks.cuh"

namespace {

using namespace repro_ssm;

template <typename T>
struct Args {
  const T* r;
  const T* k;
  const T* v;
  const float* w;
  const float* u;
  T* out;
  float* states;    // (B, H, segments - 1, K, V)
  float* decays;    // (B, H, segments - 1, K)
  int T_len, H, rows, seg, nseg;
};

// Shared memory of a block, in floats: k, W (cp + 1 rows: row 0 zero, row
// t + 1 W_t) and r at K + 4 floats a row, v and the state at V + 8, att
// at cp + 4; (A) has no r, att or u.  rwkv6.wkv6_smem mirrors it.
struct Layout {
  int sk, sv, sa, k, wx, v, s, r, att, u, total;
  __host__ __device__ Layout(int K, int V, int cp, bool outputs) {
    sk = stride_a(K);
    sv = stride_b(V);
    sa = stride_a(cp);
    k = 0;
    wx = k + cp * sk;
    v = wx + (cp + 1) * sk;
    s = v + cp * sv;
    r = s + K * sv;
    att = r + (outputs ? cp * sk : 0);
    u = att + (outputs ? cp * sa : 0);
    total = u + (outputs ? K : 0);
  }
};

// The diagonal blocks' pairs left to the CUDA cores: those inside each
// 4-row quarter of a sub-chunk, t >= s, 10 a quarter.
constexpr int kQuarter = 4, kQuarterPairs = kQuarter * (kQuarter + 1) / 2;
constexpr int kDiagPairs = (kSub / kQuarter) * kQuarterPairs;
static_assert((kDiagPairs + 31) / 32 == 2, "diag_batch is called twice");

// The rows of one diagonal block (sub-chunk) in shared memory: r, k and
// W_{t-1} (row t of wx; W_s is row s + 1), u, the lane.
struct DiagRows {
  const float* r;
  const float* k;
  const float* wx;
  const float* u;
  int lane;
};

// Pairs q in [32 kB, 32 kB + 32) of a diagonal block, pair q = 10 qq + tl
// (tl + 1) / 2 + sl the entry (t, s) = (4 qq + tl, 4 qq + sl), sl <= tl:
// the lanes split the key columns and sum their pairs (the pairwise decay
// below the diagonal, the bonus on it), and a butterfly reduce-scatter
// leaves pair 32 kB + lane in the lane.  kB, the rows and the slots are
// known at compile time, so the sums stay in registers and the rows'
// loads are shared.
template <int kB, int K>
__device__ __forceinline__ float diag_batch(const DiagRows& x) {
  constexpr int sk = stride_a(K), lo = 32 * kB, hi = 32 * (kB + 1);
  float part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) part[e] = 0.f;
#pragma unroll 1   // one column pass at a time: no spills at K = 128
  for (int d0 = 0; d0 < K; d0 += 32) {
    const int d = d0 + x.lane;
#pragma unroll
    for (int qq = 0; qq < kSub / kQuarter; ++qq)
#pragma unroll
      for (int tl = 0; tl < kQuarter; ++tl) {
        const int q0 = kQuarterPairs * qq + tl * (tl + 1) / 2;
        if (q0 + tl < lo || q0 >= hi) continue;
        const int t = kQuarter * qq + tl;
        const float rd = x.r[t * sk + d];
        const float wt = x.wx[t * sk + d];
#pragma unroll
        for (int sl = 0; sl < kQuarter; ++sl) {   // constant trip count
          const int q = q0 + sl, s = kQuarter * qq + sl;
          if (sl > tl || q < lo || q >= hi) continue;
          const float kd = x.k[s * sk + d];
          part[q - lo] += sl < tl
              ? rd * kd * ex2(fminf(wt - x.wx[(s + 1) * sk + d], 0.f))
              : rd * (x.u[d] * kd);
        }
      }
  }
  reduce_scatter(part, x.lane);
  return part[0];
}

// Two blocks an SM (128 registers a thread), but at K = 128 one: its
// (C) instance needs a few more registers than 128.
template <typename T, bool kOut, int K, int V>
__global__ void __launch_bounds__(kThreads, K > 64 ? 1 : 2)
    wkv6_pieces(Args<T> a) {
  constexpr bool kSplitV = !std::is_same<T, __nv_bfloat16>::value;
  constexpr int sk = stride_a(K), sv = stride_b(V);
  extern __shared__ __align__(16) float sm[];
  const int cp = round16(a.rows);
  const Layout L(K, V, cp, kOut);
  const int sa = L.sa;
  float* const ks = sm + L.k;
  float* const wx = sm + L.wx;
  float* const vs = sm + L.v;
  float* const S = sm + L.s;
  float* const rs = sm + L.r;
  float* const att = sm + L.att;
  float* const us = sm + L.u;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lg = lane / 4, lt = lane % 4;
  const long ldk = static_cast<long>(a.H) * K;
  const long ldv = static_cast<long>(a.H) * V;
  const long slot = (static_cast<long>(b) * a.H + h) * (a.nseg - 1);
  const int nsub = cp / kSub;

  if (kOut && g > 0)
    load_block<V>(S, sv, a.states + (slot + g - 1) * K * V, K);
  else
    zero_block<V>(S, sv, K);
  if (kOut)
    for (int c = threadIdx.x; c < K; c += kThreads) us[c] = a.u[h * K + c];
  float wsum = 0.f;   // (A): the segment's log decay, thread c's column

  for (int p = 0; p < a.seg; ++p) {
    const long t0 = static_cast<long>(g * a.seg + p) * a.rows;
    const long rk = (static_cast<long>(b) * a.T_len + t0) * ldk
                    + static_cast<long>(h) * K;
    const long rv = (static_cast<long>(b) * a.T_len + t0) * ldv
                    + static_cast<long>(h) * V;
    __syncthreads();   // the previous piece is done with every tile
    // w by cp.async, then k, v and r, all in flight at once (a width of
    // 128 holds twice the registers: there each is copied in turn)
    Stager<K, float>().load(wx + sk, sk, a.w + rk, ldk, cp, a.rows);
    if (K > 64) {
      Stager<K, T>().copy(ks, sk, a.k + rk, ldk, cp, a.rows);
      Stager<V, T>().copy(vs, sv, a.v + rv, ldv, cp, a.rows);
      if (kOut) Stager<K, T>().copy(rs, sk, a.r + rk, ldk, cp, a.rows);
    } else {
      Stager<K, T> tk, tr;
      Stager<V, T> tv;
      tk.load(ks, sk, a.k + rk, ldk, cp, a.rows);
      tv.load(vs, sv, a.v + rv, ldv, cp, a.rows);
      if (kOut) tr.load(rs, sk, a.r + rk, ldk, cp, a.rows);
      tk.store();
      tv.store();
      if (kOut) tr.store();
    }
    staged();
    // W down each key column, in base 2 (rows past the piece hold w = 0)
    for (int c = threadIdx.x; c < K; c += kThreads) {
      float acc = 0.f;
      wx[c] = 0.f;
      for (int r0 = 0; r0 < cp; r0 += kSub) {
        float x[kSub];
#pragma unroll
        for (int j = 0; j < kSub; ++j) x[j] = wx[(r0 + j + 1) * sk + c];
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          acc += x[j] * kLog2e;
          wx[(r0 + j + 1) * sk + c] = acc;
        }
      }
    }
    __syncthreads();
    const float* const wl = wx + cp * sk;   // W_last (w = 0 past the piece)

    if (kOut) {
      const bool state_in = g > 0 || p > 0;
      // att off the diagonal: sub-chunk i's rows against columns s < 16 i,
      // scaled about ref = W_{16i-1}, a warp a (sub-chunk, 8 kGroup
      // columns) unit, the heaviest sub-chunks first
      for (int i = nsub - 1, unit = 0; i >= 1; --i) {
        const int tb = kSub * i;
        const float* const ref = wx + tb * sk;
        for (int n0 = 0; n0 < tb; n0 += 8 * kGroup, ++unit) {
          if (unit % kWarps != warp) continue;
          float acc[kGroup][4];
          zero(acc);
          warp_mma<true, true>(
              acc, min(kGroup, (tb - n0) / 8), K,
              [&](int row, int d) {
                const int t = tb + row;
                return rs[t * sk + d] * ex2(wx[t * sk + d] - ref[d]);
              },
              [&](int d, int col) {
                const int s = n0 + col;
                return ks[s * sk + d] * ex2(ref[d] - wx[(s + 1) * sk + d]);
              });
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (n0 + 8 * j < tb)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float* dst = att + (tb + lg + 8 * hh) * sa + n0 + 8 * j
                             + 2 * lt;
                dst[0] = acc[j][2 * hh];
                dst[1] = acc[j][2 * hh + 1];
              }
        }
      }
      // the diagonal blocks, a warp a block from the last warp down (the
      // first warps take the blocks off the diagonal), zero above it.  The
      // pairs across its 8-row halves (rows 8-15 x columns 0-7) and across
      // the 4-row quarters of each half (4-7 x 0-3, 12-15 x 8-11) on the
      // tensor cores, each about the W of the last row before its rows,
      // the other rows and columns masked to zero; the pairs inside a
      // quarter (diag_batch) on the CUDA cores
      for (int i = kWarps - 1 - warp; i < nsub; i += kWarps) {
        const int tb = kSub * i;
        for (int e = lane; e < kSub * kSub; e += 32)
          if (e % kSub > e / kSub)
            att[(tb + e / kSub) * sa + tb + e % kSub] = 0.f;
#pragma unroll 1
        for (int across = 0; across < 3; ++across) {
          const int r_lo = across == 0 ? 8 : across == 1 ? 4 : 12;
          const int r_hi = across == 0 ? 16 : r_lo + 4;
          const int c0 = across == 2 ? 8 : 0, cols = across == 0 ? 8 : 4;
          const float* const ref = wx + (tb + r_lo) * sk;   // W_{tb+r_lo-1}
          float acc[kGroup][4];
          zero(acc);
          warp_mma<1, true, true>(
              acc, K,
              [&](int row, int d) {
                const int t = tb + row;
                return row >= r_lo && row < r_hi
                           ? rs[t * sk + d]
                                 * ex2(fminf(wx[t * sk + d] - ref[d], 0.f))
                           : 0.f;
              },
              [&](int d, int col) {
                const int s = tb + c0 + col;
                return col < cols
                           ? ks[s * sk + d]
                                 * ex2(fminf(ref[d] - wx[(s + 1) * sk + d],
                                             0.f))
                           : 0.f;
              });
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = lg + 8 * (e / 2), col = 2 * lt + e % 2;
            if (row >= r_lo && row < r_hi && col < cols)
              att[(tb + row) * sa + tb + c0 + col] = acc[0][e];
          }
        }
        const DiagRows rows{rs + tb * sk, ks + tb * sk, wx + tb * sk, us,
                            lane};
        const float sum[2] = {diag_batch<0, K>(rows), diag_batch<1, K>(rows)};
#pragma unroll
        for (int bt = 0; bt < 2; ++bt) {
          const int q = 32 * bt + lane;
          if (q < kDiagPairs) {
            const int qq = q / kQuarterPairs, p = q % kQuarterPairs;
            const int tl = tri_row(p);
            att[(tb + kQuarter * qq + tl) * sa + tb + kQuarter * qq + p
                - tl * (tl + 1) / 2] = sum[bt];
          }
        }
      }
      __syncthreads();
      // out = (r e^{W_{t-1}}) . S_in + att . v, a warp a row sub-chunk
      // and 32 columns
      constexpr int kCols = 8 * kGroup, kGroups = V / kCols;
      for (int unit = warp; unit < nsub * kGroups; unit += kWarps) {
        const int i = unit / kGroups, n0 = (unit % kGroups) * kCols;
        const int tb = kSub * i;
        float acc[kGroup][4];
        zero(acc);
        if (state_in)
          warp_mma<kGroup, true, true>(
              acc, K,
              [&](int row, int d) {
                const int t = tb + row;
                return rs[t * sk + d] * ex2(wx[t * sk + d]);
              },
              [&](int d, int col) { return S[d * sv + n0 + col]; });
        warp_mma<kGroup, true, kSplitV>(
            acc, tb + kSub,
            [&](int row, int s) { return att[(tb + row) * sa + s]; },
            [&](int s, int col) { return vs[s * sv + n0 + col]; });
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = tb + lg + 8 * hh;
          if (t < a.rows) {
            T* dst = a.out + rv + t * ldv + n0 + 2 * lt;
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              store2(dst + 8 * j, acc[j][2 * hh], acc[j][2 * hh + 1]);
          }
        }
      }
    }
    if (!kOut || p + 1 < a.seg) {
      if (kOut) __syncthreads();   // every output has read S_in
      // S = e^{W_last} S + (k e^{W_last - W})^T v, a warp 16 key rows and
      // 32 columns
      constexpr int kCols = 8 * kGroup, kGroups = V / kCols;
      for (int unit = warp; unit < (K / kSub) * kGroups; unit += kWarps) {
        const int m0 = kSub * (unit / kGroups);
        const int n0 = (unit % kGroups) * kCols;
        float acc[kGroup][4];
        zero(acc);
        warp_mma<kGroup, true, kSplitV>(
            acc, cp,
            [&](int row, int s) {
              const int c = m0 + row;
              return ks[s * sk + c] * ex2(wl[c] - wx[(s + 1) * sk + c]);
            },
            [&](int s, int col) { return vs[s * sv + n0 + col]; });
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = m0 + lg + 8 * hh;
          const float decay = ex2(wl[c]);
          float* row = S + c * sv + n0 + 2 * lt;
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            row[8 * j] = fmaf(decay, row[8 * j], acc[j][2 * hh]);
            row[8 * j + 1] = fmaf(decay, row[8 * j + 1], acc[j][2 * hh + 1]);
          }
        }
      }
      if (!kOut)
        for (int c = threadIdx.x; c < K; c += kThreads) wsum += wl[c];
    }
  }
  if (!kOut) {
    __syncthreads();
    store_block<V>(a.states + (slot + g) * K * V, S, sv, K);
    for (int c = threadIdx.x; c < K; c += kThreads)
      a.decays[(slot + g) * K + c] = wsum;
  }
}

template <typename T, bool kOut, int K, int V>
int launch_phase(const Args<T>& a, int blocks_x, int batch,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout(K, V, round16(a.rows),
                                             kOut).total;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_pieces<T, kOut, K, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wkv6_pieces<T, kOut, K, V><<<dim3(blocks_x, a.H, batch), kThreads, smem,
                               stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int K, int V>
int launch_widths(const Args<T>& a, int batch, cudaStream_t s) {
  if (a.nseg > 1) {
    int err = launch_phase<T, false, K, V>(a, a.nseg - 1, batch, s);
    if (err) return err;
    err = launch_scan(a.states, a.decays, batch * a.H, a.nseg - 1, K, V, K,
                      s);
    if (err) return err;
  }
  return launch_phase<T, true, K, V>(a, a.nseg, batch, s);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, void* ws, int batch, int T_len, int H,
           int K, int V, int rows, int seg, void* stream) {
  if (batch <= 0 || T_len <= 0 || H <= 0 || rows <= 0 || rows > kMaxRows
      || seg <= 0 || T_len % (rows * seg))
    return cudaErrorInvalidValue;
  const int nseg = T_len / (rows * seg);
  if (nseg > 1 && ws == nullptr) return cudaErrorInvalidValue;
  Args<T> a{static_cast<const T*>(r), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const float*>(w),
            static_cast<const float*>(u), static_cast<T*>(out),
            static_cast<float*>(ws), nullptr, T_len, H, rows, seg, nseg};
  a.decays = a.states + static_cast<long>(batch) * H * (nseg - 1) * K * V;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instance of the width: K = V, 32, 64 or 128
  switch (K == V ? K : 0) {
    case 32: return launch_widths<T, 32, 32>(a, batch, s);
    case 64: return launch_widths<T, 64, 64>(a, batch, s);
    case 128: return launch_widths<T, 128, 128>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define REPRO_WKV6_ENTRY(SUFFIX, ELEM)                                        \
  extern "C" int wkv6_##SUFFIX(const void* r, const void* k, const void* v,  \
                               const void* w, const void* u, void* out,      \
                               void* ws, int batch, int T, int H, int K,     \
                               int V, int rows, int seg, void* stream) {     \
    return launch<ELEM>(r, k, v, w, u, out, ws, batch, T, H, K, V, rows,     \
                        seg, stream);                                        \
  }

REPRO_WKV6_ENTRY(f32, float)
REPRO_WKV6_ENTRY(bf16, __nv_bfloat16)
#undef REPRO_WKV6_ENTRY
