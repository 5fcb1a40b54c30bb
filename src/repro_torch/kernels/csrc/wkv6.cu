// Chunked RWKV-6 ("Finch") WKV for Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv6_kernel` / `wkv6` of
// src/repro/kernels/rwkv6.py (its pallas_call at line 93).  Same
// function: per batch row b and head h, with log decay w <= 0 and bonus u,
//   o_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t,
//   S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T,   S_0 = 0 (K x V, f32),
// computed chunk by chunk as the TPU kernel does.  With W the inclusive
// cumulative sum of w inside a chunk and W_{t-1} = W_t - w_t:
//   inter-chunk  o_t += (r_t * e^{W_{t-1}}) . S_in
//   intra-chunk  att[t][s] = sum_k r_tk k_sk e^{min(W_{t-1,k} - W_{s,k}, 0)}
//                for s < t, and att[t][t] = r_t . (u * k_t) (the bonus);
//                o_t += sum_s att[t][s] v_s
//   state        S_out = e^{W_last} S_in + (k * e^{W_last - W})^T v.
// Every exponent is <= 0: the factorized e^{-W} form, which overflows, is
// never formed.  Entry points wkv6_f32 and wkv6_bf16: r, k, v and out of
// that type; w and u f32 (the decay path stays f32, as in the model).
//
// Layout: the model layout, read in place: r, k, w (B, T, H, K), v and
// out (B, T, H, V), u (H, K).
//
// Design: one block of 1024 threads per (batch row, head, slice of vb of
// the V state columns); the columns of S evolve independently, so a
// block carries a K x vb slice of the state in shared memory across the
// chunks of its sequence, in a loop (blocks run in no order; the TPU's
// sequential chunk grid axis becomes this loop).  Per chunk it stages r,
// k, w (c x K) and its v columns (c x vb) as f32, scans W and W_{t-1} per
// key column, then computes att entry by entry, summing over K on the fly:
// the TPU kernel's (c, c, K) pair tensor is 1 MiB of f32 at c = K = 64,
// over the 227 KiB a block may hold, while att is c x c.  Then r and k
// are scaled in place by their decays, and out and the new state are
// products over the staged tiles.  Rows of the K-wide tiles are K + 1
// floats apart, so a warp reading one key column of 32 rows hits 32
// banks.  The wrapper picks vb: the most V slices (powers of two, vb >=
// 16) that keep B * H * slices blocks within one wave of the card's SMs
// (at rwkv6-7b's width, B = 1 and H = 64: two slices of 32, 128 blocks
// on 132 SMs, where one slice would leave 68 SMs idle).  Each slice
// recomputes att, which is the price of the second wave of SMs.  With
// one block per SM, 1024 threads (32 warps) hide the latency of the
// shared-memory reads and exponentials that 256 left exposed.
//
// Bound on the card: bytes at these shapes (each input read once, out
// written once: ~100 MB at rwkv6-7b's T = 2048 with bf16 r, k, v and f32
// w, against ~3.2 GFLOP).
// This simple version is bound by its own arithmetic instead: the c^2/2
// * K exponentials of att per chunk and slice, and shared-memory reads
// of f32 FMAs on the CUDA cores.  Tensor-core (mma) tiles for the
// products, att computed once per chunk for all slices, and sub-chunks
// that share one exponential reference (fla's chunk_rwkv6) are the known
// next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_io.cuh"

namespace {

using repro_dense::store1;
using repro_dense::to_f32;

constexpr int kThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, T* __restrict__ out, int T_len, int H,
    int K, int V, int c, int vb) {
  extern __shared__ float smem[];
  const int KP = K + 1;             // row stride of the K-wide tiles
  float* r_s = smem;                // [c][KP] r, then r * e^{W_{t-1}}
  float* k_s = r_s + c * KP;        // [c][KP] k, then k * e^{W_last - W}
  float* wc_s = k_s + c * KP;       // [c][KP] W (inclusive cumsum of w)
  float* wp_s = wc_s + c * KP;      // [c][KP] w, then W_{t-1} = W - w
  float* v_s = wp_s + c * KP;       // [c][vb] the block's v columns
  float* S_s = v_s + c * vb;        // [K][vb] the block's state slice
  float* att_s = S_s + K * vb;      // [c][c]
  float* u_s = att_s + c * c;       // [K]

  const int j0 = blockIdx.x * vb, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long row_k = static_cast<long>(H) * K;   // t stride of r, k, w
  const long row_v = static_cast<long>(H) * V;   // t stride of v, out
  for (int i = tid; i < K * vb; i += kThreads) S_s[i] = 0.f;
  for (int i = tid; i < K; i += kThreads) u_s[i] = u[h * K + i];

  for (int t0 = 0; t0 < T_len; t0 += c) {
    __syncthreads();   // the previous chunk is done with every tile
    const long base_k = (static_cast<long>(b) * T_len + t0) * row_k
                        + static_cast<long>(h) * K;
    const long base_v = (static_cast<long>(b) * T_len + t0) * row_v
                        + static_cast<long>(h) * V + j0;
    for (int i = tid; i < c * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const long g = base_k + t * row_k + kk;
      r_s[t * KP + kk] = to_f32(r[g]);
      k_s[t * KP + kk] = to_f32(k[g]);
      wp_s[t * KP + kk] = w[g];
    }
    for (int i = tid; i < c * vb; i += kThreads) {
      const int t = i / vb, j = i % vb;
      v_s[i] = to_f32(v[base_v + t * row_v + j]);
    }
    __syncthreads();
    // W = cumsum(w) down each key column; W_{t-1} = W - w, as the TPU
    // kernel forms it
    for (int kk = tid; kk < K; kk += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        const float wt = wp_s[t * KP + kk];
        acc += wt;
        wc_s[t * KP + kk] = acc;
        wp_s[t * KP + kk] = acc - wt;
      }
    }
    __syncthreads();
    // att[t][s]: the pairwise decays below the diagonal, the bonus on it
    for (int i = tid; i < c * c; i += kThreads) {
      const int t = i / c, s = i % c;
      const float* rt = r_s + t * KP;
      float a = 0.f;
      if (s < t) {
        const float* wpt = wp_s + t * KP;
        const float* ks = k_s + s * KP;
        const float* wcs = wc_s + s * KP;
        for (int kk = 0; kk < K; ++kk)
          a += rt[kk] * expf(fminf(wpt[kk] - wcs[kk], 0.f)) * ks[kk];
      } else if (s == t) {
        const float* kt = k_s + t * KP;
        for (int kk = 0; kk < K; ++kk) a += rt[kk] * (u_s[kk] * kt[kk]);
      }
      att_s[i] = a;
    }
    __syncthreads();
    // r <- r e^{W_{t-1}} (inter-chunk query), k <- k e^{W_last - W}
    const float* wl = wc_s + (c - 1) * KP;
    for (int i = tid; i < c * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      r_s[t * KP + kk] *= expf(wp_s[t * KP + kk]);
      k_s[t * KP + kk] *= expf(wl[kk] - wc_s[t * KP + kk]);
    }
    __syncthreads();
    // out = (r e^{W_{t-1}}) . S_in + att . v
    for (int i = tid; i < c * vb; i += kThreads) {
      const int t = i / vb, j = i % vb;
      const float* rt = r_s + t * KP;
      float o = 0.f;
      for (int kk = 0; kk < K; ++kk) o += rt[kk] * S_s[kk * vb + j];
      const float* at = att_s + t * c;
      float a = 0.f;
      for (int s = 0; s <= t; ++s) a += at[s] * v_s[s * vb + j];
      store1(out + base_v + t * row_v + j, o + a);
    }
    __syncthreads();   // S_in is read by every output above
    // S_out = e^{W_last} S_in + (k e^{W_last - W})^T v
    for (int i = tid; i < K * vb; i += kThreads) {
      const int kk = i / vb, j = i % vb;
      float acc = 0.f;
      for (int s = 0; s < c; ++s) acc += k_s[s * KP + kk] * v_s[s * vb + j];
      S_s[i] = expf(wl[kk]) * S_s[i] + acc;
    }
  }
}

// Shared memory of one block, in bytes.
inline size_t smem_bytes(int K, int c, int vb) {
  return sizeof(float) * (4 * static_cast<size_t>(c) * (K + 1)
                          + static_cast<size_t>(c) * vb
                          + static_cast<size_t>(K) * vb
                          + static_cast<size_t>(c) * c + K);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, int batch, int T_len, int H, int K,
           int V, int c, int vb, void* stream) {
  if (batch <= 0 || T_len <= 0 || H <= 0 || K <= 0 || c <= 0 || vb <= 0
      || T_len % c || V % vb)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, c, vb);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(V / vb, H, batch);
  wkv6_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(out), T_len, H, K, V, c,
      vb);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_WKV6_ENTRY(SUFFIX, ELEM)                                        \
  extern "C" int wkv6_##SUFFIX(const void* r, const void* k, const void* v,  \
                               const void* w, const void* u, void* out,      \
                               int batch, int T, int H, int K, int V, int c, \
                               int vb, void* stream) {                       \
    return launch<ELEM>(r, k, v, w, u, out, batch, T, H, K, V, c, vb,        \
                        stream);                                             \
  }

REPRO_WKV6_ENTRY(f32, float)
REPRO_WKV6_ENTRY(bf16, __nv_bfloat16)
#undef REPRO_WKV6_ENTRY
