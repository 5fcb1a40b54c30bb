// Chunked Mamba2 SSD for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd` of
// src/repro/kernels/mamba2.py (its pallas_call at line 93).  Same
// function: per batch row b and head h, with one scalar decay per head
// and step,
//   S_t = e^{-A_h dt_t} S_{t-1} + dt_t B_t x_t^T,   S_0 = 0 (N x P, f32),
//   y_t = C_t^T S_t + D_h x_t,
// computed chunk by chunk as the TPU kernel does.  With L the inclusive
// cumulative sum of -A_h dt inside a chunk:
//   inter-chunk  y_t += e^{L_t} (C_t . S_in)
//   intra-chunk  M[t][s] = (C_t . B_s) e^{min(L_t - L_s, 0)} dt_s, s <= t;
//                y_t += sum_s M[t][s] x_s
//   skip         y_t += D_h x_t
//   state        S_out = e^{L_last} S_in
//                        + sum_s B_s (e^{L_last - L_s} dt_s) x_s^T.
// Entry points ssd_f32 and ssd_bf16: x, B, C and y of that type; dt, A and
// D f32 (in the model dt is a softplus in f32 and A, D are f32 params).
//
// Layout: the model layout, read in place: x and y (B, T, H, P), dt
// (B, T, H), B and C (B, T, N) shared by all heads, A and D (H,).
//
// Design: one block of 1024 threads per (batch row, head, slice of pb of
// the P state columns); the columns of S evolve independently, so a
// block carries an N x pb slice of the state in shared memory across the
// chunks of its sequence, in a loop (the TPU's sequential chunk grid
// axis).  Per chunk it stages B and C (c x N), its x columns (c x pb) and
// dt as f32, scans L in one thread (c additions), then fills M (c x c:
// 64 KiB of f32 at c = 128) entry by entry, and computes y and the new
// state as products over the staged tiles.  Rows of B and C are N + 1
// floats apart, so a warp reading one column of 32 rows hits 32 banks.
// The wrapper picks pb as wkv6.cu picks its slice: the most P slices
// (powers of two, pb >= 16) that keep B * H * slices blocks within one
// wave of the card's SMs (two of 32 at zamba2-1.2b's B = 1, H = 64).
// Each slice recomputes C B^T, which every head shares too.  With one
// block per SM, 1024 threads (32 warps) hide the latency of the
// shared-memory reads that fewer would leave exposed.
//
// Bound on the card: bytes at these shapes (x, B, C, dt read once, y
// written once), far below the operations' bound of the three products.
// This simple version is bound by its own f32 FMAs from shared memory on
// the CUDA cores; C B^T once per chunk for all heads, and tensor-core
// (mma) tiles for the three products, are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_io.cuh"

namespace {

using repro_dense::store1;
using repro_dense::to_f32;

constexpr int kThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    T* __restrict__ out, int T_len, int H, int P, int N, int c, int pb) {
  extern __shared__ float smem[];
  const int NP = N + 1;             // row stride of the N-wide tiles
  float* b_s = smem;                // [c][NP] B
  float* c_s = b_s + c * NP;        // [c][NP] C
  float* x_s = c_s + c * NP;        // [c][pb] the block's x columns
  float* S_s = x_s + c * pb;        // [N][pb] the block's state slice
  float* m_s = S_s + N * pb;        // [c][c]  M
  float* l_s = m_s + c * c;         // [c]     L
  float* dt_s = l_s + c;            // [c]     dt
  float* kd_s = dt_s + c;           // [c]     e^{L_last - L} dt

  const int j0 = blockIdx.x * pb, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const float a = A[h], dh = D[h];
  const long row_x = static_cast<long>(H) * P;   // t stride of x, y
  for (int i = tid; i < N * pb; i += kThreads) S_s[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += c) {
    __syncthreads();   // the previous chunk is done with every tile
    const long tb = static_cast<long>(b) * T_len + t0;   // (b, t0) row
    const long base_x = tb * row_x + static_cast<long>(h) * P + j0;
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N, n = i % N;
      b_s[t * NP + n] = to_f32(Bm[(tb + t) * N + n]);
      c_s[t * NP + n] = to_f32(Cm[(tb + t) * N + n]);
    }
    for (int i = tid; i < c * pb; i += kThreads) {
      const int t = i / pb, j = i % pb;
      x_s[i] = to_f32(x[base_x + t * row_x + j]);
    }
    for (int t = tid; t < c; t += kThreads) dt_s[t] = dt[(tb + t) * H + h];
    __syncthreads();
    // L = cumsum(-A dt)
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        acc += -a * dt_s[t];
        l_s[t] = acc;
      }
    }
    __syncthreads();
    const float l_last = l_s[c - 1];
    for (int t = tid; t < c; t += kThreads)
      kd_s[t] = expf(l_last - l_s[t]) * dt_s[t];
    // M[t][s] = (C_t . B_s) e^{min(L_t - L_s, 0)} dt_s on and below the
    // diagonal
    for (int i = tid; i < c * c; i += kThreads) {
      const int t = i / c, s = i % c;
      float m = 0.f;
      if (s <= t) {
        const float* ct = c_s + t * NP;
        const float* bs = b_s + s * NP;
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb += ct[n] * bs[n];
        m = cb * expf(fminf(l_s[t] - l_s[s], 0.f)) * dt_s[s];
      }
      m_s[i] = m;
    }
    __syncthreads();
    // y = e^{L} (C . S_in) + M . x + D x
    for (int i = tid; i < c * pb; i += kThreads) {
      const int t = i / pb, j = i % pb;
      const float* ct = c_s + t * NP;
      float cs = 0.f;
      for (int n = 0; n < N; ++n) cs += ct[n] * S_s[n * pb + j];
      const float* mt = m_s + t * c;
      float mx = 0.f;
      for (int s = 0; s <= t; ++s) mx += mt[s] * x_s[s * pb + j];
      store1(out + base_x + t * row_x + j,
             cs * expf(l_s[t]) + mx + dh * x_s[t * pb + j]);
    }
    __syncthreads();   // S_in is read by every output above
    // S_out = e^{L_last} S_in + sum_s B_s (e^{L_last - L_s} dt_s) x_s^T
    const float decay = expf(l_last);
    for (int i = tid; i < N * pb; i += kThreads) {
      const int n = i / pb, j = i % pb;
      float acc = 0.f;
      for (int s = 0; s < c; ++s)
        acc += b_s[s * NP + n] * kd_s[s] * x_s[s * pb + j];
      S_s[i] = decay * S_s[i] + acc;
    }
  }
}

// Shared memory of one block, in bytes.
inline size_t smem_bytes(int N, int c, int pb) {
  return sizeof(float) * (2 * static_cast<size_t>(c) * (N + 1)
                          + static_cast<size_t>(c) * pb
                          + static_cast<size_t>(N) * pb
                          + static_cast<size_t>(c) * c + 3 * c);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* out, int batch, int T_len,
           int H, int P, int N, int c, int pb, void* stream) {
  if (batch <= 0 || T_len <= 0 || H <= 0 || N <= 0 || c <= 0 || pb <= 0
      || T_len % c || P % pb)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, c, pb);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(P / pb, H, batch);
  ssd_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(out), T_len, H, P, N, c, pb);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_SSD_ENTRY(SUFFIX, ELEM)                                         \
  extern "C" int ssd_##SUFFIX(const void* x, const void* dt, const void* A,  \
                              const void* Bm, const void* Cm, const void* D, \
                              void* out, int batch, int T, int H, int P,     \
                              int N, int c, int pb, void* stream) {          \
    return launch<ELEM>(x, dt, A, Bm, Cm, D, out, batch, T, H, P, N, c, pb,  \
                        stream);                                             \
  }

REPRO_SSD_ENTRY(f32, float)
REPRO_SSD_ENTRY(bf16, __nv_bfloat16)
#undef REPRO_SSD_ENTRY
