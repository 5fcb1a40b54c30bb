// AMU matmul for Hopper (sm_90a), f32: the paper's programming model
// inside one CUDA kernel.  (The bf16 instance is amu_matmul_sm90.cu.)
//
// Replaces the TPU kernel `_amu_matmul_kernel` / `amu_matmul` of
// src/repro/kernels/amu_matmul.py (its pallas_call at line 117).  Same
// function: out = x @ w for x (M, K) and w (K, N) in device memory, f32
// accumulation, out in x's dtype; one block per (bm, bn) output tile,
// grid (N / bn, M / bm), the K loop inside the block.  Entry point
// amu_matmul_f32 (x, w and out f32; the template also reads bf16).
//
// The AMU structure stays explicit, as on the TPU, not left to a
// compiler's pipelining.  Line by line against _amu_matmul_kernel:
//
//   x_hbm / w_hbm in ANY (stay in HBM)  -> x, w: plain device pointers;
//                                          the block reads them only
//                                          through aload
//   xb (2, bm, bk), wb (2, bk, bn)      -> xb [2][bm][bks], wb [2][bks][bn]
//     (the SPM: two slots per operand)     in dynamic shared memory
//   sem_x / sem_w, one per slot         -> the cp.async group of each
//                                          aload (one commit per tile)
//   issue(k, slot): make_async_copy     -> aload(k, slot): the tile's
//     (...).start() for x and w            16-byte pieces by
//                                          cp.async.cg.shared.global,
//                                          then cp.async.commit_group
//   issue(0, 0); when n_k > 1: issue(1) -> aload(0, 0); aload(1, 1) if
//                                          there is a tile 1 (else an
//                                          empty group, so every wait
//                                          below is wait_group 1)
//   acc[...] = zeros                    -> acc[8][8] f32 per thread, in
//                                          registers
//   wait(k, slot): copy.wait()          -> getfin: cp.async.wait_group 1
//     (getfin)                             (all groups but the newest
//                                          have landed: tile k has)
//                                          + __syncthreads() (every
//                                          thread's pieces of it)
//   acc += dot(xb[slot], wb[slot])      -> the block's 8x8-per-thread
//                                          f32 FMA loop over the slot
//   when k + 2 < n_k: issue(k + 2,slot) -> __syncthreads() (the slot is
//     (the consumed slot refills)          consumed by all), then
//                                          aload(k + 2, slot)
//   o_ref = acc.astype(o_ref.dtype)     -> store8 of each thread's 8x8
//
// Shared memory: two slots of (bm + bn) * bk elements at f32 and
// bm = bk = bn = 128 are 256 KiB, over the 227 KiB a block may have.
// So the wrapper may split each bk step into bk / bks sub-steps of bks
// columns (the largest divisor of bk whose ring fits); the ring stays two
// slots deep and tile s + 2 is issued as tile s is consumed, with s
// running over the sub-steps.  Each output element still sums its K
// products in order, one f32 FMA each.
//
// Bound on the card: operations, 2 * M * K * N, at the CUDA cores' f32
// rate (67 TFLOP/s; TF32 on the tensor cores would miss the reference's
// 5e-6 bar).  Each thread sums an 8 x 8 output tile with one f32 FMA per
// product; a redesign for speed (larger register tiles, TMA copies into
// a deeper ring) is queued in ROADMAP.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_io.cuh"

namespace {

using repro_dense::load8;
using repro_dense::store8;
using repro_dense::to_f32;

constexpr int kMaxThreads = 256;
constexpr int kTM = 8;   // output rows per thread
constexpr int kTN = 8;   // output columns per thread

// One 16-byte piece, global -> shared, through L2 only.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) amu_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int K, int N, int bm, int bn, int bks, int n_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPiece = 16 / sizeof(T);          // elements per cp.async
  const int x_tile = bm * bks, w_tile = bks * bn;  // elements per slot
  T* xb = reinterpret_cast<T*>(smem);              // [2][bm][bks]
  T* wb = xb + 2 * x_tile;                         // [2][bks][bn]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tx = tid % (bn / kTN), ty = tid / (bn / kTN);
  const T* x_blk = x + static_cast<long>(blockIdx.y) * bm * K;
  const T* w_blk = w + static_cast<long>(blockIdx.x) * bn;

  // aload: start tile s's copies into `slot` and commit them as a group
  auto aload = [&](int s, int slot) {
    T* xs = xb + slot * x_tile;
    T* ws = wb + slot * w_tile;
    const int k0 = s * bks;
    const int x_pieces = bks / kPiece, w_pieces = bn / kPiece;
    for (int p = tid; p < bm * x_pieces; p += nthreads) {
      const int r = p / x_pieces, c = (p % x_pieces) * kPiece;
      cp_async16(xs + r * bks + c, x_blk + static_cast<long>(r) * K + k0 + c);
    }
    for (int p = tid; p < bks * w_pieces; p += nthreads) {
      const int r = p / w_pieces, c = (p % w_pieces) * kPiece;
      cp_async16(ws + r * bn + c, w_blk + static_cast<long>(k0 + r) * N + c);
    }
  };

  // fill the pipeline: tiles 0 and 1 in flight
  aload(0, 0);
  cp_async_commit();
  if (n_steps > 1) aload(1, 1);
  cp_async_commit();

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    const int slot = s & 1;
    // getfin: tile s has landed in the slot, every thread's pieces of it
    cp_async_wait_1();
    __syncthreads();
    const T* xs = xb + slot * x_tile + ty * kTM * bks;
    const T* ws = wb + slot * w_tile + tx * kTN;
    for (int kk = 0; kk < bks; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int r = 0; r < kTM; ++r) a[r] = to_f32(xs[r * bks + kk]);
      load8(ws + kk * bn, b);
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    // the slot is consumed: keep the pipeline full with tile s + 2
    __syncthreads();
    if (s + 2 < n_steps) aload(s + 2, slot);
    cp_async_commit();
  }

  T* o = out + (static_cast<long>(blockIdx.y) * bm + ty * kTM) * N
         + static_cast<long>(blockIdx.x) * bn + tx * kTN;
#pragma unroll
  for (int r = 0; r < kTM; ++r) store8(o + static_cast<long>(r) * N, acc[r]);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int M, int K, int N,
           int bm, int bn, int bks, void* stream) {
  if (bm <= 0 || bn <= 0 || bks <= 0 || M % bm || N % bn || K % bks)
    return cudaErrorInvalidValue;
  if (bm % kTM || bn % kTN || (bks * sizeof(T)) % 16)
    return cudaErrorInvalidValue;
  const int threads = (bm / kTM) * (bn / kTN);
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem =
      2 * (static_cast<size_t>(bm) * bks + static_cast<size_t>(bks) * bn)
      * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      amu_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(N / bn, M / bm);
  amu_matmul_kernel<T><<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      K, N, bm, bn, bks, K / bks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int amu_matmul_f32(const void* x, const void* w, void* out, int M,
                              int K, int N, int bm, int bn, int bks,
                              void* stream) {
  return launch<float>(x, w, out, M, K, N, bm, bn, bks, stream);
}
