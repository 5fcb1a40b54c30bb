// AMU matmul for Hopper (sm_90a), f32: the paper's programming model
// inside one CUDA kernel.  (The bf16 instance is amu_matmul_sm90.cu.)
//
// Replaces the TPU kernel `_amu_matmul_kernel` / `amu_matmul` of
// src/repro/kernels/amu_matmul.py (its pallas_call at line 117).  Same
// function: out = x @ w for x (M, K) and w (K, N) f32 in device memory,
// f32 accumulation; one block per (BM, BN) output tile, the K loop inside
// the block.  Entry point amu_matmul_f32.
//
// Arithmetic: each output element sums its K products one fmaf at a time,
// in ascending k, from 0.0f, whatever the tile, so the result does not
// depend on the tile (nor on the reference's tiles, which the wrapper
// validates and then replaces by the card's, amu_matmul.f32_tiles).
//
// The AMU structure stays explicit, as on the TPU, not left to a
// compiler's pipelining.  Line by line against _amu_matmul_kernel:
//
//   x_hbm / w_hbm in ANY (stay in HBM)  -> x, w: plain device pointers;
//                                          the block reads them only
//                                          through aload
//   xb (2, bm, bk), wb (2, bk, bn)      -> xs [S][BK][BM + 4] (k-major),
//     (the SPM: two slots per operand)     ws [S][BK][BN], a ring of
//                                          S = 4 stages in dynamic
//                                          shared memory
//   sem_x / sem_w, one per slot         -> the cp.async group of each
//                                          aload (one commit per stage)
//   issue(k, slot): make_async_copy     -> aload(t, slot): x's elements
//     (...).start() for x and w            by 4-byte cp.async.ca, each
//                                          to its transposed place; w's
//                                          16-byte pieces by
//                                          cp.async.cg; past M, N or K
//                                          the copy reads nothing and
//                                          writes zeros
//   issue(0, 0); when n_k > 1: issue(1) -> aload(0 .. S - 2), one group
//                                          each (empty past n_k)
//   acc[...] = zeros                    -> acc[TM][TN] f32 per thread,
//                                          in registers
//   wait(k, slot): copy.wait()          -> getfin: cp.async.wait_group
//     (getfin)                             S - 2 (all but the newest
//                                          S - 2 groups have landed:
//                                          stage t has) + __syncthreads
//                                          (every thread's pieces of it;
//                                          and every thread is done with
//                                          stage t - 1)
//   when k + 2 < n_k: issue(k + 2,slot) -> aload(t + S - 1) into the slot
//     (the consumed slot refills)          stage t - 1 has freed
//   acc += dot(xb[slot], wb[slot])      -> the thread's TM x TN outer
//                                          products over the stage's BK
//                                          columns, fmaf on the CUDA
//                                          cores
//   o_ref = acc.astype(o_ref.dtype)     -> 16-byte stores of the rows and
//                                          columns inside (M, N)
//
// Two instances (instance() below): 128 x 128 blocks of 256 threads of
// 8 x 8 outputs and 16 K columns a stage, and 64 x 64 blocks of 128
// threads of 8 x 4 outputs and 32 K columns a stage; f32_tiles picks the
// one that leaves the busiest of the 132 SMs the fewest outputs.  The
// 64 x 64 block gives a 1024^2 output two warps a scheduler where 8 x 8
// gave one; the deeper stage halves its barriers.
//
// Inner loop: thread (tx, ty) owns rows ty*4 + {0..3} (and for TM 8
// BM/2 + ty*4 + {0..3}), columns tx*4 + {0..3} (and for TN 8 BN/2 +
// tx*4 + {0..3}).  Per k it reads its x values as 16-byte loads from the
// k-major x tile (threads of one ty share them: a broadcast) and its w
// values as 16-byte loads of contiguous bytes, then issues TM * TN fmaf;
// the loads of k + 1 go out before k's fmaf, into a second set of
// fragment registers.  x's row pitch BM + 4 keeps the transposing 4-byte
// copies conflict-free: a warp copies 8 k by 4 rows, banks 4k + r.  Each
// copy's source, destination and row or column mask are set once before
// the K loop, so a stage's copies cost a pointer add and a select each
// (chip_smoke.py phase 1 prints the SASS's fmaf and integer counts).
//
// Bound on the card: operations, 2 * M * K * N, at the CUDA cores' f32
// rate (67 TFLOP/s; TF32 on the tensor cores would miss the reference's
// 5e-6 bar).

#include <cuda_runtime.h>

#include <type_traits>

#include "dense_io.cuh"

namespace {

constexpr int kXPad = 4;      // x tile row pitch BM + 4 (floats)
constexpr int kStages = 4;    // ring stages (S)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One 4-byte element, global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(live ? 4 : 0));
}

// One 16-byte piece, global -> shared, through L2 only; zeros if !live.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Threads of a (BM, BN) block whose threads own TM x TN outputs each.
template <int BM, int BN, int TM, int TN>
__host__ __device__ constexpr int threads_of() {
  return (BM / TM) * (BN / TN);
}

// The ring of stages of BK columns of x (k-major, padded) and BK rows of w.
template <int BM, int BN, int BK>
constexpr size_t smem_of() {
  return static_cast<size_t>(kStages) * BK * ((BM + kXPad) + BN) *
         sizeof(float);
}

// No cap on registers below 255 (chip_smoke.py's phase 1 prints the
// counts and requires no spill).
template <int BM, int BN, int TM, int TN, int BK>
__global__ void __launch_bounds__(threads_of<BM, BN, TM, TN>())
    amu_matmul_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, int M, int K, int N) {
  constexpr int kThreads = threads_of<BM, BN, TM, TN>();
  constexpr int kXStage = BK * (BM + kXPad);   // floats per x stage
  constexpr int kWStage = BK * BN;             // floats per w stage
  // x: a thread copies k columns (tid & 7) + 8 h of rows (tid >> 3) +
  // kXRows j, so a warp copies 8 consecutive k of 4 rows: 32-byte runs
  // of global memory, banks 4k + r of the k-major tile
  constexpr int kXRows = kThreads / 8;
  constexpr int kXPasses = BM / kXRows;
  // w: a thread copies the 16-byte piece at column (tid % (BN / 4)) * 4
  // of rows tid / (BN / 4) + kWRows i
  constexpr int kWRows = kThreads / (BN / 4);
  constexpr int kWPasses = BK / kWRows;
  static_assert(BM % kXRows == 0 && BK % 8 == 0 && BK % kWRows == 0,
                "copies per thread");
  static_assert((TM == 4 || TM == 8) && (TN == 4 || TN == 8),
                "4 or 8 rows and columns a thread");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // [S][BK][BM + kXPad]
  float* ws = smem + kStages * kXStage;   // [S][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;

  // Each thread's copies are fixed but for the stage's k0, so their
  // sources, destinations and row / column masks are set once here; a
  // stage then costs a pointer add and a select per copy.
  const int xr = tid >> 3, xc = tid & 7;
  const float* x_src = x + static_cast<long>(m0 + xr) * K + xc;
  const long x_step = static_cast<long>(kXRows) * K;
  unsigned x_rows = 0;   // bit j: row m0 + xr + kXRows j is inside M
#pragma unroll
  for (int j = 0; j < kXPasses; ++j)
    if (m0 + xr + kXRows * j < M) x_rows |= 1u << j;
  float* x_dst = xs + xc * (BM + kXPad) + xr;
  const int wr = tid / (BN / 4), wc = (tid % (BN / 4)) * 4;
  const bool w_col = n0 + wc < N;
  const float* w_src = w + static_cast<long>(wr) * N + n0 + wc;
  const long w_step = static_cast<long>(kWRows) * N;
  float* w_dst = ws + wr * BN + wc;

  // aload: start stage t's copies into `slot`; `whole`: no column of the
  // stage lies past K (every stage but a ragged last one)
  auto aload = [&](int t, int slot, auto whole) {
    const int k0 = t * BK;
    const float* xp = x_src + k0;
    const float* wp = w_src + static_cast<long>(k0) * N;
    float* xd = x_dst + slot * kXStage;
    float* wd = w_dst + slot * kWStage;
#pragma unroll
    for (int h = 0; h < BK / 8; ++h) {
      bool k_live = true;
      if constexpr (!decltype(whole)::value) k_live = k0 + xc + 8 * h < K;
      const float* p = xp + 8 * h;
#pragma unroll
      for (int j = 0; j < kXPasses; ++j, p += x_step) {
        const bool live = k_live && (x_rows >> j & 1u);
        cp_async4(xd + h * 8 * (BM + kXPad) + j * kXRows, live ? p : x,
                  live);
      }
    }
    const float* p = wp;
#pragma unroll
    for (int i = 0; i < kWPasses; ++i, p += w_step) {
      bool live = w_col;
      if constexpr (!decltype(whole)::value)
        live = live && k0 + wr + kWRows * i < K;
      cp_async16(wd + i * kWRows * BN, live ? p : w, live);
    }
  };
  auto aload_stage = [&](int t, int slot) {
    if ((t + 1) * BK <= K)
      aload(t, slot, std::true_type{});
    else
      aload(t, slot, std::false_type{});
  };

  // fill the ring: stages 0 .. S - 2 in flight, one group each
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_k) aload_stage(t, t);
    cp_async_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  // the TM x values (rows ty*4.., and for TM 8 BM/2 + ty*4..) and TN w
  // values (columns tx*4.., and for TN 8 BN/2 + tx*4..) of column kk of a
  // stage
  auto frag = [&](const float* xk, const float* wk, int kk, float (&a)[TM],
                  float (&b)[TN]) {
    const float* xq = xk + kk * (BM + kXPad);
    const float* wq = wk + kk * BN;
    const float4 a0 = *reinterpret_cast<const float4*>(xq + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(wq + tx * 4);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    if constexpr (TM == 8) {
      const float4 a1 =
          *reinterpret_cast<const float4*>(xq + BM / 2 + ty * 4);
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    }
    if constexpr (TN == 8) {
      const float4 b1 =
          *reinterpret_cast<const float4*>(wq + BN / 2 + tx * 4);
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    }
  };
  auto outer = [&](const float (&a)[TM], const float (&b)[TN]) {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  };

  for (int t = 0; t < n_k; ++t) {
    const int slot = t % kStages;
    // getfin: stage t has landed, every thread's pieces of it
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the slot of stage t - 1 is free: keep S - 1 stages in flight
    const int nt = t + kStages - 1;
    if (nt < n_k) aload_stage(nt, nt % kStages);
    cp_async_commit();
    const float* xk = xs + slot * kXStage;
    const float* wk = ws + slot * kWStage;
    const int live_k = K - t * BK;
    float a[2][TM], b[2][TN];
    if (live_k >= BK) {   // column kk + 1's fragments load under kk's fmaf
      frag(xk, wk, 0, a[0], b[0]);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        if (kk + 1 < BK)
          frag(xk, wk, kk + 1, a[(kk + 1) & 1], b[(kk + 1) & 1]);
        outer(a[kk & 1], b[kk & 1]);
      }
    } else {   // the last, partial stage: no product past K is added
      for (int kk = 0; kk < live_k; ++kk) {
        frag(xk, wk, kk, a[0], b[0]);
        outer(a[0], b[0]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + (r < 4 ? ty * 4 + r : BM / 2 + ty * 4 + r - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      if (n < N)
        *reinterpret_cast<float4*>(out + static_cast<long>(m) * N + n) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
    }
  }
}

using KernelFn = void (*)(const float*, const float*, float*, int, int, int);

// The (BM, BN) instance, its shared memory opted in to.
template <int BM, int BN, int TM, int TN, int BK>
cudaError_t prepare(KernelFn* kernel, size_t* smem, int* threads) {
  *kernel = amu_matmul_kernel<BM, BN, TM, TN, BK>;
  *smem = smem_of<BM, BN, BK>();
  *threads = threads_of<BM, BN, TM, TN>();
  return cudaFuncSetAttribute(*kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// The instance of a tile of amu_matmul.F32_TILES, and its threads.
cudaError_t instance(int bm, int bn, KernelFn* kernel, size_t* smem,
                     int* threads) {
  if (bm == 128 && bn == 128)
    return prepare<128, 128, 8, 8, 16>(kernel, smem, threads);
  if (bm == 64 && bn == 64)
    return prepare<64, 64, 8, 4, 32>(kernel, smem, threads);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, K), w (K, N), out (M, N), f32, row-major; (bm, bn) one of
// (128, 128), (64, 64) (amu_matmul.F32_TILES); `stages` 4, the
// ring's depth, which it only checks; N a multiple of 4 (16-byte rows of
// w and out), bases 16-byte aligned.
extern "C" int amu_matmul_f32(const void* x, const void* w, void* out, int M,
                              int K, int N, int bm, int bn, int stages,
                              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 4 || stages != kStages)
    return cudaErrorInvalidValue;
  KernelFn kernel;
  size_t smem;
  int threads;
  cudaError_t err = instance(bm, bn, &kernel, &smem, &threads);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), M, K, N);
  return cudaGetLastError();
}

// *blocks: how many blocks of the (bm, bn) instance one SM of the current
// device holds at once, by its registers, threads and shared memory
// (tools/f32_tile_sweep.py prints it beside each tile's time).
extern "C" int amu_matmul_f32_resident(int bm, int bn, int* blocks) {
  KernelFn kernel;
  size_t smem;
  int threads;
  cudaError_t err = instance(bm, bn, &kernel, &smem, &threads);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, smem);
}
