// AMU matmul for Hopper (sm_90a), bf16: the paper's aload / SPM / getfin
// model in the card's own hardware.  TMA is the aload, a ring of stages in
// shared memory is the SPM, the mbarrier wait is the getfin, and the
// products run on the tensor cores (wgmma).
//
// Replaces the TPU kernel `_amu_matmul_kernel` / `amu_matmul` of
// src/repro/kernels/amu_matmul.py (its pallas_call at line 117) for bf16
// operands.  Same function: out = x @ w for x (M, K) and w (K, N), both
// row-major bf16 in device memory, products summed in f32, out bf16
// (round to nearest even).  Entry point amu_matmul_bf16; the f32 instance
// keeps amu_matmul.cu (wgmma has no full-f32 mode, only TF32).
//
// Line by line against _amu_matmul_kernel:
//
//   x_hbm / w_hbm in ANY (stay in HBM)  -> two CUtensorMaps (encoded by the
//                                          host, 128-byte swizzle, passed
//                                          as __grid_constant__): the block
//                                          reads x and w only through TMA
//   xb (2, bm, bk), wb (2, bk, bn)      -> a ring of S stages in dynamic
//     (the SPM: two slots per operand)     shared memory, each an x tile
//                                          (BM x 64, K-major) and a w tile
//                                          (64 x BN as BN / 64 boxes of
//                                          64 x 64, N-major); S = 4..8,
//                                          as deep as 227 KB holds
//   sem_x / sem_w, one per slot         -> full[s]: an mbarrier per stage,
//                                          armed with expect_tx for the
//                                          stage's bytes (whole boxes,
//                                          out-of-bounds zeros included)
//   issue(k, slot): make_async_copy     -> the producer warp's one thread:
//     (...).start() for x and w            arrive.expect_tx on full[s],
//                                          then cp.async.bulk.tensor of the
//                                          x box and the BN / 64 w boxes
//   issue(0, 0); issue(1, 1)            -> the producer runs ahead by up to
//                                          S stages (not 2)
//   acc[...] = zeros                    -> each consumer warpgroup's 64 x BN
//                                          f32 accumulator in registers
//   wait(k, slot): copy.wait()          -> mbarrier.try_wait.parity on
//     (getfin)                             full[s], parity (k / S) & 1
//   acc += dot(xb[slot], wb[slot])      -> four wgmma m64nBNk16 (bf16 in,
//                                          f32 accumulate) from the stage,
//                                          one commit group per stage
//   when k + 2 < n_k: issue(k + 2,slot) -> the freed slot: after
//     (the consumed slot refills)          wgmma.wait_group 1 has retired
//                                          stage k - 1's products, each
//                                          consumer warp arrives on
//                                          empty[(k - 1) % S]; the producer
//                                          waits on empty[s] before it
//                                          reloads stage s (tile k + S - 1
//                                          goes into the slot tile k - 1
//                                          freed)
//   o_ref = acc.astype(o_ref.dtype)     -> bf16x2 stores from the
//                                          accumulator fragment, masked at
//                                          the M and N edges
//
// Tiles are the card's, not the TPU's.  A block computes a BM x BN output
// tile, BM = 64 per consumer warpgroup (one or two), BN in {64, 128, 192,
// 256} (whole 64-column swizzle atoms of w), and the wrapper picks (BM,
// BN) so the grid fills the 132 SMs in as few waves as it can
// (amu_matmul.sm90_tiles): at phi4-mini's MLP products, 512 x 8192 in
// 128 x 256 tiles and 512 x 3072 in 64 x 192, 128 blocks each.  Blocks
// that share a w column tile have neighbouring indices.  The reference's
// (bm, bk, bn) are validated by the wrapper and change no bit: every
// output element sums its K products in the same fixed order whatever
// they are, and there is no split-K, so two calls give the same bits.
// Ragged M, N and K come from TMA's zero fill past the tensor's edge and
// the masked store; TMA needs 16-byte aligned bases and row strides (K
// and N multiples of 8), which the wrapper checks.
//
// Bound on the card: operations, 2 M K N at 989 TFLOP/s (bf16 dense), at
// the main path's shapes (0.0261 ms at 512 x 3072 x 8192; its 53 MB of
// operands take 0.016 ms at 3.35 TB/s).  The design keeps the tensor cores
// fed: one thread issues all loads, S stages stay in flight, the
// consumers wait only on data, and with two consumer warpgroups
// setmaxnreg moves registers from the producer (40) to the consumers'
// 64 x 256 accumulators (232).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using namespace repro_sm90;

constexpr int kBK = 64;                // K of a stage: one 128-byte row
constexpr int kAtom = 64;              // N of one w box (128 bytes)
constexpr int kBoxBytes = kBK * kAtom * 2;
constexpr int kSmemOptin = 232448;     // H100: opt-in shared memory a block
constexpr int kAlign = 1024;           // 128-byte swizzle atom of 8 rows
constexpr int kMaxStages = 8;

template <int BN, int NC>
struct Tile {
  static constexpr int BM = 64 * NC;
  static constexpr int kThreads = 128 * (NC + 1);   // + producer warpgroup
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBK * BN * 2;
  // stages and their two barriers, plus the slack to align the ring
  static constexpr int kStages =
      (kSmemOptin - kAlign) / (kStageBytes + 16) < kMaxStages
          ? (kSmemOptin - kAlign) / (kStageBytes + 16)
          : kMaxStages;
  static constexpr int kSmem = kAlign + kStages * (kStageBytes + 16);
  static_assert(BN % kAtom == 0 && BN <= 256, "BN: whole atoms, <= 256");
  static_assert(kStages >= 2, "the ring needs two stages");
};

template <int BN, int NC>
__global__ void __launch_bounds__(Tile<BN, NC>::kThreads, 1)
    amu_matmul_sm90_kernel(__grid_constant__ const CUtensorMap x_map,
                           __grid_constant__ const CUtensorMap w_map,
                           __nv_bfloat16* __restrict__ out, int M, int K,
                           int N, int m_tiles) {
  using T = Tile<BN, NC>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1)
      & ~static_cast<uintptr_t>(kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * T::kStageBytes);
  uint64_t* empty = full + S;

  // blocks that share a w column tile are neighbours
  const int m0 = (blockIdx.x % m_tiles) * T::BM;
  const int n0 = (blockIdx.x / m_tiles) * BN;
  const int n_k = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);    // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // producer warpgroup: one thread issues every aload
    if constexpr (NC > 1) setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * NC) {
      tma_prefetch(&x_map);
      tma_prefetch(&w_map);
      for (int k = 0; k < n_k; ++k) {
        const int s = k % S;
        mbar_wait(&empty[s], ((k / S) & 1) ^ 1);   // the slot is free
        unsigned char* a = ring + s * T::kStageBytes;
        unsigned char* b = a + T::kABytes;
        mbar_arrive_expect_tx(&full[s], T::kStageBytes);
        tma_load_2d(a, &x_map, &full[s], k * kBK, m0);
#pragma unroll
        for (int j = 0; j < BN / kAtom; ++j)
          tma_load_2d(b + j * kBoxBytes, &w_map, &full[s], n0 + j * kAtom,
                      k * kBK);
      }
    }
  } else {
    // consumer warpgroup wg: rows m0 + 64 wg .. + 63 of the tile
    if constexpr (NC > 1) setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;

    for (int k = 0; k < n_k; ++k) {
      const int s = k % S;
      mbar_wait(&full[s], (k / S) & 1);            // getfin
      const uint32_t a = smem_u32(ring + s * T::kStageBytes) + wg * 64 * 128;
      const uint32_t b = smem_u32(ring + s * T::kStageBytes + T::kABytes);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        // x: 16 columns are 32 bytes along the swizzled row; w: 16 rows
        // are two 8-row groups of 1024 bytes
        wgmma_tn(acc, sw128_desc(a + kk * 32, 16, 1024),
                 sw128_desc(b + kk * 2048, kBoxBytes, 1024), 1);
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();                             // stage k - 1 retired
      if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int row0 = m0 + 64 * wg + 16 * warp + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;       // even, and N % 8 == 0
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long>(row) * N + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// The map of a row-major bf16 (rows, cols) matrix read in boxes of
// box_rows x 64 columns (128 bytes, the swizzle's span).
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return encode_bf16(map, base, 2, dims, strides, box);
}

template <int BN, int NC>
int launch(const void* x, const void* w, void* out, int M, int K, int N,
           int stages, cudaStream_t stream) {
  using T = Tile<BN, NC>;
  if (stages != T::kStages) return cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  if (!encode(&x_map, x, M, K, T::BM) || !encode(&w_map, w, K, N, kBK))
    return cudaErrorInvalidValue;
  auto kernel = amu_matmul_sm90_kernel<BN, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + T::BM - 1) / T::BM;
  const int n_tiles = (N + BN - 1) / BN;
  kernel<<<m_tiles * n_tiles, T::kThreads, T::kSmem, stream>>>(
      x_map, w_map, static_cast<__nv_bfloat16*>(out), M, K, N, m_tiles);
  return cudaGetLastError();
}

template <int NC>
int launch_bn(const void* x, const void* w, void* out, int M, int K, int N,
              int bn, int stages, cudaStream_t stream) {
  switch (bn) {
    case 64: return launch<64, NC>(x, w, out, M, K, N, stages, stream);
    case 128: return launch<128, NC>(x, w, out, M, K, N, stages, stream);
    case 192: return launch<192, NC>(x, w, out, M, K, N, stages, stream);
    case 256: return launch<256, NC>(x, w, out, M, K, N, stages, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) @ w (K, N) -> out (M, N), bf16, on `stream`; (bm, bn, stages)
// as amu_matmul.sm90_tiles picks them.  Returns a cudaError_t.
extern "C" int amu_matmul_bf16(const void* x, const void* w, void* out,
                               int M, int K, int N, int bm, int bn,
                               int stages, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64) return launch_bn<1>(x, w, out, M, K, N, bn, stages, s);
  if (bm == 128) return launch_bn<2>(x, w, out, M, K, N, bn, stages, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
