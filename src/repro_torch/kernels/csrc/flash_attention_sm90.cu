// Dense flash attention for Hopper (sm_90a), bf16: TMA loads into a ring
// of stages on mbarriers, one producer thread, and the products on the
// tensor cores (wgmma), the online softmax in f32 registers.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (its pallas_call at line 114) for
// bf16 operands; the f32 instance keeps flash_attention.cu (wgmma's only
// f32 mode is TF32).  Same function: for batch row b, query t at absolute
// position q_offset + t and query head h, softmax(q . K^T / sqrt(D)) . V
// over the KV positions p < kv_valid of KV head h / G that the mask lets
// through — p <= q_pos when causal, p > q_pos - window when window > 0 —
// with an f32 online softmax and a bf16 output.  Entry point
// flash_attention_bf16, with flash_attention.cu's arguments; head dims 16,
// 32, 64, 80 and 128, any G.  A query that sees no key at all (kv_valid
// or a window that leaves it nothing) is don't-care, as in the reference.
//
// Against _flash_kernel:
//
//   q / k / v BlockSpecs in the model    -> three CUtensorMaps over the
//     layout (B, S, H, D), no transposes    model layout in place, 4-D:
//                                           q (D, H, Sq, B), k and v
//                                           (D, Hkv, kv_valid, B); boxes
//                                           of 64 columns (128 bytes,
//                                           128-byte swizzle) x 1 head x
//                                           64 rows; positions at or past
//                                           kv_valid and rows past Sq
//                                           arrive as zeros
//   grid (B, H, Sq / bq, Skv / bkv),     -> grid (Sq / 128, H, B): a block
//     the KV axis sequential                walks its KV tiles in a loop
//                                           (flash_sm90.cuh), the heaviest
//                                           causal q tiles first
//   m / l / acc scratch in VMEM          -> f32 registers of the consumer
//                                           warpgroups
//   pl.when(block live) (lines 51-58)    -> the block's tile range: from
//                                           the window's first tile (or
//                                           0) to the last position its
//                                           queries may see
//   s = where(mask, s, -1e30)            -> the same finite -1e30, on the
//                                           accumulator elements at each
//                                           thread's (row, column), skipped
//                                           for tiles every row sees whole
//   o = acc / l                          -> bf16x2 stores of the columns
//                                           below D, rows below Sq
//
// Bound on the card: operations.  A causal prompt of S = 2048 does
// ~4 * S^2 / 2 * D flops per head against ~4 * S * D bytes of q, K, V and
// out per head: far above the ~295 flop/byte bf16 ridge.  The design
// keeps the tensor cores fed: one thread issues every load, four stages
// stay in flight, the two consumer warpgroups overlap one's softmax with
// the other's products, and setmaxnreg moves registers from the
// producer (40) to the consumers (232).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"

namespace {

using namespace repro_flash;

struct DenseMask {
  int kv_valid, causal, window, first_q, last_q;

  __device__ bool interior(int k0) const {
    return k0 + kBlockKV <= kv_valid
           && (!causal || k0 + kBlockKV - 1 <= first_q)
           && (window <= 0 || k0 > last_q - window);
  }
  __device__ bool visible(int p, int q) const {
    return p < kv_valid && (!causal || p <= q)
           && (window <= 0 || p > q - window);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_sm90_kernel(
    __grid_constant__ const CUtensorMap q_map,
    __grid_constant__ const CUtensorMap k_map,
    __grid_constant__ const CUtensorMap v_map,
    __nv_bfloat16* __restrict__ out, int Sq, int num_heads, int num_kv_heads,
    int causal, int window, int q_offset, int kv_valid, float scale_log2) {
  using P = Plan<D>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (num_heads / num_kv_heads);
  const int t0 = qt * kBlockQ;
  const int first_q = q_offset + t0;
  const int last_q = q_offset + min(t0 + kBlockQ, Sq) - 1;
  const int hi = causal ? min(kv_valid, last_q + 1) : kv_valid;
  const int lo = window_start(first_q, window);
  const int n_tiles = tile_count(lo, hi);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (wg == kConsumers) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * kConsumers) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      mbar_arrive_expect_tx(sm.qbar, P::kQBytes);
#pragma unroll
      for (int a = 0; a < P::kAtoms; ++a)
#pragma unroll
        for (int w = 0; w < kConsumers; ++w)
          tma_load_4d(sm.q + (a * kBlockQ + 64 * w) * kRowBytes, &q_map,
                      sm.qbar, a * kAtom, h, t0 + 64 * w, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int k0 = lo + it * kBlockKV;
        mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[st], P::kStageBytes);
#pragma unroll
        for (int a = 0; a < P::kAtoms; ++a) {
          tma_load_4d(sm.k(st) + a * kBlockKV * kRowBytes, &k_map,
                      &sm.full[st], a * kAtom, kvh, k0, b);
          tma_load_4d(sm.v(st) + a * kBlockKV * kRowBytes, &v_map,
                      &sm.full[st], a * kAtom, kvh, k0, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int q_pos[2] = {first_q + thread_row(wg, 0),
                          first_q + thread_row(wg, 1)};
    const DenseMask mask{kv_valid, causal, window, first_q, last_q};
    float o[P::kDPad / 2], l[2];
    consume<D>(sm, wg, lo, n_tiles, scale_log2, q_pos, mask, o, l);
    const long row_stride = static_cast<long>(num_heads) * D;
    store_rows<D>(out + (static_cast<long>(b) * Sq + t0) * row_stride
                      + static_cast<long>(h) * D,
                  row_stride, wg, min(kBlockQ, Sq - t0), o, l);
  }
}

// q / out (B, Sq, H, D) or k / v (B, S, Hkv, D) read as (D, heads, rows,
// B), rows cut to `rows` of the S allocated, in boxes of 64 columns x 1
// head x `box_rows` rows.
bool encode_4d(CUtensorMap* map, const void* base, int batch, int S,
               int rows, int heads, int D, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row,
                                 row * S};
  const cuuint32_t box[4] = {kAtom, 1, static_cast<cuuint32_t>(box_rows), 1};
  return encode_bf16(map, base, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int Sq, int Skv, int num_heads, int num_kv_heads, int causal,
           int window, int q_offset, int kv_valid, float scale,
           cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  // kv_valid = 0 leaves no tile; the maps still need one row
  const int kv_rows = max(1, kv_valid);
  if (!encode_4d(&q_map, q, batch, Sq, Sq, num_heads, D, 64)
      || !encode_4d(&k_map, k, batch, Skv, kv_rows, num_kv_heads, D,
                    kBlockKV)
      || !encode_4d(&v_map, v, batch, Skv, kv_rows, num_kv_heads, D,
                    kBlockKV))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<D>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  kernel<<<grid, kThreads, Plan<D>::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), Sq, num_heads,
      num_kv_heads, causal, window, q_offset, kv_valid, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k / v (B, Skv, Hkv, D), out (B, Sq, H, D), bf16,
// contiguous, 16-byte aligned; on `stream`.  Returns a cudaError_t.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int Sq, int Skv, int num_heads,
                                    int num_kv_heads, int head_dim,
                                    int causal, int window, int q_offset,
                                    int kv_valid, float scale, void* stream) {
  if (batch <= 0 || Sq <= 0 || Skv <= 0 || num_kv_heads <= 0
      || num_heads % num_kv_heads || q_offset < 0)
    return cudaErrorInvalidValue;
  kv_valid = max(0, min(kv_valid, Skv));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(DD)                                                  \
  case DD:                                                                    \
    return launch<DD>(q, k, v, out, batch, Sq, Skv, num_heads, num_kv_heads,  \
                      causal, window, q_offset, kv_valid, scale, s);
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

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
