// Paged chunked-prefill flash attention for Hopper (sm_90a), bf16 pool:
// TMA loads of the pages into a ring of stages on mbarriers, one producer
// thread that reads the page table, and the products on the tensor cores
// (wgmma), the online softmax in f32 registers.
//
// Replaces the TPU kernel `_paged_prefill_kernel` / `paged_prefill_flash`
// of src/repro/kernels/flash_attention.py (its pallas_call at line 279)
// for a bf16 pool; the int8 / fp8 frames of a quantized pool have their
// own kernel on the same block, paged_prefill.cu.  Same function: C
// prompt-chunk rows, each a different sequence at its own depth.  Query t
// of row c sits at absolute position offset[c] + t and attends, causally,
// to the KV positions below kv_valid = offset[c] + lengths[c] that the
// row's page table maps (position p lives in frame page_rows[c, p / page]
// at row p % page), optionally inside a sliding window.  Query rows t >=
// lengths[c] are don't-care, as on the TPU.  Entry point
// paged_prefill_attention_bf16, with paged_prefill.cu's arguments less
// the scales; head dims 16, 32, 64, 80 and 128, any G, any page size.
//
// Against _paged_prefill_kernel:
//
//   q BlockSpec (C, T, H, D)             -> a 4-D CUtensorMap (D, H, T, C)
//                                           over the model layout; rows
//                                           past T arrive as zeros
//                                           (flash_sm90.cuh: paged_q_map)
//   k_pages / v_pages in ANY, frames     -> one 3-D map each over the pool
//     fetched by make_async_copy through    in place, (D, Hkv, N * page):
//     the scalar-prefetched page table      the producer thread reads the
//                                           chunk row's page_rows and
//                                           issues a box of
//                                           gcd(page, 64) rows x 64
//                                           columns per page of a tile, at
//                                           row frame * page + p % page;
//                                           a box wholly at or past the
//                                           tile's last visible position
//                                           goes to row -box (zeros: no
//                                           such position is read)
//   DMA semaphores, two slots            -> a ring of 4 stages, full and
//                                           empty mbarriers
//   pl.when(frame live)                  -> the block's tile range, from
//                                           the window's first tile (or 0)
//                                           to the last position its live
//                                           queries may see; a block of
//                                           padding rows only writes zeros
//   m / l / acc in VMEM                  -> f32 registers (flash_sm90.cuh)
//
// Bound on the card: at the main path's shapes (T = 256 chunk rows over a
// prefix of up to ~1.5k positions, D = 128) the work is ~4 * T * S * D
// flops per head against ~4 * S * D bytes of K/V per KV head:
// operations, at the 989 TFLOP/s bf16 tensor-core rate.  The design is
// the dense kernel's (flash_attention_sm90.cu) with the page table
// feeding the producer's coordinates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"

namespace {

using namespace repro_flash;

template <int D>
__global__ void __launch_bounds__(kThreads, 1) paged_prefill_sm90_kernel(
    __grid_constant__ const CUtensorMap q_map,
    __grid_constant__ const CUtensorMap k_map,
    __grid_constant__ const CUtensorMap v_map,
    const int* __restrict__ page_rows, const int* __restrict__ offsets,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int T,
    int num_heads, int num_kv_heads, int page, int pages_per_seq,
    int box_rows, int window, float scale_log2) {
  using P = Plan<D>;
  extern __shared__ unsigned char smem_raw[];
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, c = blockIdx.z;
  const int kvh = h / (num_heads / num_kv_heads);
  const int off = offsets[c], len = lengths[c];
  const int t0 = qt * kBlockQ;
  const long row_stride = static_cast<long>(num_heads) * D;
  __nv_bfloat16* out_tile = out + (static_cast<long>(c) * T + t0) * row_stride
                            + static_cast<long>(h) * D;

  if (t0 >= len) {               // the whole tile is padding: don't-care
    const int rows = min(kBlockQ, T - t0);
    for (int i = threadIdx.x; i < rows * D; i += kThreads)
      out_tile[(i / D) * row_stride + i % D] = __float2bfloat16(0.f);
    return;
  }

  const Smem<D> sm(smem_raw);
  const int kv_valid = off + len;
  const int first_q = off + t0;
  const int last_q = off + min(t0 + kBlockQ, len) - 1;
  const int hi = last_q + 1;     // <= kv_valid: causal
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
                      sm.qbar, a * kAtom, h, t0 + 64 * w, c);
      const int* rows = page_rows + static_cast<long>(c) * pages_per_seq;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int k0 = lo + it * kBlockKV;
        mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[st], P::kStageBytes);
        for (int r = 0; r < kBlockKV; r += box_rows) {
          const int p = k0 + r;
          const int at = p < hi
              ? rows[min(p / page, pages_per_seq - 1)] * page + p % page
              : -box_rows;
#pragma unroll
          for (int a = 0; a < P::kAtoms; ++a) {
            const int dst = (a * kBlockKV + r) * kRowBytes;
            tma_load_3d(sm.k(st) + dst, &k_map, &sm.full[st], a * kAtom, kvh,
                        at);
            tma_load_3d(sm.v(st) + dst, &v_map, &sm.full[st], a * kAtom, kvh,
                        at);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int q_pos[2] = {first_q + thread_row(wg, 0),
                          first_q + thread_row(wg, 1)};
    const PagedMask mask{kv_valid, window, first_q, last_q};
    float o[P::kDPad / 2], l[2];
    consume<D>(sm, wg, lo, n_tiles, scale_log2, q_pos, mask, o, l);
    store_rows<D>(out_tile, row_stride, wg, min(kBlockQ, T - t0), o, l);
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_rows, const void* offsets, const void* lengths,
           void* out, int chunk_rows, int T, int num_heads, int num_kv_heads,
           int page, int pages_per_seq, int window, float scale,
           cudaStream_t stream) {
  const int box_rows = gcd(page, kBlockKV);
  // the pool's frame count is not an argument: its row extent is the
  // largest a coordinate can address, and the page table names the rows
  const cuuint64_t kv_dims[3] = {static_cast<cuuint64_t>(D),
                                 static_cast<cuuint64_t>(num_kv_heads),
                                 0x7fffffffull};
  const cuuint64_t kv_strides[2] = {
      static_cast<cuuint64_t>(D) * 2,
      static_cast<cuuint64_t>(num_kv_heads) * D * 2};
  const cuuint32_t kv_box[3] = {kAtom, 1, static_cast<cuuint32_t>(box_rows)};
  CUtensorMap q_map, k_map, v_map;
  if (!paged_q_map(&q_map, q, D, num_heads, T, chunk_rows)
      || !encode_bf16(&k_map, k_pages, 3, kv_dims, kv_strides, kv_box)
      || !encode_bf16(&v_map, v_pages, 3, kv_dims, kv_strides, kv_box))
    return cudaErrorInvalidValue;
  auto kernel = paged_prefill_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<D>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, num_heads, chunk_rows);
  kernel<<<grid, kThreads, Plan<D>::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<const int*>(page_rows),
      static_cast<const int*>(offsets), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), T, num_heads, num_kv_heads, page,
      pages_per_seq, box_rows, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q / out (C, T, H, D) bf16, k_pages / v_pages (N, page, Hkv, D) bf16,
// page_rows (C, pages_per_seq), offsets and lengths (C,) int32; all
// contiguous, 16-byte aligned; on `stream`.  Returns a cudaError_t.
extern "C" int paged_prefill_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_rows, const void* offsets, const void* lengths, void* out,
    int chunk_rows, int T, int num_heads, int num_kv_heads, int head_dim,
    int page, int pages_per_seq, int window, float scale, void* stream) {
  if (chunk_rows <= 0 || T <= 0 || num_kv_heads <= 0
      || num_heads % num_kv_heads || page <= 0 || pages_per_seq <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PREFILL_CASE(DD)                                                \
  case DD:                                                                    \
    return launch<DD>(q, k_pages, v_pages, page_rows, offsets, lengths, out,  \
                      chunk_rows, T, num_heads, num_kv_heads, page,           \
                      pages_per_seq, window, scale, s);
  switch (head_dim) {
    REPRO_PREFILL_CASE(16)
    REPRO_PREFILL_CASE(32)
    REPRO_PREFILL_CASE(64)
    REPRO_PREFILL_CASE(80)
    REPRO_PREFILL_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PREFILL_CASE
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
