// Paged chunked-prefill flash attention for Hopper (sm_90a), the int8
// and fp8 frames of a quantized pool, on the tensor cores.
//
// Replaces the TPU kernel `_paged_prefill_kernel` / `paged_prefill_flash`
// of src/repro/kernels/flash_attention.py (its pallas_call at line 279)
// for a quantized pool; a bf16 pool has its own kernel on the same block,
// paged_prefill_sm90.cu.  It computes the same function: C prompt-chunk
// rows, each a different sequence at its own depth.  Query t of row c
// sits at absolute position offset[c] + t and attends, causally, to the
// KV positions below kv_valid = offset[c] + lengths[c] that the row's
// page table maps (position p lives in frame page_rows[c, p / page] at
// row p % page), optionally inside a sliding window.  Output bf16.
// Query rows t >= lengths[c] are don't-care, as on the TPU.
//
// Layout: q and out (C, T, H, D), the model layout; k_pages / v_pages
// (N, page, Hkv, D); page_rows (C, pages_per_seq) int32; offset and
// lengths (C,) int32.  H = G * Hkv, query head h reads KV head h / G,
// any G; head dims 16, 32, 64, 80 and 128, any page size.
//
// Entry points: paged_prefill_attention_int8 / _fp8 for the frames of a
// quantized pool (element types in kv_types.cuh), which take k_scales /
// v_scales (N, Hkv) f32: the TPU kernel's quantized instance (its scale
// BlockSpecs at line 257, its dequant at lines 176-177 and 190-191).  The
// value of a code is float(code) * the scale of its (frame, KV head).  No
// position at or past the tile's last visible one is read, page-table
// entry and scale included: its K and V rows arrive as zeros (a zero
// byte is +0 in int8 and in E4M3) with scale 0.
//
// Design: flash_sm90.cuh's block, as the bf16 pool's kernel: 128 query
// rows of one query head in two consumer warpgroups, S = Q K^T and
// O += P V on wgmma m64n64k16, the online softmax in f32 registers in
// base 2, KV tiles of 64 positions at absolute multiples of 64 through a
// ring of kStages bf16 stages on full / empty mbarriers; q arrives by TMA
// (paged_q_map).  What differs is the way from the 1-byte frames to the
// bf16 operand tiles, which TMA alone cannot take (it copies, it does not
// widen):
//   * the producer warpgroup's kProducers threads each copy their share
//     of a tile's K and V rows, 16 bytes at a time, through the page
//     table into a raw ring of kRawStages stages by cp.async, and the
//     first kBlockKV threads each position's k and v scale (4-byte
//     copies); kRawStages - 1 tiles of copies stay in flight;
//   * a thread then widens the very bytes it copied (so the raw ring
//     needs no barrier) into the swizzled bf16 stage that a TMA box would
//     have written, exactly (kv_types.cuh: widen16), puts the scales
//     beside the stage, and arrives on the stage's full barrier, which
//     waits for all kProducers threads, after a proxy fence (wgmma reads
//     shared memory through the async proxy);
//   * a scale is constant along D, so it factors out of both products:
//     the consumers multiply column j of S by ks_j before the mask, and
//     column j of P by vs_j before P is rounded to bf16; the row sums add
//     the unscaled weights (ColumnScales, consume's Scales hook).
// So the products read the raw codes, and only the f32 summation order
// and P's bf16 rounding differ from the plain version, as for bf16.  A
// row's bits depend on its q, the tiles' absolute positions and its mask
// only (flash_sm90.cuh), so a chunk split leaves them as they are.
//
// Bound on the card: at the main path's shapes (T = 256 chunk rows over
// a prefix of up to ~1.5k positions, D = 128) the work is ~4 * T * S * D
// flops per head against ~2 * S * D bytes of 1-byte K/V per KV head:
// operations, at the 989 TFLOP/s bf16 tensor-core rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"
#include "kv_types.cuh"

namespace {

using namespace repro_flash;

constexpr int kProducers = 128;        // the producer warpgroup's threads
constexpr int kRawStages = 3;          // raw ring: 2 tiles' copies in flight
// setmaxnreg: the producers copy and widen, the consumers hold S, P, O;
// 72 * 128 + 216 * 256 = 168 * 384, the launch's registers
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;

// The quantized plan of a head dim: Plan<D> (the q tile, kStages bf16
// stages of a K and a V tile, the barriers), then each bf16 stage's
// kBlockKV k scales and kBlockKV v scales, then kRawStages raw stages of
// a tile's 1-byte K rows, its V rows and their scales.
template <int D>
struct QuantPlan {
  static constexpr int kRowPieces = D / 16;             // 16 bytes a piece
  static constexpr int kPieces = kBlockKV * kRowPieces; // of K (or V) a tile
  static constexpr int kRawTile = kPieces * 16;
  static constexpr int kScaleBytes = 2 * kBlockKV * 4;
  static constexpr int kRawStage = 2 * kRawTile + kScaleBytes;
  static constexpr int kScaleOffset =
      (Plan<D>::kBarOffset + (2 * kStages + 1) * 8 + 15) / 16 * 16;
  static constexpr int kRawOffset = kScaleOffset + kStages * kScaleBytes;
  static constexpr int kSmem = kAlign + kRawOffset + kRawStages * kRawStage;
  static_assert(kSmem <= kSmemOptin, "the quantized plan must fit one block");
};

// One 16-byte piece, global -> shared, through L2; zeros if !live.  (No
// memory clobber: the page-table reads of later pieces may move ahead;
// the copied bytes are read only after cp_async_wait.)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(live ? 16 : 0));
}

// One 4-byte element, global -> shared; zero if !live.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's shared-memory writes, visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes at a shared-memory address, loaded and stored as such.
__device__ __forceinline__ uint4 lds128(uint32_t at) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(at)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t at, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// consume's Scales hook: bf16 stage st's k scales at the shared-memory
// address stages + st * 2 * kBlockKV * 4, its v scales kBlockKV floats
// further; this thread's columns of S and P are 8 j + 2 (lane % 4) +
// {0, 1}, in both of its rows.
struct ColumnScales {
  struct Cols {
    float2 c[kBlockKV / 8];
  };
  uint32_t stages;

  __device__ Cols load(uint32_t at) const {
    Cols f;
    at += 8 * (threadIdx.x % 4);
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j)
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(f.c[j].x), "=f"(f.c[j].y) : "r"(at + 32 * j)
                   : "memory");
    return f;
  }
  __device__ Cols keys(int st) const {
    return load(stages + st * 2 * kBlockKV * 4);
  }
  __device__ Cols values(int st) const {
    return load(stages + (st * 2 + 1) * kBlockKV * 4);
  }
  __device__ void apply(float (&s)[kBlockKV / 2], const Cols& f) const {
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j) {
      s[4 * j] *= f.c[j].x;
      s[4 * j + 1] *= f.c[j].y;
      s[4 * j + 2] *= f.c[j].x;
      s[4 * j + 3] *= f.c[j].y;
    }
  }
};

// The producer warpgroup: tile it (positions k0 = lo + 64 it on) is
// copied into raw stage it % kRawStages, widened into bf16 stage
// it % kStages.  Thread u copies and widens pieces u, u + kProducers, ...
// of K and of V (piece i: row i / kRowPieces, bytes 16 (i % kRowPieces)
// on), and, for u < kBlockKV, the scales of row u.
template <typename KV, int D>
__device__ __forceinline__ void produce(
    const Smem<D>& sm, unsigned char* raw, float* scales,
    const KV* __restrict__ k_pages, const KV* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const int* __restrict__ rows, int kvh, int num_kv_heads, int page,
    int pages_per_seq, int lo, int hi, int n_tiles) {
  using QP = QuantPlan<D>;
  // pieces a thread: the loops below are unrolled, so a thread's
  // page-table reads, and its pieces' loads and widening, overlap
  constexpr int kMine = (QP::kPieces + kProducers - 1) / kProducers;
  const int u = threadIdx.x - 128 * kConsumers;
  const long row_bytes = static_cast<long>(num_kv_heads) * D;
  const auto* kb = reinterpret_cast<const unsigned char*>(k_pages) + kvh * D;
  const auto* vb = reinterpret_cast<const unsigned char*>(v_pages) + kvh * D;
  const uint32_t raw_at = smem_u32(raw);
  const uint32_t ring_at = smem_u32(sm.k(0));
  // Where a page divides the tile (the engine's 16: 4 pages a tile),
  // tile it's first page is lo / page + it * (kBlockKV / page), and the
  // page and row of each of this thread's rows in the tile are fixed:
  // taken once here, so a tile's copies divide by nothing.  Else divide
  // per row.
  const bool whole = kBlockKV % page == 0;
  const int lo_page = lo / page, tile_pages = kBlockKV / page;
  int page_of[kMine + 1], row_of[kMine + 1];      // [kMine]: row u's
#pragma unroll
  for (int j = 0; j <= kMine; ++j) {
    const int r = j < kMine ? (u + j * kProducers) / QP::kRowPieces : u;
    page_of[j] = r / page;
    row_of[j] = r % page;
  }
  // the frame of tile it's row r, this thread's j-th, and the row in it
  // (below hi, so its page-table entry is live)
  auto frame = [&](int it, int r, int j) {
    const int pg = whole ? lo_page + it * tile_pages + page_of[j]
                         : (lo + it * kBlockKV + r) / page;
    return static_cast<long>(rows[min(pg, pages_per_seq - 1)]);
  };
  auto row_in = [&](int it, int r, int j) {
    return whole ? row_of[j] : (lo + it * kBlockKV + r) % page;
  };

  auto copy = [&](int it) {
    if (it < n_tiles) {
      const int k0 = lo + it * kBlockKV;
      unsigned char* st = raw + (it % kRawStages) * QP::kRawStage;
#pragma unroll
      for (int j = 0; j < kMine; ++j) {
        const int i = u + j * kProducers;
        if (QP::kPieces % kProducers != 0 && i >= QP::kPieces) break;
        const int r = i / QP::kRowPieces;
        const bool live = k0 + r < hi;
        const long at =
            live ? (frame(it, r, j) * page + row_in(it, r, j)) * row_bytes
                       + (i % QP::kRowPieces) * 16
                 : 0;
        cp_async16(st + i * 16, kb + at, live);
        cp_async16(st + QP::kRawTile + i * 16, vb + at, live);
      }
      if (u < kBlockKV) {
        const bool live = k0 + u < hi;
        const long at = live ? frame(it, u, kMine) * num_kv_heads + kvh : 0;
        float* sd = reinterpret_cast<float*>(st + 2 * QP::kRawTile);
        cp_async4(sd + u, k_scales + at, live);
        cp_async4(sd + kBlockKV + u, v_scales + at, live);
      }
    }
    cp_async_commit();             // an empty group past the last tile
  };

  // Piece i's 16 columns are the 8-column chunks 2 (i % kRowPieces) and
  // the next of its row, at the chunks a TMA box with 128-byte swizzle
  // writes (atom-major, chunk c of row r at c ^ (r % 8)).
  auto widen = [&](int it) {
    const uint32_t k_at = ring_at + (it % kStages) * Plan<D>::kStageBytes;
    const uint32_t v_at = k_at + Plan<D>::kTileBytes;
    const uint32_t st = raw_at + (it % kRawStages) * QP::kRawStage;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {   // K, then V: a thread's loads first
      uint4 in[kMine];
#pragma unroll
      for (int j = 0; j < kMine; ++j) {
        const int i = u + j * kProducers;
        if (QP::kPieces % kProducers == 0 || i < QP::kPieces)
          in[j] = lds128(st + kv * QP::kRawTile + i * 16);
      }
#pragma unroll
      for (int j = 0; j < kMine; ++j) {
        const int i = u + j * kProducers;
        if (QP::kPieces % kProducers != 0 && i >= QP::kPieces) break;
        const int r = i / QP::kRowPieces, c = 2 * (i % QP::kRowPieces);
        const uint32_t row = (kv ? v_at : k_at)
                             + ((c / 8) * kBlockKV + r) * kRowBytes;
        uint4 lo16, hi16;
        repro_kv::widen16<KV>(in[j], lo16, hi16);
        sts128(row + ((c % 8) ^ (r % 8)) * 16, lo16);
        sts128(row + (((c + 1) % 8) ^ (r % 8)) * 16, hi16);
      }
    }
    if (u < kBlockKV) {
      const float* sd = reinterpret_cast<const float*>(
          raw + (it % kRawStages) * QP::kRawStage + 2 * QP::kRawTile);
      const int s = it % kStages;
      scales[s * 2 * kBlockKV + u] = sd[u];
      scales[s * 2 * kBlockKV + kBlockKV + u] = sd[kBlockKV + u];
    }
  };

  // the columns past D of every stage: zeros once (q's are zeros too,
  // and 0 * a stale NaN would not be)
  if constexpr (D < Plan<D>::kDPad) {
    constexpr int kPad = (Plan<D>::kDPad - D) / 8;   // chunks past D a row
    for (int i = u; i < 2 * kStages * kBlockKV * kPad; i += kProducers) {
      const int c = D / 8 + i % kPad, r = (i / kPad) % kBlockKV;
      const int t = i / (kPad * kBlockKV);           // stage 2 s + (K, V)
      sts128(ring_at + (t / 2) * Plan<D>::kStageBytes
                 + (t % 2) * Plan<D>::kTileBytes
                 + ((c / 8) * kBlockKV + r) * kRowBytes
                 + ((c % 8) ^ (r % 8)) * 16,
             make_uint4(0u, 0u, 0u, 0u));
    }
  }

  for (int it = 0; it < kRawStages - 1; ++it) copy(it);
  for (int it = 0; it < n_tiles; ++it) {
    copy(it + kRawStages - 1);
    cp_async_wait<kRawStages - 1>();          // this thread's tile it
    const int s = it % kStages;
    mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
    widen(it);
    fence_proxy_async();
    mbar_arrive(&sm.full[s]);
  }
}

// KV: the pool's element type.
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads, 1) paged_prefill_quant_kernel(
    __grid_constant__ const CUtensorMap q_map,
    const KV* __restrict__ k_pages, const KV* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const int* __restrict__ page_rows, const int* __restrict__ offsets,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int T,
    int num_heads, int num_kv_heads, int page, int pages_per_seq, int window,
    float scale_log2) {
  using QP = QuantPlan<D>;
  extern __shared__ unsigned char smem_raw[];
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, c = blockIdx.z;
  const int kvh = h / (num_heads / num_kv_heads);
  const int off = offsets[c], len = lengths[c];
  const int t0 = qt * kBlockQ;
  const long row_stride = static_cast<long>(num_heads) * D;
  __nv_bfloat16* out_tile = out + (static_cast<long>(c) * T + t0) * row_stride
                            + static_cast<long>(h) * D;

  if (t0 >= len) {               // the whole tile is padding: don't-care
    const int n = min(kBlockQ, T - t0);
    for (int i = threadIdx.x; i < n * D; i += kThreads)
      out_tile[(i / D) * row_stride + i % D] = __float2bfloat16(0.f);
    return;
  }

  const Smem<D> sm(smem_raw);
  float* scales = reinterpret_cast<float*>(sm.q + QP::kScaleOffset);
  unsigned char* raw = sm.q + QP::kRawOffset;
  const int kv_valid = off + len;
  const int first_q = off + t0;
  const int last_q = off + min(t0 + kBlockQ, len) - 1;
  const int hi = last_q + 1;     // <= kv_valid: causal
  const int lo = window_start(first_q, window);
  const int n_tiles = tile_count(lo, hi);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) sm.init(kProducers);
  __syncthreads();

  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      tma_prefetch(&q_map);
      mbar_arrive_expect_tx(sm.qbar, Plan<D>::kQBytes);
#pragma unroll
      for (int a = 0; a < Plan<D>::kAtoms; ++a)
#pragma unroll
        for (int w = 0; w < kConsumers; ++w)
          tma_load_4d(sm.q + (a * kBlockQ + 64 * w) * kRowBytes, &q_map,
                      sm.qbar, a * kAtom, h, t0 + 64 * w, c);
    }
    produce<KV, D>(sm, raw, scales, k_pages, v_pages, k_scales, v_scales,
                   page_rows + static_cast<long>(c) * pages_per_seq, kvh,
                   num_kv_heads, page, pages_per_seq, lo, hi, n_tiles);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int q_pos[2] = {first_q + thread_row(wg, 0),
                          first_q + thread_row(wg, 1)};
    const PagedMask mask{kv_valid, window, first_q, last_q};
    float o[Plan<D>::kDPad / 2], l[2];
    consume<D>(sm, wg, lo, n_tiles, scale_log2, q_pos, mask, o, l,
               ColumnScales{smem_u32(scales)});
    store_rows<D>(out_tile, row_stride, wg, min(kBlockQ, T - t0), o, l);
  }
}

template <typename KV, int D>
int launch_d(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales,
             const void* page_rows, const void* offsets, const void* lengths,
             void* out, int chunk_rows, int T, int num_heads,
             int num_kv_heads, int page, int pages_per_seq, int window,
             float scale, cudaStream_t stream) {
  CUtensorMap q_map;
  if (!paged_q_map(&q_map, q, D, num_heads, T, chunk_rows))
    return cudaErrorInvalidValue;
  auto kernel = paged_prefill_quant_kernel<KV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      QuantPlan<D>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, num_heads, chunk_rows);
  kernel<<<grid, kThreads, QuantPlan<D>::kSmem, stream>>>(
      q_map, static_cast<const KV*>(k_pages), static_cast<const KV*>(v_pages),
      static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
      static_cast<const int*>(page_rows), static_cast<const int*>(offsets),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), T,
      num_heads, num_kv_heads, page, pages_per_seq, window, scale * kLog2e);
  return cudaGetLastError();
}

// One entry point's body: element type KV of the pool's frames.
template <typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* page_rows,
           const void* offsets, const void* lengths, void* out,
           int chunk_rows, int T, int num_heads, int num_kv_heads,
           int head_dim, int page, int pages_per_seq, int window, float scale,
           void* stream) {
  if (chunk_rows <= 0 || T <= 0 || num_kv_heads <= 0
      || num_heads % num_kv_heads || page <= 0 || pages_per_seq <= 0
      || k_scales == nullptr || v_scales == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PREFILL_CASE(DD)                                                \
  case DD:                                                                    \
    return launch_d<KV, DD>(q, k_pages, v_pages, k_scales, v_scales,          \
                            page_rows, offsets, lengths, out, chunk_rows, T,  \
                            num_heads, num_kv_heads, page, pages_per_seq,     \
                            window, scale, s);
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

}  // namespace

// The quantized pool's instances: q / out (C, T, H, D) bf16, k_pages /
// v_pages (N, page, Hkv, D) int8 or E4M3, k_scales / v_scales (N, Hkv)
// f32, page_rows (C, pages_per_seq), offsets and lengths (C,) int32; all
// contiguous, q, out and the pools 16-byte aligned; on `stream`.
// Returns a cudaError_t.
#define REPRO_QUANT_ENTRY(SUFFIX, ELEM)                                       \
  extern "C" int paged_prefill_attention_##SUFFIX(                            \
      const void* q, const void* k_pages, const void* v_pages,                \
      const void* k_scales, const void* v_scales, const void* page_rows,      \
      const void* offsets, const void* lengths, void* out, int chunk_rows,    \
      int T, int num_heads, int num_kv_heads, int head_dim, int page,         \
      int pages_per_seq, int window, float scale, void* stream) {             \
    return launch<ELEM>(q, k_pages, v_pages, k_scales, v_scales, page_rows,   \
                        offsets, lengths, out, chunk_rows, T, num_heads,      \
                        num_kv_heads, head_dim, page, pages_per_seq, window,  \
                        scale, stream);                                       \
  }

REPRO_QUANT_ENTRY(int8, int8_t)
REPRO_QUANT_ENTRY(fp8, __nv_fp8_e4m3)
#undef REPRO_QUANT_ENTRY

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
