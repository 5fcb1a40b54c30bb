// Paged one-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` / `paged_decode_attention`
// of src/repro/kernels/decode_attention.py (its pallas_call at line 254).
// It computes the same function: for each sequence b and query head h,
// softmax(q . K^T / sqrt(D)) . V over the first lengths[b] KV positions,
// where position p lives in pool frame page_table[b, p / page] at row
// p % page.  Online softmax in f32, bf16 loads, bf16 store.
//
// Layout: q and out (B, H, D); k_pages / v_pages (N, page, Hkv, D), so one
// pool row of one KV head is D contiguous bf16 (256 bytes at D = 128) and
// rows are Hkv * D apart; page_table (B, pages_per_seq) int32; lengths
// (B,) int32.  H = G * Hkv, query head h reads KV head h / G.
//
// Design: one block of 128 threads per (KV head, sequence).  The block
// loads its own page-table row and walks the sequence's KV positions in
// tiles of 64, each position mapped through the table, so a tile may
// straddle several frames.  All G query heads of the KV head share each
// staged K/V row:
//   1. scores: a row is read by D/8 lanes, 16 bytes each; the G partial
//      dot products are reduced with warp shuffles;
//   2. softmax: one warp per query head updates the running max and sum;
//   3. P.V: each thread owns 8 dims of the output for a subset of the
//      tile's rows, and the row groups are summed once at the end.
// Positions at or past lengths[b] are never read: the loop ends at the
// last tile that holds a valid position (the TPU kernel's page liveness).
//
// Bound on the card: bytes.  Each step reads every valid K and V row once
// (2 * len * D * 2 bytes per sequence and KV head) and does 4 * G * D
// flops per position, far below the ~295 flop/byte ridge of an H100.
// What limits this simple version is parallelism: B * Hkv blocks (64 at
// B = 8, Hkv = 8) leave most of the 132 SMs idle, and each block walks
// its tiles one after another.  Splitting the KV axis across blocks with
// a second reduction pass (flash-decoding) is the known next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int G, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    int num_kv_heads, int page, int pages_per_seq, float scale) {
  constexpr int kLanesPerRow = D / 8;                  // 16 bytes per lane
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kRowGroups = kThreads / kLanesPerRow;  // P.V row split
  static_assert(kTile % (kWarps * kRowsPerWarp) == 0, "tile rows");
  static_assert(kTile % kRowGroups == 0, "tile rows");

  __shared__ float q_s[G][D];
  __shared__ float p_s[G][kTile];
  __shared__ float m_s[G], l_s[G], corr_s[G];
  __shared__ float red_s[kRowGroups][G][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lengths[b];
  const int* pt = page_table + static_cast<long>(b) * pages_per_seq;
  const long row_stride = static_cast<long>(num_kv_heads) * D;
  const long head_off = static_cast<long>(kvh) * D;
  const long q_base = (static_cast<long>(b) * num_kv_heads + kvh) * G * D;

  for (int i = tid; i < G * D; i += kThreads)
    q_s[i / D][i % D] = __bfloat162float(q[q_base + i]) * scale;
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int sub = tid % kLanesPerRow;   // 8 dims [sub*8, sub*8+8)
  const int grp = tid / kLanesPerRow;   // P.V rows grp, grp+kRowGroups, ...
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  __syncthreads();

  const int n_tiles = (len + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kTile;
    // 1. scores for the tile's rows, all G heads at once
    for (int r = warp * kRowsPerWarp + lane / kLanesPerRow; r < kTile;
         r += kWarps * kRowsPerWarp) {
      const int pos = t0 + r;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (pos < len) {
        const int frame = pt[min(pos / page, pages_per_seq - 1)];
        const long base = (static_cast<long>(frame) * page + pos % page) * row_stride
                          + head_off + sub * 8;
        float kf[8];
        load8(k_pages + base, kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) part[g] += q_s[g][sub * 8 + e] * kf[e];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (sub == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) p_s[g][r] = pos < len ? part[g] : kNegInf;
      }
    }
    __syncthreads();
    // 2. online softmax: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, p_s[g][r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < kTile; r += 32) {
        const float e = expf(p_s[g][r] - m_new);
        p_s[g][r] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + P . V over this thread's rows and dims
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float corr = corr_s[g];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
    }
    for (int r = grp; r < kTile; r += kRowGroups) {
      const int pos = t0 + r;
      if (pos >= len) break;
      const int frame = pt[min(pos / page, pages_per_seq - 1)];
      const long base = (static_cast<long>(frame) * page + pos % page) * row_stride
                        + head_off + sub * 8;
      float vf[8];
      load8(v_pages + base, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_s[g][r];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] += p * vf[e];
      }
    }
    __syncthreads();   // p_s and corr_s are rewritten by the next tile
  }

  // sum the row groups' partial outputs, normalise, store bf16
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) red_s[grp][g][sub * 8 + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kRowGroups; ++j) s += red_s[j][g][d];
    out[q_base + i] = __float2bfloat16(s / fmaxf(l_s[g], 1e-30f));
  }
}

template <int D>
cudaError_t launch_d(int groups, dim3 grid, cudaStream_t stream,
                     const __nv_bfloat16* q, const __nv_bfloat16* k,
                     const __nv_bfloat16* v, const int* pt, const int* len,
                     __nv_bfloat16* out, int hkv, int page, int pps, float scale) {
#define REPRO_DECODE_CASE(GG)                                              \
  case GG:                                                                 \
    paged_decode_kernel<GG, D><<<grid, kThreads, 0, stream>>>(             \
        q, k, v, pt, len, out, hkv, page, pps, scale);                     \
    return cudaGetLastError();
  switch (groups) {
    REPRO_DECODE_CASE(1)
    REPRO_DECODE_CASE(2)
    REPRO_DECODE_CASE(3)
    REPRO_DECODE_CASE(4)
    REPRO_DECODE_CASE(6)
    REPRO_DECODE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

}  // namespace

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int batch,
    int num_heads, int num_kv_heads, int head_dim, int page,
    int pages_per_seq, float scale, void* stream) {
  if (num_kv_heads <= 0 || num_heads % num_kv_heads) return cudaErrorInvalidValue;
  const dim3 grid(num_kv_heads, batch);
  const int groups = num_heads / num_kv_heads;
  auto qq = static_cast<const __nv_bfloat16*>(q);
  auto kk = static_cast<const __nv_bfloat16*>(k_pages);
  auto vv = static_cast<const __nv_bfloat16*>(v_pages);
  auto pt = static_cast<const int*>(page_table);
  auto ln = static_cast<const int*>(lengths);
  auto oo = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_d<64>(groups, grid, s, qq, kk, vv, pt, ln, oo, num_kv_heads,
                          page, pages_per_seq, scale);
    case 128:
      return launch_d<128>(groups, grid, s, qq, kk, vv, pt, ln, oo, num_kv_heads,
                           page, pages_per_seq, scale);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
