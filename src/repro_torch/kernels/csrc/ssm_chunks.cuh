// Shared pieces of the chunk-parallel linear recurrences, wkv6.cu and
// ssd.cu: their tensor-core products, the staging of a piece's rows in
// shared memory, and the scan of the segments' states.
//
// Products: mma.sync m16n8k8 TF32 with f32 accumulators.  A warp owns 16
// rows (one sub-chunk, the mma's M) and up to kGroup tiles of 8 columns.
// An operand that is not exact in TF32 (any f32 input, and every operand
// scaled by a decay) is split x = hi + lo: hi is x rounded to nearest,
// ties away from zero (low 13 bits zero), lo = x - hi, exact in f32, read
// by the tensor core through its top 19 bits; a . b is then lo_a . hi_b +
// hi_a . lo_b + hi_a . hi_b (3xTF32, as csrc/flash_attention.cu).  A bf16
// input is exact in TF32 (8 significant bits of 11), so where one side
// of a product is a raw bf16 input its split is skipped: two products,
// and one where both sides are (C B^T of ssd in bf16).  The tensor core
// truncates as it accumulates, so each 16 of depth is summed from zero
// in fresh accumulators and added to the result in f32.
//
// Shared rows: a matrix read as element (row g, column t) of a lane (g =
// lane / 4, t = lane % 4: an A operand, or a B operand stored n-major) has
// rows 4 mod 8 floats apart (stride_a); one read as element (t, g) (a B
// operand stored k-major) 8 mod 16 apart (stride_b): either way the 32
// lanes' reads meet 32 banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_io.cuh"

namespace repro_ssm {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 16;       // rows of a sub-chunk: the mma's M
constexpr int kGroup = 4;      // 8-column tiles a warp holds at once
constexpr int kScanThreads = 256;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int stride_a(int n) { return n + 4; }
__host__ __device__ constexpr int stride_b(int n) { return n + 8; }

// x as TF32 head and tail (split), or as it is when exact (a bf16 input).
template <bool kSplit>
__device__ __forceinline__ void tf32(float x, uint32_t& hi, uint32_t& lo) {
  if (kSplit) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU op (x <= 0 here: the decays are kept in base 2; a
// result below 2^-126 flushes to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Row of entry q of the entries (t, s <= t) of a 16 x 16 block, taken row
// by row (its column is q - row (row + 1) / 2).
__host__ __device__ constexpr int tri_row(int q) {
  int t = 0;
  while ((t + 1) * (t + 2) / 2 <= q) ++t;
  return t;
}

// One level of reduce_scatter: lanes kOff apart swap halves of v[0, 2
// kOff) and add; the half a lane keeps lands in v[0, kOff).
template <int kOff>
__device__ __forceinline__ void reduce_level(float (&v)[32], int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int e = 0; e < kOff; ++e) {
    const float send = upper ? v[e] : v[e + kOff];
    const float keep = upper ? v[e + kOff] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// 32 partial sums in each lane -> lane l holds the warp's total of sum l
// (in v[0]): a butterfly reduce-scatter, 31 shuffles; every index is a
// constant, so v stays in registers.
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  reduce_level<16>(v, lane);
  reduce_level<8>(v, lane);
  reduce_level<4>(v, lane);
  reduce_level<2>(v, lane);
  reduce_level<1>(v, lane);
}

__device__ __forceinline__ void zero(float (&acc)[kGroup][4]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc[j] += A . B_j over `depth` (a multiple of 16), for the warp's 16
// rows and the column tiles j < NT.  a(row, d) gives A's element (row <
// 16), b(d, col) B's (col < 8 NT), as f32; kSplitA / kSplitB: that
// operand is split (else exact in TF32).  Accumulator element e of tile j
// is row g + 8 (e / 2), column 8 j + 2 t + e % 2.  NT is a constant, so
// the tiles' loads and products interleave with no branch between them.
template <int NT, bool kSplitA, bool kSplitB, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[kGroup][4], int depth,
                                         FA a, FB b) {
  static_assert(NT <= kGroup, "NT column tiles a warp at most");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int d0 = 0; d0 < depth; d0 += 16) {
    float part[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = d0 + 8 * half + t, k1 = k0 + 4;
      uint32_t ah[4], al[4];
      tf32<kSplitA>(a(g, k0), ah[0], al[0]);
      tf32<kSplitA>(a(g + 8, k0), ah[1], al[1]);
      tf32<kSplitA>(a(g, k1), ah[2], al[2]);
      tf32<kSplitA>(a(g + 8, k1), ah[3], al[3]);
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tf32<kSplitB>(b(k0, 8 * j + g), bh[j][0], bl[j][0]);
        tf32<kSplitB>(b(k1, 8 * j + g), bh[j][1], bl[j][1]);
      }
      if (kSplitA)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[j], al, bh[j][0], bh[j][1]);
      if (kSplitB)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(part[j], ah, bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// warp_mma over nt = 2 or 4 column tiles (a unit of 16 or 32 columns).
template <bool kSplitA, bool kSplitB, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[kGroup][4], int nt,
                                         int depth, FA a, FB b) {
  if (nt == 4)
    warp_mma<4, kSplitA, kSplitB>(acc, depth, a, b);
  else
    warp_mma<2, kSplitA, kSplitB>(acc, depth, a, b);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// Every staged tile has landed and every thread may read it.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Staging a piece's tiles: `rows` rows of W elements (W a multiple of 4,
// W / 4 at most kThreads) from global memory (row stride ld elements) into
// shared memory as f32 (row stride sd floats), rows n..rows-1 zero.  A
// thread moves the 4 elements at column 4 (tid % Q) of rows tid / Q + j
// kStep.  An f32 tile goes by cp.async at load() (staged() waits); a bf16
// tile's loads land in registers at load() and are widened into shared
// memory at store(), so every tile of a piece is in flight at once;
// copy() does both in rounds of 8 loads, for tiles too wide for that.
constexpr int kMaxRows = 128;   // rows of a piece, at most

template <int W, typename T>
struct Stager;

template <int W>
struct Stager<W, float> {
  static constexpr int Q = W / 4, kStep = kThreads / Q;
  static_assert(W % 4 == 0 && Q <= kThreads, "a row's 16-byte pieces");
  __device__ __forceinline__ void load(float* dst, int sd, const float* src,
                                       long ld, int rows, int n) {
    const int c = 4 * (threadIdx.x % Q);
    for (int r = threadIdx.x / Q; r < rows; r += kStep)
      cp_async16(dst + r * sd + c, src + (r < n ? r : 0) * ld + c, r < n);
  }
  __device__ __forceinline__ void store() {}
  __device__ __forceinline__ void copy(float* dst, int sd, const float* src,
                                       long ld, int rows, int n) {
    load(dst, sd, src, ld, rows, n);
  }
};

__device__ __forceinline__ float4 widen(uint2 raw) {
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

template <int W>
struct Stager<W, __nv_bfloat16> {
  static constexpr int Q = W / 4, kStep = kThreads / Q;
  static constexpr int kMax = (kMaxRows + kStep - 1) / kStep;
  static_assert(W % 4 == 0 && Q <= kThreads, "a row's 8-byte pieces");
  uint2 raw[kMax];
  float* dst_;
  int sd_, rows_;
  __device__ __forceinline__ void load(float* dst, int sd,
                                       const __nv_bfloat16* src, long ld,
                                       int rows, int n) {
    dst_ = dst + 4 * (threadIdx.x % Q);
    sd_ = sd;
    rows_ = rows;
    const int r0 = threadIdx.x / Q;
    const __nv_bfloat16* p = src + 4 * (threadIdx.x % Q);
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      const int r = r0 + j * kStep;
      raw[j] = r < n ? *reinterpret_cast<const uint2*>(p + r * ld)
                     : make_uint2(0u, 0u);
    }
  }
  __device__ __forceinline__ void store() {
    const int r0 = threadIdx.x / Q;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      const int r = r0 + j * kStep;
      if (r < rows_)
        *reinterpret_cast<float4*>(dst_ + r * sd_) = widen(raw[j]);
    }
  }
  // load() and store() in rounds of 8 loads a thread: fewer registers.
  __device__ __forceinline__ void copy(float* dst, int sd,
                                       const __nv_bfloat16* src, long ld,
                                       int rows, int n) {
    const int c = 4 * (threadIdx.x % Q), r0 = threadIdx.x / Q;
#pragma unroll
    for (int j0 = 0; j0 < kMax; j0 += 8) {
      uint2 part[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = r0 + (j0 + j) * kStep;
        part[j] = r < n ? *reinterpret_cast<const uint2*>(src + r * ld + c)
                        : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = r0 + (j0 + j) * kStep;
        if (j0 + j < kMax && r < rows)
          *reinterpret_cast<float4*>(dst + r * sd + c) = widen(part[j]);
      }
    }
  }
};

// An f32 rows x W block, dense in global memory, into shared memory (row
// stride sd) by cp.async (staged() waits), or back.
template <int W>
__device__ __forceinline__ void load_block(float* dst, int sd,
                                           const float* src, int rows) {
  Stager<W, float>().load(dst, sd, src, W, rows, rows);
}

template <int W>
__device__ __forceinline__ void store_block(float* dst, const float* src,
                                            int sd, int rows) {
  constexpr int Q = W / 4;
  for (int e = threadIdx.x; e < rows * Q; e += kThreads) {
    const int r = e / Q, c = 4 * (e % Q);
    *reinterpret_cast<float4*>(dst + r * W + c) =
        *reinterpret_cast<const float4*>(src + r * sd + c);
  }
}

template <int W>
__device__ __forceinline__ void zero_block(float* dst, int sd, int rows) {
  constexpr int Q = W / 4;
  for (int e = threadIdx.x; e < rows * Q; e += kThreads)
    *reinterpret_cast<float4*>(dst + (e / Q) * sd + 4 * (e % Q)) =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// Two adjacent outputs, narrowed to the element type.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The state scan between the segments, in place: ws holds, per (batch row,
// head), the states U_g (R x C each) that segments g < n built from zero,
// and leaves S_{g+1} = 2^{d_g} S_g + U_g: the state entering segment g + 1,
// from S_0 = s_in (the caller's initial state, (batch row, head, R, C)
// dense) or 0 where s_in is null.  dec holds the log2 decays d_g <= 0, per
// row of the state (dec_rows = R) or one per segment (dec_rows = 1).  A
// thread carries 4 columns of one row; the loads of a batch of segments go
// out together.
__global__ void __launch_bounds__(kScanThreads) state_scan(
    float* __restrict__ ws, const float* __restrict__ dec,
    const float* __restrict__ s_in, int bh_count, int n, int R, int C,
    int dec_rows) {
  constexpr int kBatch = 8;
  const int per = R * C / 4;
  const long i = static_cast<long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (i >= static_cast<long>(bh_count) * per) return;
  const int bh = static_cast<int>(i / per), e = static_cast<int>(i % per);
  const int row = dec_rows > 1 ? 4 * e / C : 0;
  float4* p = reinterpret_cast<float4*>(ws) + static_cast<long>(bh) * n * per
              + e;
  const float* d = dec + static_cast<long>(bh) * n * dec_rows + row;
  float4 s = s_in ? reinterpret_cast<const float4*>(s_in)[i]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g0 = 0; g0 < n; g0 += kBatch) {
    float4 u[kBatch];
    float f[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (g0 + j < n) {
        u[j] = p[static_cast<long>(g0 + j) * per];
        f[j] = d[static_cast<long>(g0 + j) * dec_rows];
      }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (g0 + j < n) {
        const float a = exp2f(f[j]);
        s.x = fmaf(a, s.x, u[j].x);
        s.y = fmaf(a, s.y, u[j].y);
        s.z = fmaf(a, s.z, u[j].z);
        s.w = fmaf(a, s.w, u[j].w);
        p[static_cast<long>(g0 + j) * per] = s;
      }
  }
}

inline int launch_scan(float* ws, const float* dec, const float* s_in,
                       int bh_count, int n, int R, int C, int dec_rows,
                       cudaStream_t stream) {
  const long threads = static_cast<long>(bh_count) * R * C / 4;
  const int blocks = static_cast<int>((threads + kScanThreads - 1)
                                      / kScanThreads);
  state_scan<<<blocks, kScanThreads, 0, stream>>>(ws, dec, s_in, bh_count, n,
                                                  R, C, dec_rows);
  return cudaGetLastError();
}

}  // namespace repro_ssm
