// Split-KV (flash-decoding) partials and their combine, shared by the
// decode attention kernels that split a sequence's positions over blocks.
//
// A kernel that splits the positions [0, valid_len) of each (sequence,
// query head) row into `splits` contiguous ranges runs one block per range
// and writes that range's f32 online-softmax state to a workspace:
//
//   acc [rows][splits][D]  sum over the range of exp(s - m) * v (not
//                          divided by l)
//   m   [rows][splits]     the range's running max of the scaled scores,
//                          the finite sentinel -1e30 where it saw none
//   l   [rows][splits]     sum over the range of exp(s - m); 0 where empty
//
// rows = B * H, row = b * H + h, the layout of a (B, H, D) output.  The
// workspace holds rows * splits * (D + 2) floats: acc, then m, then l.
//
// The combine (combine_kernel) runs one warp per row: M = max_s m_s, then
// in split order w_s = exp(m_s - M), L += l_s * w_s, O += acc_s * w_s, and
// stores O / max(L, 1e-30) in the output's type.  An empty range
// (m_s = -1e30, l_s = 0, acc_s = 0) has weight exactly 0 beside any
// non-empty one, and a row whose every range is empty stores zeros, with
// no NaN.  The order is fixed, so two calls give the same bits.  With one
// range, w = 1 and the result is acc / max(l, 1e-30): the bits of the
// kernel's own unsplit store.
//
// Ranges of a fixed length (the paged kernels, paged_attention.cuh): a
// row of length L merges only its first ceil(L / range) ranges, the ones
// below L, and never reads the others, which a block whose rows are all
// shorter did not write; lengths[row / heads] is the row's length (the
// (B, S) lengths of a (B, S, H, D) output).  L <= 0 merges none and
// stores zeros.  Without lengths (the dense decode) every range merges.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_split {

constexpr float kEmptyMax = -1e30f;   // m of a range that saw no position
constexpr int kCombineWarps = 4;      // warps (rows) per combine block
constexpr int kMaxDimsPerLane = 4;    // D <= 128

// The workspace's three arrays for `rows` rows of `splits` ranges.
struct Partials {
  float* acc;
  float* m;
  float* l;
  __host__ __device__ Partials(float* ws, int rows, int splits, int D)
      : acc(ws),
        m(ws + static_cast<long>(rows) * splits * D),
        l(ws + static_cast<long>(rows) * splits * (D + 1)) {}
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One warp per row: merge the row's `splits` partials, store D outputs.
// lengths: null, or the rows' lengths as above with the range length.
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32) combine_kernel(
    float* __restrict__ ws, T* __restrict__ out, int rows, int splits,
    int D, const int* __restrict__ lengths, int heads, int range) {
  const int row = blockIdx.x * kCombineWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const Partials p(ws, rows, splits, D);
  const long base = static_cast<long>(row) * splits;
  int live = splits;
  if (lengths != nullptr) {
    const int len = lengths[row / heads];
    live = len <= 0 ? 0 : min(splits, (len + range - 1) / range);
  }
  float mx = kEmptyMax;
  for (int s = lane; s < live; s += 32) mx = fmaxf(mx, p.m[base + s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  // ranges in order, 32 at a time: lane j holds range s0 + j's weight and
  // l, shuffled to the warp, so the loop's loads are the acc rows alone,
  // independent of one another and issued several ahead
  float sum = 0.f, o[kMaxDimsPerLane] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < live; s0 += 32) {
    const int mine = s0 + lane;
    const float w_lane = mine < live ? expf(p.m[base + mine] - mx) : 0.f;
    const float l_lane = mine < live ? p.l[base + mine] : 0.f;
    const int n = min(32, live - s0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float wgt = __shfl_sync(0xffffffffu, w_lane, j);
      sum += __shfl_sync(0xffffffffu, l_lane, j) * wgt;
      const float* a = p.acc + (base + s0 + j) * D;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) o[i] += a[d] * wgt;
      }
    }
  }
  const float den = fmaxf(sum, 1e-30f);
  T* dst = out + static_cast<long>(row) * D;
#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) store_out(dst + d, o[i] / den);
  }
}

// Enqueue the combine of `rows` rows on `stream`; with `lengths`, each
// row merges only its ranges of `range` positions below its length.
template <typename T>
cudaError_t launch_combine(float* ws, T* out, int rows, int splits,
                           int D, cudaStream_t stream,
                           const int* lengths = nullptr, int heads = 1,
                           int range = 1) {
  const int blocks = (rows + kCombineWarps - 1) / kCombineWarps;
  combine_kernel<T><<<blocks, kCombineWarps * 32, 0, stream>>>(
      ws, out, rows, splits, D, lengths, heads, range);
  return cudaGetLastError();
}

}  // namespace repro_split
