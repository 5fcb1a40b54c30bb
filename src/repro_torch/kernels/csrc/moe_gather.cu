// Indexed row gathers for Hopper (sm_90a): the AMU gather pattern.
//
// Replaces the two TPU kernels of src/repro/kernels/moe_gather.py:
//   * gather_rows (`_gather_rows_kernel`, its pallas_call at line 70):
//       out[i] = src[idx[i]] for src (N, d) and idx (M,) int32,
//       M a multiple of rows_per_block.  On the TPU the indices are
//       scalar-prefetched into SMEM before the grid runs (the paper's
//       access-pattern register) and each grid step fills one
//       rows_per_block output block with one start-then-wait DMA per
//       row (aload / getfin on one semaphore).
//   * gather_blocks (`_gather_blocks_kernel`, pallas_call at line 104):
//       output block i (block_rows rows) is src rows
//       [b * block_rows, (b + 1) * block_rows), b = block_idx[i]; the
//       BlockSpec index map reads the prefetched block index, so the
//       TPU pipelines one DMA per block.
// Entry points gather_rows_{f32,bf16} and gather_blocks_{f32,bf16}: a
// gather only moves bits, so the two types differ only in the element
// width and every output bit is a source bit.
//
// Design: a block loads its own indices from global memory (the
// scalar prefetch).  gather_rows runs one block per rows_per_block
// output rows with one warp per row (32 * min(rows_per_block, 8)
// threads; with more rows a warp takes every 8th); a warp copies its
// row with 16-byte loads and stores, neighbouring lanes on neighbouring
// addresses, where the row's bytes and both base pointers are multiples
// of 16 (the wrapper decides), and element by element otherwise.
// gather_blocks runs one block of 256 threads per output block, whose
// block_rows * d elements are one contiguous run in src and in out.
//
// Bound on the card: bytes — each distinct source row read once, every
// output row written once, and the indices: (U + M) * d * itemsize +
// 4 * M for U distinct indices.  No arithmetic.
// This simple version keeps one 16-byte load per lane in flight per
// loop step; overlapping the next row's load with this row's store
// (cp.async or TMA bulk copies, the paper's aload / getfin pipeline) is
// the known next step.  Indices are not checked, as the TPU kernel's
// DMA does not check them: an index outside [0, N) is outside the
// contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRowWarps = 8;
constexpr int kBlockThreads = 256;

// Copy n elements of T from s to o with the threads lane, lane + step,
// ...: as 16-byte vectors when vec (n * sizeof(T) a multiple of 16, s
// and o 16-byte aligned), else one element at a time.
template <typename T>
__device__ __forceinline__ void copy_run(const T* __restrict__ s,
                                         T* __restrict__ o, long long n,
                                         bool vec, int lane, int step) {
  if (vec) {
    const long long nv = n * static_cast<long long>(sizeof(T)) / 16;
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    uint4* ov = reinterpret_cast<uint4*>(o);
#pragma unroll 4
    for (long long j = lane; j < nv; j += step) ov[j] = __ldg(sv + j);
  } else {
    for (long long j = lane; j < n; j += step) o[j] = s[j];
  }
}

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ src,
                                   const int* __restrict__ idx,
                                   T* __restrict__ out, int d, int rpb,
                                   bool vec) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  for (int r = warp; r < rpb; r += warps) {
    const long long i = static_cast<long long>(blockIdx.x) * rpb + r;
    const long long row = idx[i];
    copy_run(src + row * d, out + i * d, d, vec, lane, kWarp);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads) gather_blocks_kernel(
    const T* __restrict__ src, const int* __restrict__ block_idx,
    T* __restrict__ out, long long block_elems, bool vec) {
  const long long b = block_idx[blockIdx.x];
  copy_run(src + b * block_elems,
           out + static_cast<long long>(blockIdx.x) * block_elems,
           block_elems, vec, threadIdx.x, kBlockThreads);
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T>
int launch_rows(const void* src, const void* idx, void* out, int N, int d,
                int M, int rpb, void* stream) {
  if (N <= 0 || d <= 0 || M <= 0 || rpb <= 0 || M % rpb)
    return cudaErrorInvalidValue;
  const bool vec = (static_cast<long long>(d) * sizeof(T)) % 16 == 0
                   && aligned16(src) && aligned16(out);
  const int threads = kWarp * (rpb < kMaxRowWarps ? rpb : kMaxRowWarps);
  gather_rows_kernel<T><<<M / rpb, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const int*>(idx),
      static_cast<T*>(out), d, rpb, vec);
  return cudaGetLastError();
}

template <typename T>
int launch_blocks(const void* src, const void* block_idx, void* out, int N,
                  int d, int Mb, int block_rows, void* stream) {
  if (N <= 0 || d <= 0 || Mb <= 0 || block_rows <= 0 || N % block_rows)
    return cudaErrorInvalidValue;
  const long long block_elems = static_cast<long long>(block_rows) * d;
  const bool vec = (block_elems * static_cast<long long>(sizeof(T))) % 16 == 0
                   && aligned16(src) && aligned16(out);
  gather_blocks_kernel<T><<<Mb, kBlockThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const int*>(block_idx),
      static_cast<T*>(out), block_elems, vec);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_GATHER_ENTRY(SUFFIX, ELEM)                                      \
  extern "C" int gather_rows_##SUFFIX(const void* src, const void* idx,      \
                                      void* out, int N, int d, int M,        \
                                      int rpb, void* stream) {               \
    return launch_rows<ELEM>(src, idx, out, N, d, M, rpb, stream);           \
  }                                                                           \
  extern "C" int gather_blocks_##SUFFIX(const void* src,                     \
                                        const void* block_idx, void* out,    \
                                        int N, int d, int Mb,                \
                                        int block_rows, void* stream) {      \
    return launch_blocks<ELEM>(src, block_idx, out, N, d, Mb, block_rows,    \
                               stream);                                      \
  }

REPRO_GATHER_ENTRY(f32, float)
REPRO_GATHER_ENTRY(bf16, __nv_bfloat16)
#undef REPRO_GATHER_ENTRY

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
