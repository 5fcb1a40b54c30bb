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
// Design: the grid comes from the work and the SM count
// (moe_gather.gather_plan, mirrored by `plan_of` below), not from the
// TPU's rows_per_block, which is only checked (M % rows_per_block, as
// the reference asserts).  Each output row of row_bytes bytes is cut
// into pieces of one fixed byte count, a thread a piece, and each
// thread loads its row's index straight into a register (the TPU
// kernel's scalar prefetch, the paper's access-pattern register).  Two
// routes:
//   * vec (16-byte aligned rows and pointers): a 16-byte piece a thread,
//     consecutive threads on consecutive pieces of a row, so a 4 KB row
//     is 256 threads' work and every load of the gather is in flight at
//     once; blocks of 256 threads, fewer (to 32) where that would leave
//     SMs without a block;
//   * elem (a row's bytes or a base pointer off the 16-byte grid): an
//     element a thread.
// gather_blocks is gather_rows over the view (N / block_rows,
// block_rows * d) of src: a block of block_rows rows is one contiguous
// row of that view, in src and in out, so it takes the same plan and
// the same kernel (the paged-KV fetch's 32 KB blocks: 2048 threads each
// on the vec route; tools/gather_sweep.py times blocks of 8 to 64 KB,
// and PERF.md says why no bulk-copy route was tried for them).
// What the plan rests on (tools/gather_sweep.py, cold, on an H100):
// warps of 2 KB pieces with four 16-byte loads a lane in flight and the
// block's indices staged in shared memory behind a barrier ran slower
// than index_select at olmoe's 4 KB rows; and a TMA route, one
// cp.async.bulk global -> shared a 4 KB row completing on an mbarrier
// and one shared -> global after it (aload / getfin on Hopper), was no
// faster than the vec route at any shape of the sweep, olmoe's prefill
// dispatch and combine included, and slower at its decode shapes, so
// the vec route takes every aligned gather.
//
// Bound on the card: bytes — each distinct source row read once, every
// output row written once, and the indices: (U + M) * d * itemsize +
// 4 * M for U distinct indices.  No arithmetic.
// Indices are not checked, as the TPU kernel's DMA does not check them:
// an index outside [0, N) is outside the contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// the plan (moe_gather.gather_plan mirrors these)
constexpr int kMaxThreads = 256;         // most threads a block
constexpr int kMinThreads = 32;

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// The plan of a gather of M rows of row_bytes bytes (moe_gather.
// gather_plan): its route (vec or elem), pieces a row, pieces, threads
// a block and blocks.
struct Plan {
  bool vec;
  long long per_row;
  long long pieces;
  long long threads;
  long long blocks;
};

Plan plan_of(long long M, long long row_bytes, long long elem_bytes, int sms,
             bool aligned) {
  Plan p;
  p.vec = aligned && row_bytes % 16 == 0;
  p.per_row = row_bytes / (p.vec ? 16 : elem_bytes);
  p.pieces = M * p.per_row;
  p.threads = kMaxThreads;
  while (p.threads > kMinThreads
         && (p.pieces + p.threads - 1) / p.threads < sms)
    p.threads /= 2;
  p.blocks = (p.pieces + p.threads - 1) / p.threads;
  return p;
}

// Thread u copies piece u, a W (16 bytes, or one element's bits) of row
// u / per_row.
template <typename W>
__global__ void __launch_bounds__(kMaxThreads) gather_rows_kernel(
    const W* __restrict__ src, const int* __restrict__ idx,
    W* __restrict__ out, unsigned per_row, unsigned pieces) {
  const unsigned u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= pieces) return;
  const unsigned row = u / per_row, col = u - row * per_row;
  out[u] = __ldg(src + static_cast<long long>(__ldg(idx + row)) * per_row
                 + col);
}

// The plan's sm count: the current device's, read once per device.
int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cache[dev] > 0) return cache[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
      != cudaSuccess)
    return 0;
  if (dev < 64) cache[dev] = n;
  return n;
}

// A gather of M rows of row_elems elements of T: its plan, its launch.
template <typename T>
int launch_gather(const void* src, const void* idx, void* out,
                  long long row_elems, long long M, void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const Plan p = plan_of(M, row_elems * static_cast<long long>(sizeof(T)),
                         sizeof(T), sms, aligned16(src) && aligned16(out));
  if (p.pieces > 0xffffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned>(p.blocks);
  const auto threads = static_cast<int>(p.threads);
  const auto per_row = static_cast<unsigned>(p.per_row);
  const auto pieces = static_cast<unsigned>(p.pieces);
  using Bits = typename std::conditional<sizeof(T) == 2, unsigned short,
                                         unsigned int>::type;
  if (p.vec) {
    gather_rows_kernel<uint4><<<blocks, threads, 0, s>>>(
        static_cast<const uint4*>(src), static_cast<const int*>(idx),
        static_cast<uint4*>(out), per_row, pieces);
  } else {
    gather_rows_kernel<Bits><<<blocks, threads, 0, s>>>(
        static_cast<const Bits*>(src), static_cast<const int*>(idx),
        static_cast<Bits*>(out), per_row, pieces);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_rows(const void* src, const void* idx, void* out, int N, int d,
                int M, int rpb, void* stream) {
  if (N <= 0 || d <= 0 || M <= 0 || rpb <= 0 || M % rpb)
    return cudaErrorInvalidValue;
  return launch_gather<T>(src, idx, out, d, M, stream);
}

// Block i of out is row block_idx[i] of src's (N / block_rows,
// block_rows * d) view.
template <typename T>
int launch_blocks(const void* src, const void* block_idx, void* out, int N,
                  int d, int Mb, int block_rows, void* stream) {
  if (N <= 0 || d <= 0 || Mb <= 0 || block_rows <= 0 || N % block_rows)
    return cudaErrorInvalidValue;
  return launch_gather<T>(src, block_idx, out,
                          static_cast<long long>(block_rows) * d, Mb, stream);
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
