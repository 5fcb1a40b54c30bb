// Chunk-parallel Mamba2 SSD for Hopper (sm_90a), its products on the
// tensor cores.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd` of
// src/repro/kernels/mamba2.py (its pallas_call at line 93).  Same
// function: per batch row b and head h, with one scalar decay per head
// and step,
//   S_t = e^{-A_h dt_t} S_{t-1} + dt_t B_t x_t^T,   S_0 = s_in or 0 (N x P,
//   f32), y_t = C_t^T S_t + D_h x_t.
// Entry points ssd_f32 and ssd_bf16: x, B, C and y of that type; dt, A and
// D f32 (in the model dt is a softplus in f32 and A, D are f32 params).
// Their last two arguments carry the state across calls (a prompt served
// in chunks): s_in, the initial state S_0 (B, H, N, P) f32, and s_out,
// where the final state S_T goes, (B, H, N, P) f32; either may be null
// (S_0 = 0; no final state).
//
// Layout: the model layout, read in place: x and y (B, T, H, P), dt
// (B, T, H), B and C (B, T, N) shared by all heads, A and D (H,).
//
// Design: the Mamba-2 paper's block decomposition (mamba_ssm's
// chunk_state, state_passing and chunk_scan).  The sequence is cut into
// pieces of `rows` rows (the chunk or a divisor of it) and the pieces into
// segments of `seg`, as the plan mamba2.ssd_plan sets
// (build.recurrence_plan).  Inside a piece, with L the inclusive
// cumulative sum of -A_h dt (0 before it; the kernel keeps it in base 2,
// L log2(e), and takes 2^x in one MUFU op):
//   inter-piece  y_t += e^{L_t} (C_t . S_in)
//   intra-piece  y_t += sum_{s <= t} (C_t . B_s) e^{min(L_t - L_s, 0)}
//                       dt_s x_s
//   skip         y_t += D_h x_t
//   state        S_out = e^{L_last} S_in + (B * e^{L_last - L} dt)^T x.
// One call enqueues three kernels on the stream:
//   (A) C B^T of every piece, once per (batch row, piece) for all heads
//       (lower 16-row strips, into a workspace), and in the same launch
//       one block per (segment but the last, head, batch row): the state
//       its segment builds from zero and its log decay;
//   (B) repro_ssm::state_scan: S_{g+1} = e^{d_g} S_g + U_g in place;
//   (C) one block per (segment, head, batch row): its outputs, from the
//       state entering it, carried through its pieces.
// With one segment (B) is skipped and (A) computes C B^T alone.  With
// s_in, (B) starts from it and the first segment of (C) enters with it.
// With s_out, a fourth kernel, (A)'s body as an instance of its own, runs
// after (C): a block per (head, batch row) over the last segment from the
// state entering it (the scan's, or s_in), writing S_T straight into
// s_out.  The plan and the workspace stay as they are, and (A) and (C),
// at the 128 registers of two blocks an SM, carry none of its code.  At
// zamba2-1.2b's width (B 1, T 2048, H 64, chunk 128) the plan takes
// pieces of 64 rows (two blocks an SM) and segments of 4: 512 blocks of
// (C), where the kernel before them ran 128 blocks that each walked 16
// chunks in turn and recomputed C B^T per head and per state slice.
//
// Inside a piece (8 warps, a warp's mma rows a sub-chunk of 16; P in {32,
// 64, 128} and N in {16, 32, 64, 128} are template constants): the tiles
// by cp.async (f32) or 8-byte loads widened in registers (bf16), all in
// flight together; L by one warp's shuffle scan; y = e^{L} (C . S) + M .
// x + D x with M = C B^T * e^{min(L_t - L_s, 0)} dt_s below the diagonal,
// formed as the A operand is read, and U = (B e^{L_last - L} dt)^T x, on
// the tensor cores (repro_ssm::warp_mma); every exponent <= 0.  Products
// are 3xTF32; x, B and C are exact in TF32 in the bf16 instance, so C B^T
// there is one product and those with x or C two (ssm_chunks.cuh).
//
// Bound on the card: bytes (x, B, C, dt read once, y written once: ~34
// MB at zamba2-1.2b's T = 2048; the chunked form's products take less
// time at the bf16 tensor rate).  The
// limiter: (C)'s products, M . x with its exponential per entry the
// largest, each block serial in its phases at two blocks an SM; then the
// state updates of (A) and (C).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "dense_io.cuh"
#include "ssm_chunks.cuh"

namespace {

using namespace repro_ssm;

template <typename T>
struct Args {
  const T* x;
  const float* dt;
  const float* A;
  const T* Bm;
  const T* Cm;
  const float* D;
  T* out;
  float* cb;        // (B, pieces, cp, cp): C B^T of each piece
  float* states;    // (B, H, segments - 1, N, P)
  float* decays;    // (B, H, segments - 1)
  const float* s_in;   // (B, H, N, P) initial state, or null (zero)
  float* s_out;        // (B, H, N, P) final state, or null (not asked for)
  int T_len, H, rows, seg, nseg, pieces, n_cb;
};

// Shared memory of a block, in floats: x and the state at P + 8 floats a
// row, L and dt, B at N + 8 where the state is updated, C at N + 4 and
// C B^T at cp + 4 where outputs are made.  A C B^T block of (A) holds C
// and B at N + 4.  mamba2.ssd_smem mirrors it.
struct Layout {
  int sx, sb, sc, scb, x, s, l, dt, b, c, cb, total;
  __host__ __device__ Layout(int P, int N, int cp, bool outputs,
                             bool update) {
    sx = stride_b(P);
    sb = stride_b(N);
    sc = stride_a(N);
    scb = stride_a(cp);
    x = 0;
    s = x + cp * sx;
    l = s + N * sx;
    dt = l + cp;
    b = dt + cp;
    c = b + (update ? cp * sb : 0);
    cb = c + (outputs ? cp * sc : 0);
    total = cb + (outputs ? cp * scb : 0);
  }
  __host__ __device__ static int cb_block(int N, int cp) {
    return 2 * cp * stride_a(N);
  }
};

// L = cumsum(-A dt) log2(e) (base 2) over the piece's cp rows (dt = 0
// past the piece), by warp 0: a lane sums its run of rows, a shuffle scan
// joins the runs.
__device__ __forceinline__ void scan_l(float* l, const float* dts, float A,
                                       int cp) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, per = (cp + 31) / 32, r0 = lane * per;
  float run = 0.f, v[kMaxRows / 32];
#pragma unroll
  for (int j = 0; j < kMaxRows / 32; ++j)
    if (j < per && r0 + j < cp) {
      run += -A * dts[r0 + j] * kLog2e;
      v[j] = run;
    }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const float base = incl - run;
#pragma unroll
  for (int j = 0; j < kMaxRows / 32; ++j)
    if (j < per && r0 + j < cp) l[r0 + j] = base + v[j];
}

// The piece's dt column into shared memory, zero past the piece.
__device__ __forceinline__ void stage_dt(float* dts, const float* dt,
                                         long row0, int H, int h, int rows,
                                         int cp) {
  for (int t = threadIdx.x; t < cp; t += kThreads)
    dts[t] = t < rows ? dt[(row0 + t) * H + h] : 0.f;
}

// C B^T of piece pc of batch row b: the lower 16-row strips (columns up
// to the end of each row's sub-chunk), a warp a (strip, 8 kGroup columns)
// unit.
template <typename T, int N>
__device__ void cb_block(const Args<T>& a, float* sm, int b, int pc) {
  constexpr bool kSplit = !std::is_same<T, __nv_bfloat16>::value;
  constexpr int sn = stride_a(N);
  const int cp = round16(a.rows);
  float* const cs = sm;
  float* const bs = sm + cp * sn;
  const long row0 = static_cast<long>(b) * a.T_len
                    + static_cast<long>(pc) * a.rows;
  {
    Stager<N, T> tc, tb;
    tc.load(cs, sn, a.Cm + row0 * N, N, cp, a.rows);
    tb.load(bs, sn, a.Bm + row0 * N, N, cp, a.rows);
    tc.store();
    tb.store();
  }
  staged();
  float* const dst = a.cb + (static_cast<long>(b) * a.pieces + pc) * cp * cp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lg = lane / 4, lt = lane % 4;
  for (int i = cp / kSub - 1, unit = 0; i >= 0; --i) {
    const int tb = kSub * i;
    for (int n0 = 0; n0 < tb + kSub; n0 += 8 * kGroup, ++unit) {
      if (unit % kWarps != warp) continue;
      float acc[kGroup][4];
      zero(acc);
      warp_mma<kSplit, kSplit>(
          acc, min(kGroup, (tb + kSub - n0) / 8), N,
          [&](int row, int d) { return cs[(tb + row) * sn + d]; },
          [&](int d, int col) { return bs[(n0 + col) * sn + d]; });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* row = dst + (tb + lg + 8 * hh) * cp + n0 + 2 * lt;
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (n0 + 8 * j < tb + kSub)
            store2(row + 8 * j, acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
    }
  }
}

// (A) for blocks past the C B^T ones (kOut false), (C) (kOut true): the
// pieces of segment g of head h of batch row b.  kFinal: (A)'s body over
// the last segment, a block per (head, batch row), from the state entering
// it, into s_out (a template constant: (A) and (C) carry none of it).
template <typename T, bool kOut, int P, int N, bool kFinal = false>
__global__ void __launch_bounds__(kThreads, 2) ssd_pieces(Args<T> a) {
  constexpr bool kSplit = !std::is_same<T, __nv_bfloat16>::value;
  constexpr int sx = stride_b(P), sb = stride_b(N), sc = stride_a(N);
  extern __shared__ __align__(16) float sm[];
  int g, h, b;
  if (kOut) {
    g = blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
  } else if (kFinal) {
    g = a.nseg - 1;
    h = blockIdx.x % a.H;
    b = blockIdx.x / a.H;
  } else {
    if (static_cast<int>(blockIdx.x) < a.n_cb) {
      cb_block<T, N>(a, sm, blockIdx.x / a.pieces, blockIdx.x % a.pieces);
      return;
    }
    const int idx = blockIdx.x - a.n_cb, n = a.nseg - 1;
    g = idx % n;
    h = (idx / n) % a.H;
    b = idx / (n * a.H);
  }
  const int cp = round16(a.rows);
  const bool update = !kOut || a.seg > 1;
  const Layout L(P, N, cp, kOut, update);
  const int scb = L.scb;
  float* const xs = sm + L.x;
  float* const S = sm + L.s;
  float* const ls = sm + L.l;
  float* const dts = sm + L.dt;
  float* const bs = sm + L.b;
  float* const cs = sm + L.c;
  float* const cbs = sm + L.cb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lg = lane / 4, lt = lane % 4;
  const long ldx = static_cast<long>(a.H) * P;
  const long slot = (static_cast<long>(b) * a.H + h) * (a.nseg - 1);
  const float Ah = a.A[h], Dh = a.D[h];
  const int nsub = cp / kSub;
  constexpr int kCols = 8 * kGroup, kGroups = P / kCols;
  // the state entering the segment: (C) and the final pass start from
  // it, (A)'s segments from zero
  constexpr bool enter = kOut || kFinal;

  if (enter && g > 0)
    load_block<P>(S, sx, a.states + (slot + g - 1) * N * P, N);
  else if (enter && a.s_in != nullptr)
    load_block<P>(S, sx, a.s_in + (static_cast<long>(b) * a.H + h) * N * P,
                  N);
  else
    zero_block<P>(S, sx, N);
  float lsum = 0.f;   // (A): the segment's log decay, in thread 0

  for (int p = 0; p < a.seg; ++p) {
    const int pc = g * a.seg + p;
    const long row0 = static_cast<long>(b) * a.T_len
                      + static_cast<long>(pc) * a.rows;
    const long rx = row0 * ldx + static_cast<long>(h) * P;
    __syncthreads();   // the previous piece is done with every tile
    {
      Stager<P, T> tx;
      Stager<N, T> tb, tc;
      tx.load(xs, sx, a.x + rx, ldx, cp, a.rows);
      if (update) tb.load(bs, sb, a.Bm + row0 * N, N, cp, a.rows);
      if (kOut) {
        tc.load(cs, sc, a.Cm + row0 * N, N, cp, a.rows);
        // the piece's C B^T (cp x cp, dense), 16 bytes a thread at a time
        const float* cb = a.cb + (static_cast<long>(b) * a.pieces + pc) * cp
                                 * cp;
        const int q = cp / 4, c = 4 * (threadIdx.x % q);
        for (int r = threadIdx.x / q; r < cp; r += kThreads / q)
          cp_async16(cbs + r * scb + c, cb + r * cp + c, true);
      }
      stage_dt(dts, a.dt, row0, a.H, h, a.rows, cp);
      tx.store();
      if (update) tb.store();
      if (kOut) tc.store();
    }
    staged();
    scan_l(ls, dts, Ah, cp);
    __syncthreads();
    const float l_last = ls[cp - 1];

    if (kOut) {
      const bool state_in = g > 0 || p > 0 || a.s_in != nullptr;
      // y = e^{L} (C . S_in) + M . x + D x, a warp a row sub-chunk and 32
      // columns
      for (int unit = warp; unit < nsub * kGroups; unit += kWarps) {
        const int i = unit / kGroups, n0 = (unit % kGroups) * kCols;
        const int tb = kSub * i;
        float acc[kGroup][4];
        zero(acc);
        if (state_in) {
          warp_mma<kGroup, kSplit, true>(
              acc, N,
              [&](int row, int d) { return cs[(tb + row) * sc + d]; },
              [&](int d, int col) { return S[d * sx + n0 + col]; });
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float f = ex2(ls[tb + lg + 8 * (e / 2)]);
#pragma unroll
            for (int j = 0; j < kGroup; ++j) acc[j][e] *= f;
          }
        }
        warp_mma<kGroup, true, kSplit>(
            acc, tb + kSub,
            [&](int row, int s) {
              const int t = tb + row;
              return s <= t ? cbs[t * scb + s]
                                  * ex2(fminf(ls[t] - ls[s], 0.f)) * dts[s]
                            : 0.f;
            },
            [&](int s, int col) { return xs[s * sx + n0 + col]; });
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = tb + lg + 8 * hh;
          if (t < a.rows) {
            const float* xt = xs + t * sx + n0 + 2 * lt;
            T* dst = a.out + rx + t * ldx + n0 + 2 * lt;
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              store2(dst + 8 * j, acc[j][2 * hh] + Dh * xt[8 * j],
                     acc[j][2 * hh + 1] + Dh * xt[8 * j + 1]);
          }
        }
      }
    }
    if (update && (!kOut || p + 1 < a.seg)) {
      if (kOut) __syncthreads();   // every output has read S_in
      // S = e^{L_last} S + (B e^{L_last - L} dt)^T x, a warp 16 state rows
      // and 32 columns
      const float decay = ex2(l_last);
      for (int unit = warp; unit < (N / kSub) * kGroups; unit += kWarps) {
        const int m0 = kSub * (unit / kGroups);
        const int n0 = (unit % kGroups) * kCols;
        float acc[kGroup][4];
        zero(acc);
        warp_mma<kGroup, true, kSplit>(
            acc, cp,
            [&](int row, int s) {
              return bs[s * sb + m0 + row] * (ex2(l_last - ls[s]) * dts[s]);
            },
            [&](int s, int col) { return xs[s * sx + n0 + col]; });
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float* row = S + (m0 + lg + 8 * hh) * sx + n0 + 2 * lt;
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            row[8 * j] = fmaf(decay, row[8 * j], acc[j][2 * hh]);
            row[8 * j + 1] = fmaf(decay, row[8 * j + 1], acc[j][2 * hh + 1]);
          }
        }
      }
      lsum += l_last;
    }
  }
  if (!kOut) {
    __syncthreads();
    if (kFinal) {
      store_block<P>(a.s_out + (static_cast<long>(b) * a.H + h) * N * P, S,
                     sx, N);
    } else {
      store_block<P>(a.states + (slot + g) * N * P, S, sx, N);
      if (threadIdx.x == 0) a.decays[slot + g] = lsum;
    }
  }
}

template <typename T, bool kOut, int P, int N, bool kFinal = false>
int launch_phase(const Args<T>& a, dim3 grid, size_t smem,
                 cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_pieces<T, kOut, P, N, kFinal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_pieces<T, kOut, P, N, kFinal><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int P, int N>
int launch_widths(const Args<T>& a, int batch, cudaStream_t s) {
  const int cp = round16(a.rows);
  const long slots = static_cast<long>(batch) * a.H * (a.nseg - 1);
  const int state_floats = a.nseg > 1
      ? Layout(P, N, cp, false, true).total : 0;
  const int first = Layout::cb_block(N, cp) > state_floats
                    ? Layout::cb_block(N, cp) : state_floats;
  int err = launch_phase<T, false, P, N>(
      a, dim3(a.n_cb + static_cast<int>(slots)), sizeof(float) * first, s);
  if (err) return err;
  if (a.nseg > 1) {
    err = launch_scan(a.states, a.decays, a.s_in, batch * a.H, a.nseg - 1, N,
                      P, 1, s);
    if (err) return err;
  }
  err = launch_phase<T, true, P, N>(
      a, dim3(a.nseg, a.H, batch),
      sizeof(float) * Layout(P, N, cp, true, a.seg > 1).total, s);
  if (err || a.s_out == nullptr) return err;
  return launch_phase<T, false, P, N, true>(
      a, dim3(batch * a.H),
      sizeof(float) * Layout(P, N, cp, false, true).total, s);
}

// The instance of the widths: P 32, 64 or 128, N 16, 32, 64 or 128.
template <typename T, int P>
int launch_n(const Args<T>& a, int N, int batch, cudaStream_t s) {
  switch (N) {
    case 16: return launch_widths<T, P, 16>(a, batch, s);
    case 32: return launch_widths<T, P, 32>(a, batch, s);
    case 64: return launch_widths<T, P, 64>(a, batch, s);
    case 128: return launch_widths<T, P, 128>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* out, void* ws, int batch,
           int T_len, int H, int P, int N, int rows, int seg, void* stream,
           const void* s_in, void* s_out) {
  if (batch <= 0 || T_len <= 0 || H <= 0 || rows <= 0 || rows > kMaxRows
      || seg <= 0 || T_len % (rows * seg) || ws == nullptr)
    return cudaErrorInvalidValue;
  const int cp = round16(rows), pieces = T_len / rows;
  const int nseg = pieces / seg;
  Args<T> a{static_cast<const T*>(x), static_cast<const float*>(dt),
            static_cast<const float*>(A), static_cast<const T*>(Bm),
            static_cast<const T*>(Cm), static_cast<const float*>(D),
            static_cast<T*>(out), static_cast<float*>(ws), nullptr, nullptr,
            static_cast<const float*>(s_in), static_cast<float*>(s_out),
            T_len, H, rows, seg, nseg, pieces, batch * pieces};
  a.states = a.cb + static_cast<long>(batch) * pieces * cp * cp;
  a.decays = a.states + static_cast<long>(batch) * H * (nseg - 1) * N * P;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 32: return launch_n<T, 32>(a, N, batch, s);
    case 64: return launch_n<T, 64>(a, N, batch, s);
    case 128: return launch_n<T, 128>(a, N, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define REPRO_SSD_ENTRY(SUFFIX, ELEM)                                         \
  extern "C" int ssd_##SUFFIX(const void* x, const void* dt, const void* A,  \
                              const void* Bm, const void* Cm, const void* D, \
                              void* out, void* ws, int batch, int T, int H,  \
                              int P, int N, int rows, int seg,               \
                              void* stream, const void* s_in,                \
                              void* s_out) {                                 \
    return launch<ELEM>(x, dt, A, Bm, Cm, D, out, ws, batch, T, H, P, N,     \
                        rows, seg, stream, s_in, s_out);                     \
  }

REPRO_SSD_ENTRY(f32, float)
REPRO_SSD_ENTRY(bf16, __nv_bfloat16)
#undef REPRO_SSD_ENTRY
