// Paged multi-row GQA attention for speculative verify-K decode, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_verify_kernel` / `paged_verify_attention`
// of src/repro/kernels/decode_attention.py (its pallas_call at line 395).
// It computes the same function: for each sequence b, verify row s
// (S = K + 1 rows: the last committed token and K drafts) and query head
// h, softmax(q . K^T / sqrt(D)) . V over the first lengths[b, s] KV
// positions, where position p lives in pool frame page_table[b, p / page]
// at row p % page.  Online softmax in f32, bf16 q and store.  A row
// with lengths[b, s] == 0 returns zeros (the TPU kernel's behaviour; the
// plain version returns a uniform average there, and callers never
// consume such a row).
//
// Layout: q and out (B, S, H, D), the model layout; k_pages / v_pages
// (N, page, Hkv, D); page_table (B, pages_per_seq) int32; lengths (B, S)
// int32; ws the split-KV workspace, B * S * H * n_ranges * (D + 2) f32,
// or null with one range.  Entry points: _bf16, and _int8 / _fp8 for a
// quantized pool with k_scales / v_scales (N, Hkv) f32 (the TPU kernel's
// quantized instance, its scale BlockSpecs at line 377); row s stays
// bitwise the decode entry point of the same element type.  Each call
// enqueues the range kernel and, with more than one range, the combine.
//
// Design: the template of paged_attention.cuh with the S * G query rows
// of a (KV head, sequence) in blocks of up to 16 (15 at G = 3, so one
// block covers all S = 5 rows of a K = 4 verify), split over the same
// ranges of split_positions positions as decode.  Each K/V row a block
// stages in its cp.async ring serves every one of its rows: one pass over
// a range of a sequence's pages verifies K + 1 tokens, as the TPU
// kernel's (S * G, page) score tile does.  A block's tiles run to the
// largest of its rows' lengths and mask each row by its own, with the
// decode kernel's per-row arithmetic in the same order, and the combine
// merges a row's ranges below its own length, so row s here is bitwise
// the decode kernel (paged_decode.cu) at lengths[:, s] whenever the
// caller passes both the same split_positions (the wrapper's
// paged_split_positions gives both the same for one B, Hkv, G and
// capacity).
//
// Bound on the card: bytes, as for decode — the K/V rows up to the
// longest row, read once per (sequence, KV head), against 4 * S * G * D
// flops per position.

#include "paged_attention.cuh"

extern "C" int paged_verify_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* ws,
    int batch, int num_rows, int num_heads, int num_kv_heads, int head_dim,
    int page, int pages_per_seq, int split_positions, float scale,
    void* stream) {
  return repro_paged::launch<__nv_bfloat16>(
      q, k_pages, v_pages, nullptr, nullptr, page_table, lengths, out, ws,
      batch, num_rows, num_heads, num_kv_heads, head_dim, page,
      pages_per_seq, split_positions, scale, stream);
}

// The quantized pool's instances: k_scales / v_scales (N, Hkv) f32.
#define REPRO_QUANT_ENTRY(SUFFIX, ELEM)                                       \
  extern "C" int paged_verify_attention_##SUFFIX(                             \
      const void* q, const void* k_pages, const void* v_pages,                \
      const void* k_scales, const void* v_scales, const void* page_table,     \
      const void* lengths, void* out, void* ws, int batch, int num_rows,      \
      int num_heads, int num_kv_heads, int head_dim, int page,                \
      int pages_per_seq, int split_positions, float scale, void* stream) {    \
    return repro_paged::launch<ELEM>(                                         \
        q, k_pages, v_pages, k_scales, v_scales, page_table, lengths, out,    \
        ws, batch, num_rows, num_heads, num_kv_heads, head_dim, page,         \
        pages_per_seq, split_positions, scale, stream);                       \
  }

REPRO_QUANT_ENTRY(int8, int8_t)
REPRO_QUANT_ENTRY(fp8, __nv_fp8_e4m3)
#undef REPRO_QUANT_ENTRY
