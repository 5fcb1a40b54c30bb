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
// int32.  Entry points: _bf16, and _int8 / _fp8 for a quantized pool with
// k_scales / v_scales (N, Hkv) f32 (the TPU kernel's quantized instance,
// its scale BlockSpecs at line 377); row s stays bitwise the decode entry
// point of the same element type.
//
// Design: the template of paged_attention.cuh with SB whole verify rows
// per block (SB * G <= 16 query rows, SB = 5 at G = 3, so one block covers
// all S = 5 rows of a K = 4 verify).  Each K/V row the block stages
// serves every one of its rows: one pass over a sequence's pages verifies
// K + 1 tokens, as the TPU kernel's (S * G, page) score tile does.  The
// tile loop runs to the largest row length and masks each row by its own,
// with the decode kernel's per-row arithmetic in the same order, so row s
// here is bitwise the decode kernel (paged_decode.cu) at lengths[:, s].
//
// Bound on the card: bytes, as for decode — the K/V rows up to the
// longest row, read once per (sequence, KV head), against 4 * S * G * D
// flops per position.  Parallelism limits this simple version as it does
// decode (B * Hkv blocks); split-KV is the known next step for both.

#include "paged_attention.cuh"

extern "C" int paged_verify_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int batch,
    int num_rows, int num_heads, int num_kv_heads, int head_dim, int page,
    int pages_per_seq, float scale, void* stream) {
  return repro_paged::launch<true, __nv_bfloat16>(
      q, k_pages, v_pages, nullptr, nullptr, page_table, lengths, out, batch,
      num_rows, num_heads, num_kv_heads, head_dim, page, pages_per_seq, scale,
      stream);
}

// The quantized pool's instances: k_scales / v_scales (N, Hkv) f32.
#define REPRO_QUANT_ENTRY(SUFFIX, ELEM)                                       \
  extern "C" int paged_verify_attention_##SUFFIX(                             \
      const void* q, const void* k_pages, const void* v_pages,                \
      const void* k_scales, const void* v_scales, const void* page_table,     \
      const void* lengths, void* out, int batch, int num_rows, int num_heads, \
      int num_kv_heads, int head_dim, int page, int pages_per_seq,            \
      float scale, void* stream) {                                            \
    return repro_paged::launch<true, ELEM>(                                   \
        q, k_pages, v_pages, k_scales, v_scales, page_table, lengths, out,    \
        batch, num_rows, num_heads, num_kv_heads, head_dim, page,             \
        pages_per_seq, scale, stream);                                        \
  }

REPRO_QUANT_ENTRY(int8, int8_t)
REPRO_QUANT_ENTRY(fp8, __nv_fp8_e4m3)
#undef REPRO_QUANT_ENTRY
