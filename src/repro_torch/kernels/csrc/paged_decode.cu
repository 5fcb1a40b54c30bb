// Paged one-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` / `paged_decode_attention`
// of src/repro/kernels/decode_attention.py (its pallas_call at line 254).
// It computes the same function: for each sequence b and query head h,
// softmax(q . K^T / sqrt(D)) . V over the first lengths[b] KV positions,
// where position p lives in pool frame page_table[b, p / page] at row
// p % page.  Online softmax in f32, bf16 q and store.
//
// Layout: q and out (B, H, D); k_pages / v_pages (N, page, Hkv, D);
// page_table (B, pages_per_seq) int32; lengths (B,) int32.
//
// Entry points: paged_decode_attention_bf16 for a bf16 pool, and _int8 /
// _fp8 for the frames of a quantized pool, which take k_scales /
// v_scales (N, Hkv) f32 and dequantize each element as it is loaded (the
// TPU kernel's quantized instance, its scale BlockSpecs at line 234).
//
// It is the one-row instance (S = 1, one row per block) of the template in
// paged_attention.cuh, which holds the design notes and the bound: one
// block of 128 threads per (KV head, sequence), 64-position tiles through
// the page table, the G query heads of a KV head sharing each staged K/V
// row.  The speculative verify kernel (paged_verify.cu) is the same
// template with S rows, so its row s computes what this kernel computes
// at lengths[:, s], bit for bit.

#include "paged_attention.cuh"

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int batch,
    int num_heads, int num_kv_heads, int head_dim, int page,
    int pages_per_seq, float scale, void* stream) {
  return repro_paged::launch<false, __nv_bfloat16>(
      q, k_pages, v_pages, nullptr, nullptr, page_table, lengths, out, batch,
      1, num_heads, num_kv_heads, head_dim, page, pages_per_seq, scale,
      stream);
}

// The quantized pool's instances: k_scales / v_scales (N, Hkv) f32.
#define REPRO_QUANT_ENTRY(SUFFIX, ELEM)                                       \
  extern "C" int paged_decode_attention_##SUFFIX(                             \
      const void* q, const void* k_pages, const void* v_pages,                \
      const void* k_scales, const void* v_scales, const void* page_table,     \
      const void* lengths, void* out, int batch, int num_heads,               \
      int num_kv_heads, int head_dim, int page, int pages_per_seq,            \
      float scale, void* stream) {                                            \
    return repro_paged::launch<false, ELEM>(                                  \
        q, k_pages, v_pages, k_scales, v_scales, page_table, lengths, out,    \
        batch, 1, num_heads, num_kv_heads, head_dim, page, pages_per_seq,     \
        scale, stream);                                                       \
  }

REPRO_QUANT_ENTRY(int8, int8_t)
REPRO_QUANT_ENTRY(fp8, __nv_fp8_e4m3)
#undef REPRO_QUANT_ENTRY
