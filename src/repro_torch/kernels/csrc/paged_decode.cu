// Paged one-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` / `paged_decode_attention`
// of src/repro/kernels/decode_attention.py (its pallas_call at line 254).
// It computes the same function: for each sequence b and query head h,
// softmax(q . K^T / sqrt(D)) . V over the first lengths[b] KV positions,
// where position p lives in pool frame page_table[b, p / page] at row
// p % page.  Online softmax in f32, bf16 loads, bf16 store.
//
// Layout: q and out (B, H, D); k_pages / v_pages (N, page, Hkv, D);
// page_table (B, pages_per_seq) int32; lengths (B,) int32.
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
  return repro_paged::launch<false>(q, k_pages, v_pages, page_table, lengths,
                                    out, batch, 1, num_heads, num_kv_heads,
                                    head_dim, page, pages_per_seq, scale,
                                    stream);
}
