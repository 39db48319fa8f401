// GQA decode attention over the int8 page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/paged_quant.py:quant_paged_decode_attention
// which gathers int8 pool pages through the prefetched page table and
// dequantizes each (ps, d) tile in VMEM with its (page, KV head) f32 scale
// right before the matrix products.  Here the structure is the f32 paged
// kernel's (paged_decode.cuh): one block per (sequence, KV head), 32-row
// position tiles in order, each row's page looked up once per tile with
// its two scales; a row is dequantized in registers as int8 * scale in
// f32, the reference's product, and full-precision K/V never reach device
// memory.
//
// The current token: the reference's decode writes the new K/V row into
// its dequantized f32 view, attends over that view, and only then
// requantizes the write page.  So the token attends to its own K/V
// unquantized.  Given k_new / v_new (B, K, d) f32 and new_pos (B,), the
// kernel reads those rows in place of pool row new_pos[b] (where that is
// below the length); with null pointers it computes exactly the TPU
// kernel's function.
//
// Bound on the H100: bytes, as for the f32 kernel, with a quarter of the
// pool bytes per row (d bytes per KV head for K and for V, plus a 4-byte
// scale per page and KV head).  The int8 -> f32 conversion and the scale
// multiply are a few integer and f32 operations per element, far under
// the card's rate.

#include "paged_decode.cuh"

// q (B, 1, H, d) bf16; k_pages, v_pages (P, ps, K, d) int8; k_scales,
// v_scales (P, K) f32; k_new, v_new (B, K, d) f32 or null, new_pos (B,)
// int32 (null when k_new is); tables (B, n_table) int32 contiguous;
// lengths (B,) int32; out (B, 1, H, d) bf16; d = 128, unit stride on d.
// strides[16] = q (batch, head), k (page, row, head), v (page, row, head),
// k_scales (page, head), v_scales (page, head), k_new and v_new (batch,
// head), out (batch, head), in elements.  Returns the launch's cudaError_t.
extern "C" int repro_quant_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* k_new,
    const void* v_new, const void* new_pos, const void* tables,
    const void* lengths, void* out, int batch, int n_heads, int n_kv_heads,
    int head_dim, int page_size, int n_table, const int64_t* strides,
    float scale, void* stream) {
  if (n_kv_heads <= 0 || (k_new == nullptr) != (v_new == nullptr) ||
      (k_new != nullptr && new_pos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* st = strides;
  paged::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k_pages;
  a.v = v_pages;
  a.k_scale = static_cast<const float*>(k_scales);
  a.v_scale = static_cast<const float*>(v_scales);
  a.k_new = static_cast<const float*>(k_new);
  a.v_new = static_cast<const float*>(v_new);
  a.new_pos = static_cast<const int*>(new_pos);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.group = n_heads / n_kv_heads;
  a.page_size = page_size;
  a.n_table = n_table;
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_sp = st[2]; a.k_sr = st[3]; a.k_sh = st[4];
  a.v_sp = st[5]; a.v_sr = st[6]; a.v_sh = st[7];
  a.ks_sp = st[8]; a.ks_sh = st[9];
  a.vs_sp = st[10]; a.vs_sh = st[11];
  a.n_sb = st[12]; a.n_sh = st[13];
  a.o_sb = st[14]; a.o_sh = st[15];
  a.scale = scale;
  return paged::launch<true>(a, batch, n_heads, n_kv_heads, head_dim, stream);
}
