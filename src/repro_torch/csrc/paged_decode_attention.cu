// GQA decode attention over the f32 page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/paged.py:paged_decode_attention
// whose grid (B, K, nP) walks a sequence's pages sequentially, the page
// table arriving as a scalar-prefetch operand that the K/V index maps use
// to fetch one (ps, d) pool page per grid step.  Here one block owns one
// (sequence, KV head) and walks its positions in 32-row tiles, looking up
// each row's page itself (paged_decode.cuh); every row it reads serves all
// G query heads.  The tile order does not follow the pages, so the page
// size never changes the arithmetic: on the same rows the result is
// bit-equal to decode_attention.cu's.
//
// Inputs: q (B, 1, H, d) bf16; the model-layout pool (P, ps, K, d) f32 of
// one layer (bf16-rounded values in f32, as the reference's pool holds);
// tables (B, nP) int32; lengths (B,) int32 in [1, nP * ps].  Output
// (B, 1, H, d) bf16.  Scores, softmax and P V are f32 FMA.
//
// Bound on the H100: each visible row is read once (2 x d x 4 bytes per
// KV head) for 4 d FLOPs per (query head, key) pair, far below the card's
// operations-per-byte balance, so it is bound by bytes; an aliased page
// is read once per sequence that holds it (once from device memory, then
// mostly from L2).  As for the contiguous kernel, the (B, K) grid of 128
// blocks at B = 16 leaves the memory system underused at long lengths;
// splitting the positions across blocks is the next step.

#include "paged_decode.cuh"

// q (B, 1, H, d) bf16; k_pages and v_pages (P, ps, K, d) f32; tables
// (B, n_table) int32 contiguous; lengths (B,) int32; out (B, 1, H, d)
// bf16; d = 128, unit stride on d everywhere.
// strides[10] = q (batch, head), k (page, row, head), v (page, row, head),
// out (batch, head), in elements.  Returns the launch's cudaError_t.
extern "C" int repro_paged_decode_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int batch,
    int n_heads, int n_kv_heads, int head_dim, int page_size, int n_table,
    const int64_t* strides, float scale, void* stream) {
  if (n_kv_heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* st = strides;
  paged::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const float*>(k_pages);
  a.v = static_cast<const float*>(v_pages);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.group = n_heads / n_kv_heads;
  a.page_size = page_size;
  a.n_table = n_table;
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_sp = st[2]; a.k_sr = st[3]; a.k_sh = st[4];
  a.v_sp = st[5]; a.v_sr = st[6]; a.v_sh = st[7];
  a.o_sb = st[8]; a.o_sh = st[9];
  a.scale = scale;
  return paged::launch(a, batch, n_heads, n_kv_heads, head_dim, stream);
}
