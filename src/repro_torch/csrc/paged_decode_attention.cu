// GQA decode attention over the f32 page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/paged.py:paged_decode_attention
// whose grid (B, K, nP) walks a sequence's pages sequentially, the page
// table arriving as a scalar-prefetch operand that the K/V index maps use
// to fetch one (ps, d) pool page per grid step.  Here the positions are
// split over blocks: the span split of split_decode.cuh, shared with the
// contiguous kernel (decode_attention.cu), with position p of sequence b
// at row tables[b][p / ps] * k_sp + (p % ps) * k_sr + kh * k_sh.  Spans do
// not follow pages, so the page size never changes the arithmetic: on the
// same rows the result is bit-equal to decode_attention.cu's (DESIGN.md
// section 8's page-size invariance).  The int8 pool has its own kernel
// (quant_paged_decode_attention.cu).
//
// Inputs: q (B, 1, H, d) bf16; the model-layout pool (P, ps, K, d) f32 of
// one layer (bf16-rounded values in f32, as the reference's pool holds);
// tables (B, nP) int32; lengths (B,) int32 in [1, nP * ps].  Output
// (B, 1, H, d) bf16.  Scores, softmax and P V are f32 FMA.  Table entries
// past ceil(length / ps) are padding: they must be valid page ids and are
// never read.  Pages may appear in several tables (prefix sharing); the
// kernel only reads them.  Lengths above nP * ps are read as nP * ps, which
// is what the plain version's mask does.
//
// Bound on the H100: bytes, each distinct visible pool row once (2 x d x 4
// bytes per KV head); an aliased page is read once per sequence that holds
// it, from L2 after the first.  At the main path's lengths (16 sequences
// of ~500 positions sharing a 29-page header) the distinct rows are ~7.7
// MB and stay in L2, so latency, not bandwidth, held the kernel this
// replaced at 53x its bound: 128 blocks, one per (sequence, KV head), each
// walking 16 tiles in a row with the table -> address -> K latency and
// three barriers in every tile.  Now every page id of a span is loaded at
// the top, all together, before any copy; the span split puts 512 blocks
// in flight there, with K and V copied ahead by cp.async.

#include "split_decode.cuh"

using split_decode::Args;

// q (B, 1, H, d) bf16; k_pages and v_pages (P, ps, K, d) f32 with 16-byte
// aligned rows; tables (B, n_table) int32 contiguous; lengths (B,) int32;
// out (B, 1, H, d) bf16; d = 128, unit stride on d everywhere.  strides[10]
// = q (batch, head), k (page, row, head), v (page, row, head), out (batch,
// head), in elements.  scratch: at least B * K * ceil(n_table * ps / span)
// * G * (d + 2) f32, 16-byte aligned; arrivals: at least B * K uint32,
// zero (the kernel leaves them zero).  One launch on `stream`; returns its
// cudaError_t.
extern "C" int repro_paged_decode_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int batch,
    int n_heads, int n_kv_heads, int head_dim, int page_size, int n_table,
    const int64_t* strides, float scale, void* scratch, int64_t scratch_floats,
    void* arrivals, int64_t n_arrivals, void* stream) {
  const int64_t limit = static_cast<int64_t>(n_table) * page_size;
  if (n_kv_heads <= 0 || page_size <= 0 || n_table <= 0 || limit > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* st = strides;
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const float*>(k_pages);
  a.v = static_cast<const float*>(v_pages);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.group = n_heads / n_kv_heads;
  a.n_kv = n_kv_heads;
  a.limit = static_cast<int>(limit);
  a.page_size = page_size;
  a.n_table = n_table;
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_s0 = st[2]; a.k_s1 = st[3]; a.k_s2 = st[4];
  a.v_s0 = st[5]; a.v_s1 = st[6]; a.v_s2 = st[7];
  a.o_sb = st[8]; a.o_sh = st[9];
  a.scale = scale;
  return split_decode::launch<true, 128>(a, batch, n_heads, head_dim, scratch,
                                    scratch_floats, arrivals, n_arrivals, stream);
}

// The paged split kernel's figures (see repro_decode_kernel_info): for G <=
// 4, or for G <= 8 where gm8 is non-zero.
extern "C" int repro_paged_decode_kernel_info(int gm8, int* regs, int* local_bytes,
                                              int* smem_bytes, int* blocks_per_sm) {
  return gm8 ? split_decode::kernel_info<true, 8, 128>(regs, local_bytes, smem_bytes,
                                                  blocks_per_sm)
             : split_decode::kernel_info<true, 4, 128>(regs, local_bytes, smem_bytes,
                                                  blocks_per_sm);
}
