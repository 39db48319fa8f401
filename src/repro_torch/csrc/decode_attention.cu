// GQA decode attention over the contiguous f32 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:decode_attention
// whose grid (B, K, nS) walks cache tiles sequentially and keeps the online-
// softmax state of a whole query-head group in VMEM scratch.  Here the
// positions are split over blocks instead: the span split of
// split_decode.cuh, shared with the paged kernel (paged_decode_attention.cu),
// with position p of sequence b at row b * k_sb + p * k_ss + kh * k_sh.
//
// Inputs: q (B, 1, H, d) bf16, cache (B, S, K, d) f32 (the serving cache
// holds bf16-rounded values in f32, as the JAX package's does), lengths (B,)
// int32 in [1, S].  Output (B, 1, H, d) bf16.  Scores, softmax and the P V
// sum are f32 FMA: G is too small for a tensor-core tile, and the rows are
// not bf16-representable in general.
//
// Bound on the H100: bytes.  Decode reads each visible cache row once (2 x
// d x 4 bytes per row per KV head) for 4 d FLOPs per (query head, key)
// pair, far below the card's operations-per-byte balance.  What held the
// kernel this replaced far above that bound (0.35 ms at ragged lengths
// 1..1,024 against 0.021): one block per (sequence, KV head), 128 blocks
// at B = 16 and K = 8, each walking its positions in 32-row tiles with
// three barriers a tile, nothing fetched ahead, and P V reading V as one
// dependent 4-byte load a row.  Now: a block per span of 128 positions
// (up to 8x the blocks), three blocks an SM, every row of a span copied
// ahead with cp.async and V in flight while K is scored, 16-byte V loads
// in P V, and one launch a call (the combine is the last block's).

#include "split_decode.cuh"

using split_decode::Args;

// q (B, 1, H, d) bf16; k_cache and v_cache (B, S, K, d) f32 with 16-byte
// aligned rows; lengths (B,) int32 in [1, S]; out (B, 1, H, d) bf16; d =
// 128, unit stride on d everywhere.  strides[10] = q (batch, head), k
// (batch, seq, head), v (batch, seq, head), out (batch, head), in
// elements.  scratch: at least B * K * ceil(S / span) * G * (d + 2) f32,
// 16-byte aligned; arrivals: at least B * K uint32, zero (the kernel leaves
// them zero).  One launch on `stream`; returns its cudaError_t.
extern "C" int repro_decode_attention_f32cache(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, int batch, int n_heads, int n_kv_heads,
    int head_dim, int max_len, const int64_t* strides, float scale,
    void* scratch, int64_t scratch_floats, void* arrivals, int64_t n_arrivals,
    void* stream) {
  if (n_kv_heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* st = strides;
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const float*>(k_cache);
  a.v = static_cast<const float*>(v_cache);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.group = n_heads / n_kv_heads;
  a.n_kv = n_kv_heads;
  a.limit = max_len;
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_s0 = st[2]; a.k_s1 = st[3]; a.k_s2 = st[4];
  a.v_s0 = st[5]; a.v_s1 = st[6]; a.v_s2 = st[7];
  a.o_sb = st[8]; a.o_sh = st[9];
  a.scale = scale;
  return split_decode::launch<false>(a, batch, n_heads, head_dim, scratch,
                                     scratch_floats, arrivals, n_arrivals, stream);
}

// Registers, local (spill) bytes a thread, shared memory a block and
// resident blocks an SM of the split kernel `which`, as the runtime
// reports them: 0 and 1 the contiguous kernel for G <= 4 and G <= 8, 2 and
// 3 the paged kernel's.
extern "C" int repro_decode_kernel_info(int which, int* regs, int* local_bytes,
                                        int* smem_bytes, int* blocks_per_sm) {
  switch (which) {
    case 0:
      return split_decode::kernel_info<false, 4>(regs, local_bytes, smem_bytes,
                                                 blocks_per_sm);
    case 1:
      return split_decode::kernel_info<false, 8>(regs, local_bytes, smem_bytes,
                                                 blocks_per_sm);
    case 2:
    case 3:
      return repro_paged_decode_kernel_info(which == 3, regs, local_bytes,
                                            smem_bytes, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The span length, for the wrappers' scratch (both kernels).
extern "C" int repro_decode_span() { return split_decode::SPAN; }
