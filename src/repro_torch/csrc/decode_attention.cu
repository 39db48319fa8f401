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
// Head widths 128 (qwen3, qwen2.5, the MoE family), 112 (zamba2's shared
// attention block, which runs G = 1: 32 query heads over 32 KV heads) and
// 64 (whisper's decoder, G = 1: 20 over 20, over its self cache and over
// its cross cache of 1,500 encoder rows at lengths = 1,500) and 256
// (paligemma, G = 8: 8 query heads over 1 KV head, over the 256 patch rows
// and the text after them; two float4s of a row a lane and two output
// columns a thread, split_decode.cuh).  G = 1 takes
// the GM = 4 instantiation, whose query rows 1-3 are idle: their registers
// and FMAs are spent for nothing (not tuned yet).  At d = 64 a row is 16
// float4s, so lanes 16-31 copy no column of a row and threads 64-127 own
// no output column (split_decode.cuh).
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
// 128, 112, 64 or 256, unit stride on d everywhere.  strides[10] = q (batch, head), k
// (batch, seq, head), v (batch, seq, head), out (batch, head), in
// elements.  scratch: at least B * K * ceil(S / span) * G * (d + 2) f32,
// 16-byte aligned; arrivals: at least B * K uint32, zero (the kernel leaves
// them zero).  One launch on `stream`; returns its cudaError_t, and
// cudaErrorInvalidValue for a head_dim no instantiation is built for.
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
  switch (head_dim) {
    case 128:
      return split_decode::launch<false, 128>(a, batch, n_heads, head_dim, scratch,
                                              scratch_floats, arrivals, n_arrivals,
                                              stream);
    case 112:
      return split_decode::launch<false, 112>(a, batch, n_heads, head_dim, scratch,
                                              scratch_floats, arrivals, n_arrivals,
                                              stream);
    case 64:
      return split_decode::launch<false, 64>(a, batch, n_heads, head_dim, scratch,
                                             scratch_floats, arrivals, n_arrivals,
                                             stream);
    case 256:
      return split_decode::launch<false, 256>(a, batch, n_heads, head_dim, scratch,
                                              scratch_floats, arrivals, n_arrivals,
                                              stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, local (spill) bytes a thread, shared memory a block and
// resident blocks an SM of the split kernel `which`, as the runtime
// reports them: 0 and 1 the contiguous kernel for G <= 4 and G <= 8, 2 and
// 3 the paged kernel's, 4 and 5 the contiguous kernel's at d = 112, 6 and 7
// at d = 64, 8 and 9 at d = 256.
extern "C" int repro_decode_kernel_info(int which, int* regs, int* local_bytes,
                                        int* smem_bytes, int* blocks_per_sm) {
  switch (which) {
    case 0:
      return split_decode::kernel_info<false, 4, 128>(regs, local_bytes, smem_bytes,
                                                      blocks_per_sm);
    case 1:
      return split_decode::kernel_info<false, 8, 128>(regs, local_bytes, smem_bytes,
                                                      blocks_per_sm);
    case 2:
    case 3:
      return repro_paged_decode_kernel_info(which == 3, regs, local_bytes,
                                            smem_bytes, blocks_per_sm);
    case 4:
      return split_decode::kernel_info<false, 4, 112>(regs, local_bytes, smem_bytes,
                                                      blocks_per_sm);
    case 5:
      return split_decode::kernel_info<false, 8, 112>(regs, local_bytes, smem_bytes,
                                                      blocks_per_sm);
    case 6:
      return split_decode::kernel_info<false, 4, 64>(regs, local_bytes, smem_bytes,
                                                     blocks_per_sm);
    case 7:
      return split_decode::kernel_info<false, 8, 64>(regs, local_bytes, smem_bytes,
                                                     blocks_per_sm);
    case 8:
      return split_decode::kernel_info<false, 4, 256>(regs, local_bytes, smem_bytes,
                                                      blocks_per_sm);
    case 9:
      return split_decode::kernel_info<false, 8, 256>(regs, local_bytes, smem_bytes,
                                                      blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The span length, for the wrappers' scratch (both kernels).
extern "C" int repro_decode_span() { return split_decode::SPAN; }
