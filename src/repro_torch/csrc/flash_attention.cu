// GQA prefill attention for Hopper (sm_90a), causal or not, bf16 in and out.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:flash_attention
// which tiles (B, H, nq, nk) with the k-block axis innermost and carries the
// online-softmax state in VMEM scratch from one sequential grid step to the
// next.  Hopper runs blocks in parallel and in no order, so here one block
// owns up to 128 query rows of one (batch, head) and walks the key tiles in
// a loop, holding the softmax state and the output in registers.  KV head
// h / group serves every query head of its group, as the TPU kernel's index
// map does.
//
// What bounds it on the H100.  The work is 4 d FLOPs per visible (query,
// key) pair and the bytes are Q, K, V and O once each.  At the serving
// path's 12-token prompts that is ~2.4 MFLOP a head against 72 KB: the
// bound is the bytes (~73 ns) and in practice the launch and the latency of
// one load-compute-store chain.  At 2,048 tokens it is 34 GFLOP against
// 6 MB: the bound is the tensor cores (~35 us at 989 TFLOP/s).
//
// The design for that:
//   * tensor cores at the wgmma rate: each consumer warpgroup owns 64 query
//     rows; S = Q K^T is wgmma m64n128k16 with Q and K from shared memory,
//     O += P V is wgmma m64n128k16 with P from registers and V from shared
//     memory through the transposed (MN-major) descriptor;
//   * S, P and O never leave registers: the online softmax runs on the
//     accumulator fragments (row max and row sum across the 4 lanes of a
//     quad), exp2f with scale * log2(e) folded into one FMA, O rescaled in
//     registers and normalised once in the epilogue, which goes through
//     shared memory for 16-byte coalesced stores;
//   * asynchronous copies: one producer warp loads Q once and streams K and
//     V tiles through a 2-stage ring with TMA (128-byte swizzle, the layout
//     wgmma reads), completion on mbarriers; separate K and V barriers let
//     Q K^T start while V is in flight.  The tensor maps come from the
//     views' strides, so fused-projection and cache views load in place,
//     and the hardware zero-fills rows past Sq and Sk;
//   * causal work: a block loads only the key tiles up to its last row's
//     limit, masks element by element only the tiles that cross the
//     diagonal or the end of K, and the grid starts the heaviest query
//     tiles first (the y index runs from the last query tile down);
//   * two consumer warpgroups (128 rows) share each K/V tile where the rows
//     exist, one where Sq <= 64.
//
// Determinism (batch invariance).  Key tiles always start at key 0, are 128
// keys wide (64 at d = 256) and are visited in order, with no split of the key axis across
// blocks, and a row's arithmetic involves only its own fragments.  A tile
// past a row's causal limit leaves its state bit-unchanged (max unchanged,
// correction exp2(0) = 1, sum + 0, O + 0), so a row's output does not
// depend on its tile, on Sq, or on whether it was prefilled in full or as a
// suffix after a prefix-cache hit.
//
// Head widths 128 (qwen3, qwen2.5) and 112 (zamba2).  Shared memory is laid
// out for 128 columns either way: at d = 112 the tensor maps' inner extent
// is 112, so the second 64-column box of each row is filled with zeros
// past column 111 by the hardware; Q K^T takes 7 k16 steps instead of 8,
// the zero columns of V make output columns 112-127 zero, and the store
// writes 14 16-byte chunks a row instead of 16.  The d = 128 instantiation
// is the code it was.
//
// MLA's decompressed heads (minicpm3): Q and K of width 96 (64 nope + 32
// rope columns), V of width 64.  The kernel is a template on the Q/K width
// DQK and the V width DV; (128, 128) and (112, 112) compute what the one
// width did.  At (96, 64) the layout stays that of 128 columns: Q's and K's
// tensor maps have inner extent 96, so TMA zero-fills columns 96-127 of
// their second box and Q K^T takes 6 k16 steps.  V's map has inner extent
// 64 and its second 64-column half is never loaded: those shared-memory
// columns hold stale bytes, which P V carries only into output columns
// 64-127 (a column of P V reads only its own column of V), and the store
// writes 8 16-byte chunks a row, so no such column leaves the block.
//
// whisper's heads: (d_qk, d_v) = (64, 64).  Q's and K's tensor maps have
// inner extent 64, so only their first 64-column box is loaded (the second
// would be all zeros) and Q K^T takes 4 k16 steps; V is as at (96, 64).
//
// Causal or not (the TPU kernel's `causal` flag).  A non-causal call (the
// encoder's self-attention, the decoder's cross-attention) visits every key
// tile of Sk and masks only the keys past Sk (TMA fills those rows of the
// last tile with zeros, which would score 0, not -inf); q_offset then
// plays no part.  The causal path is the arithmetic it was: the flag only
// selects the tile count and the mask's diagonal test.
//
// The prefix-LM mask (paligemma's: the reference's make_causal_mask with a
// prefix_len P).  A causal row at position q sees the keys up to max(q, P -
// 1): the P prefix positions (the image's patch embeddings) attend to each
// other both ways, the text after them causally.  That limit replaces the
// diagonal in the two places it is read: the block's count of key tiles
// (driven by max(last row, P - 1)) and the element mask of the tiles that
// cross it.  At P = 0 the limit is the diagonal, so every earlier path
// visits the same tiles in the same order and computes the same bits.
//
// Head width 256 (paligemma: 8 query heads over 1 KV head).  Its layout is
// 256 shared-memory columns, four 64-column swizzled boxes a row, and
// 64-key tiles: K and V are 32 KB a tile, the 2-stage ring 128 KB, Q 32
// KB, where 128-key tiles would need 256 KB for the ring alone.  Q K^T
// takes 16 k16 steps as wgmma m64n64k16 (S is 32 registers a thread); P V
// runs as two m64n128k16 products a k16 step, one for each 128-column half
// of O (the accumulator is 128 f32 registers a thread).  The output is
// staged through the warpgroup's 32 KB Q tile.  A block has one consumer
// warpgroup (64 query rows) at every Sq: with two, ptxas holds the 288
// threads to 168 registers a thread and spills; with one it takes 197 and
// spills nothing.  The narrower widths keep 128 columns and 128-key tiles,
// the code they were.
//
// Numerics: bf16 operands, f32 accumulation and softmax.  The unnormalised
// probabilities are rounded to bf16 for P V and the row sum adds those
// same rounded values, so the final division normalises exactly what was
// accumulated.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG_ROWS = 64;        // query rows per consumer warpgroup
constexpr int NSTAGE = 2;          // K/V ring depth
constexpr int Q_BOX = WG_ROWS * 128;    // bytes of one 64-column box of Q
constexpr float LOG2E = 1.4426950408889634f;

// The layout of an instantiation: the shared-memory row of 128 columns, or
// 256 for the d = 256 heads, and the keys a tile that fit beside it.  Every
// tile starts on a 1,024-byte boundary, the period of the 128-byte swizzle
// that TMA writes and wgmma reads.
template <int NWG, int DQK>
struct Smem {
  static constexpr int DCOL = DQK > 128 ? 256 : 128;  // columns of a row
  static constexpr int NBOX = DCOL / 64;              // 64-column boxes a row
  static constexpr int BN = DCOL == 256 ? 64 : 128;   // keys per tile
  static constexpr int Q_WG = NBOX * Q_BOX;           // one warpgroup's Q
  static constexpr int KV_BOX = BN * 128;             // one box of K or V
  static constexpr int KV_TILE = NBOX * KV_BOX;
  static constexpr int q = 0;
  static constexpr int k = q + NWG * Q_WG;
  static constexpr int v = k + NSTAGE * KV_TILE;
  static constexpr int bar = v + NSTAGE * KV_TILE;  // q, k[], v[], empty[]
  static constexpr int bytes = bar + 8 * (1 + 3 * NSTAGE) + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.  A phase that
// never completes is a fault of the kernel: trap (the launch then reports an
// error) rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a (d, seq, heads, batch) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or reuse of registers that an
// in-flight wgmma writes or reads across the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// D (64 x 128, f32) = A (64 x 16) B (16 x 128) (+ D if scale_d); A and B
// from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) = A (64 x 16) B (16 x 64) (+ D if scale_d); A and B
// from shared memory, both K-major (S of the 64-key tiles at d = 256).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128); A from registers (bf16
// pairs), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Accumulator fragments of wgmma m64nN (f32), per thread of a warpgroup:
// element 4j + e sits in row 16 * warp + lane / 4 (+ 8 when e >= 2) and
// column 8j + 2 * (lane % 4) + (e & 1).  The A fragment of one k16 step of
// P V is the same pattern over 16 columns, so S's elements 8k .. 8k + 7
// packed in pairs are exactly P's registers for keys 16k .. 16k + 15.
template <int NWG, int DQK, int DV>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o, int sq, int sk,
                     int n_heads, int group, int n_qtiles, int64_t o_sb,
                     int64_t o_ss, int64_t o_sh, int q_offset, int causal,
                     int prefix_len, float scale_log2) {
  using L = Smem<NWG, DQK>;
  constexpr int BN = L::BN;
  constexpr int NH = L::DCOL / 128;       // 128-column halves of O
  constexpr int ROW_BYTES = L::DCOL * 2;  // a staged output row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::bar;
  const uint32_t bar_k = bar_q + 8;                // + 8 s
  const uint32_t bar_v = bar_k + 8 * NSTAGE;       // + 8 s
  const uint32_t bar_free = bar_v + 8 * NSTAGE;    // + 8 s

  const int h = blockIdx.x % n_heads;
  const int b = blockIdx.x / n_heads;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.y)) * NWG * WG_ROWS;
  const int q_last = min(q0 + NWG * WG_ROWS, sq) - 1;
  // the last key row q sees, causal: its diagonal, or the prefix's end
  auto limit = [q_offset, prefix_len](int q) { return max(q_offset + q, prefix_len - 1); };
  // the keys any row of the block sees: up to the last row's limit, or all
  const int n_tiles = ((causal ? min(sk, limit(q_last) + 1) : sk) + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_free + 8 * s, NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == NWG * 4) {
    // producer: Q once, then K and V tile by tile through the ring
    if (lane == 0) {
      const int kh = h / group;
      const int q_wgs = (q_last - q0) / WG_ROWS + 1;  // warpgroups with rows
      constexpr int QK_BOXES = (DQK + 63) / 64;       // 64-column boxes of Q, K
      constexpr int V_BOXES = (DV + 63) / 64;
      mbar_expect_tx(bar_q, q_wgs * QK_BOXES * Q_BOX);
      for (int wg = 0; wg < q_wgs; ++wg)
        for (int box = 0; box < QK_BOXES; ++box)
          tma_load(base + L::q + wg * L::Q_WG + box * Q_BOX, &tm_q, bar_q,
                   64 * box, q0 + wg * WG_ROWS, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NSTAGE;
        if (j >= NSTAGE) mbar_wait(bar_free + 8 * s, ((j / NSTAGE) - 1) & 1);
        const uint32_t kd = base + L::k + s * L::KV_TILE;
        const uint32_t vd = base + L::v + s * L::KV_TILE;
        mbar_expect_tx(bar_k + 8 * s, QK_BOXES * L::KV_BOX);
        for (int box = 0; box < QK_BOXES; ++box)
          tma_load(kd + box * L::KV_BOX, &tm_k, bar_k + 8 * s, 64 * box, j * BN, kh, b);
        mbar_expect_tx(bar_v + 8 * s, V_BOXES * L::KV_BOX);
        for (int box = 0; box < V_BOXES; ++box)
          tma_load(vd + box * L::KV_BOX, &tm_v, bar_v + 8 * s, 64 * box, j * BN, kh, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows row0 .. row0 + 63 of the block
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int r0 = (warp % 4) * 16 + lane / 4;  // local row of e < 2; + 8 for e >= 2
  const int c0 = 2 * (lane % 4);
  const int row0 = q0 + wg * WG_ROWS;
  const int lim0 = limit(row0 + r0);
  const int lim1 = limit(row0 + r0 + 8);
  const int wg_last = min(row0 + WG_ROWS, sq) - 1;
  const int wg_tiles =
      wg_last < row0
          ? 0
          : ((causal ? min(sk, limit(wg_last) + 1) : sk) + BN - 1) / BN;
  const uint32_t q_sm = base + L::q + wg * L::Q_WG;

  float oacc[NH][64];
  float sacc[BN / 2];
  uint32_t p[BN / 4];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 64; ++i) oacc[hh][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
  float m_0 = -INFINITY, m_1 = -INFINITY, l_0 = 0.f, l_1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NSTAGE;
    const uint32_t parity = (j / NSTAGE) & 1;
    mbar_wait(bar_k + 8 * s, parity);
    if (j < wg_tiles) {
      // S = Q K^T: DQK / 16 k16 steps over d, 4 in each 64-column box
      const uint32_t k_sm = base + L::k + s * L::KV_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
        const uint64_t da = sw128_desc(q_sm + (kk / 4) * Q_BOX + off, 16, 1024);
        const uint64_t db = sw128_desc(k_sm + (kk / 4) * L::KV_BOX + off, 16, 1024);
        if constexpr (BN == 128) wgmma_ss_n128(sacc, da, db, kk > 0);
        else wgmma_ss_n64(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sacc);

      // the tile crosses the limit of the warpgroup's first row, or Sk
      const int k0 = j * BN;
      if ((causal && k0 + BN - 1 > limit(row0)) || k0 + BN > sk) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + c0 + (i & 1);
          if (key >= sk || (causal && key > ((i & 2) ? lim1 : lim0)))
            sacc[i] = -INFINITY;
        }
      }
      float mx0 = m_0, mx1 = m_1;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, sacc[i]);
        else mx0 = fmaxf(mx0, sacc[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row that has seen no visible key keeps m = -inf: p = 0, sum 0.
      // The correction is the accurate exp2f, so an unchanged max gives
      // exactly 1 and a tile past the row's limit changes no bit.
      const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
      const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
      const float corr0 = exp2f((m_0 - mu0) * scale_log2);
      const float corr1 = exp2f((m_1 - mu1) * scale_log2);
      m_0 = mx0;
      m_1 = mx1;
      const float mb0 = mu0 * scale_log2, mb1 = mu1 * scale_log2;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const float mb = (i & 2) ? mb1 : mb0;
        const __nv_bfloat162 pb =
            __floats2bfloat162_rn(fast_exp2(fmaf(sacc[i], scale_log2, -mb)),
                                  fast_exp2(fmaf(sacc[i + 1], scale_log2, -mb)));
        p[i / 2] = *reinterpret_cast<const uint32_t*>(&pb);
        const float pair = __low2float(pb) + __high2float(pb);
        if (i & 2) ps1 += pair;
        else ps0 += pair;
      }
      l_0 = l_0 * corr0 + ps0;
      l_1 = l_1 * corr1 + ps1;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int i = 0; i < 64; ++i) oacc[hh][i] *= (i & 2) ? corr1 : corr0;

      // O += P V: BN / 16 k16 steps over the tile's keys, 16 rows (2,048
      // bytes) each, one n128 product a 128-column half of O (two boxes)
      mbar_wait(bar_v + 8 * s, parity);
      const uint32_t v_sm = base + L::v + s * L::KV_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          wgmma_rs_n128(oacc[hh], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                        p[4 * kk + 3],
                        sw128_desc(v_sm + 2 * hh * L::KV_BOX + kk * 2048, L::KV_BOX,
                                   1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) reg_fence(oacc[hh]);
      reg_fence(p);
    } else {
      mbar_wait(bar_v + 8 * s, parity);
    }
    mbar_arrive(bar_free + 8 * s);
  }
  if (row0 >= sq) return;

  // epilogue: full row sums, normalise, stage through this warpgroup's Q
  // tile (16-byte chunks swizzled by row) and store 16 bytes a thread
  l_0 += __shfl_xor_sync(0xffffffffu, l_0, 1);
  l_0 += __shfl_xor_sync(0xffffffffu, l_0, 2);
  l_1 += __shfl_xor_sync(0xffffffffu, l_1, 1);
  l_1 += __shfl_xor_sync(0xffffffffu, l_1, 2);
  const float d0 = fmaxf(l_0, 1e-37f), d1 = fmaxf(l_1, 1e-37f);
  uint8_t* stage = smem + L::q + wg * L::Q_WG;
  wg_sync(wg);  // every warp of this warpgroup is done reading Q
#pragma unroll
  for (int jn = 0; jn < DV / 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * e;
      const float dn = e ? d1 : d0;
      const int i = 4 * (jn % 16) + 2 * e;
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(oacc[jn / 16][i] / dn, oacc[jn / 16][i + 1] / dn);
      *reinterpret_cast<__nv_bfloat162*>(stage + r * ROW_BYTES + ((jn ^ (r & 7)) * 16) +
                                         (lane % 4) * 4) = v;
    }
  }
  wg_sync(wg);
  for (int idx = t; idx < WG_ROWS * (DV / 8); idx += 128) {
    const int r = idx / (DV / 8), c = idx % (DV / 8);
    const int qrow = row0 + r;
    if (qrow < sq)
      *reinterpret_cast<uint4*>(o + b * o_sb + qrow * o_ss + h * o_sh + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * ROW_BYTES + ((c ^ (r & 7)) * 16));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (batch, seq, heads, d) bf16 view with unit stride on d as a 4-D tensor
// map (d, seq, heads, batch) whose box is 64 columns by `rows` rows, in the
// 128-byte swizzle; columns from d to the box's end read as zeros.  Strides are in elements;
// a dimension of size 1 gets a stride that TMA accepts, since it is never
// stepped.
struct MapKey {
  const void* ptr;
  int dim, batch, seq, heads, rows;
  int64_t s_b, s_s, s_h;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && dim == o.dim && batch == o.batch && seq == o.seq &&
           heads == o.heads && rows == o.rows && s_b == o.s_b &&
           s_s == o.s_s && s_h == o.s_h;
  }
};

bool encode_map(CUtensorMap* map, const MapKey& key) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  int64_t s_h = key.heads == 1 ? key.s_s * key.seq : key.s_h;
  int64_t s_b = key.batch == 1 ? s_h * key.heads : key.s_b;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(key.dim),
                              static_cast<cuuint64_t>(key.seq),
                              static_cast<cuuint64_t>(key.heads),
                              static_cast<cuuint64_t>(key.batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(key.s_s) * 2,
                                 static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(key.rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(key.ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The encode costs a few microseconds of host time on every call, so each
// host thread keeps its last few maps: a model's layers hand the kernel the
// same views (the caching allocator reuses addresses), and a hit is a copy.
constexpr int MAP_CACHE = 16;
struct MapCache {
  MapKey key[MAP_CACHE];
  CUtensorMap map[MAP_CACHE];
  int size = 0, next = 0;
};
thread_local MapCache map_cache;

bool make_map(CUtensorMap* map, const void* ptr, int dim, int batch, int seq,
              int heads, int64_t s_b, int64_t s_s, int64_t s_h, int rows) {
  const MapKey key{ptr, dim, batch, seq, heads, rows, s_b, s_s, s_h};
  MapCache& c = map_cache;
  for (int i = 0; i < c.size; ++i) {
    if (c.key[i] == key) {
      *map = c.map[i];
      return true;
    }
  }
  if (!encode_map(map, key)) return false;
  c.key[c.next] = key;
  c.map[c.next] = *map;
  c.next = (c.next + 1) % MAP_CACHE;
  if (c.size < MAP_CACHE) ++c.size;
  return true;
}

template <int NWG, int DQK, int DV>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, int batch, int sq, int sk,
                   int n_heads, int group, const int64_t* st, int q_offset,
                   int causal, int prefix_len, float scale_log2, cudaStream_t stream) {
  constexpr int smem = Smem<NWG, DQK>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<NWG, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_qtiles = (sq + NWG * WG_ROWS - 1) / (NWG * WG_ROWS);
  const dim3 grid(n_heads * batch, n_qtiles);
  flash_prefill_kernel<NWG, DQK, DV><<<grid, NWG * 128 + 32, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, n_heads, group,
      n_qtiles, st[9], st[10], st[11], q_offset, causal, prefix_len, scale_log2);
  return cudaGetLastError();
}

struct KernelInfo {
  const void* fn;
  int warpgroups, smem;
};

template <int NWG, int DQK, int DV>
KernelInfo info() {
  return {reinterpret_cast<const void*>(flash_prefill_kernel<NWG, DQK, DV>), NWG,
          Smem<NWG, DQK>::bytes};
}

}  // namespace

// What limits the kernel with `which` consumer warpgroups at d = 128 (1 or
// 2), or `which - 2` at d = 112 (3 or 4), or `which - 4` at (d_qk, d_v) =
// (96, 64) (5 or 6), or `which - 6` at d = 64 (7 or 8), or with one at d =
// 256 (9): registers a thread, local (stack and spill) bytes a thread,
// dynamic shared memory a block, and blocks resident on one SM.
// Returns the queries' cudaError_t.
extern "C" int repro_flash_kernel_info(int which, int* regs,
                                       int* local_bytes, int* smem_bytes,
                                       int* blocks_per_sm) {
  const KernelInfo infos[9] = {
      info<1, 128, 128>(), info<2, 128, 128>(), info<1, 112, 112>(),
      info<2, 112, 112>(), info<1, 96, 64>(),   info<2, 96, 64>(),
      info<1, 64, 64>(),   info<2, 64, 64>(),   info<1, 256, 256>()};
  if (which < 1 || which > 9) return static_cast<int>(cudaErrorInvalidValue);
  const KernelInfo& k = infos[which - 1];
  cudaError_t err = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k.fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, k.fn, k.warpgroups * 128 + 32, k.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = k.smem;
  return static_cast<int>(cudaSuccess);
}

// q (B, Sq, H, d_qk), k (B, Sk, K, d_qk), v (B, Sk, K, d_v), o (B, Sq, H,
// d_v): bf16, (d_qk, d_v) = (128, 128), (112, 112), (96, 64), (64, 64) or
// (256, 256), unit stride on d, 16-byte aligned rows.  strides[12] holds the
// (batch, seq, head) strides of q, k, v, o in elements.  causal != 0: query
// i sits at position q = q_offset + i and sees keys 0 .. max(q, prefix_len
// - 1) (prefix_len = 0: the plain causal mask); causal == 0: every query
// sees every key.  Returns the launch's cudaError_t.
extern "C" int repro_flash_prefill_bf16(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int sq, int sk, int n_heads,
                                        int n_kv_heads, int d_qk, int d_v,
                                        const int64_t* strides, int q_offset,
                                        int causal, int prefix_len, float scale,
                                        void* stream) {
  const bool widths = (d_qk == 128 && d_v == 128) || (d_qk == 112 && d_v == 112) ||
                      (d_qk == 96 && d_v == 64) || (d_qk == 64 && d_v == 64) ||
                      (d_qk == 256 && d_v == 256);
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 || q_offset < 0 || prefix_len < 0 || !widths)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* st = strides;
  const int bn = d_qk == 256 ? Smem<1, 256>::BN : Smem<1, 128>::BN;  // keys a tile
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, d_qk, batch, sq, n_heads, st[0], st[1], st[2], WG_ROWS) ||
      !make_map(&tk, k, d_qk, batch, sk, n_kv_heads, st[3], st[4], st[5], bn) ||
      !make_map(&tv, v, d_v, batch, sk, n_kv_heads, st[6], st[7], st[8], bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = n_heads / n_kv_heads;
  const float scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_LAUNCH(NWG, DQK, DV)                                            \
  launch<NWG, DQK, DV>(tq, tk, tv, o, batch, sq, sk, n_heads, group, st, q_offset, \
                       causal != 0, prefix_len, scale_log2, s)
  const bool two = sq > WG_ROWS;
  const cudaError_t err =
      d_qk == 128 ? (two ? REPRO_FLASH_LAUNCH(2, 128, 128) : REPRO_FLASH_LAUNCH(1, 128, 128))
      : d_qk == 112
          ? (two ? REPRO_FLASH_LAUNCH(2, 112, 112) : REPRO_FLASH_LAUNCH(1, 112, 112))
      : d_qk == 96
          ? (two ? REPRO_FLASH_LAUNCH(2, 96, 64) : REPRO_FLASH_LAUNCH(1, 96, 64))
      : d_qk == 64
          ? (two ? REPRO_FLASH_LAUNCH(2, 64, 64) : REPRO_FLASH_LAUNCH(1, 64, 64))
          : REPRO_FLASH_LAUNCH(1, 256, 256);
#undef REPRO_FLASH_LAUNCH
  return static_cast<int>(err);
}
