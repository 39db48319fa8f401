// Causal GQA prefill attention for Hopper (sm_90a), bf16 in and out.
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
// keys wide and are visited in order, with no split of the key axis across
// blocks, and a row's arithmetic involves only its own fragments.  A tile
// past a row's causal limit leaves its state bit-unchanged (max unchanged,
// correction exp2(0) = 1, sum + 0, O + 0), so a row's output does not
// depend on its tile, on Sq, or on whether it was prefilled in full or as a
// suffix after a prefix-cache hit.
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

constexpr int D = 128;             // head_dim (qwen3-4b)
constexpr int WG_ROWS = 64;        // query rows per consumer warpgroup
constexpr int BN = 128;            // keys per tile
constexpr int NSTAGE = 2;          // K/V ring depth
constexpr int Q_HALF = WG_ROWS * 128;   // bytes of one 64-column half of Q
constexpr int KV_HALF = BN * 128;       // bytes of one 64-column half of K or V
constexpr int KV_TILE = 2 * KV_HALF;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: every tile starts on a 1,024-byte boundary, the period of
// the 128-byte swizzle that TMA writes and wgmma reads.
template <int NWG>
struct Smem {
  static constexpr int q = 0;
  static constexpr int k = q + NWG * 2 * Q_HALF;
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
template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o, int sq, int sk,
                     int n_heads, int group, int n_qtiles, int64_t o_sb,
                     int64_t o_ss, int64_t o_sh, int q_offset,
                     float scale_log2) {
  using L = Smem<NWG>;
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
  const int n_tiles = (min(sk, q_offset + q_last + 1) + BN - 1) / BN;

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
      mbar_expect_tx(bar_q, q_wgs * 2 * Q_HALF);
      for (int wg = 0; wg < q_wgs; ++wg)
        for (int half = 0; half < 2; ++half)
          tma_load(base + L::q + (2 * wg + half) * Q_HALF, &tm_q, bar_q,
                   64 * half, q0 + wg * WG_ROWS, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NSTAGE;
        if (j >= NSTAGE) mbar_wait(bar_free + 8 * s, ((j / NSTAGE) - 1) & 1);
        const uint32_t kd = base + L::k + s * KV_TILE;
        const uint32_t vd = base + L::v + s * KV_TILE;
        mbar_expect_tx(bar_k + 8 * s, KV_TILE);
        tma_load(kd, &tm_k, bar_k + 8 * s, 0, j * BN, kh, b);
        tma_load(kd + KV_HALF, &tm_k, bar_k + 8 * s, 64, j * BN, kh, b);
        mbar_expect_tx(bar_v + 8 * s, KV_TILE);
        tma_load(vd, &tm_v, bar_v + 8 * s, 0, j * BN, kh, b);
        tma_load(vd + KV_HALF, &tm_v, bar_v + 8 * s, 64, j * BN, kh, b);
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
  const int qpos0 = q_offset + row0 + r0;
  const int qpos1 = qpos0 + 8;
  const int wg_last = min(row0 + WG_ROWS, sq) - 1;
  const int wg_tiles =
      wg_last < row0 ? 0 : (min(sk, q_offset + wg_last + 1) + BN - 1) / BN;
  const uint32_t q_sm = base + L::q + wg * 2 * Q_HALF;

  float oacc[D / 2];
  float sacc[BN / 2];
  uint32_t p[BN / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
  float m_0 = -INFINITY, m_1 = -INFINITY, l_0 = 0.f, l_1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NSTAGE;
    const uint32_t parity = (j / NSTAGE) & 1;
    mbar_wait(bar_k + 8 * s, parity);
    if (j < wg_tiles) {
      // S = Q K^T: 8 k16 steps over d, 4 in each 64-column half
      const uint32_t k_sm = base + L::k + s * KV_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
        wgmma_ss_n128(sacc,
                      sw128_desc(q_sm + (kk / 4) * Q_HALF + off, 16, 1024),
                      sw128_desc(k_sm + (kk / 4) * KV_HALF + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sacc);

      const int k0 = j * BN;
      if (k0 + BN - 1 > q_offset + row0 || k0 + BN > sk) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + c0 + (i & 1);
          if (key >= sk || key > ((i & 2) ? qpos1 : qpos0)) sacc[i] = -INFINITY;
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
      for (int i = 0; i < D / 2; ++i) oacc[i] *= (i & 2) ? corr1 : corr0;

      // O += P V: 8 k16 steps over the tile's keys, 16 rows (2,048 bytes) each
      mbar_wait(bar_v + 8 * s, parity);
      const uint32_t v_sm = base + L::v + s * KV_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_n128(oacc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                      p[4 * kk + 3], sw128_desc(v_sm + kk * 2048, KV_HALF, 1024));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(oacc);
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
  uint8_t* stage = smem + L::q + wg * 2 * Q_HALF;
  wg_sync(wg);  // every warp of this warpgroup is done reading Q
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * e;
      const float dn = e ? d1 : d0;
      const __nv_bfloat162 v = __floats2bfloat162_rn(oacc[4 * jn + 2 * e] / dn,
                                                     oacc[4 * jn + 2 * e + 1] / dn);
      *reinterpret_cast<__nv_bfloat162*>(stage + r * 256 + ((jn ^ (r & 7)) * 16) +
                                         (lane % 4) * 4) = v;
    }
  }
  wg_sync(wg);
  for (int idx = t; idx < WG_ROWS * (D / 8); idx += 128) {
    const int r = idx / (D / 8), c = idx % (D / 8);
    const int qrow = row0 + r;
    if (qrow < sq)
      *reinterpret_cast<uint4*>(o + b * o_sb + qrow * o_ss + h * o_sh + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * 256 + ((c ^ (r & 7)) * 16));
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
// 128-byte swizzle.  Strides are in elements; a dimension of size 1 gets a
// stride that TMA accepts, since it is never stepped.
struct MapKey {
  const void* ptr;
  int batch, seq, heads, rows;
  int64_t s_b, s_s, s_h;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && batch == o.batch && seq == o.seq &&
           heads == o.heads && rows == o.rows && s_b == o.s_b &&
           s_s == o.s_s && s_h == o.s_h;
  }
};

bool encode_map(CUtensorMap* map, const MapKey& key) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  int64_t s_h = key.heads == 1 ? key.s_s * key.seq : key.s_h;
  int64_t s_b = key.batch == 1 ? s_h * key.heads : key.s_b;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
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

bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
              int64_t s_b, int64_t s_s, int64_t s_h, int rows) {
  const MapKey key{ptr, batch, seq, heads, rows, s_b, s_s, s_h};
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

template <int NWG>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, int batch, int sq, int sk,
                   int n_heads, int group, const int64_t* st, int q_offset,
                   float scale_log2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<NWG>::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_qtiles = (sq + NWG * WG_ROWS - 1) / (NWG * WG_ROWS);
  const dim3 grid(n_heads * batch, n_qtiles);
  flash_prefill_kernel<NWG><<<grid, NWG * 128 + 32, Smem<NWG>::bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, n_heads, group,
      n_qtiles, st[9], st[10], st[11], q_offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// What limits the kernel with `warpgroups` consumer warpgroups (1 or 2):
// registers a thread, local (stack and spill) bytes a thread, dynamic
// shared memory a block, and blocks resident on one SM.  Returns the
// queries' cudaError_t.
extern "C" int repro_flash_kernel_info(int warpgroups, int* regs,
                                       int* local_bytes, int* smem_bytes,
                                       int* blocks_per_sm) {
  if (warpgroups != 1 && warpgroups != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn =
      warpgroups == 1
          ? reinterpret_cast<const void*>(flash_prefill_kernel<1>)
          : reinterpret_cast<const void*>(flash_prefill_kernel<2>);
  const int smem = warpgroups == 1 ? Smem<1>::bytes : Smem<2>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fn, warpgroups * 128 + 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = smem;
  return static_cast<int>(cudaSuccess);
}

// q (B, Sq, H, d), k and v (B, Sk, K, d), o (B, Sq, H, d): bf16, d = 128,
// unit stride on d, 16-byte aligned rows.  strides[12] holds the (batch,
// seq, head) strides of q, k, v, o in elements.  Returns the launch's
// cudaError_t.
extern "C" int repro_flash_prefill_bf16(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int sq, int sk, int n_heads,
                                        int n_kv_heads, int head_dim,
                                        const int64_t* strides, int q_offset,
                                        float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 || q_offset < 0 || head_dim != D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* st = strides;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, batch, sq, n_heads, st[0], st[1], st[2], WG_ROWS) ||
      !make_map(&tk, k, batch, sk, n_kv_heads, st[3], st[4], st[5], BN) ||
      !make_map(&tv, v, batch, sk, n_kv_heads, st[6], st[7], st[8], BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = n_heads / n_kv_heads;
  const float scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      sq > WG_ROWS ? launch<2>(tq, tk, tv, o, batch, sq, sk, n_heads, group, st,
                               q_offset, scale_log2, s)
                   : launch<1>(tq, tk, tv, o, batch, sq, sk, n_heads, group, st,
                               q_offset, scale_log2, s);
  return static_cast<int>(err);
}
