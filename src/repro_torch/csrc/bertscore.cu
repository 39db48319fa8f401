// BERTScore greedy matching for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/bertscore/bertscore.py:bertscore_pr
// which, per example, takes the cosine similarity of every (candidate token,
// reference token) pair, sets masked pairs to exactly -1e30, and reduces the
// (Lc, Lr) matrix to P = mean over candidate tokens of the row maxima and
// R = mean over reference tokens of the column maxima.  The F1 epilogue is
// in kernels/bertscore/ops.py, as in the reference.
//
// Bound on the H100: reading the (Lc + Lr) D f32 embeddings once.  The
// product is 2 Lc Lr D FLOPs an example; done as three TF32 products it is
// 6 Lc Lr D at 495 TFLOP/s, 13 us at the metric's 64 x 64 x 256 and B =
// 1,024, under the 40 us the bytes take at 3.35 TB/s, so the bound is the
// bytes.
//
// One block of 128 threads (4 warps) owns one example, so no sum crosses
// blocks and an example's P and R are the same bits alone or in any
// batch.  It walks (64-row candidate tile, 64-row reference tile) pairs;
// the running row maxima and column maxima of the whole example live in
// shared memory, so the (Lc, Lr) matrix never reaches device memory.  What
// the design does about what held the first version (scalar f32 FMA bound
// by the shared-memory load rate, every embedding read twice, scalar
// staging with nothing in flight, maxima through a shared tile scanned by
// half the threads, one thread summing P and R):
//   - the product runs on tensor cores with f32 accuracy, 3xTF32: each
//     operand x splits into hi = tf32_rna(x) and lo = tf32_rna(x - hi),
//     and mma.sync m16n8k8 accumulates lo.hi' + hi.lo' + hi.hi' in f32
//     (~2^-21 of |x||y| a product; plain TF32 would move P and R by
//     ~1e-3).  The rounding is two integer ops on the bits, which a probe
//     found faster than cvt.rna.tf32.f32.  Warp w owns candidate rows 16w..16w+15 of the tile against
//     all 64 reference rows (8 accumulator tiles of 16 x 8);
//   - 32-column slices of both tiles are staged by cp.async, 16 bytes a
//     thread (4 bytes where D % 4 != 0), into a ring of 2 stages, so the
//     next slice is in flight while this one is multiplied (45 KB of
//     shared memory, 4 blocks an SM; a ring of 3 at 3 blocks an SM was
//     slower in a probe);
//   - each row's squared norm is summed from the staged slices, in column
//     order, the first time its tile is staged (thread t: candidate row t,
//     reference row t - 64), so no embedding is read twice for it; the dot
//     product is scaled by rsqrt(max(|c|^2, 1e-18)) rsqrt(max(|r|^2,
//     1e-18)) in the epilogue (the reference normalises before the
//     product: ~1 ulp apart);
//   - the tile's row and column maxima come from the accumulators in
//     registers by warp shuffles; a row is one warp's, and a column's
//     maximum across warps is an atomicMax on the float's order-preserving
//     integer image in shared memory.  A maximum is exact whatever the
//     order, so this changes no bit;
//   - P and R are each summed by one warp, lanes over tokens in index
//     order, then a fixed shuffle tree.
// Masked pairs and pairs past the edge take exactly -1e30.
//
// Limits: 1 <= Lc, Lr <= 512 (the per-example maxima in shared memory) and
// 1 <= D <= 1024; the wrapper raises outside them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXL = 512;   // tokens per side
constexpr int MAXD = 1024;  // embedding width
constexpr int T = 64;       // rows per candidate tile and per reference tile
constexpr int DK = 32;      // embedding columns a stage
constexpr int LDS = DK + 4; // a staged row's stride: conflict-free fragments
constexpr int STAGES = 2;   // the ring of k-slices
constexpr int NT = 128;     // threads: 4 warps of 16 candidate rows each
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// f32 -> TF32 rounded to nearest, ties away from zero (cvt.rna.tf32.f32 on
// finite values): add half of the 13 dropped bits to the magnitude, clear them
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
}

struct Stage {
  float c[T][LDS];
  float r[T][LDS];
};

// Stage the k-slice k0 of candidate tile c0 and reference tile r0; rows and
// columns past the edge are zero-filled.  VEC: 16-byte copies (D % 4 == 0
// and 16-byte aligned bases), else 4-byte ones.
template <bool VEC>
__device__ __forceinline__ void load_stage(Stage& st, const float* c, const float* r,
                                           int lc, int lr, int d, int c0, int r0,
                                           int k0) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 2 * T * DK / 4 / NT; ++i) {
      const int e = tid + i * NT;
      const int side = e / (T * DK / 4), row = (e / (DK / 4)) % T, q = e % (DK / 4);
      const int col = k0 + 4 * q;
      const int lim = side ? lr : lc, row0 = side ? r0 : c0;
      const float* base = side ? r : c;
      const bool in = row0 + row < lim && col < d;
      const float* src = in ? base + static_cast<int64_t>(row0 + row) * d + col : base;
      cp_async16(side ? &st.r[row][4 * q] : &st.c[row][4 * q], src, in ? 16 : 0);
    }
  } else {
    for (int i = 0; i < 2 * T * DK / NT; ++i) {
      const int e = tid + i * NT;
      const int side = e / (T * DK), row = (e / DK) % T, k = e % DK;
      const int col = k0 + k;
      const int lim = side ? lr : lc, row0 = side ? r0 : c0;
      const float* base = side ? r : c;
      const bool in = row0 + row < lim && col < d;
      const float* src = in ? base + static_cast<int64_t>(row0 + row) * d + col : base;
      cp_async4(side ? &st.r[row][k] : &st.c[row][k], src, in ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 3)
bertscore_kernel(const float* __restrict__ cand, const float* __restrict__ ref,
                 const float* __restrict__ cmask, const float* __restrict__ rmask,
                 int lc, int lr, int d, float* __restrict__ p_out,
                 float* __restrict__ r_out) {
  __shared__ __align__(16) Stage stages[STAGES];
  __shared__ float inv_c[MAXL], inv_r[MAXL];
  __shared__ float rowmax[MAXL];
  __shared__ uint32_t colkey[MAXL];
  __shared__ bool valid_c[MAXL], valid_r[MAXL];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* c = cand + static_cast<int64_t>(b) * lc * d;
  const float* r = ref + static_cast<int64_t>(b) * lr * d;
  const int n_ct = (lc + T - 1) / T, n_rt = (lr + T - 1) / T, n_k = (d + DK - 1) / DK;
  const int steps = n_ct * n_rt * n_k;

  // step s: tile pair s / n_k (candidate tile outer), k-slice s % n_k
  auto stage_load = [&](int s) {
    if (s < steps) {
      const int pair = s / n_k, kk = s - pair * n_k;
      load_stage<VEC>(stages[s % STAGES], c, r, lc, lr, d, (pair / n_rt) * T,
                      (pair % n_rt) * T, kk * DK);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage_load(s);

  for (int i = tid; i < lc; i += NT) {
    rowmax[i] = NEG_INF;
    valid_c[i] = cmask[static_cast<int64_t>(b) * lc + i] > 0.5f;
  }
  for (int j = tid; j < lr; j += NT) {
    colkey[j] = order_key(NEG_INF);
    valid_r[j] = rmask[static_cast<int64_t>(b) * lr + j] > 0.5f;
  }

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float nrm = 0.f;  // thread t: squared norm of candidate row t / reference row t - 64
  const int my_row = tid & (T - 1);
  const bool my_cand = tid < T;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_prev();
    __syncthreads();  // slice s landed for every thread; slice s - 1 is consumed
    stage_load(s + STAGES - 1);
    const Stage& st = stages[s % STAGES];
    const int pair = s / n_k, kk = s - pair * n_k;
    const int ct = pair / n_rt, rt = pair - ct * n_rt;
    const bool first_visit = my_cand ? rt == 0 : ct == 0;

    if (first_visit) {
      const float* row = my_cand ? st.c[my_row] : st.r[my_row];
#pragma unroll
      for (int q = 0; q < DK / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(row + 4 * q);
        nrm = fmaf(v.x, v.x, nrm);
        nrm = fmaf(v.y, v.y, nrm);
        nrm = fmaf(v.z, v.z, nrm);
        nrm = fmaf(v.w, v.w, nrm);
      }
    }

#pragma unroll
    for (int k8 = 0; k8 < DK / 8; ++k8) {
      const int kc = 8 * k8 + t;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(st.c[16 * warp + g][kc], a_hi[0], a_lo[0]);
      split_tf32(st.c[16 * warp + g + 8][kc], a_hi[1], a_lo[1]);
      split_tf32(st.c[16 * warp + g][kc + 4], a_hi[2], a_lo[2]);
      split_tf32(st.c[16 * warp + g + 8][kc + 4], a_hi[3], a_lo[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
        split_tf32(st.r[8 * nt + g][kc], b_hi0, b_lo0);
        split_tf32(st.r[8 * nt + g][kc + 4], b_hi1, b_lo1);
        mma_tf32(acc[nt], a_lo, b_hi0, b_hi1);
        mma_tf32(acc[nt], a_hi, b_lo0, b_lo1);
        mma_tf32(acc[nt], a_hi, b_hi0, b_hi1);
      }
    }

    if (kk == n_k - 1) {  // the pair's product is complete: its epilogue
      if (first_visit) {
        const int row = (my_cand ? ct : rt) * T + my_row;
        if (row < (my_cand ? lc : lr))
          (my_cand ? inv_c : inv_r)[row] = rsqrtf(fmaxf(nrm, 1e-18f));
        nrm = 0.f;
      }
      __syncthreads();  // norms of both tiles, and the masks, are in place
      const int i0 = ct * T + 16 * warp + g, i1 = i0 + 8;
      const bool vc0 = i0 < lc && valid_c[i0], vc1 = i1 < lc && valid_c[i1];
      const float ic0 = vc0 ? inv_c[i0] : 0.f, ic1 = vc1 ? inv_c[i1] : 0.f;
      float m0 = NEG_INF, m1 = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = rt * T + 8 * nt + 2 * t + e;
          const bool vr = j < lr && valid_r[j];
          const float ir = vr ? inv_r[j] : 0.f;
          // masked pairs, and pairs past the edge, take exactly -1e30
          const float s0 = (vc0 && vr) ? acc[nt][e] * ic0 * ir : NEG_INF;
          const float s1 = (vc1 && vr) ? acc[nt][2 + e] * ic1 * ir : NEG_INF;
          m0 = fmaxf(m0, s0);
          m1 = fmaxf(m1, s1);
          float cm = fmaxf(s0, s1);
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 4));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 8));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
          if (g == 0 && j < lr) atomicMax(&colkey[j], order_key(cm));
          acc[nt][e] = acc[nt][2 + e] = 0.f;
        }
      }
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      if (t == 0) {  // a row belongs to this warp alone
        if (i0 < lc) rowmax[i0] = fmaxf(rowmax[i0], m0);
        if (i1 < lc) rowmax[i1] = fmaxf(rowmax[i1], m1);
      }
    }
  }
  __syncthreads();

  // P by warp 0, R by warp 1: lanes over tokens in index order, then a
  // fixed shuffle tree
  if (warp < 2) {
    const int len = warp == 0 ? lc : lr;
    float sum = 0.f, cnt = 0.f;
    for (int i = lane; i < len; i += 32) {
      if (warp == 0 ? valid_c[i] : valid_r[i]) {
        sum += warp == 0 ? rowmax[i] : key_value(colkey[i]);
        cnt += 1.f;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_down_sync(0xffffffffu, sum, o);
      cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    }
    if (lane == 0) (warp == 0 ? p_out : r_out)[b] = sum / fmaxf(cnt, 1.f);
  }
}

const void* kernel_fn(bool vec) {
  return vec ? reinterpret_cast<const void*>(bertscore_kernel<true>)
             : reinterpret_cast<const void*>(bertscore_kernel<false>);
}

}  // namespace

// cand (B, Lc, D), ref (B, Lr, D), cmask (B, Lc), rmask (B, Lr): contiguous
// f32, masks 0/1.  p, r: (B,) f32 outputs.  Returns the launch's cudaError_t.
extern "C" int repro_bertscore_pr(const void* cand, const void* ref,
                                  const void* cmask, const void* rmask, int b,
                                  int lc, int lr, int d, void* p, void* r,
                                  void* stream) {
  if (b <= 0 || lc < 1 || lc > MAXL || lr < 1 || lr > MAXL || d < 1 || d > MAXD)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(cand) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ref) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cand);
  const float* rf = static_cast<const float*>(ref);
  const float* cm = static_cast<const float*>(cmask);
  const float* rm = static_cast<const float*>(rmask);
  if (vec)
    bertscore_kernel<true><<<b, NT, 0, s>>>(c, rf, cm, rm, lc, lr, d,
                                            static_cast<float*>(p), static_cast<float*>(r));
  else
    bertscore_kernel<false><<<b, NT, 0, s>>>(c, rf, cm, rm, lc, lr, d,
                                             static_cast<float*>(p), static_cast<float*>(r));
  return static_cast<int>(cudaGetLastError());
}

// Registers, local (spill) bytes a thread, shared memory a block and
// resident blocks an SM of the kernel with 16-byte staging (which = 0) or
// 4-byte staging (which = 1), as the runtime reports them.
extern "C" int repro_bertscore_kernel_info(int which, int* regs, int* local_bytes,
                                           int* smem_bytes, int* blocks_per_sm) {
  if (which < 0 || which > 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_fn(which == 0);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}
