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
// The TPU kernel walks reference tiles along a sequential grid axis and
// keeps the running row maxima in VMEM scratch.  Here one block owns one
// example and loops over (candidate tile, reference tile) pairs itself: the
// running row maxima and column maxima of the whole example live in shared
// memory, so the (Lc, Lr) matrix never reaches device memory and no sum
// crosses blocks.  First every row's inverse norm rsqrt(max(|x|^2, 1e-18))
// is taken, as the Pallas kernel normalises; then 32-column slices of a
// 64-row candidate tile and a 64-row reference tile are staged in shared
// memory already normalised, and each thread accumulates a 4 x 4 block of
// the 64 x 64 tile in plain f32 FMA, columns in index order.  No TF32, no
// tensor cores (the reference's product is f32; TF32 would move P and R by
// ~1e-3), no atomics: every sum has one fixed order inside its block, so an
// example's P and R are the same bits alone or in any batch.
//
// Bound on the H100: 2 Lc Lr D FLOPs per example against reading its
// (Lc + Lr) D f32 embeddings once.  At the metric's 64 x 64 x 256 that is
// 16 FLOPs a byte, under the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so
// the bound is the bytes; this kernel does not reach it (16 blocks at the
// main path's chunk of 16, CUDA-core FMA).
//
// Limits: 1 <= Lc, Lr <= 512 (the per-example maxima in shared memory) and
// 1 <= D <= 1024; the wrapper raises outside them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXL = 512;   // tokens per side
constexpr int MAXD = 1024;  // embedding width
constexpr int T = 64;       // rows per candidate tile and per reference tile
constexpr int DK = 32;      // embedding columns staged per step
constexpr int NT = 256;     // threads: 16 x 16, each a 4 x 4 block of the tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT)
bertscore_kernel(const float* __restrict__ cand, const float* __restrict__ ref,
                 const float* __restrict__ cmask,
                 const float* __restrict__ rmask, int lc, int lr, int d,
                 float* __restrict__ p_out, float* __restrict__ r_out) {
  __shared__ float inv_c[MAXL], inv_r[MAXL];
  __shared__ float rowmax[MAXL], colmax[MAXL];
  __shared__ bool valid_c[MAXL], valid_r[MAXL];
  __shared__ float cs[T][DK + 1], rs[T][DK + 1];
  __shared__ float sim[T][T + 1];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* c = cand + static_cast<int64_t>(b) * lc * d;
  const float* r = ref + static_cast<int64_t>(b) * lr * d;

  // inverse row norms: one warp a row, lanes strided over the width
  for (int row = warp; row < lc + lr; row += NT / 32) {
    const float* x = row < lc ? c + static_cast<int64_t>(row) * d
                              : r + static_cast<int64_t>(row - lc) * d;
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s = fmaf(x[k], x[k], s);
    s = warp_sum(s);
    if (lane == 0) {
      const float inv = rsqrtf(fmaxf(s, 1e-18f));
      if (row < lc) inv_c[row] = inv;
      else inv_r[row - lc] = inv;
    }
  }
  for (int i = tid; i < lc; i += NT) {
    rowmax[i] = NEG_INF;
    valid_c[i] = cmask[static_cast<int64_t>(b) * lc + i] > 0.5f;
  }
  for (int j = tid; j < lr; j += NT) {
    colmax[j] = NEG_INF;
    valid_r[j] = rmask[static_cast<int64_t>(b) * lr + j] > 0.5f;
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  for (int c0 = 0; c0 < lc; c0 += T) {
    for (int r0 = 0; r0 < lr; r0 += T) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
      for (int k0 = 0; k0 < d; k0 += DK) {
        // stage normalised slices; rows and columns past the edge are 0
        for (int e = tid; e < T * DK; e += NT) {
          const int i = e / DK, k = e % DK;
          const bool kin = k0 + k < d;
          cs[i][k] = (kin && c0 + i < lc)
                         ? c[static_cast<int64_t>(c0 + i) * d + k0 + k] * inv_c[c0 + i]
                         : 0.f;
          rs[i][k] = (kin && r0 + i < lr)
                         ? r[static_cast<int64_t>(r0 + i) * d + k0 + k] * inv_r[r0 + i]
                         : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < DK; ++k) {
          float cv[4], rv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = cs[ty + 16 * a][k];
#pragma unroll
          for (int e = 0; e < 4; ++e) rv[e] = rs[tx + 16 * e][k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(cv[a], rv[e], acc[a][e]);
        }
        __syncthreads();
      }
      // masked pairs, and pairs past the edge, take exactly -1e30
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ty + 16 * a, j = tx + 16 * e;
          const bool ok = c0 + i < lc && r0 + j < lr && valid_c[c0 + i] &&
                          valid_r[r0 + j];
          sim[i][j] = ok ? acc[a][e] : NEG_INF;
        }
      }
      __syncthreads();
      if (tid < T) {
        const int i = tid;
        if (c0 + i < lc) {
          float m = rowmax[c0 + i];
          const int nj = min(T, lr - r0);
          for (int j = 0; j < nj; ++j) m = fmaxf(m, sim[i][j]);
          rowmax[c0 + i] = m;
        }
      } else if (tid < 2 * T) {
        const int j = tid - T;
        if (r0 + j < lr) {
          float m = colmax[r0 + j];
          const int ni = min(T, lc - c0);
          for (int i = 0; i < ni; ++i) m = fmaxf(m, sim[i][j]);
          colmax[r0 + j] = m;
        }
      }
      __syncthreads();
    }
  }

  if (tid == 0) {
    float sp = 0.f, np = 0.f, sr = 0.f, nr = 0.f;
    for (int i = 0; i < lc; ++i) {
      if (valid_c[i]) {
        sp += rowmax[i];
        np += 1.f;
      }
    }
    for (int j = 0; j < lr; ++j) {
      if (valid_r[j]) {
        sr += colmax[j];
        nr += 1.f;
      }
    }
    p_out[b] = sp / fmaxf(np, 1.f);
    r_out[b] = sr / fmaxf(nr, 1.f);
  }
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
  bertscore_kernel<<<b, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const float*>(ref),
      static_cast<const float*>(cmask), static_cast<const float*>(rmask), lc,
      lr, d, static_cast<float*>(p), static_cast<float*>(r));
  return static_cast<int>(cudaGetLastError());
}
