// GQA decode attention over the f32 page pool (paged_decode_attention.cu).
//
// The structure is decode_attention.cu's, row for row: one block per
// (sequence, KV head) serving all G query heads of the group, 32-row tiles
// of *positions* walked in order up to the sequence's length, the same
// score, online-softmax and P V arithmetic in the same order.  Only the
// address of a row changes: position p lives in pool page
// tables[b][p / ps] at row p % ps.  At the top of every tile the first 32
// threads look up their row's page once and leave its offsets in shared
// memory.  So the result does not depend on the page size, and on the same
// rows it is bit-equal to the contiguous kernel (DESIGN.md section 8's
// page-size invariance).  The int8 pool has its own kernel
// (quant_paged_decode_attention.cu).
//
// Pool layout is the model's, (P, ps, K, d), read through strides.  Table
// entries past ceil(length / ps) are padding: they must be valid page ids
// and are never read.  Pages may appear in several tables (prefix
// sharing); the kernel only reads them.  Lengths above nP * ps are read as
// nP * ps, which is what the plain version's mask does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged {

constexpr int D = 128;       // head_dim (qwen3-4b)
constexpr int EPL = D / 32;  // d elements per lane in the Q K dot
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int T = 32;        // positions per tile
constexpr int MAXG = 8;      // query heads per KV head

struct Args {
  const __nv_bfloat16* q;   // (B, 1, H, d)
  const float* k;           // pool (P, ps, K, d)
  const float* v;
  const int* tables;        // (B, n_table) int32
  const int* lengths;       // (B,) int32
  __nv_bfloat16* out;       // (B, 1, H, d)
  int group, page_size, n_table;
  int64_t q_sb, q_sh;
  int64_t k_sp, k_sr, k_sh, v_sp, v_sr, v_sh;
  int64_t o_sb, o_sh;
  float scale;
};

__global__ void __launch_bounds__(NTHREADS) paged_decode_kernel(const Args a) {
  __shared__ float s_p[MAXG][T];  // scores, then probabilities
  __shared__ float s_m[MAXG];
  __shared__ float s_l[MAXG];
  __shared__ float s_c[MAXG];
  __shared__ int64_t s_krow[T];   // element offset of each tile row (this head)
  __shared__ int64_t s_vrow[T];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = a.group;
  const int len = min(a.lengths[b], a.n_table * a.page_size);
  const int* tab = a.tables + static_cast<int64_t>(b) * a.n_table;

  float qf[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qf[g][e] = g < group
                     ? __bfloat162float(a.q[b * a.q_sb + (kh * group + g) * a.q_sh +
                                            lane * EPL + e])
                     : 0.f;
  if (tid < MAXG) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  for (int k0 = 0; k0 < len; k0 += T) {
    __syncthreads();  // the previous tile's probabilities and rows are consumed
    if (tid < T && k0 + tid < len) {
      const int pos = k0 + tid;
      const int64_t page = tab[pos / a.page_size];
      const int64_t off = pos % a.page_size;
      s_krow[tid] = page * a.k_sp + off * a.k_sr + kh * a.k_sh;
      s_vrow[tid] = page * a.v_sp + off * a.v_sr + kh * a.v_sh;
    }
    __syncthreads();

    // scores: warp w owns rows k0 + w*T/4 ...; lanes split d, then reduce
#pragma unroll
    for (int jj = 0; jj < T / NWARPS; ++jj) {
      const int j = warp * (T / NWARPS) + jj;
      const int kpos = k0 + j;
      float part[MAXG];
      if (kpos < len) {
        float kf[EPL];
        const float4 k4 = *reinterpret_cast<const float4*>(
            a.k + s_krow[j] + lane * EPL);
        kf[0] = k4.x; kf[1] = k4.y; kf[2] = k4.z; kf[3] = k4.w;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          float acc_g = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc_g = fmaf(qf[g][e], kf[e], acc_g);
          part[g] = acc_g;
        }
      } else {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < group) s_p[g][j] = kpos < len ? part[g] * a.scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w updates heads w, w + 4, ...; lane = row in tile
    for (int g = warp; g < group; g += NWARPS) {
      const float x = s_p[g][lane];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);  // row k0 < len is always visible
      const float p = expf(x - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      s_p[g][lane] = p;
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        s_c[g] = c;
        s_l[g] = s_l[g] * c + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // P V: thread t owns output column t for every head of the group
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < group) acc[g] *= s_c[g];
      const int nk = min(T, len - k0);
      for (int j = 0; j < nk; ++j) {
        const float vv = a.v[s_vrow[j] + tid];
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < group) acc[g] = fmaf(s_p[g][j], vv, acc[g]);
      }
    }
  }
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < group)
        a.out[b * a.o_sb + (kh * group + g) * a.o_sh + tid] =
            __float2bfloat16(acc[g] / fmaxf(s_l[g], 1e-37f));
  }
}

// Checks the geometry, launches on ``stream`` and returns the launch's
// cudaError_t.
inline int launch(const Args& a, int batch, int n_heads, int n_kv_heads, int head_dim,
                  void* stream) {
  if (batch <= 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      head_dim != D || a.page_size <= 0 || a.n_table <= 0 ||
      n_heads / n_kv_heads > MAXG || a.group != n_heads / n_kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_kv_heads, batch);
  paged_decode_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paged
