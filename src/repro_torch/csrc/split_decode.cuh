// Span-split GQA decode attention over f32 K/V rows: the one device code
// path of the contiguous-cache kernel (decode_attention.cu) and the paged
// one (paged_decode_attention.cu).
//
// One block of 128 threads per (span of SPAN positions, KV head,
// sequence), grid (n_span, K, B); blocks past a sequence's length return
// before any barrier.  Warp w owns the span's rows w, w + 4, ..., w + 124
// (dealt in turn, so a span shorter than 128 rows still keeps all four
// warps busy):
//   1. lane l computes the K and V offsets of row w + 4 l (a page-table
//      load in the paged kernel, all of a span's in flight together, with
//      the query's loads, one column a thread, before the sequence's
//      length has arrived), then the warp copies its rows' K into shared
//      memory with cp.async, 16 bytes a lane (a 512-byte f32 row is one
//      warp-wide copy), as four commit groups of 8 rows, and the query
//      goes through shared memory to the lanes that score with it;
//   2. the warp scores each group as it lands (a row is 8 lanes of 16 d
//      for G <= 4, or 16 lanes of 8 d for G <= 8, every query head of the
//      KV group at once, f32 FMA, then a butterfly sum), and puts the V
//      copies of the group's rows where its K rows were: only the warp
//      reads them, so a __syncwarp is the only wait, and V is in flight
//      while the rest of K is scored;
//   3. the block's softmax over the span (max m, sum of exps l, per head);
//   4. P V: lane l owns output columns 4 l .. 4 l + 3 (one 16-byte load of
//      V a row), over the warp's rows as their V groups land; the four
//      warps' sums are added in warp order;
//   5. the finish.  A sequence of one span writes acc / l.  Otherwise the
//      block writes its partial (m, l, acc) of each query head to scratch,
//      and the block that arrives last at a per-(sequence, KV head)
//      counter (atomicInc, which wraps it back to 0) combines every span
//      in span order: out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M).
//      The arithmetic does not depend on which block combines, so the
//      arrival order never changes the bits.
// One launch a call: a second (combine) launch would add a device kernel
// and its gap to every decode call, also where each sequence has one span
// (the contiguous main path's lengths 11..45).
//
// SPAN is a constant, never derived from S, the batch, the occupancy or
// the page size, and the tile order and every reduction order depend on
// positions alone.  The two kernels differ only in how a position becomes
// a row's offset (row_offsets below), so on the same rows the paged
// kernel is bit-equal to the contiguous one at any page size, and a
// sequence's bits depend on its own rows alone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage (the unnamed namespace): each source that includes this
// gets its own kernels and its own "attribute set" flags, which would
// otherwise be one process-wide symbol shared by every library built from
// this header.
namespace split_decode {
namespace {

constexpr int D = 128;           // head_dim (qwen3-4b)
constexpr int SPAN = 128;        // positions a block; a constant (above)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int WARP_ROWS = SPAN / NWARPS;       // a warp's rows of the span
constexpr int NGROUP = 4;                      // cp.async groups a warp
constexpr int GROUP_ROWS = WARP_ROWS / NGROUP;
constexpr int MAXG = 8;                        // query heads per KV head
constexpr int SMEM_BYTES = SPAN * D * 4;       // K rows, then V rows (dynamic)
static_assert(WARP_ROWS <= 32 && D == NTHREADS && D == 4 * 32 && NGROUP <= 4,
              "a lane's row offset, a thread's column, a lane's float4 of a "
              "row, cp_async_wait_dyn's range");

struct Args {
  const __nv_bfloat16* q;  // (B, 1, H, d)
  const float* k;          // contiguous (B, S, K, d) or pool (P, ps, K, d)
  const float* v;
  const int* tables;       // paged: (B, n_table) int32
  const int* lengths;      // (B,) int32
  __nv_bfloat16* out;      // (B, 1, H, d)
  float* part_acc;         // (B, K, n_span, G, d) unnormalised P V
  float* part_ml;          // (B, K, n_span, G, 2) max and sum of exps
  unsigned* arrivals;      // (B, K) zero between calls
  int group, n_kv, n_span;
  int limit;               // lengths above it are read as it: S or n_table * ps
  int page_size, n_table;  // paged only
  int64_t q_sb, q_sh;
  // (batch, position, head) of the cache, or (page, row, head) of the pool
  int64_t k_s0, k_s1, k_s2, v_s0, v_s1, v_s2;
  int64_t o_sb, o_sh;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// wait until at most n (0 .. 3) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// Where position `pos` of sequence b lives, for KV head kh, in elements:
// the only place the two kernels differ.
template <bool PAGED>
__device__ __forceinline__ void row_offsets(const Args& a, int b, int kh, int pos,
                                            int64_t* ko, int64_t* vo) {
  int64_t i0, i1;
  if (PAGED) {
    i0 = a.tables[static_cast<int64_t>(b) * a.n_table + pos / a.page_size];
    i1 = pos % a.page_size;
  } else {
    i0 = b;
    i1 = pos;
  }
  *ko = i0 * a.k_s0 + i1 * a.k_s1 + kh * a.k_s2;
  *vo = i0 * a.v_s0 + i1 * a.v_s1 + kh * a.v_s2;
}

// GM: the most query heads per KV head it serves (4 or 8).
template <bool PAGED, int GM>
__global__ void __launch_bounds__(NTHREADS, 3) split_kernel(const Args a) {
  constexpr int LPR = GM <= 4 ? 8 : 16;  // lanes a row in the scores
  constexpr int EPL = D / LPR;           // d elements a lane: EPL / 4 float4
  constexpr int RPI = 32 / LPR;          // rows a warp scores at once
  extern __shared__ __align__(16) float s_kv[];  // [SPAN][D]
  __shared__ __align__(16) float s_p[SPAN][GM];  // scores, then probabilities
  __shared__ __align__(16) float s_q[GM][D];
  __shared__ float s_m[GM];
  __shared__ float s_l[GM];
  __shared__ int s_last;

  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = a.group;
  const int p0 = sp * SPAN;
  // this warp's i-th row of the span: rows are dealt to the warps in turn,
  // so a short span keeps all four warps busy
  auto row = [warp](int i) { return warp + NWARPS * i; };

  // the query (a column a thread) and row(lane)'s offsets (its page id
  // in the paged kernel) do not depend on the length: in flight before it
  __nv_bfloat16 qraw[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g)
    if (g < group) qraw[g] = a.q[b * a.q_sb + (kh * group + g) * a.q_sh + tid];
  int64_t ko, vo;
  row_offsets<PAGED>(a, b, kh, min(p0 + row(lane), a.limit - 1), &ko, &vo);

  const int len = min(a.lengths[b], a.limit);
  __nv_bfloat16* out = a.out + b * a.o_sb + kh * group * a.o_sh;
  if (p0 >= len) {  // past this sequence: the whole block, no barrier yet
    if (sp == 0)    // no visible position at all
      for (int g = 0; g < group; ++g) out[g * a.o_sh + tid] = __float2bfloat16(0.f);
    return;
  }
  const int nrow = min(SPAN, len - p0);

  // the K copies in NGROUP commit groups (a group past the span's last row
  // is empty; every test of `live` below is the same across the warp)
  auto live = [&](int i) { return row(i) < nrow; };
#pragma unroll
  for (int c = 0; c < NGROUP; ++c) {
    if (live(GROUP_ROWS * c)) {
#pragma unroll
      for (int i = 0; i < GROUP_ROWS; ++i) {
        const int64_t off = __shfl_sync(0xffffffffu, ko, GROUP_ROWS * c + i);
        const int r = row(GROUP_ROWS * c + i);
        if (r < nrow) cp_async16(s_kv + r * D + 4 * lane, a.k + off + 4 * lane);
      }
    }
    cp_async_commit();
  }

  // a lane's share of every head's query: float4 chunks sl, sl + LPR, ...
#pragma unroll
  for (int g = 0; g < GM; ++g)
    if (g < group) s_q[g][tid] = __bfloat162float(qraw[g]);
  __syncthreads();
  const int sl = lane % LPR;
  float qf[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e4 = 0; e4 < EPL / 4; ++e4) {
      const float4 q4 = g < group
                            ? *reinterpret_cast<const float4*>(&s_q[g][4 * (sl + LPR * e4)])
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      qf[g][4 * e4] = q4.x; qf[g][4 * e4 + 1] = q4.y;
      qf[g][4 * e4 + 2] = q4.z; qf[g][4 * e4 + 3] = q4.w;
    }

  // scores, a group of rows as it lands; then its V rows replace its K rows
#pragma unroll
  for (int c = 0; c < NGROUP; ++c) {
    cp_async_wait<NGROUP - 1>();  // K group c (later K and earlier V pending)
    __syncwarp();
    if (!live(GROUP_ROWS * c)) {
      cp_async_commit();  // the group's (empty) V copies, to keep the count
      continue;
    }
#pragma unroll
    for (int it = 0; it < GROUP_ROWS / RPI; ++it) {
      if (!live(GROUP_ROWS * c + RPI * it)) break;
      const int r = row(GROUP_ROWS * c + RPI * it + lane / LPR);
      float part[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) part[g] = 0.f;
      if (r < nrow) {
        const float* kr = s_kv + r * D;
#pragma unroll
        for (int e4 = 0; e4 < EPL / 4; ++e4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + 4 * (sl + LPR * e4));
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            part[g] = fmaf(qf[g][4 * e4], k4.x, part[g]);
            part[g] = fmaf(qf[g][4 * e4 + 1], k4.y, part[g]);
            part[g] = fmaf(qf[g][4 * e4 + 2], k4.z, part[g]);
            part[g] = fmaf(qf[g][4 * e4 + 3], k4.w, part[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (sl == 0 && r < nrow) {
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < group) s_p[r][g] = part[g] * a.scale;
      }
    }
    __syncwarp();  // the group's K rows are read
#pragma unroll
    for (int i = 0; i < GROUP_ROWS; ++i) {
      const int64_t off = __shfl_sync(0xffffffffu, vo, GROUP_ROWS * c + i);
      const int r = row(GROUP_ROWS * c + i);
      if (r < nrow) cp_async16(s_kv + r * D + 4 * lane, a.v + off + 4 * lane);
    }
    cp_async_commit();
  }
  __syncthreads();

  // softmax over the span: warp w takes heads w, w + 4; lane rows l + 32 k
  for (int g = warp; g < group; g += NWARPS) {
    float x[SPAN / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < SPAN / 32; ++k) {
      x[k] = lane + 32 * k < nrow ? s_p[lane + 32 * k][g] : -INFINITY;
      mx = fmaxf(mx, x[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;  // row 0 of the span is visible, so mx is finite
#pragma unroll
    for (int k = 0; k < SPAN / 32; ++k) {
      const float p = expf(x[k] - mx);
      s_p[lane + 32 * k][g] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      s_m[g] = mx;
      s_l[g] = sum;
    }
  }
  __syncthreads();

  // P V over the warp's rows, a V group as it lands
  float acc[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int c = 0; c < NGROUP; ++c) {
    cp_async_wait_dyn(NGROUP - 1 - c);
    __syncwarp();
    // rows grow with i: the group's visible ones are i < iend
    const int iend = min(GROUP_ROWS * (c + 1), (nrow - warp + NWARPS - 1) / NWARPS);
#pragma unroll 4
    for (int i = GROUP_ROWS * c; i < iend; ++i) {
      const int r = row(i);
      const float4 v4 = *reinterpret_cast<const float4*>(s_kv + r * D + 4 * lane);
      float pr[GM];
#pragma unroll
      for (int g = 0; g < GM; g += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&s_p[r][g]);
        pr[g] = p4.x; pr[g + 1] = p4.y; pr[g + 2] = p4.z; pr[g + 3] = p4.w;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        acc[g][0] = fmaf(pr[g], v4.x, acc[g][0]);
        acc[g][1] = fmaf(pr[g], v4.y, acc[g][1]);
        acc[g][2] = fmaf(pr[g], v4.z, acc[g][2]);
        acc[g][3] = fmaf(pr[g], v4.w, acc[g][3]);
      }
    }
  }
  // the warps' sums, kept where the rows were, added in warp order
  static_assert(NWARPS * MAXG * D * 4 <= SMEM_BYTES, "P V sums fit over the rows");
  float (*s_acc)[GM][D] = reinterpret_cast<float (*)[GM][D]>(s_kv);
  __syncthreads();  // every warp is done with its V rows
#pragma unroll
  for (int g = 0; g < GM; ++g)
    *reinterpret_cast<float4*>(&s_acc[warp][g][4 * lane]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  float o[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    o[g] = s_acc[0][g][tid];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) o[g] += s_acc[w][g][tid];
  }

  const int ns = (len + SPAN - 1) / SPAN;
  if (ns == 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < group) out[g * a.o_sh + tid] = __float2bfloat16(o[g] / fmaxf(s_l[g], 1e-37f));
    return;
  }
  const int64_t seq = static_cast<int64_t>(b) * a.n_kv + kh;
  const int64_t pbase = (seq * a.n_span + sp) * group;  // partial (sp, g) at row pbase + g
#pragma unroll
  for (int g = 0; g < GM; ++g)
    if (g < group) a.part_acc[(pbase + g) * D + tid] = o[g];
  if (tid < group)
    *reinterpret_cast<float2*>(a.part_ml + 2 * (pbase + tid)) = make_float2(s_m[tid], s_l[tid]);
  __threadfence();  // the partial is visible on the card before the arrival
  __syncthreads();
  if (tid == 0) s_last = atomicInc(a.arrivals + seq, ns - 1) == static_cast<unsigned>(ns - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: every span's partial, in span order (read through L2)
  const int64_t base = seq * a.n_span * group;
  for (int g = 0; g < group; ++g) {
    float m = -INFINITY;
    for (int s = 0; s < ns; ++s) m = fmaxf(m, __ldcg(a.part_ml + 2 * (base + s * group + g)));
    float l = 0.f, acc_o = 0.f;
    for (int s = 0; s < ns; ++s) {
      const int64_t i = base + s * group + g;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.part_ml + 2 * i));
      const float w = expf(ml.x - m);
      l = fmaf(ml.y, w, l);
      acc_o = fmaf(__ldcg(a.part_acc + i * D + tid), w, acc_o);
    }
    out[g * a.o_sh + tid] = __float2bfloat16(acc_o / fmaxf(l, 1e-37f));
  }
}

template <bool PAGED, int GM>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      split_kernel<PAGED, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  done = err == cudaSuccess;
  return err;
}

// Checks the geometry, the rows' alignment and the scratch (partials of
// (B, K, n_span, G) rows of d + 2 floats, n_span = ceil(limit / SPAN); B *
// K arrival counters), sets the scratch fields of `a` (the caller fills
// the rest), launches on `stream` and returns the launch's cudaError_t.
template <bool PAGED>
int launch(Args a, int batch, int n_heads, int head_dim, void* scratch,
           int64_t n_scratch, void* arrivals, int64_t n_arrivals, void* stream) {
  if (batch <= 0 || batch > 65535 || a.n_kv <= 0 || a.n_kv > 65535 ||
      n_heads % a.n_kv != 0 || n_heads / a.n_kv > MAXG || head_dim != D ||
      a.limit <= 0 || a.group != n_heads / a.n_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies: every row and both bases aligned
  const int64_t row_strides[6] = {a.k_s0, a.k_s1, a.k_s2, a.v_s0, a.v_s1, a.v_s2};
  for (int64_t st : row_strides)
    if (st % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(a.k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_span = (static_cast<int64_t>(a.limit) + SPAN - 1) / SPAN;
  const int64_t rows = static_cast<int64_t>(batch) * a.n_kv * n_span * a.group;
  if (n_span > 65535 || n_scratch < rows * (D + 2) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 || arrivals == nullptr ||
      n_arrivals < static_cast<int64_t>(batch) * a.n_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  a.n_span = static_cast<int>(n_span);
  a.part_acc = static_cast<float*>(scratch);
  a.part_ml = a.part_acc + rows * D;
  a.arrivals = static_cast<unsigned*>(arrivals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_span), a.n_kv, batch);
  cudaError_t err;
  if (a.group <= 4) {
    err = configure<PAGED, 4>();
    if (err == cudaSuccess) split_kernel<PAGED, 4><<<grid, NTHREADS, SMEM_BYTES, s>>>(a);
  } else {
    err = configure<PAGED, 8>();
    if (err == cudaSuccess) split_kernel<PAGED, 8><<<grid, NTHREADS, SMEM_BYTES, s>>>(a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local (spill) bytes a thread, shared memory a block (static
// and dynamic) and resident blocks an SM of split_kernel<PAGED, GM>.
template <bool PAGED, int GM>
int kernel_info(int* regs, int* local_bytes, int* smem_bytes, int* blocks_per_sm) {
  const void* fn = reinterpret_cast<const void*>(split_kernel<PAGED, GM>);
  cudaError_t err = configure<PAGED, GM>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, NTHREADS,
                                                        SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes) + SMEM_BYTES;
  return static_cast<int>(cudaSuccess);
}

}  // namespace
}  // namespace split_decode

// The paged kernel's figures (paged_decode_attention.cu), reached through
// repro_decode_kernel_info.
extern "C" int repro_paged_decode_kernel_info(int gm8, int* regs, int* local_bytes,
                                              int* smem_bytes, int* blocks_per_sm);
