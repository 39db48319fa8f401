// GQA decode attention over the int8 page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/paged_quant.py:quant_paged_decode_attention
// which gathers int8 pool pages through the prefetched page table and
// dequantizes each (ps, d) tile in VMEM with its (page, KV head) f32 scale
// right before the matrix products.
//
// Two launches on one stream, no atomics:
//   1. split: one block per (sequence, KV head, span of SPAN positions).
//      Its 128 threads look up each row's page in the sequence's own table
//      and copy the span's K rows, then its V rows, into shared memory with
//      cp.async, 16 bytes a thread (a 128-byte int8 row is 8 lanes), as two
//      commit groups: the V copies are in flight while the K rows are
//      scored.  A score is k_scale (q . k_int) with the int8 row converted
//      in registers (the scale is constant over a row); a V row is
//      dequantized in registers as int8 * scale in f32, the reference's
//      product.  Scores, softmax and P V are f32 FMA for every query head
//      of the KV group; P V is summed per warp over 32 rows, then over the
//      4 warps in order.  The block writes its partial (m, l, acc) for the
//      G query heads to scratch.
//   2. combine: one block per (sequence, query head) reduces the partials
//      in span order, out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M).
// SPAN is a compile-time constant, never derived from the batch, the
// occupancy or the page size, so a sequence's result depends on its own
// rows alone, and the same values give the same bits at any page size.
//
// The current token: the reference's decode writes the new K/V row into
// its dequantized f32 view, attends over that view, and only then
// requantizes the write page.  So the token attends to its own K/V
// unquantized.  Given k_new / v_new (B, K, d) f32 and new_pos (B,), the
// kernel reads those rows in place of pool row new_pos[b] (where that is
// below the length); with null pointers it computes exactly the TPU
// kernel's function.  Table entries past ceil(length / ps) are never
// read; lengths above nP * ps are read as nP * ps.
//
// Bound on the H100: bytes, d bytes per row and KV head for K and for V
// plus a 4-byte scale per page and KV head, an aliased page once.  At the
// main path's lengths (16 sequences of ~500 positions sharing a 29-page
// header) the distinct rows are ~2 MB, L2-resident, so latency, not
// bandwidth, limits it: the span split puts 512 blocks in flight where one
// block per (sequence, KV head) put 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head_dim (qwen3-4b)
constexpr int SPAN = 128;     // positions a split block; a constant (above)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;       // query heads per KV head
static_assert(SPAN == 32 * NWARPS && D == NTHREADS, "a warp's 32 rows, a thread's column");

struct Args {
  const __nv_bfloat16* q;   // (B, 1, H, d)
  const int8_t* k;          // pool (P, ps, K, d)
  const int8_t* v;
  const float* k_scale;     // (P, K) per-(page, KV head) scales
  const float* v_scale;
  const float* k_new;       // optional: (B, K, d) f32 current-token rows
  const float* v_new;
  const int* new_pos;       // with k_new: (B,) position they replace
  const int* tables;        // (B, n_table) int32
  const int* lengths;       // (B,) int32
  __nv_bfloat16* out;       // (B, 1, H, d)
  float* part_acc;          // (B, K, n_span, G, d) unnormalised P V
  float* part_ml;           // (B, K, n_span, G, 2) max and sum of exp
  int group, page_size, n_table, n_kv, n_span;
  int64_t q_sb, q_sh;
  int64_t k_sp, k_sr, k_sh, v_sp, v_sr, v_sh;
  int64_t ks_sp, ks_sh, vs_sp, vs_sh;
  int64_t n_sb, n_sh;
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

// Byte e of w as a signed int8, in f32
__device__ __forceinline__ float s8_to_f32(uint32_t w, int e) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * e)));
}

__device__ __forceinline__ int seq_len(const Args& a, int b) {
  return min(a.lengths[b], a.n_table * a.page_size);
}

// Where thread t's rows of the span live: thread t copies 16-byte chunk
// t % 8 of rows t / 8 + 16 i (a 128-byte row is 8 lanes), for both pools.
constexpr int ROWS_A_THREAD = SPAN * (D / 16) / NTHREADS;

// GM: the most query heads per KV head it serves (4 or 8).  A lane holds
// its d elements of every head's query in registers: 16 of 4 heads, or 8
// of 8 heads, so a row is 8 or 16 lanes.
template <int GM>
__global__ void __launch_bounds__(NTHREADS, 4) quant_split_kernel(const Args a) {
  constexpr int EPL = GM <= 4 ? 16 : 8;  // d elements a lane
  constexpr int LPR = D / EPL;           // lanes a row
  __shared__ __align__(16) int8_t s_k[SPAN][D];
  __shared__ __align__(16) int8_t s_v[SPAN][D];
  __shared__ float s_ks[SPAN];
  __shared__ float s_vs[SPAN];
  __shared__ __align__(16) float s_p[SPAN][GM];  // scores, then probabilities

  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = seq_len(a, b);
  const int p0 = sp * SPAN;
  if (p0 >= len) return;  // past this sequence: the whole block, no barrier yet
  const int nrow = min(SPAN, len - p0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = a.group;
  const int* tab = a.tables + static_cast<int64_t>(b) * a.n_table;
  // the fresh row's index in this span (out of range where there is none)
  const int fresh = a.k_new != nullptr ? a.new_pos[b] - p0 : -1;

  // the rows' pages first (all loads in flight together), then the K
  // copies, then the V copies, as two commit groups; the chunk-0 thread of
  // a row keeps the row's two page scales
  const int ch = tid % (D / 16);
  int64_t page[ROWS_A_THREAD];
  int row_in_page[ROWS_A_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_A_THREAD; ++i) {
    const int r = tid / (D / 16) + (NTHREADS / (D / 16)) * i;
    const int pos = p0 + min(r, nrow - 1);
    page[i] = tab[pos / a.page_size];
    row_in_page[i] = pos % a.page_size;
  }
#pragma unroll
  for (int i = 0; i < ROWS_A_THREAD; ++i) {
    const int r = tid / (D / 16) + (NTHREADS / (D / 16)) * i;
    if (r < nrow)
      cp_async16(&s_k[r][16 * ch], a.k + page[i] * a.k_sp + row_in_page[i] * a.k_sr +
                                       kh * a.k_sh + 16 * ch);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < ROWS_A_THREAD; ++i) {
    const int r = tid / (D / 16) + (NTHREADS / (D / 16)) * i;
    if (r < nrow)
      cp_async16(&s_v[r][16 * ch], a.v + page[i] * a.v_sp + row_in_page[i] * a.v_sr +
                                       kh * a.v_sh + 16 * ch);
  }
  cp_async_commit();
  if (ch == 0) {
#pragma unroll
    for (int i = 0; i < ROWS_A_THREAD; ++i) {
      const int r = tid / (D / 16) + (NTHREADS / (D / 16)) * i;
      if (r < nrow) {
        s_ks[r] = a.k_scale[page[i] * a.ks_sp + kh * a.ks_sh];
        s_vs[r] = a.v_scale[page[i] * a.vs_sp + kh * a.vs_sh];
      }
    }
  }

  // scores: a row is LPR lanes of EPL d each, a warp 32 / LPR rows at a
  // time; warp w owns rows 32 w .. 32 w + 31
  const int sl = lane % LPR;
  float qf[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qf[g][e] = g < group
                     ? __bfloat162float(a.q[b * a.q_sb + (kh * group + g) * a.q_sh +
                                            EPL * sl + e])
                     : 0.f;
  const float* kn = a.k_new ? a.k_new + b * a.n_sb + kh * a.n_sh : nullptr;
  const float* vn = a.v_new ? a.v_new + b * a.n_sb + kh * a.n_sh : nullptr;
  cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();     // and everyone's
#pragma unroll 2
  for (int it = 0; it < LPR; ++it) {
    const int r = 32 * warp + (32 / LPR) * it + lane / LPR;
    float part[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) part[g] = 0.f;
    if (r < nrow) {
      float kf[EPL];
      if (r == fresh) {
#pragma unroll
        for (int e = 0; e < EPL; e += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kn + EPL * sl + e);
          kf[e] = k4.x; kf[e + 1] = k4.y; kf[e + 2] = k4.z; kf[e + 3] = k4.w;
        }
      } else {
        // EPL int8 of the row (one 16- or 8-byte load), 4 a word
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(&s_k[r][EPL * sl]);
#pragma unroll
        for (int m = 0; m < EPL / 4; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) kf[4 * m + e] = s8_to_f32(wp[m], e);
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) part[g] = fmaf(qf[g][e], kf[e], part[g]);
      // the page scale is constant over the row: k_scale (q . k_int)
      const float sc = r == fresh ? 1.f : s_ks[r];
#pragma unroll
      for (int g = 0; g < GM; ++g) part[g] *= sc;
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
    if (sl == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < group) s_p[r][g] = r < nrow ? part[g] * a.scale : -INFINITY;
    }
  }
  __syncthreads();

  // softmax over the span: warp w takes heads w, w + 4; lane rows l + 32 k
  const int64_t pbase =
      ((static_cast<int64_t>(b) * a.n_kv + kh) * a.n_span + sp) * group;
  for (int g = warp; g < group; g += NWARPS) {
    float x[SPAN / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < SPAN / 32; ++k) {
      x[k] = s_p[lane + 32 * k][g];
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
    if (lane == 0)
      *reinterpret_cast<float2*>(a.part_ml + 2 * (pbase + g)) = make_float2(mx, sum);
  }
  cp_async_wait<0>();  // the V rows
  __syncthreads();

  // P V: lane l owns output columns 4 l .. 4 l + 3 (one 4-byte load of V a
  // row) for every head of the group, over warp w's rows 32 w .. 32 w + 31;
  // then the four warps' sums, kept where the K rows were, are added in
  // warp order
  static_assert(NWARPS * GM * D * 4 <= SPAN * D, "P V sums fit over the K rows");
  float (*s_acc)[GM][D] = reinterpret_cast<float (*)[GM][D]>(&s_k[0][0]);
  float acc[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  const int rend = min(32 * warp + 32, nrow);
#pragma unroll 4
  for (int r = 32 * warp; r < rend; ++r) {
    float vv[4];
    if (r == fresh) {
      const float4 v4 = *reinterpret_cast<const float4*>(vn + 4 * lane);
      vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(&s_v[r][4 * lane]);
      const float sc = s_vs[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) vv[e] = s8_to_f32(w, e) * sc;
    }
    float pr[GM];
#pragma unroll
    for (int g = 0; g < GM; g += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(&s_p[r][g]);
      pr[g] = p4.x; pr[g + 1] = p4.y; pr[g + 2] = p4.z; pr[g + 3] = p4.w;
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pr[g], vv[e], acc[g][e]);
  }
#pragma unroll
  for (int g = 0; g < GM; ++g)
    *reinterpret_cast<float4*>(&s_acc[warp][g][4 * lane]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  for (int g = 0; g < group; ++g) {
    float sum = s_acc[0][g][tid];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) sum += s_acc[w][g][tid];
    a.part_acc[(pbase + g) * D + tid] = sum;
  }
}

// One block per (query head of the group, KV head, sequence); thread t
// owns output column t.
__global__ void __launch_bounds__(D) quant_combine_kernel(const Args a) {
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int len = seq_len(a, b);
  const int ns = len > 0 ? (len + SPAN - 1) / SPAN : 0;
  // partial (s, g) of this (sequence, KV head) at row base + s * group
  const int64_t base = (static_cast<int64_t>(b) * a.n_kv + kh) * a.n_span * a.group + g;
  float m = -INFINITY;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, a.part_ml[2 * (base + s * a.group)]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < ns; ++s) {
    const int64_t i = base + s * a.group;
    const float2 ml = *reinterpret_cast<const float2*>(a.part_ml + 2 * i);
    const float w = expf(ml.x - m);
    l = fmaf(ml.y, w, l);
    o = fmaf(a.part_acc[i * D + tid], w, o);
  }
  a.out[b * a.o_sb + (kh * a.group + g) * a.o_sh + tid] =
      __float2bfloat16(o / fmaxf(l, 1e-37f));
}

const void* kernel_fn(int which) {
  switch (which) {
    case 0: return reinterpret_cast<const void*>(quant_split_kernel<4>);
    case 1: return reinterpret_cast<const void*>(quant_split_kernel<8>);
    case 2: return reinterpret_cast<const void*>(quant_combine_kernel);
    default: return nullptr;
  }
}

}  // namespace

// Registers, local (spill) bytes a thread, static shared memory and
// resident blocks an SM of kernel `which` (0: split for G <= 4, 1: split
// for G <= 8, 2: combine), as the runtime reports them.
extern "C" int repro_quant_paged_kernel_info(int which, int* regs,
                                             int* local_bytes, int* smem_bytes,
                                             int* blocks_per_sm) {
  const void* fn = kernel_fn(which);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  const int threads = which == 2 ? D : NTHREADS;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                        threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}

// The span length, for the wrapper's scratch: (B, K, n_span, G, d + 2) f32
// with n_span = ceil(n_table * page_size / span).
extern "C" int repro_quant_paged_span() { return SPAN; }

// q (B, 1, H, d) bf16; k_pages, v_pages (P, ps, K, d) int8 with 16-byte
// aligned rows; k_scales, v_scales (P, K) f32; k_new, v_new (B, K, d) f32
// or null, new_pos (B,) int32 (null when k_new is); tables (B, n_table)
// int32 contiguous; lengths (B,) int32; out (B, 1, H, d) bf16; d = 128,
// unit stride on d.  strides[16] = q (batch, head), k (page, row, head),
// v (page, row, head), k_scales (page, head), v_scales (page, head), k_new
// and v_new (batch, head), out (batch, head), in elements.  scratch: at
// least B * K * n_span * G * (d + 2) f32.  Two launches on `stream`;
// returns the first cudaError_t.
extern "C" int repro_quant_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* k_new,
    const void* v_new, const void* new_pos, const void* tables,
    const void* lengths, void* out, int batch, int n_heads, int n_kv_heads,
    int head_dim, int page_size, int n_table, const int64_t* strides,
    float scale, void* scratch, int64_t scratch_floats, void* stream) {
  const int64_t* st = strides;
  if (batch <= 0 || batch > 65535 || n_kv_heads <= 0 || n_kv_heads > 65535 ||
      n_heads % n_kv_heads != 0 || n_heads / n_kv_heads > MAXG ||
      head_dim != D || page_size <= 0 || n_table <= 0 ||
      (k_new == nullptr) != (v_new == nullptr) ||
      (k_new != nullptr && new_pos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies: every int8 row aligned
  for (int i = 2; i < 8; ++i)
    if (st[i] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_span = (static_cast<int64_t>(n_table) * page_size + SPAN - 1) / SPAN;
  const int group = n_heads / n_kv_heads;
  const int64_t rows = static_cast<int64_t>(batch) * n_kv_heads * n_span * group;
  if (n_span > 65535 || scratch_floats < rows * (D + 2) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const int8_t*>(k_pages);
  a.v = static_cast<const int8_t*>(v_pages);
  a.k_scale = static_cast<const float*>(k_scales);
  a.v_scale = static_cast<const float*>(v_scales);
  a.k_new = static_cast<const float*>(k_new);
  a.v_new = static_cast<const float*>(v_new);
  a.new_pos = static_cast<const int*>(new_pos);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_acc = static_cast<float*>(scratch);
  a.part_ml = a.part_acc + rows * D;
  a.group = group;
  a.page_size = page_size;
  a.n_table = n_table;
  a.n_kv = n_kv_heads;
  a.n_span = static_cast<int>(n_span);
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_sp = st[2]; a.k_sr = st[3]; a.k_sh = st[4];
  a.v_sp = st[5]; a.v_sr = st[6]; a.v_sh = st[7];
  a.ks_sp = st[8]; a.ks_sh = st[9];
  a.vs_sp = st[10]; a.vs_sh = st[11];
  a.n_sb = st[12]; a.n_sh = st[13];
  a.o_sb = st[14]; a.o_sh = st[15];
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_span), n_kv_heads, batch);
  if (group <= 4)
    quant_split_kernel<4><<<grid, NTHREADS, 0, s>>>(a);
  else
    quant_split_kernel<8><<<grid, NTHREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_combine_kernel<<<dim3(group, n_kv_heads, batch), D, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
