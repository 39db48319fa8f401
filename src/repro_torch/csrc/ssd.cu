// Chunked state-space-dual (Mamba2 SSD) scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/ssd.py:ssd
// whose grid (B, H, nc) walks the chunks of one (sequence, head) in order
// and carries the (P, N) state in VMEM scratch from one grid step to the
// next, every product in f32.
//
// Per chunk of Q rows (cum = the chunk's running sum of dt * a):
//   S[i, j]  = (C_i . B_j) exp(cum_i - cum_j)      for j <= i, else 0
//   y_i      = sum_j S[i, j] dt_j x_j + exp(cum_i) (C_i . s_in)
//   s_out    = exp(cum_last) s_in + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
//
// Blocks run in no order here, so the scan is split into four passes on
// one stream, with no order between the blocks of a pass and no atomics:
//   1. chunk states, one block per (sequence, chunk, head): the running
//      sum `cum` (kept in scratch for the later passes) and the chunk's
//      own state sum_j exp(cum_last - cum_j) dt_j x_j B_j^T (P x N, f32
//      scratch);
//   2. C B^T, one block per (sequence, chunk, group, 64-row tile): the
//      group's score matrix once, for every head of the group (f32
//      scratch, the causal part only);
//   3. the state recurrence, one thread per (sequence, head, state
//      element): s_c = exp(cum_last_c) s_{c-1} + local_c in chunk order,
//      leaving in scratch the state entering each chunk and writing the
//      final state;
//   4. outputs, one block per (sequence, chunk, head, 128-row tile):
//      y = (C B^T o L o dt) x + exp(cum_i) C s_in, rounded to bf16 once.
// At L = 478 (two chunks, 80 heads) pass 1 runs 164 blocks and pass 4
// 320, two an SM, where the kernel this replaces ran 80, one an SM.  Tiles
// reach shared memory by cp.async, so a block's copies are all in flight
// at once.
//
// Every product runs on the tensor cores as mma.sync m16n8k16 bf16 with
// f32 accumulation.  x, B and C are bf16 in memory, so they enter exactly.
// Each f32 factor (dt, the decays, the state) is folded into ONE operand,
// which is split into two bf16 halves, hi = bf16(v) and lo = bf16(v - hi),
// and multiplied as hi.x + lo.x: about 16 bits of the operand, against f32
// FMA's 24 and TF32's 11.  The exponential is taken only where j <= i: the
// TPU kernel takes it of every difference and masks afterwards, where
// j > i may overflow.  A ragged last chunk is the padded chunk with dt = 0
// (exp(0) = 1 and a zero update leave the state as it is); padded rows are
// zero and never stored.  Summation orders are fixed (the mma's, then the
// k steps in order, hi before lo), so a sequence's result depends on its
// own data alone.  Passes 1 and 2 share a launch, so a call is three.
//
// Inputs: x (B, L, H, P) bf16, dt (B, L, H) f32 (post-softplus), a (H,)
// f32, B and C per group (B, L, G, N) bf16, head h reading group
// h / (H / G): the groups are never repeated out to heads in memory.
// Outputs: y (B, L, H, P) bf16, final state (B, H, P, N) f32.  P = 64,
// N = 128 (Mamba2's), Q <= 256.
//
// Bound on the H100: per head and full chunk the products cost
// Q(Q+1)/2 (N + P) + 2 Q P N multiply-adds, C B^T once per group; the head
// reads and writes 4 P + 4 bytes a row (x, dt, y) plus its share of its
// group's B and C and the final state once: bytes bound it, at 3.35 TB/s.
// The scratch (local and entering states, 32 KB a (chunk, head); C B^T,
// 256 KB a (chunk, group)) stays in the 50 MB L2 at the main path's sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int P = 64;      // head_dim
constexpr int N = 128;     // state size
constexpr int QMAX = 256;  // largest chunk
constexpr int TR = 64;     // rows of a C B^T or output tile
constexpr int NTHREADS = 256;
// row strides, in elements, padded by 16 bytes so that the 8 rows an
// ldmatrix reads fall in distinct banks
constexpr int XS = P + 8;       // bf16 [row][p]
constexpr int NS = N + 8;       // bf16 [row][n]
constexpr int CBS = QMAX + 8;   // f32 [row][j]: float2 reads of 8 rows x 4

struct Geo {
  int L, H, G, rep, Q, QP, nc;  // QP: Q rounded up to 16
  int64_t x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh;
  int64_t b_sb, b_sl, b_sg, c_sb, c_sl, c_sg;
  float* cum;  // (B, H, nc, QP) running sums
  float* st;   // (B, nc, H, P, N) local, then entering, states
  float* cb;   // (B, nc, G, QP, QP) C B^T
};

__device__ __forceinline__ float* cum_at(const Geo& g, int b, int h, int c) {
  return g.cum + ((static_cast<int64_t>(b) * g.H + h) * g.nc + c) * g.QP;
}
__device__ __forceinline__ float* st_at(const Geo& g, int b, int c, int h) {
  return g.st + ((static_cast<int64_t>(b) * g.nc + c) * g.H + h) * (P * N);
}
__device__ __forceinline__ float* cb_at(const Geo& g, int b, int c, int grp) {
  return g.cb + ((static_cast<int64_t>(b) * g.nc + c) * g.G + grp) *
                    (static_cast<int64_t>(g.QP) * g.QP);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.  Plain: thread t gets row t/4, columns 2(t%4) and +1.
// .trans: thread t gets column t/4, rows 2(t%4) and +1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: a 16x16 (row-major fragments), b 16x8, d 16x8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) split into bf16 halves: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf2_bits(h);
  lo = bf2_bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// 16 bytes global -> shared, asynchronously; zeros where !full (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// Rows row0 .. row0 + rows - 1 of a chunk of a bf16 matrix of WIDTH
// columns (row r at base + r * stride) into shared memory with row stride
// `ss`, as cp.async copies of 16 bytes; rows at or past the chunk's `qv`
// valid rows are zero.
template <int WIDTH>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ss,
                                          const __nv_bfloat16* base,
                                          int64_t stride, int row0, int rows,
                                          int qv) {
  constexpr int CH = WIDTH / 8;
  for (int e = threadIdx.x; e < rows * CH; e += NTHREADS) {
    const int j = e / CH, k = e % CH;
    const bool ok = row0 + j < qv;
    cp_async16(dst + j * ss + k * 8, ok ? base + (row0 + j) * stride + k * 8 : base,
               ok);
  }
}

// ---- pass 1: running sums and chunk states ----------------------------------

constexpr int S_OFF_X = 0;                           // x [j][p]
constexpr int S_OFF_B = S_OFF_X + QMAX * XS * 2;     // B [j][n]
constexpr int S_OFF_DT = S_OFF_B + QMAX * NS * 2;    // dt [j]
constexpr int S_OFF_CUM = S_OFF_DT + QMAX * 4;       // cum [j]
constexpr int S_OFF_W = S_OFF_CUM + QMAX * 4;        // dt_j exp(cum_last - cum_j)
constexpr int S_SMEM = S_OFF_W + QMAX * 4;
static_assert(2 * (S_SMEM + 1024) <= 233472, "two blocks an SM");

__device__ __forceinline__ void state_block(
    unsigned char* smem, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ a,
    const __nv_bfloat16* __restrict__ bm, const Geo& g, int h) {
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + S_OFF_X);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(smem + S_OFF_B);
  float* s_dt = reinterpret_cast<float*>(smem + S_OFF_DT);
  float* s_cum = reinterpret_cast<float*>(smem + S_OFF_CUM);
  float* s_w = reinterpret_cast<float*>(smem + S_OFF_W);

  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = c * g.Q, qv = min(g.Q, g.L - c0);
  const int kend = (qv + 15) & ~15;  // rows the products read (<= QP)

  copy_rows<P>(s_x, XS, x + b * g.x_sb + c0 * g.x_sl + h * g.x_sh, g.x_sl, 0,
               kend, qv);
  copy_rows<N>(s_b, NS, bm + b * g.b_sb + c0 * g.b_sl + (h / g.rep) * g.b_sg,
               g.b_sl, 0, kend, qv);
  if (tid < g.QP)
    s_dt[tid] = tid < qv ? dt[b * g.dt_sb + (c0 + tid) * g.dt_sl + h * g.dt_sh] : 0.f;
  __syncthreads();

  // cum over the padded chunk (dt = 0 past qv keeps it at cum_last): each
  // lane sums its run of rows, a warp scan adds the runs before it
  if (warp == 0) {
    const float av = a[h];
    const int per = (g.QP + 31) / 32;
    const int j0 = min(lane * per, g.QP), j1 = min(j0 + per, g.QP);
    float run = 0.f;
    for (int j = j0; j < j1; ++j) run = __fadd_rn(run, __fmul_rn(s_dt[j], av));
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, t);
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.f;
    for (int j = j0; j < j1; ++j) {
      before = __fadd_rn(before, __fmul_rn(s_dt[j], av));
      s_cum[j] = before;
    }
  }
  __syncthreads();
  if (tid < g.QP) {
    cum_at(g, b, h, c)[tid] = s_cum[tid];
    s_w[tid] = __fmul_rn(s_dt[tid], expf(s_cum[g.QP - 1] - s_cum[tid]));
  }
  cp_async_wait_all();
  __syncthreads();

  // state[p][n] = sum_j x[j][p] w_j B[j][n]: warp w owns p rows 16 (w % 4)
  // .. and n columns 64 (w / 4) .. + 63 (8 tiles of 8).  A = (x w)^T, from
  // x stored [j][p] read transposed, times w in f32, split.
  const int mt = warp & 3, nh = warp >> 2;
  const int mi = lane >> 3, r8 = lane & 7, gid = lane >> 2, tig = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += 16) {
    uint32_t ax[4], ah[4], al[4];
    ldsm_x4_t(ax, s_x + (k0 + r8 + ((mi >> 1) << 3)) * XS + 16 * mt +
                      ((mi & 1) << 3));
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // register q: rows j, j + 1 below
      const int j = k0 + 2 * tig + ((q >> 1) << 3);
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ax[q]));
      split2(__fmul_rn(xv.x, s_w[j]), __fmul_rn(xv.y, s_w[j + 1]), ah[q], al[q]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];  // B stored [j][n]: (k = j, col = n), read transposed
      ldsm_x4_t(bf, s_b + (k0 + r8 + ((mi & 1) << 3)) * NS + 64 * nh + 16 * np +
                        ((mi >> 1) << 3));
      mma(acc[2 * np], ah, bf[0], bf[1]);
      mma(acc[2 * np], al, bf[0], bf[1]);
      mma(acc[2 * np + 1], ah, bf[2], bf[3]);
      mma(acc[2 * np + 1], al, bf[2], bf[3]);
    }
  }
  float* dst = st_at(g, b, c, h);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int p = 16 * mt + gid, n = 64 * nh + 8 * t + 2 * tig;
    *reinterpret_cast<float2*>(dst + p * N + n) = make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(dst + (p + 8) * N + n) =
        make_float2(acc[t][2], acc[t][3]);
  }
}

// ---- pass 2: C B^T once per (sequence, chunk, group) ------------------------

constexpr int C_OFF_C = 0;                        // C [i][n], the row tile
constexpr int C_OFF_B = C_OFF_C + TR * NS * 2;    // B [j][n]
constexpr int C_SMEM = C_OFF_B + QMAX * NS * 2;
static_assert(C_SMEM <= S_SMEM, "passes 1 and 2 share a launch");

__device__ __forceinline__ void cb_block(unsigned char* smem,
                                         const __nv_bfloat16* __restrict__ bm,
                                         const __nv_bfloat16* __restrict__ cm,
                                         const Geo& g, int rt, int grp) {
  __nv_bfloat16* s_c = reinterpret_cast<__nv_bfloat16*>(smem + C_OFF_C);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(smem + C_OFF_B);

  const int i0 = rt * TR;
  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = c * g.Q, qv = min(g.Q, g.L - c0);
  const int rows = min(TR, g.QP - i0);
  copy_rows<N>(s_c, NS, cm + b * g.c_sb + c0 * g.c_sl + grp * g.c_sg, g.c_sl, i0,
               rows, qv);
  copy_rows<N>(s_b, NS, bm + b * g.b_sb + c0 * g.b_sl + grp * g.b_sg, g.b_sl, 0,
               i0 + rows, qv);
  cp_async_wait_all();
  __syncthreads();

  // warp w owns rows 16 (w % 4) .. of the tile and every other pair of
  // 8-column tiles up to its last row (the causal part)
  const int r0 = 16 * (warp & 3);
  if (r0 >= rows) return;
  const int mi = lane >> 3, r8 = lane & 7, gid = lane >> 2, tig = lane & 3;
  uint32_t af[8][4];  // C rows, all of N
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    ldsm_x4(af[ks], s_c + (r0 + r8 + ((mi & 1) << 3)) * NS + 16 * ks +
                        ((mi >> 1) << 3));
  float* out = cb_at(g, b, c, grp);
  const int jlim = i0 + r0 + 16;
  for (int j0 = 16 * (warp >> 2); j0 < jlim; j0 += 32) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t bf[4];  // B stored [j][n]: (k = n, col = j), read as stored
      ldsm_x4(bf, s_b + (j0 + ((mi >> 1) << 3) + r8) * NS + 16 * ks +
                      ((mi & 1) << 3));
      mma(acc[0], af[ks], bf[0], bf[1]);
      mma(acc[1], af[ks], bf[2], bf[3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = i0 + r0 + gid, j = j0 + 8 * t + 2 * tig;
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(i) * g.QP + j) =
          make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(i + 8) * g.QP + j) =
          make_float2(acc[t][2], acc[t][3]);
    }
  }
}

// Passes 1 and 2 in one launch: blocks 0 .. H - 1 of a (chunk, sequence)
// are pass 1's heads, the rest pass 2's (group, row tile) pairs.
__global__ void __launch_bounds__(NTHREADS, 2)
ssd_chunk_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const __nv_bfloat16* __restrict__ bm,
                 const __nv_bfloat16* __restrict__ cm, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nrt = (g.QP + TR - 1) / TR;
  const int blk = blockIdx.x;
  if (blk < g.H)
    state_block(smem, x, dt, a, bm, g, blk);
  else
    cb_block(smem, bm, cm, g, (blk - g.H) % nrt, (blk - g.H) / nrt);
}

// ---- pass 3: the state recurrence across chunks ------------------------------

constexpr int SCAN_EL = 4;     // state elements a thread (one float4)
constexpr int SCAN_BATCH = 8;  // chunks whose inputs are loaded together

__global__ void __launch_bounds__(NTHREADS)
ssd_scan_kernel(float* __restrict__ fs, const Geo g) {
  const int e = (blockIdx.x * NTHREADS + threadIdx.x) * SCAN_EL;
  const int h = blockIdx.y, b = blockIdx.z;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < g.nc; c0 += SCAN_BATCH) {
    float4 local[SCAN_BATCH];
    float cum_last[SCAN_BATCH];
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      if (c0 + k < g.nc) {
        local[k] = *reinterpret_cast<const float4*>(st_at(g, b, c0 + k, h) + e);
        cum_last[k] = cum_at(g, b, h, c0 + k)[g.QP - 1];
      }
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      if (c0 + k < g.nc) {
        // the state entering chunk c0 + k, then the state leaving it
        *reinterpret_cast<float4*>(st_at(g, b, c0 + k, h) + e) = s;
        const float d = expf(cum_last[k]);
        s = make_float4(__fadd_rn(__fmul_rn(s.x, d), local[k].x),
                        __fadd_rn(__fmul_rn(s.y, d), local[k].y),
                        __fadd_rn(__fmul_rn(s.z, d), local[k].z),
                        __fadd_rn(__fmul_rn(s.w, d), local[k].w));
      }
  }
  *reinterpret_cast<float4*>(fs + (static_cast<int64_t>(b) * g.H + h) * (P * N) + e) = s;
}

// ---- pass 4: outputs ---------------------------------------------------------

constexpr int TO = 128;                              // rows of an output tile
constexpr int O_OFF_X = 0;                           // x [j][p]
constexpr int O_OFF_SH = O_OFF_X + QMAX * XS * 2;    // entering state hi [p][n]
constexpr int O_OFF_SL = O_OFF_SH + P * NS * 2;      // entering state lo
constexpr int O_OFF_C = O_OFF_SL + P * NS * 2;       // C [i][n], the row tile
constexpr int O_OFF_CUM = O_OFF_C + TO * NS * 2;     // cum [j]
constexpr int O_OFF_DT = O_OFF_CUM + QMAX * 4;       // dt [j]
constexpr int O_SMEM = O_OFF_DT + QMAX * 4;
static_assert(2 * (O_SMEM + 1024) <= 233472, "two blocks an SM");
static_assert(TO == 16 * (NTHREADS / 32), "a warp's 16 rows");

// One block per (sequence, chunk, head, 128-row tile); warp w owns rows
// 16 w .. 16 w + 15 of the tile and all 64 p columns.  The off-diagonal
// term exp(cum_i) C s_in is computed first and seeds the accumulators of
// y_diag.  C B^T comes straight from pass 2's scratch (L2) into the A
// fragments, two k steps ahead.  Below the diagonal the decay is split at
// the warp's first row r: exp(cum_i - cum_j) = exp(cum_i - cum_r)
// exp(cum_r - cum_j), both factors at most 1, so 4 exponentials a k step
// instead of 8; the diagonal block takes exp(cum_i - cum_j) itself where
// j <= i.  These exponentials feed y only (gated at 2^-7 of the value), so
// they are the fast ones.
__global__ void __launch_bounds__(NTHREADS, 2)
ssd_out_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ dt, const __nv_bfloat16* __restrict__ cm,
               __nv_bfloat16* __restrict__ y, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + O_OFF_X);
  __nv_bfloat16* s_sh = reinterpret_cast<__nv_bfloat16*>(smem + O_OFF_SH);
  __nv_bfloat16* s_sl = reinterpret_cast<__nv_bfloat16*>(smem + O_OFF_SL);
  __nv_bfloat16* s_c = reinterpret_cast<__nv_bfloat16*>(smem + O_OFF_C);
  float* s_cum = reinterpret_cast<float*>(smem + O_OFF_CUM);
  float* s_dt = reinterpret_cast<float*>(smem + O_OFF_DT);

  const int nrt = (g.QP + TO - 1) / TO;
  const int rt = nrt - 1 - static_cast<int>(blockIdx.x) % nrt;  // heaviest first
  const int h = static_cast<int>(blockIdx.x) / nrt;
  const int c = blockIdx.y, b = blockIdx.z, grp = h / g.rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = c * g.Q, qv = min(g.Q, g.L - c0);
  const int i0 = rt * TO, rows = min(TO, g.QP - i0), jend = i0 + rows;

  copy_rows<P>(s_x, XS, x + b * g.x_sb + c0 * g.x_sl + h * g.x_sh, g.x_sl, 0,
               jend, qv);
  copy_rows<N>(s_c, NS, cm + b * g.c_sb + c0 * g.c_sl + grp * g.c_sg, g.c_sl, i0,
               rows, qv);
  if (tid < jend) {
    s_cum[tid] = cum_at(g, b, h, c)[tid];
    s_dt[tid] = tid < qv ? dt[b * g.dt_sb + (c0 + tid) * g.dt_sl + h * g.dt_sh] : 0.f;
  }
  if (c > 0) {  // the entering state, split
    const float* s_in = st_at(g, b, c, h);
    constexpr int PER = P * N / 4 / NTHREADS;
    float4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      v[k] = *reinterpret_cast<const float4*>(s_in + 4 * (tid + k * NTHREADS));
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = 4 * (tid + k * NTHREADS), p = e / N, n = e % N;
      uint2 hi, lo;
      split2(v[k].x, v[k].y, hi.x, lo.x);
      split2(v[k].z, v[k].w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(s_sh + p * NS + n) = hi;
      *reinterpret_cast<uint2*>(s_sl + p * NS + n) = lo;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int r0 = 16 * warp;
  if (r0 >= rows) return;
  const int mi = lane >> 3, r8 = lane & 7, gid = lane >> 2, tig = lane & 3;
  const int ir = i0 + r0;                     // the warp's first row
  const int ia = ir + gid, ib = ia + 8;       // this thread's two rows
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // y_off = C s_in (split), then scaled by exp(cum_i) row by row
  if (c > 0) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, s_c + (r0 + r8 + ((mi & 1) << 3)) * NS + 16 * ks +
                      ((mi >> 1) << 3));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // s stored [p][n]: (k = n, col = p), read as stored
        const int srow = 16 * np + ((mi >> 1) << 3) + r8;
        const int scol = 16 * ks + ((mi & 1) << 3);
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, s_sh + srow * NS + scol);
        ldsm_x4(bl, s_sl + srow * NS + scol);
        mma(acc[2 * np], af, bh[0], bh[1]);
        mma(acc[2 * np], af, bl[0], bl[1]);
        mma(acc[2 * np + 1], af, bh[2], bh[3]);
        mma(acc[2 * np + 1], af, bl[2], bl[3]);
      }
    }
    const float ea = __expf(s_cum[ia]), eb = __expf(s_cum[ib]);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      acc[t][0] *= ea;
      acc[t][1] *= ea;
      acc[t][2] *= eb;
      acc[t][3] *= eb;
    }
  }

  // y_diag: A = C B^T o exp(cum_i - cum_j) o dt_j (split), B = x.  The
  // C B^T fragments of the next two k steps are in flight (fragment q: row
  // q & 1, columns + 8 (q >> 1)).
  const float cum_r = s_cum[ir];
  const float ua = __expf(s_cum[ia] - cum_r), ub = __expf(s_cum[ib] - cum_r);
  const float* cb_a = cb_at(g, b, c, grp) + static_cast<int64_t>(ia) * g.QP + 2 * tig;
  const float* cb_b = cb_a + 8 * static_cast<int64_t>(g.QP);
  float2 nx1[4], nx2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* src = (q & 1 ? cb_b : cb_a) + ((q >> 1) << 3);
    nx1[q] = *reinterpret_cast<const float2*>(src);
    if (ir >= 16) nx2[q] = *reinterpret_cast<const float2*>(src + 16);
  }
  for (int k0 = 0; k0 <= ir; k0 += 16) {
    float2 cur[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cur[q] = nx1[q];
      nx1[q] = nx2[q];
    }
    if (k0 + 32 <= ir) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        nx2[q] = *reinterpret_cast<const float2*>((q & 1 ? cb_b : cb_a) + k0 + 32 +
                                                  ((q >> 1) << 3));
    }
    uint32_t ah[4], al[4];
    if (k0 < ir) {  // every j < r <= i
      float wj[4];   // exp(cum_r - cum_j) dt_j for j = k0 + 2 tig + {0, 1, 8, 9}
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = k0 + 2 * tig + (m & 1) + ((m >> 1) << 3);
        wj[m] = __fmul_rn(__expf(cum_r - s_cum[j]), s_dt[j]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ui = q & 1 ? ub : ua;
        const int m = (q >> 1) << 1;
        split2(__fmul_rn(__fmul_rn(cur[q].x, wj[m]), ui),
               __fmul_rn(__fmul_rn(cur[q].y, wj[m + 1]), ui), ah[q], al[q]);
      }
    } else {  // the diagonal block: j <= i only
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = q & 1 ? ib : ia;
        const int j = k0 + 2 * tig + ((q >> 1) << 3);
        const float ci = s_cum[i];
        const float v0 = j <= i ? __fmul_rn(__fmul_rn(cur[q].x, __expf(ci - s_cum[j])),
                                            s_dt[j]) : 0.f;
        const float v1 = j + 1 <= i
                             ? __fmul_rn(__fmul_rn(cur[q].y, __expf(ci - s_cum[j + 1])),
                                         s_dt[j + 1]) : 0.f;
        split2(v0, v1, ah[q], al[q]);
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];  // x stored [j][p]: (k = j, col = p), read transposed
      ldsm_x4_t(bf, s_x + (k0 + r8 + ((mi & 1) << 3)) * XS + 16 * np +
                        ((mi >> 1) << 3));
      mma(acc[2 * np], ah, bf[0], bf[1]);
      mma(acc[2 * np], al, bf[0], bf[1]);
      mma(acc[2 * np + 1], ah, bf[2], bf[3]);
      mma(acc[2 * np + 1], al, bf[2], bf[3]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = rr ? ib : ia;
    if (i >= qv) continue;
    __nv_bfloat16* yrow = y + ((static_cast<int64_t>(b) * g.L + c0 + i) * g.H + h) * P;
#pragma unroll
    for (int t = 0; t < 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * t + 2 * tig) =
          __floats2bfloat162_rn(acc[t][2 * rr], acc[t][2 * rr + 1]);
  }
}

bool g_attrs_set = false;

cudaError_t set_attrs() {
  if (g_attrs_set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, O_SMEM);
  g_attrs_set = err == cudaSuccess;
  return err;
}

}  // namespace

// Scratch the wrapper allocates, in floats: running sums (B, H, nc, QP),
// chunk states (B, nc, H, P, N) and C B^T (B, nc, G, QP, QP), where Q =
// min(chunk, L), QP = Q rounded up to 16 and nc = ceil(L / Q).
static int64_t ssd_scratch_floats(int batch, int len, int heads, int groups,
                                  int chunk) {
  const int64_t q = chunk < len ? chunk : len;
  const int64_t qp = (q + 15) / 16 * 16, nc = (len + q - 1) / q;
  return batch * nc * (heads * qp + static_cast<int64_t>(heads) * P * N +
                       groups * qp * qp);
}

// Registers, local (spill) bytes a thread, dynamic shared memory and
// resident blocks an SM of kernel `which` (0: chunk states and C B^T, 1:
// the recurrence, 2: outputs), as the runtime reports them.
extern "C" int repro_ssd_kernel_info(int which, int* regs, int* local_bytes,
                                     int* smem_bytes, int* blocks_per_sm) {
  const void* fns[3] = {reinterpret_cast<const void*>(ssd_chunk_kernel),
                        reinterpret_cast<const void*>(ssd_scan_kernel),
                        reinterpret_cast<const void*>(ssd_out_kernel)};
  const int smem[3] = {S_SMEM, 0, O_SMEM};
  if (which < 0 || which > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_attrs();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fns[which],
                                                        NTHREADS, smem[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = smem[which];
  return static_cast<int>(cudaSuccess);
}

// x (B, L, H, P) bf16; dt (B, L, H) f32; a (H,) f32; bm and cm (B, L, G,
// N) bf16; y (B, L, H, P) bf16 and fs (B, H, P, N) f32, both contiguous;
// scratch: at least ssd_scratch_floats(...) f32, 16-byte aligned.
// P = 64, N = 128, G divides H, 1 <= chunk <= 256 (taken as min(chunk, L)).
// strides[12] = x (batch, seq, head), dt (batch, seq, head), bm (batch,
// seq, group), cm (batch, seq, group), in elements; unit stride on the last
// axis of each, and 16-byte aligned bf16 rows.  Three launches on `stream`;
// returns the first cudaError_t.
extern "C" int repro_ssd_bf16(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              void* fs, int batch, int len, int heads,
                              int groups, int head_dim, int state_dim,
                              int chunk, const int64_t* strides, void* scratch,
                              int64_t scratch_floats, void* stream) {
  if (batch <= 0 || len <= 0 || heads <= 0 || groups <= 0 ||
      heads % groups != 0 || head_dim != P || state_dim != N || chunk < 1 ||
      chunk > QMAX || batch > 65535 ||
      scratch_floats < ssd_scratch_floats(batch, len, heads, groups, chunk) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_attrs();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t* st = strides;
  Geo g;
  g.L = len;
  g.H = heads;
  g.G = groups;
  g.rep = heads / groups;
  g.Q = chunk < len ? chunk : len;
  g.QP = (g.Q + 15) / 16 * 16;
  g.nc = (len + g.Q - 1) / g.Q;
  g.x_sb = st[0]; g.x_sl = st[1]; g.x_sh = st[2];
  g.dt_sb = st[3]; g.dt_sl = st[4]; g.dt_sh = st[5];
  g.b_sb = st[6]; g.b_sl = st[7]; g.b_sg = st[8];
  g.c_sb = st[9]; g.c_sl = st[10]; g.c_sg = st[11];
  float* sf = static_cast<float*>(scratch);
  g.cum = sf;
  g.st = g.cum + static_cast<int64_t>(batch) * heads * g.nc * g.QP;
  g.cb = g.st + static_cast<int64_t>(batch) * g.nc * heads * (P * N);
  const int nrt = (g.QP + TR - 1) / TR;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* bp = static_cast<const __nv_bfloat16*>(bm);
  const auto* cp = static_cast<const __nv_bfloat16*>(cm);

  ssd_chunk_kernel<<<dim3(heads + groups * nrt, g.nc, batch), NTHREADS, S_SMEM,
                     s>>>(xp, dtp, static_cast<const float*>(a), bp, cp, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<dim3(P * N / (NTHREADS * SCAN_EL), heads, batch), NTHREADS, 0,
                    s>>>(
      static_cast<float*>(fs), g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_out_kernel<<<dim3((g.QP + TO - 1) / TO * heads, g.nc, batch), NTHREADS,
                   O_SMEM, s>>>(
      xp, dtp, cp, static_cast<__nv_bfloat16*>(y), g);
  return static_cast<int>(cudaGetLastError());
}
