// Chunked state-space-dual (Mamba2 SSD) scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/ssd.py:ssd
// whose grid (B, H, nc) walks the chunks of one (sequence, head) in order
// and carries the (P, N) state in VMEM scratch from one grid step to the
// next.  Blocks run in no order here, so one block owns one (sequence,
// head) and loops over the chunks itself; the state stays in shared memory
// for the whole sequence and never touches device memory until the end.
//
// Per chunk of Q rows (cum = the chunk's running sum of dt * a):
//   S[i, j]  = (C_i . B_j) exp(cum_i - cum_j)      for j <= i, else 0
//   y_i      = sum_j S[i, j] (dt_j x_j) + exp(cum_i) (C_i . state)
//   state   <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// The exponential is taken only where j <= i: the TPU kernel takes it of
// every difference and masks afterwards, where j > i may overflow.  The
// chunk's Q x Q score matrix (256 KB in f32) does not fit in shared memory,
// so query rows go in tiles of 32.  A ragged last chunk is the padded chunk
// with dt = 0 (exp(0) = 1 and a zero update leave the state as it is):
// rows past the sequence are zero and never stored.  Every sum is f32 FMA
// in a fixed order with no atomics, so a sequence's result depends on its
// own data alone.
//
// Inputs: x (B, L, H, P) bf16, dt (B, L, H) f32 (post-softplus), a (H,)
// f32, B and C per group (B, L, G, N) bf16, head h reading group
// h / (H / G): the groups are never repeated out to heads in memory.
// Outputs: y (B, L, H, P) bf16, final state (B, H, P, N) f32.  P = 64,
// N = 128 (Mamba2's), Q <= 256.
//
// Bound on the H100: per head and full chunk the intra-chunk products
// cost Q(Q+1)/2 (N + P) multiply-adds and the state and off-diagonal
// products 2 Q P N, while the head reads and writes 4 P + 4 bytes a row (x,
// dt, y) plus its share of its group's B and C, and the final state once:
// at full width (Q = 256, 80 heads on one group) about 290 FLOPs per byte,
// at the card's bf16 balance of ~295, so the bytes and the tensor-core rate
// bound it about equally.  This first kernel does the products as f32 FMA
// on CUDA cores, one block per (sequence, head): 80 blocks at batch 1 on
// 132 SMs, and every head recomputes its group's C B^T.  wgmma tiles and a
// score matrix shared by the heads of a group are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int P = 64;      // head_dim
constexpr int N = 128;     // state size
constexpr int QMAX = 256;  // largest chunk
constexpr int TQ = 32;     // query rows per tile
constexpr int NTHREADS = 256;
constexpr int BROW = N + 2;   // bf16 row stride of s_b: 65 words, so 32
                              // consecutive rows fall in 32 banks
constexpr int SROW = TQ + 4;  // f32 row stride of s_s and s_ct

// shared memory, in bytes from the start (16-byte aligned where float4 or
// uint4 touch it)
constexpr int OFF_ST = 0;                          // state [n][p] f32
constexpr int OFF_S = OFF_ST + N * P * 4;          // scores [j][i] f32
constexpr int OFF_CT = OFF_S + QMAX * SROW * 4;    // C tile [n][i] f32
constexpr int OFF_DT = OFF_CT + N * SROW * 4;      // dt [j]
constexpr int OFF_CUM = OFF_DT + QMAX * 4;         // cum [j]
constexpr int OFF_W = OFF_CUM + QMAX * 4;          // exp(cum_last - cum_j)
constexpr int OFF_X = OFF_W + QMAX * 4;            // x [j][p] bf16
constexpr int OFF_B = OFF_X + QMAX * P * 2;        // B [j][n] bf16
constexpr int SMEM_BYTES = OFF_B + QMAX * BROW * 2;
static_assert(OFF_X % 16 == 0 && OFF_CT % 16 == 0, "alignment");
static_assert(SMEM_BYTES <= 232448, "shared memory");

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__global__ void __launch_bounds__(NTHREADS, 1)
ssd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
           const __nv_bfloat16* __restrict__ cm, __nv_bfloat16* __restrict__ y,
           float* __restrict__ fs, int L, int H, int rep, int Q,
           int64_t x_sb, int64_t x_sl, int64_t x_sh,
           int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
           int64_t b_sb, int64_t b_sl, int64_t b_sg,
           int64_t c_sb, int64_t c_sl, int64_t c_sg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_st = reinterpret_cast<float*>(smem + OFF_ST);
  float* s_s = reinterpret_cast<float*>(smem + OFF_S);
  float* s_ct = reinterpret_cast<float*>(smem + OFF_CT);
  float* s_dt = reinterpret_cast<float*>(smem + OFF_DT);
  float* s_cum = reinterpret_cast<float*>(smem + OFF_CUM);
  float* s_w = reinterpret_cast<float*>(smem + OFF_W);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + OFF_X);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(smem + OFF_B);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / rep;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float av = a[h];

  const __nv_bfloat16* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const __nv_bfloat16* bb = bm + b * b_sb + g * b_sg;
  const __nv_bfloat16* cb = cm + b * c_sb + g * c_sg;
  __nv_bfloat16* yb = y + (static_cast<int64_t>(b) * L * H + h) * P;

  for (int e = tid; e < N * P; e += NTHREADS) s_st[e] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int qv = min(Q, L - c0);  // valid rows of this chunk
    __syncthreads();  // the previous chunk's readers are done

    // dt, x and B of the chunk; rows past the sequence are zero
    for (int j = tid; j < Q; j += NTHREADS)
      s_dt[j] = j < qv ? dtb[(c0 + j) * dt_sl] : 0.f;
    for (int e = tid; e < Q * (P / 8); e += NTHREADS) {
      const int j = e / (P / 8), k = e % (P / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (j < qv)
        v = *reinterpret_cast<const uint4*>(xb + (c0 + j) * x_sl + k * 8);
      *reinterpret_cast<uint4*>(s_x + j * P + k * 8) = v;
    }
    for (int e = tid; e < Q * (N / 8); e += NTHREADS) {
      const int j = e / (N / 8), k = e % (N / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (j < qv)
        v = *reinterpret_cast<const uint4*>(bb + (c0 + j) * b_sl + k * 8);
      uint32_t* dst = reinterpret_cast<uint32_t*>(s_b + j * BROW + k * 8);
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
    if (tid == 0) {  // the running sum in row order, rounded as dt*a then +
      float cum = 0.f;
      for (int j = 0; j < qv; ++j) {
        cum = __fadd_rn(cum, __fmul_rn(s_dt[j], av));
        s_cum[j] = cum;
      }
    }
    __syncthreads();
    const float cum_last = s_cum[qv - 1];
    for (int j = tid; j < qv; j += NTHREADS) s_w[j] = expf(cum_last - s_cum[j]);

    for (int i0 = 0; i0 < qv; i0 += TQ) {
      __syncthreads();  // the previous tile's s_s and s_ct are consumed
      // the C tile, transposed to [n][i]; rows past the sequence are zero
      for (int e = tid; e < TQ * (N / 8); e += NTHREADS) {
        const int il = e / (N / 8), k = e % (N / 8);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (i0 + il < qv)
          v = *reinterpret_cast<const uint4*>(cb + (c0 + i0 + il) * c_sl + k * 8);
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 f = bf2(w4[m]);
          s_ct[(k * 8 + 2 * m) * SROW + il] = f.x;
          s_ct[(k * 8 + 2 * m + 1) * SROW + il] = f.y;
        }
      }
      __syncthreads();

      // scores: warp w owns tile rows 4w .. 4w+3, lane owns columns
      // j = lane + 32 kk for every 32-column block up to the tile's end
      {
        const int ir = 4 * warp;
        const int nk = i0 / 32 + 1;
        float acc[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) acc[r][kk] = 0.f;
        for (int n = 0; n < N; n += 2) {
          const float4 ca = *reinterpret_cast<const float4*>(s_ct + n * SROW + ir);
          const float4 cc = *reinterpret_cast<const float4*>(s_ct + (n + 1) * SROW + ir);
          const float c_a[4] = {ca.x, ca.y, ca.z, ca.w};
          const float c_b[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk < nk) {
              const int j = lane + 32 * kk;
              const float2 bv = bf2(*reinterpret_cast<const uint32_t*>(
                  s_b + j * BROW + n));
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                acc[r][kk] = fmaf(c_a[r], bv.x, acc[r][kk]);
                acc[r][kk] = fmaf(c_b[r], bv.y, acc[r][kk]);
              }
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk < nk) {
            const int j = lane + 32 * kk;
            float out[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = i0 + ir + r;
              out[r] = (j <= i && i < qv)
                           ? acc[r][kk] * expf(s_cum[i] - s_cum[j])
                           : 0.f;
            }
            *reinterpret_cast<float4*>(s_s + j * SROW + ir) =
                make_float4(out[0], out[1], out[2], out[3]);
          }
        }
      }
      __syncthreads();

      // outputs: thread owns column p of tile rows 8 ig .. 8 ig + 7
      {
        const int p = tid % P;
        const int il0 = 8 * (tid / P);
        float acc[8], off[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] = off[r] = 0.f;
        const int jend = min(i0 + il0 + 8, qv);
        for (int j = 0; j < jend; ++j) {
          const float xd = __fmul_rn(__bfloat162float(s_x[j * P + p]), s_dt[j]);
          const float4 s0 = *reinterpret_cast<const float4*>(s_s + j * SROW + il0);
          const float4 s1 = *reinterpret_cast<const float4*>(s_s + j * SROW + il0 + 4);
          const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r] = fmaf(sv[r], xd, acc[r]);
        }
        if (c0 > 0) {  // the state entering the chunk (zero in the first)
          for (int n = 0; n < N; ++n) {
            const float st = s_st[n * P + p];
            const float4 q0 = *reinterpret_cast<const float4*>(s_ct + n * SROW + il0);
            const float4 q1 = *reinterpret_cast<const float4*>(s_ct + n * SROW + il0 + 4);
            const float cv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
            for (int r = 0; r < 8; ++r) off[r] = fmaf(cv[r], st, off[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + il0 + r;
          if (i < qv)
            yb[static_cast<int64_t>(c0 + i) * H * P + p] =
                __float2bfloat16(acc[r] + off[r] * expf(s_cum[i]));
        }
      }
    }
    __syncthreads();  // the last tile has read the entering state

    // state update: thread owns p in [4 pg, 4 pg + 4), n in [8 ng, 8 ng + 8)
    {
      const int pg = tid % 16;
      const int ng = tid / 16;
      float acc[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[q][m] = 0.f;
      for (int j = 0; j < qv; ++j) {
        const float dj = s_dt[j], wj = s_w[j];
        const uint2 xv = *reinterpret_cast<const uint2*>(s_x + j * P + 4 * pg);
        const float2 x01 = bf2(xv.x), x23 = bf2(xv.y);
        const float xs[4] = {x01.x, x01.y, x23.x, x23.y};
        float u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = __fmul_rn(__fmul_rn(xs[q], dj), wj);
        const uint32_t* brow =
            reinterpret_cast<const uint32_t*>(s_b + j * BROW + 8 * ng);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 bv = bf2(brow[m]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q][2 * m] = fmaf(u[q], bv.x, acc[q][2 * m]);
            acc[q][2 * m + 1] = fmaf(u[q], bv.y, acc[q][2 * m + 1]);
          }
        }
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float4* dst = reinterpret_cast<float4*>(s_st + (8 * ng + m) * P + 4 * pg);
        const float4 old = *dst;
        *dst = make_float4(__fadd_rn(__fmul_rn(old.x, decay), acc[0][m]),
                           __fadd_rn(__fmul_rn(old.y, decay), acc[1][m]),
                           __fadd_rn(__fmul_rn(old.z, decay), acc[2][m]),
                           __fadd_rn(__fmul_rn(old.w, decay), acc[3][m]));
      }
    }
  }
  __syncthreads();
  float* fsb = fs + (static_cast<int64_t>(b) * H + h) * P * N;
  for (int e = tid; e < P * N; e += NTHREADS) fsb[e] = s_st[(e % N) * P + e / N];
}

}  // namespace

// x (B, L, H, P) bf16; dt (B, L, H) f32; a (H,) f32; bm and cm (B, L, G,
// N) bf16; y (B, L, H, P) bf16 and fs (B, H, P, N) f32, both contiguous.
// P = 64, N = 128, G divides H, 1 <= chunk <= 256 (taken as min(chunk, L)).
// strides[12] = x (batch, seq, head), dt (batch, seq, head), bm (batch,
// seq, group), cm (batch, seq, group), in elements; unit stride on the last
// axis of each, and 16-byte aligned bf16 rows.  Returns the launch's
// cudaError_t.
extern "C" int repro_ssd_bf16(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              void* fs, int batch, int len, int heads,
                              int groups, int head_dim, int state_dim,
                              int chunk, const int64_t* strides,
                              void* stream) {
  if (batch <= 0 || len <= 0 || heads <= 0 || groups <= 0 ||
      heads % groups != 0 || head_dim != P || state_dim != N || chunk < 1 ||
      chunk > QMAX || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t* st = strides;
  const dim3 grid(heads, batch);
  ssd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(fs), len, heads, heads / groups, min(chunk, len),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}
