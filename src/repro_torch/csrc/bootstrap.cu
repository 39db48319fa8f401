// Poisson-bootstrap kernels for Hopper (sm_90a): the chunked partials of
// the streaming statistics, and the replicate means of the statistics API.
//
// Partials: replaces the Pallas TPU kernel
//   src/repro/kernels/bootstrap/bootstrap.py:bootstrap_partials
// which, per chunk of an (n, m) score matrix, emits the mergeable replicate
// pairs (sum w*x, sum w) of shape (n_boot, m).  The weight of (replicate b,
// example p) is Poisson(1) drawn from the murmur3-finalizer counter mixer
// keyed by (seed, start + p, b) -- src/repro/kernels/bootstrap/ref.py
// mix_bits / poisson1_weight -- so it is regenerated in registers and never
// touches memory.  A NaN score gets weight 0 for its metric only.
//
// Bound on the H100: the bytes are only the (n, m) scores and the two
// (n_boot, m) outputs, so the bound is the work.  Every (example,
// replicate) draw is integer work of at least 16 instructions: the
// position's key as a running add, three shift-and-xor pairs (the first
// is one shift and one 3-input xor, since a shift distributes over xor
// and the replicate's part can be hoisted), two multiplies and 7 compares
// against integer thresholds.  The 3 xors and the 7 compares run only on
// the ALU, 64 lanes a clock an SM (132 x 64 x 1.98e9 = 1.67e13 a second);
// the add and the shifts can go to the FMA pipe (IMAD.IADD, IMAD.HI)
// beside the multiplies, and every instruction takes one of 128 issue
// lanes a clock an SM (3.35e13 a second).  On top, an FMA and an add per
// (draw, metric).  At the main path's chunk (n = 1,024, 7 metrics, 1,000
// replicates) the issue lanes bound it: 1.024e6 x (16 + 14) / 3.35e13 =
// ~0.9 us, under a launch's own cost.
//
// The design, against what held the first version (one block of 128
// replicates walking all of a 1,024-row tile in one dependent chain, 8
// blocks on 132 SMs at that chunk, and a second launch adding the tiles):
//   - a block is 32 replicates (one a lane) by a tile of P_ROWS = 64 rows
//     (16 a warp), so the main path's chunk is 16 x 32 = 512 blocks, ~4
//     an SM.  P_ROWS is a constant, never derived from n or the occupancy;
//   - the block stages its tile's scores in shared memory once, NaN tested
//     there (a NaN becomes a 0 score of validity 0), so a draw's metrics
//     cost 2 FMAs each and no compare; the kernel is templated on the
//     group's column count (1..8), so absent columns cost nothing;
//   - a draw compares the raw counter bits with integer thresholds,
//     (bits >> 8) >= T_k, T_k = ceil(cdf_k * 2^24) for the f32 CDF
//     constants: the same count as the f32 ladder at all 2^24 values, with
//     no int-to-float conversion and no multiply; (boot * 0x9E3779B1) ^
//     seed is hoisted out of the row loop and pos * 0x85EBCA77 is a running
//     add (uint32 wrap-around, as the reference's);
//   - one launch: the last block of a replicate group to arrive (an
//     atomicInc that wraps its counter back to 0, after a __threadfence)
//     adds the partials in order; a one-tile call writes its sums directly.
//
// Summation order, fixed by n alone, for each (replicate, metric): a
// warp's 16 rows in row order (fmaf from 0); a tile is ((w0 + w1) + w2) +
// w3 over its warps; row block k of at most P_BLOCKS = 64 takes tiles k,
// k + 64, k + 128, ... and adds them in that order; the last block adds
// the row blocks' sums in block order.  Up to 64 tiles (4,096 rows, the
// main path's chunks of <= 1,024 among them) that is every tile in tile
// order.  The cap keeps the scratch at <= 64 partials per (replicate,
// metric) whatever n.  Every sum is IEEE f32 in that order: no atomics on
// values, no tensor cores (TF32 would round the scores), so the result is
// reproducible bit for bit; sum w holds integers, exact for n < 2^24, so
// it equals the plain version's.  A launch takes at most 8 columns; the
// wrapper launches once per group of 8 in ascending order, each into its
// slice of the outputs through the row stride ld.  The weights do not
// depend on the column, so a column's bits are those of a launch on it
// alone.
//
// Means: replaces the Pallas TPU kernel
//   src/repro/kernels/bootstrap/bootstrap.py:bootstrap_means
// the (n_boot,) replicate means sum(w*x) / max(sum(w), 1) of one (n,) f32
// vector, with the same weights keyed by (seed, example index, replicate).
// One block of 128 replicates a 1,024-row tile, then a second launch that
// adds the tiles and divides.  NaN is not masked (a NaN makes every mean
// NaN, as w @ x does in the TPU kernel); any n_boot >= 1 is taken, where
// the TPU kernel asserts that its 128-replicate block divides n_boot and
// so refuses the default 1,000.  Its bound is the partials' draw work
// with one FMA and one add a draw: at n = 10^6, B = 1,000, 10^9 draws x
// 10 ALU-only ops / 1.67e13 = 0.6 ms (their 18 instructions at 128 issue
// lanes take 0.54 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BB = 128;    // replicates per block (one per thread)
constexpr int CH = 1024;   // score rows per tile (grid axis y)
constexpr int MAXM = 8;    // metric columns per launch

__device__ __forceinline__ uint32_t mix_bits(uint32_t boot, uint32_t pos,
                                             uint32_t seed) {
  uint32_t h = (boot * 0x9E3779B1u) ^ (pos * 0x85EBCA77u) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float poisson1_weight(uint32_t bits) {
  // float32 of the Poisson(1) CDF at k = 0..6 (ref.py POISSON1_CDF)
  const uint32_t cdf[7] = {0x3ebc5ab2u, 0x3f3c5ab2u, 0x3f6b715eu, 0x3f7b2398u,
                           0x3f7f1026u, 0x3f7fd90fu, 0x3f7ffa8bu};
  const float u = static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;
  float w = 0.f;
#pragma unroll
  for (int i = 0; i < 7; ++i) w += (u >= __uint_as_float(cdf[i])) ? 1.f : 0.f;
  return w;
}

// -- partials --------------------------------------------------------------------

constexpr int P_REPS = 32;                  // replicates a block, one a lane
constexpr int P_WARPS = 4;                  // warps a block
constexpr int P_THREADS = 32 * P_WARPS;
constexpr int P_WARP_ROWS = 16;             // rows a warp of a tile
constexpr int P_ROWS = P_WARPS * P_WARP_ROWS;  // rows a tile
constexpr int P_BLOCKS = 64;                // most row blocks a replicate group
constexpr uint32_t KEY_BOOT = 0x9E3779B1u, KEY_POS = 0x85EBCA77u;

// Poisson(1) weight of the counter h = (boot key) ^ (pos key): the
// finalizer, then the count of thresholds T_k <= bits >> 8, as f32.  T_k =
// ceil(cdf_k * 2^24) of the f32 CDF constants in poisson1_weight above, so
// (bits >> 8) >= T_k exactly when (bits >> 8) * 2^-24 >= cdf_k in f32.
__device__ __forceinline__ float poisson1_draw(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const uint32_t v = h >> 8;
  const int k = (v >= 6171993u) + (v >= 12343986u) + (v >= 15429982u) +
                (v >= 16458648u) + (v >= 16715814u) + (v >= 16767247u) +
                (v >= 16775819u);
  return __int_as_float(0x4B000000 | k) - 8388608.f;  // exact for 0 <= k < 2^23
}

struct PartialsArgs {
  const float* x;      // the group's first column of an (n, ld) matrix
  float* part;         // (n_groups, n_blocks, 2 M, P_REPS) row-block sums
  unsigned* arrivals;  // (n_groups,) zero between calls
  float* swx;          // (n_boot, ld) outputs, at the group's first column
  float* sw;
  int ld, n, n_boot, n_tiles, n_blocks;
  uint32_t seed, start;
};

// Grid (n_blocks, n_groups): row block k of replicate group g.  See the
// note at the top for the summation order.
template <int M>
__global__ void __launch_bounds__(P_THREADS) partials_kernel(const PartialsArgs a) {
  __shared__ float xs[P_ROWS][M];  // scores, NaN -> 0
  __shared__ float vs[P_ROWS][M];  // 1 where scorable, else 0
  __shared__ float red[P_WARPS - 1][2 * M][P_REPS];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y;
  const int b = g * P_REPS + lane;
  const uint32_t key = static_cast<uint32_t>(b) * KEY_BOOT ^ a.seed;
  float acc[2 * M];  // warp 0: the row block's sums (swx then sw)
#pragma unroll
  for (int j = 0; j < 2 * M; ++j) acc[j] = 0.f;

  for (int t = blockIdx.x; t < a.n_tiles; t += a.n_blocks) {
    const int row0 = t * P_ROWS;
    const int rows = min(P_ROWS, a.n - row0);
    __syncthreads();  // the previous tile's xs / red are read
    for (int e = threadIdx.x; e < rows * M; e += P_THREADS) {
      const int r = e / M, j = e - r * M;
      const float v = a.x[static_cast<int64_t>(row0 + r) * a.ld + j];
      const bool ok = v == v;  // NaN = unscorable: weight 0 for this metric
      xs[r][j] = ok ? v : 0.f;
      vs[r][j] = ok ? 1.f : 0.f;
    }
    __syncthreads();
    float s[2 * M];
#pragma unroll
    for (int j = 0; j < 2 * M; ++j) s[j] = 0.f;
    const int r0 = warp * P_WARP_ROWS, r1 = min(r0 + P_WARP_ROWS, rows);
    uint32_t pk = (a.start + static_cast<uint32_t>(row0 + r0)) * KEY_POS;
    for (int r = r0; r < r1; ++r, pk += KEY_POS) {
      const float w = poisson1_draw(key ^ pk);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        s[j] = fmaf(w, xs[r][j], s[j]);
        s[M + j] = fmaf(w, vs[r][j], s[M + j]);  // sum w, exact
      }
    }
    if (warp > 0) {
#pragma unroll
      for (int j = 0; j < 2 * M; ++j) red[warp - 1][j][lane] = s[j];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int w = 0; w < P_WARPS - 1; ++w)
#pragma unroll
        for (int j = 0; j < 2 * M; ++j) s[j] += red[w][j][lane];
      if (t == blockIdx.x) {
#pragma unroll
        for (int j = 0; j < 2 * M; ++j) acc[j] = s[j];
      } else {
#pragma unroll
        for (int j = 0; j < 2 * M; ++j) acc[j] += s[j];
      }
    }
  }

  if (a.n_blocks == 1) {  // one row block: its sums are the result
    if (warp == 0 && b < a.n_boot) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        a.swx[static_cast<int64_t>(b) * a.ld + j] = acc[j];
        a.sw[static_cast<int64_t>(b) * a.ld + j] = acc[M + j];
      }
    }
    return;
  }
  constexpr int VALS = 2 * M * P_REPS;  // a row block's sums, lane fastest
  float* part = a.part + static_cast<int64_t>(g) * a.n_blocks * VALS;
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 2 * M; ++j)
      part[static_cast<int64_t>(blockIdx.x) * VALS + j * P_REPS + lane] = acc[j];
  }
  __threadfence();  // the sums are visible on the card before the arrival
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicInc(a.arrivals + g, a.n_blocks - 1) ==
             static_cast<unsigned>(a.n_blocks - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: every row block's sums in block order, read through L2
  // CHUNK blocks at a time, all of a thread's loads of a chunk in flight
  // before its adds (one round trip a chunk, not one a row block)
  constexpr int PER = (VALS + P_THREADS - 1) / P_THREADS;  // values a thread
  constexpr int CHUNK = 8;
  float total[PER];
  for (int k0 = 0; k0 < a.n_blocks; k0 += CHUNK) {
    float got[PER][CHUNK];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int v = threadIdx.x + i * P_THREADS;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        got[i][k] = (v < VALS && k0 + k < a.n_blocks)
                        ? __ldcg(part + static_cast<int64_t>(k0 + k) * VALS + v)
                        : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        if (k0 + k < a.n_blocks) total[i] = k0 + k == 0 ? got[i][k] : total[i] + got[i][k];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int v = threadIdx.x + i * P_THREADS;
    const int j = v / P_REPS, bb = g * P_REPS + (v - j * P_REPS);
    if (v < VALS && bb < a.n_boot) {
      if (j < M) a.swx[static_cast<int64_t>(bb) * a.ld + j] = total[i];
      else a.sw[static_cast<int64_t>(bb) * a.ld + j - M] = total[i];
    }
  }
}

const void* partials_for(int m) {
  switch (m) {
    case 1: return reinterpret_cast<const void*>(partials_kernel<1>);
    case 2: return reinterpret_cast<const void*>(partials_kernel<2>);
    case 3: return reinterpret_cast<const void*>(partials_kernel<3>);
    case 4: return reinterpret_cast<const void*>(partials_kernel<4>);
    case 5: return reinterpret_cast<const void*>(partials_kernel<5>);
    case 6: return reinterpret_cast<const void*>(partials_kernel<6>);
    case 7: return reinterpret_cast<const void*>(partials_kernel<7>);
    case 8: return reinterpret_cast<const void*>(partials_kernel<8>);
    default: return nullptr;
  }
}

// -- means -----------------------------------------------------------------------

__global__ void __launch_bounds__(BB)
means_tile_kernel(const float* __restrict__ x, int n, int n_boot, uint32_t seed,
                  float* __restrict__ tile_wx, float* __restrict__ tile_w) {
  __shared__ float xs[CH];
  const int i0 = blockIdx.y * CH;
  const int cnt = min(CH, n - i0);
  for (int t = threadIdx.x; t < cnt; t += BB) xs[t] = x[i0 + t];
  __syncthreads();
  const int b = blockIdx.x * BB + threadIdx.x;
  if (b >= n_boot) return;
  float swx = 0.f, sw = 0.f;
  for (int i = 0; i < cnt; ++i) {
    const float w = poisson1_weight(
        mix_bits(static_cast<uint32_t>(b), static_cast<uint32_t>(i0 + i), seed));
    swx = fmaf(w, xs[i], swx);  // NaN stays NaN, even at w = 0
    sw += w;
  }
  const int64_t o = static_cast<int64_t>(blockIdx.y) * n_boot + b;
  tile_wx[o] = swx;
  tile_w[o] = sw;
}

__global__ void means_finish_kernel(const float* __restrict__ tile_wx,
                                    const float* __restrict__ tile_w,
                                    int n_tiles, int n_boot,
                                    float* __restrict__ means) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_boot) return;
  float a = 0.f, c = 0.f;
  for (int s = 0; s < n_tiles; ++s) {
    a += tile_wx[static_cast<int64_t>(s) * n_boot + b];
    c += tile_w[static_cast<int64_t>(s) * n_boot + b];
  }
  means[b] = a / fmaxf(c, 1.f);
}

}  // namespace

// Rows a tile of the means kernel (its scratch is (ceil(n / rows), n_boot)
// f32 twice).
extern "C" int repro_bootstrap_tile_rows() { return CH; }

// The partials kernel's geometry, for the wrapper's scratch: the most
// columns a launch, replicates a block, rows a tile and row blocks a
// replicate group.
extern "C" int repro_bootstrap_partials_geometry(int* cols, int* reps, int* rows,
                                                 int* blocks) {
  *cols = MAXM;
  *reps = P_REPS;
  *rows = P_ROWS;
  *blocks = P_BLOCKS;
  return static_cast<int>(cudaSuccess);
}

// One group of at most `cols` metric columns: scores points at the
// group's first column of an (n, ld) f32 row-major matrix (NaN =
// unscorable), swx / sw at the same column of (n_boot, ld) f32 outputs.
// Scratch: part of at least ceil(n_boot / reps) * min(ceil(n / rows),
// blocks) * 2 * m * reps f32, and arrivals of ceil(n_boot / reps) counters,
// zero between calls (every call leaves them at zero).  A column's sums do
// not depend on the other columns of its group.  One launch; returns its
// cudaError_t.
extern "C" int repro_bootstrap_partials(const void* scores, int ld, int n, int m,
                                        int n_boot, unsigned int seed,
                                        unsigned int start, void* part,
                                        int64_t n_part, void* arrivals,
                                        int64_t n_arrivals, void* swx, void* sw,
                                        void* stream) {
  const int n_groups = n_boot > 0 ? (n_boot + P_REPS - 1) / P_REPS : 0;
  if (n <= 0 || m <= 0 || m > MAXM || ld < m || n_boot <= 0 || n_groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  PartialsArgs a;
  a.n_tiles = (n + P_ROWS - 1) / P_ROWS;
  a.n_blocks = min(a.n_tiles, P_BLOCKS);
  if (a.n_blocks > 1 &&
      (n_part < static_cast<int64_t>(n_groups) * a.n_blocks * 2 * m * P_REPS ||
       n_arrivals < n_groups || part == nullptr || arrivals == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const float*>(scores);
  a.part = static_cast<float*>(part);
  a.arrivals = static_cast<unsigned*>(arrivals);
  a.swx = static_cast<float*>(swx);
  a.sw = static_cast<float*>(sw);
  a.ld = ld;
  a.n = n;
  a.n_boot = n_boot;
  a.seed = seed;
  a.start = start;
  const dim3 grid(a.n_blocks, n_groups);
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchKernel(partials_for(m), grid, dim3(P_THREADS),
                                           params, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Registers, local (spill) bytes a thread, shared memory a block and
// resident blocks an SM of the partials kernel for m = which (1..8) columns,
// as the runtime reports them.
extern "C" int repro_bootstrap_kernel_info(int which, int* regs, int* local_bytes,
                                           int* smem_bytes, int* blocks_per_sm) {
  const void* fn = partials_for(which);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, P_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}

// data (n,) f32; tile_wx / tile_w scratch of (ceil(n / tile_rows), n_boot)
// f32; means (n_boot,) f32 output.  Returns the launches' cudaError_t.
extern "C" int repro_bootstrap_means(const void* data, int n, int n_boot,
                                     unsigned int seed, void* tile_wx,
                                     void* tile_w, void* means, void* stream) {
  if (n <= 0 || n_boot <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + CH - 1) / CH;
  const dim3 grid((n_boot + BB - 1) / BB, n_tiles);
  means_tile_kernel<<<grid, BB, 0, s>>>(
      static_cast<const float*>(data), n, n_boot, seed,
      static_cast<float*>(tile_wx), static_cast<float*>(tile_w));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  means_finish_kernel<<<(n_boot + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(tile_wx), static_cast<const float*>(tile_w),
      n_tiles, n_boot, static_cast<float*>(means));
  return static_cast<int>(cudaGetLastError());
}
