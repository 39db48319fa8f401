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
// The TPU kernel carries its sums in VMEM across a sequential grid axis over
// row tiles.  Here the row tiles are a grid axis of their own: pass 1 writes
// one partial per (row tile, replicate, metric), pass 2 adds the tiles in
// index order.  Every sum is IEEE f32 in a fixed order: no atomics, no
// tensor cores (TF32 would round the scores), so the result is reproducible
// bit for bit.  The weights are bit-identical to the reference: uint32
// multiplies wrap, (bits >> 8) * 2^-24 is exact in f32, and it is compared
// against the f32-rounded CDF constants given below as bit patterns.
//
// The TPU kernel pads the metrics to 128 lanes and takes any m.  Here a
// launch takes at most 8 columns, whose per-thread sums live in registers;
// the wrapper launches once per group of 8 in ascending order, each into
// its slice of the outputs through the row stride ld.  The weights do not
// depend on the column, so a column's bits are those of a launch on it
// alone.
//
// Bound on the H100: each (example, replicate, metric) costs the integer
// mixer plus a compare ladder and one FMA, while the bytes are only the
// (n, m) scores and the two (n_boot, m) outputs, so it is bound by
// operations (integer and f32 ALU, not tensor cores).
//
// Means: replaces the Pallas TPU kernel
//   src/repro/kernels/bootstrap/bootstrap.py:bootstrap_means
// the (n_boot,) replicate means sum(w*x) / max(sum(w), 1) of one (n,) f32
// vector, with the same weights keyed by (seed, example index, replicate).
// It is the partials kernel's layout with one column, three differences
// apart: NaN is not masked (a NaN makes every mean NaN, as w @ x does in
// the TPU kernel); any n_boot >= 1 is taken, where the TPU kernel asserts
// that its 128-replicate block divides n_boot and so refuses the default
// 1,000; and pass 2 divides, so means come out, not pairs.  Its bound is
// the same: operations, 3 per (example, replicate).

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

__global__ void __launch_bounds__(BB)
partials_tile_kernel(const float* __restrict__ x, int ld, int n, int m,
                     int n_boot, uint32_t seed, uint32_t start,
                     float* __restrict__ tile_wx, float* __restrict__ tile_w) {
  __shared__ float xs[CH * MAXM];
  const int i0 = blockIdx.y * CH;
  const int cnt = min(CH, n - i0);
  for (int t = threadIdx.x; t < cnt * m; t += BB)
    xs[t] = x[static_cast<int64_t>(i0 + t / m) * ld + t % m];
  __syncthreads();
  const int b = blockIdx.x * BB + threadIdx.x;
  if (b >= n_boot) return;
  float swx[MAXM], sw[MAXM];
#pragma unroll
  for (int j = 0; j < MAXM; ++j) swx[j] = sw[j] = 0.f;
  for (int i = 0; i < cnt; ++i) {
    const float w = poisson1_weight(
        mix_bits(static_cast<uint32_t>(b),
                 start + static_cast<uint32_t>(i0 + i), seed));
#pragma unroll
    for (int j = 0; j < MAXM; ++j) {
      if (j < m) {
        const float xv = xs[i * m + j];
        if (xv == xv) {  // NaN = unscorable: weight 0 for this metric
          swx[j] = fmaf(w, xv, swx[j]);
          sw[j] += w;
        }
      }
    }
  }
  const int64_t base = (static_cast<int64_t>(blockIdx.y) * n_boot + b) * m;
#pragma unroll
  for (int j = 0; j < MAXM; ++j) {
    if (j < m) {
      tile_wx[base + j] = swx[j];
      tile_w[base + j] = sw[j];
    }
  }
}

__global__ void sum_tiles_kernel(const float* __restrict__ tile_wx,
                                 const float* __restrict__ tile_w, int n_tiles,
                                 int n_boot, int m, int ld,
                                 float* __restrict__ swx,
                                 float* __restrict__ sw) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int count = n_boot * m;
  if (t >= count) return;
  float a = 0.f, c = 0.f;
  for (int s = 0; s < n_tiles; ++s) {
    a += tile_wx[static_cast<int64_t>(s) * count + t];
    c += tile_w[static_cast<int64_t>(s) * count + t];
  }
  const int64_t out = static_cast<int64_t>(t / m) * ld + t % m;
  swx[out] = a;
  sw[out] = c;
}

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

extern "C" int repro_bootstrap_tile_rows() { return CH; }
extern "C" int repro_bootstrap_tile_cols() { return MAXM; }

// One group of at most tile_cols() metric columns: scores points at the
// group's first column of an (n, ld) f32 row-major matrix (NaN =
// unscorable), swx / sw at the same column of (n_boot, ld) f32 outputs;
// tile_wx / tile_w are scratch of (ceil(n / tile_rows), n_boot, m) f32.  A
// column's sums do not depend on the other columns of its group.  Returns
// the launches' cudaError_t.
extern "C" int repro_bootstrap_partials(const void* scores, int ld, int n,
                                        int m, int n_boot, unsigned int seed,
                                        unsigned int start, void* tile_wx,
                                        void* tile_w, void* swx, void* sw,
                                        void* stream) {
  if (n <= 0 || m <= 0 || m > MAXM || ld < m || n_boot <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + CH - 1) / CH;
  const dim3 grid((n_boot + BB - 1) / BB, n_tiles);
  partials_tile_kernel<<<grid, BB, 0, s>>>(
      static_cast<const float*>(scores), ld, n, m, n_boot, seed, start,
      static_cast<float*>(tile_wx), static_cast<float*>(tile_w));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_tiles_kernel<<<(n_boot * m + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(tile_wx), static_cast<const float*>(tile_w),
      n_tiles, n_boot, m, ld, static_cast<float*>(swx), static_cast<float*>(sw));
  return static_cast<int>(cudaGetLastError());
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
