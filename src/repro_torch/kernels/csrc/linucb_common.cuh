// Shared device code of the two router kernels: Eq. 2 scoring of one
// tile of request rows against every arm of one state.
//
// Layout of a 256-thread block: 32 rows per tile, 8 neighbouring lanes
// per row. For each arm the block stages that arm's (d x d) inverse in
// shared memory (64 KB at d = 128: all K inverses, 512 KB, would not fit
// in the 227 KB a block may use) and every row's 8 lanes split the d
// output columns of x^T A^-1, accumulating in FP32 FMAs. The 8 partial
// sums of x^T A^-1 x and of x . theta are combined with xor shuffles, so
// every row is reduced in the same fixed order on every launch.
#pragma once

#include <cuda_runtime.h>

namespace linucb {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 8;
constexpr int kRowsPerTile = kThreads / kLanesPerRow;   // 32
constexpr int kMaxD = 128;
constexpr int kMaxK = 64;
constexpr int kColsPerLane = kMaxD / kLanesPerRow;      // 16

// Dynamic shared memory of a scoring block: one arm's inverse, the row
// tile of contexts (row stride d + 1 against bank conflicts) and the
// tile's (rows x K) scores.
inline size_t score_smem_bytes(int K, int d) {
  return sizeof(float) * (static_cast<size_t>(d) * d
                          + static_cast<size_t>(kRowsPerTile) * (d + 1)
                          + static_cast<size_t>(kRowsPerTile) * K);
}

// Loads rows [row0, row0 + rows) of x (R x d, one state) into sx.
__device__ inline void load_tile(const float* __restrict__ x, int row0,
                                 int rows, int d, float* sx) {
  const int ldx = d + 1;
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, f = i - r * d;
    sx[r * ldx + f] = x[static_cast<size_t>(row0 + r) * d + f];
  }
}

// Eq. 2 for the tile: ssc[r * K + a] = x_r . theta_a
//   + alpha * sqrt(max(x_r^T Ainv_a x_r, 0) / infl_a) - pen_a.
// theta (K x d), ainv (K x d x d), pen / infl (K) of one state.
// Every thread of the block must call it (it synchronises).
__device__ inline void score_tile(const float* __restrict__ theta,
                                  const float* __restrict__ ainv,
                                  const float* __restrict__ pen,
                                  const float* __restrict__ infl,
                                  float alpha, const float* sx, int rows,
                                  int K, int d, float* sa, float* ssc) {
  const int ldx = d + 1;
  const int row = threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x % kLanesPerRow;
  const bool live = row < rows;
  const float* xr = sx + row * ldx;
  for (int a = 0; a < K; ++a) {
    __syncthreads();   // the previous arm's reads of sa are done
    const float* src = ainv + static_cast<size_t>(a) * d * d;
    for (int i = threadIdx.x; i < d * d; i += blockDim.x) sa[i] = src[i];
    __syncthreads();
    float q = 0.f, ex = 0.f;
    if (live) {
      float acc[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.f;
      for (int f = 0; f < d; ++f) {
        const float xf = xr[f];
        const float* arow = sa + f * d;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int e = lane + j * kLanesPerRow;
          if (e < d) acc[j] = fmaf(xf, arow[e], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int e = lane + j * kLanesPerRow;
        if (e < d) q = fmaf(acc[j], xr[e], q);
      }
      const float* th = theta + static_cast<size_t>(a) * d;
      for (int f = lane; f < d; f += kLanesPerRow) ex = fmaf(xr[f], th[f], ex);
    }
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
      q += __shfl_xor_sync(0xffffffffu, q, off);
      ex += __shfl_xor_sync(0xffffffffu, ex, off);
    }
    if (live && lane == 0) {
      const float v = fmaxf(q, 0.f) / infl[a];
      ssc[row * K + a] = ex + alpha * sqrtf(v) - pen[a];
    }
  }
  __syncthreads();   // ssc complete for the caller
}

}  // namespace linucb
