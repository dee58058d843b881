// Batched Eq. 2 UCB scoring over a stack of router states.
//
// Replaces: src/repro/kernels/linucb_score/kernel.py::_score_kernel, the
// Pallas TPU kernel behind linucb_score_blocked / ops.linucb_score.
//
// What bounds it on the H100: 2·R·K·d² FP32 operations (the quadratic
// forms) against R·d + S·K·d² + R·K floats moved. At R = 256 rows per
// state, K = 8, d = 26 that is ~2.7 MFLOP for ~50 KB per state; the
// kernel is bound by operations on the non-tensor FP32 units, and at the
// main path's small shapes by launch latency. No tensor cores: TF32
// keeps about three digits and would break the router's 1e-4 score
// contract.
//
// Design: the TPU kept all K inverses resident in VMEM; a Hopper block
// has 227 KB of shared memory, less than the 512 KB of K = 8 inverses at
// d = 128. So the grid is (row tiles, states), and each block walks the
// arms one at a time, staging that arm's inverse in shared memory
// (linucb_common.cuh) while its 32-row tile of contexts stays resident.
// α is an operand per state (hyper-parameters are data).
#include <cuda_runtime.h>

#include "linucb_common.cuh"

namespace {

__global__ void __launch_bounds__(linucb::kThreads)
score_kernel(const float* __restrict__ x,       // (S, R, d)
             const float* __restrict__ theta,   // (S, K, d)
             const float* __restrict__ ainv,    // (S, K, d, d)
             const float* __restrict__ pen,     // (S, K)
             const float* __restrict__ infl,    // (S, K)
             const float* __restrict__ alpha,   // (S,)
             float* __restrict__ out,           // (S, R, K)
             int R, int K, int d) {
  extern __shared__ float smem[];
  float* sa = smem;                                         // d * d
  float* sx = sa + d * d;                                   // 32 * (d + 1)
  float* ssc = sx + linucb::kRowsPerTile * (d + 1);         // 32 * K
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * linucb::kRowsPerTile;
  const int rows = min(linucb::kRowsPerTile, R - row0);
  const size_t kd = static_cast<size_t>(K) * d;

  linucb::load_tile(x + static_cast<size_t>(s) * R * d, row0, rows, d, sx);
  linucb::score_tile(theta + s * kd, ainv + s * kd * d, pen + s * K,
                     infl + s * K, alpha[s], sx, rows, K, d, sa, ssc);
  float* o = out + (static_cast<size_t>(s) * R + row0) * K;
  for (int i = threadIdx.x; i < rows * K; i += blockDim.x) o[i] = ssc[i];
}

}  // namespace

extern "C" int linucb_score_launch(const float* x, const float* theta,
                                   const float* ainv, const float* pen,
                                   const float* infl, const float* alpha,
                                   float* out, int S, int R, int K, int d,
                                   void* stream) {
  if (S == 0 || R == 0) return 0;
  const size_t smem = linucb::score_smem_bytes(K, d);
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + linucb::kRowsPerTile - 1) / linucb::kRowsPerTile, S);
  score_kernel<<<grid, linucb::kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      x, theta, ainv, pen, infl, alpha, out, R, K, d);
  return static_cast<int>(cudaGetLastError());
}
