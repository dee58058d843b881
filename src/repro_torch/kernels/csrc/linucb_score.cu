// Batched Eq. 2 UCB scoring over a stack of router states.
//
// Replaces: src/repro/kernels/linucb_score/kernel.py::_score_kernel, the
// Pallas TPU kernel behind linucb_score_blocked / ops.linucb_score.
//
// What bounds it on the H100: 2·R·K·d² FP32 operations (the quadratic
// forms) against R·d + S·K·d² + R·K floats moved. At R = 4096, K = 8,
// d = 128 that is 1.07 GFLOP for 2.8 MB: bound by the FP32 units
// (16 µs at 67 TFLOP/s). At the main path's (20, 256, 8, 26) it is 2.8
// MFLOP per state, a few microseconds of latency. No tensor cores: TF32
// keeps about three digits and would break the router's 1e-4 score
// contract.
//
// Design (linucb_common.cuh): the TPU kept all K inverses resident in
// VMEM; a Hopper block has 227 KB of shared memory, less than the 512 KB
// of K = 8 inverses at d = 128. So each block scores one 128-row tile
// against ONE arm: grid (R / 128, K, S). It stages that arm's inverse
// once, zero-padded to DP = 32 / 64 / 128, and computes the tile's
// products in (DP / 16) x 8 register micro-tiles with 256 threads. The
// grid gives K times more blocks than a loop over the arms would, and no
// block restages an inverse: at (1, 4096, 8, 128) 256 blocks (133 KB of
// shared memory each, so one per SM at a time: two waves on 132 SMs), at
// (20, 256, 8, 26) 320 blocks (22 KB each, all resident at once). The
// wrapper picks DP (kernel.py's score_plan); α is an operand per state
// (hyper-parameters are data).
//
// The rows a block takes are the TPU kernel's block_r knob: `rows` = 32,
// 64, 128 or 256, with 2 x rows threads. Every choice gives the same
// scores bit for bit; 128 unless a caller passes another (kernels/tune.py
// times them).
#include <cuda_runtime.h>

#include "linucb_common.cuh"

namespace {

// linucb::launch_score at `rows` rows a block, known only at run time: 32,
// 64, 128 or 256 (kernel.py's BLOCK_ROWS). Only this file instantiates the
// other rows; the step kernel's file keeps the default.
int launch_score_rows(const float* x, const float* theta, const float* ainv,
                      const float* pen, const float* infl, const float* alpha,
                      float* out, int S, int R, int K, int d, int dp,
                      int rows, cudaStream_t stream) {
  switch (rows) {
    case 32: return linucb::launch_score<32>(x, theta, ainv, pen, infl,
                                             alpha, out, S, R, K, d, dp,
                                             stream);
    case 64: return linucb::launch_score<64>(x, theta, ainv, pen, infl,
                                             alpha, out, S, R, K, d, dp,
                                             stream);
    case 128: return linucb::launch_score<128>(x, theta, ainv, pen, infl,
                                               alpha, out, S, R, K, d, dp,
                                               stream);
    case 256: return linucb::launch_score<256>(x, theta, ainv, pen, infl,
                                               alpha, out, S, R, K, d, dp,
                                               stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int linucb_score_launch(const float* x, const float* theta,
                                   const float* ainv, const float* pen,
                                   const float* infl, const float* alpha,
                                   float* out, int S, int R, int K, int d,
                                   int dp, int rows, void* stream) {
  return launch_score_rows(x, theta, ainv, pen, infl, alpha, out, S, R, K,
                           d, dp, rows, static_cast<cudaStream_t>(stream));
}
