// One closed-loop router block over a stack of states: score, select,
// decay + Sherman-Morrison + pacer fold, theta refresh.
//
// Replaces: src/repro/kernels/linucb_step/kernel.py::_step_kernel, the
// Pallas TPU megakernel behind linucb_step_blocked / ops.linucb_step.
//
// What bounds it on the H100: the request loop. Within a state the B
// updates are serial (each Sherman-Morrison step reads the inverse the
// previous one wrote), so a block costs B dependent d x d passes however
// many SMs the card has; across states the loops are independent. The
// statistics (A, A^-1: 2·K·d² floats, ~1 MB at K = 8, d = 128) are read
// once and written once per block, which is small next to the serial
// chain.
//
// Design: two launches that together are this kernel.
//   1. select_kernel, grid (row tiles, S): Eq. 2 scores of the block
//      (linucb_common.cuh), + pre-drawn tiebreak noise, hard-ceiling
//      mask, argmax with a strict '>' in ascending slot order (exact ties
//      land on the lowest slot, as jnp.argmax), forced override, and the
//      (reward, cost) gather of the chosen arm.
//   2. update_kernel, one 256-thread block per state: copies the stats to
//      the outputs, then runs the num_valid requests in order, updating
//      the chosen arm's A, A^-1 and b in place in device memory (the
//      counterpart of the TPU kernel's input_output_aliases; the rows
//      stay in L2). Warps split the matvec A^-1 x by rows, every thread
//      forms the denominator, and all threads write the rank-1 update,
//      with __syncthreads() between the three. The pacer's two scalars
//      live in registers. Finally theta_a = A_a^-1 b_a for every arm.
// The PRNG chain, the forced counters and the pacer's enabled gate stay
// outside, in the router, as in the JAX package.
#include <cuda_runtime.h>

#include "linucb_common.cuh"

namespace {

constexpr float kGammaFloor = 1e-6f;   // repro/kernels/linucb_step GAMMA_FLOOR
constexpr float kNegInf = -1e30f;      // repro/kernels/linucb_step NEG_INF

__global__ void __launch_bounds__(linucb::kThreads)
select_kernel(const float* __restrict__ theta,   // (S, K, d)
              const float* __restrict__ ainv,    // (S, K, d, d)
              const float* __restrict__ x,       // (S, B, d)
              const float* __restrict__ rewards, // (S, B, K)
              const float* __restrict__ costs,   // (S, B, K)
              const float* __restrict__ noise,   // (S, B, K)
              const bool* __restrict__ cand,     // (S, K)
              const float* __restrict__ pen,     // (S, K)
              const float* __restrict__ infl,    // (S, K)
              const float* __restrict__ alpha,   // (S,)
              const int* __restrict__ force_arm, // (S,)
              const bool* __restrict__ forced,   // (S, B)
              int* __restrict__ arms,            // (S, B)
              float* __restrict__ r_out,         // (S, B)
              float* __restrict__ c_out,         // (S, B)
              int B, int K, int d) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sx = sa + d * d;
  float* ssc = sx + linucb::kRowsPerTile * (d + 1);
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * linucb::kRowsPerTile;
  const int rows = min(linucb::kRowsPerTile, B - row0);
  const size_t kd = static_cast<size_t>(K) * d;

  linucb::load_tile(x + static_cast<size_t>(s) * B * d, row0, rows, d, sx);
  linucb::score_tile(theta + s * kd, ainv + s * kd * d, pen + s * K,
                     infl + s * K, alpha[s], sx, rows, K, d, sa, ssc);
  const int r = threadIdx.x;
  if (r >= rows) return;
  const size_t i = static_cast<size_t>(s) * B + row0 + r;
  const float* nz = noise + i * K;
  const bool* cd = cand + s * K;
  int arm = 0;
  float best = 0.f;
  for (int a = 0; a < K; ++a) {
    const float m = cd[a] ? ssc[r * K + a] + nz[a] : kNegInf;
    if (a == 0 || m > best) { best = m; arm = a; }
  }
  if (forced[i]) arm = force_arm[s];
  arms[i] = arm;
  r_out[i] = rewards[i * K + arm];
  c_out[i] = costs[i * K + arm];
}

__global__ void __launch_bounds__(linucb::kThreads)
update_kernel(const float* __restrict__ A,       // (S, K, d, d)
              const float* __restrict__ Ainv,    // (S, K, d, d)
              const float* __restrict__ b,       // (S, K, d)
              const int* __restrict__ last_upd,  // (S, K)
              const float* __restrict__ x,       // (S, B, d)
              const float* __restrict__ hyp_gamma, // (S,) hyper leaves
              const float* __restrict__ hyp_eta,
              const float* __restrict__ hyp_aema,
              const float* __restrict__ hyp_lbar,
              const float* __restrict__ pac_lam,   // (S,) pacer leaves
              const float* __restrict__ pac_cema,
              const float* __restrict__ pac_budget,
              const int* __restrict__ t_sels,   // (S,) t + B
              const int* __restrict__ arms,      // (S, B)
              const float* __restrict__ r_in,    // (S, B) chosen rewards
              const float* __restrict__ c_in,    // (S, B) chosen costs
              float* __restrict__ oA, float* __restrict__ oAinv,
              float* __restrict__ ob, float* __restrict__ otheta,
              int* __restrict__ olu, float* __restrict__ olam,
              float* __restrict__ oc_ema,
              int B, int K, int d, int num_valid, int dt_max) {
  __shared__ int slu[linucb::kMaxK];
  __shared__ float sxv[linucb::kMaxD];
  __shared__ float sax[linucb::kMaxD];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nwarps = blockDim.x / 32;
  const size_t dd = static_cast<size_t>(d) * d;
  const size_t base = static_cast<size_t>(s) * K * dd;

  for (size_t i = tid; i < K * dd; i += blockDim.x) {
    oA[base + i] = A[base + i];
    oAinv[base + i] = Ainv[base + i];
  }
  for (int i = tid; i < K * d; i += blockDim.x)
    ob[static_cast<size_t>(s) * K * d + i] = b[static_cast<size_t>(s) * K * d + i];
  if (tid < K) slu[tid] = last_upd[s * K + tid];

  const float gamma = fminf(fmaxf(hyp_gamma[s], kGammaFloor), 1.f);
  const float eta = hyp_eta[s], a_ema = hyp_aema[s], lbar = hyp_lbar[s];
  const int t_sel = t_sels[s];
  const float budget = pac_budget[s];
  float lam = pac_lam[s], c_ema = pac_cema[s];

  for (int i = 0; i < num_valid; ++i) {
    const size_t req = static_cast<size_t>(s) * B + i;
    if (tid < d) sxv[tid] = x[req * d + tid];
    __syncthreads();   // x_i, slu and the previous step's writes are visible
    const int arm = arms[req];
    const float r = r_in[req], c = c_in[req];
    const int dt = min(max(t_sel - slu[arm], 0), dt_max);
    const float g = powf(gamma, static_cast<float>(dt));
    float* Aa = oA + base + arm * dd;
    float* Ai = oAinv + base + arm * dd;
    float* ba = ob + (static_cast<size_t>(s) * K + arm) * d;

    // Ax = (A_inv / g) x: one warp per row, lanes over columns.
    for (int e = warp; e < d; e += nwarps) {
      float p = 0.f;
      for (int f = lane; f < d; f += 32) p = fmaf(Ai[e * d + f] / g, sxv[f], p);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) sax[e] = p;
    }
    __syncthreads();
    float denom = 0.f;
    for (int e = 0; e < d; ++e) denom = fmaf(sxv[e], sax[e], denom);
    denom += 1.f;

    for (int idx = tid; idx < d * d; idx += blockDim.x) {
      const int e = idx / d, f = idx - e * d;
      Ai[idx] = Ai[idx] / g - (sax[e] * sax[f]) / denom;
      Aa[idx] = Aa[idx] * g + sxv[e] * sxv[f];
    }
    if (tid < d) ba[tid] = ba[tid] * g + r * sxv[tid];
    c_ema = (1.f - a_ema) * c_ema + a_ema * c;                    // Eq. 3
    lam = fminf(fmaxf(lam + eta * (c_ema / budget - 1.f), 0.f), lbar);  // Eq. 4
    __syncthreads();   // every read of sxv, sax and slu[arm] is done
    if (tid == 0) slu[arm] = t_sel;
  }
  __syncthreads();

  // theta_a = A_a^-1 b_a for every arm: one warp per (arm, row).
  for (int row = warp; row < K * d; row += nwarps) {
    const int a = row / d, e = row - a * d;
    const float* Ai = oAinv + base + a * dd + static_cast<size_t>(e) * d;
    const float* ba = ob + (static_cast<size_t>(s) * K + a) * d;
    float p = 0.f;
    for (int f = lane; f < d; f += 32) p = fmaf(Ai[f], ba[f], p);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      p += __shfl_xor_sync(0xffffffffu, p, off);
    if (lane == 0) otheta[(static_cast<size_t>(s) * K + a) * d + e] = p;
  }
  if (tid < K) olu[s * K + tid] = slu[tid];
  if (tid == 0) {
    olam[s] = lam;
    oc_ema[s] = c_ema;
  }
}

}  // namespace

extern "C" int linucb_step_launch(
    const float* A, const float* Ainv, const float* b, const float* theta,
    const int* last_upd, const float* x, const float* rewards,
    const float* costs, const float* noise, const bool* cand,
    const float* pen, const float* infl, const float* alpha,
    const float* gamma, const float* eta, const float* a_ema,
    const float* lbar, const float* lam, const float* c_ema,
    const float* budget, const int* t_sel, const int* force_arm,
    const bool* forced, float* oA, float* oAinv, float* ob, float* otheta,
    int* olu, int* oarms, float* orew, float* ocost, float* olam,
    float* oc_ema, int S, int B, int K, int d, int num_valid, int dt_max,
    void* stream) {
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    const size_t smem = linucb::score_smem_bytes(K, d);
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((B + linucb::kRowsPerTile - 1) / linucb::kRowsPerTile, S);
    select_kernel<<<grid, linucb::kThreads, smem, st>>>(
        theta, Ainv, x, rewards, costs, noise, cand, pen, infl, alpha,
        force_arm, forced, oarms, orew, ocost, B, K, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  update_kernel<<<S, linucb::kThreads, 0, st>>>(
      A, Ainv, b, last_upd, x, gamma, eta, a_ema, lbar, lam, c_ema, budget,
      t_sel, oarms, orew, ocost, oA, oAinv, ob, otheta, olu, olam, oc_ema, B,
      K, d, num_valid, dt_max);
  return static_cast<int>(cudaGetLastError());
}
