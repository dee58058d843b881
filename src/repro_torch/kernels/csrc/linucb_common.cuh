// Shared device code of the two router kernels: the Eq. 2 scoring kernel
// (a register-tiled product per (row tile, arm, state)), the select rule,
// and the copy / launch-chaining primitives both use.
//
// Scoring, one block per (ROWS-row tile, arm a, state s), ROWS = 32, 64,
// 128 (the default, and the step kernel's) or 256. The block stages
// the tile's contexts X (ROWS x d) and arm a's inverse (d x d) in shared
// memory, zero-padded to DP columns (DP = 32, 64 or 128, the smallest
// that holds d: zeros are exact in every product below), and computes
// T = X A^-1_a with 2 ROWS threads. Thread (g, c), g in [0, 16 ROWS / DP),
// c in [0, DP / 8), holds an M x 8 micro-tile of T in registers, M =
// DP / 16: rows g + (16 ROWS / DP) i, columns 4c .. 4c + 3 and
// DP / 2 + 4c .. + 3. At DP = 128 every step of 4 along the reduction
// axis reads 8 float4 of X and 8 of A^-1 for 256 FMAs, so the loop is
// bound by the FP32 units, not by shared-memory loads; at small d the
// smaller micro-tile keeps 8 warps on each 128-row tile for latency.
// The epilogue forms x^T A^-1 x = sum_e T[r, e] x[r, e] and x . theta_a
// from the registers and reduces them over the DP / 8 lanes of a row
// group by xor shuffles (a fixed order on every launch), so T never
// leaves registers. A (row, arm)'s sums run in an order set by DP and
// kChunk alone, so every ROWS gives the same scores bit for bit.
//
// Staging is asynchronous: X and A^-1 go in by cp.async (16-byte copies
// when d % 4 == 0 and the operands are 16-byte aligned, else 4-byte
// ones), in DP / 32 commit groups of 32 reduction columns each. All are
// in flight at once, and the product of group k starts as soon as group
// k has landed, while the later groups are still coming in.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_mma.cuh"

namespace linucb {

constexpr int kMaxD = 128;
constexpr int kMaxK = 64;
constexpr float kNegInf = -1e30f;     // repro/kernels/linucb_step NEG_INF

// The scoring tile: 128 rows by default (the rows a block takes are a
// template parameter, ROWS), 8 columns a thread, 2 ROWS threads.
constexpr int kTileRows = 128;
constexpr int kMicro = 8;
constexpr int kChunk = 32;                       // columns per commit group

__host__ __device__ constexpr int score_threads(int rows) { return 2 * rows; }
__host__ __device__ constexpr int score_ldx(int dp) { return dp + 4; }

// Dynamic shared memory of a scoring block: the X tile (rows x DP + 4
// floats), the inverse (DP x DP) and theta_a (DP).
inline size_t score_smem_bytes(int dp, int rows) {
  return sizeof(float) * (static_cast<size_t>(rows) * score_ldx(dp) +
                          static_cast<size_t>(dp) * dp + dp);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16- and 4-byte asynchronous copies; with ok false the destination is
// zero-filled and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N commit groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// The same for n in 0..3 known only at run time.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Programmatic dependent launch (warp_mma.cuh).
using warp_mma::pdl_launch_dependents;
using warp_mma::pdl_wait;

// The select rule of one request row: Eq. 2 score + tiebreak noise on the
// hard-ceiling candidates (-1e30 elsewhere), argmax with a strict '>' in
// ascending slot order (exact ties land on the lowest slot, as
// jnp.argmax), then the forced override.
__device__ __forceinline__ int choose_arm(const float* sc, const float* nz,
                                          const bool* cand, bool forced,
                                          int force_arm, int K) {
  int arm = 0;
  float best = 0.f;
  for (int a = 0; a < K; ++a) {
    const float m = cand[a] ? sc[a] + nz[a] : kNegInf;
    if (a == 0 || m > best) { best = m; arm = a; }
  }
  return forced ? force_arm : arm;
}

namespace {

// Eq. 2 for rows [ROWS bx, ROWS bx + ROWS) of state s against arm a:
// out[(s R + r) K + a] = x_r . theta_a
//   + alpha_s sqrt(max(x_r^T Ainv_a x_r, 0) / infl_a) - pen_a.
// x (S, R, d), theta (S, K, d), ainv (S, K, d, d), pen / infl (S, K),
// alpha (S,), out (S, R, K). vec: 16-byte copies are allowed.
template <int DP, int ROWS>
__global__ void __launch_bounds__(score_threads(ROWS))
linucb_score_kernel(const float* __restrict__ x,
                    const float* __restrict__ theta,
                    const float* __restrict__ ainv,
                    const float* __restrict__ pen,
                    const float* __restrict__ infl,
                    const float* __restrict__ alpha,
                    float* __restrict__ out, int R, int K, int d, int vec) {
  constexpr int kT = score_threads(ROWS);
  constexpr int kCols = DP / kMicro;          // column groups: 4, 8 or 16
  constexpr int kM = DP / 16;                 // rows a thread: 2, 4 or 8
  constexpr int kRowGroups = ROWS / kM;       // at ROWS 128: 64, 32 or 16
  static_assert(kRowGroups * kCols == kT, "one thread per micro-tile");
  constexpr int kLdx = score_ldx(DP);
  constexpr int kGroups = DP / kChunk;        // commit groups: 1, 2 or 4
  static_assert(32 % kCols == 0, "a row group lies within one warp");
  // Let a dependent update grid start its own staging now.
  pdl_launch_dependents();

  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                           // ROWS x kLdx
  float* sa = sx + ROWS * kLdx;               // DP x DP
  float* sth = sa + DP * DP;                  // DP
  const int a = blockIdx.y, s = blockIdx.z;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, R - row0);
  const int tid = threadIdx.x;
  const float* xs = x + (static_cast<size_t>(s) * R + row0) * d;
  const size_t arm = static_cast<size_t>(s) * K + a;
  const float* as = ainv + arm * d * d;

  for (int k = 0; k < kGroups; ++k) {
    const int f0 = k * kChunk;
    if (vec) {
      for (int i = tid; i < ROWS * (kChunk / 4); i += kT) {
        const int r = i / (kChunk / 4), col = f0 + 4 * (i % (kChunk / 4));
        const bool ok = r < rows && col < d;
        cp_async16(sx + r * kLdx + col, ok ? xs + r * d + col : x, ok);
      }
      for (int i = tid; i < kChunk * (DP / 4); i += kT) {
        const int f = f0 + i / (DP / 4), col = 4 * (i % (DP / 4));
        const bool ok = f < d && col < d;
        cp_async16(sa + f * DP + col, ok ? as + f * d + col : ainv, ok);
      }
    } else {
      for (int i = tid; i < ROWS * kChunk; i += kT) {
        const int r = i / kChunk, col = f0 + i % kChunk;
        const bool ok = r < rows && col < d;
        cp_async4(sx + r * kLdx + col, ok ? xs + r * d + col : x, ok);
      }
      for (int i = tid; i < kChunk * DP; i += kT) {
        const int f = f0 + i / DP, col = i % DP;
        const bool ok = f < d && col < d;
        cp_async4(sa + f * DP + col, ok ? as + f * d + col : ainv, ok);
      }
    }
    cp_async_commit();
  }
  for (int e = tid; e < DP; e += kT) sth[e] = e < d ? theta[arm * d + e] : 0.f;

  const int c = tid % kCols, g = tid / kCols;
  float acc[kM][kMicro];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kGroups; ++k) {
    cp_async_wait(kGroups - 1 - k);
    __syncthreads();   // commit group k (and theta) is visible to all
#pragma unroll 2
    for (int f = k * kChunk; f < (k + 1) * kChunk; f += 4) {
      float4 xv[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i)
        xv[i] = *reinterpret_cast<const float4*>(
            sx + (g + kRowGroups * i) * kLdx + f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* arow = sa + (f + kk) * DP + 4 * c;
        const float4 a0 = *reinterpret_cast<const float4*>(arow);
        const float4 a1 = *reinterpret_cast<const float4*>(arow + DP / 2);
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          const float xk = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y
                         : kk == 2 ? xv[i].z : xv[i].w;
          acc[i][0] = fmaf(xk, a0.x, acc[i][0]);
          acc[i][1] = fmaf(xk, a0.y, acc[i][1]);
          acc[i][2] = fmaf(xk, a0.z, acc[i][2]);
          acc[i][3] = fmaf(xk, a0.w, acc[i][3]);
          acc[i][4] = fmaf(xk, a1.x, acc[i][4]);
          acc[i][5] = fmaf(xk, a1.y, acc[i][5]);
          acc[i][6] = fmaf(xk, a1.z, acc[i][6]);
          acc[i][7] = fmaf(xk, a1.w, acc[i][7]);
        }
      }
    }
  }

  // Epilogue: the quadratic form and x . theta from the registers, summed
  // over the row group's kCols lanes; lane c writes rows i = c mod kCols.
  const float4 t0 = *reinterpret_cast<const float4*>(sth + 4 * c);
  const float4 t1 = *reinterpret_cast<const float4*>(sth + DP / 2 + 4 * c);
  const float al = alpha[s], pa = pen[arm], ia = infl[arm];
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    const float* xr = sx + (g + kRowGroups * i) * kLdx;
    const float4 x0 = *reinterpret_cast<const float4*>(xr + 4 * c);
    const float4 x1 = *reinterpret_cast<const float4*>(xr + DP / 2 + 4 * c);
    float q = acc[i][0] * x0.x;
    q = fmaf(acc[i][1], x0.y, q);
    q = fmaf(acc[i][2], x0.z, q);
    q = fmaf(acc[i][3], x0.w, q);
    q = fmaf(acc[i][4], x1.x, q);
    q = fmaf(acc[i][5], x1.y, q);
    q = fmaf(acc[i][6], x1.z, q);
    q = fmaf(acc[i][7], x1.w, q);
    float ex = x0.x * t0.x;
    ex = fmaf(x0.y, t0.y, ex);
    ex = fmaf(x0.z, t0.z, ex);
    ex = fmaf(x0.w, t0.w, ex);
    ex = fmaf(x1.x, t1.x, ex);
    ex = fmaf(x1.y, t1.y, ex);
    ex = fmaf(x1.z, t1.z, ex);
    ex = fmaf(x1.w, t1.w, ex);
#pragma unroll
    for (int off = kCols / 2; off > 0; off >>= 1) {
      q += __shfl_xor_sync(0xffffffffu, q, off);
      ex += __shfl_xor_sync(0xffffffffu, ex, off);
    }
    const int r = g + kRowGroups * i;
    if (i % kCols == c && r < rows)
      out[(static_cast<size_t>(s) * R + row0 + r) * K + a] =
          ex + al * sqrtf(fmaxf(q, 0.f) / ia) - pa;
  }
}

// Launches linucb_score_kernel<DP, ROWS> over grid (R / ROWS, K, S); DP
// is 32, 64 or 128 and at least d (kernel.py's score_plan). The
// shared-memory attribute is set once per instantiation, at its fixed
// size.
template <int DP, int ROWS>
int launch_score_dp(const float* x, const float* theta, const float* ainv,
                    const float* pen, const float* infl, const float* alpha,
                    float* out, int S, int R, int K, int d,
                    cudaStream_t stream) {
  const int smem = static_cast<int>(score_smem_bytes(DP, ROWS));
  static const int attr = cudaFuncSetAttribute(
      linucb_score_kernel<DP, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr) return attr;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ainv) % 16 == 0;
  const dim3 grid((R + ROWS - 1) / ROWS, K, S);
  linucb_score_kernel<DP, ROWS><<<grid, score_threads(ROWS), smem, stream>>>(
      x, theta, ainv, pen, infl, alpha, out, R, K, d, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The scoring launch at ROWS rows a block; the step kernel's chained
// route takes the default.
template <int ROWS = kTileRows>
int launch_score(const float* x, const float* theta, const float* ainv,
                 const float* pen, const float* infl, const float* alpha,
                 float* out, int S, int R, int K, int d, int dp,
                 cudaStream_t stream) {
  if (S == 0 || R == 0) return 0;
  if (d < 1 || d > dp || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dp) {
    case 32: return launch_score_dp<32, ROWS>(x, theta, ainv, pen, infl,
                                              alpha, out, S, R, K, d, stream);
    case 64: return launch_score_dp<64, ROWS>(x, theta, ainv, pen, infl,
                                              alpha, out, S, R, K, d, stream);
    case 128: return launch_score_dp<128, ROWS>(x, theta, ainv, pen, infl,
                                                alpha, out, S, R, K, d,
                                                stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace linucb
