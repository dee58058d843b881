// One closed-loop router block over a stack of states: score, select,
// decay + Sherman-Morrison + pacer fold, theta refresh.
//
// Replaces: src/repro/kernels/linucb_step/kernel.py::_step_kernel, the
// Pallas TPU megakernel behind linucb_step_blocked / ops.linucb_step.
//
// What bounds it on the H100: the request loop's dependent chain. Each
// Sherman-Morrison step reads the inverse the previous one wrote, but
// only within one arm: request i reads and writes arm arms[i]'s A, A^-1,
// b and last_upd alone, and the pacer's Eq. 3-4 fold reads only the
// chosen costs. So the K arms' chains are independent, and applying each
// arm's requests in block order gives every arm exactly the serial
// loop's sequence of operations. The chain per state is the busiest
// arm's request count of dependent d x d passes; the statistics (A, A^-1:
// 2·K·d² floats, ~1 MB at K = 8, d = 128) are read once and written once.
//
// Design: linucb_update_kernel, one block per (arm a, state s) plus one
// pacer block per state (grid (K + 1, S)).
//   - Arm block: holds A^-1_a and A_a in registers for the whole block
//     (64 KB each at d = 128; a lane owns one float4 column chunk of a
//     few rows of both), selects every request's arm (the same rule, in
//     the same order, in every block of the state), lists the requests
//     with arms[i] == a in block order by warp ballots, and applies them.
//     At the arm's first request it decays the statistics as the oracle
//     does (A g, A^-1 / g by IEEE division, b g); dt comes from
//     last_upd[a] there and is 0 (g = 1) after it, as in the serial loop.
//     Request j is one pass over the lane's rows: the reciprocal of
//     1 + x_j . u_j once (__frcp_rn, the IEEE quotient); then
//     A^-1 -= (u_e u_f) / denom by that reciprocal (u_e u_f first, so the
//     update stays symmetric; within the 1e-4 contract), A += x x^T,
//     b += r x, and from the updated rows u_{j+1} = A^-1 x_{j+1} with the
//     rows' terms x_{j+1, e} u_{j+1, e} of the next denominator, summed
//     by warp (shuffles) and over the warps after the one barrier a
//     request costs. Only the vectors (u, x, b) live in shared memory;
//     the x rows come in by cp.async through a ring of 8 buffers, 6
//     requests ahead. Then theta_a = A^-1_a b_a, and A, A^-1, b, theta
//     and last_upd are written once; an arm no request chose is copied
//     and its theta recomputed, as the TPU kernel does.
//   - Pacer block: writes arms, r and c for every row and folds the
//     num_valid chosen costs into (c_ema, lambda) in order (Eq. 3-4).
//   At d <= 32 a block has 128 threads, groups of 8 lanes (the row's 8
//   column chunks) owning 2 rows each; above, 512 threads, groups of 32
//   owning 8 rows each (a state has only K + 1 blocks, so an arm's block
//   has an SM to itself). A group's kRPT row sums take log2 kG + kRPT - 1
//   shuffles (group_sums), not kRPT log2 kG.
// Scores come two ways (kernel.py's route):
//   - B <= 1 ("single"): one launch. Every block recomputes the single
//     row's K scores itself (K·d² FMAs: 5.4 k at d = 26; x^T A^-1 first,
//     as the scoring kernel and the oracle), and they all reach the same
//     argmax; only the chosen arm's block updates.
//   - B > 1 ("pdl"): linucb_score_kernel (linucb_common.cuh) writes the
//     block's (B, K) scores to a workspace, and the update kernel follows
//     it by programmatic dependent launch: its blocks stage the statistics
//     while the scores' tail runs, and wait for the scores only then.
// The PRNG chain, the forced counters and the pacer's enabled gate stay
// outside, in the router, as in the JAX package.
#include <cuda_runtime.h>

#include "linucb_common.cuh"

namespace linucb {
namespace {

constexpr float kGammaFloor = 1e-6f;   // repro/kernels/linucb_step GAMMA_FLOOR

// x rows of the requests ahead, in flight by cp.async: a ring of kRing
// buffers, filled kPre requests ahead.
constexpr int kRing = 8;
constexpr int kPre = 6;

// Dynamic shared memory of an update block: b, the x ring and u (two
// buffers), 4 kG floats each (d padded with zeros); the warps' terms of
// x . u (two buffers); the request list (index, reward or cost) of kT
// rows, the warps' counts, the K scores and (single route) the K x d
// partial products of the scores.
template <int kT, int kG>
constexpr size_t update_smem_bytes(int K, int d) {
  return sizeof(float) * ((3 + kRing) * 4 * kG + 2 * (kT / 32) + 2 * kT +
                          32 + K + static_cast<size_t>(K) * d);
}

template <int kT>
__device__ __forceinline__ void block_sync() {
  if constexpr (kT == 32) __syncwarp(); else __syncthreads();
}

// Sums each of a lane's kN values over the kG lanes of its group (kG and
// kN powers of two, kN <= kG) by halving: at each xor offset from kG / 2
// down, while a lane holds more than one value it keeps one half (the
// lower half if its offset bit is clear) and adds its partner's copy of
// it, one shuffle per value kept; then single values are summed. v[0]
// ends as the group's sum of value idx(lane) = the bits of lane that
// chose upper halves; log2 kG + kN - 1 shuffles instead of kN log2 kG.
// One fixed order on every launch.
template <int kG, int kN>
__device__ __forceinline__ int group_sums(float (&v)[kN], int lane) {
  int idx = 0, n = kN;
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) {
    if (n > 1) {
      const int half = n / 2;
      const bool upper = lane & o;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        if (i < half) {
          const float keep = upper ? v[half + i] : v[i];
          const float send = upper ? v[i] : v[half + i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (upper) idx += half;
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return idx;
}

// Sums v over the warp (xor shuffles) and stores it at out[warp].
__device__ __forceinline__ void warp_sum_to(float v, float* out, int warp,
                                            int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) out[warp] = v;
}

// u = M v for the rows g + (blockDim / kG) r of M, held as float4 chunk
// c of each row in m[r]: the row sums land on the lanes of each group
// with (lane & (kG / kRPT - 1)) == 0 (group_sums), which store u[e] into
// out. Returns the lane's share of v . u, sum_r v[e_r] (M_{e_r, chunk c}
// . v_c), formed before the row sums so that its warp reduction does not
// wait for them (v's pad entries past d are 0).
template <int kG, int kRPT>
__device__ __forceinline__ float rows_matvec(const float4 (&m)[kRPT],
                                             const float* v, float* out,
                                             int g, int c, int lane, int d) {
  const float4 vv = reinterpret_cast<const float4*>(v)[c];
  const int rows = blockDim.x / kG;
  float p[kRPT], t = 0.f;
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    p[r] = fmaf(m[r].w, vv.w, fmaf(m[r].z, vv.z,
           fmaf(m[r].y, vv.y, m[r].x * vv.x)));
    t = fmaf(v[g + rows * r], p[r], t);
  }
  const int e = g + rows * group_sums<kG, kRPT>(p, lane);
  if ((lane & (kG / kRPT - 1)) == 0 && e < d) out[e] = p[0];
  return t;
}

// kT threads in groups of kG lanes. Group g owns rows g + (kT / kG) r,
// r < kRPT, of the arm's statistics, and lane c of it the float4 column
// chunk c of those rows, of A^-1 and of A, in registers throughout. u and
// x chunks are read once a request for all the lane's rows.
template <int kT, int kG, int kRPT>
__global__ void __launch_bounds__(kT, 1)
linucb_update_kernel(
    const float* __restrict__ A,        // (S, K, d, d)
    const float* __restrict__ Ainv,     // (S, K, d, d)
    const float* __restrict__ b,        // (S, K, d)
    const float* __restrict__ theta,    // (S, K, d)
    const int* __restrict__ last_upd,   // (S, K)
    const float* __restrict__ x,        // (S, B, d)
    const float* __restrict__ rewards,  // (S, B, K)
    const float* __restrict__ costs,    // (S, B, K)
    const float* __restrict__ noise,    // (S, B, K)
    const bool* __restrict__ cand,      // (S, K)
    const float* __restrict__ pen,      // (S, K)
    const float* __restrict__ infl,     // (S, K)
    const float* __restrict__ alpha,    // (S,) hyper leaves
    const float* __restrict__ hyp_gamma, const float* __restrict__ hyp_eta,
    const float* __restrict__ hyp_aema, const float* __restrict__ hyp_lbar,
    const float* __restrict__ pac_lam,  // (S,) pacer leaves
    const float* __restrict__ pac_cema, const float* __restrict__ pac_budget,
    const int* __restrict__ t_sels,     // (S,) t + B
    const int* __restrict__ force_arm,  // (S,)
    const bool* __restrict__ forced,    // (S, B)
    const float* __restrict__ scores,   // (S, B, K), or null: in-block
    float* __restrict__ oA, float* __restrict__ oAinv,
    float* __restrict__ ob, float* __restrict__ otheta,
    int* __restrict__ olu, int* __restrict__ oarms, float* __restrict__ orew,
    float* __restrict__ ocost, float* __restrict__ olam,
    float* __restrict__ oc_ema, int B, int K, int d, int num_valid,
    int dt_max) {
  constexpr int kWarps = kT / 32;
  constexpr int kGroups = kT / kG;      // row groups
  constexpr int kLd = 4 * kG;           // padded width of the vectors
  static_assert(kG <= 32 && kRPT <= kG, "a row group lies within one warp");
  extern __shared__ __align__(16) float smem[];
  float* sb = smem;                       // kLd
  float* sx = sb + kLd;                   // kRing x kLd: a ring of x rows
  float* su = sx + kRing * kLd;           // 2 x kLd
  float* sden = su + 2 * kLd;             // 2 x kWarps: x . u by warp
  float* lval = sden + 2 * kWarps;        // kT: reward (arm) / cost (pacer)
  int* lidx = reinterpret_cast<int*>(lval + kT);   // kT
  int* wcnt = lidx + kT;                  // 32
  float* ssc = reinterpret_cast<float*>(wcnt + 32);  // K
  float* sq = ssc + K;                    // K x d (single route)
  const int a = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool pacer = a == K;
  const size_t arm = static_cast<size_t>(s) * K + a;
  const size_t dd = static_cast<size_t>(d) * d;
  const float* xs = x + static_cast<size_t>(s) * B * d;
  // This lane's rows g + kGroups r and its columns 4c .. 4c + 3 of them.
  const int g = tid / kG, c = tid % kG, f0 = 4 * c;
  const int w = d - f0;                   // columns of the chunk in a row
  float4 ai[kRPT], av[kRPT];              // A^-1 and A, in registers

  if (!pacer) {   // the arm's statistics, in flight while the scores come
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int e = g + kGroups * r;
      const size_t off = arm * dd + static_cast<size_t>(e) * d + f0;
      const bool row = e < d;
      const float* p = Ainv + off;
      const float* q = A + off;
      ai[r] = make_float4(row && w > 0 ? p[0] : 0.f, row && w > 1 ? p[1] : 0.f,
                          row && w > 2 ? p[2] : 0.f, row && w > 3 ? p[3] : 0.f);
      av[r] = make_float4(row && w > 0 ? q[0] : 0.f, row && w > 1 ? q[1] : 0.f,
                          row && w > 2 ? q[2] : 0.f, row && w > 3 ? q[3] : 0.f);
    }
    for (int f = tid; f < kLd; f += kT) sb[f] = f < d ? b[arm * d + f] : 0.f;
    for (int f = tid; f < (kRing + 2) * kLd; f += kT) sx[f] = 0.f;   // pads
  }

  // The block's scores: in-block for the single row (every block computes
  // the same K values in the same order, x^T A^-1 first as the scoring
  // kernel and the oracle do), else the score launch's.
  const float* sc = ssc;
  if (scores != nullptr) {
    pdl_wait();   // the score launch has finished and its writes are visible
    sc = scores + static_cast<size_t>(s) * B * K;
  } else if (B > 0) {
    block_sync<kT>();   // the pads' zeros are in before x lands
    for (int f = tid; f < d; f += kT) sx[f] = xs[f];
    block_sync<kT>();
    for (int i = tid; i < K * d; i += kT) {
      const int k = i / d, col = i - k * d;
      const float* cp = Ainv + (static_cast<size_t>(s) * K + k) * dd + col;
      float t = 0.f;
      for (int f = 0; f < d; ++f)
        t = fmaf(sx[f], cp[static_cast<size_t>(f) * d], t);
      sq[i] = t * sx[col];
    }
    block_sync<kT>();
    for (int k = tid; k < K; k += kT) {
      const size_t sk = static_cast<size_t>(s) * K + k;
      float q = 0.f, ex = 0.f;
      for (int f = 0; f < d; ++f) {
        q += sq[k * d + f];
        ex = fmaf(sx[f], theta[sk * d + f], ex);
      }
      ssc[k] = ex + alpha[s] * sqrtf(fmaxf(q, 0.f) / infl[sk]) - pen[sk];
    }
    block_sync<kT>();
  }
  const bool* cd = cand + static_cast<size_t>(s) * K;
  const size_t row0 = static_cast<size_t>(s) * B;
  const int farm = force_arm[s];

  if (pacer) {
    const float eta = hyp_eta[s], a_ema = hyp_aema[s], lbar = hyp_lbar[s];
    const float budget = pac_budget[s];
    float lam = pac_lam[s], c_ema = pac_cema[s];
    for (int r0 = 0; r0 < B; r0 += kT) {
      const int i = r0 + tid;
      if (i < B) {
        const int ai_ = choose_arm(sc + static_cast<size_t>(i) * K,
                                   noise + (row0 + i) * K, cd,
                                   forced[row0 + i], farm, K);
        const size_t req = row0 + i;
        const float r = rewards[req * K + ai_], co = costs[req * K + ai_];
        oarms[req] = ai_;
        orew[req] = r;
        ocost[req] = co;
        lval[tid] = co;
      }
      block_sync<kT>();
      if (tid == 0) {
        const int n = min(kT, num_valid - r0);
        for (int j = 0; j < n; ++j) {
          c_ema = (1.f - a_ema) * c_ema + a_ema * lval[j];             // Eq. 3
          lam = fminf(fmaxf(lam + eta * (c_ema / budget - 1.f), 0.f), lbar);  // Eq. 4
        }
      }
      block_sync<kT>();
    }
    if (tid == 0) {
      olam[s] = lam;
      oc_ema[s] = c_ema;
    }
    return;
  }

  const float gamma = fminf(fmaxf(hyp_gamma[s], kGammaFloor), 1.f);
  const int t_sel = t_sels[s];
  const int lu = last_upd[arm];
  bool applied = false;
  block_sync<kT>();   // b and the zero pads are in

  for (int r0 = 0; r0 < num_valid; r0 += kT) {
    // The requests of rows [r0, r0 + kT) that chose arm a, in block order.
    const int i = r0 + tid;
    bool mine = false;
    if (i < num_valid)
      mine = choose_arm(sc + static_cast<size_t>(i) * K,
                        noise + (row0 + i) * K, cd, forced[row0 + i], farm,
                        K) == a;
    const unsigned m = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) wcnt[warp] = __popc(m);
    block_sync<kT>();
    int off = 0, n = 0;
    for (int w2 = 0; w2 < kWarps; ++w2) {
      off += w2 < warp ? wcnt[w2] : 0;
      n += wcnt[w2];
    }
    if (mine) {
      const int pos = off + __popc(m & ((1u << lane) - 1u));
      lidx[pos] = i;
      lval[pos] = rewards[(row0 + i) * K + a];
    }
    block_sync<kT>();
    if (n == 0) continue;

    // The first kPre requests' x rows into the ring, one commit group
    // each (every thread commits, so the groups count alike).
    for (int j = 0; j < kPre; ++j) {
      if (tid < d && j < n)
        cp_async4(sx + (j % kRing) * kLd + tid,
                  xs + static_cast<size_t>(lidx[j]) * d + tid, true);
      cp_async_commit();
    }
    if (!applied) {
      // Decay once, at the arm's first request (the oracle's A g,
      // A^-1 / g, b g); after it dt = 0 and g = 1 exactly.
      applied = true;
      const int dt = min(max(t_sel - lu, 0), dt_max);
      const float gd = powf(gamma, static_cast<float>(dt));
      if (gd != 1.f) {
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
          ai[r].x = ai[r].x / gd; ai[r].y = ai[r].y / gd;
          ai[r].z = ai[r].z / gd; ai[r].w = ai[r].w / gd;
          av[r].x *= gd; av[r].y *= gd; av[r].z *= gd; av[r].w *= gd;
        }
        if (c == 0) {
#pragma unroll
          for (int r = 0; r < kRPT; ++r) {
            const int e = g + kGroups * r;
            if (e < d) sb[e] *= gd;
          }
        }
      }
    }
    cp_async_wait<kPre - 2>();   // x_0 and x_1 are in
    block_sync<kT>();
    // u_0 = A^-1 x_0 and the warps' terms of x_0 . u_0.
    warp_sum_to(rows_matvec<kG, kRPT>(ai, sx, su, g, c, lane, d), sden,
                warp, lane);
    block_sync<kT>();

    for (int j = 0; j < n; ++j) {
      // u_j, x_j, x_{j+1} and the warps' terms of x_j . u_j are in. This
      // pass applies request j and forms u_{j+1} = A^-1 x_{j+1} from the
      // updated rows, so a request costs one pass and one barrier.
      const float* xv = sx + (j % kRing) * kLd;
      const float* xn = sx + ((j + 1) % kRing) * kLd;
      const float* uv = su + (j & 1) * kLd;
      float* un = su + ((j + 1) & 1) * kLd;
      // 1 + x . u from the warps' terms, in warp order; its reciprocal once
      // (__frcp_rn: the IEEE quotient 1 / (1 + x . u), without the
      // division's slow path).
      const float* dw = sden + (j & 1) * kWarps;
      float dn = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < kWarps; ++w2) dn += dw[w2];
      const float rden = __frcp_rn(1.f + dn);
      const float4 uu = reinterpret_cast<const float4*>(uv)[c];
      const float4 xx = reinterpret_cast<const float4*>(xv)[c];
      const float rj = lval[j];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        // A^-1 -= (u u^T) / denom (u_e u_f first: the update stays
        // symmetric), A += x x^T, b += r x; pad rows and columns stay 0.
        const int e = g + kGroups * r;
        const float ue = e < d ? uv[e] : 0.f, xe = e < d ? xv[e] : 0.f;
        ai[r].x -= (ue * uu.x) * rden;
        ai[r].y -= (ue * uu.y) * rden;
        ai[r].z -= (ue * uu.z) * rden;
        ai[r].w -= (ue * uu.w) * rden;
        av[r].x = fmaf(xe, xx.x, av[r].x);
        av[r].y = fmaf(xe, xx.y, av[r].y);
        av[r].z = fmaf(xe, xx.z, av[r].z);
        av[r].w = fmaf(xe, xx.w, av[r].w);
        if (c == 0 && e < d) sb[e] = fmaf(rj, xe, sb[e]);
      }
      if (j + 1 < n)
        warp_sum_to(rows_matvec<kG, kRPT>(ai, xn, un, g, c, lane, d),
                    sden + ((j + 1) & 1) * kWarps, warp, lane);
      // The x row kPre requests ahead into the buffer x_{j+kPre-kRing}
      // left; then wait until x_{j+2} is in.
      if (tid < d && j + kPre < n)
        cp_async4(sx + ((j + kPre) % kRing) * kLd + tid,
                  xs + static_cast<size_t>(lidx[j + kPre]) * d + tid, true);
      cp_async_commit();
      cp_async_wait<kPre - 2>();
      block_sync<kT>();
    }
  }

  // theta_a = A^-1_a b_a, then every statistic of the arm written once.
  rows_matvec<kG, kRPT>(ai, sb, otheta + arm * d, g, c, lane, d);
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int e = g + kGroups * r;
    if (e >= d) continue;
    float* pi = oAinv + arm * dd + static_cast<size_t>(e) * d + f0;
    float* pa = oA + arm * dd + static_cast<size_t>(e) * d + f0;
    if (w > 0) { pi[0] = ai[r].x; pa[0] = av[r].x; }
    if (w > 1) { pi[1] = ai[r].y; pa[1] = av[r].y; }
    if (w > 2) { pi[2] = ai[r].z; pa[2] = av[r].z; }
    if (w > 3) { pi[3] = ai[r].w; pa[3] = av[r].w; }
  }
  for (int f = tid; f < d; f += kT) ob[arm * d + f] = sb[f];
  if (tid == 0) olu[arm] = applied ? t_sel : lu;
}

// One launch configuration of the update kernel: the shared-memory
// attribute is set once per instantiation, at the most K <= kMaxK and
// the instantiation's largest d take.
template <int kT, int kG, int kRPT>
struct Update {
  static int attr() {
    static const int err = cudaFuncSetAttribute(
        linucb_update_kernel<kT, kG, kRPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(update_smem_bytes<kT, kG>(kMaxK, 4 * kG)));
    return err;
  }
};

}  // namespace
}  // namespace linucb

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
    float* oc_ema, float* scores, int S, int B, int K, int d, int dp,
    int num_valid, int dt_max, void* stream) {
  using namespace linucb;
  if (S == 0) return 0;
  if (d < 1 || d > kMaxD || K < 1 || K > kMaxK || num_valid > B ||
      (B > 1) != (scores != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (scores != nullptr) {
    err = linucb::launch_score(x, theta, Ainv, pen, infl, alpha, scores, S,
                               B, K, d, dp, st);
    if (err) return err;
  }
  auto run = [&](auto kernel, int threads, size_t smem, int attr) {
    if (attr) return attr;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(K + 1, S);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = pdl;
    cfg.numAttrs = scores != nullptr ? 1 : 0;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, kernel, A, Ainv, b, theta, last_upd, x, rewards, costs, noise,
        cand, pen, infl, alpha, gamma, eta, a_ema, lbar, lam, c_ema, budget,
        t_sel, force_arm, forced, static_cast<const float*>(scores), oA,
        oAinv, ob, otheta, olu, oarms, orew, ocost, olam, oc_ema, B, K, d,
        num_valid, dt_max));
  };
  if (d <= 32)
    err = run(linucb_update_kernel<128, 8, 2>, 128,
              update_smem_bytes<128, 8>(K, d), Update<128, 8, 2>::attr());
  else
    err = run(linucb_update_kernel<512, 32, 8>, 512,
              update_smem_bytes<512, 32>(K, d), Update<512, 32, 8>::attr());
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
