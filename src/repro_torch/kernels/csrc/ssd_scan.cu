// Mamba2 SSD scan with a carried (N, P) state, by chunks of Q rows.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel, the Pallas
// TPU kernel behind ssd_scan_bh / ops.ssd_scan.
//
// What it computes: for each batch row b and head h, over chunks of Q rows
// of the sequence, with inclusive in-chunk cumulants cum_i = sum_{k<=i}
// dt_k A_h:
//   y_i = sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} dt_j x_j
//         + e^{cum_i} C_i h + D_h x_i
//   h  <- e^{cum_Q} h + sum_j e^{cum_Q - cum_j} dt_j B_j (x) x_j
// from h = 0, and the final h. B and C are shared by all heads (one
// group), as the TPU op's per-head repeat of them makes them.
//
// What bounds it on the H100. The served launch is one chunk: the
// mamba2-370m prompts pad to 32 tokens (serving/engine.py PROMPT_BUCKET)
// and the server keeps at most 128, so L = Q <= 128, H = 32, P = 64,
// N = 128. At L = Q = 32 the work is ~19 MFLOP (C B^T once, then per head
// M x and the state B^T (w o x); C h is zero on the first chunk) against
// ~1.3 MB moved, most of it the f32 final state: bytes bound it at
// ~0.4 us, and a launch and one round trip to device memory are most of
// what is left. At L = 2048 (16 chunks of 128) it is ~2.6 GFLOP in bf16,
// ~40 us on the FP32 units and ~3 us on the tensor cores.
//
// Design. Three routes, chosen up front by kernel.ssd_plan (the Python
// side) from the shapes, the dtype and the operands' alignment:
//   one_chunk (L <= Q, bf16): ssd_chunk_mma_kernel in mode kOneChunk, one
//     launch. Grid (head groups x P tiles, 1, B). A block stages its
//     chunk's B and C (Q x N) and its heads' x tiles (Q x TP) with
//     16-byte cp.async (rows past the chunk or past L zero-filled: no
//     decay, no input, as the TPU op's zero padding), computes C B^T once
//     on the tensor cores (mma.sync m16n8k16, f32 accumulators; only its
//     lower-triangle 16 x 16 blocks) into shared memory in f32 and reuses
//     it for every head it owns. Per head: M = C B^T o e^{cum_i - cum_j}
//     o dt_j on the lower triangle is formed straight into A fragments
//     (rounded to bf16 once), y = M x + D x on the tensor cores; the
//     state B^T (w o x), w_j = e^{cum_Q - cum_j} dt_j, on the tensor cores
//     with w o x split into a bf16 high and low part (two products into
//     one f32 accumulator: the state feeds every later token, so it keeps
//     ~16 bits; one bf16 alone keeps 8). The work is dealt to the 8
//     warps as tasks of 16 rows (a row tile of y, or of the state) across
//     the whole P tile, so each A fragment (of M, C or B^T) serves every
//     column; the loops run over the chunk's 16-row tiles, so a Q = 32
//     chunk does Q = 32 work. C h is not computed (h = 0).
//   chunked (L > Q, bf16): the chunk-parallel SSD form (arXiv:2405.21060
//     §6) in three launches chained by programmatic dependent launch:
//     (1) ssd_chunk_mma_kernel, mode kChunkState, grid (.., chunks, B):
//     each chunk's own state S_c = B^T (w o x) and cum_Q into f32
//     workspaces; (2) ssd_state_pass_kernel: the serial pass
//     h_c = e^{cum_Q,c-1} h_{c-1} + S_{c-1} per (b, h, slice of N x P),
//     written over S_c in place, and the final h; (3) ssd_chunk_mma_kernel,
//     mode kChunkOut: y = M x + e^{cum} C h_c + D x per chunk, with h_c
//     split into bf16 high and low parts for C h_c; its staging and
//     C B^T run before it waits for (2).
//   fma (f32, and bf16 that the tensor-core route cannot take: N % 16,
//     P % 8, or a view off 16 bytes): ssd_chunk_fma_kernel<T>, FP32 FMAs
//     from shared memory, one (b, chunk, h, 16 columns of P) per block,
//     with the same modes and the same pass (2) for L > Q. It recomputes
//     C B^T in each block (f32 is not served).
// The decay e^{cum_i - cum_j} is computed only where j <= i (above the
// diagonal the exponent is positive and could overflow; it is selected
// away, never multiplied by 0). The D skip is added in f32 before the
// cast of y.
#include <cstdint>

#include "attention_common.cuh"
#include "warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;          // largest chunk
constexpr int kMaxN = 128;          // largest state size
constexpr int kMaxTP = 64;          // P columns per block (tensor cores)
constexpr int kMaxG = kWarps;       // heads per block (one warp scans each)
constexpr int kMaxPairs = kMaxTP / 16;  // 16-column groups of a P tile
constexpr int kFmaTP = 16;          // P columns per block (FP32 FMAs)

enum Mode { kOneChunk = 0, kChunkState = 1, kChunkOut = 2 };
enum Route { kRouteOneChunk = 0, kRouteChunked = 1, kRouteFma = 2 };

struct Params {
  const void* x;      // (B, L, H, P), rows x_sl apart
  const float* dt;    // (B, L, H)
  const float* A;     // (H,)
  const void* Bm;     // (B, L, N), rows b_sl apart
  const void* Cm;     // (B, L, N), rows c_sl apart
  const float* D;     // (H,)
  void* y;            // (B, L, H, P)
  float* h_out;       // (B, H, N, P)
  float* ws;          // (B, nc, H, N, P): S_c, then h_c (chunked)
  float* ws_cum;      // (B, nc, H): cum_Q of each chunk (chunked)
  int L, H, P, N, Q, nc, G, TP, mode;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

// Inclusive cumsum of dt A over the chunk's rows [0, rows) by one warp
// (lane t sums rows 4t..4t+3 in order, then a warp scan of the lane
// sums), into scum; dt into sdt; w_j = e^{cum_last - cum_j} dt_j into sw.
// Rows at or past Q, or past L, read dt = 0. Returns cum_last.
__device__ float chunk_cumsum(const float* __restrict__ dtb, int H, float a,
                              int l0, int Q, int L, int rows, float* scum,
                              float* sdt, float* sw) {
  const int lane = threadIdx.x & 31;
  float part[kMaxQ / 32], dv[kMaxQ / 32];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int r = lane * (kMaxQ / 32) + k, l = l0 + r;
    dv[k] = (r < Q && l < L) ? dtb[static_cast<size_t>(l) * H] : 0.f;
    run += dv[k] * a;
    part[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int r = lane * (kMaxQ / 32) + k;
    if (r < rows) {
      const float cum = excl + part[k];
      scum[r] = cum;
      sdt[r] = dv[k];
      sw[r] = expf(last - cum) * dv[k];
    }
  }
  return last;
}

// ---- the tensor-core kernel (bf16) ----

// Byte offsets of the tensor-core kernel's shared memory for a chunk of
// Qp rows (Q rounded up to 16), N, a P tile of TP and G heads. Rows of
// bf16 are padded by 16 bytes, so 8 rows' 16-byte ldmatrix reads hit
// distinct banks. sU holds two bf16 planes (high and low parts): w o x
// (Qp x TP) where the block computes states, h_c (N x TP) in kChunkOut.
// C B^T is kept in f32, rows Qp + 8 floats apart (a row offset of 8 or
// 24 banks: the fragments' 8-byte reads are conflict-free).
struct MmaSmem {
  int nb, xb, cbp, b, c, x, u, plane, cb, f, d, bytes;
  __host__ __device__ MmaSmem(int mode, int Qp, int N, int TP, int G) {
    const bool y = mode != kChunkState;
    nb = 2 * N + 16;
    xb = 2 * TP + 16;
    cbp = Qp + 8;
    b = 0;
    c = b + Qp * nb;
    x = c + (y ? Qp * nb : 0);
    u = x + G * Qp * xb;
    plane = (mode == kChunkOut ? N : Qp) * xb;
    cb = u + 2 * plane;
    f = cb + (y ? Qp * cbp * 4 : 0);
    d = f + 3 * G * Qp * 4;
    bytes = d + G * 4;
  }
};

// acc += A B_hi, lo += A B_lo for the two 8-column tiles of B whose
// rows start at q (the high plane) and q + plane (the low plane).
__device__ __forceinline__ void hi_lo_product(float (&acc)[2][4],
                                              float (&lo)[2][4],
                                              const uint32_t (&a)[4],
                                              const uint8_t* q, int plane) {
  uint32_t bh[4], bl[4];
  ldmatrix_x4_trans(bh, q);
  ldmatrix_x4_trans(bl, q + plane);
  const uint32_t h0[2] = {bh[0], bh[1]}, h1[2] = {bh[2], bh[3]};
  const uint32_t l0[2] = {bl[0], bl[1]}, l1[2] = {bl[2], bl[3]};
  mma_bf16(acc[0], a, h0);
  mma_bf16(acc[1], a, h1);
  mma_bf16(lo[0], a, l0);
  mma_bf16(lo[1], a, l1);
}
__device__ __forceinline__ void sum_into(float (&acc)[2][4],
                                         const float (&lo)[2][4]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e >> 2][e & 3] += lo[e >> 2][e & 3];
}

// One warp's share of a head: the 16 rows of y of row tile mi, every
// column of the P tile (16 at a time): [C h_c, scaled by e^{cum_i}] +
// M x + D x. M's A fragments are formed once per 16 columns of j, from
// C B^T in shared memory, and serve every 16 columns of the P tile. With
// TP % 16 == 8 the last 16 columns' second 8 read the rows' 16-byte pad;
// those columns are never stored.
__device__ __forceinline__ void y_task(
    const Params& p, const MmaSmem& s, const uint8_t* sC, const float* sCB,
    const uint8_t* xt, const uint8_t* sU, const float* cum, const float* dtg,
    float d_skip, bool with_h, int mi, int b, int h, int l0, int p0) {
  const int lane = threadIdx.x & 31, g4 = lane >> 2, t4 = lane & 3;
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  const int n_pairs = (p.TP + 15) / 16;
  float acc[kMaxPairs][2][4] = {};
  const int i0 = 16 * mi + g4, i1 = i0 + 8;
  const float ci0 = cum[i0], ci1 = cum[i1];
  if (with_h) {
    float lo[kMaxPairs][2][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < p.N / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, sC + (16 * mi + lr) * s.nb + (16 * ks + lc) * 2);
      const uint8_t* q = sU + (16 * ks + lr) * s.xb + lc * 2;
#pragma unroll
      for (int pr = 0; pr < kMaxPairs; ++pr)
        if (pr < n_pairs)
          hi_lo_product(acc[pr], lo[pr], a, q + 32 * pr, s.plane);
    }
    const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
    for (int pr = 0; pr < kMaxPairs; ++pr) {
      sum_into(acc[pr], lo[pr]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[pr][e][0] *= e0;
        acc[pr][e][1] *= e0;
        acc[pr][e][2] *= e1;
        acc[pr][e][3] *= e1;
      }
    }
  }
  for (int kb = 0; kb <= mi; ++kb) {
    // Columns j0, j0 + 1 (first 8-column tile) and j0 + 8, j0 + 9.
    const int j0 = 16 * kb + 2 * t4;
    const float* r0 = sCB + i0 * s.cbp + j0;
    const float* r1 = r0 + 8 * s.cbp;
    const float2 cb00 = *reinterpret_cast<const float2*>(r0);
    const float2 cb01 = *reinterpret_cast<const float2*>(r0 + 8);
    const float2 cb10 = *reinterpret_cast<const float2*>(r1);
    const float2 cb11 = *reinterpret_cast<const float2*>(r1 + 8);
    const float2 cj0 = *reinterpret_cast<const float2*>(cum + j0);
    const float2 cj1 = *reinterpret_cast<const float2*>(cum + j0 + 8);
    const float2 dj0 = *reinterpret_cast<const float2*>(dtg + j0);
    const float2 dj1 = *reinterpret_cast<const float2*>(dtg + j0 + 8);
    auto m = [](float cb, float ci, float cj, float dj, bool keep) {
      return keep ? cb * __expf(ci - cj) * dj : 0.f;
    };
    const uint32_t a[4] = {
        pack_bf16(m(cb00.x, ci0, cj0.x, dj0.x, j0 <= i0),
                  m(cb00.y, ci0, cj0.y, dj0.y, j0 + 1 <= i0)),
        pack_bf16(m(cb10.x, ci1, cj0.x, dj0.x, j0 <= i1),
                  m(cb10.y, ci1, cj0.y, dj0.y, j0 + 1 <= i1)),
        pack_bf16(m(cb01.x, ci0, cj1.x, dj1.x, j0 + 8 <= i0),
                  m(cb01.y, ci0, cj1.y, dj1.y, j0 + 9 <= i0)),
        pack_bf16(m(cb11.x, ci1, cj1.x, dj1.x, j0 + 8 <= i1),
                  m(cb11.y, ci1, cj1.y, dj1.y, j0 + 9 <= i1))};
    const uint8_t* q = xt + (16 * kb + lr) * s.xb + lc * 2;
#pragma unroll
    for (int pr = 0; pr < kMaxPairs; ++pr) {
      if (pr < n_pairs) {
        uint32_t bx[4];
        ldmatrix_x4_trans(bx, q + 32 * pr);
        const uint32_t b0[2] = {bx[0], bx[1]}, b1[2] = {bx[2], bx[3]};
        mma_bf16(acc[pr][0], a, b0);
        mma_bf16(acc[pr][1], a, b1);
      }
    }
  }
  // y = acc + D x, in f32 before the cast.
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(p.y);
#pragma unroll
  for (int pr = 0; pr < kMaxPairs; ++pr) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 16 * pr + 8 * e + 2 * t4;
      if (pr < n_pairs && col < p.TP && p0 + col < p.P) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? i1 : i0, l = l0 + i;
          if (i < p.Q && l < p.L) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xt + i * s.xb +
                                                         2 * col));
            *reinterpret_cast<__nv_bfloat162*>(
                yb + (static_cast<size_t>(b) * p.L + l) * p.H * p.P +
                static_cast<size_t>(h) * p.P + p0 + col) =
                __floats2bfloat162_rn(
                    acc[pr][e][2 * half] + d_skip * xv.x,
                    acc[pr][e][2 * half + 1] + d_skip * xv.y);
          }
        }
      }
    }
  }
}

// One warp's share of a head's state B^T (w o x) (high + low parts):
// state rows 16 nm .. 16 nm + 15, every column of the P tile, into dst
// (N x P, f32). The A fragment of B^T serves every 16 columns.
__device__ __forceinline__ void state_task(const Params& p, const MmaSmem& s,
                                           const uint8_t* sB,
                                           const uint8_t* sU, int Qp, int nm,
                                           int p0, float* dst) {
  const int lane = threadIdx.x & 31, g4 = lane >> 2, t4 = lane & 3;
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  const int br = (lane & 7) + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
  const int n_pairs = (p.TP + 15) / 16;
  // The high and the low parts in accumulators of their own: independent
  // chains of products.
  float acc[kMaxPairs][2][4] = {}, lo[kMaxPairs][2][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < Qp / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4_trans(a, sB + (16 * ks + br) * s.nb + (16 * nm + bc) * 2);
    const uint8_t* q = sU + (16 * ks + lr) * s.xb + lc * 2;
#pragma unroll
    for (int pr = 0; pr < kMaxPairs; ++pr)
      if (pr < n_pairs) hi_lo_product(acc[pr], lo[pr], a, q + 32 * pr, s.plane);
  }
  const int r0 = 16 * nm + g4;
#pragma unroll
  for (int pr = 0; pr < kMaxPairs; ++pr) {
    sum_into(acc[pr], lo[pr]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 16 * pr + 8 * e + 2 * t4;
      if (pr < n_pairs && col < p.TP && p0 + col < p.P) {
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r0) * p.P + p0 +
                                   col) =
            make_float2(acc[pr][e][0], acc[pr][e][1]);
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r0 + 8) * p.P +
                                   p0 + col) =
            make_float2(acc[pr][e][2], acc[pr][e][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_mma_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  using bf16 = __nv_bfloat16;
  const int Qp = (p.Q + 15) & ~15;
  const MmaSmem s(p.mode, Qp, p.N, p.TP, p.G);
  uint8_t* sB = smem + s.b;
  uint8_t* sC = smem + s.c;
  uint8_t* sX = smem + s.x;
  uint8_t* sU = smem + s.u;
  float* sCB = reinterpret_cast<float*>(smem + s.cb);
  float* scum = reinterpret_cast<float*>(smem + s.f);
  float* sdt = scum + p.G * Qp;
  float* sw = sdt + p.G * Qp;
  float* sD = reinterpret_cast<float*>(smem + s.d);

  const int n_pt = (p.P + p.TP - 1) / p.TP;
  const int hg = blockIdx.x / n_pt, pt = blockIdx.x - hg * n_pt;
  const int h0 = hg * p.G, p0 = pt * p.TP;
  const int G = min(p.G, p.H - h0);
  const int c = blockIdx.y, b = blockIdx.z, l0 = c * p.Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool do_y = p.mode != kChunkState, do_state = p.mode != kChunkOut;
  const bool with_h = p.mode == kChunkOut && c > 0;
  if (p.mode != kOneChunk) pdl_launch_dependents();

  // Stage B, C (y) and the heads' x tiles: 16-byte copies, rows past the
  // chunk or past L (and columns past P) zero-filled.
  {
    const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.b_sb;
    const bf16* cg = static_cast<const bf16*>(p.Cm) + b * p.c_sb;
    const int ncn = p.N / 8;
    for (int i = tid; i < Qp * ncn; i += kThreads) {
      const int r = i / ncn, k = i - r * ncn, l = l0 + r;
      const bool ok = r < p.Q && l < p.L;
      const long long row = ok ? l : 0;
      cp_async16(sB + r * s.nb + 16 * k, bg + row * p.b_sl + 8 * k,
                 ok ? 16 : 0);
      if (do_y)
        cp_async16(sC + r * s.nb + 16 * k, cg + row * p.c_sl + 8 * k,
                   ok ? 16 : 0);
    }
    const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb +
                     static_cast<long long>(h0) * p.P + p0;
    const int ncx = p.TP / 8, per_head = Qp * ncx;
    for (int i = tid; i < G * per_head; i += kThreads) {
      const int g = i / per_head, rem = i - g * per_head;
      const int r = rem / ncx, k = rem - r * ncx, l = l0 + r;
      const bool ok = r < p.Q && l < p.L && p0 + 8 * k < p.P;
      const bf16* src =
          xg + static_cast<long long>(g) * p.P +
          (ok ? static_cast<long long>(l) * p.x_sl + 8 * k : 0);
      cp_async16(sX + (g * Qp + r) * s.xb + 16 * k, src, ok ? 16 : 0);
    }
    cp_async_commit();
  }
  // Warp g scans head h0 + g.
  if (warp < G) {
    const float last = chunk_cumsum(
        p.dt + static_cast<size_t>(b) * p.L * p.H + h0 + warp, p.H,
        p.A[h0 + warp], l0, p.Q, p.L, Qp, scum + warp * Qp,
        sdt + warp * Qp, sw + warp * Qp);
    if (lane == 0) {
      sD[warp] = p.D[h0 + warp];
      if (p.mode == kChunkState)
        p.ws_cum[(static_cast<size_t>(b) * p.nc + c) * p.H + h0 + warp] =
            last;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // C B^T once for the block's heads: warps take its lower-triangle
  // 16 x 16 blocks (mi, kb <= mi) in turn.
  const int n_mt = Qp / 16;
  if (do_y) {
    const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
    const int br = (lane & 7) + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
    for (int t = warp; t < n_mt * (n_mt + 1) / 2; t += kWarps) {
      int mi = 0;
      while ((mi + 1) * (mi + 2) / 2 <= t) ++mi;
      const int kb = t - mi * (mi + 1) / 2;
      // Even and odd 16-column steps of N in accumulators of their own.
      float acc[2][4] = {}, odd[2][4] = {};
      auto step = [&](float (&c)[2][4], int ks) {
        uint32_t a[4], r[4];
        ldmatrix_x4(a, sC + (16 * mi + lr) * s.nb + (16 * ks + lc) * 2);
        ldmatrix_x4(r, sB + (16 * kb + br) * s.nb + (16 * ks + bc) * 2);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(c[0], a, b0);
        mma_bf16(c[1], a, b1);
      };
      const int nks = p.N / 16;
      for (int ks = 0; ks + 1 < nks; ks += 2) {
        step(acc, ks);
        step(odd, ks + 1);
      }
      if (nks & 1) step(acc, nks - 1);
      sum_into(acc, odd);
      float* r0 = sCB + (16 * mi + (lane >> 2)) * s.cbp + 16 * kb +
                  2 * (lane & 3);
      float* r1 = r0 + 8 * s.cbp;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        *reinterpret_cast<float2*>(r0 + 8 * e) =
            make_float2(acc[e][0], acc[e][1]);
        *reinterpret_cast<float2*>(r1 + 8 * e) =
            make_float2(acc[e][2], acc[e][3]);
      }
    }
  }

  if (with_h) pdl_wait();   // pass (2) has written h_c

  const int n_y = do_y ? n_mt : 0;
  const int n_s = do_state ? p.N / 16 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = h0 + g;
    const uint8_t* xt = sX + g * Qp * s.xb;
    if (do_state) {
      // w o x, split into bf16 high and low parts.
      const int pairs = p.TP / 2;
      for (int i = tid; i < Qp * pairs; i += kThreads) {
        const int r = i / pairs, k = i - r * pairs;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xt + r * s.xb + 4 * k));
        const float w = sw[g * Qp + r];
        const float v0 = xv.x * w, v1 = xv.y * w;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(sU + r * s.xb + 4 * k) = hi;
        *reinterpret_cast<__nv_bfloat162*>(sU + s.plane + r * s.xb + 4 * k) =
            __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
      }
    }
    if (with_h) {
      // h_c (N x TP, f32), split into bf16 high and low parts.
      const float* hc = p.ws +
                        ((static_cast<size_t>(b) * p.nc + c) * p.H + h) *
                            p.N * p.P + p0;
      const int quads = p.TP / 4;
#pragma unroll 4
      for (int i = tid; i < p.N * quads; i += kThreads) {
        const int n = i / quads, k = i - n * quads;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p0 + 4 * k < p.P)
          v = *reinterpret_cast<const float4*>(
              hc + static_cast<size_t>(n) * p.P + 4 * k);
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
        const float2 f01 = __bfloat1622float2(h01);
        const float2 f23 = __bfloat1622float2(h23);
        __nv_bfloat162* hi =
            reinterpret_cast<__nv_bfloat162*>(sU + n * s.xb + 8 * k);
        __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(
            sU + s.plane + n * s.xb + 8 * k);
        hi[0] = h01;
        hi[1] = h23;
        lo[0] = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
        lo[1] = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
      }
    }
    __syncthreads();   // sU (and C B^T, at the first head) is in place

    // The head's tasks: the row tiles of y, then the 16-row tiles of the
    // state, dealt to the warps in turn.
    float* dst = p.mode == kOneChunk
                     ? p.h_out + (static_cast<size_t>(b) * p.H + h) *
                                     p.N * p.P
                     : p.ws + ((static_cast<size_t>(b) * p.nc + c) * p.H +
                               h) * p.N * p.P;
    for (int t = warp; t < n_y + n_s; t += kWarps) {
      if (t < n_y)
        y_task(p, s, sC, sCB, xt, sU, scum + g * Qp, sdt + g * Qp, sD[g],
               with_h, t, b, h, l0, p0);
      else
        state_task(p, s, sB, sU, Qp, t - n_y, p0, dst);
    }
    __syncthreads();   // sU is free for the next head
  }
}

// ---- the FP32-FMA kernel (f32, and bf16 off the tensor cores) ----

// f32 shared memory of the FMA kernel: B and C (Q x (N + 1)), M (Q x
// (Q + 1)), x (Q x 16), h_c (N x 16), and cum, dt, w (Q each).
__host__ __device__ inline size_t fma_smem_bytes(int Q, int N) {
  return sizeof(float) *
         (2 * static_cast<size_t>(Q) * (N + 1) +
          static_cast<size_t>(Q) * (Q + 1) +
          static_cast<size_t>(Q) * kFmaTP + static_cast<size_t>(N) * kFmaTP +
          3 * static_cast<size_t>(Q));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_fma_kernel(const Params p) {
  extern __shared__ float fsm[];
  const int Q = p.Q, N = p.N, P = p.P;
  const int ldn = N + 1, ldq = Q + 1;
  float* sB = fsm;                  // Q x ldn
  float* sC = sB + Q * ldn;         // Q x ldn
  float* sM = sC + Q * ldn;         // Q x ldq
  float* sx = sM + Q * ldq;         // Q x kFmaTP
  float* sh = sx + Q * kFmaTP;      // N x kFmaTP: h_c
  float* scum = sh + N * kFmaTP;    // Q
  float* sdt = scum + Q;            // Q
  float* sw = sdt + Q;              // Q

  const int n_pt = (P + kFmaTP - 1) / kFmaTP;
  const int h = blockIdx.x / n_pt, p0 = (blockIdx.x - h * n_pt) * kFmaTP;
  const int c = blockIdx.y, b = blockIdx.z, l0 = c * Q;
  const int tid = threadIdx.x;
  const bool do_y = p.mode != kChunkState, do_state = p.mode != kChunkOut;
  const bool with_h = p.mode == kChunkOut && c > 0;
  if (p.mode != kOneChunk) pdl_launch_dependents();

  const T* xb = static_cast<const T*>(p.x) + b * p.x_sb +
                static_cast<long long>(h) * P + p0;
  const T* bb = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* cb = static_cast<const T*>(p.Cm) + b * p.c_sb;
  for (int i = tid; i < Q * N; i += kThreads) {
    const int r = i / N, n = i - r * N, l = l0 + r;
    const bool in = l < p.L;
    sB[r * ldn + n] = in ? attn::to_f32(bb[l * p.b_sl + n]) : 0.f;
    if (do_y) sC[r * ldn + n] = in ? attn::to_f32(cb[l * p.c_sl + n]) : 0.f;
  }
  for (int i = tid; i < Q * kFmaTP; i += kThreads) {
    const int r = i / kFmaTP, k = i - r * kFmaTP, l = l0 + r;
    sx[i] = (l < p.L && p0 + k < P) ? attn::to_f32(xb[l * p.x_sl + k]) : 0.f;
  }
  if (tid < 32) {
    const float last = chunk_cumsum(
        p.dt + static_cast<size_t>(b) * p.L * p.H + h, p.H, p.A[h], l0, Q,
        p.L, Q, scum, sdt, sw);
    if (p.mode == kChunkState && tid == 0)
      p.ws_cum[(static_cast<size_t>(b) * p.nc + c) * p.H + h] = last;
  }
  __syncthreads();

  if (do_y) {
    // M[i][j] = (C_i . B_j) e^{cum_i - cum_j} dt_j for j <= i, else 0.
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q, j = e - i * Q;
      float v = 0.f;
      if (j <= i) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n)
          dot = fmaf(sC[i * ldn + n], sB[j * ldn + n], dot);
        v = dot * expf(scum[i] - scum[j]) * sdt[j];
      }
      sM[i * ldq + j] = v;
    }
    if (with_h) {
      pdl_wait();   // pass (2) has written h_c
      const float* hc = p.ws +
                        ((static_cast<size_t>(b) * p.nc + c) * p.H + h) * N *
                            P + p0;
      for (int i = tid; i < N * kFmaTP; i += kThreads) {
        const int n = i / kFmaTP, k = i - n * kFmaTP;
        sh[i] = p0 + k < P ? hc[static_cast<size_t>(n) * P + k] : 0.f;
      }
    }
    __syncthreads();
    // y = M x + e^{cum} C h_c + D x for column p0 + k of row i.
    const float d_skip = p.D[h];
    T* y = static_cast<T*>(p.y);
    for (int e = tid; e < Q * kFmaTP; e += kThreads) {
      const int i = e / kFmaTP, k = e - i * kFmaTP, l = l0 + i;
      if (l >= p.L || p0 + k >= P) continue;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j)
        acc = fmaf(sM[i * ldq + j], sx[j * kFmaTP + k], acc);
      if (with_h) {
        float ch = 0.f;
        for (int n = 0; n < N; ++n)
          ch = fmaf(sC[i * ldn + n], sh[n * kFmaTP + k], ch);
        acc = fmaf(ch, expf(scum[i]), acc);
      }
      y[(static_cast<size_t>(b) * p.L + l) * p.H * P +
        static_cast<size_t>(h) * P + p0 + k] =
          attn::from_f32<T>(acc + d_skip * sx[i * kFmaTP + k]);
    }
  }
  if (do_state) {
    // The state B^T (w o x) over the chunk's rows.
    float* dst = p.mode == kOneChunk
                     ? p.h_out + (static_cast<size_t>(b) * p.H + h) * N * P
                     : p.ws + ((static_cast<size_t>(b) * p.nc + c) * p.H +
                               h) * N * P;
    for (int e = tid; e < N * kFmaTP; e += kThreads) {
      const int n = e / kFmaTP, k = e - n * kFmaTP;
      if (p0 + k >= P) continue;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j)
        acc = fmaf(sB[j * ldn + n], sw[j] * sx[j * kFmaTP + k], acc);
      dst[static_cast<size_t>(n) * P + p0 + k] = acc;
    }
  }
}

// ---- pass (2): the serial state pass over the chunks ----

constexpr int kPassThreads = 128;
constexpr int kPassPer = 4;       // state elements a thread
constexpr int kPassBatch = 8;     // chunks whose loads are in flight at once

// Grid (N P / (kPassThreads kPassPer), H, B). Each thread carries kPassPer
// elements of one (b, h)'s state: h_c = e^{cum_Q,c-1} h_{c-1} + S_{c-1},
// written over S_c (c >= 1; chunk 0 enters with h = 0), then the final h.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ ws, const float* __restrict__ cumq,
                      float* __restrict__ h_out, int H, int NP, int nc) {
  pdl_launch_dependents();
  const int h = blockIdx.y, b = blockIdx.z;
  const int e0 = blockIdx.x * kPassThreads * kPassPer + threadIdx.x;
  float st[kPassPer];
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) st[k] = 0.f;
  pdl_wait();   // pass (1) has written S_c and cum_Q
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float sc[kPassBatch][kPassPer], dec[kPassBatch];
#pragma unroll
    for (int cc = 0; cc < kPassBatch; ++cc) {
      const int c = c0 + cc;
      if (c < nc) {
        const size_t slot = (static_cast<size_t>(b) * nc + c) * H + h;
        dec[cc] = expf(cumq[slot]);
#pragma unroll
        for (int k = 0; k < kPassPer; ++k) {
          const int e = e0 + k * kPassThreads;
          sc[cc][k] = e < NP ? ws[slot * NP + e] : 0.f;
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < kPassBatch; ++cc) {
      const int c = c0 + cc;
      if (c < nc) {
        const size_t slot = (static_cast<size_t>(b) * nc + c) * H + h;
#pragma unroll
        for (int k = 0; k < kPassPer; ++k) {
          const int e = e0 + k * kPassThreads;
          if (e < NP) {
            if (c > 0) ws[slot * NP + e] = st[k];
            st[k] = fmaf(dec[cc], st[k], sc[cc][k]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) {
    const int e = e0 + k * kPassThreads;
    if (e < NP) h_out[(static_cast<size_t>(b) * H + h) * NP + e] = st[k];
  }
}

// ---- launches ----

// Launches `kernel` on (grid, threads, smem); chained to the previous
// launch of the stream by programmatic dependent launch when `pdl`.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
           bool pdl, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

// The largest dynamic shared memory a block may opt into, set once on
// each chunk kernel.
int opt_in_smem() {
  static const int bytes = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      return -1;
    const auto a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    if (cudaFuncSetAttribute(ssd_chunk_mma_kernel, a, v) != cudaSuccess ||
        cudaFuncSetAttribute(ssd_chunk_fma_kernel<float>, a, v) !=
            cudaSuccess ||
        cudaFuncSetAttribute(ssd_chunk_fma_kernel<__nv_bfloat16>, a, v) !=
            cudaSuccess)
      return -1;
    return v;
  }();
  return bytes;
}

int run(Params p, int B, int route, int dtype, cudaStream_t st) {
  const int limit = opt_in_smem();
  if (limit < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool chunked = p.nc > 1;
  const dim3 pass_grid((p.N * p.P + kPassThreads * kPassPer - 1) /
                           (kPassThreads * kPassPer),
                       p.H, B);
  int err = 0;
  if (route == kRouteFma) {
    const size_t smem = fma_smem_bytes(p.Q, p.N);
    if (smem > static_cast<size_t>(limit))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = dtype == attn::kBF16 ? ssd_chunk_fma_kernel<__nv_bfloat16>
                                       : ssd_chunk_fma_kernel<float>;
    const dim3 grid(((p.P + kFmaTP - 1) / kFmaTP) * p.H, p.nc, B);
    p.mode = chunked ? kChunkState : kOneChunk;
    err = launch(kernel, grid, kThreads, smem, false, st, p);
    if (err || !chunked) return err;
    err = launch(ssd_state_pass_kernel, pass_grid, kPassThreads, 0, true, st,
                 p.ws, static_cast<const float*>(p.ws_cum), p.h_out, p.H,
                 p.N * p.P, p.nc);
    if (err) return err;
    p.mode = kChunkOut;
    return launch(kernel, grid, kThreads, smem, true, st, p);
  }
  const int Qp = (p.Q + 15) & ~15;
  const dim3 grid(((p.H + p.G - 1) / p.G) * ((p.P + p.TP - 1) / p.TP),
                  p.nc, B);
  p.mode = chunked ? kChunkState : kOneChunk;
  if (MmaSmem(p.mode, Qp, p.N, p.TP, p.G).bytes > limit ||
      (chunked && MmaSmem(kChunkOut, Qp, p.N, p.TP, p.G).bytes > limit))
    return static_cast<int>(cudaErrorInvalidValue);
  err = launch(ssd_chunk_mma_kernel, grid, kThreads,
               MmaSmem(p.mode, Qp, p.N, p.TP, p.G).bytes, false, st, p);
  if (err || !chunked) return err;
  err = launch(ssd_state_pass_kernel, pass_grid, kPassThreads, 0, true, st,
               p.ws, static_cast<const float*>(p.ws_cum), p.h_out, p.H,
               p.N * p.P, p.nc);
  if (err) return err;
  p.mode = kChunkOut;
  return launch(ssd_chunk_mma_kernel, grid, kThreads,
                MmaSmem(p.mode, Qp, p.N, p.TP, p.G).bytes, true, st, p);
}

}  // namespace

// route: 0 one_chunk, 1 chunked (bf16 on the tensor cores), 2 fma.
// heads_per_block and p_tile are the tensor-core routes' G and TP. ws
// (B, nc, H, N, P) and ws_cum (B, nc, H) are f32 workspaces, used when
// L > Q (nc > 1).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               void* y, void* h, void* ws, void* ws_cum,
                               int B, int L, int H, int P, int N, int Q,
                               long long x_sb, long long x_sl,
                               long long b_sb, long long b_sl,
                               long long c_sb, long long c_sl, int dtype,
                               int route, int heads_per_block, int p_tile,
                               void* stream) {
  if (B == 0 || H == 0 || P == 0 || L == 0) return 0;
  const int nc = (L + Q - 1) / Q;
  const bool tc = route == kRouteOneChunk || route == kRouteChunked;
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || route < 0 || route > 2 ||
      (nc > 1 && (ws == nullptr || ws_cum == nullptr)) ||
      (route == kRouteOneChunk && nc != 1) ||
      (route == kRouteChunked && nc == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc && (dtype != attn::kBF16 || N % 16 || P % 8 || p_tile % 8 ||
             p_tile < 8 || p_tile > kMaxTP || heads_per_block < 1 ||
             heads_per_block > kMaxG))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.Cm = Cm;
  p.D = static_cast<const float*>(D);
  p.y = y;
  p.h_out = static_cast<float*>(h);
  p.ws = static_cast<float*>(ws);
  p.ws_cum = static_cast<float*>(ws_cum);
  p.L = L;
  p.H = H;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.nc = nc;
  p.G = tc ? heads_per_block : 1;
  p.TP = tc ? p_tile : kFmaTP;
  p.mode = kOneChunk;
  p.x_sb = x_sb;
  p.x_sl = x_sl;
  p.b_sb = b_sb;
  p.b_sl = b_sl;
  p.c_sb = c_sb;
  p.c_sl = c_sl;
  const int err = run(p, B, route, dtype, static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
