// Mamba2 SSD chunked scan with a carried (N, P) state.
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
// What bounds it on the H100: per (b, chunk) the (Q x Q) product C B^T
// (lower triangle), and per head the masked (Q x Q) . (Q x P) product and
// the (Q x N) . (N x P) products of the state (C h only after the first
// chunk); at the served shape (L = Q = 128, H = 32, P = 64, N = 128)
// ~103 MFLOP against ~2.2 MB moved, so operations bound it: ~1.5 us at
// the 67 TFLOP/s FP32 rate. This kernel does all of it as FP32 FMAs from
// shared memory and recomputes C B^T in every block, so it sits well
// below that.
//
// Design: the TPU grid (B*H, chunks) ran the chunk axis in order and kept
// the state in VMEM scratch. Here the P columns are independent given the
// chunk's cumulants and C B^T, so one block owns a 16-column slice of one
// (b, h)'s state and loops over the chunks itself: grid (P / 16, H, B),
// 128 blocks at the served shape. Each block recomputes cum and the masked
// (Q x Q) matrix M = (C B^T) o L o dt, which costs Q^2 N FMAs against the
// Q (Q + 2N) * 16 of its own columns. x (B, L, H, P), dt (B, L, H) and B / C
// (B, L, N) are read in the model's layout through strides (B / C may be
// views of one projection), with no per-head repeat and no padding: rows
// past L read as dt = x = B = C = 0, which is what the TPU op's zero
// padding gives (no decay, no input). The decay e^{cum_i - cum_j} is
// computed only where j <= i (above the diagonal the exponent is positive
// and could overflow; it is selected away, never multiplied by 0). The D
// skip is added in f32 before the cast of y. Shared memory holds B, C and
// M in f32 (216,064 bytes at Q = N = 128: dynamic, opt-in set once).
#include "attention_common.cuh"

namespace {

constexpr int kMaxQ = 128;       // largest chunk
constexpr int kMaxN = 128;       // largest state size
constexpr int kTP = 16;          // head-dim columns per block
constexpr int kThreads = 256;    // 16 x 16
constexpr int kR = kMaxQ / 16;   // rows (or state rows) per thread

size_t smem_bytes(int Q, int N) {
  return sizeof(float) *
         (2 * static_cast<size_t>(Q) * (N + 1) +
          static_cast<size_t>(Q) * (Q + 1) + static_cast<size_t>(N) * kTP +
          static_cast<size_t>(Q) * kTP + 3 * static_cast<size_t>(Q));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x,       // (B, L, H, P), rows x_sl apart
           const float* __restrict__ dt,  // (B, L, H)
           const float* __restrict__ A,   // (H,)
           const T* __restrict__ Bm,      // (B, L, N), rows b_sl apart
           const T* __restrict__ Cm,      // (B, L, N), rows c_sl apart
           const float* __restrict__ D,   // (H,)
           T* __restrict__ y,             // (B, L, H, P)
           float* __restrict__ h_out,     // (B, H, N, P)
           int L, int H, int P, int N, int Q, long long x_sb,
           long long x_sl, long long b_sb, long long b_sl, long long c_sb,
           long long c_sl) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldq = Q + 1;    // padded rows: no bank conflicts
  float* sB = smem;                      // Q x ldn
  float* sC = sB + Q * ldn;              // Q x ldn
  float* sM = sC + Q * ldn;              // Q x ldq
  float* sh = sM + Q * ldq;              // N x kTP: the carried state
  float* sx = sh + N * kTP;              // Q x kTP
  float* scum = sx + Q * kTP;            // Q: inclusive cumsum of dt A
  float* sdt = scum + Q;                 // Q: dt
  float* sw = sdt + Q;                   // Q: e^{cum_last - cum_j} dt_j

  const int p0 = blockIdx.x * kTP, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float a = A[h], d_skip = D[h];
  const T* xb = x + b * x_sb + static_cast<long long>(h) * P + p0;
  const T* bb = Bm + b * b_sb;
  const T* cb = Cm + b * c_sb;
  const float* dtb = dt + static_cast<size_t>(b) * L * H + h;

  for (int i = tid; i < N * kTP; i += kThreads) sh[i] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();   // the previous chunk's reads of every tile are done
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N, n = i - r * N, l = l0 + r;
      const bool in = l < L;
      sB[r * ldn + n] = in ? attn::to_f32(bb[l * b_sl + n]) : 0.f;
      sC[r * ldn + n] = in ? attn::to_f32(cb[l * c_sl + n]) : 0.f;
    }
    for (int i = tid; i < Q * kTP; i += kThreads) {
      const int r = i / kTP, c = i - r * kTP, l = l0 + r;
      sx[i] = (l < L && p0 + c < P) ? attn::to_f32(xb[l * x_sl + c]) : 0.f;
    }
    if (tid < 32) {
      // Warp 0: lane t sums rows 4t..4t+3 in order, then a warp scan of
      // the lane sums gives the inclusive cumsum of dt A over the chunk.
      float part[kMaxQ / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxQ / 32; ++k) {
        const int r = tid * (kMaxQ / 32) + k, l = l0 + r;
        const float d = (r < Q && l < L) ? dtb[static_cast<size_t>(l) * H]
                                         : 0.f;
        if (r < Q) sdt[r] = d;
        run += d * a;
        part[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxQ / 32; ++k) {
        const int r = tid * (kMaxQ / 32) + k;
        if (r < Q) scum[r] = excl + part[k];
      }
    }
    __syncthreads();
    if (tid < Q) sw[tid] = expf(scum[Q - 1] - scum[tid]) * sdt[tid];

    // M[i][j] = (C_i . B_j) e^{cum_i - cum_j} dt_j for j <= i, else 0.
    // Thread (ty, tx) owns rows ty + 16 r and columns tx + 16 c.
    {
      float acc[kR][kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kR; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kR], bv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = ty + 16 * r, j = tx + 16 * r;
          cv[r] = i < Q ? sC[i * ldn + n] : 0.f;
          bv[r] = j < Q ? sB[j * ldn + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kR; ++c)
            acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + 16 * r;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          const int j = tx + 16 * c;
          if (j >= Q) continue;
          sM[i * ldq + j] =
              j <= i ? acc[r][c] * expf(scum[i] - scum[j]) * sdt[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M x + e^{cum} (C h) + D x for column p0 + tx, rows ty + 16 r.
    {
      float acc[kR], acc_h[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = acc_h[r] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float xv = sx[j * kTP + tx];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = ty + 16 * r;
          if (i < Q) acc[r] = fmaf(sM[i * ldq + j], xv, acc[r]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float hv = sh[n * kTP + tx];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = ty + 16 * r;
          if (i < Q) acc_h[r] = fmaf(sC[i * ldn + n], hv, acc_h[r]);
        }
      }
      const int p = p0 + tx;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + 16 * r, l = l0 + i;
        if (i < Q && l < L && p < P) {
          const float v = acc[r] + acc_h[r] * expf(scum[i]) +
                          d_skip * sx[i * kTP + tx];
          y[(static_cast<size_t>(b) * L + l) * H * P +
            static_cast<size_t>(h) * P + p] = attn::from_f32<T>(v);
        }
      }
    }
    __syncthreads();   // every read of the state is done before it moves

    // h <- e^{cum_last} h + B^T (w o x), state rows ty + 16 r, column tx.
    {
      const float decay = expf(scum[Q - 1]);
      float acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int n = ty + 16 * r;
        acc[r] = n < N ? sh[n * kTP + tx] * decay : 0.f;
      }
      for (int j = 0; j < Q; ++j) {
        const float wx = sx[j * kTP + tx] * sw[j];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int n = ty + 16 * r;
          if (n < N) acc[r] = fmaf(sB[j * ldn + n], wx, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int n = ty + 16 * r;
        if (n < N) sh[n * kTP + tx] = acc[r];
      }
    }
  }
  __syncthreads();

  float* hb = h_out + (static_cast<size_t>(b) * H + h) * N * P + p0;
  for (int i = tid; i < N * kTP; i += kThreads) {
    const int n = i / kTP, c = i - n * kTP;
    if (p0 + c < P) hb[static_cast<size_t>(n) * P + c] = sh[i];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* h, int B, int L,
           int H, int P, int N, int Q, long long x_sb, long long x_sl,
           long long b_sb, long long b_sl, long long c_sb, long long c_sl,
           cudaStream_t stream) {
  // The attribute is set once per instantiation, at the largest Q and N.
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxQ, kMaxN)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((P + kTP - 1) / kTP, H, B);
  ssd_kernel<T><<<grid, kThreads, smem_bytes(Q, N), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(h), L, H, P, N, Q, x_sb, x_sl,
      b_sb, b_sl, c_sb, c_sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               void* y, void* h, int B, int L, int H, int P,
                               int N, int Q, long long x_sb, long long x_sl,
                               long long b_sb, long long b_sl,
                               long long c_sb, long long c_sl, int dtype,
                               void* stream) {
  if (B == 0 || H == 0 || P == 0) return 0;
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == attn::kBF16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, h, B, L, H, P, N, Q,
                                 x_sb, x_sl, b_sb, b_sl, c_sb, c_sl, st);
  return launch<float>(x, dt, A, Bm, Cm, D, y, h, B, L, H, P, N, Q, x_sb,
                       x_sl, b_sb, b_sl, c_sb, c_sl, st);
}
