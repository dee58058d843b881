// Prefill attention with an online softmax: causal, sliding-window or full
// masks, GQA (query head h reads kv head h / G).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::_attn_kernel, the
// Pallas TPU kernel behind flash_attention_bh / ops.flash_attention.
//
// What it computes: for each batch row b, query head h and query position
// i in [0, S), softmax_j(scale * q_i . k_j masked) . v_j over key positions
// j in [0, T), with positions 0..S-1 and 0..T-1 as the TPU op assumes. The
// mask is the TPU kernel's: causal i - j >= 0, sliding 0 <= i - j < window,
// full all j < T. Masked scores are -1e30 (finite), the running max starts
// at -1e30, and the final division floors the denominator at 1e-30.
//
// What bounds it on the H100: 4 * B * H * S * T * hd operations over the
// tiles visited (2 for QK^T, 2 for PV) against q, k, v and o moved once.
// At the path's shapes (S = 32..2048, hd = 128) attention is bound by
// operations: on the tensor cores (989 TFLOP/s bf16) a few microseconds.
// This kernel does its arithmetic as FP32 FMAs from shared memory (P stays
// f32 for P.V, as the TPU kernel keeps it; a bf16 P would not match), so it
// sits at most at the 67 TFLOP/s FP32 rate and in practice well below:
// one shared-memory load per one to four FMAs, no wgmma, no TMA, no
// double buffering. Those are a later redesign.
//
// Design: the TPU grid (B*H, query tiles, kv tiles) ran the kv axis in
// order and carried (m, l, acc) in VMEM. Here one block owns one 64-row
// query tile of one (b, h) and loops over the kv tiles itself, with the
// state in registers. Tiles wholly above the causal diagonal, and wholly
// outside the sliding window, are skipped. The kernel reads q, k, v in the
// model's own (B, S, H, hd) / (B, T, KV, hd) layouts through strides and
// masks ragged query and key tiles itself, so nothing is transposed or
// padded (the TPU op padded hd to 128 and S, T to the tile). Threads form
// a 16 x 16 grid: thread (ty, tx) owns query rows ty + 16 i (i < 4), score
// columns tx + 16 j (j < 4) and output columns tx + 16 c (c < hd / 16).
// A row's 16 owners are 16 consecutive lanes, so the row max and row sum
// are xor shuffles inside a half warp.
#include "attention_common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr int kSlots = attn::kMaxHd / 16;  // output columns per thread

enum Mode { kCausal = 0, kSliding = 1, kFull = 2 };

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * ld + kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q,   // (B, S, H, hd)
             const T* __restrict__ k,   // (B, T, KV, hd)
             const T* __restrict__ v,   // (B, T, KV, hd)
             T* __restrict__ o,         // (B, S, H, hd)
             int S, int T_len, int H, int KV, int hd, int mode, int window,
             float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;                 // padded rows: no bank conflicts
  float* sq = smem;                      // kBQ x ld
  float* sk = sq + kBQ * ld;             // kBK x ld
  float* sv = sk + kBK * ld;             // kBK x ld
  float* sp = sv + kBK * ld;             // kBQ x (kBK + 1)
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(KV) * hd;
  const T* qb = q + static_cast<size_t>(b) * S * q_stride +
                static_cast<size_t>(h) * hd;
  const T* kb = k + static_cast<size_t>(b) * T_len * kv_stride +
                static_cast<size_t>(kvh) * hd;
  const T* vb = v + static_cast<size_t>(b) * T_len * kv_stride +
                static_cast<size_t>(kvh) * hd;
  attn::load_rows(qb, q_stride, q0, kBQ, S, hd, ld, sq);

  // The kv tiles this query tile can see.
  int k_lo = 0, k_hi = T_len;
  if (mode != kFull) {
    k_hi = min(T_len, q0 + kBQ);
    if (mode == kSliding) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / kBK) * kBK;

  float m[kRows], l[kRows], acc[kRows][kSlots];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = attn::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();   // the previous tile's reads of sk / sv / sp are done
    attn::load_rows(kb, kv_stride, k0, kBK, T_len, hd, ld, sk);
    attn::load_rows(vb, kv_stride, k0, kBK, T_len, hd, ld, sv);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sq[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sk[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + 16 * i;
      float row_max = attn::kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        const int dist = qp - kp;
        bool ok = kp < T_len;
        if (mode == kCausal) ok = ok && dist >= 0;
        if (mode == kSliding) ok = ok && dist >= 0 && dist < window;
        s[i][j] = ok ? s[i][j] * scale : attn::kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      row_max = attn::group_max<16>(row_max);
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        sp[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
      }
      row_sum = attn::group_sum<16>(row_sum);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kSlots; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sp[(ty + 16 * i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        const int col = tx + 16 * c;
        if (col < hd) {
          const float vv = sv[j * ld + col];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  T* ob = o + static_cast<size_t>(b) * S * q_stride +
          static_cast<size_t>(h) * hd;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], attn::kMinDenom);
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int col = tx + 16 * c;
      if (col < hd)
        ob[static_cast<size_t>(qi) * q_stride + col] =
            attn::from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_len, int H, int KV, int hd, int mode, int window,
           float scale, cudaStream_t stream) {
  // The attribute is set once per instantiation, at the largest hd.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(attn::kMaxHd)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T><<<grid, kThreads, smem_bytes(hd), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, H, KV, hd,
      mode, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T_len, int H, int KV, int hd,
                                      int mode, int window, float scale,
                                      int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == attn::kBF16)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, T_len, H, KV, hd, mode,
                                 window, scale, st);
  return launch<float>(q, k, v, o, B, S, T_len, H, KV, hd, mode, window,
                       scale, st);
}
