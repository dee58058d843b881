// Decode attention: one query token of every query head against the KV
// ring buffer, with an online softmax over kv tiles.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::_decode_kernel,
// the Pallas TPU kernel behind decode_attention_bkv / ops.decode_attention.
//
// What it computes: for batch row b and query head h = kvh * G + g,
// softmax_w(scale * q . k_w masked) . v_w over the W cache slots, where
// the (W,) validity vector masks slots that are unwritten, wrapped or
// outside the sliding window (the model computes it from the position).
// Masked scores are -1e30 (finite), the running max starts at -1e30 and
// the final division floors the denominator at 1e-30, as on the TPU.
//
// What bounds it on the H100: bytes. The whole cache, 2 * B * W * KV * hd
// elements, streams through once per token for 4 * B * H * W * hd
// operations: one to eight operations per byte, far below the card's
// ~295 bf16 operations per byte. The bound is the cache over 3.35 TB/s.
//
// Design: as on the TPU, one block keeps the G query heads of one kv head
// together, so each K/V element read from device memory serves G heads,
// and walks the W slots in tiles of 64, with (m, l) per head in shared
// memory and the output accumulators in registers. Grid: B * KV blocks.
// At B = 1 that is 8-32 blocks on 132 SMs, so a single token cannot reach
// the bandwidth bound; a split over W with a second combining pass is the
// later redesign. The kernel reads the cache in its (B, W, KV, hd) layout
// through strides and masks the ragged last tile itself (the TPU op padded
// hd to 128 and W to its block). Arithmetic is FP32 FMAs from shared
// memory; P stays f32 for P.V.
#include <cstdint>

#include "attention_common.cuh"

namespace {

constexpr int kBK = 64;          // cache slots per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;        // output elements per thread
constexpr int kMaxOut = kSlots * kThreads;  // G * hd <= 2048
constexpr int kMaxG = 64;

size_t smem_bytes(int G, int hd) {
  const int ld = hd + 1;
  return sizeof(float) * (static_cast<size_t>(G + 2 * kBK) * ld +
                          static_cast<size_t>(G) * kBK + 3 * G);
}

// An upper bound of smem_bytes over G <= kMaxG, hd <= kMaxHd and
// G * hd <= kMaxOut: (G + 2 kBK)(hd + 1) <= kMaxOut + G + 2 kBK (kMaxHd + 1).
size_t max_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kMaxOut) + kMaxG +
          static_cast<size_t>(2 * kBK) * (attn::kMaxHd + 1) +
          static_cast<size_t>(kMaxG) * kBK + 3 * kMaxG);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q,            // (B, KV, G, hd)
              const T* __restrict__ k,            // (B, W, KV, hd)
              const T* __restrict__ v,            // (B, W, KV, hd)
              const uint8_t* __restrict__ valid,  // (W,)
              T* __restrict__ o,                  // (B, KV, G, hd)
              int W, int KV, int G, int hd, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sq = smem;                 // G x ld
  float* sk = sq + G * ld;          // kBK x ld
  float* sv = sk + kBK * ld;        // kBK x ld
  float* sp = sv + kBK * ld;        // G x kBK
  float* sm = sp + G * kBK;         // (G,) running max
  float* sl = sm + G;               // (G,) running sum
  float* sc = sl + G;               // (G,) this tile's correction
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int n_out = G * hd;

  const size_t head0 = (static_cast<size_t>(b) * KV + kvh) * G * hd;
  attn::load_rows(q + head0, static_cast<size_t>(hd), 0, G, G, hd, ld, sq);
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = attn::kNegInf;
    sl[g] = 0.f;
  }
  const size_t stride = static_cast<size_t>(KV) * hd;
  const size_t base = static_cast<size_t>(b) * W * stride +
                      static_cast<size_t>(kvh) * hd;

  float acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.f;

  for (int w0 = 0; w0 < W; w0 += kBK) {
    __syncthreads();   // the previous tile's reads are done
    attn::load_rows(k + base, stride, w0, kBK, W, hd, ld, sk);
    attn::load_rows(v + base, stride, w0, kBK, W, hd, ld, sv);
    __syncthreads();

    for (int e = tid; e < G * kBK; e += kThreads) {
      const int g = e / kBK, c = e - g * kBK;
      const int w = w0 + c;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(sq[g * ld + d], sk[c * ld + d], s);
      sp[e] = (w < W && valid[w]) ? s * scale : attn::kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      const float a = sp[g * kBK + lane], c = sp[g * kBK + lane + 32];
      const float m_prev = sm[g];
      const float m_new = fmaxf(m_prev, attn::group_max<32>(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      sp[g * kBK + lane] = pa;
      sp[g * kBK + lane + 32] = pc;
      const float sum = attn::group_sum<32>(pa + pc);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sc[g] = corr;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = tid + s * kThreads;
      if (e < n_out) {
        const int g = e / hd, d = e - g * hd;
        float a = acc[s] * sc[g];
        for (int c = 0; c < kBK; ++c)
          a = fmaf(sp[g * kBK + c], sv[c * ld + d], a);
        acc[s] = a;
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = tid + s * kThreads;
    if (e < n_out)
      o[head0 + e] =
          attn::from_f32<T>(acc[s] / fmaxf(sl[e / hd], attn::kMinDenom));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* o, int B, int W, int KV, int G, int hd, float scale,
           cudaStream_t stream) {
  // Set once per instantiation, at the most any (G, hd) it takes needs.
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(max_smem_bytes()));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  decode_kernel<T><<<B * KV, kThreads, smem_bytes(G, hd), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(o), W, KV, G, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid,
                                       void* o, int B, int W, int KV, int G,
                                       int hd, float scale, int dtype,
                                       void* stream) {
  if (B == 0 || KV == 0 || G == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == attn::kBF16)
    return launch<__nv_bfloat16>(q, k, v, valid, o, B, W, KV, G, hd, scale,
                                 st);
  return launch<float>(q, k, v, valid, o, B, W, KV, G, hd, scale, st);
}
