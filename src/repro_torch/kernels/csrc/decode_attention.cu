// Decode attention: one query token of every query head against the KV
// ring buffer, split over the cache (two passes).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::_decode_kernel,
// the Pallas TPU kernel behind decode_attention_bkv / ops.decode_attention.
//
// What it computes: for batch row b and query head h = kvh * G + g,
// softmax_w(scale * q . k_w masked) . v_w over the W cache slots, where
// the (W,) validity vector masks slots that are unwritten, wrapped or
// outside the sliding window (the model computes it from the position).
// Masked scores are -1e30 (finite) and the final division floors the
// denominator at 1e-30, as on the TPU. A row with no valid slot at all,
// which the model never produces (the current token's slot is valid),
// gives the mean of V over the W slots of its kv head, as the TPU kernel
// does (every score is -1e30, so every p = exp(0)). Its tiles are still
// all skipped; the pass that writes the output sees no valid slot and
// averages V instead (see Pass 2).
//
// What bounds it on the H100: bytes. The valid slots' K and V stream
// through once per token for 4 * B * H * hd operations per valid slot:
// one to eight operations per byte, far below the card's ~295 bf16
// operations per byte. The bound is that cache over 3.35 TB/s, so the
// design is about bytes in flight and filling all 132 SMs.
//
// Design. Pass 1, decode_split_kernel: the grid is (n_split, KV, B). A
// block of 8 warps takes a contiguous run of 64-slot tiles for all G
// query heads of one kv head, so each K/V element read from device memory
// serves G heads. It reads the validity bytes of its first 16 tiles with
// q at the start, and skips a tile with no valid slot; the tiles it keeps
// go through a two-stage ring in shared memory in their own dtype (rows
// padded by 16 bytes so that 8 rows' 16-byte reads hit distinct banks).
// Per tile, two ways:
//   - bf16 with hd % 16 == 0, the served shapes: S = q K^T and O += P V
//     on the tensor cores (mma.sync m16n8k16, heads padded to 16-row
//     tiles, fragments by ldmatrix; V through the transposing ldmatrix;
//     K / V staged by cp.async 16-byte copies).
//     A measured FP32 version of this path spent 2-3 times the cache's
//     streaming time on instructions at G = 8 (each K/V element feeds
//     8 heads, plus its conversion and shared-memory reads), so the
//     tensor cores take the arithmetic and the kernel is left with its
//     bytes. P is rounded to bf16 once, as in flash_attention.
//   - f32, and bf16 at other hd, which no served model has: K / V copied
//     and FP32 FMAs done element by element; lane c of a warp owns slots
//     c and c + 32 and widens each element of their K rows once for all
//     the warp's heads (q in f32 in shared memory); a thread owns output
//     elements for P V.
// K / V may be of another type than q: the fp8 caches (e4m3, e5m2), with
// q in bf16 or f32. Both fp8 formats widen to bf16 and to f32 exactly, so
// the kernel on an fp8 cache gives the bits it gives on that cache cast
// to q's type, and reads half (bf16) or a quarter (f32) of its bytes. On
// the kMma path the fp8 tiles come in by the same 16-byte cp.async copies
// (an fp8 row of hd % 16 == 0 is hd bytes) into a ring of their own, and
// one pass per tile widens them into the bf16 tile that ldmatrix reads
// (cvt.rn.f16x2.e4m3x2 / e5m2x2, then f16 -> bf16). The FMA path reads
// the fp8 elements and widens each on its way to f32.
// Either way warp w keeps the online softmax of heads w, w + 8, ... in
// f32: it holds a head's 64 scores of the tile, max and sum by warp
// shuffles. The block writes its partial (m, l, acc) in f32 to a
// workspace that the wrapper allocates, or with n_split = 1 the output.
// Pass 2, decode_combine_kernel, one block per (g, kv head, b): rescales
// each split's partial by exp(m_i - M), sums, and divides by
// max(L, 1e-30). A split with no valid slot has m = -1e30 and contributes
// exp(-1e30 - M) = 0 once any slot is valid. When every split reports
// m = -1e30 the row has no valid slot, and the combine writes the mean of
// V over the W slots instead (with n_split = 1 pass 1 does the same in
// its epilogue); the windowed path never takes that branch. The wrapper
// chooses n_split
// (kernel.split_plan): about two blocks per SM of the card when B * KV
// is small, and at least one tile per split.
#include <cstdint>

#include "attention_common.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int kBK = 64;          // cache slots per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 64;
constexpr int kMaxOut = 2048;    // G * hd
constexpr int kOutPerThread = kMaxOut / kThreads;
constexpr int kHeadsPerWarp = kMaxG / kWarps;

// Bytes of a K or V row in shared memory: hd elements rounded up to 16
// bytes, plus 16.
__host__ __device__ inline int row_bytes(int hd, int es) {
  return (hd * es + 15) / 16 * 16 + 16;
}

using warp_mma::cp_async16;
using warp_mma::cp_async_commit;
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The first tile in [t, t_end) with a valid slot, or t_end. Block-wide.
// Bit r of thread i's `pre` is the validity of slot kThreads r + i of the
// split, for its first kPre tiles (read with q at the start, so these
// tiles cost no round trip to device memory here); later tiles are read
// as they come.
constexpr int kPreRounds = 4;
constexpr int kPre = kPreRounds * kThreads / kBK;
__device__ __forceinline__ int next_valid(const uint8_t* __restrict__ valid,
                                          uint32_t pre, int t_begin, int t,
                                          int t_end, int W) {
  for (; t < t_end; ++t) {
    const int rel = (t - t_begin) * kBK;   // the tile's first slot in the split
    int any;
    if (t - t_begin < kPre) {
      const int r = rel / kThreads;
      const int i = static_cast<int>(threadIdx.x) - rel % kThreads;
      any = i >= 0 && i < kBK && ((pre >> r) & 1u);
    } else {
      const int w = t * kBK + threadIdx.x;
      any = threadIdx.x < kBK && w < W && valid[w];
    }
    if (__syncthreads_or(any)) return t;
  }
  return t_end;
}

// Rows [w0, w0 + kBK) of one kv head into a (kBK, rb)-byte tile; rows
// past W are zeros. With `vec`, by 16-byte cp.async copies.
template <typename KT>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const KT* __restrict__ src,
                                          size_t stride, int w0, int W,
                                          int hd, int rb, bool vec) {
  if (vec) {
    const int chunks = hd * static_cast<int>(sizeof(KT)) / 16;
    for (int i = threadIdx.x; i < kBK * chunks; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const int w = w0 + r;
      const KT* s = src + static_cast<size_t>(w < W ? w : 0) * stride;
      cp_async16(dst + r * rb + 16 * c,
                 reinterpret_cast<const uint8_t*>(s) + 16 * c, w < W ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const int w = w0 + r;
      reinterpret_cast<KT*>(dst + r * rb)[d] =
          w < W ? src[static_cast<size_t>(w) * stride + d]
                : attn::from_f32<KT>(0.f);
    }
  }
}

template <typename KT>
struct Fp8Kind;
template <>
struct Fp8Kind<__nv_fp8_e4m3> {
  static constexpr __nv_fp8_interpretation_t value = __NV_E4M3;
};
template <>
struct Fp8Kind<__nv_fp8_e5m2> {
  static constexpr __nv_fp8_interpretation_t value = __NV_E5M2;
};

// Two fp8 values (the low and high byte of `bits`) as two bf16 in one
// register, exactly: fp8 -> f16 is exact (cvt.rn.f16x2.e4m3x2 / e5m2x2),
// and so are f16 -> f32 -> bf16 for these values (at most 3 mantissa
// bits, exponents within bf16's).
template <typename KT>
__device__ __forceinline__ uint32_t widen2(uint32_t bits) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(bits), Fp8Kind<KT>::value);
  const float2 f = __half22float2(__half2(h));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// An fp8 tile (kBK rows of `rbs` bytes) widened into a bf16 tile (rows of
// `rb` bytes), 8 elements a thread at a time: one 8-byte shared load, one
// 16-byte shared store (hd % 16 == 0 on this path; both row strides are
// multiples of 16 bytes).
template <typename KT>
__device__ __forceinline__ void widen_tile(uint8_t* dst,
                                           const uint8_t* src, int hd,
                                           int rb, int rbs) {
  const int octs = hd / 8;
  for (int i = threadIdx.x; i < kBK * octs; i += kThreads) {
    const int r = i / octs, c = i - r * octs;
    const uint2 raw = *reinterpret_cast<const uint2*>(src + r * rbs + 8 * c);
    uint4 out;
    out.x = widen2<KT>(raw.x & 0xffffu);
    out.y = widen2<KT>(raw.x >> 16);
    out.z = widen2<KT>(raw.y & 0xffffu);
    out.w = widen2<KT>(raw.y >> 16);
    *reinterpret_cast<uint4*>(dst + r * rb + 16 * c) = out;
  }
}

// The tensor-core pieces of the bf16 path (mma.sync m16n8k16):
// csrc/warp_mma.cuh.
using warp_mma::ldmatrix_x2;
using warp_mma::ldmatrix_x2_trans;
using warp_mma::ldmatrix_x4;
using warp_mma::mma_bf16;

// The two ways through a tile: FP32 FMAs element by element (kFma), and
// bf16 on the tensor cores (kMma: hd a multiple of 16, 16-byte rows).
enum Path { kFma = 0, kMma = 1 };
constexpr int kMaxMt = kMaxG / 16;       // 16-head row tiles (kMma)
constexpr int kPStride = kBK + 8;        // bf16 P row: 144 bytes (kMma)

// Shared memory after the K / V ring: q, then the scores or P in f32, P
// in bf16 (kMma), the correction and the running sum per head.
__host__ __device__ inline int padded_g(int G) { return (G + 15) / 16 * 16; }
__host__ __device__ inline size_t q_bytes(int G, int hd) {
  const size_t f32 = sizeof(float) * G * hd;
  const size_t bf16 = static_cast<size_t>(padded_g(G)) * (2 * hd + 16);
  return f32 > bf16 ? f32 : bf16;
}

// `es`: the bytes of a K / V element; `widen`: the fp8 kMma path, whose
// widened bf16 K and V tiles follow the ring.
__host__ __device__ inline size_t smem_bytes(int G, int hd, int es,
                                             bool widen) {
  return static_cast<size_t>(2 * 2 * kBK) * row_bytes(hd, es) +
         (widen ? static_cast<size_t>(2 * kBK) * row_bytes(hd, 2) : 0) +
         q_bytes(G, hd) +
         sizeof(float) * (static_cast<size_t>(G) * kBK + 2 * G) +
         sizeof(__nv_bfloat16) * padded_g(G) * kPStride;
}

// An upper bound of smem_bytes over G <= kMaxG, hd <= kMaxHd and
// G * hd <= kMaxOut, in f32 (the fp8 ring and its widened tiles take less
// than the f32 ring).
size_t max_smem_bytes() {
  return static_cast<size_t>(2 * 2 * kBK) * row_bytes(attn::kMaxHd, 4) +
         static_cast<size_t>(kMaxG) * (2 * attn::kMaxHd + 16) +
         sizeof(float) * (kMaxOut + kMaxG * kBK + 2 * kMaxG) +
         sizeof(__nv_bfloat16) * kMaxG * kPStride;
}

// The mean over the W slots of column d of one kv head's V (rows
// ``stride`` elements apart), in f32: the output of a row with no valid
// slot, where every p = exp(0).
template <typename KT>
__device__ float mean_v(const KT* __restrict__ v, size_t stride, int W,
                        int d) {
  float s = 0.f;
  for (int w = 0; w < W; ++w) s += attn::to_f32(v[w * stride + d]);
  return s / static_cast<float>(W);
}

template <typename T, typename KT, int kPath>
__global__ void __launch_bounds__(kThreads, 2)
decode_split_kernel(const T* __restrict__ q,            // (B, KV, G, hd)
                    const KT* __restrict__ k,           // (B, W, KV, hd)
                    const KT* __restrict__ v,           // (B, W, KV, hd)
                    const uint8_t* __restrict__ valid,  // (W,)
                    T* __restrict__ o,                  // (B, KV, G, hd)
                    float* __restrict__ part_acc,  // (B, KV, n_split, G, hd)
                    float* __restrict__ part_ml,   // (B, KV, n_split, G, 2)
                    int W, int KV, int G, int hd, int tiles_per_split,
                    float scale) {
  // kFma: acc[j] is output element tid + kThreads j.
  // kMma: acc[(i kMaxMt + mt) 4 + r] is the r-th C element of row tile mt
  // and column tile warp + kWarps i.
  constexpr int kAcc = kPath == kMma ? 2 * kMaxMt * 4 : kOutPerThread;
  // fp8 K / V on the tensor cores: staged as fp8, widened to bf16.
  constexpr bool kWiden = kPath == kMma && sizeof(KT) == 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const int es = sizeof(KT);
  const int rbs = row_bytes(hd, es);                // staged rows (bytes)
  const int rb = kWiden ? row_bytes(hd, 2) : rbs;   // rows the tile reads
  const int Gp = padded_g(G), qs = 2 * hd + 16;   // kMma q rows (bytes)
  uint8_t* sk = smem;                               // 2 stages of K
  uint8_t* sv = smem + 2 * kBK * rbs;               // 2 stages of V
  uint8_t* wk = smem + 4 * kBK * rbs;               // kWiden: bf16 K, V
  uint8_t* wv = wk + kBK * rb;
  uint8_t* sqb = kWiden ? wv + kBK * rb : wk;       // q: f32 G x hd, or
  float* sq = reinterpret_cast<float*>(sqb);        // bf16 Gp x qs bytes
  float* sp = reinterpret_cast<float*>(sqb + q_bytes(G, hd));  // G x kBK
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sp + G * kBK);
  float* sc = reinterpret_cast<float*>(sP + Gp * kPStride);  // (G,)
  float* sl = sc + G;                                        // (G,)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int n_tiles = (W + kBK - 1) / kBK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int n_out = G * hd;

  const size_t head0 = (static_cast<size_t>(b) * KV + kvh) * G * hd;
  uint32_t pre = 0;
#pragma unroll
  for (int r = 0; r < kPreRounds; ++r) {
    const int w = t_begin * kBK + r * kThreads + tid;
    if (w < min(t_end * kBK, W) && valid[w]) pre |= 1u << r;
  }
  if constexpr (kPath == kMma) {
    // q as bf16 rows (zeros past G), and P's rows past G zero for good.
    for (int e = tid; e < Gp * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      reinterpret_cast<T*>(sqb + r * qs)[d] =
          r < G ? q[head0 + e] : attn::from_f32<T>(0.f);
    }
    for (int e = tid; e < Gp * kPStride; e += kThreads)
      sP[e] = __float2bfloat16(0.f);
  } else {
    for (int e = tid; e < n_out; e += kThreads)
      sq[e] = attn::to_f32(q[head0 + e]);
  }
  for (int g = tid; g < G; g += kThreads) sl[g] = 0.f;
  const size_t stride = static_cast<size_t>(KV) * hd;
  const size_t base = static_cast<size_t>(b) * W * stride +
                      static_cast<size_t>(kvh) * hd;

  // Running max per head, in the registers of the warp that owns it
  // (head g = warp + kWarps i).
  float m_run[kHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) m_run[i] = attn::kNegInf;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  auto issue = [&](int t, int stage) {
    load_tile<KT>(sk + stage * kBK * rbs, k + base, stride, t * kBK, W, hd,
                  rbs, kPath == kMma);
    load_tile<KT>(sv + stage * kBK * rbs, v + base, stride, t * kBK, W, hd,
                  rbs, kPath == kMma);
  };

  int t_cur = next_valid(valid, pre, t_begin, t_begin, t_end, W);
  const bool empty = t_cur >= t_end;   // no valid slot in the split
  if (t_cur < t_end) issue(t_cur, 0);
  cp_async_commit();
  int t_nxt = t_cur < t_end
                  ? next_valid(valid, pre, t_begin, t_cur + 1, t_end, W)
                  : t_end;
  if (t_nxt < t_end) issue(t_nxt, 1);
  cp_async_commit();
  int stage = 0;

  while (t_cur < t_end) {
    cp_async_wait_older();
    __syncthreads();   // this stage's tile (and q, sl at first) is in
    const uint8_t* kt = sk + stage * kBK * rbs;
    const uint8_t* vt = sv + stage * kBK * rbs;
    if constexpr (kWiden) {
      widen_tile<KT>(wk, kt, hd, rb, rbs);
      widen_tile<KT>(wv, vt, hd, rb, rbs);
      __syncthreads();
      kt = wk;
      vt = wv;
    }
    const int w0 = t_cur * kBK;

    // Raw scores q . k of the warp's heads (w, w + kWarps, ...) at slots
    // lane and lane + 32.
    float s0[kHeadsPerWarp], s1[kHeadsPerWarp];
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) s0[i] = s1[i] = 0.f;
    if constexpr (kPath == kMma) {
      // S = q K^T on the tensor cores: warp w takes slots 8w .. 8w + 7 of
      // every 16-head row tile, into sp; then each warp reads its heads.
      const int n0 = 8 * warp;
      const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
#pragma unroll
      for (int mt = 0; mt < kMaxMt; ++mt) {
        if (mt * 16 < G) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          for (int ks = 0; ks < hd / 16; ++ks) {
            uint32_t a[4], bk[2];
            ldmatrix_x4(a, sqb + (mt * 16 + lr) * qs + (ks * 16 + lc) * 2);
            ldmatrix_x2(bk, kt + (n0 + (lane & 7)) * rb +
                                (ks * 16 + 8 * ((lane >> 3) & 1)) * 2);
            mma_bf16(c, a, bk);
          }
          const int r0 = mt * 16 + (lane >> 2), col = n0 + 2 * (lane & 3);
          if (r0 < G) {
            sp[r0 * kBK + col] = c[0];
            sp[r0 * kBK + col + 1] = c[1];
          }
          if (r0 + 8 < G) {
            sp[(r0 + 8) * kBK + col] = c[2];
            sp[(r0 + 8) * kBK + col + 1] = c[3];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kHeadsPerWarp; ++i) {
        const int g = warp + kWarps * i;
        if (g < G) {
          s0[i] = sp[g * kBK + lane];
          s1[i] = sp[g * kBK + lane + 32];
        }
      }
    } else {
      // Lane owns slots lane and lane + 32 and widens each element of
      // their K rows once for all the warp's heads.
      const KT* k0 = reinterpret_cast<const KT*>(kt + lane * rb);
      const KT* k1 = reinterpret_cast<const KT*>(kt + (lane + 32) * rb);
      for (int d = 0; d < hd; ++d) {
        const float a = attn::to_f32(k0[d]), c = attn::to_f32(k1[d]);
#pragma unroll
        for (int i = 0; i < kHeadsPerWarp; ++i) {
          const int g = warp + kWarps * i;
          if (g < G) {
            const float qv = sq[g * hd + d];
            s0[i] = fmaf(qv, a, s0[i]);
            s1[i] = fmaf(qv, c, s1[i]);
          }
        }
      }
    }

    // The online softmax of each of the warp's heads (the warp holds all
    // 64 scores of a head: max and sum by shuffles). P goes to sp in f32,
    // or to sP in bf16 for the tensor cores.
    const bool ok0 = w0 + lane < W && valid[w0 + lane];
    const bool ok1 = w0 + lane + 32 < W && valid[w0 + lane + 32];
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int g = warp + kWarps * i;
      if (g < G) {
        const float x0 = ok0 ? s0[i] * scale : attn::kNegInf;
        const float x1 = ok1 ? s1[i] * scale : attn::kNegInf;
        const float m_new =
            fmaxf(m_run[i], attn::group_max<32>(fmaxf(x0, x1)));
        const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        if constexpr (kPath == kMma) {
          sP[g * kPStride + lane] = __float2bfloat16(p0);
          sP[g * kPStride + lane + 32] = __float2bfloat16(p1);
        } else {
          sp[g * kBK + lane] = p0;
          sp[g * kBK + lane + 32] = p1;
        }
        const float sum = attn::group_sum<32>(p0 + p1);
        if (lane == 0) {
          const float corr = expf(m_run[i] - m_new);
          sc[g] = corr;
          sl[g] = sl[g] * corr + sum;
        }
        m_run[i] = m_new;
      }
    }
    __syncthreads();

    if constexpr (kPath == kMma) {
      // O = O * corr + P V on the tensor cores: warp w takes the 8-column
      // tiles w and w + 8 of hd, for every 16-head row tile.
      const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int nt = warp + kWarps * i;
        if (nt * 8 < hd) {
#pragma unroll
          for (int mt = 0; mt < kMaxMt; ++mt) {
            if (mt * 16 < G) {
              float* c = acc + (i * kMaxMt + mt) * 4;
              const int r0 = mt * 16 + (lane >> 2);
              const float c0 = r0 < G ? sc[r0] : 1.f;
              const float c1 = r0 + 8 < G ? sc[r0 + 8] : 1.f;
              float cc[4] = {c[0] * c0, c[1] * c0, c[2] * c1, c[3] * c1};
#pragma unroll
              for (int ks = 0; ks < kBK / 16; ++ks) {
                uint32_t a[4], bv[2];
                ldmatrix_x4(a, sP + (mt * 16 + lr) * kPStride + ks * 16 + lc);
                ldmatrix_x2_trans(bv, vt + (ks * 16 + lr) * rb + nt * 16);
                mma_bf16(cc, a, bv);
              }
#pragma unroll
              for (int x = 0; x < 4; ++x) c[x] = cc[x];
            }
          }
        }
      }
    } else {
      // O = O * corr + P V over the tile's slots, one output element at a
      // time (consecutive threads: consecutive columns).
#pragma unroll
      for (int j = 0; j < kOutPerThread; ++j) {
        const int e = tid + j * kThreads;
        if (e < n_out) {
          const int g = e / hd, d = e - g * hd;
          const float* pg = sp + g * kBK;
          const uint8_t* vcol = vt + d * es;
          float a = acc[j] * sc[g];
#pragma unroll 4
          for (int c = 0; c < kBK; ++c)
            a = fmaf(pg[c],
                     attn::to_f32(*reinterpret_cast<const KT*>(vcol + c * rb)),
                     a);
          acc[j] = a;
        }
      }
    }
    __syncthreads();   // the stage is free for the tile after next

    const int t_after =
        t_nxt < t_end ? next_valid(valid, pre, t_begin, t_nxt + 1, t_end, W)
                      : t_end;
    if (t_after < t_end) issue(t_after, stage);
    cp_async_commit();
    t_cur = t_nxt;
    t_nxt = t_after;
    stage ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // A row with no valid slot at all (n_split = 1 covers the whole ring):
  // the mean of V over the W slots.
  if (n_split == 1 && empty) {
    for (int e = tid; e < n_out; e += kThreads)
      o[head0 + e] = attn::from_f32<T>(mean_v(v + base, stride, W, e % hd));
    return;
  }
  // The output (n_split = 1) or this split's partial.
  const size_t part = (static_cast<size_t>(b) * KV + kvh) * n_split + split;
  auto put = [&](int e, float x) {
    if (n_split == 1)
      o[head0 + e] = attn::from_f32<T>(x / fmaxf(sl[e / hd], attn::kMinDenom));
    else
      part_acc[part * n_out + e] = x;
  };
  if constexpr (kPath == kMma) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = (warp + kWarps * i) * 8 + 2 * (lane & 3);
#pragma unroll
      for (int mt = 0; mt < kMaxMt; ++mt) {
        const int r0 = mt * 16 + (lane >> 2);
        const float* c = acc + (i * kMaxMt + mt) * 4;
        if (col < hd && r0 < G) {
          put(r0 * hd + col, c[0]);
          put(r0 * hd + col + 1, c[1]);
        }
        if (col < hd && r0 + 8 < G) {
          put((r0 + 8) * hd + col, c[2]);
          put((r0 + 8) * hd + col + 1, c[3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < n_out) put(e, acc[j]);
    }
  }
  if (n_split == 1) return;
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    const int g = warp + kWarps * i;
    if (g < G && lane == 0) {
      part_ml[(part * G + g) * 2] = m_run[i];
      part_ml[(part * G + g) * 2 + 1] = sl[g];
    }
  }
}

// Pass 2: one block per (g, kv head, b), one thread per output column.
// The splits' (m, l) go to shared memory in one round trip, M and L are
// warp reductions over them, and each thread sums its column over the
// splits' partials with the weights exp(m_i - M).
constexpr int kCombineThreads = 128;   // >= hd
constexpr int kMaxSplit = 1024;

template <typename T, typename KT>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const KT* __restrict__ v,   // (B, W, KV, hd)
                      T* __restrict__ o, int W, int KV, int G, int hd,
                      int n_split) {
  __shared__ float sm[kMaxSplit], sw[kMaxSplit];
  const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t part0 = (static_cast<size_t>(b) * KV + kvh) * n_split;
  for (int i = tid; i < n_split; i += kCombineThreads) {
    sm[i] = part_ml[((part0 + i) * G + g) * 2];
    sw[i] = part_ml[((part0 + i) * G + g) * 2 + 1];
  }
  __syncthreads();
  float M = attn::kNegInf;
  for (int i = lane; i < n_split; i += 32) M = fmaxf(M, sm[i]);
  M = attn::group_max<32>(M);
  float L = 0.f;
  for (int i = lane; i < n_split; i += 32) L += sw[i] * expf(sm[i] - M);
  L = attn::group_sum<32>(L);
  if (M <= attn::kNegInf) {   // no split saw a valid slot: the mean of V
    const size_t stride = static_cast<size_t>(KV) * hd;
    if (tid < hd)
      o[((static_cast<size_t>(b) * KV + kvh) * G + g) * hd + tid] =
          attn::from_f32<T>(mean_v(v + static_cast<size_t>(b) * W * stride +
                                       static_cast<size_t>(kvh) * hd,
                                   stride, W, tid));
    return;   // M is the same in every warp: the whole block returns
  }
  __syncthreads();   // every warp has read sw as l
  for (int i = tid; i < n_split; i += kCombineThreads)
    sw[i] = expf(sm[i] - M);
  __syncthreads();
  if (tid >= hd) return;
  const float* col = part_acc + (part0 * G + g) * hd + tid;
  const size_t step = static_cast<size_t>(G) * hd;
  float a = 0.f;
#pragma unroll 16
  for (int i = 0; i < n_split; ++i) a = fmaf(col[i * step], sw[i], a);
  o[((static_cast<size_t>(b) * KV + kvh) * G + g) * hd + tid] =
      attn::from_f32<T>(a / fmaxf(L, attn::kMinDenom));
}

template <typename T, typename KT>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* o, void* part_acc, void* part_ml, int B, int W, int KV,
           int G, int hd, int n_split, int tiles_per_split, float scale,
           cudaStream_t stream) {
  // Set once per instantiation, at the most any (G, hd) it takes needs.
  // The tensor-core path exists for bf16 q with bf16 or fp8 K / V.
  using Kernel = decltype(&decode_split_kernel<T, KT, kFma>);
  constexpr bool kHasMma = sizeof(T) == 2 && sizeof(KT) <= 2;
  static const int attr = [] {
    const int bytes = static_cast<int>(max_smem_bytes());
    const auto a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    int err = cudaFuncSetAttribute(decode_split_kernel<T, KT, kFma>, a, bytes);
    if constexpr (kHasMma)
      if (!err)
        err = cudaFuncSetAttribute(decode_split_kernel<T, KT, kMma>, a, bytes);
    return err;
  }();
  if (attr) return attr;
  // kMma stages K / V by 16-byte cp.async copies: rows of hd % 16 == 0
  // elements (bf16 or fp8) on 16-byte aligned bases.
  Kernel kernel = decode_split_kernel<T, KT, kFma>;
  bool mma = false;
  if constexpr (kHasMma)
    if (hd % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(v) % 16 == 0) {
      kernel = decode_split_kernel<T, KT, kMma>;
      mma = true;
    }
  const size_t smem =
      smem_bytes(G, hd, sizeof(KT), mma && sizeof(KT) == 1);
  kernel<<<dim3(n_split, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(o), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), W, KV, G, hd, tiles_per_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  decode_combine_kernel<T, KT><<<dim3(G, KV, B), kCombineThreads, 0,
                                 stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const KT*>(v), static_cast<T*>(o), W, KV, G, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

// q / out of type T, K / V of the cache's type (`kv_dtype`).
template <typename T>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
              const void* valid, void* o, void* part_acc, void* part_ml,
              int B, int W, int KV, int G, int hd, int n_split,
              int tiles_per_split, float scale, cudaStream_t st) {
  switch (kv_dtype) {
    case attn::kF8E4M3:
      return launch<T, __nv_fp8_e4m3>(q, k, v, valid, o, part_acc, part_ml,
                                      B, W, KV, G, hd, n_split,
                                      tiles_per_split, scale, st);
    case attn::kF8E5M2:
      return launch<T, __nv_fp8_e5m2>(q, k, v, valid, o, part_acc, part_ml,
                                      B, W, KV, G, hd, n_split,
                                      tiles_per_split, scale, st);
    default:
      return launch<T, T>(q, k, v, valid, o, part_acc, part_ml, B, W, KV, G,
                          hd, n_split, tiles_per_split, scale, st);
  }
}

}  // namespace

// `dtype`: q's and the output's type (attn::kF32 / kBF16); `kv_dtype`: the
// cache's, that same type or an fp8 format (attn::kF8E4M3 / kF8E5M2).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid,
                                       void* o, void* part_acc, void* part_ml,
                                       int B, int W, int KV, int G, int hd,
                                       int n_split, int tiles_per_split,
                                       float scale, int dtype, int kv_dtype,
                                       void* stream) {
  if (B == 0 || KV == 0 || G == 0) return 0;
  if (n_split < 1 || n_split > kMaxSplit || tiles_per_split < 1 ||
      static_cast<long long>(n_split) * tiles_per_split < (W + kBK - 1) / kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != attn::kF32 && dtype != attn::kBF16) ||
      (kv_dtype != dtype && kv_dtype != attn::kF8E4M3 &&
       kv_dtype != attn::kF8E5M2))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == attn::kBF16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, valid, o, part_acc,
                                    part_ml, B, W, KV, G, hd, n_split,
                                    tiles_per_split, scale, st);
  return launch_kv<float>(kv_dtype, q, k, v, valid, o, part_acc, part_ml, B,
                          W, KV, G, hd, n_split, tiles_per_split, scale, st);
}
