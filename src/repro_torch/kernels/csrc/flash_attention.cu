// Prefill attention with an online softmax: causal, sliding-window or full
// masks, GQA (query head h reads kv head h / G). Two kernels:
// flash_wgmma_kernel (bf16 on the tensor cores, hd a multiple of 8) and
// flash_kernel (FP32 FMAs: f32, and bf16 at any other hd).
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
// What bounds it on the H100: 4 * B * H * hd operations per (query, key)
// pair the mask keeps (2 for QK^T, 2 for PV) against q, k, v and o moved
// once. At the path's shapes (hd = 128) that is 64 operations per byte of
// K/V per query row, so long prompts are bound by the bf16 tensor cores
// (989 TFLOP/s) and the served 32-token prompts by latency: 16 to 64
// blocks of one query tile on 132 SMs.
//
// flash_wgmma_kernel, the bf16 design for Hopper. One block owns one
// 128-row query tile of one (b, h): two consumer warpgroups of 64 rows
// each and one producer warp. The producer loads the Q tile once and the
// K and V tiles of 64 keys into a ring of kStages stages by TMA
// (4-D tensor maps over the model's (B, S, H, hd) / (B, T, KV, hd)
// layouts, 64-column panels of 128-byte rows in the 128-byte swizzle that
// the wgmma descriptors read), signalling mbarriers with the expected
// transaction bytes; TMA zero-fills rows past S and T and columns past
// hd, so ragged tiles and hd < 128 need no padding copy (one instantiation
// of two 64-column panels serves every hd <= 128). Each consumer
// warpgroup computes S = Q K^T with wgmma.m64n64k16 from two shared-memory
// descriptors (both K-major as stored), keeps the running max and sum and
// the correction in registers (a row's 16 scores of a thread reduce over
// the 4 threads of a quad), masks per element only the tiles that cross
// the diagonal, the window's edge or T, and skips a tile that its 64 rows
// cannot see. P goes to bf16 in registers, where the accumulator fragment
// of S is the A fragment of P.V, and wgmma.m64n128k16 takes V from
// shared memory as an MN-major B (transpose flag set). The epilogue
// multiplies by 1 / max(l, 1e-30) and stores bf16 from registers. Blocks
// run the heaviest query tiles (causal: the last) first.
//
// Numerics: P is rounded to bf16 once (the TPU kernel multiplies f32 P
// with V); each weight moves by at most 2^-9 relative, well inside the
// bf16 contract |d| <= 5e-2 + 5e-2 |x|. The sums l stay f32.
//
// flash_kernel, the FP32 route: one block per 64-row
// query tile, a 16 x 16 thread grid, q / k / v widened to f32 in shared
// memory, FP32 FMAs, P kept in f32. TF32 would keep ~3 digits and break
// the f32 contract (rtol 2e-4, atol 2e-5), so f32 stays on FP32 FMAs;
// bf16 takes this route only when hd % 8 != 0, where a TMA map's strides
// (multiples of 16 bytes) cannot describe the layout.
#include <dlfcn.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

// Error codes of the tensor-core launch beside CUDA's: libcuda's
// cuTensorMapEncodeTiled was not found, or refused a map (plus its
// CUresult).
constexpr int kEncodeMissing = 9000;
constexpr int kEncodeFailed = 10000;

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


// ---- flash_wgmma_kernel: bf16 on the tensor cores ---------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;                  // query rows per block
constexpr int kBK = 64;                   // keys per kv tile
constexpr int kStages = 3;                // K/V ring depth
constexpr int kConsumers = 256;           // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32; // and one producer warp
constexpr int kRowBytes = 128;            // a swizzled row: 64 bf16
constexpr int kQPanel = kBQ * kRowBytes;  // 16 KB
constexpr int kKVPanel = kBK * kRowBytes; // 8 KB

constexpr int kPanels = 2;                // 64-column panels: hd <= 128

// Shared memory of a block: Q, then the K and V rings, then the barriers.
// Every panel starts on a 1024-byte swizzle atom. At hd <= 64 the second
// panel is TMA's zero fill.
struct Layout {
  static constexpr int q = 0;
  static constexpr int k = q + kPanels * kQPanel;
  static constexpr int v = k + kStages * kPanels * kKVPanel;
  static constexpr int bars = v + kStages * kPanels * kKVPanel;
  static constexpr int bytes = bars + (1 + 2 * kStages) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ bool keeps(int mode, int window, int T_len,
                                      int qp, int kp) {
  const int dist = qp - kp;
  bool ok = kp < T_len;
  if (mode == kCausal) ok = ok && dist >= 0;
  if (mode == kSliding) ok = ok && dist >= 0 && dist < window;
  return ok;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   bf16* __restrict__ o,   // (B, S, H, hd)
                   int S, int T_len, int H, int KV, int hd, int mode,
                   int window, float scale_log2) {
  using L = Layout;
  constexpr int kOut = kPanels * 32;       // O accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem + L::q;
  uint8_t* sk = smem + L::k;
  uint8_t* sv = smem + L::v;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  // The kv tiles this query tile can see.
  int k_lo = 0, k_hi = T_len;
  if (mode != kFull) {
    k_hi = min(T_len, q0 + kBQ);
    if (mode == kSliding) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: one lane issues every TMA load ----
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(q_full, kPanels * kQPanel);
      for (int p = 0; p < kPanels; ++p)
        tma_load_4d(sq + p * kQPanel, &q_map, q_full, 64 * p, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * kPanels * kKVPanel);
        const int k0 = k_lo + i * kBK;
        for (int p = 0; p < kPanels; ++p) {
          tma_load_4d(sk + (s * kPanels + p) * kKVPanel, &k_map, &full[s], 64 * p,
                      kvh, k0, b);
          tma_load_4d(sv + (s * kPanels + p) * kKVPanel, &v_map, &full[s], 64 * p,
                      kvh, k0, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int qp0 = q0 + 64 * wg + 16 * warp + lane / 4;   // this thread's
  const int qp1 = qp0 + 8;                               // two rows
  const int wg_lo = q0 + 64 * wg;
  const int wg_hi = min(wg_lo + 63, S - 1);

  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float m0 = attn::kNegInf, m1 = attn::kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  const uint8_t* q_rows = sq + wg * 64 * kRowBytes;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = k_lo + i * kBK, k_max = k0 + kBK - 1;
    mbar_wait(&full[s], (i / kStages) & 1);

    // Can this warpgroup's rows see the tile, and must it mask it?
    bool visible = wg_lo < S, masked = k_max >= T_len;
    if (mode == kCausal) {
      visible = visible && k0 <= wg_hi;
      masked = masked || k_max > wg_lo;
    } else if (mode == kSliding) {
      visible = visible && k0 <= wg_hi && k_max > wg_lo - window;
      masked = masked || k_max > wg_lo || k0 <= wg_hi - window;
    }

    if (visible) {
      const uint8_t* k_tile = sk + s * kPanels * kKVPanel;
      const uint8_t* v_tile = sv + s * kPanels * kKVPanel;
      // S = Q K^T: 16 columns of hd per wgmma, 4 per 64-column panel.
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;   // dropped: scale_d = 0
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(
              sc, desc_sw128(q_rows + p * kQPanel + kk * 32, 16, 1024),
              desc_sw128(k_tile + p * kKVPanel + kk * 32, 16, 1024),
              (p | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Online softmax in registers (base 2: scores carry log2 e). sc[4j
      // + e] is row qp0, key k0 + 8j + 2 quad + e; sc[4j + 2 + e] row qp1.
      float mx0 = attn::kNegInf, mx1 = attn::kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * quad + e;
          float s0 = sc[4 * j + e] * scale_log2;
          float s1 = sc[4 * j + 2 + e] * scale_log2;
          if (masked) {
            if (!keeps(mode, window, T_len, qp0, kp)) s0 = attn::kNegInf;
            if (!keeps(mode, window, T_len, qp1, kp)) s1 = attn::kNegInf;
          }
          sc[4 * j + e] = s0;
          sc[4 * j + 2 + e] = s1;
          mx0 = fmaxf(mx0, s0);
          mx1 = fmaxf(mx1, s1);
        }
      mx0 = attn::group_max<4>(mx0);
      mx1 = attn::group_max<4>(mx1);
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = exp2f(sc[4 * j + e] - n0);
          sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - n1);
          r0 += sc[4 * j + e];
          r1 += sc[4 * j + 2 + e];
        }
      l0 = l0 * c0 + r0;   // this thread's share; the quad sums at the end
      l1 = l1 * c1 + r1;
#pragma unroll
      for (int j = 0; j < kOut / 4; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }

      // P in bf16: the S fragment of keys 16kk..16kk+15 is the A fragment
      // of the kk-th k16 step of P.V.
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V: V's 16 keys per step (2048 bytes), panels 8 KB apart.
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc_sw128(v_tile + kk * 16 * kRowBytes,
                                       kKVPanel, 1024);
        wgmma_m64n128k16_rs(acc, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with stage s
  }

  // Epilogue: the quad's row sums, 1 / max(l, 1e-30), bf16 stores.
  l0 = attn::group_sum<4>(l0);
  l1 = attn::group_sum<4>(l1);
  const float inv0 = 1.f / fmaxf(l0, attn::kMinDenom);
  const float inv1 = 1.f / fmaxf(l1, attn::kMinDenom);
  const size_t row = static_cast<size_t>(H) * hd;
  bf16* o0 = o + (static_cast<size_t>(b) * S + qp0) * row +
             static_cast<size_t>(h) * hd;
  bf16* o1 = o0 + 8 * row;
#pragma unroll
  for (int j = 0; j < kOut / 4; ++j) {
    const int col = 8 * j + 2 * quad;   // hd is a multiple of 8: col + 1 < hd
    if (col < hd) {
      if (qp0 < S)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(
            acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (qp1 < S)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
            acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, taken from libcuda.so.1, which the CUDA runtime
// has loaded (the library is not linked against libcuda).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeFn>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A map over a (batch, rows, heads, hd) bf16 tensor whose boxes are
// (64 columns, 1 head, box_rows rows, 1 batch row) in the 128-byte swizzle.
int make_map(CUtensorMap* map, const void* base, int batch, int rows,
             int heads, int hd, int box_rows) {
  EncodeFn encode = encode_fn();
  if (encode == nullptr) return kEncodeMissing;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(hd) * 2,
      static_cast<cuuint64_t>(heads) * hd * 2,
      static_cast<cuuint64_t>(rows) * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_len, int H, int KV, int hd, int mode, int window,
           float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout::alloc);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, B, S, H, hd, kBQ);
  if (!err) err = make_map(&km, k, B, T_len, KV, hd, kBK);
  if (!err) err = make_map(&vm, v, B, T_len, KV, hd, kBK);
  if (err) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_wgmma_kernel<<<grid, kThreads, Layout::alloc, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), S, T_len, H, KV, hd, mode, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int S, int T_len, int H, int KV,
                                         int hd, int mode, int window,
                                         float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (hd % 8 != 0 || hd > attn::kMaxHd) return static_cast<int>(
      cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return tc::launch(q, k, v, o, B, S, T_len, H, KV, hd, mode, window, scale,
                    st);
}
