// Paged multi-query attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: dynamo_tpu/ops/paged_attention.py `_mq_kernel` (the Pallas TPU
// kernel driven by `_paged_attention_mq`, pl.pallas_call at :522). It
// computes the same function: for each batch row b and query column
// (t, kv head k, group g), an online-softmax attention over the row's
// true pages, read through block_tables[b]. Query t attends positions
// [0, lengths[b, t]); in tree mode it also attends in-flight slot s at
// position lengths[b, t] + s when anc[b, t, s] is set. int8 pages are
// dequantized in registers with per-position, per-head f32 scales (widen
// to f32, multiply, round once to q's dtype). Rows of length 0 output
// zeros, and so does any query column that attends no position.
//
// Dropped from the TPU design: the block-diagonal q and the transposed
// [KVH*hd, H] accumulator (MXU layout tricks), the 128-lane cap on
// KVH*T*G, and the cross-step DMA pipelining (the TPU grid runs in order;
// here blocks run in parallel and a warp keeps U positions of loads in
// flight instead).
//
// Design: grid (B, KVH), 256 threads (8 warps). The block stages its
// G*T query vectors (softmax scale folded in, f32) in shared memory, up
// to CQ columns per pass. Each warp walks one contiguous slice of the
// row, U positions per step with all their loads issued before any use;
// each lane holds hd/32 (VPL) consecutive elements of a K/V row and loads
// them with one vector load. Each warp keeps an online-softmax state
// (m, l, acc) per column; the warps merge through shared memory at the
// end of a pass. Positions that no column of the pass attends are never
// loaded, so garbage or NaN past a row's length cannot reach the sums.
//
// Bound on this card (H100 SXM, 3.35 TB/s HBM): the kernel must read
// every attended K and V row once, so its least time is
//   sum_b rowlen_b * KVH * hd * 2 (k, v) * sizeof(page)  (+ the f32 scales
//   for int8 pages, + q and out) / 3.35 TB/s.
// What this simple design leaves on the table: B*KVH blocks (64 at B=8
// for llama-8b) fill under half of the 132 SMs, so one row's walk is
// latency-bound; split-K ("flash-decoding") across blocks, TMA page
// copies and wgmma for the multi-query modes are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CQ = 8;        // query columns per pass
constexpr int MAX_HD = 256;
constexpr int MAX_T = 64;    // tree bits ride a 64-bit mask per query

enum Dtype { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// Round an f32 value to q's dtype and back (the int8 dequant's one rounding).
template <typename QT> __device__ __forceinline__ float round_q(float x);
template <> __device__ __forceinline__ float round_q<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_q<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename QT> __device__ __forceinline__ QT from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load VPL consecutive elements at p (aligned to VPL * sizeof(T) bytes,
// or 16 when that is larger) as f32.
template <typename T, int VPL>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, float* out) {
  constexpr int BYTES = VPL * static_cast<int>(sizeof(T));
  T e[VPL];
  if constexpr (BYTES % 16 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < BYTES / 16; ++j) {
      uint4 w = v[j];
      memcpy(reinterpret_cast<char*>(e) + 16 * j, &w, 16);
    }
  } else if constexpr (BYTES == 8) {
    uint2 w = *reinterpret_cast<const uint2*>(p);
    memcpy(e, &w, 8);
  } else if constexpr (BYTES == 4) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    memcpy(e, &w, 4);
  } else {
#pragma unroll
    for (int i = 0; i < VPL; ++i) e[i] = p[i];
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) out[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Does a query column with history horizon `len` and ancestor bits
// `anc` attend position `pos`? (Tree slot s sits at len + s.)
template <bool TREE>
__device__ __forceinline__ bool attends(int pos, int len, unsigned long long anc, int T) {
  if (pos < len) return true;
  if constexpr (TREE) {
    const int s = pos - len;
    return s < T && ((anc >> s) & 1ull);
  }
  return false;
}

template <typename QT, typename PT, int VPL, bool TREE>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const QT* __restrict__ q,      // [B, T, KVH, G, hd]
                       const PT* __restrict__ kc,     // layer slice [N, bs, KVH*hd]
                       const PT* __restrict__ vc,
                       const float* __restrict__ ks,  // layer slice [N, bs, KVH] (int8 only)
                       const float* __restrict__ vs,
                       const int* __restrict__ tables,   // [B, W]
                       const int* __restrict__ lengths,  // [B, T]
                       const int8_t* __restrict__ anc,   // [B, T, T] (tree only)
                       QT* __restrict__ out,             // [B, T, KVH, G, hd]
                       int T, int KVH, int G, int hd, int N, int bs, int W,
                       float scale) {
  constexpr bool QUANT = sizeof(PT) == 1;
  constexpr int U = VPL >= 8 ? 2 : 8;  // positions in flight per warp

  // Dynamic shared memory: q_s [CQ][hd] then acc_s [WARPS][CQ][hd] (f32).
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = smem + CQ * hd;
  __shared__ float m_s[WARPS][CQ];
  __shared__ float l_s[WARPS][CQ];
  __shared__ int len_s[MAX_T];
  __shared__ unsigned long long anc_s[MAX_T];
  __shared__ int rowlen_s;

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int NQ = T * G;
  const size_t D = static_cast<size_t>(KVH) * hd;
  const bool lane_on = lane * VPL < hd;

  // Row bookkeeping: per-query horizons, ancestor bits, walk bound.
  if (threadIdx.x < T) {
    const int t = threadIdx.x;
    len_s[t] = max(lengths[b * T + t], 0);
    unsigned long long bits = 0;
    if constexpr (TREE) {
      const int8_t* a = anc + (static_cast<size_t>(b) * T + t) * T;
      for (int s = 0; s < T; ++s)
        if (a[s] != 0) bits |= 1ull << s;
    }
    anc_s[t] = bits;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int mx = 0;
    bool live = false;
    for (int t = 0; t < T; ++t) {
      mx = max(mx, len_s[t]);
      live |= anc_s[t] != 0;
    }
    if (TREE) mx = live ? mx + T : 0;
    rowlen_s = min(mx, W * bs);  // the table addresses no further
  }
  __syncthreads();
  const int rowlen = rowlen_s;
  const int* tab = tables + static_cast<size_t>(b) * W;
  const size_t head_off = static_cast<size_t>(kh) * hd + static_cast<size_t>(lane) * VPL;

  for (int c0 = 0; c0 < NQ; c0 += CQ) {
    const int nc = min(CQ, NQ - c0);
    for (int i = threadIdx.x; i < nc * hd; i += THREADS) {
      const int c = i / hd, e = i % hd;
      const int col = c0 + c, t = col / G, g = col % G;
      q_s[c * hd + e] = to_f(q[((static_cast<size_t>(b) * T + t) * KVH + kh) * G * hd +
                         static_cast<size_t>(g) * hd + e]) * scale;
    }
    __syncthreads();

    float qr[CQ][VPL];
    int clen[CQ];
    unsigned long long canc[CQ];
    float m[CQ], l[CQ], acc[CQ][VPL];
#pragma unroll
    for (int c = 0; c < CQ; ++c) {
      const bool on = c < nc;
      const int t = on ? (c0 + c) / G : 0;
      clen[c] = on ? len_s[t] : 0;
      canc[c] = on ? anc_s[t] : 0ull;
      m[c] = -INFINITY;
      l[c] = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        qr[c][i] = (on && lane_on) ? q_s[c * hd + lane * VPL + i] : 0.f;
        acc[c][i] = 0.f;
      }
    }

    // This warp's slice of the row: [lo, hi), a multiple of U long.
    const int slice = (rowlen + WARPS * U - 1) / (WARPS * U) * U;
    const int lo = warp * slice, hi = min(lo + slice, rowlen);
    for (int base = lo; base < hi; base += U) {
      float kv[U][VPL], vv[U][VPL];
      bool need[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = base + u;
        bool a = false;
#pragma unroll
        for (int c = 0; c < CQ; ++c) a |= pos < hi && attends<TREE>(pos, clen[c], canc[c], T);
        need[u] = a;
        if (a && lane_on) {
          const int page = min(max(tab[pos / bs], 0), N - 1);
          const size_t row = static_cast<size_t>(page) * bs + pos % bs;
          load_vals<PT, VPL>(kc + row * D + head_off, kv[u]);
          load_vals<PT, VPL>(vc + row * D + head_off, vv[u]);
          if constexpr (QUANT) {
            const float sk = ks[row * KVH + kh], sv = vs[row * KVH + kh];
#pragma unroll
            for (int i = 0; i < VPL; ++i) {
              kv[u][i] = round_q<QT>(kv[u][i] * sk);
              vv[u][i] = round_q<QT>(vv[u][i] * sv);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < VPL; ++i) kv[u][i] = vv[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!need[u]) continue;  // warp-uniform
        const int pos = base + u;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          if (c >= nc) break;
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < VPL; ++i) part = fmaf(qr[c][i], kv[u][i], part);
          const float s = warp_sum(part);
          if (!attends<TREE>(pos, clen[c], canc[c], T)) continue;
          const float mn = fmaxf(m[c], s);
          const float corr = expf(m[c] - mn);
          const float p = expf(s - mn);
          l[c] = l[c] * corr + p;
#pragma unroll
          for (int i = 0; i < VPL; ++i) acc[c][i] = fmaf(acc[c][i], corr, p * vv[u][i]);
          m[c] = mn;
        }
      }
    }

    // Merge the warps' partial states.
#pragma unroll
    for (int c = 0; c < CQ; ++c) {
      if (c >= nc) break;
      if (lane_on) {
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc_s[(warp * CQ + c) * hd + lane * VPL + i] = acc[c][i];
      }
      if (lane == 0) {
        m_s[warp][c] = m[c];
        l_s[warp][c] = l[c];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nc * hd; i += THREADS) {
      const int c = i / hd, e = i % hd;
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_s[w][c]);
      float L = 0.f, O = 0.f;
      if (M > -INFINITY) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float f = m_s[w][c] == -INFINITY ? 0.f : expf(m_s[w][c] - M);
          L = fmaf(l_s[w][c], f, L);
          O = fmaf(acc_s[(w * CQ + c) * hd + e], f, O);
        }
      }
      const int col = c0 + c, t = col / G, g = col % G;
      out[((static_cast<size_t>(b) * T + t) * KVH + kh) * G * hd + static_cast<size_t>(g) * hd + e] =
          from_f<QT>(L > 0.f ? O / L : 0.f);
    }
    __syncthreads();  // q_s / acc_s are reused by the next pass
  }
}

template <typename QT, typename PT, int VPL, bool TREE>
cudaError_t launch_typed(const void* q, const void* kc, const void* vc, const float* ks,
                         const float* vs, const int* tables, const int* lengths,
                         const int8_t* anc, void* out, int B, int T, int KVH, int G, int hd,
                         int N, int bs, int W, float scale, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, PT, VPL, TREE>;
  const int smem = (1 + WARPS) * CQ * hd * static_cast<int>(sizeof(float));
  static int smem_set = 0;  // opt-in above 48 KB, once per instantiation
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  kernel<<<dim3(B, KVH), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kc), static_cast<const PT*>(vc), ks, vs,
      tables, lengths, anc, static_cast<QT*>(out), T, KVH, G, hd, N, bs, W, scale);
  return cudaGetLastError();
}

template <typename QT, typename PT, bool TREE>
cudaError_t launch_vpl(int vpl, const void* q, const void* kc, const void* vc, const float* ks,
                       const float* vs, const int* tables, const int* lengths,
                       const int8_t* anc, void* out, int B, int T, int KVH, int G, int hd,
                       int N, int bs, int W, float scale, cudaStream_t stream) {
#define DTPU_VPL_CASE(V)                                                                      \
  case V:                                                                                     \
    return launch_typed<QT, PT, V, TREE>(q, kc, vc, ks, vs, tables, lengths, anc, out, B, T, \
                                         KVH, G, hd, N, bs, W, scale, stream);
  switch (vpl) {
    DTPU_VPL_CASE(1)
    DTPU_VPL_CASE(2)
    DTPU_VPL_CASE(4)
    DTPU_VPL_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DTPU_VPL_CASE
}

template <typename QT, typename PT>
cudaError_t launch_tree(bool tree, int vpl, const void* q, const void* kc, const void* vc,
                        const float* ks, const float* vs, const int* tables, const int* lengths,
                        const int8_t* anc, void* out, int B, int T, int KVH, int G, int hd,
                        int N, int bs, int W, float scale, cudaStream_t stream) {
  if (tree)
    return launch_vpl<QT, PT, true>(vpl, q, kc, vc, ks, vs, tables, lengths, anc, out, B, T,
                                    KVH, G, hd, N, bs, W, scale, stream);
  return launch_vpl<QT, PT, false>(vpl, q, kc, vc, ks, vs, tables, lengths, anc, out, B, T,
                                   KVH, G, hd, N, bs, W, scale, stream);
}

}  // namespace

extern "C" {

// Launch the paged attention kernel on `stream`; returns a cudaError_t
// (0 = launched). Pointers are device pointers; k_cache/v_cache/k_scale/
// v_scale are the FULL [L, ...] arrays and `layer` selects the slice.
// k_scale/v_scale are used only when page_dtype is int8; anc is null
// outside tree mode. No synchronisation, no allocation.
int dtpu_paged_attention(const void* q, const void* k_cache, const void* v_cache,
                         const void* k_scale, const void* v_scale, const void* block_tables,
                         const void* lengths, const void* anc, void* out, int q_dtype,
                         int page_dtype, int B, int T, int KVH, int G, int hd, int N, int bs,
                         int W, int layer, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (T < 0 || T > MAX_T || hd <= 0 || hd > MAX_HD || hd % 32 != 0 || KVH <= 0 || G <= 0 ||
      N <= 0 || bs <= 0 || W <= 0 || layer < 0)
    return cudaErrorInvalidValue;
  const int vpl = hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : 8;
  const size_t layer_elems = static_cast<size_t>(N) * bs * KVH * hd;
  const size_t layer_scales = static_cast<size_t>(N) * bs * KVH;
  const size_t page_bytes = page_dtype == DT_F32 ? 4 : page_dtype == DT_BF16 ? 2 : 1;
  const char* kc = static_cast<const char*>(k_cache) + layer * layer_elems * page_bytes;
  const char* vc = static_cast<const char*>(v_cache) + layer * layer_elems * page_bytes;
  const float* ks = page_dtype == DT_I8 ? static_cast<const float*>(k_scale) + layer * layer_scales : nullptr;
  const float* vs = page_dtype == DT_I8 ? static_cast<const float*>(v_scale) + layer * layer_scales : nullptr;
  const int* tab = static_cast<const int*>(block_tables);
  const int* len = static_cast<const int*>(lengths);
  const int8_t* an = static_cast<const int8_t*>(anc);
  const bool tree = an != nullptr;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == DT_F32 && page_dtype == DT_F32)
    return launch_tree<float, float>(tree, vpl, q, kc, vc, ks, vs, tab, len, an, out, B, T, KVH, G,
                                     hd, N, bs, W, scale, st);
  if (q_dtype == DT_BF16 && page_dtype == DT_BF16)
    return launch_tree<__nv_bfloat16, __nv_bfloat16>(tree, vpl, q, kc, vc, ks, vs, tab, len, an,
                                                     out, B, T, KVH, G, hd, N, bs, W, scale, st);
  if (q_dtype == DT_F32 && page_dtype == DT_I8)
    return launch_tree<float, int8_t>(tree, vpl, q, kc, vc, ks, vs, tab, len, an, out, B, T, KVH,
                                      G, hd, N, bs, W, scale, st);
  if (q_dtype == DT_BF16 && page_dtype == DT_I8)
    return launch_tree<__nv_bfloat16, int8_t>(tree, vpl, q, kc, vc, ks, vs, tab, len, an, out, B,
                                              T, KVH, G, hd, N, bs, W, scale, st);
  return cudaErrorInvalidValue;
}

const char* dtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
