// Weight-only int8 matrix product for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: dynamo_tpu/engine/model.py `_dot_q` (:156) and the int8 branches
// of `_logits` (:279-291), the tied one (:283-285) included. Those are not
// Pallas kernels: XLA fuses the
// int8 -> bf16 convert into the dot's operand read, so the TPU streams one
// byte per weight. In PyTorch, `x @ w.to(bf16) * s` would write and read a
// bf16 copy of every weight on every call (~5 bytes per weight); this kernel
// keeps the TPU's one byte.
//
// It computes, for x [M, K] (bf16 or f32, M <= 64), w [K, N] int8 in the JAX
// layout (contiguous along N) and scale [N] (f32 or bf16):
//   acc[m, n] = sum_k x[m, k] * w[k, n]          (f32 accumulation)
//   layers (out in x's dtype):  y = rx( rx(acc) * rx(scale[n]) )
//   logits (out f32):           y = f32( rx(acc) ) * f32(scale[n])
// where rx rounds to x's dtype (round to nearest even; identity for f32):
// the rounding points of the JAX functions.
//
// Bound on this card (H100 SXM, 3.35 TB/s HBM): at decode batch sizes the
// product does 2*M operations per weight byte, far below the ~295 operations
// per byte the tensor cores need to be the limit, so it is bound by reading
// K*N weight bytes once. The design streams them once:
// - Each block owns 128 output columns (128-byte row segments) and a
//   contiguous range of K (split-K), walked in 128-row tiles through a
//   4-stage ring in shared memory filled by 16-byte cp.async copies,
//   coalesced along N. x's rows for the same tile ride the same ring. Splits
//   are chosen from the shapes (the wrapper's split_k): as many as keep the
//   call within one wave of resident blocks (2 per SM at M <= 8).
// - bf16 x: products on the tensor cores, mma.sync.m16n8k16 with f32
//   accumulation, computing w^T x^T: the weights are the A operand. Each warp
//   owns 64 of the block's columns and half of each tile's k rows. A row r
//   of A tile t (t = 0..3) is the warp's column 4r + t, so a thread's A
//   fragment for all four tiles comes from two 32-bit shared-memory words per
//   k row (4 adjacent columns each), read without bank conflicts (rows padded
//   to 144 bytes). int8 becomes bf16 in registers exactly, two at a time: a
//   byte permute pairs the two k rows' bytes, two bitwise ops build
//   128 + (v & 127) and 128 + 128 * sign(v) as bf16 pairs, and one bf16x2
//   subtract leaves v. No bf16 copy of w exists anywhere. The x rows are the
//   B operand, M in 8-row tiles (up to 8 of them), so each weight converted
//   feeds every row.
// - f32 x: FMAs on the CUDA cores, 8 rows of x per block (grid z).
// - The block's two k halves (or k-lanes) are added in order. With one split
//   the block writes y; otherwise it writes f32 partials [splits, M, N] to
//   scratch the wrapper allocates, and a second kernel (a programmatic
//   dependent launch, so it sets up while the first drains) adds them in
//   split order and applies the epilogue. No float atomics: a repeat gives
//   the same bits, inside CUDA graphs too.
// - Shapes that break 16-byte alignment (K % 8 for bf16 x, K % 4 for f32,
//   N % 16, or an unaligned pointer) stage the same tiles with plain loads.
//
// The tied head (dtpu_int8_matmul_t): llama-1b and llama-3b take their
// logits from the int8 embedding [V, D] used transposed, so w arrives as
// [N, K] contiguous along K, with the same scale [N], epilogue and rounding
// points. Bound the same way (V*D bytes, 394 MB at llama-3b). Each warp owns
// 32 rows of w (two m16n8k16 A tiles) and walks K in 64-byte steps: a thread
// reads 16 contiguous bytes of each of its four rows per step (coalesced
// 64-byte row segments), next step's loads in flight while this one's run.
// The k order inside a step is permuted so that a 32-bit word of one row
// feeds an A fragment's k pair directly (physical k 16tg + 4s + {0,1} and
// {2,3} are logical k 2tg + {0,1} and 2tg + 8 + {0,1} of sub-step s): a dot
// product does not depend on the order of its terms, as long as the x rows,
// staged once per block in shared memory (rows padded to 8 bytes past a
// multiple of 128, so a half-warp's 8-byte reads hit distinct banks), use
// the same order. Blocks of 256 rows; every x row (up to 64, 8-row m tiles)
// rides the block, staged in K chunks that fit 96 KB, so each weight is read
// once and feeds every row. The warp's sum over K is its own, in order, so
// repeats are bit-identical. f32 x: the same loads, FMAs on the CUDA cores,
// 8 x rows per block (grid y for more), the four k lanes of a row added by
// shuffles in a fixed tree. No copy of the embedding is made.
//
// Not taken here (ROADMAP): wgmma and TMA, fusing wq/wk/wv into one call,
// a prefill-shaped kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;       // output columns per block
constexpr int BK = 128;       // k rows per stage
constexpr int STAGES = 4;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROW = BN + 16;  // bytes per staged weight row
constexpr int WWORDS = WROW / 4;
constexpr int MAX_M = 64;
constexpr int F32_ROWS = 8;    // x rows per block on the f32 path
constexpr int MERGE_THREADS = 256;

enum Dtype { DT_F32 = 0, DT_BF16 = 1 };

using bf16 = __nv_bfloat16;

template <typename XT> struct XRow;
template <> struct XRow<bf16> { static constexpr int ELEMS = BK + 8, VEC = 8; };
template <> struct XRow<float> { static constexpr int ELEMS = BK + 4, VEC = 4; };

struct Params {
  const void* x;      // [M, K]
  const int8_t* w;    // [K, N]
  const void* scale;  // [N]
  void* out;          // [M, N]
  float* part;        // [splits, M, N] (splits > 1)
  int M, K, N, scale_bf16, out_f32, splits, tiles_per_split, k_tiles;
};

template <typename XT> __device__ __forceinline__ XT from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename XT> __device__ __forceinline__ float round_x(float v);
template <> __device__ __forceinline__ float round_x<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_x<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; when !pred nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte b of a word whose bytes were xored with 0x80 -> the signed int8 value
// as f32, exactly: the byte becomes the low mantissa bits of 2^23.
__device__ __forceinline__ float i8_to_f32(uint32_t biased, int b) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | b)) - 8388736.0f;
}

// Byte b of `lo` and byte b of `hi` -> a packed bf16 pair (lo in the low half).
// Exact: with s the sign bit, v = (128 + (v & 127)) - (128 + 128 s), and both
// terms are bf16 values (0x4300 | low 7 bits; 0x4300 | s << 7).
__device__ __forceinline__ uint32_t i8_pair_bf16(uint32_t lo, uint32_t hi, int b) {
  const uint32_t pair = __byte_perm(lo, hi, (b | b << 4 | (4 + b) << 8 | (4 + b) << 12));
  const uint32_t mag = (pair & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (pair & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(mag), "r"(off));
  return r;
}

// d += a . b, m16n8k16, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename XT>
__device__ __forceinline__ void epilogue(const Params& p, int m, int n, float acc) {
  const float s = p.scale_bf16 ? __bfloat162float(static_cast<const bf16*>(p.scale)[n])
                               : static_cast<const float*>(p.scale)[n];
  const float r = round_x<XT>(acc);
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.out_f32)
    static_cast<float*>(p.out)[o] = r * s;
  else
    static_cast<XT*>(p.out)[o] = from_f<XT>(r * round_x<XT>(s));
}

// Stage k tile `tile` of the block's 64 columns (from n0) and of x's rows
// m0 .. m0 + MP - 1 into `stage`: weights [BK][WROW] bytes, then x
// [MP][XRow::ELEMS]. Out-of-range rows and columns are zeros.
template <typename XT, int MP, bool ALIGNED>
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* stage, int tile, int n0,
                                           int m0) {
  int8_t* ws = reinterpret_cast<int8_t*>(stage);
  XT* xs = reinterpret_cast<XT*>(stage + BK * WROW);
  const XT* x = static_cast<const XT*>(p.x);
  constexpr int XE = XRow<XT>::ELEMS;
  const int k0 = tile * BK;
  if constexpr (ALIGNED) {
    for (int c = threadIdx.x; c < BK * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16), q = c % (BN / 16);
      const int k = k0 + r, n = n0 + q * 16;
      const bool ok = k < p.K && n < p.N;
      cp_async16(ws + r * WROW + q * 16, ok ? p.w + static_cast<size_t>(k) * p.N + n : p.w, ok);
    }
    constexpr int XV = XRow<XT>::VEC;
    for (int c = threadIdx.x; c < MP * (BK / XV); c += THREADS) {
      const int m = c / (BK / XV), q = c % (BK / XV);
      const int k = k0 + q * XV;
      const bool ok = m0 + m < p.M && k < p.K;
      cp_async16(xs + m * XE + q * XV, ok ? x + static_cast<size_t>(m0 + m) * p.K + k : x, ok);
    }
  } else {
    for (int c = threadIdx.x; c < BK * BN; c += THREADS) {
      const int r = c / BN, j = c % BN;
      const int k = k0 + r, n = n0 + j;
      ws[r * WROW + j] = (k < p.K && n < p.N) ? p.w[static_cast<size_t>(k) * p.N + n] : 0;
    }
    for (int c = threadIdx.x; c < MP * BK; c += THREADS) {
      const int m = c / BK, j = c % BK;
      const int k = k0 + j;
      xs[m * XE + j] =
          (m0 + m < p.M && k < p.K) ? x[static_cast<size_t>(m0 + m) * p.K + k] : from_f<XT>(0.f);
    }
  }
}

// Final per-block step: sum the NRED partial sets in `red` ([NRED][MP][BN]
// f32) in order, then write y (one split) or the split's partials.
template <typename XT, int MP, int NRED>
__device__ __forceinline__ void finish(const Params& p, const float* red, int n0, int m0, int s) {
  for (int c = threadIdx.x; c < MP * BN; c += THREADS) {
    const int m = c / BN, j = c % BN;
    const int n = n0 + j;
    if (m0 + m >= p.M || n >= p.N) continue;
    float v = red[m * BN + j];
#pragma unroll
    for (int r = 1; r < NRED; ++r) v += red[(r * MP + m) * BN + j];
    if (p.splits == 1)
      epilogue<XT>(p, m0 + m, n, v);
    else
      p.part[(static_cast<size_t>(s) * p.M + m0 + m) * p.N + n] = v;
  }
}

template <typename XT, int MP>
__host__ __device__ constexpr int stage_bytes() {
  return BK * WROW + MP * XRow<XT>::ELEMS * static_cast<int>(sizeof(XT));
}

// bf16 x: MT tiles of 8 rows of x, tensor cores.
template <int MT, bool ALIGNED>
__global__ void __launch_bounds__(THREADS) int8_matmul_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int MP = MT * 8;
  constexpr int STAGE = stage_bytes<bf16, MP>();
  constexpr int XE = XRow<bf16>::ELEMS;
  const int n0 = blockIdx.x * BN;
  const int s = blockIdx.y;
  const int t0 = s * p.tiles_per_split;
  const int nt = min(p.tiles_per_split, p.k_tiles - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ch = warp & 1, kh = warp >> 1;  // the warp's 64 columns, its k half
  const int cw = ch * 16 + g;               // its A rows' column words

  float acc[4][MT][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][mt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nt) load_stage<bf16, MP, ALIGNED>(p, smem + i * STAGE, t0 + i, n0, 0);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const uint8_t* st = smem + (i % STAGES) * STAGE;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const bf16* xs = reinterpret_cast<const bf16*>(st + BK * WROW);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kb = kh * (BK / 2) + ks * 16;
      const int r0 = kb + 2 * tg;
      // Words (4 adjacent columns) of k rows r0, r0+1, r0+8, r0+9 at the
      // warp's column words g (columns 4g..4g+3) and g + 8 (4g+32..4g+35).
      uint32_t wv[8];
      wv[0] = ws[r0 * WWORDS + cw];
      wv[1] = ws[(r0 + 1) * WWORDS + cw];
      wv[2] = ws[r0 * WWORDS + cw + 8];
      wv[3] = ws[(r0 + 1) * WWORDS + cw + 8];
      wv[4] = ws[(r0 + 8) * WWORDS + cw];
      wv[5] = ws[(r0 + 9) * WWORDS + cw];
      wv[6] = ws[(r0 + 8) * WWORDS + cw + 8];
      wv[7] = ws[(r0 + 9) * WWORDS + cw + 8];
      uint32_t a[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        a[t][0] = i8_pair_bf16(wv[0], wv[1], t);  // A row g,     k r0, r0+1
        a[t][1] = i8_pair_bf16(wv[2], wv[3], t);  // A row g + 8, k r0, r0+1
        a[t][2] = i8_pair_bf16(wv[4], wv[5], t);  // A row g,     k r0+8, r0+9
        a[t][3] = i8_pair_bf16(wv[6], wv[7], t);  // A row g + 8, k r0+8, r0+9
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* xr = xs + (mt * 8 + g) * XE + r0;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_bf16(acc[t][mt], a[t], b0, b1);
      }
    }
    if (i + STAGES - 1 < nt)
      load_stage<bf16, MP, ALIGNED>(p, smem + ((i + STAGES - 1) % STAGES) * STAGE,
                                    t0 + i + STAGES - 1, n0, 0);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // C fragment: rows g, g+8 of tile t are the warp's columns 4g+t and
  // 4g+32+t; its columns 2tg, 2tg+1 of m tile mt are x rows mt*8 + 2tg (+1).
  float* red = reinterpret_cast<float*>(smem);  // [2 k halves][MP][BN]
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = mt * 8 + 2 * tg;
      const int na = ch * 64 + 4 * g + t, nb = na + 32;
      float* rw = red + kh * MP * BN;
      rw[m * BN + na] = acc[t][mt][0];
      rw[(m + 1) * BN + na] = acc[t][mt][1];
      rw[m * BN + nb] = acc[t][mt][2];
      rw[(m + 1) * BN + nb] = acc[t][mt][3];
    }
  __syncthreads();
  finish<bf16, MP, 2>(p, red, n0, 0, s);
}

// f32 x: 8 rows of x per block (grid z), FMAs on the CUDA cores. Thread
// (k-lane kl, column word cw) sums k rows kl, kl + 4, ... of each tile.
template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS) int8_matmul_f32_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int MP = F32_ROWS;
  constexpr int STAGE = stage_bytes<float, MP>();
  constexpr int XE = XRow<float>::ELEMS;
  constexpr int LANES = THREADS / (BN / 4);  // k-lanes: 4
  const int n0 = blockIdx.x * BN;
  const int s = blockIdx.y;
  const int m0 = blockIdx.z * MP;
  const int t0 = s * p.tiles_per_split;
  const int nt = min(p.tiles_per_split, p.k_tiles - t0);
  const int cw = threadIdx.x % (BN / 4), kl = threadIdx.x / (BN / 4);

  float acc[MP][4];
#pragma unroll
  for (int m = 0; m < MP; ++m)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[m][b] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nt) load_stage<float, MP, ALIGNED>(p, smem + i * STAGE, t0 + i, n0, m0);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const uint8_t* st = smem + (i % STAGES) * STAGE;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const float* xs = reinterpret_cast<const float*>(st + BK * WROW);
#pragma unroll 4
    for (int k = kl; k < BK; k += LANES) {
      const uint32_t wv = ws[k * WWORDS + cw] ^ 0x80808080u;
      float wf[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) wf[b] = i8_to_f32(wv, b);
#pragma unroll
      for (int m = 0; m < MP; ++m) {
        const float xv = xs[m * XE + k];
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[m][b] = fmaf(xv, wf[b], acc[m][b]);
      }
    }
    if (i + STAGES - 1 < nt)
      load_stage<float, MP, ALIGNED>(p, smem + ((i + STAGES - 1) % STAGES) * STAGE,
                                     t0 + i + STAGES - 1, n0, m0);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [LANES][MP][BN]
#pragma unroll
  for (int m = 0; m < MP; ++m)
#pragma unroll
    for (int b = 0; b < 4; ++b) red[(kl * MP + m) * BN + 4 * cw + b] = acc[m][b];
  __syncthreads();
  finish<float, MP, LANES>(p, red, n0, m0, s);
}

// Sum the split partials in split order, then the epilogue.
template <typename XT>
__global__ void __launch_bounds__(MERGE_THREADS) int8_matmul_merge_kernel(const Params p) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * MERGE_THREADS + threadIdx.x;
  const size_t mn = static_cast<size_t>(p.M) * p.N;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partials are complete
  if (idx >= mn) return;
  float v = p.part[idx];
  for (int s = 1; s < p.splits; ++s) v += p.part[s * mn + idx];
  epilogue<XT>(p, static_cast<int>(idx / p.N), static_cast<int>(idx % p.N), v);
}

// ---- the tied head: w [N, K] int8, contiguous along K -------------------------

constexpr int T_WARPS = 8;
constexpr int T_THREADS = T_WARPS * 32;
constexpr int T_GROUPS = 2;                      // 16-row A tiles per warp
constexpr int T_ROWS = T_WARPS * 16 * T_GROUPS;  // rows of w per block
constexpr int T_MROWS = 8;                       // x rows per block (grid y)
constexpr int T_KSTEP = 64;                      // k per step (16 bytes a thread)
constexpr int T_XBYTES = 96 * 1024;              // shared memory for x per chunk

// Bytes 2h and 2h + 1 of w -> a packed bf16 pair (byte 2h in the low half),
// exactly, as i8_pair_bf16 does.
__device__ __forceinline__ uint32_t i8_adj_bf16(uint32_t w, int h) {
  const uint32_t pair = __byte_perm(w, 0u, h ? 0x4342u : 0x4140u);
  const uint32_t mag = (pair & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (pair & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(mag), "r"(off));
  return r;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// 16 bytes of row n of w from k (zeros past N or K).
template <bool ALIGNED>
__device__ __forceinline__ uint4 load_row16(const Params& p, int n, int k) {
  if (n >= p.N) return make_uint4(0, 0, 0, 0);
  const int8_t* src = p.w + static_cast<size_t>(n) * p.K + k;
  if constexpr (ALIGNED) {
    if (k >= p.K) return make_uint4(0, 0, 0, 0);
    return __ldcs(reinterpret_cast<const uint4*>(src));
  } else {
    uint32_t wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k + 4 * q + b < p.K) v |= static_cast<uint32_t>(static_cast<uint8_t>(src[4 * q + b])) << (8 * b);
      wv[q] = v;
    }
    return make_uint4(wv[0], wv[1], wv[2], wv[3]);
  }
}

// x rows m0 .. m0 + rows - 1, k kc0 .. kc0 + kpad - 1, into xs [rows][xstride]
// (zeros past M or K).
template <typename XT>
__device__ __forceinline__ void stage_x(const Params& p, XT* xs, int xstride, int m0, int rows,
                                        int kc0, int kpad) {
  const XT* x = static_cast<const XT*>(p.x);
  for (int c = threadIdx.x; c < rows * kpad; c += T_THREADS) {
    const int m = c / kpad, j = c % kpad;
    const int k = kc0 + j;
    xs[m * xstride + j] =
        (m0 + m < p.M && k < p.K) ? x[static_cast<size_t>(m0 + m) * p.K + k] : from_f<XT>(0.f);
  }
}

// bf16 x: MT tiles of 8 x rows, all in the block.
template <int MT, bool ALIGNED>
__global__ void __launch_bounds__(T_THREADS) int8_matmul_t_bf16_kernel(const Params p, int kc) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  const int xstride = kc + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int nw = blockIdx.x * T_ROWS + warp * 16 * T_GROUPS;
  float acc[MT][T_GROUPS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < T_GROUPS; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][r][e] = 0.f;

  for (int kc0 = 0; kc0 < p.K; kc0 += kc) {
    const int kpad = (min(kc, p.K - kc0) + T_KSTEP - 1) / T_KSTEP * T_KSTEP;
    __syncthreads();  // the previous chunk's readers are done
    stage_x<bf16>(p, xs, xstride, 0, MT * 8, kc0, kpad);
    __syncthreads();
    uint4 cur[T_GROUPS][2], nxt[T_GROUPS][2];
#pragma unroll
    for (int r = 0; r < T_GROUPS; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        cur[r][h] = load_row16<ALIGNED>(p, nw + 16 * r + 8 * h + g, kc0 + 16 * tg);
    for (int ks = 0; ks < kpad; ks += T_KSTEP) {
      if (ks + T_KSTEP < kpad) {
#pragma unroll
        for (int r = 0; r < T_GROUPS; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            nxt[r][h] = load_row16<ALIGNED>(p, nw + 16 * r + 8 * h + g,
                                            kc0 + ks + T_KSTEP + 16 * tg);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[T_GROUPS][4];
#pragma unroll
        for (int r = 0; r < T_GROUPS; ++r) {
          const uint32_t lo = word_of(cur[r][0], s), hi = word_of(cur[r][1], s);
          a[r][0] = i8_adj_bf16(lo, 0);
          a[r][1] = i8_adj_bf16(hi, 0);
          a[r][2] = i8_adj_bf16(lo, 1);
          a[r][3] = i8_adj_bf16(hi, 1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint2 xv = *reinterpret_cast<const uint2*>(xs + (mt * 8 + g) * xstride + ks +
                                                           16 * tg + 4 * s);
#pragma unroll
          for (int r = 0; r < T_GROUPS; ++r) mma_bf16(acc[mt][r], a[r], xv.x, xv.y);
        }
      }
#pragma unroll
      for (int r = 0; r < T_GROUPS; ++r) {
        cur[r][0] = nxt[r][0];
        cur[r][1] = nxt[r][1];
      }
    }
  }
  // C fragment: rows g, g + 8 of tile r are rows of w; columns 2tg, 2tg + 1
  // are x rows of m tile mt.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < T_GROUPS; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = nw + 16 * r + g + 8 * (e >> 1), m = mt * 8 + 2 * tg + (e & 1);
        if (n < p.N && m < p.M) epilogue<bf16>(p, m, n, acc[mt][r][e]);
      }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(T_THREADS) int8_matmul_t_f32_kernel(const Params p, int kc) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* xs = reinterpret_cast<float*>(smem);
  const int xstride = kc + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * T_MROWS;
  const int nw = blockIdx.x * T_ROWS + warp * 16 * T_GROUPS;
  constexpr int R = T_GROUPS * 2;  // rows per thread: g + 8i
  float acc[R][T_MROWS];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int m = 0; m < T_MROWS; ++m) acc[i][m] = 0.f;

  for (int kc0 = 0; kc0 < p.K; kc0 += kc) {
    const int kpad = (min(kc, p.K - kc0) + T_KSTEP - 1) / T_KSTEP * T_KSTEP;
    __syncthreads();
    stage_x<float>(p, xs, xstride, m0, T_MROWS, kc0, kpad);
    __syncthreads();
    for (int ks = 0; ks < kpad; ks += T_KSTEP) {
      uint4 w[R];
#pragma unroll
      for (int i = 0; i < R; ++i) w[i] = load_row16<ALIGNED>(p, nw + 8 * i + g, kc0 + ks + 16 * tg);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wf[R][4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const uint32_t biased = word_of(w[i], q) ^ 0x80808080u;
#pragma unroll
          for (int b = 0; b < 4; ++b) wf[i][b] = i8_to_f32(biased, b);
        }
#pragma unroll
        for (int m = 0; m < T_MROWS; ++m) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + m * xstride + ks + 16 * tg + 4 * q);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            float a = acc[i][m];
            a = fmaf(xv.x, wf[i][0], a);
            a = fmaf(xv.y, wf[i][1], a);
            a = fmaf(xv.z, wf[i][2], a);
            a = fmaf(xv.w, wf[i][3], a);
            acc[i][m] = a;
          }
        }
      }
    }
  }
  // The four k lanes (tg) of a row, added in a fixed tree; lane tg then
  // writes x rows 2tg and 2tg + 1.
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int m = 0; m < T_MROWS; ++m) {
      float v = acc[i][m];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      acc[i][m] = v;
    }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = nw + 8 * i + g;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int mm = 2 * tg + j, m = m0 + mm;
      float v = acc[i][0];
#pragma unroll
      for (int t = 1; t < T_MROWS; ++t)
        if (t == mm) v = acc[i][t];
      if (n < p.N && m < p.M) epilogue<float>(p, m, n, v);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem_bytes, cudaStream_t st, const Params& p) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, THREADS, smem_bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_merge(const Params& p, cudaStream_t st) {
  const size_t mn = static_cast<size_t>(p.M) * p.N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((mn + MERGE_THREADS - 1) / MERGE_THREADS));
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_matmul_merge_kernel<XT>, p);
}

template <int MT>
cudaError_t launch_bf16(const Params& p, dim3 grid, bool aligned, cudaStream_t st) {
  const int smem = STAGES * stage_bytes<bf16, MT * 8>();
  return aligned ? launch(int8_matmul_bf16_kernel<MT, true>, grid, smem, st, p)
                 : launch(int8_matmul_bf16_kernel<MT, false>, grid, smem, st, p);
}

}  // namespace

extern "C" {

// Launch y = epilogue(x @ w) on `stream`: the split kernel, then the merge
// kernel when splits > 1; returns a cudaError_t (0 = launched). x [M, K]
// (x_dtype 0 f32, 1 bf16), w [K, N] int8, scale [N] (scale_dtype 0 f32,
// 1 bf16), out [M, N] (f32 when out_f32, else x's dtype), part f32
// [splits, M, N] scratch (splits > 1 only). splits cuts K's 128-row tiles
// into contiguous ranges of ceil(tiles / splits), none empty. No
// synchronisation, no allocation.
int dtpu_int8_matmul(const void* x, const void* w, const void* scale, void* out, void* part,
                     int x_dtype, int scale_dtype, int out_f32, int M, int K, int N, int splits,
                     void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int k_tiles = (K + BK - 1) / BK;
  if (M < 0 || M > MAX_M || K <= 0 || N < 0 || splits < 1 || splits > k_tiles ||
      splits > 65535 || (x_dtype != DT_F32 && x_dtype != DT_BF16) ||
      (scale_dtype != DT_F32 && scale_dtype != DT_BF16) || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const int tps = (k_tiles + splits - 1) / splits;
  if ((splits - 1) * tps >= k_tiles) return cudaErrorInvalidValue;  // an empty split
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.scale = scale;
  p.out = out;
  p.part = static_cast<float*>(part);
  p.M = M;
  p.K = K;
  p.N = N;
  p.scale_bf16 = scale_dtype == DT_BF16;
  p.out_f32 = out_f32 != 0;
  p.splits = splits;
  p.tiles_per_split = tps;
  p.k_tiles = k_tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = N % 16 == 0 && K % (x_dtype == DT_BF16 ? 8 : 4) == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 groups((N + BN - 1) / BN, splits, 1);
  cudaError_t err;
  if (x_dtype == DT_BF16) {
    const int mt = (M + 7) / 8;
    if (mt <= 1)
      err = launch_bf16<1>(p, groups, aligned, st);
    else if (mt <= 2)
      err = launch_bf16<2>(p, groups, aligned, st);
    else if (mt <= 4)
      err = launch_bf16<4>(p, groups, aligned, st);
    else
      err = launch_bf16<8>(p, groups, aligned, st);
  } else {
    const dim3 grid(groups.x, splits, (M + F32_ROWS - 1) / F32_ROWS);
    const int smem = STAGES * stage_bytes<float, F32_ROWS>();
    err = aligned ? launch(int8_matmul_f32_kernel<true>, grid, smem, st, p)
                  : launch(int8_matmul_f32_kernel<false>, grid, smem, st, p);
  }
  if (err != cudaSuccess || splits == 1) return err;
  return x_dtype == DT_BF16 ? launch_merge<bf16>(p, st) : launch_merge<float>(p, st);
}

// Launch y = epilogue(x @ w^T) on `stream` for w [N, K] int8 contiguous along
// K (the tied embedding [V, D] as stored); x, scale, out and the dtypes as
// for dtpu_int8_matmul. One kernel, no scratch; returns a cudaError_t.
int dtpu_int8_matmul_t(const void* x, const void* w, const void* scale, void* out, int x_dtype,
                       int scale_dtype, int out_f32, int M, int K, int N, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (M < 0 || M > MAX_M || K <= 0 || N < 0 || (x_dtype != DT_F32 && x_dtype != DT_BF16) ||
      (scale_dtype != DT_F32 && scale_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  Params p = {};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.scale = scale;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.scale_bf16 = scale_dtype == DT_BF16;
  p.out_f32 = out_f32 != 0;
  const bool bf16x = x_dtype == DT_BF16;
  const int xsize = bf16x ? 2 : 4;
  // bf16: every x row in the block (m tiles of 8: 1, 2, 4 or 8); f32: 8 rows
  // per block, grid y over the rest.
  const int mt = (M + 7) / 8;
  const int mtiles = !bf16x ? 1 : mt <= 1 ? 1 : mt <= 2 ? 2 : mt <= 4 ? 4 : 8;
  const int rows = mtiles * T_MROWS;
  // x chunk width: all of K when it fits the budget, else the largest
  // multiple of the k step that does.
  const int kmax = (T_XBYTES / (rows * xsize) - 4) / T_KSTEP * T_KSTEP;
  const int kc = min((K + T_KSTEP - 1) / T_KSTEP * T_KSTEP, kmax);
  const int smem = rows * (kc + 4) * xsize;
  const bool aligned = K % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + T_ROWS - 1) / T_ROWS, bf16x ? 1 : (M + T_MROWS - 1) / T_MROWS, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) -> cudaError_t {
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, T_THREADS, smem, st>>>(p, kc);
    return cudaGetLastError();
  };
  if (!bf16x)
    return aligned ? go(int8_matmul_t_f32_kernel<true>) : go(int8_matmul_t_f32_kernel<false>);
  switch (mtiles) {
    case 1:
      return aligned ? go(int8_matmul_t_bf16_kernel<1, true>)
                     : go(int8_matmul_t_bf16_kernel<1, false>);
    case 2:
      return aligned ? go(int8_matmul_t_bf16_kernel<2, true>)
                     : go(int8_matmul_t_bf16_kernel<2, false>);
    case 4:
      return aligned ? go(int8_matmul_t_bf16_kernel<4, true>)
                     : go(int8_matmul_t_bf16_kernel<4, false>);
    default:
      return aligned ? go(int8_matmul_t_bf16_kernel<8, true>)
                     : go(int8_matmul_t_bf16_kernel<8, false>);
  }
}

const char* dtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
