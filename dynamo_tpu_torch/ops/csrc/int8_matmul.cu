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
// It computes, for x [M, K] (bf16 or f32), w [K, N] int8 in the JAX layout
// (contiguous along N) and scale [N] (f32 or bf16):
//   acc[m, n] = sum_k x[m, k] * w[k, n]          (f32 accumulation)
//   layers (out in x's dtype):  y = rx( rx(acc) * rx(scale[n]) )
//   logits (out f32):           y = f32( rx(acc) ) * f32(scale[n])
// where rx rounds to x's dtype (round to nearest even; identity for f32):
// the rounding points of the JAX functions.
//
// Four entries, chosen by the wrapper from shapes alone (ops/int8_matmul.py
// `route`): the decode kernel (dtpu_int8_matmul: M <= 8 rows of bf16 x, and
// f32 x or unaligned shapes up to 64 rows), the wide entry
// (dtpu_int8_matmul_wide: bf16 x of more than 8 rows, any count), and for
// the tied head the tied wgmma entry (dtpu_int8_matmul_tw: bf16 x, any
// count) and the first tied entry (dtpu_int8_matmul_t: f32 x, and bf16
// shapes the wgmma entry refuses, up to 64 rows).
//
// The decode kernel. Bound on this card (H100 SXM, 3.35 TB/s HBM): at decode
// batch sizes the product does 2*M operations per weight byte, far below the
// ~295 operations per byte the tensor cores need to be the limit, so it is
// bound by reading K*N weight bytes once. The design streams them once:
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
//   N % 16, or an unaligned pointer) stage the same tiles with plain loads,
//   and so do bf16 calls of more than 8 rows (aligned ones take the wide
//   entry).
//
// The first tied entry (dtpu_int8_matmul_t): llama-1b and llama-3b take
// their logits from the int8 embedding [V, D] used transposed, so w arrives
// as [N, K] contiguous along K, with the same scale [N], epilogue and
// rounding points. Bound the same way (V*D bytes, 394 MB at llama-3b). It
// serves f32 x, and bf16 x whose K or embedding address TMA refuses (plain
// loads), up to 64 rows; the tied wgmma entry below takes the rest. Each warp owns
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
// The wide entry (int8_matmul_wide_kernel): bf16 x of more than 8 rows,
// decode buckets of 32-256 rows, verify passes (B x S1 rows) and prefill
// chunks. Bytes bound up to ~148 rows (2*M operations per weight byte), then
// operations bound, so it needs both the weight stream of the decode kernel
// and the tensor cores' full rate, which on Hopper only wgmma gives:
// - It computes y^T = w^T x^T: the weights are wgmma's A (64 output
//   columns per warpgroup, wgmma's M), x's rows its N, in row tiles of 16,
//   32, 64, 128 or 256 chosen by the wrapper from M (grid z walks tiles of
//   256 past that), K in steps of 16.
// - A comes from registers: each thread converts the int8 bytes of its A
//   fragment to bf16 with the byte permute above (exact), straight into the
//   m16n8k16 A layout wgmma takes per warp. One conversion feeds every row
//   of the tile; no bf16 copy of w exists anywhere. A warp's rows g and g + 8
//   are made adjacent columns (2g, 2g + 1), so one 32-bit shared-memory word
//   per k row holds both, and the two warps' 16-byte chunks sit in distinct
//   banks under the swizzle below.
// - B (x's tile, K-major) is read by wgmma from shared memory through a
//   descriptor of the 128-byte swizzle.
// - A block is two consumer warpgroups (128 columns) and one producer warp,
//   one block per SM. The producer's one thread keeps a ring of 5-16
//   stages (64 k rows: 8 KB of weights and the x tile; deeper for small
//   row tiles, about 200 KB in all) full with two TMA tensor copies per stage
//   (tensor maps encoded per call on the host, passed __grid_constant__;
//   the 128-byte swizzle on both; the hardware zero-fills past M, K and N),
//   completed on a "full" mbarrier; each consumer warp arrives on the
//   stage's "empty" mbarrier when its wgmmas are done with it. The two
//   warpgroups overlap each other's conversions and products.
// - Stages and blocks per SM are fixed at compile time (WideCfg's shared
//   memory, __launch_bounds__), and the wrapper's split plan reads the
//   same number (its WIDE_BLOCKS_PER_SM; dtpu_int8_wide_blocks_per_sm
//   reports the built kernel's occupancy). Splits of K keep a call within
//   one wave of one block per SM, which the card ran faster than two per
//   SM (PERF.md): a split's f32 partials cost bytes. The partials go
//   through the ordered merge kernel below, no atomics, so a repeat gives
//   the same bits, inside CUDA graphs too.
// - x is staged by TMA too (the swizzle wgmma's descriptor reads is TMA's),
//   and the weight tile takes TMA's 128-byte swizzle rather than padded
//   rows (a TMA box cannot pad); a thread's reads hit distinct banks all
//   the same.
//
// The tied wgmma entry (int8_matmul_tied_wide_kernel): bf16 x of any row
// count against the [N, K] embedding as stored: the logits of every decode
// bucket, verify pass and prefill. Bytes bound up to ~148 rows, then
// operations bound, as the wide entry is, and built the same way: y^T =
// emb . x^T, the embedding wgmma's A (converted in registers), x's rows its
// N (row tiles of 8, 16, 32, 64, 128 or 256; past 256 rows, of 128 or 256,
// whichever pads fewer: the wrapper's tied_plan), one producer warp keeping a
// ring of 5-16 stages of TMA copies full, two consumer warpgroups of 64
// embedding rows each. What differs:
// - The embedding is K-major as stored, so a stage's weight tile is a
//   [128 rows x 64 bytes] TMA box with no swizzle: a quarter-warp's 16-byte
//   reads cover two adjacent 64-byte rows, every bank once. A thread reads
//   16 contiguous bytes of each of its two rows per stage.
// - An A fragment wants k pairs 2tg (+1) and 2tg + 8 (+9) of a k16 step,
//   which in a K-major int8 row are not one 32-bit word. Of the two ways
//   out (consumers reading 16-bit halves, or x written once in a matching
//   k order) this entry takes the second: a small kernel first writes x
//   into a scratch xp [Mp, Kp] in the first tied entry's permuted order
//   (inside each 64-wide k block, position 16 s + 8 h + 2 c + l holds
//   k = 16 c + 4 s + 2 h + l), so thread tg's 16 bytes hold its fragments
//   for all four k16 steps of the stage, two 16-byte shared-memory reads
//   per stage in place of sixteen 2-byte ones. A dot product does not
//   depend on the order of its terms. The copy is about M x K x 2 bytes
//   (0.8 MB at 128 rows of llama-3b, against a 394 MB embedding); the main
//   kernel is a programmatic dependent launch behind it, its producer
//   waiting on griddepcontrol before its first x copy. xp's rows run to a
//   whole row tile, zeros past M, so no x box reaches out of bounds (on the
//   H100, boxes half out of bounds made the call slower).
// - The grid is persistent: one block per SM walks column tiles (and row
//   tiles past 256 rows, all row tiles of a column tile in turn, so the
//   embedding's tile is read once from HBM and again from L2), and the
//   producer's ring runs on across tiles, so a tile's epilogue overlaps the
//   next tile's loads. No split of K: each output is one thread's sum over
//   K in a fixed order, so repeats are bit-identical, inside CUDA graphs
//   too, with no partials and no merge.
// - Outputs are written straight from the accumulators with the epilogue
//   above, masked past N and M (TMA zero-fills the embedding past N and K).
//
// Not taken here (ROADMAP): fusing wq/wk/wv into one call, a persistent
// grid for the wide entry.

#include <cuda.h>
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

__device__ __forceinline__ float scale_at(const Params& p, int n) {
  return p.scale_bf16 ? __bfloat162float(static_cast<const bf16*>(p.scale)[n])
                      : static_cast<const float*>(p.scale)[n];
}

// y[m, n] from the f32 sum and column n's scale s.
template <typename XT>
__device__ __forceinline__ void store_scaled(const Params& p, int m, int n, float acc, float s) {
  const float r = round_x<XT>(acc);
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.out_f32)
    static_cast<float*>(p.out)[o] = r * s;
  else
    static_cast<XT*>(p.out)[o] = from_f<XT>(r * round_x<XT>(s));
}

template <typename XT>
__device__ __forceinline__ void epilogue(const Params& p, int m, int n, float acc) {
  store_scaled<XT>(p, m, n, acc, scale_at(p, n));
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

// bf16 x: MT tiles of 8 x rows, all in the block. Only shapes the tied
// wgmma entry refuses come here (K % 16 or the embedding's address), so the
// weights come through plain loads.
template <int MT>
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
        cur[r][h] = load_row16<false>(p, nw + 16 * r + 8 * h + g, kc0 + 16 * tg);
    for (int ks = 0; ks < kpad; ks += T_KSTEP) {
      if (ks + T_KSTEP < kpad) {
#pragma unroll
        for (int r = 0; r < T_GROUPS; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            nxt[r][h] = load_row16<false>(p, nw + 16 * r + 8 * h + g,
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

// ---- the wide entry: bf16 x, more than 8 rows; wgmma, TMA, mbarriers -------------

constexpr int W_BN = 128;                       // output columns per block
constexpr int W_BK = 64;                        // k rows per stage (128 bytes of an x row)
constexpr int W_CONSUMERS = 2;                  // warpgroups, 64 columns each
constexpr int W_THREADS = W_CONSUMERS * 128 + 32;  // and one producer warp
constexpr int W_WBYTES = W_BK * W_BN;           // a stage's weight tile

// Stages per row tile (wgmma's N): a stage is 8 KB of weights and NR x 128
// bytes of x, and each row tile's ring fills most of an SM's shared memory,
// so one block runs per SM (W_BLOCKS_PER_SM; __launch_bounds__ gives it
// the registers it wants). On the card one deep ring per SM streams the
// weights faster than two shallow ones, and the split plan then keeps a
// call's blocks to one per SM (the wrapper's WIDE_BLOCKS_PER_SM mirrors
// this; dtpu_int8_wide_blocks_per_sm reads the built kernel's occupancy).
constexpr int W_BLOCKS_PER_SM = 1;
template <int NR> struct WideCfg;
template <> struct WideCfg<16> { static constexpr int STAGES = 16; };
template <> struct WideCfg<32> { static constexpr int STAGES = 16; };
template <> struct WideCfg<64> { static constexpr int STAGES = 12; };
template <> struct WideCfg<128> { static constexpr int STAGES = 8; };
template <> struct WideCfg<256> { static constexpr int STAGES = 5; };

template <int NR>
__host__ __device__ constexpr int wide_stage_bytes() {
  return W_WBYTES + NR * W_BK * 2;
}
// Stages, their mbarriers (full and empty per stage) and the slack that
// aligns the ring to 1024 bytes (the 128-byte swizzle's period).
template <int NR>
__host__ __device__ constexpr int wide_smem_bytes() {
  return WideCfg<NR>::STAGES * (wide_stage_bytes<NR>() + 16) + 1024;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// One TMA box of `tm` at element coordinates (c0 innermost, c1) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* tm, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major bf16 tile of 128-byte rows
// written by TMA with the 128-byte swizzle (1024-byte aligned): 8-row groups
// 1024 bytes apart. Adding 2 advances it by one k16 step (32 bytes).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of `d` across an asynchronous
// wgmma's issue or its wait, and from computing a wgmma's register inputs
// (A fragments, descriptors) after the wgmmas start: ptxas serializes
// wgmmas whose inputs are defined inside their pipeline stage.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+f"(d[r])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+r"(d[r])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint64_t* d) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+l"(d[r])::"memory");
}

// d[64 x NR] += a (bf16, registers; the m16n8k16 A layout per warp) . b
// (bf16, shared memory through the descriptor), f32 accumulators.
template <int NR>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);
template <> __device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Layers (out in bf16) or logits (out f32) for x rows m and columns n, n + 1.
__device__ __forceinline__ void epilogue_pair(const Params& p, int m, int n, float v0,
                                              float v1) {
  float s0, s1;
  if (p.scale_bf16) {
    const __nv_bfloat162 s = *reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const bf16*>(p.scale) + n);
    s0 = __low2float(s);
    s1 = __high2float(s);
  } else {
    const float2 s = *reinterpret_cast<const float2*>(static_cast<const float*>(p.scale) + n);
    s0 = s.x;
    s1 = s.y;
  }
  const float r0 = round_x<bf16>(v0), r1 = round_x<bf16>(v1);
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.out_f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(r0 * s0, r1 * s1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + o) = __floats2bfloat162_rn(
        r0 * round_x<bf16>(s0), r1 * round_x<bf16>(s1));
  }
}

// Block (column block x, split y, row tile z): 128 columns from n0, x rows
// m0 .. m0 + NR - 1, the split's k tiles. Warps 0-7 are two consumer
// warpgroups (64 columns each), warp 8 the producer.
template <int NR>
__global__ void __launch_bounds__(W_THREADS, W_BLOCKS_PER_SM)
    int8_matmul_wide_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_w, const Params p) {
  constexpr int STAGES = WideCfg<NR>::STAGES;
  constexpr int STAGE = wide_stage_bytes<NR>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x * W_BN, s = blockIdx.y, m0 = blockIdx.z * NR;
  const int t0 = s * p.tiles_per_split;
  const int nt = min(p.tiles_per_split, p.k_tiles - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, W_CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W_CONSUMERS * 4) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < nt; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + st, (i / STAGES - 1) & 1);
        mbar_expect_tx(full + st, STAGE);
        const int k0 = (t0 + i) * W_BK;
        tma_load_2d(smem + st * STAGE, &tm_w, n0, k0, full + st);
        tma_load_2d(smem + st * STAGE + W_WBYTES, &tm_x, k0, m0, full + st);
      }
    }
    return;
  }

  // A row 16 wq + g of warpgroup q (rows g and g + 8 of the warp's m16
  // slice) is column 64 q + 16 wq + 2 g, and row 16 wq + g + 8 the column
  // after it: a thread's two columns are adjacent bytes of one 32-bit word
  // of each weight row, in the warp's 16-byte chunk 4 q + wq. TMA's swizzle
  // stores chunk j of row r at chunk j ^ (r & 7); a thread's k rows are
  // 16 ks + 2 tg (+1, +8, +9), so r & 7 is 2 tg or 2 tg + 1 at every step.
  const int q = warp >> 2, wq = warp & 3, g = lane >> 2, tg = lane & 3;
  const int chunk = 4 * q + wq;
  const int off_e = ((chunk ^ (2 * tg)) << 4) + (g >> 1) * 4;
  const int off_o = ((chunk ^ (2 * tg + 1)) << 4) + (g >> 1) * 4;
  const int b = 2 * (g & 1);  // byte of the first column in the word

  float acc[NR / 2];
#pragma unroll
  for (int r = 0; r < NR / 2; ++r) acc[r] = 0.f;

  // Per k tile: convert its weights into A fragments, issue its four
  // wgmmas and wait for them, then hand the stage back to the producer.
  // The two warpgroups overlap each other's conversions and products. (A
  // warpgroup converting its next tile while its wgmmas run needs a
  // second set of A registers written inside their pipeline stage, and
  // ptxas then serializes every wgmma: slower on the card.)
  for (int i = 0; i < nt; ++i) {
    const int st = i % STAGES;
    mbar_wait(full + st, (i / STAGES) & 1);
    const uint8_t* wt = smem + st * STAGE;
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint8_t* rb = wt + (16 * ks + 2 * tg) * W_BN;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rb + off_e);             // k r
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rb + W_BN + off_o);      // r + 1
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(rb + 8 * W_BN + off_e);  // r + 8
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(rb + 9 * W_BN + off_o);  // r + 9
      a[ks][0] = i8_pair_bf16(w0, w1, b);      // A row g,     k r, r + 1
      a[ks][1] = i8_pair_bf16(w0, w1, b + 1);  // A row g + 8, k r, r + 1
      a[ks][2] = i8_pair_bf16(w2, w3, b);      // A row g,     k r + 8, r + 9
      a[ks][3] = i8_pair_bf16(w2, w3, b + 1);  // A row g + 8, k r + 8, r + 9
    }
    uint64_t desc[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) desc[ks] = desc_sw128(wt + W_WBYTES) + 2 * ks;
    fence_regs<16>(&a[0][0]);
    fence_regs<4>(desc);
    fence_regs<NR / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<NR>(acc, a[ks], desc[ks]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NR / 2>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
  }

  // D fragment: rows g and g + 8 of the warp's slice are columns c and
  // c + 1; value 4 j + h (+ 2) is x row 8 j + 2 tg + h.
  const int c = n0 + 64 * q + 16 * wq + 2 * g;
  if (c >= p.N) return;
#pragma unroll
  for (int j = 0; j < NR / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * tg + h;
      if (m >= p.M) continue;
      const float v0 = acc[4 * j + h], v1 = acc[4 * j + 2 + h];
      if (p.splits == 1)
        epilogue_pair(p, m, c, v0, v1);
      else
        *reinterpret_cast<float2*>(p.part + (static_cast<size_t>(s) * p.M + m) * p.N + c) =
            make_float2(v0, v1);
    }
}

// ---- the tied head on wgmma: w [N, K] int8 as stored (K-major), bf16 x, any rows ----

constexpr int TW_BN = 128;              // embedding rows (output columns) per tile
constexpr int TW_BK = 64;               // k per stage: 64 bytes of each embedding row
constexpr int TW_WBYTES = TW_BN * TW_BK;  // a stage's weight tile
constexpr int TW_BLOCKS_PER_SM = 1;

// Stages per row tile (wgmma's N): a stage is 8 KB of weights and NR x 128
// bytes of x; each ring fills most of an SM's shared memory, one block per
// SM (the wrapper's TIED_BLOCKS_PER_SM; dtpu_int8_tied_blocks_per_sm reads
// the built kernel's occupancy).
template <int NR> struct TiedCfg;
template <> struct TiedCfg<8> { static constexpr int STAGES = 16; };
template <> struct TiedCfg<16> { static constexpr int STAGES = 16; };
template <> struct TiedCfg<32> { static constexpr int STAGES = 16; };
template <> struct TiedCfg<64> { static constexpr int STAGES = 12; };
template <> struct TiedCfg<128> { static constexpr int STAGES = 8; };
template <> struct TiedCfg<256> { static constexpr int STAGES = 5; };

template <int NR>
__host__ __device__ constexpr int tied_stage_bytes() {
  return TW_WBYTES + NR * TW_BK * 2;
}
template <int NR>
__host__ __device__ constexpr int tied_smem_bytes() {
  return TiedCfg<NR>::STAGES * (tied_stage_bytes<NR>() + 16) + 1024;
}

// x [M, K] -> xp [Mp, Kp] (Mp = M rounded up to the row tile, Kp = K to
// TW_BK) in the k order the tied entry's A fragments take the embedding's
// bytes in: inside each 64-wide k block, position 16 s + 8 h + 2 c + l
// holds x at k = 16 c + 4 s + 2 h + l (zeros past K and M, so no x box
// reaches out of bounds). One thread per 16 bytes of xp.
__global__ void __launch_bounds__(256) int8_tied_permute_x_kernel(const uint16_t* x, uint16_t* xp,
                                                                  int M, int Mp, int K, int Kp) {
  const size_t v = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  const int per_row = Kp / 8;
  if (v >= static_cast<size_t>(Mp) * per_row) return;
  const int m = static_cast<int>(v / per_row), c0 = static_cast<int>(v % per_row) * 8;
  const int k0 = (c0 & ~(TW_BK - 1)) + 4 * ((c0 >> 4) & 3) + 2 * ((c0 >> 3) & 1);
  const uint16_t* xr = x + static_cast<size_t>(m) * K;
  uint32_t w[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int k = k0 + 16 * c;
    const uint32_t lo = m < M && k < K ? xr[k] : 0u, hi = m < M && k + 1 < K ? xr[k + 1] : 0u;
    w[c] = lo | hi << 16;
  }
  *reinterpret_cast<uint4*>(xp + static_cast<size_t>(m) * Kp + c0) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// A persistent block walks tiles t = blockIdx.x, + gridDim.x, ...: tile t is
// embedding rows n0 = (t / row_tiles) * 128 on, x rows m0 = (t % row_tiles) *
// NR on, all of K. Warps 0-7 are two consumer warpgroups (64 rows each),
// warp 8 the producer, whose ring runs on across tile boundaries.
template <int NR>
__global__ void __launch_bounds__(W_THREADS, TW_BLOCKS_PER_SM)
    int8_matmul_tied_wide_kernel(const __grid_constant__ CUtensorMap tm_x,
                                 const __grid_constant__ CUtensorMap tm_w, const Params p,
                                 int row_tiles) {
  constexpr int STAGES = TiedCfg<NR>::STAGES;
  constexpr int STAGE = tied_stage_bytes<NR>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int tiles = (p.N + TW_BN - 1) / TW_BN * row_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, W_CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W_CONSUMERS * 4) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");  // xp is written
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = t / row_tiles * TW_BN, m0 = t % row_tiles * NR;
        for (int kt = 0; kt < p.k_tiles; ++kt, ++i) {
          const int st = i % STAGES;
          if (i >= STAGES) mbar_wait(empty + st, (i / STAGES - 1) & 1);
          mbar_expect_tx(full + st, STAGE);
          tma_load_2d(smem + st * STAGE, &tm_w, kt * TW_BK, n0, full + st);
          tma_load_2d(smem + st * STAGE + TW_WBYTES, &tm_x, kt * TW_BK, m0, full + st);
        }
      }
    }
    return;
  }

  // A rows g and g + 8 of warp wq in warpgroup q are embedding rows `row`
  // and row + 8 of the tile. A stage holds 64 contiguous bytes of each row
  // (no swizzle: a quarter-warp's two rows are 128 contiguous bytes, every
  // bank once); thread tg takes bytes 16 tg .. 16 tg + 15 of both rows, and
  // word s of them feeds k16 step s: bytes 4 s + {0, 1} are the fragment's
  // k pair 2 tg (+1), bytes 4 s + {2, 3} its pair 2 tg + 8 (+9). xp holds x
  // in that order, so wgmma's B reads it through the plain descriptor.
  const int q = warp >> 2, wq = warp & 3, g = lane >> 2, tg = lane & 3;
  const int row = 64 * q + 16 * wq + g;
  float acc[NR / 2];
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = t / row_tiles * TW_BN, m0 = t % row_tiles * NR;
#pragma unroll
    for (int r = 0; r < NR / 2; ++r) acc[r] = 0.f;
    for (int kt = 0; kt < p.k_tiles; ++kt, ++i) {
      const int st = i % STAGES;
      mbar_wait(full + st, (i / STAGES) & 1);
      const uint8_t* wt = smem + st * STAGE;
      const uint4 lo = *reinterpret_cast<const uint4*>(wt + row * TW_BK + 16 * tg);
      const uint4 hi = *reinterpret_cast<const uint4*>(wt + (row + 8) * TW_BK + 16 * tg);
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t lw = word_of(lo, s), hw = word_of(hi, s);
        a[s][0] = i8_adj_bf16(lw, 0);  // A row g,     k 2tg, 2tg + 1
        a[s][1] = i8_adj_bf16(hw, 0);  // A row g + 8, k 2tg, 2tg + 1
        a[s][2] = i8_adj_bf16(lw, 1);  // A row g,     k 2tg + 8, 2tg + 9
        a[s][3] = i8_adj_bf16(hw, 1);  // A row g + 8, k 2tg + 8, 2tg + 9
      }
      uint64_t desc[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) desc[s] = desc_sw128(wt + TW_WBYTES) + 2 * s;
      fence_regs<16>(&a[0][0]);
      fence_regs<4>(desc);
      fence_regs<NR / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_rs<NR>(acc, a[s], desc[s]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NR / 2>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
    }
    // D fragment: value 4 j + h is (A row g, x row 8 j + 2 tg + h), value
    // 4 j + 2 + h (A row g + 8, the same x row).
    const int n = n0 + row;
    const float s0 = n < p.N ? scale_at(p, n) : 0.f, s1 = n + 8 < p.N ? scale_at(p, n + 8) : 0.f;
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + 2 * tg + h;
        if (m >= p.M) continue;
        if (n < p.N) store_scaled<bf16>(p, m, n, acc[4 * j + h], s0);
        if (n + 8 < p.N) store_scaled<bf16>(p, m, n + 8, acc[4 * j + 2 + h], s1);
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
  // More than 8 rows of aligned bf16 x take the wide entry (the wrapper's
  // route): the tiles of 16-64 rows serve shapes that break its alignment,
  // and take any other call through the plain loads.
  if constexpr (MT == 1)
    if (aligned) return launch(int8_matmul_bf16_kernel<1, true>, grid, smem, st, p);
  return launch(int8_matmul_bf16_kernel<MT, false>, grid, smem, st, p);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(f)
                                                                : nullptr;
  }();
  return fn;
}

// A 2-D row-major tensor [rows, cols] of `elem`-byte values, boxes of
// [box_rows, box_cols] with `swizzle` (the 128-byte one unless named); zeros
// outside it.
bool tensor_map(CUtensorMap* tm, CUtensorMapDataType type, const void* base, int rows, int cols,
                int elem, int box_rows, int box_cols,
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(tm, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NR>
cudaError_t wide_attr() {
  return cudaFuncSetAttribute(int8_matmul_wide_kernel<NR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, wide_smem_bytes<NR>());
}

template <int NR>
cudaError_t launch_wide(const Params& p, const void* x, int row_tiles, cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  if (!tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, p.M, p.K, 2, NR, W_BK) ||
      !tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, p.K, p.N, 1, W_BK, W_BN))
    return cudaErrorNotSupported;
  const cudaError_t e = wide_attr<NR>();
  if (e != cudaSuccess) return e;
  const dim3 grid((p.N + W_BN - 1) / W_BN, p.splits, row_tiles);
  int8_matmul_wide_kernel<NR><<<grid, W_THREADS, wide_smem_bytes<NR>(), st>>>(tm_x, tm_w, p);
  return cudaGetLastError();
}

template <int NR>
int wide_occupancy() {
  if (wide_attr<NR>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, int8_matmul_wide_kernel<NR>, W_THREADS,
                                                    wide_smem_bytes<NR>()) != cudaSuccess)
    return -1;
  return n;
}

template <int NR>
cudaError_t tied_attr() {
  return cudaFuncSetAttribute(int8_matmul_tied_wide_kernel<NR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, tied_smem_bytes<NR>());
}

// The tied wgmma kernel on `blocks` persistent blocks, as a programmatic
// dependent launch behind the permute kernel (its producer waits for xp).
template <int NR>
cudaError_t launch_tied(const Params& p, const void* xp, int kp, int row_tiles, int blocks,
                        cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  if (!tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xp, row_tiles * NR, kp, 2, NR,
                  TW_BK) ||
      !tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, p.N, p.K, 1, TW_BN, TW_BK,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorNotSupported;
  const cudaError_t e = tied_attr<NR>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = tied_smem_bytes<NR>();
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_matmul_tied_wide_kernel<NR>, tm_x, tm_w, p, row_tiles);
}

template <int NR>
int tied_occupancy() {
  if (tied_attr<NR>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, int8_matmul_tied_wide_kernel<NR>,
                                                    W_THREADS, tied_smem_bytes<NR>()) != cudaSuccess)
    return -1;
  return n;
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
// for dtpu_int8_matmul. One kernel, no scratch; returns a cudaError_t. bf16
// x always takes plain loads here (aligned shapes take dtpu_int8_matmul_tw).
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
    case 1: return go(int8_matmul_t_bf16_kernel<1>);
    case 2: return go(int8_matmul_t_bf16_kernel<2>);
    case 4: return go(int8_matmul_t_bf16_kernel<4>);
    default: return go(int8_matmul_t_bf16_kernel<8>);
  }
}

// Launch y = epilogue(x @ w) for bf16 x [M, K] (M > 0 rows, any count) on
// `stream` through the wgmma entry: row tiles of `row_tile` rows (16, 32,
// 64, 128 or 256; grid z walks ceil(M / row_tile) of them), `splits`
// contiguous ranges of K's 64-row tiles (none empty), then the merge kernel
// when splits > 1. w [K, N] int8, scale [N] (scale_dtype 0 f32, 1 bf16),
// out [M, N] (f32 when out_f32, else bf16), part f32 [splits, M, N]
// scratch. Needs K % 8 == 0, N % 16 == 0 and 16-byte aligned x, w and
// scale (TMA's strides and the paired epilogue); returns a cudaError_t.
int dtpu_int8_matmul_wide(const void* x, const void* w, const void* scale, void* out, void* part,
                          int scale_dtype, int out_f32, int M, int K, int N, int row_tile,
                          int splits, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int k_tiles = (K + W_BK - 1) / W_BK;
  const int row_tiles = row_tile > 0 ? (M + row_tile - 1) / row_tile : 0;
  if (M < 0 || K <= 0 || N < 0 || K % 8 != 0 || N % 16 != 0 || splits < 1 ||
      splits > k_tiles || splits > 65535 || row_tiles > 65535 ||
      (scale_dtype != DT_F32 && scale_dtype != DT_BF16) || (splits > 1 && part == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16)
    return cudaErrorInvalidValue;
  const int tps = (k_tiles + splits - 1) / splits;
  if ((splits - 1) * tps >= k_tiles) return cudaErrorInvalidValue;  // an empty split
  Params p = {};
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
  cudaError_t err;
  switch (row_tile) {
    case 16: err = launch_wide<16>(p, x, row_tiles, st); break;
    case 32: err = launch_wide<32>(p, x, row_tiles, st); break;
    case 64: err = launch_wide<64>(p, x, row_tiles, st); break;
    case 128: err = launch_wide<128>(p, x, row_tiles, st); break;
    case 256: err = launch_wide<256>(p, x, row_tiles, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  return launch_merge<bf16>(p, st);
}

// Launch y = epilogue(x @ w^T) for bf16 x [M, K] (M > 0 rows, any count) and
// w [N, K] int8 contiguous along K (the tied embedding [V, D] as stored) on
// `stream` through the tied wgmma entry: first x into xp [Mp, Kp] (bf16
// scratch; Mp = M rounded up to row_tile, Kp = K to 64) in the entry's k
// order, then `blocks`
// persistent blocks over ceil(N / 128) x ceil(M / row_tile) tiles (row_tile
// 8, 16, 32, 64, 128 or 256). scale [N] (scale_dtype 0 f32, 1 bf16), out
// [M, N] (f32 when out_f32, else bf16). Needs K % 16 == 0 and 16-byte
// aligned w and xp (TMA's strides); N and x take any value. Returns a
// cudaError_t.
int dtpu_int8_matmul_tw(const void* x, const void* w, const void* scale, void* out, void* xp,
                        int scale_dtype, int out_f32, int M, int K, int N, int row_tile, int blocks,
                        void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int k_tiles = (K + TW_BK - 1) / TW_BK;
  const int kp = k_tiles * TW_BK;
  const int row_tiles = row_tile > 0 ? (M + row_tile - 1) / row_tile : 0;
  if (M < 0 || K <= 0 || N < 0 || K % 16 != 0 || blocks < 1 || blocks > 65535 ||
      (scale_dtype != DT_F32 && scale_dtype != DT_BF16) || xp == nullptr ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(xp) % 16 ||
      static_cast<long long>(row_tiles) * ((N + TW_BN - 1) / TW_BN) > INT32_MAX)
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
  p.k_tiles = k_tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t vecs = static_cast<size_t>(row_tiles) * row_tile * (kp / 8);
  int8_tied_permute_x_kernel<<<static_cast<unsigned>((vecs + 255) / 256), 256, 0, st>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(xp), M, row_tiles * row_tile, K,
      kp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (row_tile) {
    case 8: return launch_tied<8>(p, xp, kp, row_tiles, blocks, st);
    case 16: return launch_tied<16>(p, xp, kp, row_tiles, blocks, st);
    case 32: return launch_tied<32>(p, xp, kp, row_tiles, blocks, st);
    case 64: return launch_tied<64>(p, xp, kp, row_tiles, blocks, st);
    case 128: return launch_tied<128>(p, xp, kp, row_tiles, blocks, st);
    case 256: return launch_tied<256>(p, xp, kp, row_tiles, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

// Blocks of the tied wgmma entry one SM holds at `row_tile`, or -1.
int dtpu_int8_tied_blocks_per_sm(int row_tile) {
  switch (row_tile) {
    case 8: return tied_occupancy<8>();
    case 16: return tied_occupancy<16>();
    case 32: return tied_occupancy<32>();
    case 64: return tied_occupancy<64>();
    case 128: return tied_occupancy<128>();
    case 256: return tied_occupancy<256>();
    default: return -1;
  }
}

// Blocks of the wide entry one SM holds at `row_tile` (the occupancy the
// CUDA runtime computes from its shared memory and registers), or -1.
int dtpu_int8_wide_blocks_per_sm(int row_tile) {
  switch (row_tile) {
    case 16: return wide_occupancy<16>();
    case 32: return wide_occupancy<32>();
    case 64: return wide_occupancy<64>();
    case 128: return wide_occupancy<128>();
    case 256: return wide_occupancy<256>();
    default: return -1;
  }
}

const char* dtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
