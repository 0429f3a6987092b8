// Paged multi-query attention for Hopper (sm_90a), hand-written CUDA C++ (v3).
//
// Replaces: dynamo_tpu/ops/paged_attention.py `_mq_kernel` (:210, the Pallas
// TPU kernel driven by `_paged_attention_mq`, pl.pallas_call at :522). It
// computes the same function: for each batch row b and query column
// (t, kv head k, group g), an online-softmax attention over the row's true
// pages, read through block_tables[b]. Query t attends positions
// [0, lengths[b, t]); in tree mode it also attends in-flight slot s at
// position lengths[b, t] + s when anc[b, t, s] is set. int8 pages are
// dequantized with per-position, per-head f32 scales (widen to f32,
// multiply, round once to q's dtype: the Pallas kernel's rounding point,
// paged_attention.py:361-362). Rows of length 0 output zeros, and so does
// any query column that attends no position. A position that no query
// column attends is never loaded, so garbage or NaN there cannot reach a sum.
//
// Bound on this card (H100 SXM, 3.35 TB/s HBM): the call must read every
// attended K and V row of its head once, so its least time is
//   ( sum_b walk_b * KVH * hd * 2 * sizeof(page)   (K and V)
//   + sum_b walk_b * KVH * 4 * 2                   (int8 scales)
//   + 2 * B * T * KVH * G * hd * sizeof(q)         (q in, out)
//   + the partials' write and read-back: live splits * T*G * (hd + 2) * 4 * 2
//   ) / 3.35 TB/s.
// At decode shapes this is far below the card's operations-per-byte
// balance, so bytes bound it.
//
// v2 (grid (B, KVH), one block walking a whole row, five shuffles per
// position and column) reached ~1% of that bound (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md) for two reasons, and this design answers each:
//
// 1. Too few blocks: 64 blocks on 132 SMs, the longest row walked by one
//    block. v3 splits every row into chunks of whole pages (flash-decoding,
//    128 positions: the wrapper's split_plan). Grid (splits, KVH * passes,
//    B), with splits = ceil(W / chunk_pages) from the host-known table
//    width and never from `lengths`: no host sync, and the grid stays fixed
//    for a CUDA graph. A block whose chunk starts at or past its row's walk
//    exits at once and writes nothing: the merge derives each row's live
//    splits from the same walk and reads only those. Each live block writes
//    (m, l, acc[cols][hd]) in f32 to scratch the wrapper allocates. A second
//    kernel, grid (KVH * ceil(T*G / 4), B) with one warp per query column,
//    merges the live splits in split order: no float atomics, so every call
//    gives the same bits. It is a programmatic dependent launch, so it sets
//    up while the split kernel drains. A row whose walk fits one chunk is
//    written directly by its block, and the merge skips it.
// 2. A serial per-position instruction chain. v3 stages K/V tiles in shared
//    memory with cp.async 16-byte copies, zero-filled and not read where no
//    column attends. The ring holds 3 tiles on the tensor-core path, so a
//    whole chunk is in flight at once. Each warp issues its own rows
//    (coalesced, one page lookup per row). The kernel computes a tile at a
//    time:
//    - bf16 q (bf16 pages, or int8 pages dequantized to bf16 after landing):
//      scores and P.V on the tensor cores, mma.sync.m16n8k16 with f32
//      accumulation. The G*T query rows of the head fill M (16 per m-tile).
//      Each warp owns 16 positions of a 64-position tile. The online softmax
//      runs per 16 positions, with the row max and sum over the quad that
//      holds a row and the mask as one 16-bit word per row. The softmax
//      scale multiplies the f32 scores: q is used as given, because its bf16
//      product with 1/sqrt(hd) would round. P enters the bf16 product as
//      P_hi + P_lo (two products), which keeps P.V near f32.
//    - f32 q (f32 pages, or int8 pages dequantized to f32): f32 arithmetic on
//      the CUDA cores. Each lane owns one position of a 32-position tile and
//      each warp a set of query columns read from shared memory. The softmax
//      takes one warp max per column per tile, and P.V reads P through
//      shared memory with each lane owning hd/32 output elements.
//    Widths 64, 128 and 256 compile exactly. Other multiples of 32 run the
//    next width's kernel and test the width at run time.
//
// Not taken here (ROADMAP): TMA page copies with mbarriers, wgmma, warp
// specialisation, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_HD = 256;
constexpr int MAX_T = 64;              // tree bits ride a 64-bit mask per query
constexpr int MAX_CHUNK_PAGES = 256;   // pages per split (the wrapper's plan)
constexpr int F32_COLS = 32;           // query columns per block pass, f32 path
constexpr int F32_CPW = F32_COLS / WARPS;
constexpr float LOG2E = 1.4426950408889634f;

enum Dtype { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

using bf16 = __nv_bfloat16;
using u64 = unsigned long long;

struct Params {
  const void* q;              // [B, T, KVH, G, hd]
  const void* kc;             // layer slice [N, bs, KVH*hd]
  const void* vc;
  const float* ks;            // layer slice [N, bs, KVH] (int8 pages only)
  const float* vs;
  const int* tables;          // [B, W]
  const int* lengths;         // [B, T]
  const int8_t* anc;          // [B, T, T] (tree only, else null)
  void* out;                  // [B, T, KVH, G, hd]
  float* part_acc;            // [B, KVH, splits, nq, hd] (splits > 1)
  float2* part_ml;            // [B, KVH, splits, nq] (m, l)
  int T, KVH, G, hd, N, bs, W, chunk_pages, splits, nq, rows_per_pass;
  unsigned bs_magic;          // ceil(2^32 / bs): n / bs = umulhi(n, bs_magic) for n * bs < 2^32
  float c;                    // softmax scale * log2(e)
};

template <typename QT> __device__ __forceinline__ QT from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global → shared; when !pred nothing is read and the
// destination is filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a · b, m16n8k16, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 2^x in one MUFU op (max relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Does a query column with history horizon `len` and ancestor bits `anc`
// attend position `pos`? (Tree slot s sits at len + s; anc is 0 outside
// tree mode.)
__device__ __forceinline__ bool attends(int pos, int len, u64 anc) {
  const unsigned s = static_cast<unsigned>(pos - len);
  return (pos < len) | ((s < 64u) & static_cast<bool>((anc >> (s & 63u)) & 1ull));
}

// Bit k: does the column attend position pos0 + k (k < 16, and pos0 + k < c_hi)?
__device__ __forceinline__ unsigned attend_mask16(int pos0, int len, u64 anc, int c_hi) {
  const int nh = min(max(len - pos0, 0), 16);  // history positions
  const int s0 = pos0 - len;                   // tree slot of pos0
  const u64 tree = s0 >= 0 ? (s0 < 64 ? anc >> s0 : 0ull) : (s0 > -16 ? anc << -s0 : 0ull);
  const int nc = min(max(c_hi - pos0, 0), 16);  // positions inside the chunk
  return (((1u << nh) - 1u) | static_cast<unsigned>(tree)) & ((1u << nc) - 1u);
}

// A row's walk: maxlen = the longest history, rowlen = positions walked
// (tree rows + T, rows with no live tree node 0; capped by the table),
// extra = which positions in [maxlen, maxlen + 64) some tree slot attends.
struct Row {
  int maxlen, rowlen;
  u64 extra;
};

__device__ __forceinline__ bool needed(int pos, const Row& r) {
  const unsigned s = static_cast<unsigned>(pos - r.maxlen);
  return pos < r.maxlen || (s < 64u && ((r.extra >> s) & 1ull));
}

// Every thread of the block calls this; it fills len_s/anc_s for row b.
// The row's global reads (lengths, ancestor bytes) are issued together.
__device__ Row row_setup(const Params& p, int b, int* len_s, u64* anc_s) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool tree = p.anc != nullptr;
  if (tid < p.T) len_s[tid] = max(p.lengths[b * p.T + tid], 0);
  if (tree) {
    // Warp w reads ancestor rows t = w, w + 4, ...: lane s holds slots s, s + 32.
#pragma unroll 4
    for (int t = warp; t < p.T; t += WARPS) {
      const int8_t* a = p.anc + (static_cast<size_t>(b) * p.T + t) * p.T;
      const unsigned lo = __ballot_sync(0xffffffffu, lane < p.T && a[lane] != 0);
      const unsigned hi = __ballot_sync(0xffffffffu, lane + 32 < p.T && a[lane + 32] != 0);
      if (lane == 0) anc_s[t] = (static_cast<u64>(hi) << 32) | lo;
    }
  } else if (tid < p.T) {
    anc_s[tid] = 0ull;
  }
  __syncthreads();
  // Every thread derives the walk (T is at most 64): no further barrier.
  int mx = 0;
  bool live = false;
  for (int t = 0; t < p.T; ++t) {
    mx = max(mx, len_s[t]);
    live |= anc_s[t] != 0ull;
  }
  u64 extra = 0;  // tree slots at or past the longest history
  if (tree)
    for (int t = 0; t < p.T; ++t) {
      const int shift = mx - len_s[t];
      extra |= shift < 64 ? anc_s[t] >> shift : 0ull;
    }
  Row r;
  r.maxlen = mx;
  r.rowlen = min(tree ? (live ? mx + p.T : 0) : mx, p.W * p.bs);  // the table addresses no further
  r.extra = extra;
  return r;
}

__device__ __forceinline__ size_t q_off(const Params& p, int b, int kh, int col) {
  const int t = col / p.G, g = col - t * p.G;
  return ((static_cast<size_t>(b) * p.T + t) * p.KVH + kh) * p.G * p.hd +
         static_cast<size_t>(g) * p.hd;
}

// Shared-memory layout of the split kernel (bytes), the same on host and device.
template <typename QT, typename PT, int HD, int MT>
struct Layout {
  static constexpr bool MMA = std::is_same<QT, bf16>::value;
  static constexpr bool QUANT = sizeof(PT) == 1;
  static constexpr int TILE = MMA ? 64 : 32;     // positions per stage
  static constexpr int NSTAGE = (MMA && HD <= 128) ? 3 : 2;  // a 128-position chunk in flight at once
  static constexpr int R = MMA ? MT * 16 : F32_COLS;  // query rows per pass
  int row_q, row_p, q_bytes, p_bytes, stage_bytes, ring_bytes, work_bytes, merge_bytes, total;
  __host__ __device__ explicit Layout(int hd) {
    row_q = hd * static_cast<int>(sizeof(QT)) + 16;   // q_s and work-tile row stride
    row_p = hd * static_cast<int>(sizeof(PT)) + 16;   // stage row stride
    q_bytes = R * row_q;
    p_bytes = MMA ? 0 : WARPS * F32_CPW * TILE * 4;
    stage_bytes = 2 * TILE * row_p + (QUANT ? 2 * TILE * 4 : 0);
    ring_bytes = NSTAGE * stage_bytes;
    work_bytes = QUANT ? 2 * TILE * row_q : 0;
    merge_bytes = MMA ? WARPS * R * (hd + 8) * 4 + 3 * WARPS * R * 4 : 0;
    const int body = ring_bytes + work_bytes > merge_bytes ? ring_bytes + work_bytes : merge_bytes;
    total = q_bytes + p_bytes + body;
  }
};

// Start the copies of a pass's query rows into q_s (zeros past the last
// column); they complete with the first tile's group.
template <typename QT, int R>
__device__ __forceinline__ void issue_q(unsigned char* q_s, const Params& p, int b, int kh,
                                        int col0, int ncol, int row_q) {
  constexpr int EB = 16 / static_cast<int>(sizeof(QT));
  const QT* q = static_cast<const QT*>(p.q);
  const int pieces = p.hd / EB;
  for (int i = threadIdx.x; i < R * pieces; i += THREADS) {
    const int r = i / pieces, pc = i - r * pieces;
    const bool on = r < ncol;
    cp_async16(q_s + r * row_q + pc * 16, q + (on ? q_off(p, b, kh, col0 + r) + pc * EB : 0), on);
  }
}

// Start the copies of one tile of K and V rows (and int8 scales) into a
// stage: rows [0, TILE) are K, [TILE, 2*TILE) are V. Positions outside the
// chunk or attended by no column are zero-filled and not read.
template <typename PT, int TILE, int HD>
__device__ __forceinline__ void issue_tile(unsigned char* stage, const Params& p, int kh,
                                           int tile0, int c_lo, int c_hi, const Row& row,
                                           const int* pg_s) {
  constexpr int EB = 16 / static_cast<int>(sizeof(PT));
  constexpr int PMAX = HD / EB;          // 16-byte pieces of a row at the bucket's width
  constexpr int RW = TILE / WARPS;       // rows per warp (<= 32)
  constexpr int ITERS = RW * PMAX / 32;  // pieces per lane
  static_assert(RW <= 32 && (RW * PMAX) % 32 == 0, "tile shape");
  const PT* kc = static_cast<const PT*>(p.kc);
  const PT* vc = static_cast<const PT*>(p.vc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pieces = p.hd / EB;
  const int row_p = p.hd * static_cast<int>(sizeof(PT)) + 16;
  // Lane j < RW finds the page row of the warp's row j once.
  const int r0 = warp * RW;
  const int pos = tile0 + r0 + lane;
  const bool need = lane < RW && pos < c_hi && needed(pos, row);
  unsigned prow = 0;
  if (need) {
    const unsigned rel = static_cast<unsigned>(pos - c_lo);
    const unsigned pg = p.bs == 1 ? rel : __umulhi(rel, p.bs_magic);
    prow = static_cast<unsigned>(pg_s[pg]) * p.bs + (rel - pg * p.bs);
  }
  const unsigned needs = __ballot_sync(0xffffffffu, need);
  if constexpr (sizeof(PT) == 1) {
    if (lane < RW) {
      float* sc = reinterpret_cast<float*>(stage + 2 * TILE * row_p);
      const size_t so = static_cast<size_t>(prow) * p.KVH + kh;
      cp_async4(sc + r0 + lane, p.ks + so, need);
      cp_async4(sc + TILE + r0 + lane, p.vs + so, need);
    }
  }
  const size_t D = static_cast<size_t>(p.KVH) * p.hd;
  const PT* kbase = kc + static_cast<size_t>(kh) * p.hd;
  const PT* vbase = vc + static_cast<size_t>(kh) * p.hd;
  // Neighbouring lanes copy neighbouring pieces of a row (coalesced).
#pragma unroll
  for (int k = 0; k < ITERS; ++k) {
    const int i = k * 32 + lane, rl = i / PMAX, pc = i % PMAX;
    const unsigned pr = __shfl_sync(0xffffffffu, prow, rl);
    const bool on = ((needs >> rl) & 1u) && pc < pieces;
    const size_t off = static_cast<size_t>(pr) * D + pc * EB;
    const int so = (r0 + rl) * row_p + pc * 16;
    if (pc < pieces) {
      cp_async16(stage + so, kbase + off, on);
      cp_async16(stage + TILE * row_p + so, vbase + off, on);
    }
  }
}

// int8 stage → q-dtype work tile: widen, multiply by the position's head
// scale, round once to QT (zero-filled rows have scale 0 and stay 0).
template <typename QT, int TILE>
__device__ __forceinline__ void dequant_tile(const unsigned char* stage, unsigned char* work,
                                             int hd) {
  const int row_p = hd + 16, row_q = hd * static_cast<int>(sizeof(QT)) + 16;
  const float* sc = reinterpret_cast<const float*>(stage + 2 * TILE * row_p);
  constexpr int TPR = THREADS / (2 * TILE) > 0 ? THREADS / (2 * TILE) : 1;  // threads per row
  const int pieces = hd / 16;
  const int part = threadIdx.x % TPR;
  for (int r = threadIdx.x / TPR; r < 2 * TILE; r += THREADS / TPR) {
    const float s = sc[r];
    for (int pc = part; pc < pieces; pc += TPR) {
      int8_t e[16];
      const uint4 raw = *reinterpret_cast<const uint4*>(stage + r * row_p + pc * 16);
      memcpy(e, &raw, 16);
      QT* dst = reinterpret_cast<QT*>(work + r * row_q) + pc * 16;
      if constexpr (std::is_same<QT, bf16>::value) {
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = pack_bf16(__float2bfloat16(static_cast<float>(e[2 * i]) * s),
                           __float2bfloat16(static_cast<float>(e[2 * i + 1]) * s));
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          reinterpret_cast<float4*>(dst)[i] = make_float4(
              static_cast<float>(e[4 * i]) * s, static_cast<float>(e[4 * i + 1]) * s,
              static_cast<float>(e[4 * i + 2]) * s, static_cast<float>(e[4 * i + 3]) * s);
      }
    }
  }
}

// Where one query column's results go: normalized into `out` when the row
// fits one chunk, else this split's partial (m, l, acc) in the scratch.
template <typename QT>
struct ColOut {
  QT* out = nullptr;
  float* acc = nullptr;
  float2* ml = nullptr;
  __device__ ColOut(const Params& p, bool direct, int b, int kh, int split, int col) {
    if (direct) {
      out = static_cast<QT*>(p.out) + q_off(p, b, kh, col);
    } else {
      const size_t slot = ((static_cast<size_t>(b) * p.KVH + kh) * p.splits + split) * p.nq + col;
      acc = p.part_acc + slot * p.hd;
      ml = p.part_ml + slot;
    }
  }
  __device__ void put(int d, float l, float a) const {
    if (out) out[d] = from_f<QT>(l > 0.f ? a / l : 0.f);
    else acc[d] = a;
  }
  __device__ void put_ml(float m, float l) const {
    if (ml) *ml = make_float2(m, l);
  }
  // Four elements from d (a multiple of 4), already scaled for `out`.
  __device__ void put4(int d, float4 v) const {
    if (!out) {
      *reinterpret_cast<float4*>(acc + d) = v;
    } else if constexpr (std::is_same<QT, bf16>::value) {
      *reinterpret_cast<uint2*>(out + d) =
          make_uint2(pack_bf16(__float2bfloat16(v.x), __float2bfloat16(v.y)),
                     pack_bf16(__float2bfloat16(v.z), __float2bfloat16(v.w)));
    } else {
      *reinterpret_cast<float4*>(out + d) = v;
    }
  }
};

// One warp, one 16-position slice of a staged tile, tensor cores.
// Kt/Vt point at the slice's first K/V row; rows are rq elements apart.
template <int HD, int MT>
__device__ __forceinline__ void mma_slice(const bf16* q_s, const bf16* Kt, const bf16* Vt,
                                          int rq, int hd, int pos0, int c_hi,
                                          const int (&rlen)[MT][2], const u64 (&ranc)[MT][2],
                                          float c, float (&m)[MT][2], float (&l)[MT][2],
                                          float (&o)[MT][HD / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // Scores S = Q K^T: rows = query columns, cols = 16 positions (2 n-tiles).
  float s[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    if (ks * 16 < hd) {
      uint32_t kb[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* kr = Kt + (nt * 8 + g) * rq + ks * 16 + t * 2;
        kb[nt][0] = lds32(kr);
        kb[nt][1] = lds32(kr + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* qa = q_s + (mt * 16 + g) * rq + ks * 16 + t * 2;
        const uint32_t a[4] = {lds32(qa), lds32(qa + 8 * rq), lds32(qa + 8), lds32(qa + 8 * rq + 8)};
        mma_bf16(s[mt][0], a, kb[0][0], kb[0][1]);
        mma_bf16(s[mt][1], a, kb[1][0], kb[1][1]);
      }
    }
  }
  // Online softmax over these 16 positions; P packed as A fragments, hi + lo.
  uint32_t pa_hi[MT][4], pa_lo[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned am = attend_mask16(pos0, rlen[mt][h], ranc[mt][h], c_hi) >> (t * 2);
      float v[4];
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = (am >> (nt * 8 + e)) & 1u ? s[mt][nt][2 * h + e] : -INFINITY;
          v[nt * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[mt][h], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;
      // corr = 1 while nothing was attended (acc and l are still 0)
      const float corr = m[mt][h] == -INFINITY ? 1.f : fast_exp2((m[mt][h] - mu) * c);
      float ps = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = fast_exp2((v[k] - mu) * c);
        ps += v[k];
      }
      l[mt][h] = l[mt][h] * corr + ps;
      m[mt][h] = mn;
      if (__any_sync(0xffffffffu, corr != 1.f)) {  // the row max moved somewhere
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[mt][n][2 * h] *= corr;
          o[mt][n][2 * h + 1] *= corr;
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16 h0 = __float2bfloat16(v[nt * 2]), h1 = __float2bfloat16(v[nt * 2 + 1]);
        pa_hi[mt][nt * 2 + h] = pack_bf16(h0, h1);
        pa_lo[mt][nt * 2 + h] = pack_bf16(__float2bfloat16(v[nt * 2] - __bfloat162float(h0)),
                                          __float2bfloat16(v[nt * 2 + 1] - __bfloat162float(h1)));
      }
    }
  }
  // O += P V: V fragments by ldmatrix.trans, two d n-tiles per load.
  const int mi = lane >> 3, rr = lane & 7;
  uint32_t vb[HD / 16][4];
#pragma unroll
  for (int dn = 0; dn < HD / 16; ++dn)
    if (dn * 16 < hd) ldsm_x4_trans(vb[dn], Vt + ((mi & 1) * 8 + rr) * rq + dn * 16 + (mi >> 1) * 8);
#pragma unroll
  for (int dn = 0; dn < HD / 16; ++dn) {
    if (dn * 16 < hd) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * dn], pa_hi[mt], vb[dn][0], vb[dn][1]);
        mma_bf16(o[mt][2 * dn + 1], pa_hi[mt], vb[dn][2], vb[dn][3]);
      }
    }
  }
#pragma unroll
  for (int dn = 0; dn < HD / 16; ++dn) {
    if (dn * 16 < hd) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * dn], pa_lo[mt], vb[dn][0], vb[dn][1]);
        mma_bf16(o[mt][2 * dn + 1], pa_lo[mt], vb[dn][2], vb[dn][3]);
      }
    }
  }
}

// Split kernel: one block per (chunk of a row, KV head × query pass, row).
// EXACT: hd == HD, so every width test folds at compile time; otherwise hd
// is a smaller multiple of 32 and the loops test it at run time.
template <typename QT, typename PT, int HD, int MT, bool EXACT>
__global__ void __launch_bounds__(THREADS) paged_attention_split_kernel(const Params prm) {
  Params p = prm;
  if constexpr (EXACT) p.hd = HD;
  // The merge kernel may start launching now; it waits for this grid's end
  // before it reads any partial.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  using L = Layout<QT, PT, HD, MT>;
  constexpr int TILE = L::TILE, NSTAGE = L::NSTAGE, R = L::R;
  __shared__ int len_s[MAX_T];
  __shared__ u64 anc_s[MAX_T];
  __shared__ int pg_s[MAX_CHUNK_PAGES];
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, kh = blockIdx.y % p.KVH, pass = blockIdx.y / p.KVH;
  const int b = blockIdx.z;
  const int col0 = pass * p.rows_per_pass;
  const int ncol = min(p.rows_per_pass, p.nq - col0);
  const L lay(p.hd);
  unsigned char* q_raw = smem;
  float* p_s = reinterpret_cast<float*>(smem + lay.q_bytes);
  unsigned char* ring = smem + lay.q_bytes + lay.p_bytes;
  unsigned char* work = ring + lay.ring_bytes;

  // The block's independent global reads go out together: this chunk's
  // table entries, the pass's query rows, the row's lengths.
  int tab[MAX_CHUNK_PAGES / THREADS];
#pragma unroll
  for (int k = 0; k < MAX_CHUNK_PAGES / THREADS; ++k) {
    const int i = tid + k * THREADS, w = split * p.chunk_pages + i;
    tab[k] = i < p.chunk_pages && w < p.W ? p.tables[static_cast<size_t>(b) * p.W + w] : 0;
  }
  issue_q<QT, R>(q_raw, p, b, kh, col0, ncol, lay.row_q);
  const Row row = row_setup(p, b, len_s, anc_s);
  const int chunk = p.chunk_pages * p.bs;
  const int c_lo = split * chunk;
  if (c_lo >= row.rowlen) {
    cp_async_wait<0>();
    if (split == 0) {  // a row with nothing to walk outputs zeros
      for (int r = warp; r < ncol; r += WARPS)
        for (int d = lane; d < p.hd; d += 32)
          static_cast<QT*>(p.out)[q_off(p, b, kh, col0 + r) + d] = from_f<QT>(0.f);
    }
    return;
  }
  const int c_hi = min(c_lo + chunk, row.rowlen);
  const bool direct = row.rowlen <= chunk;
#pragma unroll
  for (int k = 0; k < MAX_CHUNK_PAGES / THREADS; ++k) {
    const int i = tid + k * THREADS;
    if (i < p.chunk_pages) pg_s[i] = min(max(tab[k], 0), p.N - 1);
  }
  __syncthreads();

  const int ntiles = (c_hi - c_lo + TILE - 1) / TILE;
#pragma unroll 1
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < ntiles)
      issue_tile<PT, TILE, HD>(ring + s * lay.stage_bytes, p, kh, c_lo + s * TILE, c_lo, c_hi, row, pg_s);
    cp_async_commit();
  }

  if constexpr (L::MMA) {
    const bf16* q_s = reinterpret_cast<const bf16*>(q_raw);
    const int rq = lay.row_q / 2;
    const int g = lane >> 2, t = lane & 3;
    int rlen[MT][2];
    u64 ranc[MT][2];
    float m[MT][2], l[MT][2], o[MT][HD / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        const int tq = r < ncol ? (col0 + r) / p.G : -1;
        rlen[mt][h] = tq >= 0 ? len_s[tq] : 0;
        ranc[mt][h] = tq >= 0 ? anc_s[tq] : 0ull;
        m[mt][h] = -INFINITY;
        l[mt][h] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[mt][n][i] = 0.f;
    }

#pragma unroll 1
    for (int it = 0; it < ntiles; ++it) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();  // tile `it` landed for all; everyone is done with it-1
      {
        const int nx = it + NSTAGE - 1;
        if (nx < ntiles)
          issue_tile<PT, TILE, HD>(ring + (nx % NSTAGE) * lay.stage_bytes, p, kh, c_lo + nx * TILE,
                               c_lo, c_hi, row, pg_s);
        cp_async_commit();
      }
      const unsigned char* kv = ring + (it % NSTAGE) * lay.stage_bytes;
      if constexpr (L::QUANT) {
        dequant_tile<bf16, TILE>(kv, work, p.hd);
        __syncthreads();
        kv = work;
      }
      const int pos0 = c_lo + it * TILE + warp * 16;
      if (pos0 < c_hi) {
        const bf16* Kt = reinterpret_cast<const bf16*>(kv) + warp * 16 * rq;
        const bf16* Vt = reinterpret_cast<const bf16*>(kv) + (TILE + warp * 16) * rq;
        mma_slice<HD, MT>(q_s, Kt, Vt, rq, p.hd, pos0, c_hi, rlen, ranc, p.c, m, l, o);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is reused for the warps' merge

    // Merge the four warps' states through shared memory: acc rows of
    // hd + 8 floats (no bank conflicts), then each warp's m, l and factor.
    const int ms = p.hd + 8;
    float* mo = reinterpret_cast<float*>(ring);  // [WARPS][R][ms]
    float* mm = mo + WARPS * R * ms;              // [WARPS][R]
    float* ml = mm + WARPS * R;
    float* fw = ml + WARPS * R;                   // factor / L of each warp's state
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lq = l[mt][h];
        lq += __shfl_xor_sync(0xffffffffu, lq, 1);
        lq += __shfl_xor_sync(0xffffffffu, lq, 2);
        const int r = warp * R + mt * 16 + g + 8 * h;
        if (t == 0) {
          mm[r] = m[mt][h];
          ml[r] = lq;
        }
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const int d = n * 8 + t * 2;
          if (d < p.hd)
            *reinterpret_cast<float2*>(mo + r * ms + d) = make_float2(o[mt][n][2 * h], o[mt][n][2 * h + 1]);
        }
      }
    }
    __syncthreads();
    if (tid < ncol) {  // one thread per row weighs the warps' states
      const int r = tid;
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mm[w * R + r]);
      float f[WARPS], Lsum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float mw = mm[w * R + r];
        f[w] = mw == -INFINITY ? 0.f : fast_exp2((mw - M) * p.c);
        Lsum = fmaf(ml[w * R + r], f[w], Lsum);
      }
      // Direct rows fold 1/L into the factors; partials keep acc unnormalized.
      const float scale = direct ? (Lsum > 0.f ? 1.f / Lsum : 0.f) : 1.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) fw[w * R + r] = f[w] * scale;
      ColOut<QT>(p, direct, b, kh, split, col0 + r).put_ml(M, Lsum);
    }
    __syncthreads();
    const int h4 = p.hd / 4;
    for (int i = tid; i < ncol * h4; i += THREADS) {
      const int r = i / h4, d = (i - r * h4) * 4;
      float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = fw[w * R + r];
        const float4 a = *reinterpret_cast<const float4*>(mo + (w * R + r) * ms + d);
        O.x = fmaf(a.x, f, O.x);
        O.y = fmaf(a.y, f, O.y);
        O.z = fmaf(a.z, f, O.z);
        O.w = fmaf(a.w, f, O.w);
      }
      ColOut<QT>(p, direct, b, kh, split, col0 + r).put4(d, O);
    }
  } else {
    // f32 path: warp w owns pass columns w, w + 4, ...; lane = position.
    constexpr int VPL = HD / 32;
    const float* q_s = reinterpret_cast<const float*>(q_raw);
    const int rq = lay.row_q / 4;
    const int vpl = p.hd / 32;
    const int ncw = ncol > warp ? (ncol - warp + WARPS - 1) / WARPS : 0;
    int clen[F32_CPW];
    u64 canc[F32_CPW];
    float m[F32_CPW], l[F32_CPW], acc[F32_CPW][VPL];
#pragma unroll
    for (int j = 0; j < F32_CPW; ++j) {
      const int tq = j < ncw ? (col0 + warp + WARPS * j) / p.G : -1;
      clen[j] = tq >= 0 ? len_s[tq] : 0;
      canc[j] = tq >= 0 ? anc_s[tq] : 0ull;
      m[j] = -INFINITY;
      l[j] = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[j][i] = 0.f;
    }
    float* pw = p_s + warp * F32_CPW * TILE;

#pragma unroll 1
    for (int it = 0; it < ntiles; ++it) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      {
        const int nx = it + NSTAGE - 1;
        if (nx < ntiles)
          issue_tile<PT, TILE, HD>(ring + (nx % NSTAGE) * lay.stage_bytes, p, kh, c_lo + nx * TILE,
                               c_lo, c_hi, row, pg_s);
        cp_async_commit();
      }
      const unsigned char* kv = ring + (it % NSTAGE) * lay.stage_bytes;
      if constexpr (L::QUANT) {
        dequant_tile<float, TILE>(kv, work, p.hd);
        __syncthreads();
        kv = work;
      }
      if (ncw == 0) continue;
      const int tile0 = c_lo + it * TILE;
      const float* Kt = reinterpret_cast<const float*>(kv);
      const float* Vt = Kt + TILE * rq;
      // Scores: lane = position, dot over hd against each owned column.
      float s[F32_CPW];
#pragma unroll
      for (int j = 0; j < F32_CPW; ++j) s[j] = 0.f;
      const float* kr = Kt + lane * rq;
#pragma unroll 2
      for (int d = 0; d < p.hd; d += 4) {
        const float4 kx = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int j = 0; j < F32_CPW; ++j) {
          if (j < ncw) {
            const float4 qx = *reinterpret_cast<const float4*>(q_s + (warp + WARPS * j) * rq + d);
            s[j] = fmaf(qx.x, kx.x, s[j]);
            s[j] = fmaf(qx.y, kx.y, s[j]);
            s[j] = fmaf(qx.z, kx.z, s[j]);
            s[j] = fmaf(qx.w, kx.w, s[j]);
          }
        }
      }
      const int pos = tile0 + lane;
#pragma unroll
      for (int j = 0; j < F32_CPW; ++j) {
        if (j < ncw) {
          const float x = (pos < c_hi && attends(pos, clen[j], canc[j])) ? s[j] : -INFINITY;
          const float mn = fmaxf(m[j], warp_max(x));
          const float mu = mn == -INFINITY ? 0.f : mn;
          const float corr = fast_exp2((m[j] - mu) * p.c);
          const float pj = fast_exp2((x - mu) * p.c);
          l[j] = l[j] * corr + pj;  // per-lane partial; summed over the warp at the end
          m[j] = mn;
#pragma unroll
          for (int i = 0; i < VPL; ++i) acc[j][i] *= corr;
          pw[j * TILE + lane] = pj;
        }
      }
      __syncwarp();
      // P·V: lane owns output elements lane + 32 i.
      const int npos = min(TILE, c_hi - tile0);
      for (int u = 0; u < npos; ++u) {
        float vv[VPL];
#pragma unroll
        for (int i = 0; i < VPL; ++i) vv[i] = i < vpl ? Vt[u * rq + lane + 32 * i] : 0.f;
#pragma unroll
        for (int j = 0; j < F32_CPW; ++j) {
          if (j < ncw) {
            const float pj = pw[j * TILE + u];
#pragma unroll
            for (int i = 0; i < VPL; ++i) acc[j][i] = fmaf(pj, vv[i], acc[j][i]);
          }
        }
      }
      __syncwarp();  // pw is rewritten by the next tile
    }
    cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < F32_CPW; ++j) {
      if (j < ncw) {
        const float Lsum = warp_sum(l[j]);
        const ColOut<QT> dst(p, direct, b, kh, split, col0 + warp + WARPS * j);
        if (lane == 0) dst.put_ml(m[j], Lsum);
#pragma unroll
        for (int i = 0; i < VPL; ++i)
          if (i < vpl) dst.put(lane + 32 * i, Lsum, acc[j][i]);
      }
    }
  }
}

// Merge kernel: one block per (KV head × group of four query columns, row),
// one warp per column; combines the live splits of rows that span more
// than one chunk, in split order.
template <typename QT>
__global__ void __launch_bounds__(THREADS) paged_attention_merge_kernel(const Params p) {
  __shared__ int len_s[MAX_T];
  __shared__ u64 anc_s[MAX_T];
  const int kh = blockIdx.x % p.KVH, grp = blockIdx.x / p.KVH, b = blockIdx.y;
  const Row row = row_setup(p, b, len_s, anc_s);
  const int chunk = p.chunk_pages * p.bs;
  const int nlive = (row.rowlen + chunk - 1) / chunk;
  if (nlive <= 1) return;  // written directly by its split kernel block
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel's partials are complete
  const size_t base = (static_cast<size_t>(b) * p.KVH + kh) * p.splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, vpl = p.hd / 32;
  const size_t acc_stride = static_cast<size_t>(p.nq) * p.hd;  // one split to the next
  constexpr int MB = 8;  // splits whose partials are loaded together
  // One warp per query column: lanes hold splits for the weights and
  // output elements lane + 32 i for the sum over splits.
  {
    const int col = grp * WARPS + warp;
    if (col >= p.nq) return;
    const float2* ml = p.part_ml + base * p.nq + col;  // split s at ml[s * nq]
    const float* acc = p.part_acc + (base * p.nq + col) * p.hd + lane;
    float O[MAX_HD / 32];
#pragma unroll
    for (int i = 0; i < MAX_HD / 32; ++i) O[i] = 0.f;
    // Lane j holds split s0 + j's (m, l); its weight reaches the others by shuffle.
    float M = -INFINITY;
    for (int s = lane; s < nlive; s += 32) M = fmaxf(M, ml[static_cast<size_t>(s) * p.nq].x);
    M = warp_max(M);
    float Lsum = 0.f;
    for (int g0 = 0; g0 < nlive; g0 += 32) {
      float f = 0.f;  // lane j: split g0 + j's factor
      if (g0 + lane < nlive) {
        const float2 v = ml[static_cast<size_t>(g0 + lane) * p.nq];
        if (v.x != -INFINITY) {
          f = fast_exp2((v.x - M) * p.c);
          Lsum = fmaf(v.y, f, Lsum);
        }
      }
      const int gend = min(g0 + 32, nlive);
      for (int s0 = g0; s0 < gend; s0 += MB) {
        float a[MB][MAX_HD / 32];  // all of this batch's loads go out first
#pragma unroll
        for (int j = 0; j < MB; ++j)
#pragma unroll
          for (int i = 0; i < MAX_HD / 32; ++i)
            a[j][i] = (s0 + j < gend && i < vpl) ? acc[(s0 + j) * acc_stride + 32 * i] : 0.f;
#pragma unroll
        for (int j = 0; j < MB; ++j) {
          const float fj = __shfl_sync(0xffffffffu, f, (s0 + j - g0) & 31);
#pragma unroll
          for (int i = 0; i < MAX_HD / 32; ++i) O[i] = fmaf(a[j][i], fj, O[i]);
        }
      }
    }
    Lsum = warp_sum(Lsum);
    QT* o = static_cast<QT*>(p.out) + q_off(p, b, kh, col) + lane;
#pragma unroll
    for (int i = 0; i < MAX_HD / 32; ++i)
      if (i < vpl) o[32 * i] = from_f<QT>(Lsum > 0.f ? O[i] / Lsum : 0.f);
  }
}

template <typename QT, typename PT, int HD, int MT>
cudaError_t launch_split(Params p, int B, int rows_per_pass, cudaStream_t st) {
  auto kernel = p.hd == HD ? paged_attention_split_kernel<QT, PT, HD, MT, true>
                           : paged_attention_split_kernel<QT, PT, HD, MT, false>;
  p.rows_per_pass = rows_per_pass;
  const int npass = (p.nq + rows_per_pass - 1) / rows_per_pass;
  if (static_cast<long long>(p.KVH) * npass > 65535) return cudaErrorInvalidValue;
  const int smem = Layout<QT, PT, HD, MT>(p.hd).total;
  static int smem_set[2] = {0, 0};  // opt-in above 48 KB, once per kernel
  int& set = smem_set[p.hd == HD];
  if (smem > set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    set = smem;
  }
  kernel<<<dim3(p.splits, p.KVH * npass, B), THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename PT>
cudaError_t launch_all(const Params& p, int B, cudaStream_t st) {
  cudaError_t e;
  if constexpr (std::is_same<QT, float>::value) {
    if (p.hd <= 64) e = launch_split<QT, PT, 64, 1>(p, B, F32_COLS, st);
    else if (p.hd <= 128) e = launch_split<QT, PT, 128, 1>(p, B, F32_COLS, st);
    else e = launch_split<QT, PT, 256, 1>(p, B, F32_COLS, st);
  } else {
    const bool one = p.nq <= 16;
    if (p.hd <= 64) e = one ? launch_split<QT, PT, 64, 1>(p, B, 16, st)
                            : launch_split<QT, PT, 64, 2>(p, B, 32, st);
    else if (p.hd <= 128) e = one ? launch_split<QT, PT, 128, 1>(p, B, 16, st)
                                  : launch_split<QT, PT, 128, 2>(p, B, 32, st);
    else e = launch_split<QT, PT, 256, 1>(p, B, 16, st);
  }
  if (e != cudaSuccess || p.splits == 1) return e;
  // Launched as a programmatic dependent of the split kernel: its blocks
  // set up while the split kernel finishes.
  const int groups = (p.nq + WARPS - 1) / WARPS;  // one warp per query column
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.KVH * groups, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_attention_merge_kernel<QT>, p);
}

}  // namespace

extern "C" {

// Launch paged attention on `stream` (the split kernel, then the merge
// kernel when splits > 1); returns a cudaError_t (0 = launched). Pointers
// are device pointers; k_cache/v_cache/k_scale/v_scale are the FULL [L, ...]
// arrays and `layer` selects the slice. k_scale/v_scale are used only when
// page_dtype is int8; anc is null outside tree mode. chunk_pages and splits
// are the wrapper's split plan (splits = ceil(W / chunk_pages)); part_acc
// [B, KVH, splits, T*G, hd] and part_ml [B, KVH, splits, T*G, 2] are f32
// scratch, needed only when splits > 1. No synchronisation, no allocation.
int dtpu_paged_attention(const void* q, const void* k_cache, const void* v_cache,
                         const void* k_scale, const void* v_scale, const void* block_tables,
                         const void* lengths, const void* anc, void* out, void* part_acc,
                         void* part_ml, int q_dtype, int page_dtype, int B, int T, int KVH, int G,
                         int hd, int N, int bs, int W, int layer, int chunk_pages, int splits,
                         void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (B < 0 || B > 65535 || T < 0 || T > MAX_T || hd <= 0 || hd > MAX_HD || hd % 32 != 0 ||
      KVH <= 0 || G <= 0 || N <= 0 || bs <= 0 || W <= 0 || layer < 0 || chunk_pages <= 0 ||
      chunk_pages > MAX_CHUNK_PAGES || splits != (W + chunk_pages - 1) / chunk_pages ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const size_t layer_elems = static_cast<size_t>(N) * bs * KVH * hd;
  const size_t layer_scales = static_cast<size_t>(N) * bs * KVH;
  const size_t page_bytes = page_dtype == DT_F32 ? 4 : page_dtype == DT_BF16 ? 2 : 1;
  Params p;
  p.q = q;
  p.kc = static_cast<const char*>(k_cache) + layer * layer_elems * page_bytes;
  p.vc = static_cast<const char*>(v_cache) + layer * layer_elems * page_bytes;
  p.ks = page_dtype == DT_I8 ? static_cast<const float*>(k_scale) + layer * layer_scales : nullptr;
  p.vs = page_dtype == DT_I8 ? static_cast<const float*>(v_scale) + layer * layer_scales : nullptr;
  p.tables = static_cast<const int*>(block_tables);
  p.lengths = static_cast<const int*>(lengths);
  p.anc = static_cast<const int8_t*>(anc);
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float2*>(part_ml);
  p.T = T;
  p.KVH = KVH;
  p.G = G;
  p.hd = hd;
  p.N = N;
  p.bs = bs;
  p.W = W;
  p.chunk_pages = chunk_pages;
  p.splits = splits;
  p.nq = T * G;
  p.bs_magic = static_cast<unsigned>((0x100000000ull + bs - 1) / bs);  // unused when bs == 1
  p.rows_per_pass = 0;
  p.c = LOG2E / sqrtf(static_cast<float>(hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == DT_F32 && page_dtype == DT_F32) return launch_all<float, float>(p, B, st);
  if (q_dtype == DT_BF16 && page_dtype == DT_BF16) return launch_all<bf16, bf16>(p, B, st);
  if (q_dtype == DT_F32 && page_dtype == DT_I8) return launch_all<float, int8_t>(p, B, st);
  if (q_dtype == DT_BF16 && page_dtype == DT_I8) return launch_all<bf16, int8_t>(p, B, st);
  return cudaErrorInvalidValue;
}

const char* dtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
