"""Weight-only int8 products: the CUDA kernel's wrapper and its plain version.

The JAX package computes ``(x @ w_int8) * scale`` with XLA fusing the
int8 → bf16 convert into the dot (``dynamo_tpu/engine/model.py`` ``_dot_q``
and the int8 branches of ``_logits``), so its weights stream at one byte
each. Here ``csrc/int8_matmul.cu`` does the same by hand for decode-shaped
products. Layouts are the JAX package's: x ``[..., K]`` (bf16 or f32), w
``[K, N]`` int8, scale ``[N]`` (f32 or bf16).

Rounding is the JAX functions': ``x @ w`` rounded to x's dtype; then for a
layer (``out_f32=False``) times the scale rounded to x's dtype, the
product in x's dtype; for logits (``out_f32=True``) in f32 times the
scale as it is.

Routes, chosen from shapes alone (never as a recovery from a failure):

- CPU tensors: ``int8_matmul_ref``, the plain version (the tests' oracle).
- CUDA, M ≤ ``SMALL_M`` rows and w contiguous: the decode route ("kernel"),
  the only route of a batch bucket of 8. Inside it, bf16 x with K % 8 ==
  0, N % 16 == 0 and w 16-byte aligned (``decode_entry``) takes the decode
  entry (TMA ring, split-K inside a thread-block cluster, one kernel), and
  ``int8_matmul_group`` makes one launch of it for weights that share x;
  any other call (f32 x, unaligned shapes) the split-K decode kernel and
  its merge. ``launches`` counts the products on this route, a group one
  per weight; ``decode_launches`` the decode entry's kernel launches.
- CUDA, more than ``SMALL_M`` rows of bf16 x, w contiguous, K % 8 == 0,
  N % 16 == 0 and w 16-byte aligned: the wide entry (wgmma with the
  weights dequantized in registers): decode buckets of 32 to 256 rows,
  verify passes and prefill chunks of any length. ``wide_launches``
  counts its calls. It has no row limit: on the H100 it beats the prefill
  route at 512 and 2048 rows too (PERF.md).
- CUDA, f32 x or a shape the wide entry refuses, at most ``MAX_M`` rows,
  w contiguous: the split-K decode kernel.
- CUDA, bf16 x and w the transpose of a contiguous ``[N, K]`` (the tied
  embedding ``[V, D]`` used as ``emb.T`` by ``_logits``) with K % 16 == 0
  and a 16-byte aligned base: the tied wgmma entry ("tied_wide"), which
  reads the embedding as stored, one byte per weight, at any row count,
  with the same epilogue; its plan is ``tied_plan``.
- CUDA, f32 x or a tied shape that entry refuses, at most ``MAX_M`` rows:
  the kernel's first tied entry ("tied", CUDA cores for f32 x, mma.sync
  for bf16). ``tied_launches`` counts the calls of both tied entries.
- CUDA, any other call (more than ``MAX_M`` rows that neither the wide
  nor the tied wgmma entry takes, or another w layout): the prefill
  route, which dequantizes w into a scratch in x's dtype and calls
  ``torch.matmul``. ``prefill_launches`` counts its calls.

A CUDA call launches a kernel or raises; it never reaches the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _build

MAX_M = 64         # the decode kernel's row limit
SMALL_M = 8        # rows of bf16 x the decode kernel keeps: a batch bucket of 8
BN, BK = 128, 128  # the kernel's columns per block and k rows per tile
RESIDENT_BLOCKS = 264  # blocks the H100's 132 SMs hold at once (2 each at M <= 8)

# The wide entry (csrc/int8_matmul.cu ``int8_matmul_wide_kernel``): columns
# per block, k rows per stage, its row tiles (wgmma's N) and the blocks one
# SM holds at every row tile (the source's W_BLOCKS_PER_SM, fixed at
# compile time by its shared memory and launch bounds; the card tests read
# the occupancy back through dtpu_int8_wide_blocks_per_sm).
WIDE_BN, WIDE_BK = 128, 64
WIDE_ROW_TILES = (16, 32, 64, 128, 256)
WIDE_BLOCKS_PER_SM = 1
SMS = 132          # the H100 SXM's streaming multiprocessors

# The tied wgmma entry (``int8_matmul_tied_wide_kernel``): embedding rows per
# tile, k per stage, its row tiles and its blocks per SM (the source's
# TW_BN, TW_BK, TiedCfg and TW_BLOCKS_PER_SM).
TIED_BN, TIED_BK = 128, 64
TIED_ROW_TILES = (8, 16, 32, 64, 128, 256)
TIED_BLOCKS_PER_SM = 1

# The decode entry (``int8_matmul_decode_kernel``): columns per block, k rows
# per stage, the blocks one SM holds (the source's D_BLOCKS_PER_SM; the card
# tests read the occupancy back through dtpu_int8_decode_blocks_per_sm),
# the largest cluster and the most weights one launch takes.
DECODE_BN, DECODE_BK = 128, 128
DECODE_BLOCKS_PER_SM = 3
DECODE_MAX_RANKS = 8
DECODE_MAX_GROUP = 4

# Products on the decode route / kernels the decode entry launched / calls
# that launched the wide entry / took the prefill route / launched either
# tied-head entry (read and reset by chip_smoke.py; CUDA-graph replays add
# the calls their graph holds).
launches = 0
decode_launches = 0
wide_launches = 0
prefill_launches = 0
tied_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def split_k(K: int, N: int) -> int:
    """Splits of K's ``BK``-row tiles for a [K, N] product, from the shapes
    alone: as many as keep the call's blocks of ``BN`` columns within one
    wave of ``RESIDENT_BLOCKS`` (a second, partial wave would leave most
    SMs idle while it runs), each split a contiguous run of
    ceil(tiles / splits) tiles, none empty."""
    groups = -(-N // BN)
    tiles = -(-K // BK)
    want = min(tiles, max(1, RESIDENT_BLOCKS // groups))
    per = -(-tiles // want)
    return -(-tiles // per)


def cluster_plan(K: int, col_blocks: int) -> tuple[int, int]:
    """The decode entry's split of K for a launch of ``col_blocks`` blocks of
    ``DECODE_BN`` columns, from the shapes alone → (cluster ranks, k tiles
    per rank). The ranks are the largest power of two, at most
    ``DECODE_MAX_RANKS`` and K's ``DECODE_BK``-row tiles, that keeps the
    launch's blocks within one block per SM and leaves no rank empty (on
    the H100 every llama-8b product and group ran fastest so, against
    plans for up to ``DECODE_BLOCKS_PER_SM`` blocks an SM: PERF.md); each
    rank takes a contiguous run of ceil(tiles / ranks) tiles. A launch of
    more column blocks than SMs takes one rank, its blocks up to
    ``DECODE_BLOCKS_PER_SM`` to an SM."""
    tiles = -(-K // DECODE_BK)
    want = min(DECODE_MAX_RANKS, tiles, max(1, SMS // col_blocks))
    ranks = 1 << (want.bit_length() - 1)
    while ranks > 1 and (ranks - 1) * -(-tiles // ranks) >= tiles:
        ranks //= 2
    return ranks, -(-tiles // ranks)


def decode_entry(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a call on the decode route ("kernel") takes the decode entry:
    bf16 x of 1 to ``SMALL_M`` rows, K % 8 == 0, N % 16 == 0 and w 16-byte
    aligned (the strides and boxes its TMA copies take)."""
    K, N = w.shape
    M = x.numel() // K if K else 0
    return (x.dtype == torch.bfloat16 and 1 <= M <= SMALL_M and K % 8 == 0 and N > 0
            and N % 16 == 0 and w.data_ptr() % 16 == 0)


def wide_plan(M: int, K: int, N: int) -> tuple[int, int, int]:
    """The wide entry's plan for an [M, K] x [K, N] product, from the shapes
    alone → (row tile, row tiles, splits). The row tile is the smallest of
    ``WIDE_ROW_TILES`` that holds M (256 past that: grid z walks
    ceil(M / 256) tiles). K's ``WIDE_BK``-row tiles are split into as many
    contiguous runs, each of ceil(tiles / splits) tiles and none empty, as
    keep the call's blocks within one wave of the SMs."""
    tile = next((t for t in WIDE_ROW_TILES if t >= M), WIDE_ROW_TILES[-1])
    row_tiles = -(-M // tile)
    blocks = -(-N // WIDE_BN) * row_tiles
    tiles = -(-K // WIDE_BK)
    want = min(tiles, max(1, SMS * WIDE_BLOCKS_PER_SM // blocks))
    per = -(-tiles // want)
    return tile, row_tiles, -(-tiles // per)


def tied_plan(M: int, N: int) -> tuple[int, int, int, int]:
    """The tied wgmma entry's plan for x [M, K] against an [N, K] embedding,
    from the shapes alone → (row tile, row tiles, blocks, tiles per block).
    The row tile is the smallest of ``TIED_ROW_TILES`` that holds M; past
    256 rows, 256 or 128, whichever pads fewer rows, 256 on a tie
    (``profile_int8_matmul --tied`` times both on the card).
    The tiles are ``TIED_BN`` embedding rows by one row tile, all of K each
    (no split, no partials); one persistent block per SM, at most one per
    tile, walks ceil(tiles / blocks) of them."""
    tile = next((t for t in TIED_ROW_TILES if t >= M), None)
    if tile is None:
        tile = 128 if -(-M // 128) * 128 < -(-M // 256) * 256 else 256
    row_tiles = -(-M // tile)
    tiles = -(-N // TIED_BN) * row_tiles
    blocks = min(tiles, SMS * TIED_BLOCKS_PER_SM)
    return tile, row_tiles, blocks, -(-tiles // blocks)


def _epilogue(y: torch.Tensor, scale: torch.Tensor, out_f32: bool) -> torch.Tensor:
    if out_f32:
        return y.float() * scale
    return y * scale.to(y.dtype)


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    out_f32: bool = False) -> torch.Tensor:
    """Plain version: dequantize, ``torch.matmul``, scale."""
    return _epilogue(x @ w.to(x.dtype), scale, out_f32)


def _prefill_route(x, w, scale, out_f32):
    global prefill_launches
    prefill_launches += 1
    return _epilogue(torch.matmul(x, w.to(x.dtype)), scale, out_f32)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                out_f32: bool = False) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` (int8) with per-column ``scale [N]`` →
    ``[..., N]`` in x's dtype (f32 with ``out_f32``)."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w, scale, out_f32)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, got {x.device}")
    _check(x, w)
    K, N = w.shape
    which = route(x, w)
    if which == "kernel" and decode_entry(x, w):
        return _launch_decode(x, [(w, scale)], out_f32)[0]
    if which == "prefill":
        return _prefill_route(x, w, scale, out_f32)
    if which == "wide":
        return _launch_wide(x, w, scale, out_f32, x.numel() // K, K, N)
    if which == "tied_wide":
        return _launch_tied_wide(x, w, scale, out_f32, x.numel() // K, K, N)
    return _launch(x, w, scale, out_f32, x.numel() // K if K else 0, K, N, which == "tied")


def int8_matmul_group(x: torch.Tensor, weights: list, out_f32: bool = False) -> list:
    """``x [..., K]`` times each ``(w [K, N_i] int8, scale [N_i])`` of
    ``weights`` → one output per weight, each what ``int8_matmul`` gives. On
    the card, when every product takes the decode entry (route "kernel",
    ``decode_entry``) and their scales share a dtype, one launch covers them
    (``DECODE_MAX_GROUP`` weights a launch; no weight is copied); otherwise,
    and on the CPU, one ``int8_matmul`` call per weight."""
    if x.device.type == "cuda" and len(weights) > 1 and len({s.dtype for _, s in weights}) == 1:
        for w, _ in weights:
            _check(x, w)
        if all(route(x, w) == "kernel" and decode_entry(x, w) for w, _ in weights):
            outs = []
            for i in range(0, len(weights), DECODE_MAX_GROUP):
                outs += _launch_decode(x, weights[i:i + DECODE_MAX_GROUP], out_f32)
            return outs
    return [int8_matmul(x, w, s, out_f32) for w, s in weights]


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if w.dim() != 2 or w.dtype != torch.int8:
        raise ValueError(f"w must be int8 [K, N], got {w.dtype} {tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"x's last dim {x.shape[-1]} != K = {w.shape[0]}")


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The shape rule for a CUDA call (module docstring): "kernel", "wide",
    "tied_wide", "tied" or "prefill"."""
    K, N = w.shape
    M = x.numel() // K if K else 0
    if w.is_contiguous():
        if M <= SMALL_M:
            return "kernel"
        if (x.dtype == torch.bfloat16 and K % 8 == 0 and N % 16 == 0
                and w.data_ptr() % 16 == 0):
            return "wide"
        return "kernel" if M <= MAX_M else "prefill"
    if w.T.is_contiguous():
        if x.dtype == torch.bfloat16 and K % 16 == 0 and w.data_ptr() % 16 == 0:
            return "tied_wide"
        if M <= MAX_M:
            return "tied"
    return "prefill"


def _operands(x, w, scale, M, K, N):
    """Check the operands → (library, x as a 16-byte aligned contiguous
    [M, K], a contiguous scale)."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    scale = _scale_operand(x, w, scale, N)
    lib = _build.library("int8_matmul")
    x2 = x.reshape(M, K)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.contiguous() if not x2.is_contiguous() else x2.clone()
    return lib, x2, scale


def _scale_operand(x, w, scale, N):
    """Check w's and scale's device and scale's dtype and shape → scale,
    contiguous."""
    if scale.dtype not in _DTYPE_CODES or tuple(scale.shape) != (N,):
        raise ValueError(f"scale must be f32 or bf16 [{N}], got {scale.dtype} {tuple(scale.shape)}")
    for t in (w, scale):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, found {t.device}")
    return scale.contiguous()


def _launch_wide(x, w, scale, out_f32, M, K, N):
    global wide_launches
    lib, x2, scale = _operands(x, w, scale, M, K, N)
    if scale.data_ptr() % 16:
        scale = scale.clone()
    tile, _row_tiles, splits = wide_plan(M, K, N)
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else x.dtype, device=x.device)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    fn = lib.dtpu_int8_matmul_wide
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
             part.data_ptr() if part is not None else None,
             _DTYPE_CODES[scale.dtype], int(out_f32), M, K, N, tile, splits,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "int8_matmul wide launch")
    wide_launches += 1
    return out.reshape(*x.shape[:-1], N)


def _launch_decode(x, weights, out_f32):
    """One launch of the decode entry for ``weights`` (1 to
    ``DECODE_MAX_GROUP`` pairs of w [K, N_i] and scale [N_i] that take it)
    → their outputs."""
    global launches, decode_launches
    K = weights[0][0].shape[0]
    M = x.numel() // K
    lib, x2, _ = _operands(x, *weights[0], M, K, weights[0][0].shape[1])
    ws, scales, outs = [], [], []
    for w, scale in weights:
        N = w.shape[1]
        scale = _scale_operand(x, w, scale, N)
        if scale.data_ptr() % 16:
            scale = scale.clone()
        ws.append(w)
        scales.append(scale)
        outs.append(torch.empty((M, N), dtype=torch.float32 if out_f32 else x.dtype,
                                device=x.device))
    ranks, _ = cluster_plan(K, sum(-(-w.shape[1] // DECODE_BN) for w in ws))
    fn = lib.dtpu_int8_matmul_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    G = len(ws)
    ptrs = lambda ts: (ctypes.c_void_p * G)(*(t.data_ptr() for t in ts))  # noqa: E731
    err = fn(x2.data_ptr(), ptrs(ws), ptrs(scales), ptrs(outs),
             (ctypes.c_int * G)(*(w.shape[1] for w in ws)), G, _DTYPE_CODES[scales[0].dtype],
             int(out_f32), M, K, ranks, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "int8_matmul decode launch")
    launches += G
    decode_launches += 1
    return [o.reshape(*x.shape[:-1], o.shape[1]) for o in outs]


def decode_blocks_per_sm() -> int:
    """Blocks of the decode entry one SM holds, as the CUDA runtime computes
    it from the built kernel (needs the card)."""
    fn = _build.library("int8_matmul").dtpu_int8_decode_blocks_per_sm
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def _launch_tied_wide(x, w, scale, out_f32, M, K, N):
    global tied_launches
    lib, x2, scale = _operands(x, w, scale, M, K, N)
    tile, row_tiles, blocks, _per_block = tied_plan(M, N)
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else x.dtype, device=x.device)
    xp = torch.empty((row_tiles * tile, -(-K // TIED_BK) * TIED_BK), dtype=x.dtype,
                     device=x.device)
    fn = lib.dtpu_int8_matmul_tw
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x2.data_ptr(), w.T.data_ptr(), scale.data_ptr(), out.data_ptr(), xp.data_ptr(),
             _DTYPE_CODES[scale.dtype], int(out_f32), M, K, N, tile, blocks,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "int8_matmul tied wgmma launch")
    tied_launches += 1
    return out.reshape(*x.shape[:-1], N)


def tied_blocks_per_sm(row_tile: int) -> int:
    """Blocks of the tied wgmma entry one SM holds at ``row_tile``, as the
    CUDA runtime computes it from the built kernel (needs the card)."""
    fn = _build.library("int8_matmul").dtpu_int8_tied_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(row_tile)


def wide_blocks_per_sm(row_tile: int) -> int:
    """Blocks of the wide entry one SM holds at ``row_tile``, as the CUDA
    runtime computes it from the built kernel (needs the card)."""
    fn = _build.library("int8_matmul").dtpu_int8_wide_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(row_tile)


def _launch(x, w, scale, out_f32, M, K, N, tied=False):
    global launches, tied_launches
    lib, x2, scale = _operands(x, w, scale, M, K, N)
    lead = x.shape[:-1]
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else x.dtype, device=x.device)
    if tied:
        fn = lib.dtpu_int8_matmul_t
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        err = fn(x2.data_ptr(), w.T.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], int(out_f32), M, K, N,
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, err, "int8_matmul tied-head launch")
        tied_launches += 1
        return out.reshape(*lead, N)
    splits = split_k(K, N)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    fn = lib.dtpu_int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
             part.data_ptr() if part is not None else None,
             _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], int(out_f32), M, K, N, splits,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "int8_matmul launch")
    launches += 1
    return out.reshape(*lead, N)
