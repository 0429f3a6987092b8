"""Paged attention: the CUDA kernel's wrappers and their plain PyTorch versions.

Port of ``dynamo_tpu/ops/paged_attention.py``. The Pallas kernel there
(``_mq_kernel``) becomes the hand-written CUDA kernel in
``csrc/paged_attention.cu``: one kernel for decode (T=1), linear
multi-query verify (T=S+1) and tree verify (``anc``), over float or int8
pages. Layouts are the JAX package's: q ``[B, (T,) KVH, G, hd]``, caches
``[L, N, bs, KVH*hd]``, int8 scales ``[L, N, bs, KVH]`` f32.

``paged_decode_attention`` / ``paged_spec_attention`` launch the kernel
for CUDA tensors and call the plain version for CPU tensors; there is no
fallback from one to the other.

The kernel splits each row into chunks of whole pages (``split_plan``):
one block per (chunk, KV head, row) writes a partial softmax state to
scratch, and a second kernel merges the partials of rows longer than one
chunk. The plan depends only on host-known shapes, never on ``lengths``.
``launches`` counts attention calls: one per call, the split kernel and
its merge together.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from dynamo_tpu_torch.ops import _build

NEG_INF = -1e30
MAX_T = 64          # tree ancestor bits ride a 64-bit mask per query
MAX_HEAD_DIM = 256

CHUNK_POSITIONS = 128  # positions one split block walks (whole pages, at least one)
MAX_CHUNK_PAGES = 256  # the kernel's page list per block

# Attention calls that launched the kernel (read and reset by chip_smoke.py);
# the split kernel and its merge count as one.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def resolve_attn_impl(requested: str, device: torch.device) -> str:
    """'auto' → 'cuda' on a CUDA device, 'torch' (the plain version) on
    the CPU. 'cuda' on a non-CUDA device raises."""
    if requested == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if requested == "cuda" and device.type != "cuda":
        raise ValueError(f"attn_impl='cuda' needs a CUDA device, got {device}")
    if requested not in ("cuda", "torch"):
        raise ValueError(f"unknown attn_impl {requested!r}")
    return requested


@dataclass(frozen=True)
class SplitPlan:
    """How the kernel cuts rows across blocks. ``chunk`` = ``chunk_pages``
    × ``bs`` positions per block; ``splits`` = ceil(W / chunk_pages) blocks
    per (row, KV head). Partials live in ``acc_shape`` and ``ml_shape`` f32
    scratch (None when one split covers the table: every row is written
    directly)."""

    chunk_pages: int
    chunk: int
    splits: int
    acc_shape: tuple[int, ...] | None
    ml_shape: tuple[int, ...] | None


def split_plan(B: int, KVH: int, nq: int, hd: int, W: int, bs: int) -> SplitPlan:
    """The split plan for B rows of a W-page table (block size ``bs``),
    ``nq`` = T·G query columns per KV head of width ``hd``. Only shapes go
    in, so the grid is fixed for a given table width."""
    chunk_pages = max(1, CHUNK_POSITIONS // bs)
    splits = -(-W // chunk_pages)
    acc = ml = None
    if splits > 1:
        acc = (B, KVH, splits, nq, hd)
        ml = (B, KVH, splits, nq, 2)
    return SplitPlan(chunk_pages, chunk_pages * bs, splits, acc, ml)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the oracle for the kernel)
# ---------------------------------------------------------------------------


def gather_dequant_pages(
    layer_cache: torch.Tensor,         # [N, bs, KVH*hd] — one layer's pages
    layer_scale: torch.Tensor | None,  # [N, bs, KVH] f32 | None
    block_tables: torch.Tensor,        # [B, W] int
    KVH: int, hd: int, dtype: torch.dtype,
) -> torch.Tensor:
    """Gather a batch's pages → [B, W*bs, KVH, hd]; int8 pages widen to
    f32, take their per-position-per-head scale and round ONCE into
    ``dtype`` (the same value every reader of the block sees)."""
    B, W = block_tables.shape
    bs = layer_cache.shape[1]
    idx = block_tables.long()
    pages = layer_cache[idx].reshape(B, W * bs, KVH, hd)
    if layer_scale is None:
        return pages
    sc = layer_scale[idx].reshape(B, W * bs, KVH)
    return (pages.float() * sc[..., None]).to(dtype)


def paged_spec_attention_ref(
    q: torch.Tensor,             # [B, T, KVH, G, hd]
    k_cache: torch.Tensor,       # [L, N, bs, KVH*hd]
    v_cache: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [B, W] int32
    lengths: torch.Tensor,       # [B, T] int32 — query t attends [0, lengths[b, t])
    k_scale: torch.Tensor | None = None,  # [L, N, bs, KVH] f32 — int8 cache only
    v_scale: torch.Tensor | None = None,
    anc: torch.Tensor | None = None,      # [B, T, T] — tree topology mask
) -> torch.Tensor:
    """Gather formulation of the multi-query kernel (the JAX package's
    ``paged_spec_attention_xla``). Tree mode: in-flight slot s sits at
    ``lengths[b, t] + s`` and query t attends it when ``anc[b, t, s]``; a
    row with no ``anc`` bit set attends nothing, whatever its lengths, as
    the Pallas kernel's empty rows do (``rowlen = 0``).

    Two deliberate differences from the JAX gather path, both matching
    the kernel: positions that no query of the row attends are zeroed
    before they enter any sum (they may hold garbage or NaN), and a query
    column that attends no position outputs zeros. Returns
    [B, T, KVH, G, hd] in q.dtype."""
    B, T, KVH, G, hd = q.shape
    layer = int(layer_idx)
    sk = sv = None
    if k_scale is not None:
        sk, sv = k_scale[layer], v_scale[layer]
    pk = gather_dequant_pages(k_cache[layer], sk, block_tables, KVH, hd, q.dtype)
    pv = gather_dequant_pages(v_cache[layer], sv, block_tables, KVH, hd, q.dtype)
    ctx = torch.arange(pk.shape[1], device=q.device)
    lens = lengths.long().clamp(min=0)
    attend = ctx[None, None, :] < lens[:, :, None]                 # [B, T, C]
    if anc is not None:
        slot = ctx[None, None, :] - lens[:, :, None]
        in_window = (slot >= 0) & (slot < T)
        anc_g = torch.gather(anc != 0, 2, slot.clamp(0, T - 1))
        attend = attend | (in_window & anc_g)
        attend = attend & (anc != 0).flatten(1).any(dim=1)[:, None, None]
    seen = attend.any(dim=1)[:, :, None, None]                     # [B, C, 1, 1]
    pk = torch.where(seen, pk, torch.zeros((), dtype=pk.dtype, device=pk.device))
    pv = torch.where(seen, pv, torch.zeros((), dtype=pv.dtype, device=pv.device))
    mask = attend[:, :, None, None, :]
    s = torch.einsum("btkgh,bckh->btkgc", q, pk).float() * hd ** -0.5
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros((), device=q.device)).to(q.dtype)
    return torch.einsum("btkgc,bckh->btkgh", p, pv)


def paged_decode_attention_ref(
    q: torch.Tensor,             # [B, KVH, G, hd]
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [B, W]
    lengths: torch.Tensor,       # [B] — attend positions [0, length)
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """T=1 case of ``paged_spec_attention_ref`` → [B, KVH, G, hd]."""
    return paged_spec_attention_ref(
        q[:, None], k_cache, v_cache, layer_idx, block_tables, lengths[:, None],
        k_scale, v_scale,
    )[:, 0]


# ---------------------------------------------------------------------------
# Wrappers: the CUDA kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------


def paged_decode_attention(
    q, k_cache, v_cache, layer_idx, block_tables, lengths, k_scale=None, v_scale=None,
) -> torch.Tensor:
    """Decode attention, q [B, KVH, G, hd], lengths [B] → [B, KVH, G, hd]."""
    return paged_spec_attention(
        q.unsqueeze(1), k_cache, v_cache, layer_idx, block_tables, lengths.unsqueeze(1),
        k_scale, v_scale,
    ).squeeze(1)


def paged_spec_attention(
    q, k_cache, v_cache, layer_idx, block_tables, lengths, k_scale=None, v_scale=None,
    anc=None,
) -> torch.Tensor:
    """Multi-query attention, q [B, T, KVH, G, hd], lengths [B, T]
    (tree mode with ``anc`` [B, T, T]) → [B, T, KVH, G, hd]."""
    if q.device.type == "cpu":
        return paged_spec_attention_ref(
            q, k_cache, v_cache, layer_idx, block_tables, lengths, k_scale, v_scale, anc,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on CUDA or CPU tensors, got {q.device}")
    return _launch(q, k_cache, v_cache, int(layer_idx), block_tables, lengths,
                   k_scale, v_scale, anc)


def _launch(q, k_cache, v_cache, layer, block_tables, lengths, k_scale, v_scale, anc):
    global launches
    if q.dim() != 5:
        raise ValueError(f"q must be [B, T, KVH, G, hd], got {tuple(q.shape)}")
    B, T, KVH, G, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("k_cache/v_cache must both be [L, N, bs, KVH*hd]")
    L, N, bs, D = k_cache.shape
    if D != KVH * hd:
        raise ValueError(f"cache lanes {D} != KVH*hd = {KVH}*{hd}")
    if hd % 32 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 32 up to {MAX_HEAD_DIM}, got {hd}")
    if T > MAX_T:
        raise ValueError(f"at most {MAX_T} query positions per row, got {T}")
    if B > 65535:
        raise ValueError(f"at most 65535 rows per call, got {B}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    quant = k_cache.dtype == torch.int8
    if not quant and k_cache.dtype != q.dtype:
        raise ValueError(f"cache dtype {k_cache.dtype} must be q's ({q.dtype}) or int8")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError("k_cache and v_cache dtypes differ")
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pages need k_scale and v_scale")
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (L, N, bs, KVH):
                raise ValueError(f"scales must be f32 [L, N, bs, KVH], got {sc.dtype} {tuple(sc.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or block_tables.dtype != torch.int32:
        raise ValueError("block_tables must be int32 [B, W]")
    if tuple(lengths.shape) != (B, T) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32 [B, T]")
    if anc is not None:
        if tuple(anc.shape) != (B, T, T):
            raise ValueError("anc must be [B, T, T]")
        if anc.dtype != torch.int8:
            anc = (anc != 0).to(torch.int8)
    tensors = [q, k_cache, v_cache, block_tables, lengths]
    tensors += [k_scale, v_scale] if quant else []
    tensors += [anc] if anc is not None else []
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, found {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged attention operands must be contiguous")
    lib = _build.library("paged_attention")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("cache storage must be 16-byte aligned")
    if q.data_ptr() % 16:  # the kernel copies q rows 16 bytes at a time
        q = q.clone()
    W = block_tables.shape[1]
    plan = split_plan(B, KVH, T * G, hd, W, bs)
    out = torch.empty_like(q)
    acc = ml = None
    if plan.splits > 1:
        acc = torch.empty(plan.acc_shape, dtype=torch.float32, device=q.device)
        ml = torch.empty(plan.ml_shape, dtype=torch.float32, device=q.device)
    fn = lib.dtpu_paged_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        block_tables.data_ptr(), lengths.data_ptr(),
        anc.data_ptr() if anc is not None else None, out.data_ptr(),
        acc.data_ptr() if acc is not None else None, ml.data_ptr() if ml is not None else None,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype],
        B, T, KVH, G, hd, N, bs, W, layer, plan.chunk_pages, plan.splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "paged_attention launch")
    launches += 1
    return out
