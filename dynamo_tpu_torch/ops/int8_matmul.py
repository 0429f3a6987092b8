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
- CUDA, M ≤ ``MAX_M`` rows (every decode batch bucket) and w contiguous:
  the kernel. ``launches`` counts its calls (the split kernel and its merge
  count as one).
- CUDA, M ≤ ``MAX_M`` rows and w the transpose of a contiguous ``[N, K]``
  (the tied embedding ``[V, D]`` used as ``emb.T`` by ``_logits``): the
  kernel's tied-head entry, which reads w as stored, one byte per weight,
  with the same epilogue. ``tied_launches`` counts its calls.
- CUDA, more rows (prefill chunks), or any other w layout: the prefill
  route, which dequantizes w into a scratch in x's dtype and calls
  ``torch.matmul``. Such products are bound by operations, not weight
  bytes, at these row counts. ``prefill_launches`` counts its calls.

A CUDA call launches the kernel or raises; it never reaches the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _build

MAX_M = 64         # the kernel's row limit: the largest decode batch bucket
BN, BK = 128, 128  # the kernel's columns per block and k rows per tile
RESIDENT_BLOCKS = 264  # blocks the H100's 132 SMs hold at once (2 each at M <= 8)

# Calls that launched the kernel / took the prefill route / launched the
# tied-head entry (read and reset by chip_smoke.py; CUDA-graph replays add
# the calls their graph holds).
launches = 0
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
    if w.dim() != 2 or w.dtype != torch.int8:
        raise ValueError(f"w must be int8 [K, N], got {w.dtype} {tuple(w.shape)}")
    K, N = w.shape
    if x.shape[-1] != K:
        raise ValueError(f"x's last dim {x.shape[-1]} != K = {K}")
    which = route(x, w)
    if which == "prefill":
        return _prefill_route(x, w, scale, out_f32)
    return _launch(x, w, scale, out_f32, x.numel() // K if K else 0, K, N, which == "tied")


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The shape rule for a CUDA call: for at most ``MAX_M`` rows of x,
    "kernel" for a contiguous w and "tied" for the transpose of a
    contiguous [N, K] (its tied-head entry); "prefill" otherwise."""
    K = w.shape[0]
    M = x.numel() // K if K else 0
    if M > MAX_M:
        return "prefill"
    if w.is_contiguous():
        return "kernel"
    return "tied" if w.T.is_contiguous() else "prefill"


def _launch(x, w, scale, out_f32, M, K, N, tied=False):
    global launches, tied_launches
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype not in _DTYPE_CODES or tuple(scale.shape) != (N,):
        raise ValueError(f"scale must be f32 or bf16 [{N}], got {scale.dtype} {tuple(scale.shape)}")
    for t in (w, scale):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, found {t.device}")
    lib = _build.library("int8_matmul")
    lead = x.shape[:-1]
    x2 = x.reshape(M, K)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.contiguous() if not x2.is_contiguous() else x2.clone()
    scale = scale.contiguous()
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
