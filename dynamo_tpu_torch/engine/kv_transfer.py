"""KV page movement: device↔host extraction and injection of paged-cache
blocks, and the host-side wire format (port of
``dynamo_tpu/engine/kv_transfer.py``, same names).

Pages travel as ``[L, n, bs, KVH*hd]`` arrays (k, v), plus
``[L, n, bs, KVH]`` f32 scales (k_scale, v_scale) for int8 storage: a
slice of the cache's native layout, so extraction is one ``index_select``
per cache array and injection one in-place ``index_copy_``. The cache is
never rebound: captured CUDA graphs replay against its tensors'
addresses, so a write that allocated new tensors would leave every graph
reading the old pages.

Host pages are numpy arrays. numpy has no bfloat16, so host bf16 pages
are ``uint16`` arrays of the bf16 bit patterns (no cache stores uint16,
so the dtype names them); they travel under the dtype name
``"bfloat16"`` and become bf16 again only when written to the cache. The
wire format (``KvPagePayload.to_dict`` / ``to_frames``) is byte for byte
the JAX package's, so pages move between the two packages' engines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dynamo_tpu_torch.engine.model import KVCache

_TORCH_OF = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
             np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32}
_NAME_OF = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32",
            torch.int8: "int8"}


def _cache_arrays(cache: KVCache) -> tuple:
    """The cache's page-parallel arrays in wire order: (k, v) or
    (k, v, k_scale, v_scale) for int8 storage."""
    if cache.k_scale is not None:
        return (cache.k, cache.v, cache.k_scale, cache.v_scale)
    return (cache.k, cache.v)


def _dtype_name(dtype) -> str:
    """A dense page dtype (torch dtype, numpy dtype or name) → its wire
    name; host uint16 pages are bf16 bit patterns."""
    if isinstance(dtype, torch.dtype):
        return _NAME_OF[dtype]
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    return "bfloat16" if name == "uint16" else name


def _host_dtype(name: str) -> np.dtype:
    """Wire dtype name → the host array dtype that holds it."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns → float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → bf16 bit patterns, rounding to nearest even (the rounding
    of ml_dtypes' and torch's casts); NaNs stay quiet NaNs."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    nan = np.isnan(x)
    r = ((np.where(nan, 0, u) + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    if nan.any():
        r[nan] = ((u[nan] >> 16) | 0x40).astype(np.uint16)
    return r


def _as_f32(x: np.ndarray) -> np.ndarray:
    return bf16_bits_to_f32(x) if x.dtype == np.uint16 else np.asarray(x, np.float32)


def _cast_dense(x: np.ndarray, name: str) -> np.ndarray:
    """float32 → the dense host dtype named ``name``."""
    return f32_to_bf16_bits(x) if name == "bfloat16" else x.astype(np.dtype(name))


def _index(block_ids, device: torch.device) -> torch.Tensor:
    """Block ids as an index tensor on ``device``, uploaded from pinned
    memory without waiting for the device."""
    ids = torch.as_tensor(np.asarray(block_ids, np.int64))
    if device.type == "cpu":
        return ids
    return ids.pin_memory().to(device, non_blocking=True)


def start_extract(cache: KVCache, block_ids: list[int]) -> tuple:
    """Enqueue the page gather without waiting → (device tensors, each
    [L, n, bs, ...], n). bf16 arrays come back viewed as int16, the dtype
    the host fetch can hand to numpy. The gather is enqueued on the
    current stream after every dispatch already made (so it reads the
    prefill chunks that wrote these blocks) and before any later one (so
    it reads them before a freed block is rewritten); the caller starts
    the device→host copy (runner.start_host_fetch) and harvests with
    ``finish_extract`` once it has landed."""
    arrs = _cache_arrays(cache)
    idx = _index(block_ids, arrs[0].device)
    out = []
    for a in arrs:
        g = a.index_select(1, idx)
        out.append(g.view(torch.int16) if g.dtype == torch.bfloat16 else g)
    return tuple(out), len(block_ids)


def finish_extract(host_arrays, n: int) -> tuple:
    """Host copies of a ``start_extract`` result (numpy) → host pages
    [L, n, ...]; bf16 pages as uint16 bit patterns."""
    return tuple(
        (a.view(np.uint16) if a.dtype == np.int16 else a)[:, :n] for a in host_arrays
    )


def extract_pages(cache: KVCache, block_ids: list[int]) -> tuple:
    """Copy the named blocks to the host → (k, v) numpy pages, each
    [L, n, bs, KVH*hd], plus (k_scale, v_scale) [L, n, bs, KVH] when the
    cache stores int8. Synchronous."""
    out, n = start_extract(cache, block_ids)
    return finish_extract([t.cpu().numpy() for t in out], n)


def _to_device(p: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """One host page array → a tensor of ``like``'s dtype on its device.
    On the card it goes up from pinned memory without waiting (the caching
    host allocator keeps the buffer until the copy has run)."""
    wire = p.view(np.int16) if p.dtype == np.uint16 else p
    cuda = like.device.type == "cuda"
    host = torch.empty(wire.shape, dtype=_TORCH_OF[wire.dtype], pin_memory=cuda)
    host.numpy()[...] = wire
    dev = host.to(like.device, non_blocking=True) if cuda else host
    if p.dtype == np.uint16:
        dev = dev.view(torch.bfloat16)
    return dev.to(like.dtype)


def inject_pages(cache: KVCache, block_ids: list[int], *pages) -> KVCache:
    """Write host pages into the named blocks, in place (the same cache
    comes back). ``pages`` is the tuple ``extract_pages`` produced: (k, v)
    or (k, v, k_scale, v_scale); the arity must match the cache's storage
    (``adapt_pages`` converts foreign payloads first). The writes are
    enqueued on the current stream, so every later dispatch reads them."""
    arrs = _cache_arrays(cache)
    if len(pages) != len(arrs):
        raise ValueError(
            f"page payload arity {len(pages)} does not match cache storage "
            f"({'int8' if cache.k_scale is not None else 'dense'}); "
            f"adapt_pages() the payload first"
        )
    n = len(block_ids)
    if any(p.shape[1] != n for p in pages):
        raise ValueError(f"page count mismatch: {[p.shape[1] for p in pages]} pages "
                         f"for {n} blocks")
    if n == 0:
        return cache
    idx = _index(block_ids, arrs[0].device)
    for a, p in zip(arrs, pages):
        a.index_copy_(1, idx, _to_device(p, a))
    return cache


def delta_blocks(kv_written: int, block_size: int, cursor: int, n_blocks: int) -> tuple[int, int]:
    """→ ``(lo, hi)`` — the full-block delta a live migration still has to
    ship: blocks ``[cursor, hi)`` where ``hi`` counts only positions whose
    KV is written (``kv_written``), clamped to the allocated block list."""
    hi = min(kv_written // block_size, n_blocks)
    return cursor, max(hi, cursor)


def quantize_pages_np(k: np.ndarray, v: np.ndarray, num_kv_heads: int):
    """Host-side int8 quantization of float pages [L, n, bs, KVH*hd] →
    (k int8, v int8, k_scale f32 [L, n, bs, KVH], v_scale f32). The absmax
    scheme, round-half-even and all-zero scale of the device's
    ``model.kv_quantize``, so a page quantized on the host equals one
    quantized on the device (a float prefill worker feeding an int8
    decode worker)."""
    def one(x):
        L, n, bs, D = x.shape
        hd = D // num_kv_heads
        xf = _as_f32(x).reshape(L, n, bs, num_kv_heads, hd)
        absmax = np.max(np.abs(xf), axis=-1)
        scale = np.where(absmax > 0, absmax, np.float32(127.0)) / np.float32(127.0)
        q = np.clip(np.rint(xf / scale[..., None]), -127, 127).astype(np.int8)
        return q.reshape(L, n, bs, D), scale.astype(np.float32)

    kq, ks = one(k)
    vq, vs = one(v)
    return kq, vq, ks, vs


def dequantize_pages_np(k, v, k_scale, v_scale, num_kv_heads: int, dtype):
    """Inverse adapter: int8 pages + scales → float pages in ``dtype`` (a
    name, numpy or torch dtype; bfloat16 as uint16 bit patterns)."""
    name = _dtype_name(dtype)

    def one(q, s):
        L, n, bs, D = q.shape
        hd = D // num_kv_heads
        x = q.reshape(L, n, bs, num_kv_heads, hd).astype(np.float32) * s[..., None]
        return _cast_dense(x.reshape(L, n, bs, D), name)

    return one(k, k_scale), one(v, v_scale)


def adapt_pages(pages: tuple, cache: KVCache, num_kv_heads: int) -> tuple:
    """Convert a page tuple to the cache's storage format: quantize float
    payloads for an int8 cache, dequantize int8 payloads for a float
    cache, pass matching formats through untouched."""
    quant_payload = len(pages) == 4
    quant_cache = cache.k_scale is not None
    if quant_payload == quant_cache:
        return pages
    if quant_cache:
        return quantize_pages_np(pages[0], pages[1], num_kv_heads)
    return dequantize_pages_np(*pages, num_kv_heads=num_kv_heads, dtype=cache.k.dtype)


def concat_page_run(run: list, *, quantized: bool, num_kv_heads: int, dtype) -> tuple:
    """Concatenate a run's per-block page tuples into one batched payload
    in the requested storage format: (k, v) when ``quantized`` is False,
    (k, v, k_scale, v_scale) when True; blocks stored in the other format
    are bridged first. ``dtype`` is the dense page dtype used when
    dequantizing int8 blocks."""
    want = 4 if quantized else 2
    norm = []
    for blk in run:
        if len(blk) == want:
            norm.append(blk)
        elif quantized:
            norm.append(quantize_pages_np(blk[0], blk[1], num_kv_heads))
        else:
            norm.append(dequantize_pages_np(*blk, num_kv_heads=num_kv_heads, dtype=dtype))
    return tuple(np.concatenate([blk[i] for blk in norm], axis=1) for i in range(want))


def split_page_run(pages: tuple, n_blocks: int) -> list[tuple]:
    """Inverse of :func:`concat_page_run`: one batched page tuple →
    per-block tuples ([L, 1, bs, …])."""
    return [
        tuple(np.ascontiguousarray(p[:, i : i + 1]) for p in pages)
        for i in range(n_blocks)
    ]


def _bytes_view(a: np.ndarray) -> memoryview:
    """The array's bytes without a copy (one copy if it is strided)."""
    return memoryview(np.ascontiguousarray(a)).cast("B")


# ---------------------------------------------------------------------------
# Wire format (msgpack-safe dicts with raw bytes)
# ---------------------------------------------------------------------------


@dataclass
class KvPagePayload:
    """Host KV pages + metadata, serializable over the response plane.
    int8 pages carry f32 scale sidecars (``k_scale``/``v_scale``,
    [L, n, bs, KVH])."""

    k: np.ndarray  # [L, n, bs, KVH*hd]; bf16 as uint16 bit patterns
    v: np.ndarray
    num_tokens: int  # prompt positions covered by these pages
    k_scale: np.ndarray | None = None  # [L, n, bs, KVH] f32 — int8 pages only
    v_scale: np.ndarray | None = None

    def pages(self) -> tuple:
        """The page tuple in wire order: (k, v) or (k, v, k_scale, v_scale)."""
        if self.k_scale is not None:
            return (self.k, self.v, self.k_scale, self.v_scale)
        return (self.k, self.v)

    @classmethod
    def from_pages(cls, pages: tuple, num_tokens: int) -> "KvPagePayload":
        """Inverse of ``pages()``."""
        ks, vs = (pages[2], pages[3]) if len(pages) == 4 else (None, None)
        return cls(k=pages[0], v=pages[1], num_tokens=num_tokens, k_scale=ks, v_scale=vs)

    def to_dict(self) -> dict:
        out = {
            "k": np.ascontiguousarray(self.k).tobytes(),
            "v": np.ascontiguousarray(self.v).tobytes(),
            "shape": list(self.k.shape),
            "dtype": _dtype_name(self.k.dtype),
            "num_tokens": self.num_tokens,
        }
        if self.k_scale is not None:
            out["k_scale"] = np.ascontiguousarray(self.k_scale).tobytes()
            out["v_scale"] = np.ascontiguousarray(self.v_scale).tobytes()
            out["scale_shape"] = list(self.k_scale.shape)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "KvPagePayload":
        shape = tuple(d["shape"])
        dt = _host_dtype(d["dtype"])
        k = np.frombuffer(d["k"], dt).reshape(shape)
        v = np.frombuffer(d["v"], dt).reshape(shape)
        ks = vs = None
        if d.get("k_scale") is not None:
            sshape = tuple(d["scale_shape"])
            ks = np.frombuffer(d["k_scale"], np.float32).reshape(sshape)
            vs = np.frombuffer(d["v_scale"], np.float32).reshape(sshape)
        return cls(k=k, v=v, num_tokens=int(d["num_tokens"]), k_scale=ks, v_scale=vs)

    # -- chunked streaming --------------------------------------------------
    #
    # A llama-8b 1536-token export is ~190 MB in bf16: frames of at most
    # max_bytes keep the response plane under its frame cap
    # (runtime/framing.py MAX_FRAME) and the event loop responsive.

    DEFAULT_FRAME_BYTES = 16 << 20

    def to_frames(self, max_bytes: int = DEFAULT_FRAME_BYTES):
        """Yield wire frames: one header, then <=max_bytes data chunks,
        scale sidecars as their own frames after the pages. Data frames
        are memoryview slices of the pages (no copy here: packing a frame
        for the wire is its one copy)."""
        kb, vb = _bytes_view(self.k), _bytes_view(self.v)
        header = {
            "kind": "kv_header",
            "shape": list(self.k.shape),
            "dtype": _dtype_name(self.k.dtype),
            "num_tokens": self.num_tokens,
            "k_bytes": kb.nbytes,
            "v_bytes": vb.nbytes,
        }
        chunks = [("k", kb), ("v", vb)]
        if self.k_scale is not None:
            ksb, vsb = _bytes_view(self.k_scale), _bytes_view(self.v_scale)
            header["scale_shape"] = list(self.k_scale.shape)
            header["k_scale_bytes"] = ksb.nbytes
            header["v_scale_bytes"] = vsb.nbytes
            chunks += [("k_scale", ksb), ("v_scale", vsb)]
        yield header
        for name, buf in chunks:
            for off in range(0, buf.nbytes, max_bytes):
                yield {"kind": name, "data": buf[off : off + max_bytes]}

    @classmethod
    def from_frames(cls, frames: list[dict]) -> "KvPagePayload":
        header = frames[0]
        if header.get("kind") != "kv_header":
            raise ValueError("first frame is not a kv_header")
        bufs = {
            name: b"".join(f["data"] for f in frames[1:] if f["kind"] == name)
            for name in ("k", "v", "k_scale", "v_scale")
        }
        want = {
            "k": header["k_bytes"], "v": header["v_bytes"],
            "k_scale": header.get("k_scale_bytes", 0),
            "v_scale": header.get("v_scale_bytes", 0),
        }
        for name, n in want.items():
            if len(bufs[name]) != n:
                raise ValueError(f"truncated kv stream: {name} {len(bufs[name])}/{n}")
        d = {
            "k": bufs["k"], "v": bufs["v"], "shape": header["shape"],
            "dtype": header["dtype"], "num_tokens": header["num_tokens"],
        }
        if header.get("scale_shape") is not None:
            d["k_scale"] = bufs["k_scale"]
            d["v_scale"] = bufs["v_scale"]
            d["scale_shape"] = header["scale_shape"]
        return cls.from_dict(d)
