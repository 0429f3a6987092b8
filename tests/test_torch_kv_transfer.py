"""KV page movement of the port (``dynamo_tpu_torch/engine/kv_transfer.py``)
against the JAX package's (``dynamo_tpu/engine/kv_transfer.py``), on the CPU.

Pages are made from a numpy seed at test-tiny geometry. Extraction from a
port cache equals extraction from a JAX cache holding the same pages;
injection writes in place (the cache tensors keep their addresses, which
captured CUDA graphs replay against); the wire format is byte for byte the
JAX one in both directions (``to_dict``, ``to_frames`` packed with msgpack),
for float32, bfloat16 and int8 pages, with truncation detected; host int8
quantization is bit-equal to the JAX package's and to the port's device
``kv_quantize``, and ``adapt_pages`` bridges both ways as the JAX one does.
The port's host bf16 pages are uint16 bit patterns; ml_dtypes is only
imported here, to build the JAX side.
"""

from __future__ import annotations

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.engine import kv_transfer as jkt
from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.transfer import stream as jstream
from dynamo_tpu_torch.engine import kv_transfer as tkt
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.runner import LocalRunner, start_host_fetch
from dynamo_tpu_torch.runtime import msgpack_lite
from dynamo_tpu_torch.transfer import stream as tstream

CFG = ModelConfig()  # test-tiny
KVH = CFG.num_kv_heads
N_BLOCKS, BS = 16, 4
KINDS = ["float32", "bfloat16", "int8"]


def host_pages(kind: str, n: int, seed: int) -> tuple:
    """Port host pages [L, n, bs, KVH*hd] (+ scales for int8), from a seed:
    bf16 as uint16 bit patterns, as the port keeps them."""
    rng = np.random.default_rng(seed)
    shape = (CFG.num_layers, n, BS, KVH * CFG.head_dim)
    if kind == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        sshape = shape[:3] + (KVH,)
        return (k, v, rng.random(sshape, np.float32) + 0.01, rng.random(sshape, np.float32) + 0.01)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if kind == "bfloat16":
        return k.astype(ml_dtypes.bfloat16).view(np.uint16), v.astype(ml_dtypes.bfloat16).view(np.uint16)
    return k, v


def to_jax_pages(pages: tuple) -> tuple:
    """Port host pages → the JAX package's (bf16 as ml_dtypes.bfloat16)."""
    return tuple(p.view(ml_dtypes.bfloat16) if p.dtype == np.uint16 else p for p in pages)


def bits(a: np.ndarray) -> np.ndarray:
    """An array's bit patterns, comparable across bf16 representations."""
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def port_cache(kind: str) -> TM.KVCache:
    dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
    return TM.init_kv_cache(CFG, N_BLOCKS, BS, dtype, torch.device("cpu"),
                            kv_quant="int8" if kind == "int8" else "none")


def jax_cache(kind: str) -> JM.KVCache:
    dtype = jnp.bfloat16 if kind == "bfloat16" else jnp.float32
    return JM.init_kv_cache(JCfg(), N_BLOCKS, BS, dtype,
                            kv_quant="int8" if kind == "int8" else "none")


def filled(kind: str, seed: int = 0):
    """A port cache and a JAX cache holding the same pages in every block."""
    pages = host_pages(kind, N_BLOCKS, seed)
    tc = port_cache(kind)
    tkt.inject_pages(tc, list(range(N_BLOCKS)), *pages)
    jc = jkt.inject_pages(jax_cache(kind), list(range(N_BLOCKS)), *to_jax_pages(pages))
    return pages, tc, jc


@pytest.mark.parametrize("kind", KINDS)
def test_extract_inject_roundtrip_in_place(kind):
    pages, cache, _ = filled(kind)
    ptrs = [a.data_ptr() for a in tkt._cache_arrays(cache)]
    ids = [3, 7, 2]
    got = tkt.extract_pages(cache, ids)
    assert len(got) == len(pages)
    for g, p in zip(got, pages):
        assert g.dtype == p.dtype and g.shape[1] == 3
        np.testing.assert_array_equal(g, p[:, ids])
    # The async path: gather, device→host fetch, harvest.
    arrs, n = tkt.start_extract(cache, ids)
    for g, p in zip(tkt.finish_extract(start_host_fetch(arrs).wait(), n), pages):
        np.testing.assert_array_equal(g, p[:, ids])
    # Into other blocks of a fresh cache, through the wire; written in place.
    back = tkt.KvPagePayload.from_dict(tkt.KvPagePayload.from_pages(got, 12).to_dict())
    fresh = port_cache(kind)
    fresh_ptrs = [a.data_ptr() for a in tkt._cache_arrays(fresh)]
    assert tkt.inject_pages(fresh, [5, 1, 9], *back.pages()) is fresh
    assert [a.data_ptr() for a in tkt._cache_arrays(fresh)] == fresh_ptrs
    for a, p in zip(tkt.finish_extract([t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                                        else t.numpy() for t in tkt._cache_arrays(fresh)],
                                       N_BLOCKS), pages):
        np.testing.assert_array_equal(a[:, [5, 1, 9]], p[:, ids])
        assert not a[:, 4].any()  # untouched block stays zero
    assert [a.data_ptr() for a in tkt._cache_arrays(cache)] == ptrs


@pytest.mark.parametrize("kind", KINDS)
def test_extract_equals_the_jax_extract(kind):
    _, tc, jc = filled(kind, seed=1)
    ids = [0, 11, 4, 4, 15]
    for t, j in zip(tkt.extract_pages(tc, ids), jkt.extract_pages(jc, ids)):
        np.testing.assert_array_equal(t, bits(j))


def test_inject_refuses_a_mismatched_payload():
    cache = port_cache("float32")
    k, v = host_pages("float32", 2, seed=15)
    with pytest.raises(ValueError, match="page count mismatch"):
        tkt.inject_pages(cache, [1, 2, 3], k, v)
    with pytest.raises(ValueError, match="arity"):
        tkt.inject_pages(port_cache("int8"), [1, 2], k, v)
    assert not cache.k.any()


def test_runner_injects_in_place_and_adapts():
    """The runner writes pages into the cache it was started with (never a
    new one) and bridges a float payload into its int8 pages."""
    args = EngineArgs(model=CFG, block_size=BS, num_kv_blocks=N_BLOCKS, max_num_seqs=2,
                      max_model_len=32, dtype="float32", kv_quant="int8", device="cpu")
    runner = LocalRunner(args)
    runner.start()
    cache = runner.cache
    ptrs = [a.data_ptr() for a in tkt._cache_arrays(cache)]
    k, v = host_pages("float32", 2, seed=2)
    runner.inject_pages([6, 3], k, v)
    assert runner.cache is cache and [a.data_ptr() for a in tkt._cache_arrays(cache)] == ptrs
    for got, want in zip(runner.extract_pages([6, 3]), tkt.quantize_pages_np(k, v, KVH)):
        np.testing.assert_array_equal(got, want)
    arrs, n = runner.start_extract_pages([3])
    np.testing.assert_array_equal(runner.finish_extract_pages(start_host_fetch(arrs), n)[0],
                                  runner.extract_pages([3])[0])


@pytest.mark.parametrize("kind", KINDS)
def test_wire_is_byte_identical_both_ways(kind):
    pages = host_pages(kind, 3, seed=3)
    tp = tkt.KvPagePayload.from_pages(pages, 12)
    jp = jkt.KvPagePayload.from_pages(to_jax_pages(pages), 12)
    assert tp.to_dict() == jp.to_dict()
    tframes = [msgpack_lite.packb(f) for f in tp.to_frames(max_bytes=100)]
    jframes = [msgpack.packb(f, use_bin_type=True) for f in jp.to_frames(max_bytes=100)]
    assert tframes == jframes and len(tframes) > 4
    # JAX frames read by the port, and port frames read by the JAX package.
    from_jax = tkt.KvPagePayload.from_frames([msgpack_lite.unpackb(f) for f in jframes])
    from_port = jkt.KvPagePayload.from_frames([msgpack.unpackb(f, raw=False) for f in tframes])
    for a, b, p in zip(from_jax.pages(), from_port.pages(), pages):
        np.testing.assert_array_equal(a, p)
        np.testing.assert_array_equal(bits(b), p)
    assert str(from_port.k.dtype) == ("bfloat16" if kind == "bfloat16" else str(pages[0].dtype))
    assert from_jax.num_tokens == from_port.num_tokens == 12
    # In process, the port's frames are read without being packed.
    local = tkt.KvPagePayload.from_frames(list(tp.to_frames(max_bytes=100)))
    for a, p in zip(local.pages(), pages):
        np.testing.assert_array_equal(a, p)


@pytest.mark.parametrize("kind", KINDS)
def test_truncated_frames_are_detected(kind):
    pages = host_pages(kind, 2, seed=4)
    for payload, frames in (
            (tkt.KvPagePayload, list(tkt.KvPagePayload.from_pages(pages, 8).to_frames(64))),
            (tkt.KvPagePayload, list(jkt.KvPagePayload.from_pages(to_jax_pages(pages), 8)
                                     .to_frames(64)))):
        with pytest.raises(ValueError, match="truncated"):
            payload.from_frames(frames[:-1])
    asm = tstream.KvChunkAssembler()
    frames = list(tstream.chunk_to_frames(0, tstream.KvChunk(0, pages, 8), 64))
    for f in frames[:-1]:
        assert asm.feed(f) is None
    assert asm.mid_chunk


def test_frames_stay_under_the_cap_and_copy_nothing():
    pages = host_pages("bfloat16", 6, seed=5)
    frames = list(tkt.KvPagePayload.from_pages(pages, 24).to_frames(max_bytes=1000))
    data = frames[1:]
    assert all(len(f["data"]) <= 1000 for f in data)
    assert sum(len(f["data"]) for f in data) == pages[0].nbytes + pages[1].nbytes
    # data frames are views of the pages, not copies
    assert all(isinstance(f["data"], memoryview) for f in data)
    assert np.shares_memory(np.frombuffer(data[0]["data"], np.uint8), pages[0])


@pytest.mark.parametrize("kind", KINDS)
def test_streamed_chunks_cross_packages(kind):
    """A chunk framed by the JAX stream is assembled by the port's, and the
    reverse; the dtype name survives for bf16."""
    pages = host_pages(kind, 3, seed=6)
    jchunk = jstream.KvChunk(block_offset=5, pages=to_jax_pages(pages), num_tokens=12)
    tchunk = tstream.KvChunk(block_offset=5, pages=pages, num_tokens=12)
    for frames, asm, want in (
            (jstream.chunk_to_frames(7, jchunk, 128), tstream.KvChunkAssembler(), bits),
            (tstream.chunk_to_frames(7, tchunk, 128), jstream.KvChunkAssembler(), bits)):
        out = None
        for f in frames:
            f = msgpack.unpackb(msgpack.packb(f, use_bin_type=True), raw=False)
            out = asm.feed(f) or out
        assert out.block_offset == 5 and out.num_tokens == 12
        for a, p in zip(out.pages, pages):
            np.testing.assert_array_equal(want(a), p)
    assert tchunk.to_wire() == jchunk.to_wire()


def _special_values(shape, seed):
    """Page values with the quantizer's edge cases: an all-zero head, exact
    .5 ties after scaling, and the absmax at either sign."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    hd = CFG.head_dim
    x[0, 0, 0, :hd] = 0.0                               # zero head: scale 1, q 0
    x[0, 0, 1, :hd] = np.arange(hd) - hd / 2 + 0.5      # halves after scaling
    x[0, 0, 1, 0] = 127.0
    x[-1, -1, -1, -hd:] = -np.linspace(0, 254, hd)      # negative absmax
    return x


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_host_quantization_bit_equal_to_jax_and_to_the_device(kind):
    shape = (CFG.num_layers, 3, BS, KVH * CFG.head_dim)
    k, v = _special_values(shape, 7), _special_values(shape, 8)
    if kind == "bfloat16":
        k = k.astype(ml_dtypes.bfloat16).view(np.uint16)
        v = v.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = tkt.quantize_pages_np(k, v, KVH)
    want = jkt.quantize_pages_np(*to_jax_pages((k, v)), KVH)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # The port's device quantizer on the same values (CPU tensors).
    for x, q, s in ((k, got[0], got[2]), (v, got[1], got[3])):
        t = torch.from_numpy(tkt._as_f32(x)).reshape(*shape[:3], KVH, CFG.head_dim)
        dq, ds = TM.kv_quantize(t)
        np.testing.assert_array_equal(dq.reshape(shape).numpy(), q)
        np.testing.assert_array_equal(ds.numpy(), s)


@pytest.mark.parametrize("dense", ["float32", "bfloat16"])
def test_adapt_pages_both_directions_equal_jax(dense):
    # dense payload → int8 cache
    k, v = host_pages(dense, 2, seed=9)
    got = tkt.adapt_pages((k, v), port_cache("int8"), KVH)
    want = jkt.adapt_pages(to_jax_pages((k, v)), jax_cache("int8"), KVH)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # int8 payload → dense cache (bf16 rounded to nearest even, as ml_dtypes)
    q = host_pages("int8", 2, seed=10)
    got = tkt.adapt_pages(q, port_cache(dense), KVH)
    want = jkt.adapt_pages(q, jax_cache(dense), KVH)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, bits(b))
    # matching formats pass through untouched
    assert tkt.adapt_pages(q, port_cache("int8"), KVH) is q


def test_bf16_rounding_matches_torch():
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 1e3,
                        np.array([0.0, -0.0, np.inf, -np.inf, 3.4e38, -3.4e38, 1e-40,
                                  1.00390625, 1.01171875], np.float32)])
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(tkt.f32_to_bf16_bits(x), want)
    assert np.isnan(tkt.bf16_bits_to_f32(tkt.f32_to_bf16_bits(np.array([np.nan], np.float32))))
    np.testing.assert_array_equal(tkt.bf16_bits_to_f32(want), x.astype(ml_dtypes.bfloat16)
                                  .astype(np.float32))


@pytest.mark.parametrize("quantized", [False, True])
def test_concat_and_split_page_runs_equal_jax(quantized):
    run = [host_pages("bfloat16", 1, seed=12), host_pages("int8", 1, seed=13),
           host_pages("bfloat16", 1, seed=14)]
    got = tkt.concat_page_run(run, quantized=quantized, num_kv_heads=KVH, dtype="bfloat16")
    want = jkt.concat_page_run([to_jax_pages(b) for b in run], quantized=quantized,
                               num_kv_heads=KVH, dtype="bfloat16")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, bits(b))
    for a, b in zip(tkt.split_page_run(got, 3), jkt.split_page_run(want, 3)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, bits(y))


@pytest.mark.parametrize("written,cursor,n_blocks", [(0, 0, 4), (17, 2, 8), (40, 3, 6),
                                                     (9, 5, 8)])
def test_delta_blocks_equal_jax(written, cursor, n_blocks):
    assert tkt.delta_blocks(written, BS, cursor, n_blocks) == \
        jkt.delta_blocks(written, BS, cursor, n_blocks)
