"""KV pages moved between the two packages' engines, on the CPU.

A JAX ``TpuEngine`` prefills a prompt and exports its KV pages (one-shot,
or streamed chunk by chunk over the JAX stream's frames, packed with
msgpack and assembled by the port's reader), and a port ``TorchEngine``
injects them and decodes; and the reverse. Both engines hold the same
weights (JAX ``init_params`` exported to numpy), test-tiny in float32, with
float32 or int8 pages. The injected run is a prefix hit, so it is held
against the JAX engine's own prefix-hit run of the same request (hit
against hit): greedy tokens equal. In the reverse direction the port
engine's prefix-hit run gives the same tokens too.
"""

from __future__ import annotations

import asyncio

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.transfer import stream as jstream
from dynamo_tpu_torch.engine.config import EngineArgs as TArgs
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime import msgpack_lite
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.transfer import stream as tstream

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            max_prefill_tokens=16, dtype="float32", decode_steps=4)
N = 10


@pytest.fixture(scope="module")
def loop():
    """One event loop for the module: the engines post to the loop they
    started on, and they serve every case here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines(loop):
    params = jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))
    out = {}
    for kv_quant in ("none", "int8"):
        j = TpuEngine(JArgs(model=JCfg(), attn_impl="xla", kv_quant=kv_quant, **ARGS),
                      params=params)
        t = TorchEngine(TArgs(model=TCfg(), device="cpu", kv_quant=kv_quant, **ARGS),
                        params=params_from_numpy(params, "cpu", torch.float32))
        out[kv_quant] = (loop.run_until_complete(j.start()), loop.run_until_complete(t.start()))
    yield out
    for j, t in out.values():
        loop.run_until_complete(j.stop())
        loop.run_until_complete(t.stop())


def request(prompt, max_tokens, **ktp) -> dict:
    d = {"model": "test-tiny", "token_ids": list(prompt),
         "sampling": {"temperature": 0.0, "seed": 0},
         "stop": {"max_tokens": max_tokens, "ignore_eos": True}}
    if ktp:
        d["kv_transfer_params"] = ktp
    return d


async def run(engine, req):
    ctx = JContext() if isinstance(engine, TpuEngine) else Context()
    toks, final = [], None
    async for item in engine.generate(req, ctx):
        toks.extend(item.get("token_ids") or [])
        if item.get("finish_reason"):
            final = item
    return toks, final


def over_the_wire(chunks, to_port: bool) -> list[dict]:
    """Exported chunks → the consumer package's inject chunk dicts, through
    the publisher's frames packed with msgpack and the consumer's reader."""
    src, dst = (jstream, tstream) if to_port else (tstream, jstream)
    out = []
    for idx, chunk in enumerate(chunks):
        asm = dst.KvChunkAssembler()
        got = None
        for f in src.chunk_to_frames(idx, chunk, 256):
            raw = msgpack.packb(f, use_bin_type=True) if to_port else msgpack_lite.packb(f)
            got = asm.feed(msgpack_lite.unpackb(raw) if to_port else
                           msgpack.unpackb(raw, raw=False)) or got
        out.append(got.to_wire())
    return out


async def export(engine, prompt, mode, handle):
    """Prefill-only export of ``prompt`` → the inject payload its consumer
    reads: a one-shot payload dict, or the stream's chunks."""
    ktp = {"do_remote_decode": True}
    if mode == "stream":
        ktp["stream_handle"] = handle
    _, final = await run(engine, request(prompt, 1, **ktp))
    meta = final["kv_transfer_params"]
    assert meta["num_blocks"] == (len(prompt) - 1) // 4
    if mode == "oneshot":
        return engine.take_export(meta["remote_handle"]).to_dict(), None
    exp = engine.get_stream_export(handle)
    assert exp.sealed and exp.num_blocks == meta["num_blocks"]
    chunks = [c for _, c in exp.chunks_since(0, 1 << 30)]
    engine.release_stream_export(handle)
    return None, chunks


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["oneshot", "stream"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_pages_move_between_the_engines(loop, engines, direction, mode, kv_quant):
    jeng, teng = engines[kv_quant]
    src, dst = (jeng, teng) if direction == "jax_to_port" else (teng, jeng)
    seed = {"jax_to_port": 0, "port_to_jax": 1}[direction] * 4 + \
        {"oneshot": 0, "stream": 2}[mode] + {"none": 0, "int8": 1}[kv_quant]
    prompt = np.random.default_rng(100 + seed).integers(1, 500, size=43).tolist()

    async def go():
        for e in (jeng, teng):
            e.clear_kv_blocks()
        payload, chunks = await export(src, prompt, mode, f"h-{direction}-{mode}-{kv_quant}")
        if chunks is not None:
            assert len(chunks) >= 2  # 16-token prefill chunks: streamed during the prefill
            payload = {"chunks": over_the_wire(chunks, direction == "jax_to_port"),
                       "num_tokens": 40, "num_blocks": 10}
        # The JAX engine's hit-against-hit reference: a cold run caches the
        # prompt, the next run of it is a prefix hit.
        jeng.clear_kv_blocks()
        await run(jeng, request(prompt, N))
        jhit, _ = await run(jeng, request(prompt, N))
        dst.clear_kv_blocks()
        before = dst.total_prefilled
        got, _ = await run(dst, request(prompt, N, inject=payload))
        # only the suffix past the 10 injected blocks was prefilled here
        assert dst.total_prefilled - before == len(prompt) - 40
        thit = None
        if direction == "port_to_jax":
            teng.clear_kv_blocks()
            await run(teng, request(prompt, N))
            thit, _ = await run(teng, request(prompt, N))
        return got, jhit, thit

    got, jhit, thit = loop.run_until_complete(go())
    assert len(got) == N and got == jhit
    if thit is not None:
        assert thit == jhit
    if dst is teng:
        assert teng.inject_bytes > 0
