"""Live migration between the two packages' engines (CPU).

A sequence decoding on a JAX ``TpuEngine`` is frozen, its KV streamed and
its resume identity handed to a port ``TorchEngine``, which finishes it;
and the reverse. Both engines hold the same weights (JAX ``init_params``
exported to numpy, test-tiny in float32). The protocol is the one
``worker/migrate.py`` drives: ``migration_begin`` and
``migration_cutover`` on the source, the sealed stream pulled through
the destination package's ``pull_kv_stream`` from the source package's
``serve_kv_window`` (frames packed with the source's msgpack and read by
the destination's), ``migration_finish`` with the marker, and the resumed
leg built by the ``Migration`` operator's ``_resume_request`` with the
pulled chunks as its inject. Five kinds of request: greedy, seeded at
temperature 0.7, n-gram speculation (``spec_tokens`` 3, stepwise verify),
a ``response_format`` schema, and a greedy one under a LoRA adapter
registered on both engines. In each, the source leg plus the resumed leg
equal the unmigrated stream, which is the same on either engine, and the
destination's cache holds the source's chunk pages byte for byte, under
the request's (adapter-salted) block hashes. The adapter request's resume
identity names its adapter, and its stream differs from the base
model's.
"""

from __future__ import annotations

import asyncio

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu import tokens as jtokens
from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm.migration import Migration as JMigration
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.transfer import stream as jstream
from dynamo_tpu_torch.engine.config import EngineArgs as TArgs
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.migration import Migration as TMigration
from dynamo_tpu_torch.runtime import msgpack_lite
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.transfer import stream as tstream

BASE = dict(block_size=4, num_kv_blocks=96, max_num_seqs=4, max_model_len=160,
            max_prefill_tokens=64, dtype="float32", decode_steps=4)
EOS = 257
RF = {"type": "json_schema", "json_schema": {"name": "x", "schema": {
    "type": "object", "properties": {"name": {"type": "string", "maxLength": 8},
                                     "age": {"type": "integer"},
                                     "active": {"type": "boolean"}}}}}
KINDS = {
    "greedy": ({}, dict(temperature=0.0, seed=0)),
    "sampled": ({}, dict(temperature=0.7, seed=7)),
    "spec": (dict(spec_tokens=3, spec_gate=0.0, spec_fused=False, pipeline_depth=0,
                  pipeline_windows=False), dict(temperature=0.0, seed=0)),
    "grammar": ({}, dict(temperature=0.0, seed=0, rf=True)),
    "adapter": (dict(lora_slots=2, lora_rank=4), dict(temperature=0.0, seed=0,
                                                      adapter="tenant-a")),
}
N = 40


@pytest.fixture(scope="module")
def loop():
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
    for kind, (kw, _) in KINDS.items():
        j = TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **{**BASE, **kw}), params=params)
        t = TorchEngine(TArgs(model=TCfg(), device="cpu", **{**BASE, **kw}),
                        params=params_from_numpy(params, "cpu", torch.float32))
        if kw.get("lora_slots"):
            for eng in (j, t):
                eng.register_adapter("tenant-a", rank=4, seed=7)
        out[kind] = (loop.run_until_complete(j.start()), loop.run_until_complete(t.start()))
    yield out
    for j, t in out.values():
        loop.run_until_complete(j.stop())
        loop.run_until_complete(t.stop())


def request(kind: str, prompt: list[int]) -> dict:
    s = KINDS[kind][1]
    req = {"model": "test-tiny", "token_ids": list(prompt),
           "sampling": {"temperature": s["temperature"], "seed": s["seed"]},
           "stop": {"max_tokens": N, "ignore_eos": not s.get("rf")}, "eos_token_ids": [EOS]}
    if s.get("rf"):
        req["response_format"] = RF
    if s.get("adapter"):
        req["adapter_id"] = s["adapter"]
    return req


def prompt_for(kind: str, direction: str) -> list[int]:
    rng = np.random.default_rng(sorted(KINDS).index(kind) * 2 + (direction == "port_to_jax"))
    if kind == "grammar":
        return list(b"Give me a record: ")
    if kind == "spec":  # repetitive, so the n-gram drafter proposes
        unit = rng.integers(1, 500, size=6).tolist()
        return unit * 4
    return rng.integers(1, 500, size=26).tolist()


def ctx_for(engine, rid=None):
    return JContext(rid) if isinstance(engine, TpuEngine) else Context(rid)


class Stream:
    def __init__(self, engine, req, rid=None):
        self.items: list[dict] = []
        self.task = asyncio.get_running_loop().create_task(self._run(engine, req, rid))

    async def _run(self, engine, req, rid):
        async for item in engine.generate(dict(req), ctx_for(engine, rid)):
            self.items.append(item)

    @property
    def tokens(self) -> list[int]:
        return [t for it in self.items for t in it.get("token_ids") or []]


async def clear(*engines) -> None:
    """Drop the engines' cached blocks once every sequence has released
    its own: a stream's client can see its finish frame before the
    scheduler frees the blocks, which would then stay cached."""
    for e in engines:
        while e.pool.num_active:
            await asyncio.sleep(0.001)
        e.clear_kv_blocks()


async def solo(engine, req) -> list[int]:
    await clear(engine)
    s = Stream(engine, req)
    await s.task
    return s.tokens


def bridge(src_is_jax: bool):
    """Wire frames of the source package → the destination's dicts."""
    if src_is_jax:
        return lambda f: msgpack_lite.unpackb(msgpack.packb(f, use_bin_type=True))
    return lambda f: msgpack.unpackb(msgpack_lite.packb(f), raw=False)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_migrated_stream_resumes_on_the_other_engine(loop, engines, kind, direction):
    jeng, teng = engines[kind]
    src, dst = (jeng, teng) if direction == "jax_to_port" else (teng, jeng)
    src_mod, dst_mod = (jstream, tstream) if src is jeng else (tstream, jstream)
    Migration = TMigration if dst is teng else JMigration
    req = request(kind, prompt_for(kind, direction))
    rid = f"x-{kind}-{direction}"

    async def go():
        ref_src = await solo(src, req)
        ref_dst = await solo(dst, req)
        await clear(src, dst)
        leg1 = Stream(src, req, rid)
        while len(leg1.tokens) < 7 and not leg1.task.done():
            await asyncio.sleep(0.0005)

        def begin_cutover():
            begin = src.migration_begin(rid)
            return begin, src.migration_cutover(rid)

        begin, cut = await src.run_on_engine_thread(begin_cutover)
        assert begin.get("ok") and cut.get("ok"), (begin, cut)
        export = src.get_stream_export(cut["handle"])
        wire = bridge(src is jeng)

        def window_call(cursor, credit, wait_s):
            async def frames():
                async for f in src_mod.serve_kv_window(export, cursor, credit, wait_s, 64 << 10):
                    yield wire(f)
            return frames()

        pulled = await dst_mod.pull_kv_stream(window_call, stall_timeout_s=10.0)
        marker = {"handle": cut["handle"], "dest_instance": 2, "request": cut["request"]}
        fin = await src.run_on_engine_thread(lambda: src.migration_finish(rid, marker))
        await asyncio.wait_for(leg1.task, 30)
        assert fin == {"ok": True} and leg1.items[-1].get("migration") == marker
        delivered = leg1.tokens
        resume = Migration._resume_request(req, marker, list(req["token_ids"]),
                                           dict(req["stop"]), delivered)
        resume["kv_transfer_params"]["inject"] = dst_mod.inject_payload_from_chunks(pulled)
        inject_before = getattr(dst, "inject_bytes", None)
        leg2 = Stream(dst, resume)
        await asyncio.wait_for(leg2.task, 60)
        # The destination's cache holds the source's chunk pages byte for byte.
        bs = BASE["block_size"]
        hashes = jtokens.compute_block_hashes(
            cut["request"]["token_ids"], bs,
            jtokens.adapter_hash_seed(req.get("adapter_id")))[: cut["kv_blocks"]]
        ids = dst.pool.match_prefix(hashes)
        held = await dst.run_on_engine_thread(lambda: dst._runner.extract_pages(ids))
        sent = tuple(np.concatenate([np.asarray(c.pages[i]) for c in pulled.chunks], axis=1)
                     for i in range(len(pulled.chunks[0].pages)))
        base = await solo(dst, dict(req, adapter_id=None)) if kind == "adapter" else None
        return {"ref_src": ref_src, "ref_dst": ref_dst, "delivered": delivered, "base": base,
                "leg2": leg2.tokens, "finish": leg2.items[-1].get("finish_reason"),
                "cut": cut, "n_ids": len(ids), "held": held, "sent": sent,
                "injected": None if inject_before is None else dst.inject_bytes - inject_before}

    r = loop.run_until_complete(go())
    assert r["ref_src"] == r["ref_dst"]
    assert r["delivered"] == r["ref_src"][: r["cut"]["emitted"]] and len(r["delivered"]) >= 7
    assert r["delivered"] + r["leg2"] == r["ref_src"]
    assert r["finish"] in ("length", "stop")
    assert r["cut"]["kv_blocks"] == r["n_ids"] > 0
    assert len(r["held"]) == len(r["sent"]) == 2
    for h, s in zip(r["held"], r["sent"]):
        assert np.asarray(h).tobytes() == np.asarray(s).tobytes()
    if r["injected"] is not None:
        assert r["injected"] > 0
    if kind == "sampled":
        assert r["cut"]["request"]["resume"]["sample_seed"] == 7
    if kind == "spec":
        assert src.total_spec_passes > 0 and dst.total_spec_passes > 0
    if kind == "adapter":
        assert r["cut"]["adapter_id"] == "tenant-a" and r["base"] != r["ref_src"]
