"""Multi-LoRA serving in TorchEngine against TpuEngine, on the CPU.

tests/test_engine_lora.py's contracts, held port against JAX on the same
numpy weights (test-tiny, float32) and the same seeded requests, every
request submitted before the scheduler starts:

- a mixed burst (base rows beside rows of two adapters) gives the same
  streams in both engines at pipeline depths 0, 1 and 2, with fused and
  tree speculation, and under a grammar: tokens equal, logprobs within
  1e-4 (the forward pass's float32 tolerance);
- base rows of a mixed burst are byte-identical to a no-LoRA port engine
  (depths 0 and 2, and stepwise speculation);
- under slot pressure (four adapters, two slots, G2 on, one request at a
  time) streams, evictions, re-page-ins and ``lora_stats`` equal the JAX
  engine's;
- a request that names an adapter the engine cannot serve (no bank, or an
  unknown name) ends its own stream with the JAX engine's typed error;
- an adapter sequence's KV identity is salted as the JAX engine salts it:
  its KV events carry the same block hashes, ``prefix_hit_length`` answers
  alike per (tokens, adapter), and an identical prompt under another
  identity never hits;
- registration refusals, pinned checkpoint pages and the ``engine_lora_*``
  series.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import RequestValidationError as JRequestValidationError
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import RequestValidationError, TorchEngine
from dynamo_tpu_torch.engine.lora import LoraAdapterSpec, make_adapter_pages
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.tokens import adapter_hash_seed, compute_block_hashes

BASE = dict(block_size=4, num_kv_blocks=256, max_num_seqs=8, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4, pipeline_depth=0,
            pipeline_windows=False)
TOL = dict(atol=1e-4, rtol=1e-4)
ADAPTERS = (("tenant-a", 4, 7), ("tenant-b", 2, 9))  # (name, rank, seed)
MIXED = [None, "tenant-a", None, "tenant-b", "tenant-a", None]
LOOPY = ([1, 2, 3] * 6, [7, 8, 9, 4] * 4, [5, 6] * 8)
EOS = 257  # the byte tokenizer's
SCHEMA_RF = {"type": "json_schema", "json_schema": {"name": "r", "schema": {
    "type": "object", "properties": {"ok": {"type": "boolean"},
                                     "tag": {"type": "string", "maxLength": 4}},
    "required": ["ok", "tag"]}}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def port_engine(np_params, **kw) -> TorchEngine:
    return TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **{**BASE, **kw}),
                       params=params_from_numpy(np_params, "cpu", torch.float32))


def jax_engine(np_params, **kw) -> TpuEngine:
    return TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **{**BASE, **kw}), params=np_params)


def request(i: int, adapter: str | None, prompt=None, max_tokens: int = 10,
            temperature: float = 0.0, **extra) -> dict:
    rng = np.random.default_rng(1000 + i)
    ids = list(prompt) if prompt is not None else rng.integers(1, 511, size=22).tolist()
    return {"model": "test-tiny", "token_ids": ids, "adapter_id": adapter,
            "sampling": {"temperature": temperature, "seed": i, "logprobs": True},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}, **extra}


async def _stream(eng, req) -> dict:
    ctx = JContext() if isinstance(eng, TpuEngine) else Context()
    out = {"tokens": [], "logprobs": [], "finish": None, "error": None}
    async for item in eng.generate(req, ctx):
        out["tokens"] += item.get("token_ids") or []
        out["logprobs"] += item.get("log_probs") or []
        out["finish"] = item.get("finish_reason") or out["finish"]
        out["error"] = item.get("error") or out["error"]
    return out


async def run(eng, reqs, adapters=ADAPTERS, one_at_a_time=False, queue_first=False):
    """Register ``adapters`` (if the engine has a bank), then serve ``reqs``:
    all submitted before the scheduler starts, or one at a time after it
    (``one_at_a_time``; ``queue_first`` queues each before the start, one
    per event-loop turn, as grammar requests compile before they queue)."""
    if eng.args.lora_slots > 0:
        for name, rank, seed in adapters:
            eng.register_adapter(name, rank=rank, seed=seed)
    try:
        if one_at_a_time:
            await eng.start()
            outs = [await _stream(eng, r) for r in reqs]
        else:
            tasks = []
            for r in reqs:
                tasks.append(asyncio.ensure_future(_stream(eng, r)))
                if queue_first:
                    while eng.metrics().worker.num_requests_waiting < len(tasks):
                        await asyncio.sleep(0.01)
            await asyncio.sleep(0)
            await eng.start()
            outs = await asyncio.gather(*tasks)
        stats = (eng.lora_stats(), eng.tiers.stats())
        return outs, stats
    finally:
        await eng.stop()


def same_streams(got, want):
    for g, w in zip(got, want):
        assert g["error"] is None and w["error"] is None, (g, w)
        assert g["tokens"] == w["tokens"] and g["finish"] == w["finish"]
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], **TOL)


def mixed(n=len(MIXED), **kw):
    return [request(i, MIXED[i % len(MIXED)], **kw) for i in range(n)]


# -- streams against TpuEngine ------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_mixed_burst_equals_tpu_engine(np_params, depth):
    kw = dict(lora_slots=2, lora_rank=4, pipeline_depth=depth, pipeline_windows=depth > 0)
    reqs = mixed(temperature=0.0) + [request(9, "tenant-b", temperature=0.8)]
    port, _ = asyncio.run(run(port_engine(np_params, **kw), reqs))
    ref, _ = asyncio.run(run(jax_engine(np_params, **kw), reqs))
    same_streams(port, ref)
    # The adapters adapt: their rows differ from the same prompts on the base.
    base, _ = asyncio.run(run(port_engine(np_params, **kw),
                              [dict(r, adapter_id=None) for r in reqs]))
    for r, p, b in zip(reqs, port, base):
        assert (p["logprobs"] != b["logprobs"]) == (r["adapter_id"] is not None)


@pytest.mark.parametrize("tree", [False, True], ids=["fused", "tree"])
def test_speculative_mixed_burst_equals_tpu_engine(np_params, tree):
    spec = dict(spec_tokens=4, spec_gate=0.0, spec_fused=True, spec_ngram=1,
                **({"spec_tree_width": 2, "spec_tree_depth": 3} if tree else {}))
    kw = dict(lora_slots=2, lora_rank=4, **spec)
    reqs = [request(i, MIXED[i], prompt=LOOPY[i % 3], max_tokens=14) for i in range(6)]
    port_eng = port_engine(np_params, **kw)
    port, _ = asyncio.run(run(port_eng, reqs))
    ref, _ = asyncio.run(run(jax_engine(np_params, **kw), reqs))
    same_streams(port, ref)
    assert port_eng.total_spec_passes > 0
    if tree:
        assert port_eng.total_spec_tree_passes > 0


def test_constrained_mixed_burst_equals_tpu_engine(np_params):
    kw = dict(lora_slots=2, lora_rank=4, spec_tokens=3, spec_gate=0.0, spec_ngram=1,
              spec_tree_width=2)
    reqs = [dict(request(i, MIXED[i], response_format=SCHEMA_RF), eos_token_ids=[EOS],
                 stop={"max_tokens": 64}) for i in range(4)]
    port, _ = asyncio.run(run(port_engine(np_params, **kw), reqs, queue_first=True))
    ref, _ = asyncio.run(run(jax_engine(np_params, **kw), reqs, queue_first=True))
    same_streams(port, ref)
    assert all(p["finish"] == "stop" for p in port)


@pytest.mark.parametrize("kw", [dict(), dict(pipeline_depth=2, pipeline_windows=True),
                                dict(spec_tokens=4, spec_gate=0.0, spec_fused=False)],
                         ids=["depth0", "depth2", "stepwise"])
def test_base_rows_byte_identical_to_a_no_lora_engine(np_params, kw):
    reqs = mixed()
    if kw.get("spec_tokens"):
        reqs = [request(i, MIXED[i], prompt=LOOPY[i % 3], max_tokens=14) for i in range(6)]
    with_lora, _ = asyncio.run(run(port_engine(np_params, lora_slots=2, lora_rank=4, **kw),
                                   reqs))
    without, _ = asyncio.run(run(port_engine(np_params, **kw),
                                 [r for r in reqs if r["adapter_id"] is None]))
    base_rows = [o for r, o in zip(reqs, with_lora) if r["adapter_id"] is None]
    for a, b in zip(base_rows, without):
        assert a["tokens"] == b["tokens"]
        assert np.asarray(a["logprobs"], np.float32).tobytes() == \
            np.asarray(b["logprobs"], np.float32).tobytes()


def test_slot_pressure_pages_as_tpu_engine(np_params):
    adapters = [(f"t{k}", 4, 3 + k) for k in range(4)]
    reqs = [request(i % 4, adapters[i % 4][0]) for i in range(9)] + [request(20, None)]
    kw = dict(lora_slots=2, lora_rank=4, host_kv_blocks=64)
    port, (pstats, ptiers) = asyncio.run(run(port_engine(np_params, **kw), reqs, adapters,
                                             one_at_a_time=True))
    ref, (jstats, jtiers) = asyncio.run(run(jax_engine(np_params, **kw), reqs, adapters,
                                            one_at_a_time=True))
    same_streams(port, ref)
    assert pstats == jstats
    assert pstats["evictions"] >= 1 and pstats["repageins"] >= 1 and pstats["resident"] == 2
    # Every page-in of a registered adapter is a G2 hit in both engines.
    assert ptiers["g2_hits"] == jtiers["g2_hits"] >= pstats["pageins"]
    # An evicted adapter pages back in to the same stream.
    for i in range(4, 8):
        assert port[i]["tokens"] == port[i - 4]["tokens"]


# -- typed errors -----------------------------------------------------------------


@pytest.mark.parametrize("slots,adapter", [(0, "tenant-a"), (2, "nobody")],
                         ids=["no-bank", "unknown"])
def test_adapter_the_engine_cannot_serve_errors_typed(np_params, slots, adapter):
    kw = dict(lora_slots=slots, lora_rank=4)
    reqs = [request(0, adapter), request(1, None)]
    port, _ = asyncio.run(run(port_engine(np_params, **kw), reqs))
    ref, _ = asyncio.run(run(jax_engine(np_params, **kw), reqs))
    assert port[0]["finish"] == ref[0]["finish"] == "error"
    assert port[0]["error"] == ref[0]["error"] and port[0]["tokens"] == []
    assert ("lora_slots=0" if slots == 0 else "unknown adapter") in port[0]["error"]
    same_streams(port[1:], ref[1:])  # the base request beside it is served


def test_register_adapter_refusals(np_params):
    for cls, eng in ((RequestValidationError, port_engine(np_params)),
                     (JRequestValidationError, jax_engine(np_params))):
        with pytest.raises(cls, match="no adapter bank"):
            eng.register_adapter("x")
    msgs = []
    for eng, cls in ((port_engine(np_params, lora_slots=1, lora_rank=2), RequestValidationError),
                     (jax_engine(np_params, lora_slots=1, lora_rank=2), JRequestValidationError)):
        with pytest.raises(cls) as e:
            eng.register_adapter("wide", rank=4)
        msgs.append(str(e.value))
        eng.register_adapter("narrow", rank=2)
        assert eng.adapters() == ["narrow"]
    assert msgs[0] == msgs[1] and "exceeds lora_rank=2" in msgs[0]


# -- KV identity -------------------------------------------------------------------


def test_adapter_kv_identity_is_salted_as_jax(np_params):
    """The same prompt base and under two adapters, one after another: the
    KV events' stored hashes equal the JAX engine's (and the router's
    salted hashes), prefix_hit_length answers alike per identity, and no
    identity hits another's blocks."""
    prompt = list(range(3, 27))

    async def go(eng):
        events = []
        eng.pool.set_event_sink(lambda ev: events.append(ev.to_dict()))
        for name, rank, seed in ADAPTERS:
            eng.register_adapter(name, rank=rank, seed=seed)
        await eng.start()
        try:
            hits, outs = [], []
            for i, adapter in enumerate([None, "tenant-a", "tenant-b", "tenant-a"]):
                hits.append({a: eng.prefix_hit_length(prompt, a)
                             for a in (None, "tenant-a", "tenant-b")})
                outs.append(await _stream(eng, request(i, adapter, prompt=prompt)))
            hits.append({a: eng.prefix_hit_length(prompt, a)
                         for a in (None, "tenant-a", "tenant-b")})
            return events, hits, outs, eng.pool.hit_rate
        finally:
            await eng.stop()

    kw = dict(lora_slots=2, lora_rank=4)
    pev, phits, pouts, prate = asyncio.run(go(port_engine(np_params, **kw)))
    jev, jhits, jouts, jrate = asyncio.run(go(jax_engine(np_params, **kw)))
    assert pev == jev and phits == jhits and prate == jrate
    same_streams(pouts, jouts)
    # Before any request nothing hits; after, each identity hits only its own.
    assert phits[0] == {None: 0, "tenant-a": 0, "tenant-b": 0}
    assert phits[1] == {None: 20, "tenant-a": 0, "tenant-b": 0}
    assert phits[2] == {None: 20, "tenant-a": 20, "tenant-b": 0}
    want = compute_block_hashes(prompt, 4, adapter_hash_seed("tenant-b"))[:5]
    stored_hashes = {blk["block_hash"] for ev in pev if ev["kind"] == "stored"
                     for blk in ev["blocks"]}
    assert set(want) <= stored_hashes
    assert not set(compute_block_hashes(prompt, 4)[:5]) & set(want)


def test_checkpoint_pages_survive_tier_eviction(np_params):
    """register_adapter(pages=...) with tiers on: after the tier object is
    evicted, the engine serves the pinned pages, never seed factors."""

    async def go():
        engine = await port_engine(np_params, lora_slots=2, lora_rank=4,
                                   host_kv_blocks=64).start()
        try:
            real = make_adapter_pages(ModelConfig(), LoraAdapterSpec("other-source", 4, 99), 4)
            engine.register_adapter("ckpt", rank=4, pages=real)
            engine.tiers.host.clear()
            got = engine._adapter_pages(LoraAdapterSpec("ckpt", 4, 0), real)
            for a, b in zip(real, got):
                np.testing.assert_array_equal(a, b)
            with engine._lora_lock:
                assert engine._lora_registry["ckpt"][1] is not None
        finally:
            await engine.stop()

    asyncio.run(go())


def test_lora_series_on_the_metrics_registry(np_params):
    async def go():
        engine = port_engine(np_params, lora_slots=2, lora_rank=4, host_kv_blocks=64)
        registry = MetricsRegistry()
        engine.bind_metrics(registry)
        outs, (stats, _) = await run(engine, [request(i, n) for i, (n, _, _) in
                                              enumerate(ADAPTERS * 2)], one_at_a_time=True)
        return registry.render(), stats, engine

    text, stats, engine = asyncio.run(go())
    assert f"dynamo_tpu_engine_lora_resident_adapters {stats['resident']}" in text
    assert f"dynamo_tpu_engine_lora_swap_total {stats['pageins']}" in text
    assert "dynamo_tpu_engine_lora_gather_seconds" in text
    assert stats["pageins"] == 2 and stats["hits"] == 2 and engine.total_lora_s > 0
