"""TorchEngine's QoS order and delta coalescing against TpuEngine's, on the
CPU (test-tiny, float32, the same numpy weights; every request seeded).

The five cases of tests/test_engine_qos.py run on both engines:
(class, age)-ordered admission, lowest-class-first preemption with the
per-class counter and a byte-identical re-admitted stream, no-priority
traffic identical with ``qos_scheduling`` on and off, ``qos_scheduling``
off ignoring wire priorities, and an unknown wire priority served as the
default class. Each engine must show the same admission order, the same
victims' classes and the same token streams as the other.

The engine cases of tests/test_stream_coalesce.py (which drive the
mocker there) run on both engines: coalesced and per-delta framings give
the same client view; the finish rides the last frame; frames stay within
``delta_max_tokens``. A consumer that reads only once the engine has
finished the request (``settled_stream``) sees every delta queued, so both
engines must merge exactly the same frames.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JReq
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JRegistry
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest as TReq
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime.engine import Context as TContext
from dynamo_tpu_torch.runtime.engine import collect
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from test_stream_coalesce import Summary
from test_torch_http import np_weights, settled_stream

BASE = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            max_prefill_tokens=64, dtype="float32")
SIDES = ("jax", "port")


@pytest.fixture(scope="module")
def weights():
    return np_weights()


def make_engine(side: str, weights, **kw):
    args = {**BASE, **kw}
    if side == "jax":
        return TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **args), params=weights)
    return TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **args),
                       params=params_from_numpy(weights, "cpu", torch.float32))


def qos_request(side: str, prompt, max_tokens=8, priority=None, seed=0):
    req = (JReq if side == "jax" else TReq)(model="t", token_ids=list(prompt), priority=priority)
    req.sampling.temperature = 0.0
    req.sampling.seed = seed
    req.stop.max_tokens = max_tokens
    req.stop.ignore_eos = True
    return req


def context(side: str):
    return JContext() if side == "jax" else TContext()


async def run_one(engine, side, req):
    return [item async for item in engine.generate(req, context(side))]


def tokens(outs):
    return [t for o in outs for t in o.get("token_ids", [])]


def on_both(weights, scenario, **kw):
    """Run ``scenario(engine, side)`` on each engine → {side: result}."""
    async def go(side):
        engine = await make_engine(side, weights, **kw).start()
        try:
            return await scenario(engine, side)
        finally:
            await engine.stop()

    return {side: asyncio.run(go(side)) for side in SIDES}


def admission_order(engine, side):
    """One decode slot: while a long standard request runs, a batch
    request is submitted, then an interactive one → (the order in which
    those two complete, streams)."""
    async def go():
        order: list[str] = []

        async def run(tag, req):
            outs = tokens(await run_one(engine, side, req))
            order.append(tag)
            return outs

        first = engine.generate(qos_request(side, [1, 2, 3], 96), context(side))
        head = [await first.__anext__()]  # "first" holds the slot from here
        batch = asyncio.ensure_future(run("batch", qos_request(side, [4, 5, 6], 8, "batch")))
        await asyncio.sleep(0)  # batch arrives before interactive
        inter = asyncio.ensure_future(run("interactive",
                                          qos_request(side, [7, 8, 9], 8, "interactive")))
        head += [item async for item in first]
        return order, (tokens(head), await batch, await inter)

    return go()


def test_waiting_interactive_admits_before_earlier_batch(weights):
    got = on_both(weights, admission_order, max_num_seqs=1)
    assert got["port"][0] == got["jax"][0] == ["interactive", "batch"]
    assert got["port"][1] == got["jax"][1]


def test_preemption_evicts_lowest_class_and_batch_still_finishes_identical(weights):
    """12 blocks: a solo 32-token run fits, any overlap of the two forces a
    preemption; the victim is the batch sequence on both engines, its
    re-admitted stream equals its solo run, and the per-class counter
    carries the class."""
    pb, pi = [1, 2, 3, 4, 5, 6], [9, 8, 7, 6, 5, 4]

    async def scenario(engine, side):
        registry = MetricsRegistry() if side == "port" else JRegistry()
        engine.bind_metrics(registry)

        async def staggered(req, delay):
            await asyncio.sleep(delay)
            return tokens(await run_one(engine, side, req))

        rb = ri = None
        for _attempt in range(4):
            rb, ri = await asyncio.gather(
                staggered(qos_request(side, pb, 26, priority="batch"), 0.0),
                staggered(qos_request(side, pi, 20, priority="interactive"), 0.002))
            assert engine.total_preemptions_by.get("interactive", 0) == 0
            if engine.total_preemptions_by.get("batch", 0) >= 1:
                break
        assert engine.total_preemptions_by.get("batch", 0) >= 1, "no preemption in 4 attempts"
        solo = tokens(await run_one(engine, side, qos_request(side, pb, 26, priority="batch")))
        assert 'engine_preemptions_total{class="batch"}' in registry.render()
        return rb, ri, solo

    got = on_both(weights, scenario, num_kv_blocks=12, max_model_len=32, max_num_seqs=2)
    for side in SIDES:
        rb, ri, solo = got[side]
        assert rb == solo and len(ri) == 20
    assert got["port"] == got["jax"]


def test_no_priority_traffic_byte_identical_with_qos_on_and_off(weights):
    prompts = ([1, 2, 3, 4, 5, 6], [9, 8, 7, 6, 5, 4])

    async def scenario(engine, side):
        r1, r2 = await asyncio.gather(run_one(engine, side, qos_request(side, prompts[0], 20)),
                                      run_one(engine, side, qos_request(side, prompts[1], 20)))
        return tokens(r1), tokens(r2)

    geo = dict(num_kv_blocks=14, max_model_len=32, max_num_seqs=2)
    on = on_both(weights, scenario, qos_scheduling=True, **geo)
    off = on_both(weights, scenario, qos_scheduling=False, **geo)
    assert on["port"] == off["port"] == on["jax"] == off["jax"]
    assert all(len(s) == 20 for s in on["port"])


def test_qos_scheduling_off_ignores_wire_priority(weights):
    got = on_both(weights, admission_order, max_num_seqs=1, qos_scheduling=False)
    assert got["port"][0] == got["jax"][0] == ["batch", "interactive"]
    assert got["port"][1] == got["jax"][1]


def test_unknown_wire_priority_never_crashes_engine(weights):
    async def scenario(engine, side):
        req = qos_request(side, [1, 2, 3], 4)
        req.priority = "hyperspeed"
        return tokens(await run_one(engine, side, req))

    got = on_both(weights, scenario)
    assert got["port"] == got["jax"] and len(got["port"]) == 4


# -- delta coalescing ------------------------------------------------------------------


def request_dict(max_tokens=48, temperature=0.0, seed=3):
    req = TReq(model="t", token_ids=list(b"the quick brown fox jumps over the lazy dog "))
    req.sampling.temperature = temperature
    req.sampling.seed = seed
    req.sampling.logprobs = True
    req.stop.max_tokens = max_tokens
    req.stop.ignore_eos = True
    return req.to_dict()


async def settled_frames(engine, side, req: dict) -> list[dict]:
    """The engine's frames for ``req``, read only once it has finished."""
    return [item async for item in settled_stream(
        engine, engine.generate(req, context(side)), req["stop"]["max_tokens"])]


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_coalesced_framings_give_the_same_client_view(weights, decode_steps):
    """Per-delta, backlog-coalesced and gathered (delta_max_ms) framings on
    both engines → one client view (text, tokens, finish, logprobs)."""
    shapes = [dict(delta_max_tokens=0), dict(delta_max_tokens=64),
              dict(delta_max_tokens=64, delta_max_ms=5.0)]
    views = []
    for shape in shapes:
        async def scenario(engine, side):
            backend = Backend(engine, ByteTokenizer())
            return Summary(await collect(backend.generate(request_dict(temperature=0.8),
                                                          TContext()))).key()

        got = on_both(weights, scenario, decode_steps=decode_steps, **shape)
        views += [got["jax"], got["port"]]
    assert all(v[:3] == views[0][:3] for v in views), views
    for v in views:
        assert v[4] == views[0][4]
        assert v[3] == pytest.approx(views[0][3], abs=1e-4, rel=1e-4)
    assert views[0][2] == "length"


@pytest.mark.parametrize("shape", [dict(delta_max_tokens=64, decode_steps=1),
                                   dict(delta_max_tokens=64, decode_steps=4),
                                   dict(delta_max_tokens=4, decode_steps=1),
                                   dict(delta_max_tokens=0, decode_steps=3)])
def test_settled_frames_are_the_same_on_both_engines(weights, shape):
    """A consumer that reads after the engine finished: the finish rides
    the last frame with its tokens, no frame is empty, frames stay within
    the cap (a K-token window is never split), and both engines merge the
    same frames."""
    async def scenario(engine, side):
        return await settled_frames(engine, side, request_dict(max_tokens=32))

    got = on_both(weights, scenario, **shape)
    sizes = {side: [len(f.get("token_ids") or []) for f in got[side]] for side in SIDES}
    assert sizes["port"] == sizes["jax"]
    assert [f.get("token_ids") for f in got["port"]] == [f.get("token_ids") for f in got["jax"]]
    for side in SIDES:
        frames = got[side]
        assert frames[-1].get("finish_reason") == "length" and frames[-1].get("token_ids")
        assert all(f.get("token_ids") for f in frames)
        assert sum(sizes[side]) == 32
        cap = shape["delta_max_tokens"]
        if cap:
            assert max(sizes[side]) <= max(cap, shape["decode_steps"])
            if shape["decode_steps"] == 1:  # one-token deltas fill every frame to the cap
                assert len(frames) == -(-32 // cap)
        else:
            assert len(frames) > 1  # one frame per delta
