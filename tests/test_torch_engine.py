"""TorchEngine (device="cpu") vs TpuEngine on the JAX CPU backend.

Both engines get the same numpy weights (JAX ``init_params`` exported to
numpy) and the same requests, in float32 with the XLA attention path on
the JAX side. Greedy token streams must be identical: the forward passes
agree to ~1e-6 (tests/test_torch_model.py), far inside the argmax gaps of
these prompts. Every request pins its sample seed (requests are built as
wire dicts with a "seed" in "sampling").
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
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineArgs as TArgs
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            max_prefill_tokens=64, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once on a few cores: these
    tiny shapes gain nothing from torch's intra-op thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def torch_engine(np_params, **kw) -> TorchEngine:
    args = TArgs(model=TCfg(), device="cpu", **{**ARGS, **kw})
    return TorchEngine(args, params=params_from_numpy(np_params, "cpu", torch.float32))


def jax_engine(np_params, **kw) -> TpuEngine:
    return TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **{**ARGS, **kw}), params=np_params)


def request(prompt, max_tokens=8, temperature=0.0, seed=0, **stop) -> dict:
    return {
        "model": "test-tiny", "token_ids": list(prompt),
        "sampling": {"temperature": temperature, "seed": seed},
        "stop": {"max_tokens": max_tokens, **stop},
    }


async def run_one(engine, req, ctx=None):
    return [item async for item in engine.generate(req, ctx or Context())]


def tokens(outs):
    return [t for o in outs for t in o.get("token_ids", [])]


PROMPTS = [[3, 1, 4, 1, 5, 9, 2], [6, 5, 3], list(range(20, 45)),
           [100, 7, 7, 7, 7, 7, 7, 7, 7, 7], [2, 71, 82, 81, 82, 84], list(range(300, 317))]


def test_concurrent_greedy_streams_match_tpu_engine(np_params):
    async def go():
        t_eng = await torch_engine(np_params).start()
        j_eng = await jax_engine(np_params).start()
        try:
            reqs = [request(p, 12, seed=i) for i, p in enumerate(PROMPTS)]
            t_out = await asyncio.gather(*(run_one(t_eng, r) for r in reqs))
            j_out = await asyncio.gather(*(run_one(j_eng, r, JContext()) for r in reqs))
        finally:
            await t_eng.stop()
            await j_eng.stop()
        for t, j in zip(t_out, j_out):
            assert tokens(t) == tokens(j) and len(tokens(t)) == 12
            assert t[-1]["finish_reason"] == j[-1]["finish_reason"] == "length"
        assert t_eng.pool.num_active == 0

    asyncio.run(go())


def test_prefix_cache_hit_gives_same_tokens(np_params):
    async def go():
        eng = await torch_engine(np_params).start()
        try:
            prompt = list(range(1, 21))  # 20 tokens = 5 blocks of 4
            a = await run_one(eng, request(prompt, 6))
            assert eng.pool.hit_blocks == 0
            b = await run_one(eng, request(prompt, 6))
            assert eng.pool.hit_blocks == 4  # (20 - 1) // 4 reusable blocks
            assert tokens(a) == tokens(b)
        finally:
            await eng.stop()

    asyncio.run(go())


def test_max_tokens_and_stop_tokens_match_tpu_engine(np_params):
    async def go():
        t_eng = await torch_engine(np_params).start()
        j_eng = await jax_engine(np_params).start()
        try:
            prompt = [5, 6, 7, 8]
            first = tokens(await run_one(t_eng, request(prompt, 5)))
            assert len(first) == 5
            stop_tok = first[2]
            cases = [request(prompt, 5, stop_token_ids=[stop_tok]),
                     request(prompt, 5, stop_token_ids=[stop_tok], ignore_eos=True),
                     request(prompt, 1)]
            for req in cases:
                t, j = await run_one(t_eng, req), await run_one(j_eng, req, JContext())
                assert tokens(t) == tokens(j)
                assert t[-1]["finish_reason"] == j[-1]["finish_reason"]
            assert tokens(await run_one(t_eng, cases[0]))[-1] == stop_tok
        finally:
            await t_eng.stop()
            await j_eng.stop()

    asyncio.run(go())


def test_cancel_mid_stream_frees_blocks(np_params):
    async def go():
        eng = await torch_engine(np_params, decode_steps=2).start()
        try:
            ctx = Context()
            got = []
            async for item in eng.generate(request([1, 2, 3], max_tokens=None), ctx):
                got.append(item)
                if len(got) == 3:
                    ctx.cancel()
            assert got and len(tokens(got)) < 120
            for _ in range(100):
                if eng.pool.num_active == 0:
                    break
                await asyncio.sleep(0.01)
            assert eng.pool.num_active == 0
        finally:
            await eng.stop()

    asyncio.run(go())


def test_preemption_matches_tpu_engine(np_params):
    """A tiny pool forces recompute preemption; both engines recover with
    the same streams, equal to a solo run."""
    async def go():
        small = dict(num_kv_blocks=14, max_model_len=32, max_num_seqs=2)
        t_eng = await torch_engine(np_params, **small).start()
        j_eng = await jax_engine(np_params, **small).start()
        try:
            reqs = [request([1, 2, 3, 4, 5, 6], 20), request([9, 8, 7, 6, 5, 4], 20, seed=1)]
            t_out = await asyncio.gather(*(run_one(t_eng, r) for r in reqs))
            assert t_eng.total_preemptions > 0
            j_out = await asyncio.gather(*(run_one(j_eng, r, JContext()) for r in reqs))
            solo = await run_one(t_eng, reqs[0])
        finally:
            await t_eng.stop()
            await j_eng.stop()
        for t, j in zip(t_out, j_out):
            assert tokens(t) == tokens(j) and len(tokens(t)) == 20
        assert tokens(t_out[0]) == tokens(solo)

    asyncio.run(go())


def test_seeded_sampling_reproducible_and_full_sampler_refused(np_params):
    """Seeded sampling is reproducible and seed-dependent; a request with
    ``top_k`` (the full sampler, once refused by the port) is served and
    matches TpuEngine token for token; an empty prompt is an error."""
    async def go():
        eng = await torch_engine(np_params).start()
        j_eng = await jax_engine(np_params).start()
        try:
            req = request([4, 4, 2], 10, temperature=0.8, seed=11)
            a, b = await run_one(eng, req), await run_one(eng, req)
            assert tokens(a) == tokens(b) and len(tokens(a)) == 10
            other = await run_one(eng, request([4, 4, 2], 10, temperature=0.8, seed=12))
            assert tokens(other) != tokens(a)
            full = request([4, 4, 2], 10, temperature=0.9, seed=5)
            full["sampling"]["top_k"] = 5
            t_full = await run_one(eng, full)
            assert t_full[-1]["finish_reason"] == "length" and len(tokens(t_full)) == 10
            assert tokens(t_full) == tokens(await run_one(j_eng, full, JContext()))
            err = await run_one(eng, request([], 4))
            assert err[-1]["finish_reason"] == "error"
        finally:
            await eng.stop()
            await j_eng.stop()

    asyncio.run(go())
