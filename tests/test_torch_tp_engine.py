"""``TorchEngine`` over a tensor-parallel ``LeaderRunner`` against the JAX
package's ``TpuEngine``, on the CPU.

The leader (rank 0) is this process; rank 1 is a spawned follower
replaying its dispatch stream over gloo (``tests/torch_tp_ranks.py``). Both
hold their shards of the same f32 test-tiny weights (JAX ``init_params``),
which both JAX engines hold whole: ``TpuEngine`` at tp 1, and at tp 2 as
tests/test_parallel.py builds it (``EngineArgs(tp=2)``: a 2-device mesh).

- A burst of greedy and seeded sampled requests gives the JAX engines'
  streams token for token at pipeline depths 2, 1 and 0.
- A speculative pass (n-gram drafts, spec_tokens 3) keeps the dense
  greedy stream; a ``json_schema`` request gives the JAX engine's
  constrained stream.
- A prefill-only export at tp 2 has tp 1's page layout ``[L, n, bs,
  KVH·hd]``, within 1e-5 + 1e-5·|x| of the JAX tp 1 engine's pages of the
  same prompt, and injected into the tp 1 ``TpuEngine`` it continues that
  engine's greedy stream token for token (hit against hit).
- The follower sampled exactly the leader's tokens (equal digests) and
  made as many collectives.
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
from dynamo_tpu_torch.engine.runner import LeaderRunner
from dynamo_tpu_torch.parallel.comm import TpGroup
from dynamo_tpu_torch.runtime.engine import Context

from torch_tp_ranks import Followers

ARGS = dict(block_size=4, num_kv_blocks=128, max_num_seqs=4, max_model_len=128,
            max_prefill_tokens=32, dtype="float32", decode_steps=4)
TOL = dict(atol=1e-5, rtol=1e-5)
SCHEMA = {"type": "object", "properties": {"name": {"type": "string", "maxLength": 6},
                                           "ok": {"type": "boolean"}}}
RF = {"type": "json_schema", "json_schema": {"name": "x", "schema": SCHEMA}}
EOS = 257


def request(prompt, max_tokens, temperature=0.0, seed=0, rf=None, **ktp) -> dict:
    d = {"model": "test-tiny", "token_ids": list(prompt),
         "sampling": {"temperature": temperature, "seed": seed},
         "stop": {"max_tokens": max_tokens, "ignore_eos": rf is None},
         "eos_token_ids": [EOS]}
    if rf is not None:
        d["response_format"] = rf
    if ktp:
        d["kv_transfer_params"] = ktp
    return d


BURST = [request(np.random.default_rng(10 + i).integers(1, 500, 6 + 7 * i).tolist(), 10,
                 temperature=0.0 if i % 2 == 0 else 0.9, seed=100 + i) for i in range(4)]
SPEC = request([5, 6, 7, 8] * 6, 16)
CONSTRAINED = request(list(b"name: "), 24, rf=RF)
EXPORTED = np.random.default_rng(3).integers(1, 500, 43).tolist()


async def run(engine, req):
    ctx = JContext() if isinstance(engine, TpuEngine) else Context()
    toks, final = [], None
    async for item in engine.generate(req, ctx):
        toks.extend(item.get("token_ids") or [])
        if item.get("finish_reason"):
            final = item
    return toks, final


async def idle(engine):
    while engine.busy():
        await asyncio.sleep(0.001)


async def burst(engine):
    engine.clear_kv_blocks()
    return [t for t, _ in await asyncio.gather(*(run(engine, r) for r in BURST))]


async def export_pages(engine):
    """Prefill-only export of ``EXPORTED`` → its page tuple (10 blocks)."""
    engine.clear_kv_blocks()
    _, final = await run(engine, request(EXPORTED, 1, do_remote_decode=True))
    return engine.take_export(final["kv_transfer_params"]["remote_handle"])


@pytest.fixture(scope="module")
def loop():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


@pytest.fixture(scope="module")
def jax_runs(loop, np_params):
    """Both JAX engines' burst, and the tp 1 engine's speculative and
    constrained streams, export and hit-against-hit reference."""

    async def go():
        out = {}
        for tp in (1, 2):
            eng = await TpuEngine(JArgs(model=JCfg(), attn_impl="xla", tp=tp, **ARGS),
                                  params=np_params).start()
            try:
                out[tp] = await burst(eng)
                if tp == 1:
                    eng.clear_kv_blocks()
                    out["spec"] = (await run(eng, SPEC))[0]
                    out["constrained"] = (await run(eng, CONSTRAINED))[0]
                    out["export"] = await export_pages(eng)
                    eng.clear_kv_blocks()
                    await run(eng, request(EXPORTED, 8))
                    out["hit"] = (await run(eng, request(EXPORTED, 8)))[0]
                    out["engine"] = eng
                    continue
            except BaseException:
                await eng.stop()
                raise
            await eng.stop()
        return out

    out = loop.run_until_complete(go())
    yield out
    loop.run_until_complete(out["engine"].stop())


@pytest.fixture(scope="module")
def port_runs(loop, np_params):
    """The tp 2 port engine: the burst at depths 2, 1, 0, then a
    speculative and a constrained request, then the export; stopped, its
    follower's result read."""
    eargs = TArgs(model=TCfg(), device="cpu", tp=2, **ARGS)
    followers = Followers(2, eargs, np_params)
    group = TpGroup(0, 2, followers.coordinator, "cpu")
    runner = LeaderRunner(eargs, params=np_params, group=group,
                          listen_addr=followers.step_addr, num_followers=1)
    engine = TorchEngine(eargs, runner=runner)

    async def go():
        await engine.start()
        out = {"depth": {}}
        try:
            for depth in (2, 1, 0):
                engine.args.pipeline_depth = depth
                out["depth"][depth] = await burst(engine)
            await idle(engine)
            engine.clear_kv_blocks()
            engine.set_spec(spec_tokens=3, spec_gate=0.0, spec_ngram=2)
            out["spec"] = (await run(engine, SPEC))[0]
            out["spec_passes"] = runner.verify_passes
            await idle(engine)
            engine.set_spec(spec_tokens=0)
            out["constrained"] = (await run(engine, CONSTRAINED))[0]
            out["export"] = await export_pages(engine)
        finally:
            await engine.stop()
        out["leader"] = {"digest": runner.digest(), "collectives": group.counters()}
        return out

    try:
        out = loop.run_until_complete(go())
        out["followers"] = followers.results()
    finally:
        followers.kill()
        group.close()
    return out


@pytest.mark.parametrize("depth", [2, 1, 0])
def test_tp2_streams_equal_tpu_engine(jax_runs, port_runs, depth):
    got = port_runs["depth"][depth]
    assert got == jax_runs[1]
    assert got == jax_runs[2]
    assert all(len(t) == 10 for t in got)


def test_tp2_speculative_and_constrained_streams(jax_runs, port_runs):
    assert port_runs["spec_passes"] > 0
    assert port_runs["spec"] == jax_runs["spec"]
    assert port_runs["constrained"] == jax_runs["constrained"]
    assert len(port_runs["constrained"]) > 0


def test_tp2_pages_have_tp1_layout_and_continue_on_tpu_engine(loop, jax_runs, port_runs):
    got, want = port_runs["export"].pages(), jax_runs["export"].pages()
    assert [p.shape for p in got] == [p.shape for p in want] == [(2, 10, 4, 64)] * 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    jeng = jax_runs["engine"]

    async def go():
        jeng.clear_kv_blocks()
        payload = port_runs["export"].to_dict()
        return (await run(jeng, request(EXPORTED, 8, inject=payload)))[0]

    assert loop.run_until_complete(go()) == jax_runs["hit"]


def test_follower_sampled_the_leader_tokens(port_runs):
    (follower,) = port_runs["followers"]
    leader = port_runs["leader"]
    assert follower["digest"] == leader["digest"] != 0
    assert follower["collectives"]["calls"] == leader["collectives"]["calls"]
    assert leader["collectives"]["calls"]["all_reduce"] > 0
