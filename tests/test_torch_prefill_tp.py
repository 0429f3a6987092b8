"""Packed prefill waves across tensor-parallel ranks, on the CPU.

A tp 2 ``TorchEngine`` (this process the leader, a spawned follower
replaying its dispatch stream over gloo, ``tests/torch_tp_ranks.py``) and a
tp 1 one serve the same wave, submitted before the scheduler starts, with
``prefill_batch_max`` 4 and the tail split on: the same prefill dispatches
as (rows, T, W), packs of several rows among them, the same greedy and
seeded sampled streams, and a follower that sampled exactly the leader's
tokens (equal digests).
"""

from __future__ import annotations

import asyncio

import numpy as np
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import LeaderRunner
from dynamo_tpu_torch.parallel.comm import TpGroup

from test_torch_prefill_engine import _stream, request, spy
from torch_tp_ranks import Followers

ARGS = dict(block_size=4, num_kv_blocks=128, max_num_seqs=8, max_model_len=128,
            max_prefill_tokens=32, dtype="float32", decode_steps=4, prefill_batch_max=4,
            prefill_buckets_spec="8,16")
LENS = (5, 3, 7, 12, 9, 30, 40, 6)


async def serve(engine) -> tuple[list, list]:
    calls = spy(engine)
    tasks = [asyncio.ensure_future(_stream(engine, request(i, n))) for i, n in enumerate(LENS)]
    await asyncio.sleep(0)
    await engine.start()
    try:
        return list(await asyncio.gather(*tasks)), calls
    finally:
        await engine.stop()


def test_tp2_packed_wave_equals_tp1():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        np_params = jax.tree.map(np.asarray,
                                 JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))
        one = TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **ARGS),
                          params=np_params)
        want, want_calls = asyncio.run(serve(one))
        eargs = EngineArgs(model=ModelConfig(), device="cpu", tp=2, **ARGS)
        followers = Followers(2, eargs, np_params)
        group = TpGroup(0, 2, followers.coordinator, "cpu")
        try:
            runner = LeaderRunner(eargs, params=np_params, group=group,
                                  listen_addr=followers.step_addr, num_followers=1)
            got, calls = asyncio.run(serve(TorchEngine(eargs, runner=runner)))
            leader = runner.digest()
            (follower,) = followers.results()
        finally:
            followers.kill()
            group.close()
    finally:
        torch.set_num_threads(n)
    assert calls == want_calls
    assert any(b > 1 for b, _, _ in calls)  # packed dispatches
    assert any(b == 1 and t == 32 for b, t, _ in calls)  # 40 = 32 + 8 chunked
    for (gt, gl, gf), (wt, wl, wf) in zip(got, want):
        assert gt == wt and gf == wf == "length"
        np.testing.assert_allclose(gl, wl, atol=1e-5, rtol=1e-5)
    assert follower["digest"] == leader and leader is not None
