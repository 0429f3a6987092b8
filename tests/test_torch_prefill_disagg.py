"""A disaggregated prefill whose prompt the tail split cuts, on the CPU.

A prefill-only request (``do_remote_decode`` with a ``stream_handle``)
whose suffix the ladder splits into [bucket chunk, tail] publishes its
full blocks chunk by chunk, contiguously, as each prefill chunk
completes, exactly as the JAX engine's stream export does for the same
prompt: the same (block offset, blocks) sequence and the same pages,
float or int8 with their scales. A prefix hit publishes its cached blocks
first as chunk 0 (in both engines).
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
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.runtime.engine import Context

from test_torch_prefill_engine import spy

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4,
            prefill_buckets_spec="8,16,32")
PROMPT = np.random.default_rng(5).integers(1, 500, 41).tolist()  # plan [32, 9]


def prefill_only(prompt, handle: str) -> dict:
    return {"model": "t", "token_ids": list(prompt),
            "sampling": {"temperature": 0.0, "seed": 0},
            "stop": {"max_tokens": 1, "ignore_eos": True},
            "kv_transfer_params": {"do_remote_decode": True, "stream_handle": handle}}


async def export(eng, prompts) -> list:
    """Serve each of ``prompts`` prefill-only in turn → per prompt its
    published chunks as (block offset, blocks, pages), and the dispatches."""
    calls = spy(eng)
    await eng.start()
    out = []
    try:
        for k, p in enumerate(prompts):
            ctx = JContext() if isinstance(eng, TpuEngine) else Context()
            async for item in eng.generate(prefill_only(p, f"h{k}"), ctx):
                if item.get("finish_reason"):
                    assert item["kv_transfer_params"]["stream"]
            exp = eng.get_stream_export(f"h{k}")
            assert exp.sealed and exp.abort_reason is None
            out.append([(c.block_offset, c.num_blocks, [np.asarray(a) for a in c.pages])
                        for _, c in exp.chunks_since(0, 1 << 30)])
    finally:
        await eng.stop()
    return out, calls


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tail_split_export_publishes_contiguous_chunks_as_jax(kv_quant):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        np_params = jax.tree.map(np.asarray,
                                 JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))
        prompts = [PROMPT, PROMPT + [7] * 30]  # then a prefix hit of 10 blocks, suffix 31
        got, calls = asyncio.run(export(TorchEngine(
            EngineArgs(model=ModelConfig(), device="cpu", kv_quant=kv_quant, **ARGS),
            params=np_params), prompts))
        want, jcalls = asyncio.run(export(TpuEngine(
            JArgs(model=JCfg(), attn_impl="xla", kv_quant=kv_quant, **ARGS),
            params=np_params), prompts))
    finally:
        torch.set_num_threads(n)
    assert calls == jcalls == [(1, 32, 32), (1, 16, 32), (1, 32, 32)]
    for g, w in zip(got, want):
        assert [c[:2] for c in g] == [c[:2] for c in w]
        ends = [off + nb for off, nb, _ in g]
        assert [off for off, _, _ in g] == [0] + ends[:-1]  # contiguous
        for (_, _, gp), (_, _, wp) in zip(g, w):
            for a, b in zip(gp, wp):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                           atol=1e-4, rtol=1e-4)
    assert [c[:2] for c in got[0]] == [(0, 8), (8, 2)]  # 41 tokens → 10 full blocks
    assert [c[:2] for c in got[1]][0] == (0, 10)  # the hit first, then the new blocks
