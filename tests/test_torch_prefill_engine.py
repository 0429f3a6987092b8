"""The port's prefill admission against the JAX engine's, on the CPU.

``TorchEngine`` and ``TpuEngine`` (XLA attention) serve the same seeded
requests on the same numpy weights (test-tiny, float32, block size 4,
``max_prefill_tokens`` 64, so the ladders stay short), every request of a
wave submitted before the scheduler starts, so both engines admit the
same waves. For each case:

- greedy and seeded sampled token streams equal, logprobs within 1e-4;
- the sequence of prefill dispatches as (rows, T, W), recorded by a spy on
  each engine's runner, equal: the bucket ladder, the tail split, the
  greedy power-of-two packs and the table buckets are the JAX engine's;
- ``total_prefill_padded``, ``total_prefilled`` and the
  ``engine_prefill_pad_ratio`` series equal.

Cases: ``prefill_batch_max`` 1 and 8, tail split on and off, the "fine"
ladder, a wave with one prompt longer than ``max_prefill_tokens`` beside
short ones (tests/test_engine.py's
``test_engine_long_prompt_chunked_with_packed_wave``), prefix hits, an
adapter row in a packed wave and int8 KV pages.
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
from dynamo_tpu.runtime.metrics import MetricsRegistry as JRegistry
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

BASE = dict(block_size=4, num_kv_blocks=256, max_num_seqs=8, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4, pipeline_depth=0,
            pipeline_windows=False)
TOL = dict(atol=1e-4, rtol=1e-4)
ADAPTERS = (("tenant-a", 4, 31), ("tenant-b", 2, 32))
# Suffix lengths of a mixed wave: with the "8,16,32" ladder (rungs 8, 16,
# 32, 64) 33 and 40 split into [32, 1] and [32, 8], two pairs pack at T 8
# and T 16, and 50 pads to 64 whole.
SHORT = (5, 9, 33, 40, 12, 50, 3, 20)
# One prompt past max_prefill_tokens (chunked 64 + 36) beside short ones.
LONG = (100, 7, 10, 6)
PAD_SERIES = "dynamo_tpu_engine_prefill_pad_ratio"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def request(i: int, n: int, prefix=(), adapter: str | None = None, max_tokens: int = 5) -> dict:
    rng = np.random.default_rng(500 + i)
    ids = list(prefix) + rng.integers(1, 511, size=n).tolist()
    return {"model": "test-tiny", "token_ids": ids, "adapter_id": adapter,
            "sampling": {"temperature": 0.8 if i % 3 == 1 else 0.0, "seed": 70 + i,
                         "logprobs": True},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


def spy(eng) -> list[tuple[int, int, int]]:
    """Record each prefill dispatch of ``eng``'s runner as (rows, T, W)."""
    calls: list[tuple[int, int, int]] = []
    runner = eng._runner
    batch, chunk = runner.prefill_batch, runner.prefill_chunk

    def prefill_batch(toks, tables, *a, **kw):
        calls.append((*np.shape(toks), np.shape(tables)[1]))
        return batch(toks, tables, *a, **kw)

    def prefill_chunk(toks, table, *a, **kw):
        calls.append((1, len(toks), len(table)))
        return chunk(toks, table, *a, **kw)

    runner.prefill_batch, runner.prefill_chunk = prefill_batch, prefill_chunk
    return calls


async def _stream(eng, req) -> tuple:
    ctx = JContext() if isinstance(eng, TpuEngine) else Context()
    toks, lps, finish, err = [], [], None, None
    async for item in eng.generate(req, ctx):
        toks += item.get("token_ids") or []
        lps += item.get("log_probs") or []
        finish = item.get("finish_reason") or finish
        err = item.get("error") or err
    assert err is None, err
    return toks, lps, finish


async def serve(eng, waves: list[list[dict]]) -> dict:
    """Serve ``waves`` in turn: the first submitted before the scheduler
    starts (one admission wave), each later one after the one before it
    has finished, its requests one at a time → streams, dispatches and
    the prefill counters."""
    for name, rank, seed in ADAPTERS if eng.args.lora_slots else ():
        eng.register_adapter(name, rank=rank, seed=seed)
    registry = JRegistry() if isinstance(eng, TpuEngine) else MetricsRegistry()
    eng.bind_metrics(registry)
    calls = spy(eng)
    tasks = [asyncio.ensure_future(_stream(eng, r)) for r in waves[0]]
    await asyncio.sleep(0)
    await eng.start()
    try:
        outs = list(await asyncio.gather(*tasks))
        for wave in waves[1:]:
            outs += [await _stream(eng, r) for r in wave]
    finally:
        await eng.stop()
    ratio = [ln for ln in registry.render().splitlines() if ln.startswith(PAD_SERIES + " ")]
    return {"outs": outs, "calls": calls, "padded": eng.total_prefill_padded,
            "prefilled": eng.total_prefilled, "ratio": ratio}


def against_jax(np_params, waves, **kw) -> dict:
    port = TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **{**BASE, **kw}),
                       params=params_from_numpy(np_params, "cpu", torch.float32))
    ref = TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **{**BASE, **kw}), params=np_params)
    got, want = asyncio.run(serve(port, waves)), asyncio.run(serve(ref, waves))
    assert got["calls"] == want["calls"]
    assert (got["padded"], got["prefilled"]) == (want["padded"], want["prefilled"])
    assert got["ratio"] == want["ratio"] and len(got["ratio"]) == 1
    assert len(got["outs"]) == len(want["outs"]) == sum(map(len, waves))
    for (gt, gl, gf), (wt, wl, wf) in zip(got["outs"], want["outs"]):
        assert gt == wt and gf == wf == "length"
        np.testing.assert_allclose(gl, wl, **TOL)
    return got


CASES = {
    "singles": (dict(prefill_batch_max=1, prefill_buckets_spec="8,16,32"), SHORT),
    "packed": (dict(prefill_batch_max=8, prefill_buckets_spec="8,16,32"), SHORT),
    "packed_no_split": (dict(prefill_batch_max=8, prefill_buckets_spec="8,16,32",
                             prefill_tail_split=False), SHORT),
    "fine_ladder": (dict(prefill_batch_max=4), SHORT),
    "long_beside_packed": (dict(prefill_batch_max=8, prefill_buckets_spec="8,16,32"), LONG),
    "int8_pages": (dict(prefill_batch_max=8, prefill_buckets_spec="8,16,32", kv_quant="int8"),
                   SHORT),
}


@pytest.mark.parametrize("case", CASES)
def test_prefill_waves_equal_tpu_engine(np_params, case):
    kw, lens = CASES[case]
    got = against_jax(np_params, [[request(i, n) for i, n in enumerate(lens)]], **kw)
    if case == "singles":
        assert all(b == 1 for b, _, _ in got["calls"])
    if case == "packed":
        # Two pairs pack (T 8, T 16); 33 and 40 run as [32, 1] and [32, 8].
        assert (2, 8, 8) in got["calls"] and (2, 16, 8) in got["calls"]
        assert got["calls"][:4] == [(1, 32, 32), (1, 8, 32), (1, 32, 32), (1, 8, 32)]
    if case == "packed_no_split":
        assert (2, 64, 32) in got["calls"]  # 33 and 40 pad to 64 together
    if case == "long_beside_packed":
        assert got["calls"][:2] == [(1, 64, 32), (1, 64, 32)]  # 100 = 64 + 36
    assert got["padded"] > got["prefilled"]


def test_prefix_hits_and_an_adapter_row_in_a_packed_wave(np_params):
    """A packed wave with adapter rows beside base rows, then prompts that
    extend its prompts (prefix hits on the base and the adapter identity),
    each its own wave."""
    first = [request(i, n, adapter=("tenant-a" if i in (1, 4) else "tenant-b" if i == 6
                                    else None)) for i, n in enumerate(SHORT)]
    later = [request(10 + i, k, prefix=first[i]["token_ids"], adapter=first[i]["adapter_id"])
             for i, k in ((1, 7), (5, 30), (0, 70), (3, 2))]
    got = against_jax(np_params, [first, later], prefill_batch_max=8,
                      prefill_buckets_spec="8,16,32", lora_slots=2, lora_rank=4)
    assert got["prefilled"] < sum(len(r["token_ids"]) for r in first + later)
