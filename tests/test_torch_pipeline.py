"""Golden equivalence of the port's decode-window pipeline, on the CPU.

Mirrors tests/test_engine_pipeline.py with ``TorchEngine(device="cpu")``:
async admission, up to ``pipeline_depth`` windows in flight chained
through ``last_toks``, zombie rows and async fetches may change when
tokens reach the host, never WHAT is generated. So token, logprob and
top-logprob streams must be identical across depths 0/1/2 and window
sizes K 1/4, under preemption and a mid-window cancel.

Then the port against the JAX package: the same mixed workload, seeded
sampled streams and full-sampler requests through ``TpuEngine`` (XLA
attention) at depth 2, K 4, on the same numpy weights (one JAX engine for
the file keeps it under its minute). Tokens must be equal; logprobs and
top-logprob values agree to 1e-4, the forward pass's float32 tolerance
(tests/test_torch_model.py).

CPU, test-tiny, float32, every request seeded.
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
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context

DEPTHS = (0, 1, 2)
BASE = dict(block_size=4, num_kv_blocks=256, max_num_seqs=8, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4)
TOL = dict(atol=1e-4, rtol=1e-4)


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


def engine(np_params, depth: int, **kw) -> TorchEngine:
    args = EngineArgs(model=ModelConfig(), device="cpu", pipeline_depth=depth,
                      pipeline_windows=depth > 0, **{**BASE, **kw})
    return TorchEngine(args, params=params_from_numpy(np_params, "cpu", torch.float32))


def request(prompt, max_tokens, temperature=0.0, seed=0, logprobs=False, top_logprobs=0,
            **sampling) -> dict:
    return {
        "model": "test-tiny", "token_ids": list(prompt),
        "sampling": {"temperature": temperature, "seed": seed, "logprobs": logprobs,
                     "top_logprobs": top_logprobs, **sampling},
        "stop": {"max_tokens": max_tokens, "ignore_eos": True},
    }


async def run_stream(eng, req, ctx=None):
    """→ flattened (tokens, logprobs, top_logprobs, finish_reason): delta
    boundaries depend on timing, the stream content may not."""
    toks, lps, tops = [], [], []
    finish = None
    async for item in eng.generate(req, ctx or (JContext() if isinstance(eng, TpuEngine)
                                                else Context())):
        toks.extend(item.get("token_ids") or [])
        lps.extend(item.get("log_probs") or [])
        tops.extend(item.get("top_log_probs") or [])
        if item.get("finish_reason"):
            finish = item["finish_reason"]
    return toks, lps, tops, finish


def mixed_workload(K: int):
    """Stops inside/at/past window boundaries, prefill-only rows, seeded
    sampling, logprobs and ranked alternatives, a 37-token prompt — all
    concurrently (tests/test_engine_pipeline.py's workload)."""
    return [
        request([1, 2, 3], 1),                       # prefill-only (max_tokens=1)
        request([4, 5, 6, 7], max(1, K)),            # exactly one window
        request([8, 9], K + 2),                      # mid second window
        request([3, 1, 4, 1, 5], 11, temperature=0.8, seed=7, logprobs=True),
        request([9, 2, 6], 9, logprobs=True, top_logprobs=3),
        request(list(range(10, 47)), 13),            # 37-token prompt
        request([5, 5, 5], 1),                       # second prefill-only row
    ]


async def run_workload(eng, reqs):
    await eng.start()
    try:
        return await asyncio.gather(*(run_stream(eng, r) for r in reqs))
    finally:
        await eng.stop()


@pytest.mark.parametrize("max_model_len,block_size,max_num_seqs", [
    (128, 4, 8), (2048, 16, 8), (100, 16, 3), (4096, 32, 40), (64, 64, 1),
])
@pytest.mark.parametrize("windows,depth", [(True, 2), (True, 0), (False, 2), (True, -1)])
def test_window_shape_config_matches_jax(max_model_len, block_size, max_num_seqs, windows, depth):
    """Batch and table-width buckets and the effective depth: the port's
    EngineArgs derive the JAX package's, so a window shape (one CUDA
    graph) means the same batch in both."""
    kw = dict(max_model_len=max_model_len, block_size=block_size, max_num_seqs=max_num_seqs,
              pipeline_windows=windows, pipeline_depth=depth)
    port, ref = EngineArgs(device="cpu", **kw), JArgs(**kw)
    assert port.decode_buckets == ref.decode_buckets
    assert port.table_buckets == ref.table_buckets
    assert port.effective_pipeline_depth == ref.effective_pipeline_depth
    for n in range(1, port.blocks_per_seq + 1):
        assert port.bucket_table(n) == ref.bucket_table(n)
    with pytest.raises(ValueError):
        port.bucket_table(port.blocks_per_seq + 1)


def test_window_layout_round_trip():
    """A window's operands survive the packed upload word for word: ints,
    floats bit-cast (negative zero, subnormals, inf) and bools."""
    from dynamo_tpu_torch.engine.runner import window_layout

    rng = np.random.default_rng(3)
    B, W, L = 3, 5, 4
    lay = window_layout(B, W, L)
    f = np.array([-0.0, 1e-40, np.inf], np.float32)
    arrays = dict(
        tokens=rng.integers(0, 2**31, B), positions=rng.integers(0, 9, B),
        tables=rng.integers(0, 99, (B, W)), active=np.array([True, False, True]),
        temps=f, seeds=np.array([0, 2**31 - 1, 5]), steps0=rng.integers(0, 9, B),
        top_k=rng.integers(0, 9, B), top_p=np.array([1.0, 0.5, 0.1], np.float32),
        freq=f[::-1].copy(), pres=np.array([0.25, -1.5, 3.0], np.float32),
        pen=rng.integers(-1, 99, (B, L)), chain_mask=np.array([False, True, True]),
        chain_src=rng.integers(0, 9, B), fold_slots=rng.integers(0, 9, B),
    )
    out = lay.unpack(torch.from_numpy(lay.pack(**arrays)))
    assert lay.size == 13 * B + B * W + B * L
    for name, want in arrays.items():
        got = out[name].numpy()
        assert got.shape == np.shape(want), name
        if got.dtype == np.float32:
            np.testing.assert_array_equal(got.view(np.int32), np.asarray(want).view(np.int32))
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("K", [1, 4])
def test_pipeline_depths_golden_equivalence(np_params, K, kv_quant):
    async def go():
        results = {d: await run_workload(engine(np_params, d, decode_steps=K, kv_quant=kv_quant),
                                         mixed_workload(K))
                   for d in DEPTHS}
        for d in DEPTHS[1:]:
            assert results[d] == results[0], f"depth {d} diverged from unpipelined (K={K})"
        base = results[0]
        assert all(finish == "length" for *_, finish in base)
        assert len(base[0][0]) == 1 and len(base[6][0]) == 1
        assert len(base[3][1]) == 11
        assert len(base[4][2]) == 9 and all(len(alts) == 3 for alts in base[4][2])

    asyncio.run(go())


def test_pipeline_depth_preemption_golden(np_params):
    """KV pressure forces recompute preemption mid-stream; in-flight windows
    must land every token first, so nothing changes across depths."""
    async def collect(depth):
        eng = engine(np_params, depth, max_num_seqs=2, num_kv_blocks=10, max_model_len=64)
        out = await run_workload(eng, [request([1, 2, 3, 4], 20, logprobs=True),
                                       request([9, 8, 7, 6], 20, logprobs=True)])
        return out, eng.total_preemptions

    async def go():
        base, n0 = await collect(0)
        assert n0 > 0
        for toks, lps, _tops, finish in base:
            assert len(toks) == 20 and len(lps) == 20 and finish == "length"
        for depth in DEPTHS[1:]:
            got, n = await collect(depth)
            assert n > 0 and got == base, f"depth {depth} diverged under preemption"

    asyncio.run(go())


@pytest.mark.parametrize("depth", DEPTHS)
def test_pipeline_mid_window_cancel(np_params, depth):
    """A stream cancelled mid-window ends cleanly at every depth (its
    in-flight windows drain as zombie rows), its blocks and slot come
    back, and the engine keeps serving the canonical stream."""
    eng = engine(np_params, depth)

    async def go():
        await eng.start()
        try:
            ctx = Context()
            got = []

            async def consume():
                async for item in eng.generate(request([1, 2, 3], None), ctx):
                    got.extend(item.get("token_ids") or [])
                    if len(got) >= 3:
                        ctx.cancel()

            await asyncio.wait_for(consume(), timeout=30)
            assert got
            after = await run_stream(eng, request([4, 5, 6, 7], 9))
            for _ in range(200):
                if eng.pool.num_active == 0 and not eng.busy():
                    break
                await asyncio.sleep(0.01)
            assert eng.pool.num_active == 0
        finally:
            await eng.stop()
        solo = await run_workload(engine(np_params, 0), [request([4, 5, 6, 7], 9)])
        assert after == solo[0]

    asyncio.run(go())
    # The engine thread has stopped: every chain slot came back.
    assert sorted(eng._free_slots) == list(range(eng.args.max_num_seqs))


def test_window_size_equivalence_across_depths(np_params):
    """decode_steps 1 and 4 agree with each other at depth 2 (the K=1 path
    drains the queue before every step)."""
    async def go():
        k1 = await run_workload(engine(np_params, 2, decode_steps=1), mixed_workload(1))
        k4 = await run_workload(engine(np_params, 2, decode_steps=4), mixed_workload(1))
        assert k1 == k4

    asyncio.run(go())


@pytest.mark.parametrize("mode", ["greedy", "simple", "full"])
def test_multi_decode_chained_matches_jax(np_params, mode):
    """One window through the port's and the JAX package's multi_decode
    on the same weights and caches: rows 0 and 1 chain their input from
    ``last_toks`` slots, row 2 takes its token from the host, row 3 pads.
    Tokens and top-n ids equal, logprobs and KV pages within 1e-4."""
    from dynamo_tpu_torch.engine import model as TM

    jcfg, tcfg = JCfg(), ModelConfig()
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, "cpu", torch.float32)
    jcache = JM.init_kv_cache(jcfg, 32, 4, jnp.float32)
    tcache = TM.init_kv_cache(tcfg, 32, 4, torch.float32, torch.device("cpu"))
    toks = np.zeros((3, 16), np.int32)
    lens = np.array([13, 9, 6], np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = np.arange(1 + 40 * r, 1 + 40 * r + n)
    tables = np.zeros((4, 8), np.int32)
    tables[0, :6], tables[1, :5], tables[2, :4] = range(1, 7), range(7, 12), range(12, 16)
    jl, jcache = JM.prefill_batch(jcfg, jparams, jcache, jnp.asarray(toks), jnp.asarray(tables[:3]),
                                  jnp.zeros((3,), jnp.int32), jnp.asarray(lens))
    TM.prefill_batch(tcfg, tparams, tcache, torch.from_numpy(toks), torch.from_numpy(tables[:3]),
                     torch.zeros((3,), dtype=torch.int32), torch.from_numpy(lens))
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    last = np.zeros((6,), np.int32)
    last[[2, 0]] = first[:2]                       # rows 0, 1 live in slots 2, 0
    chain_mask = np.array([True, True, False, False])
    chain_src = np.array([2, 0, 0, 0], np.int32)
    tokens = np.array([0, 0, first[2], 0], np.int32)
    positions = np.array([13, 9, 6, 0], np.int32)
    active = np.array([True, True, True, False])
    temps = np.array([0.0, 0.8, 1.1, 0.0], np.float32)
    seeds = np.array([5, 6, 2**31 - 1, 0], np.uint32)
    steps0 = np.array([1, 1, 1, 0], np.int32)
    tk = np.array([0, 5, 0, 0], np.int32)
    tp = np.array([1.0, 0.9, 0.8, 1.0], np.float32)
    freq = np.array([0.5, 0.0, 0.25, 0.0], np.float32)
    pres = np.array([0.0, 0.5, 0.25, 0.0], np.float32)
    pen = np.full((4, 16), -1, np.int32)
    pen[:3, 0] = first
    K, n = 5, 3
    j = JM.multi_decode(jcfg, K, mode, n, jparams, jcache, *map(jnp.asarray, (
        tokens, positions, tables, active, temps, seeds, steps0, tk, tp, freq, pres, pen,
        chain_mask, chain_src, last)), attn_impl="xla")
    t = TM.multi_decode(tcfg, K, mode, n, tparams, tcache, *map(torch.from_numpy, (
        tokens, positions, tables, active, temps, seeds.astype(np.int64), steps0, tk, tp, freq,
        pres, pen, chain_mask, chain_src, last)))
    live = slice(0, 3)
    np.testing.assert_array_equal(t[0].numpy()[:, live], np.asarray(j[0])[:, live])
    np.testing.assert_allclose(t[1].numpy()[:, live], np.asarray(j[1])[:, live], **TOL)
    np.testing.assert_array_equal(t[3].numpy()[:, live], np.asarray(j[3])[:, live])
    np.testing.assert_allclose(t[2].numpy()[:, live], np.asarray(j[2])[:, live], **TOL)
    for a, b in zip(j[4], tcache):
        if a is not None:
            np.testing.assert_allclose(b.numpy()[:, 1:], np.asarray(a)[:, 1:], **TOL)


def _assert_streams_close(port, ref):
    for (pt, pl, ptop, pf), (jt, jl, jtop, jf) in zip(port, ref):
        assert pt == jt and pf == jf
        np.testing.assert_allclose(pl, jl, **TOL)
        assert [[a for a, _ in alts] for alts in ptop] == [[a for a, _ in alts] for alts in jtop]
        np.testing.assert_allclose([[v for _, v in alts] for alts in ptop] or [[]],
                                   [[v for _, v in alts] for alts in jtop] or [[]], **TOL)


def test_streams_match_tpu_engine(np_params):
    """The mixed workload, seeded sampled streams and full-sampler requests
    (top-k, top-p, both penalties) through the port and through TpuEngine
    at depth 2, K 4: the same tokens."""
    sampled = [request([7, 1, 2, s % 500], 17, temperature=0.8, seed=s, logprobs=True)
               for s in (3, 11, 12, 1000, 2**31 - 1)]
    full = [
        request([4, 4, 2], 15, temperature=0.9, seed=5, top_k=5),
        request([6, 6, 1, 3], 15, temperature=1.1, seed=6, top_p=0.8, logprobs=True),
        request([2, 3, 5, 7], 15, temperature=0.7, seed=8, frequency_penalty=0.5,
                presence_penalty=0.25),
        request([9, 9, 9], 15, seed=9, frequency_penalty=1.0, presence_penalty=0.5),
    ]

    async def go():
        out = {}
        jargs = JArgs(model=JCfg(), attn_impl="xla", pipeline_depth=2, **BASE)
        for name, eng in (("port", engine(np_params, 2)), ("jax", TpuEngine(jargs, params=np_params))):
            await eng.start()
            try:
                mixed = await asyncio.gather(*(run_stream(eng, r) for r in mixed_workload(4)))
                samp = await asyncio.gather(*(run_stream(eng, r) for r in sampled))
                fulls = await asyncio.gather(*(run_stream(eng, r) for r in full))
            finally:
                await eng.stop()
            out[name] = (mixed, samp, fulls)
        for port, ref in zip(out["port"], out["jax"]):
            _assert_streams_close(port, ref)
        # The seeds really steer the draws.
        assert len({tuple(t) for t, *_ in out["port"][1]}) == len(sampled)

    asyncio.run(go())
