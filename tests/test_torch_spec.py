"""Speculative decoding in the port against the JAX package's, on the CPU.

Mirrors tests/test_engine_spec.py with the port's ``TorchEngine`` beside
``TpuEngine`` (XLA attention) on the same numpy weights (test-tiny,
float32) and the same seeded requests:

- token streams equal, logprobs and top-logprob values within 1e-4 (the
  forward pass's float32 tolerance, tests/test_torch_model.py);
- the spec counters (verify row-passes, proposed, accepted and emitted
  draft tokens, tree passes) equal wherever scheduling is deterministic:
  unpipelined engines (``pipeline_depth`` 0) whose requests are all
  submitted before the scheduler starts, so both engines admit the same
  waves. At depth 1 and 2 the drafts depend on which windows the host has
  drained when it drafts, which in the JAX engine depends on its device's
  timing, so those runs compare streams;
- stepwise verify (``spec_fused=False``) equal to the port's own dense
  path byte for byte: tokens, logprobs and top-logprobs.

Then the verify pass itself (``model.spec_verify``) against the JAX
package's on the same caches, with drafts the model accepts, in linear
fused, linear stepwise and tree mode, greedy and sampled, float and int8
pages: emitted tokens, ``n_emit``, per-node argmax and the chain-buffer
token equal, logprobs and the written KV pages within 1e-4.
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
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context

BASE = dict(block_size=4, num_kv_blocks=256, max_num_seqs=8, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4)
TOL = dict(atol=1e-4, rtol=1e-4)
STATS = ("rows", "proposed", "accepted", "emitted", "tree_passes")

# Tiled prompts make the history n-gram-rich; acceptance then comes from
# the tiny model's own greedy loops (tests/test_engine_spec.py's prompts).
LOOPY = ([1, 2, 3] * 6, [7, 8, 9, 4] * 4, [5, 6] * 8)
INCOMPRESSIBLE = [11, 13, 17, 19, 23, 29, 31, 37]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def spec_kw(S: int, depth: int = 0, gate: float = 0.0, fused: bool = False, **kw) -> dict:
    """Engine knobs of a speculating engine (``S`` = 0: the dense path)."""
    return dict(spec_tokens=S, spec_gate=gate, spec_fused=fused, pipeline_depth=depth,
                pipeline_windows=depth > 0, **kw)


def port_engine(np_params, **kw) -> TorchEngine:
    args = EngineArgs(model=ModelConfig(), device="cpu", **{**BASE, **kw})
    return TorchEngine(args, params=params_from_numpy(np_params, "cpu", torch.float32))


def jax_engine(np_params, **kw) -> TpuEngine:
    return TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **{**BASE, **kw}), params=np_params)


def request(prompt, max_tokens, temperature=0.0, seed=0, logprobs=False, top_logprobs=0,
            eos=()) -> dict:
    return {
        "model": "test-tiny", "token_ids": list(prompt),
        "sampling": {"temperature": temperature, "seed": seed, "logprobs": logprobs,
                     "top_logprobs": top_logprobs},
        "stop": {"max_tokens": max_tokens, "ignore_eos": not eos, "stop_token_ids": list(eos)},
    }


async def _stream(eng, req):
    toks, lps, tops = [], [], []
    finish = None
    ctx = JContext() if isinstance(eng, TpuEngine) else Context()
    async for item in eng.generate(req, ctx):
        toks.extend(item.get("token_ids") or [])
        lps.extend(item.get("log_probs") or [])
        tops.extend(item.get("top_log_probs") or [])
        if item.get("finish_reason"):
            finish = item["finish_reason"]
    return toks, lps, tops, finish


async def _workload(eng, reqs):
    # Every request is submitted before the scheduler starts, so the first
    # admission wave holds all of them in arrival order, in both engines.
    tasks = [asyncio.ensure_future(_stream(eng, r)) for r in reqs]
    await asyncio.sleep(0)
    await eng.start()
    try:
        return await asyncio.gather(*tasks)
    finally:
        await eng.stop()


def run(eng, reqs):
    """→ (streams [(tokens, logprobs, top_logprobs, finish)], spec counters)."""
    out = asyncio.run(_workload(eng, reqs))
    stats = {k: getattr(eng, f"total_spec_{k}") for k in STATS}
    return out, stats


def assert_streams_close(port, ref):
    """Tokens and finish reasons equal, logprob values within TOL."""
    assert len(port) == len(ref)
    for (pt, pl, ptop, pf), (jt, jl, jtop, jf) in zip(port, ref):
        assert pt == jt and pf == jf
        np.testing.assert_allclose(pl, jl, **TOL)
        assert [[a for a, _ in alts] for alts in ptop] == [[a for a, _ in alts] for alts in jtop]
        np.testing.assert_allclose([[v for _, v in alts] for alts in ptop] or [[]],
                                   [[v for _, v in alts] for alts in jtop] or [[]], **TOL)


def tokens_only(streams):
    return [(s[0], s[3]) for s in streams]


def mixed_workload():
    """Loopy and incompressible prompts side by side, logprobs and ranked
    alternatives, a prefill-only row, stops at and inside window and draft
    boundaries (tests/test_engine_spec.py's workload)."""
    return [
        request(LOOPY[0], 24),
        request(LOOPY[1], 17, logprobs=True),
        request(LOOPY[2], 21, logprobs=True, top_logprobs=3),
        request(INCOMPRESSIBLE, 20),
        request([2, 4, 8], 1),
        request(list(range(40, 70)), 9),
    ]


def check_against_both(np_params, reqs, S, depth=0, fused=False, counters=True, **kw):
    """The port speculating, against the JAX engine speculating (streams,
    and counters when ``counters``) and against the port's dense path
    (byte for byte when stepwise, tokens and logprobs within TOL when
    fused). → (port streams, port counters)."""
    port, ps = run(port_engine(np_params, **spec_kw(S, depth, fused=fused, **kw)), reqs())
    ref, js = run(jax_engine(np_params, **spec_kw(S, depth, fused=fused, **kw)), reqs())
    dense, _ = run(port_engine(np_params, **spec_kw(0, **kw)), reqs())
    assert_streams_close(port, ref)
    if counters:
        assert ps == js
    if fused:
        assert_streams_close(port, dense)
    else:
        assert port == dense
    assert ps["emitted"] == ps["rows"] + ps["accepted"]
    assert ps["accepted"] <= ps["proposed"]
    return port, ps


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_spec_greedy_matches_tpu_engine(np_params, S):
    """Greedy stepwise speculation at every draft length: the JAX
    engine's streams and counters, the port's dense streams exactly."""
    port, stats = check_against_both(np_params, mixed_workload, S)
    assert stats["rows"] > 0 and stats["accepted"] > 0
    assert all(finish == "length" for *_, finish in port)


def test_spec_fused_matches_tpu_engine(np_params):
    """The fused single-pass verify (the multi-query attention on the
    card): the JAX engine's fused tokens and counters, the port's dense
    tokens, logprobs within TOL."""
    _, stats = check_against_both(np_params, mixed_workload, 8, fused=True)
    assert stats["rows"] > 0 and stats["accepted"] > 0


@pytest.mark.parametrize("depth", [1, 2])
def test_spec_composes_with_pipeline(np_params, depth):
    """A verify pass is a pipeline barrier between pipelined windows:
    streams equal the unpipelined dense port's and the JAX engine's at
    the same depth."""
    port, stats = run(port_engine(np_params, **spec_kw(4, depth)), mixed_workload())
    ref, jstats = run(jax_engine(np_params, **spec_kw(4, depth)), mixed_workload())
    dense, _ = run(port_engine(np_params, **spec_kw(0)), mixed_workload())
    assert port == dense
    assert_streams_close(port, ref)
    assert stats["rows"] > 0 and jstats["rows"] > 0


def test_spec_stop_token_mid_draft(np_params):
    """An eos inside an accepted draft run truncates the stream where the
    dense path stops it."""
    dense, _ = run(port_engine(np_params, **spec_kw(0)), [request(LOOPY[0], 24, seed=3)])
    toks = dense[0][0]
    assert len(toks) == 24
    eos = toks[13]
    port, _ = check_against_both(
        np_params, lambda: [request(LOOPY[0], 24, seed=3, eos=(eos,))], 8)
    assert port[0][3] == "stop" and port[0][0][-1] == eos and len(port[0][0]) < 24


@pytest.mark.parametrize("max_tokens", [1, 2, 3, 5, 7, 10, 13])
def test_spec_max_tokens_inside_accepted_run(np_params, max_tokens):
    port, _ = check_against_both(
        np_params,
        lambda: [request(LOOPY[0], max_tokens, seed=1), request(LOOPY[2], max_tokens, seed=2)],
        8)
    assert all(len(s[0]) == max_tokens and s[3] == "length" for s in port)


def test_spec_preemption_golden(np_params):
    """KV pressure forces recompute preemption while verify passes run:
    the drained passes land every kept token first, and the EMA, cooldown
    and drafter index ride the sequence through its requeue. A preempted
    sequence re-prefills its generated tokens, and the dense and
    speculating engines preempt at different points, so logprobs after a
    preemption agree within TOL (prefill's reduction order), tokens
    exactly."""
    def reqs():
        return [request(LOOPY[0][:4], 20, logprobs=True), request(LOOPY[1][:4], 20, logprobs=True)]

    kw = dict(max_num_seqs=2, num_kv_blocks=10, max_model_len=64)
    dense_eng = port_engine(np_params, **spec_kw(0), **kw)
    dense, _ = run(dense_eng, reqs())
    assert dense_eng.total_preemptions > 0
    for S in (2, 8):
        eng = port_engine(np_params, **spec_kw(S), **kw)
        port, stats = run(eng, reqs())
        ref, _ = run(jax_engine(np_params, **spec_kw(S), **kw), reqs())
        assert_streams_close(port, dense)
        assert_streams_close(port, ref)
        assert stats["rows"] > 0 and eng.total_preemptions > 0


def test_spec_sampled_rows(np_params):
    """Seeded sampled rows: the JAX engine's tokens (its threefry bits,
    its acceptance draws) and counters; a repeat gives the same streams; a
    row that never drafts rides the dense noise stream; a greedy row in a
    sampled batch stays the dense greedy stream."""
    def reqs():
        return [
            request([37, 11, 29, 5, 17, 2, 23, 41], 15, temperature=0.9, seed=11, logprobs=True),
            request(LOOPY[0], 15, temperature=0.7, seed=12),
            request(LOOPY[1], 15, seed=13),
            request(LOOPY[2], 15, temperature=1.3, seed=14, logprobs=True),
        ]

    port, stats = run(port_engine(np_params, **spec_kw(4)), reqs())
    again, _ = run(port_engine(np_params, **spec_kw(4)), reqs())
    ref, jstats = run(jax_engine(np_params, **spec_kw(4)), reqs())
    dense, _ = run(port_engine(np_params, **spec_kw(0)), reqs())
    assert port == again
    assert_streams_close(port, ref)
    assert stats == jstats and stats["proposed"] > 0
    assert port[0] == dense[0]
    assert port[2] == dense[2]
    assert all(len(s[0]) == 15 and s[3] == "length" for s in port)


def test_spec_gate_disables_speculation(np_params):
    """An unattainable gate keeps both engines on the dense path."""
    gated, stats = run(port_engine(np_params, **spec_kw(8, gate=1e9)), mixed_workload())
    _, jstats = run(jax_engine(np_params, **spec_kw(8, gate=1e9)), mixed_workload())
    dense, _ = run(port_engine(np_params, **spec_kw(0)), mixed_workload())
    assert gated == dense
    assert stats["rows"] == 0 and jstats["rows"] == 0


@pytest.mark.parametrize("adaptive", [True, False])
def test_spec_budget_modes_match_tpu_engine(np_params, adaptive):
    """Uniform and adaptive batch node budgets: the same drafts, passes
    and reallocations as the JAX engine."""
    port_eng = port_engine(np_params, **spec_kw(3, spec_budget_adaptive=adaptive))
    jax_eng = jax_engine(np_params, **spec_kw(3, spec_budget_adaptive=adaptive))
    port, stats = run(port_eng, mixed_workload())
    ref, jstats = run(jax_eng, mixed_workload())
    assert_streams_close(port, ref)
    assert stats == jstats
    assert port_eng.total_spec_budget_reallocs == jax_eng.total_spec_budget_reallocs
    assert (port_eng.total_spec_budget_reallocs > 0) == adaptive


def test_spec_config_matches_jax():
    """The spec knobs carry the JAX package's defaults and refusals."""
    port, ref = EngineArgs(device="cpu"), JArgs()
    for name in ("spec_tokens", "spec_ngram", "spec_ema_alpha", "spec_ema_disable",
                 "spec_probe_every", "spec_tree_width", "spec_tree_depth", "spec_fused",
                 "spec_gate", "spec_budget_adaptive"):
        assert getattr(port, name) == getattr(ref, name), name
    for bad in (dict(spec_tree_width=0), dict(spec_tree_depth=-1)):
        with pytest.raises(ValueError):
            EngineArgs(device="cpu", **bad)
        with pytest.raises(ValueError):
            JArgs(**bad)
    # The port's own limit: a verify pass of at most 64 slots (the kernel's).
    EngineArgs(device="cpu", spec_tokens=31)
    with pytest.raises(ValueError, match="64 verify slots"):
        EngineArgs(device="cpu", spec_tokens=32)
    EngineArgs(device="cpu", spec_tokens=63, spec_budget_adaptive=False)


# -- the verify pass ------------------------------------------------------------


def _prefilled(np_params, kv_quant):
    """Both packages' caches after prefilling three rows (13, 9 and 6
    tokens; row 3 pads) → (jax cache, port cache, tables, first tokens)."""
    jcfg, tcfg = JCfg(), ModelConfig()
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, "cpu", torch.float32)
    jcache = JM.init_kv_cache(jcfg, 32, 4, jnp.float32, kv_quant=kv_quant)
    tcache = TM.init_kv_cache(tcfg, 32, 4, torch.float32, torch.device("cpu"), kv_quant=kv_quant)
    toks = np.zeros((3, 16), np.int32)
    lens = np.array([13, 9, 6], np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = np.arange(1 + 40 * r, 1 + 40 * r + n)
    tables = np.zeros((4, 8), np.int32)
    tables[0, :6], tables[1, :5], tables[2, :4] = range(1, 7), range(7, 12), range(12, 16)
    jl, jcache = JM.prefill_batch(jcfg, jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(tables[:3]), jnp.zeros((3,), jnp.int32),
                                  jnp.asarray(lens))
    TM.prefill_batch(tcfg, tparams, tcache, torch.from_numpy(toks),
                     torch.from_numpy(tables[:3]), torch.zeros((3,), dtype=torch.int32),
                     torch.from_numpy(lens))
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    return jparams, tparams, jcache, tcache, tables, first


def _chain(np_params, kv_quant, first, S):
    """Each row's greedy continuation of S tokens (the drafts the model
    accepts), from the port's own decode steps on a fresh cache."""
    _, tparams, _, tcache, tables, _ = _prefilled(np_params, kv_quant)
    tok = torch.from_numpy(np.append(first, 0).astype(np.int32))
    pos = torch.tensor([13, 9, 6, 0], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    out = []
    for _ in range(S):
        logits = TM.decode_step(ModelConfig(), tparams, tcache, tok, pos,
                                torch.from_numpy(tables), active)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok.numpy().copy())
        pos = pos + 1
    return np.stack(out, axis=1)  # [4, S]


def _tree_topology(B, S1):
    """Per row: nodes 1 and 2 are siblings under the root, node 3 hangs
    under node 1 and every later node under the one before it →
    (parents, anc, depth)."""
    parents = np.zeros((B, S1), np.int32)
    for j in range(3, S1):
        parents[:, j] = 1 if j == 3 else j - 1
    anc = np.zeros((B, S1, S1), np.int8)
    depth = np.zeros((B, S1), np.int32)
    for b in range(B):
        anc[b, 0, 0] = 1
        for j in range(1, S1):
            p = parents[b, j]
            anc[b, j] = anc[b, p]
            anc[b, j, j] = 1
            depth[b, j] = depth[b, p] + 1
    return parents, anc, depth


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("kind", ["fused", "stepwise", "tree"])
def test_verify_pass_matches_jax(np_params, kind, mode, kv_quant):
    S1 = 5
    jparams, tparams, jcache, tcache, tables, first = _prefilled(np_params, kv_quant)
    chain = _chain(np_params, kv_quant, first, S1 - 1)
    tokens = np.zeros((4, S1), np.int32)
    tokens[:3, 0] = first
    tree = None
    if kind == "tree":
        # Node 2 is a sibling of node 1 that the greedy walk rejects;
        # nodes 3.. continue node 1's chain, so the accepted path skips a
        # slot and the compaction moves KV.
        tokens[:3, 1] = chain[:3, 0]
        tokens[:3, 2] = (chain[:3, 0] + 7) % 512
        tokens[:3, 3:] = chain[:3, 1 : S1 - 2]
        tree = _tree_topology(4, S1)
    else:
        tokens[:3, 1:] = chain[:3]
        tokens[1, 3] = (tokens[1, 3] + 1) % 512          # row 1 rejects at slot 3
    positions0 = np.array([13, 9, 6, 0], np.int32)
    draft_len = np.array([S1 - 1, S1 - 1, 1, 0], np.int32)
    active = np.array([True, True, True, False])
    temps = np.array([0.0, 0.8, 1.2, 0.0] if mode == "simple" else [0.0] * 4, np.float32)
    seeds = np.array([5, 6, 7, 0], np.uint32)
    steps0 = np.array([1, 2, 3, 0], np.int32)
    args = (tokens, positions0, draft_len, tables, active, temps, seeds, steps0)
    fused = kind != "stepwise"
    j = JM.spec_verify(JCfg(), S1, mode, 3, jparams, jcache, *map(jnp.asarray, args),
                       *((jnp.asarray(a) for a in tree) if tree else (None,) * 3),
                       fused=fused, attn_impl="xla")
    targs = (tokens, positions0, draft_len, tables, active, temps, seeds.astype(np.int64),
             steps0)
    t = TM.spec_verify(ModelConfig(), S1, mode, 3, tparams, tcache, *map(torch.from_numpy, targs),
                       *((torch.from_numpy(a) for a in tree) if tree else (None,) * 3),
                       fused=fused)
    j_n = np.asarray(j[1])[:3]
    np.testing.assert_array_equal(t[1].numpy()[:3], j_n)
    # Row 0 (greedy) accepts its whole draft: every slot, or in the tree
    # the path 0 → 1 → 3 → … past the rejected sibling.
    assert j_n[0] == (S1 - 1 if kind == "tree" else S1)
    if mode == "greedy" and kind != "tree":
        assert j_n[1] == 3
    for r in range(3):
        n, live = j_n[r], draft_len[r] + 1
        np.testing.assert_array_equal(t[0].numpy()[r, :n], np.asarray(j[0])[r, :n])
        np.testing.assert_allclose(t[2].numpy()[r, :n], np.asarray(j[2])[r, :n], **TOL)
        np.testing.assert_array_equal(t[3].numpy()[r, :live], np.asarray(j[3])[r, :live])
        np.testing.assert_array_equal(t[5].numpy()[r, :n], np.asarray(j[5])[r, :n])
        np.testing.assert_allclose(t[4].numpy()[r, :n], np.asarray(j[4])[r, :n], **TOL)
    np.testing.assert_array_equal(t[6].numpy()[:3], np.asarray(j[6])[:3])
    # Every KV page but the garbage block, tree compaction included.
    for a, b in zip(j[7], tcache):
        if a is not None:
            np.testing.assert_allclose(b.numpy()[:, 1:], np.asarray(a)[:, 1:], **TOL)


def test_verify_refuses_unported_operands(np_params):
    """Grammar masks on a linear pass (the engine sends them only with a
    tree, as the JAX engine does) and an adapter bank without per-row
    adapter slots (or slots without a bank) raise instead of being
    ignored."""
    _, tparams, _, tcache, tables, first = _prefilled(np_params, "none")
    B, S1 = 4, 3
    args = [torch.zeros((B, S1), dtype=torch.int32), torch.zeros((B,), dtype=torch.int32),
            torch.zeros((B,), dtype=torch.int32), torch.from_numpy(tables),
            torch.zeros((B,), dtype=torch.bool), torch.ones((B,)),
            torch.zeros((B,), dtype=torch.int64), torch.zeros((B,), dtype=torch.int32)]
    with pytest.raises(ValueError, match="tree verify passes only"):
        TM.spec_verify(ModelConfig(), S1, "greedy", 0, tparams, tcache, *args,
                       mask_bits=torch.zeros((B, S1, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="ride a dispatch together"):
        TM.spec_verify(ModelConfig(), S1, "greedy", 0, tparams, tcache, *args, lora={})
    with pytest.raises(ValueError, match="ride a dispatch together"):
        TM.spec_verify(ModelConfig(), S1, "greedy", 0, tparams, tcache, *args,
                       adapter_slots=torch.zeros((B,), dtype=torch.int32))
