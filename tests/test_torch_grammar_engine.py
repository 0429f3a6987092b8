"""Grammar-constrained decoding in ``TorchEngine`` against ``TpuEngine``.

Both engines on the same numpy weights (test-tiny, float32; the JAX one
on XLA attention) serve the same seeded requests with a bounded
``response_format`` (tests/test_engine_grammar.py's schema: a string of
at most 8 characters, an integer, a boolean):

- constrained streams, dense (single masked steps) greedy and seeded
  sampled, are equal token for token, every one finishes ``stop`` and
  parses against the schema; logprobs (the raw model's) within 1e-4, the
  forward pass's float32 tolerance (tests/test_torch_pipeline.py);
- constrained tree speculation, uniform and adaptive budgets, widths 1
  and 2: equal to the JAX engine's streams and spec counters, and equal
  to the dense constrained streams (tests/test_engine_grammar.py:123-165).
  Runs are unpipelined and every request is queued before the scheduler
  starts, in one order, so both engines admit one wave (the rule of
  tests/test_torch_spec.py);
- a mixed batch: unconstrained rows riding constrained batches (all-ones
  masks) equal their solo unconstrained runs bit for bit;
- a malformed ``response_format`` errors its stream with the JAX
  engine's message; the schema cache is shared across requests;
- preemption under KV pressure and the resumed constrained row; a
  migrated leg (``kv_transfer_params.resume``) replays the FSM over the
  tokens an earlier leg generated and continues the single-leg stream;
- grammar-pruned and forced-token drafts (the port's ``engine/drafter.py``
  is a copy): the same drafts as the JAX drafter under the same
  constraints, fake FSMs and a compiled schema;
- the ``engine_grammar_*`` gauges on each package's registry.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import drafter as jd
from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JRegistry
from dynamo_tpu_torch.engine import drafter as td
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.grammar import build_compiler
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

EOS = 257
TOL = dict(atol=1e-4, rtol=1e-4)
SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 8},
    "age": {"type": "integer"},
    "active": {"type": "boolean"},
}}
RF = {"type": "json_schema", "json_schema": {"name": "x", "schema": SCHEMA}}
BASE = dict(block_size=4, num_kv_blocks=320, max_num_seqs=8, max_model_len=256,
            max_prefill_tokens=64, dtype="float32", decode_steps=4, pipeline_depth=0,
            pipeline_windows=False)
STATS = ("passes", "rows", "proposed", "accepted", "emitted", "tree_passes", "budget_reallocs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def spec_kw(S=0, width=2, depth=0, adaptive=True, **kw):
    return dict(spec_tokens=S, spec_gate=0.0, spec_ngram=3, spec_tree_width=width,
                spec_tree_depth=depth, spec_budget_adaptive=adaptive, **kw)


def engines(np_params, **kw):
    port = TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **{**BASE, **kw}),
                       params=params_from_numpy(np_params, "cpu", torch.float32))
    ref = TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **{**BASE, **kw}), params=np_params)
    return port, ref


def request(prompt: str, max_tokens=64, temperature=0.0, seed=0, rf=RF, logprobs=True,
            **ktp) -> dict:
    req = {"model": "test-tiny", "token_ids": list(prompt.encode()),
           "sampling": {"temperature": temperature, "seed": seed, "logprobs": logprobs},
           "stop": {"max_tokens": max_tokens}, "eos_token_ids": [EOS]}
    if rf is not None:
        req["response_format"] = rf
    if ktp:
        req["kv_transfer_params"] = ktp
    return req


async def _stream(eng, req):
    toks, lps, finish, err = [], [], None, None
    ctx = JContext() if isinstance(eng, TpuEngine) else Context()
    async for item in eng.generate(req, ctx):
        toks.extend(item.get("token_ids") or [])
        lps.extend(item.get("log_probs") or [])
        if item.get("finish_reason"):
            finish, err = item["finish_reason"], item.get("error")
    return toks, lps, finish, err


async def _workload(eng, reqs, registry=None):
    """Queue every request (one at a time, so the order is the list's:
    a grammar compiles in a thread before its request is queued; a
    malformed one ends its stream instead), then start the scheduler: one
    admission wave in both engines."""
    tasks = []
    for r in reqs:
        tasks.append(asyncio.ensure_future(_stream(eng, r)))
        while eng.metrics().worker.num_requests_waiting + sum(t.done() for t in tasks) \
                < len(tasks):
            await asyncio.sleep(0.001)
    if registry is not None:
        eng.bind_metrics(registry)
    await eng.start()
    try:
        return await asyncio.gather(*tasks)
    finally:
        await eng.stop()


def run(eng, reqs, registry=None):
    out = asyncio.run(_workload(eng, reqs, registry))
    stats = {k: getattr(eng, f"total_spec_{k}") for k in STATS}
    stats["grammar_seqs"] = eng.total_grammar_seqs
    stats["preemptions"] = sum(eng.total_preemptions_by.values())
    return out, stats


def text(toks) -> str:
    return bytes(t for t in toks if t < 256).decode()


def assert_valid(stream):
    toks, _, finish, _ = stream
    assert finish == "stop" and toks[-1] == EOS
    obj = json.loads(text(toks))
    assert set(obj) == {"name", "age", "active"}
    assert isinstance(obj["name"], str) and len(obj["name"]) <= 8
    assert isinstance(obj["age"], int) and not isinstance(obj["age"], bool)
    assert isinstance(obj["active"], bool)


def assert_same(port, ref):
    assert len(port) == len(ref)
    for (pt, pl, pf, pe), (jt, jl, jf, je) in zip(port, ref):
        assert (pt, pf, pe) == (jt, jf, je)
        np.testing.assert_allclose(pl, jl, **TOL)


def reqs_mixed():
    return [
        request("extract record one: alpha beta", seed=1),
        request("free running text " * 2, seed=3, rf=None, max_tokens=16),
        request("extract record three: delta", seed=4),
    ]


def reqs_sampled():
    return [request(f"record {i}", temperature=0.9, seed=50 + i, max_tokens=96)
            for i in range(3)]


@pytest.fixture(scope="module")
def dense(np_params):
    """The dense constrained runs both later comparisons need."""
    out = {}
    for name, reqs in (("mixed", reqs_mixed()), ("sampled", reqs_sampled())):
        port, ref = engines(np_params)
        out[name] = (run(port, reqs), run(ref, reqs))
    return out


@pytest.mark.parametrize("name", ["mixed", "sampled"])
def test_dense_constrained_streams_match_jax(dense, name):
    (port, pstats), (ref, jstats) = dense[name]
    assert_same(port, ref)
    for i, s in enumerate(port):
        if not (name == "mixed" and i == 1):
            assert_valid(s)
    assert pstats == jstats and pstats["grammar_seqs"] == (2 if name == "mixed" else 3)


@pytest.mark.parametrize("width,depth,adaptive", [(1, 0, True), (2, 0, True), (2, 2, True),
                                                  (2, 0, False)])
def test_constrained_tree_matches_jax_and_dense(np_params, dense, width, depth, adaptive):
    port, ref = engines(np_params, **spec_kw(S=4, width=width, depth=depth, adaptive=adaptive))
    p, pstats = run(port, reqs_mixed())
    j, jstats = run(ref, reqs_mixed())
    assert pstats == jstats
    assert [s[:1] + s[2:] for s in p] == [s[:1] + s[2:] for s in j]
    assert_same(p, j)
    (dense_p, _), _ = dense["mixed"]
    assert [s[0] for s in p] == [s[0] for s in dense_p]
    # Every constrained batch is a tree pass, even at width 1.
    assert pstats["passes"] > 0 and pstats["tree_passes"] > 0
    if not adaptive:
        assert pstats["budget_reallocs"] == 0


def test_sampled_constrained_tree_matches_jax(np_params):
    port, ref = engines(np_params, **spec_kw(S=4))
    reqs = reqs_sampled()
    p, pstats = run(port, reqs)
    j, jstats = run(ref, reqs)
    assert_same(p, j)
    assert pstats == jstats and pstats["passes"] > 0
    for s in p:
        assert_valid(s)


def test_mixed_batch_unconstrained_rows_equal_their_solo_runs(np_params, dense):
    """Unconstrained rows inside constrained batches ride all-ones masks,
    so their streams equal their runs alone (greedy and sampled)."""
    riders = [request("free running text " * 2, seed=3, rf=None, max_tokens=16),
              request("another free row", temperature=0.8, seed=8, rf=None, max_tokens=20)]
    mixed = [request("extract record one: alpha beta", seed=1), riders[0],
             request("record x", temperature=0.7, seed=9), riders[1]]
    port, ref = engines(np_params)
    p, _ = run(port, mixed)
    j, _ = run(ref, mixed)
    assert_same(p, j)
    solo, _ = run(engines(np_params)[0], riders)
    assert [p[1], p[3]] == solo


def test_malformed_response_format_errors_the_stream(np_params):
    bad = {"type": "json_schema", "json_schema": {"schema": {"type": "zzz"}}}
    reqs = [request("x", rf=bad, seed=1), request("fine", seed=2, max_tokens=8, rf=None)]
    port, ref = engines(np_params)
    p, _ = run(port, reqs)
    j, _ = run(ref, reqs)
    assert p[0][2] == "error" and "response_format" in p[0][3]
    assert p[0][2:] == j[0][2:]
    assert_same(p[1:], j[1:])


def test_schema_cache_shared_across_requests(np_params):
    async def go():
        eng = engines(np_params)[0]
        await eng.start()
        try:
            await asyncio.gather(*(_stream(eng, request(f"r{i}", seed=i)) for i in range(3)))
            return eng._grammar_compiler
        finally:
            await eng.stop()

    comp = asyncio.run(go())
    assert comp is not None and (comp.misses, comp.hits) == (1, 2)


def test_preempted_constrained_row_resumes_as_the_jax_engine(np_params):
    """Two constrained rows outgrow a 20-block pool: the newest is
    preempted, re-admitted with its tokens as the prompt and its FSM state
    kept; both engines preempt alike and give the same valid streams."""
    kw = dict(num_kv_blocks=21, max_model_len=96)
    reqs = [request("p" * 10, seed=1, max_tokens=80), request("q" * 10, seed=2, max_tokens=80)]
    port, ref = engines(np_params, **kw)
    p, pstats = run(port, reqs)
    j, jstats = run(ref, reqs)
    assert pstats["preemptions"] == jstats["preemptions"] > 0
    assert_same(p, j)
    for s in p:
        assert_valid(s)


def test_migrated_leg_replays_the_fsm(np_params, dense):
    """A resumed leg carries the original prompt plus k generated tokens
    and ``resume.prompt_len``: its FSM replays those tokens, and the leg
    continues the one-leg stream exactly (greedy), in both engines."""
    (port_dense, _), _ = dense["mixed"]
    full = port_dense[0][0]
    prompt = "extract record one: alpha beta"
    legs = []
    for k in (1, 9, len(full) // 2):
        r = request(prompt, seed=1, max_tokens=64 - k, resume={"prompt_len": len(prompt)})
        r["token_ids"] += full[:k]
        legs.append((k, r))
    port, ref = engines(np_params)
    p, _ = run(port, [r for _, r in legs])
    j, _ = run(ref, [r for _, r in legs])
    assert_same(p, j)
    for (k, _), s in zip(legs, p):
        assert full[:k] + s[0] == full


class _FakeFsm:
    """tests/test_engine_grammar.py's linear token FSM with a branch point."""

    def __init__(self, chain, branch_at=None, branch_tok=None):
        self.chain, self.branch_at, self.branch_tok = list(chain), branch_at, branch_tok

    def step(self, state, tok):
        if state < len(self.chain) and tok == self.chain[state]:
            return state + 1
        if state == self.branch_at and tok == self.branch_tok:
            return state + 1
        return None

    def forced(self, state):
        if state == self.branch_at or state >= len(self.chain):
            return None
        return self.chain[state]


DRAFT_CASES = {
    "chain_truncates_and_fast_forwards": ("chain", [10, 99, 98], [10, 11, 12, 13], None, 4),
    "chain_empty_draft_forced": ("chain", [], [10, 11, 12, 13], None, 3),
    "tree_prunes_to_legal": ("tree", [7, 20, 7, 21, 7], [21, 30], 0, 4),
    "tree_forced_without_signal": ("tree", [1, 2, 3, 4], [40, 41, 42], None, 3),
}


@pytest.mark.parametrize("name", sorted(DRAFT_CASES))
def test_constrained_drafts_equal_the_jax_drafter(name):
    kind, hist, chain, branch_at, budget = DRAFT_CASES[name]
    out = []
    for mod in (td, jd):
        fsm = _FakeFsm(chain, branch_at, 99 if branch_at is not None else None)
        c = mod.DraftConstraint(0, fsm.step, fsm.forced)
        if kind == "chain":
            out.append(mod.constrain_chain(list(hist), c, budget))
        else:
            drafter = mod.TreeDrafter(n=1 if branch_at is not None else 3, width=2, depth=4)
            tree = drafter.draft_tree(hist, drafter.new_state(), budget=budget, constraint=c)
            out.append((tree.tokens, tree.parents))
    assert out[0] == out[1]
    if name == "tree_prunes_to_legal":
        assert 20 not in out[0][0] and out[0][0][:2] == [21, 30]


def test_drafts_under_a_compiled_schema_equal_the_jax_drafter():
    """Tree drafts constrained by the compiled schema's FSM from states
    along a JSON prefix: the same trees from both drafters."""
    g = build_compiler(None, 260).compile(RF)
    hist = list(b'{"name": "ab", "age": 1, "active": true}{"name": "') + [0]
    for cut in (1, 2, 10, 12, 22, 24):
        st = g.start
        for t in hist[:cut]:
            st = g.advance(st, t)
        trees = []
        for mod in (td, jd):
            drafter = mod.TreeDrafter(n=1, width=2, depth=6)
            c = mod.DraftConstraint(st, g.advance, g.forced)
            t = drafter.draft_tree(hist[:cut], drafter.new_state(), budget=8, constraint=c)
            trees.append((t.tokens, t.parents))
        assert trees[0] == trees[1]
        assert all(g.advance(st, tok) is not None for tok in trees[0][0][:1])


def _series(text_: str, name: str) -> float:
    for line in text_.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} not in the exposition")


def test_grammar_gauges_on_both_registries(np_params):
    port, ref = engines(np_params)
    regs = (MetricsRegistry(), JRegistry())
    run(port, reqs_mixed()[:1], regs[0])
    run(ref, reqs_mixed()[:1], regs[1])
    for reg, eng in zip(regs, (port, ref)):
        exp = reg.render()
        assert _series(exp, "dynamo_tpu_engine_grammar_active_seqs") == 0.0
        assert _series(exp, "dynamo_tpu_engine_grammar_mask_seconds") > 0.0
        assert eng.total_grammar_mask_s > 0.0
    help_lines = [sorted(ln for ln in reg.render().splitlines()
                         if ln.startswith("# HELP dynamo_tpu_engine_grammar")) for reg in regs]
    assert help_lines[0] == help_lines[1] and len(help_lines[0]) == 2
