"""Tree speculation in the port against the JAX package's, on the CPU.

Mirrors tests/test_engine_spec_tree.py with the port's ``TorchEngine``
beside ``TpuEngine`` (XLA attention), on the same numpy weights and
seeded requests, with the helpers and tolerances of
tests/test_torch_spec.py: token streams equal to the JAX engine's and to
the port's dense path, logprobs within 1e-4 (a tree pass is always a
fused forward), spec counters equal to the JAX engine's in unpipelined
runs.

Workloads: the reference suite's branchy prompts dispatch no branched
pass with this model and seed (the reference's own
``test_tree_branched_pass_dispatches`` fails on them), so the suite here
runs the branchy and loopy prompts of both reference files together at
48 tokens each (``TREE_PROMPTS``), where the JAX engine dispatches
branched passes, and asserts that both engines dispatched the same number
of them, more than 0.
"""

from __future__ import annotations

import numpy as np
import pytest

from dynamo_tpu.engine.drafter import TreeDrafter as JTreeDrafter
from dynamo_tpu_torch.engine.drafter import NgramDrafter, TreeDrafter, build_drafter
from dynamo_tpu_torch.engine.config import EngineArgs
from test_torch_spec import (  # noqa: F401 — module fixtures used by name
    _one_torch_thread,
    assert_streams_close,
    jax_engine,
    np_params,
    port_engine,
    request,
    run,
    spec_kw,
    tokens_only,
)

BRANCHY = ([3, 5, 3, 7] * 5, [10, 20, 10, 30] * 5, [9, 2, 9, 4] * 5)
LOOPY = ([1, 2, 3] * 6, [7, 8, 9, 4] * 4, [5, 6] * 8)
TREE_PROMPTS = BRANCHY + LOOPY


def tree_kw(S: int, width: int = 2, depth: int = 0, pipeline: int = 0, gate: float = 0.0,
            **kw) -> dict:
    """A tree-drafting engine (the reference suite's spec_ngram=1)."""
    return spec_kw(S, pipeline, gate, fused=True, spec_ngram=1, spec_tree_width=width,
                   spec_tree_depth=depth, **kw)


def workload(max_tokens: int = 48, **sampling):
    return [request(p, max_tokens, seed=i, **sampling) for i, p in enumerate(TREE_PROMPTS)]


def check_tree(np_params, reqs, S, width=2, depth=0, counters=True, **kw):
    """Port tree speculation against the JAX engine's (streams; counters
    when ``counters``) and against the port's dense tokens. → (port
    streams, port counters)."""
    port, ps = run(port_engine(np_params, **tree_kw(S, width, depth, **kw)), reqs())
    ref, js = run(jax_engine(np_params, **tree_kw(S, width, depth, **kw)), reqs())
    dense, _ = run(port_engine(np_params, **spec_kw(0, **{k: v for k, v in kw.items()
                                                          if k == "kv_quant"})), reqs())
    assert_streams_close(port, ref)
    assert_streams_close(port, dense)
    if counters:
        assert ps == js
    assert ps["emitted"] == ps["rows"] + ps["accepted"]
    assert ps["accepted"] <= ps["proposed"]
    return port, ps


@pytest.mark.parametrize("width,depth", [(1, 2), (2, 1), (2, 4), (4, 2), (4, 4)])
def test_tree_greedy_matches_tpu_engine(np_params, width, depth):
    _, stats = check_tree(np_params, workload, 8, width, depth)
    assert stats["rows"] > 0 and stats["accepted"] > 0


def test_tree_branched_pass_dispatches(np_params):
    """The suite's guard against drafts that always collapse to chains:
    on TREE_PROMPTS both engines dispatch the same branched passes, more
    than 0, through the kernel's tree mode (the plain version here)."""
    _, stats = check_tree(np_params, workload, 8, 2, 4)
    assert stats["tree_passes"] > 0


def test_tree_width1_is_linear_path(np_params):
    """Width 1 builds the linear drafter: no branched pass, the streams of
    a width-2 engine."""
    assert type(build_drafter(EngineArgs(device="cpu", **tree_kw(8, width=1)))) is NgramDrafter
    lin, ls = check_tree(np_params, workload, 8, width=1)
    tree, ts = run(port_engine(np_params, **tree_kw(8, width=2, depth=8)), workload())
    assert ls["tree_passes"] == 0 and ts["tree_passes"] > 0
    assert tokens_only(lin) == tokens_only(tree)


def test_tree_stop_token_mid_branch(np_params):
    dense, _ = run(port_engine(np_params, **spec_kw(0)), [request(BRANCHY[0], 24, seed=3)])
    toks = dense[0][0]
    assert len(toks) == 24
    eos = toks[13]
    port, _ = check_tree(np_params, lambda: [request(BRANCHY[0], 24, seed=3, eos=(eos,))],
                         8, 2, 4)
    assert port[0][3] == "stop" and port[0][0][-1] == eos and len(port[0][0]) < 24


@pytest.mark.parametrize("max_tokens", [1, 2, 3, 5, 7, 13])
def test_tree_max_tokens_inside_accepted_run(np_params, max_tokens):
    port, _ = check_tree(np_params, lambda: workload(max_tokens), 8, 2, 4)
    assert all(len(s[0]) == max_tokens and s[3] == "length" for s in port)


def test_tree_preemption_golden(np_params):
    """Recompute preemption while tree passes run: tokens equal to the
    dense path's and the JAX engine's (logprobs within TOL: a preempted
    row re-prefills at a point that differs between engines)."""
    def reqs():
        return [request(BRANCHY[0][:4], 20, seed=1, logprobs=True),
                request(LOOPY[1][:4], 20, seed=2, logprobs=True)]

    kw = dict(max_num_seqs=2, num_kv_blocks=10, max_model_len=64)
    dense, _ = run(port_engine(np_params, **spec_kw(0), **kw), reqs())
    for width in (2, 4):
        eng = port_engine(np_params, **tree_kw(8, width, 4), **kw)
        port, stats = run(eng, reqs())
        ref, _ = run(jax_engine(np_params, **tree_kw(8, width, 4), **kw), reqs())
        assert_streams_close(port, dense)
        assert_streams_close(port, ref)
        assert stats["rows"] > 0 and eng.total_preemptions > 0


@pytest.mark.parametrize("pipeline", [1, 2])
def test_tree_composes_with_pipeline(np_params, pipeline):
    port, stats = run(port_engine(np_params, **tree_kw(8, 2, 4, pipeline)), workload())
    ref, _ = run(jax_engine(np_params, **tree_kw(8, 2, 4, pipeline)), workload())
    dense, _ = run(port_engine(np_params, **spec_kw(0)), workload())
    assert_streams_close(port, dense)
    assert_streams_close(port, ref)
    assert stats["rows"] > 0


def test_tree_sampled_rows(np_params):
    """Seeded sampled rows through tree passes: the JAX engine's tokens and
    counters (multi-round rejection draws from its threefry bits); a repeat
    gives the same streams; a never-drafting row rides the dense noise; a
    greedy row in the batch keeps the dense greedy tokens."""
    def reqs():
        return [
            request([37, 11, 29, 5, 17, 2, 23, 41], 15, temperature=0.9, seed=11),
            request(BRANCHY[0], 15, temperature=0.7, seed=12, logprobs=True),
            request(BRANCHY[1], 15, seed=13),
            request(LOOPY[0], 15, temperature=1.2, seed=14),
        ]

    port, stats = run(port_engine(np_params, **tree_kw(8, 2, 4)), reqs())
    again, _ = run(port_engine(np_params, **tree_kw(8, 2, 4)), reqs())
    ref, jstats = run(jax_engine(np_params, **tree_kw(8, 2, 4)), reqs())
    dense, _ = run(port_engine(np_params, **spec_kw(0)), reqs())
    assert port == again
    assert_streams_close(port, ref)
    assert stats == jstats and stats["proposed"] > 0
    assert tokens_only([port[0]]) == tokens_only([dense[0]])
    assert tokens_only([port[2]]) == tokens_only([dense[2]])
    assert all(len(s[0]) == 15 and s[3] == "length" for s in port)


def test_tree_int8_kv_golden(np_params):
    """Tree passes over int8 pages: the compaction moves pages and their
    scales, so the streams are the int8 dense path's and the JAX engine's."""
    _, stats = check_tree(np_params, workload, 8, 2, 4, kv_quant="int8")
    assert stats["rows"] > 0 and stats["tree_passes"] > 0


def test_tree_gate_disables_speculation(np_params):
    gated, stats = run(port_engine(np_params, **tree_kw(8, 2, 4, gate=1e9)), workload())
    _, jstats = run(jax_engine(np_params, **tree_kw(8, 2, 4, gate=1e9)), workload())
    dense, _ = run(port_engine(np_params, **spec_kw(0)), workload())
    assert gated == dense
    assert stats["rows"] == 0 and jstats["rows"] == 0


@pytest.mark.parametrize("adaptive", [True, False])
def test_tree_draft_budget_and_depth_caps(np_params, adaptive):
    """Node budgets and depth caps: the port's drafter (a copy of the JAX
    file) drafts the JAX drafter's trees on the same histories and caps;
    and under uniform and adaptive batch budgets with a depth cap the
    engines make the same passes."""
    rng = np.random.default_rng(7)
    for trial in range(40):
        n, width, depth = int(rng.integers(1, 4)), int(rng.integers(1, 5)), int(rng.integers(1, 5))
        port, ref = TreeDrafter(n, width, depth), JTreeDrafter(n, width, depth)
        ps, js = port.new_state(), ref.new_state()
        hist = [int(t) for t in rng.integers(0, 6, int(rng.integers(4, 40)))]
        budget = int(rng.integers(1, 10))
        pt, jt = port.draft_tree(hist, ps, budget), ref.draft_tree(hist, js, budget)
        assert (pt.tokens, pt.parents) == (jt.tokens, jt.parents), trial
        assert len(pt) <= budget and (len(pt) == 0 or pt.max_depth <= depth)
    port_eng = port_engine(np_params, **tree_kw(4, 2, 3, spec_budget_adaptive=adaptive))
    jax_eng = jax_engine(np_params, **tree_kw(4, 2, 3, spec_budget_adaptive=adaptive))
    port_out, stats = run(port_eng, workload())
    ref_out, jstats = run(jax_eng, workload())
    assert_streams_close(port_out, ref_out)
    assert stats == jstats
    assert port_eng.total_spec_budget_reallocs == jax_eng.total_spec_budget_reallocs
