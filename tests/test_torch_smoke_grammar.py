"""chip_smoke.py's phase 12 (structured output and embeddings) rehearsed on
the CPU, at test-tiny in float32.

- ``chip_smoke.grammar_phase`` (12a) through ``run``'s pipeline: the dense,
  tree and repeated dense bursts of 8 constrained chats and their checks
  (stop, schema-valid, FSM-legal, the repeat identical, tree greedy
  streams within the gap rule, tree passes only, the launch formula, which
  counts 0 here because the plain attention runs), then
  ``grammar_timing``'s masked step and masked tree pass, graph against
  op by op (op by op against op by op here), and the in-process
  embeddings that 12b holds the worker to.
- ``chip_smoke.grammar_http_phase`` (12b) with ``--device cpu``: store,
  worker and kv frontend spawned; the two chats equal 12a's dense
  responses, json_object, the unsupported schema's 400, /v1/responses and
  /v1/embeddings bit-equal to 12a's in-process vectors; exit codes 0.
- ``chip_smoke.grammar_lift_phase`` (12c) over a small tokenizer.json.
- The phase's own checks refuse bad streams: an illegal token, EOS before
  the structure closes, a stream without EOS, an object off the schema, a
  tree stream that leaves the dense one where the legal tokens are far
  apart either way round, and embeddings off the plain float32 forward
  (a dropped causal mask, padding in the mean).
"""

from __future__ import annotations

import asyncio
import json
import os

import pytest
import torch

import chip_smoke as C
from dynamo_tpu_torch.engine.grammar import build_compiler


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread here and in every process 12b spawns: float32 sums then
    do not depend on the host's load, and 12b holds the worker's logprobs
    to the in-process ones bit for bit (tests/test_torch_smoke_disagg.py)."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def phase12a():
    """12a on the CPU; the graph-vs-eager helpers synchronize the card,
    which is a no-op here."""
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    try:
        yield asyncio.run(C.grammar_phase("CPU", preset="test-tiny", device="cpu",
                                          dtype="float32"))
    finally:
        mp.undo()


def test_grammar_phase_on_the_cpu(phase12a):
    res, ref = phase12a
    for name in ("dense", "tree", "dense_repeat"):
        st = res[name]
        assert st["attention_launches"] == 0 and st["int8_launches"] == 0
        assert max(st["completion_tokens"]) < C.GRAMMAR_TOKENS
        assert st["mask_s"] > 0.0
    assert res["dense"]["verify_passes"] == 0 and res["dense"]["single_steps"] > 0
    assert res["tree"]["verify_passes"] > 0 and res["tree"]["accepted"] > 0
    assert res["compile_s"]["cached"] < res["compile_s"]["cold"]
    assert res["timing"]["mask_bytes_step"] == 8 * ((512 + 31) // 32) * 4
    assert sorted(ref["chats"]) == sorted(C.GRAMMAR_HTTP)
    assert [len(ids) for ids in ref["embed_ids"]] == [n for _, n in C.EMBED_CUTS]
    assert all(len(v) == 128 for v in ref["embeddings"])
    assert all(e < 1e-5 for e in res["embed_f32"]["rel_err"])
    assert all(e >= C.EMBED_REL_TOL for e in res["embed_f32"]["no_causal_mask"])
    assert res["tree"]["verify_attention_launches"] == 0


def test_grammar_http_phase_on_the_cpu(phase12a):
    _res, ref = phase12a
    out = C.grammar_http_phase("CPU", ref, preset="test-tiny", device="cpu", dtype="float32")
    assert set(out["exit_codes"].values()) == {0}
    counters = out["counters"]
    assert counters["paged_attention_launches"] == 0 and counters["grammar_seqs"] >= 3


def test_grammar_lift_phase_on_the_cpu():
    out = C.grammar_lift_phase("CPU", vocab=1256, n_bpe=1000)
    assert out["lifted_states"] == C.GRAMMAR_LIFT_STATES
    assert out["vocab_tokens"] > 900 and out["lift_s_per_state"] > 0.0


GOOD = b'{"kind": "cat", "v": 1, "ok": true, "n": 12, "tag": "ab"}'


@pytest.mark.parametrize("case", ["illegal_token", "early_eos", "no_eos", "valid"])
def test_fsm_legal_refuses_bad_streams(case):
    g = build_compiler(None, 512).compile(C.GRAMMAR_RF)
    toks = {"illegal_token": list(b'{"kind": "cow"'),
            "early_eos": list(b'{"kind": "cat"') + [257],
            "no_eos": list(GOOD),
            "valid": list(GOOD) + [257]}[case]
    if case == "valid":
        C.fsm_legal(g, toks, {257})
        assert C.grammar_valid(GOOD.decode())["n"] == 12
    else:
        with pytest.raises(RuntimeError, match="grammar"):
            C.fsm_legal(g, toks, {257})


@pytest.mark.parametrize("obj", [
    {"kind": "cat", "v": 1, "ok": True, "n": 1.5, "tag": ""},
    {"kind": "cat", "v": 2, "ok": True, "n": 1, "tag": ""},
    {"kind": "cat", "v": 1, "ok": 1, "n": 1, "tag": ""},
    {"kind": "cat", "v": 1, "ok": True, "n": 1, "tag": "123456789"},
    {"v": 1, "kind": "cat", "ok": True, "n": 1, "tag": ""},
])
def test_grammar_valid_refuses_objects_off_the_schema(obj):
    with pytest.raises(RuntimeError, match="does not validate"):
        C.grammar_valid(json.dumps(obj))


def _stream(tokens, logprobs):
    return {"tokens": tokens, "logprobs": logprobs}


@pytest.mark.parametrize("gap,ok", [(0.1, True), (-0.1, True), (0.3, False), (-0.3, False)])
def test_tree_vs_dense_gaps_holds_the_gap_both_ways(gap, ok):
    dense = [_stream([1, 2, 3], [-0.5, -1.0, -0.2])]
    tree = [_stream([1, 4, 3], [-0.5, -1.0 - gap, -0.2])]
    if ok:
        assert C.tree_vs_dense_gaps(dense, tree, [0], "t") == [pytest.approx(gap)]
    else:
        with pytest.raises(RuntimeError, match="nats"):
            C.tree_vs_dense_gaps(dense, tree, [0], "t")
    with pytest.raises(RuntimeError, match="prefix"):
        C.tree_vs_dense_gaps(dense, [_stream([1, 2], [-0.5, -1.0])], [0], "t")


@pytest.mark.parametrize("fault", ["none", "no_causal_mask", "padding_in_the_mean"])
def test_embed_against_f32_sees_faults(fault):
    import numpy as np

    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
    from dynamo_tpu_torch.engine.runner import LocalRunner

    cfg = ModelConfig()
    runner = LocalRunner(EngineArgs(model=cfg, block_size=16, num_kv_blocks=16, max_num_seqs=2,
                                    max_model_len=128, dtype="float32", device="cpu"), seed=0)
    runner.start()
    ids = list(range(5, 45))
    toks = np.zeros((48,), np.int32)
    toks[:40] = ids
    vec = runner.embed(toks, 40)
    if fault == "no_causal_mask":
        vec = C.embed_f32_reference(cfg, runner.params, ids, causal=False)
    elif fault == "padding_in_the_mean":
        vec = vec * 40 / 48
    if fault == "none":
        out = C.embed_against_f32(cfg, runner.params, [ids], [vec.numpy()], 2048, 16, "t")
        assert out["rel_err"][0] < 1e-5 and out["no_causal_mask"][0] >= C.EMBED_REL_TOL
        assert out["padded_mean"][0] == pytest.approx(8 / 48, rel=1e-4)
        # chunk pooling: the same ids pooled over 16-token chunks
        chunks = [ids[i : i + 16] for i in range(0, 40, 16)]
        pooled = sum(C.embed_f32_reference(cfg, runner.params, c) * len(c) for c in chunks) / 40
        out = C.embed_against_f32(cfg, runner.params, [ids], [pooled.numpy()], 16, 16, "t")
        assert out["rel_err"][0] < 1e-6
    else:
        with pytest.raises(RuntimeError, match="float32 reference"):
            C.embed_against_f32(cfg, runner.params, [ids], [vec.numpy()], 2048, 16, "t")
