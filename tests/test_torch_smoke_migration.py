"""chip_smoke.py's live-migration phase (phase 14), rehearsed on the CPU.

The phase's own code (``chip_smoke.migration_phase``) runs at test-tiny
in float32 with ``--device cpu``: the store and three ``python -m
dynamo_tpu_torch.worker --autoscaler on`` processes; the reference pass on
A; C's chaos cell (``cutover:dest``: a typed fallback, every stream
bit-equal to the reference); four clean migrations A → B through
workerctl/admin; B's pool move to prefill relocating its streams to A,
back to decode; the injected pages against the source's; B's
retirement leaving no key; every process exiting 0. On the CPU the plain
versions run, so every launch count is 0.
"""

from __future__ import annotations

import os

import pytest
import torch

import chip_smoke as C


@pytest.fixture(autouse=True, scope="module")
def _one_thread_everywhere():
    """One intra-op thread here and in every spawned process, so float32
    sums round alike in every worker."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def test_requests():
    reqs = C.migration_requests("m")
    assert [len(r["token_ids"]) for r in reqs] == C.MIG_LENS
    assert [r["sampling"]["temperature"] for r in reqs] == C.MIG_TEMPS
    assert all(C.MIG_TEMPS[i] == 0.0 for i in C.MIG_ROWS + C.MIG_NEW)
    assert C.MIG_TEMPS[C.MIG_CHAOS_ROW] > 0.0
    assert not set(C.MIG_ROWS) & set(C.MIG_NEW)
    assert all(r["stop"]["max_tokens"] == C.MIG_TOKENS and r["sampling"]["top_logprobs"] == 2
               for r in reqs)
    assert max(C.MIG_LENS) + C.MIG_TOKENS <= 2048  # the phase's max_model_len


def _stream(tokens, gaps):
    return {"tokens": tokens, "logprobs": [-0.5] * len(tokens),
            "top": [[[t, -0.5], [t + 1, -0.5 - g]] for t, g in zip(tokens, gaps)]}


@pytest.mark.parametrize("case,ok", [
    ("equal", True), ("after_cut_small_gap", True), ("after_cut_large_gap", False),
    ("before_cut", False), ("short", False)])
def test_relocated_divergence_rule(case, ok):
    """Equal up to the cutover; afterwards a first difference is allowed
    only where the reference's top-2 gap is under SPEC_GAP_TOL."""
    ref = _stream(list(range(10)), [1.0] * 6 + [0.01] + [1.0] * 3)
    got = {
        "equal": _stream(list(range(10)), [0.0] * 10),
        "after_cut_small_gap": _stream(list(range(6)) + [99, 98, 97, 96], [0.0] * 10),
        "after_cut_large_gap": _stream(list(range(5)) + [99] * 5, [0.0] * 10),
        "before_cut": _stream([0, 1, 99] + list(range(3, 10)), [0.0] * 10),
        "short": _stream(list(range(9)), [0.0] * 9),
    }[case]
    if ok:
        d = C.relocated_divergence(got, ref, 4, "t")
        assert d == (None if case == "equal" else 6)
    else:
        with pytest.raises(RuntimeError):
            C.relocated_divergence(got, ref, 4, "t")


def test_migration_phase_on_the_cpu():
    # 384 tokens a stream keep the rehearsal short: test-tiny's pages are
    # small, so the pool move's relocations still find every row running.
    res = C.migration_phase("CPU", preset="test-tiny", device="cpu", dtype="float32",
                            max_tokens=384)
    assert sorted(res["migrations"]) == C.MIG_ROWS
    for m in res["migrations"].values():
        assert m["kv_blocks"] > 0 and m["kv_bytes"] > 0 and m["cutover_gap_s"] > 0
    assert set(res["stall_s"]) >= {f"mig-{i}" for i in C.MIG_ROWS}
    assert all(v is None for v in res["divergence"].values())  # float32: no prefill drift
    assert res["chaos_reason"] == "chaos:cutover:dest"
    assert res["relocated_by_pool_move"] >= 1 and res["pages_compared_bytes"] > 0
    assert res["pumps"]["a"] > 0 and res["pumps"]["b"] > 0
    assert res["launches"] == {"a": 0, "b": 0, "c": 0}
    assert all(v > 0 for v in res["substeps"].values())
    assert res["exit_codes"] == {"a": 0, "b": 0, "c": 0, "store": 0}
