"""chip_smoke.py's phase 4t (``tp_phase``) rehearsed on the CPU at
test-tiny in float32: the store and ``python -m dynamo_tpu_torch.worker
--tp 2`` (the leader spawns its follower; the ranks meet over gloo), phase
4's burst through the worker's endpoint, held against the same burst in
process at tp 1 (``burst_reference``) under the gap rule; the follower's
sampled-token digest equal to the leader's; launches 0 on both ranks (the
plain attention runs on the CPU); the collectives and their bytes per
substep exactly one forward's. tests/test_torch_smoke_tp_int8.py runs the
int8 leg. The card's checks (launches = layers x substeps, eager windows
counted, peak memory) need the card."""

from __future__ import annotations

import asyncio

import chip_smoke as C


def _check(st: dict, layers: int) -> None:
    assert st["backend"] == "tp 2 over gloo (CPU ranks)"
    assert st["launches"] == [0, 0] and st["substeps"] > 0
    greedy = [i for i, t in enumerate(C.BURST_TEMPS) if t == 0.0]
    assert len(st["greedy_equal"]) + len(st["gaps"]) == len(greedy)
    assert st["tokens_per_s"] > 0 and st["ms_per_substep"] > 0
    assert st["expected_per_substep"] == 2 * layers + 2
    # Past the prefills, a substep's collectives are one forward's.
    assert st["collectives_per_substep"] == st["expected_per_substep"]
    assert st["bytes_per_substep"] == st["expected_bytes_per_substep"]
    assert st["collectives"]["all_gather"] > 0 and st["collective_bytes"] > 0


def test_tp_phase_on_the_cpu():
    ref = asyncio.run(C.burst_reference(["--preset", "test-tiny"], device="cpu",
                                        dtype="float32"))
    _check(C.tp_phase("CPU", ref, preset="test-tiny", device="cpu", dtype="float32"), 2)
