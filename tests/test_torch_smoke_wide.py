"""chip_smoke.py's phase 4c (``wide_phase``) rehearsed on the CPU at
test-tiny in float32, 24 tokens a request (64 on the card): an int8
engine of 128 sequences on the weights of an 8-sequence one serves the
128 seeded requests at once, so that its decode runs buckets 32 and 128
(and 8 when the host's timing leaves a window to the last few rows) as
it fills and drains; every greedy stream is held against the 8-sequence
engine's under the top-2 gap rule. Every launch count is 0 here (the
plain versions run on the CPU)."""

from __future__ import annotations

import asyncio

import torch

import chip_smoke as C
from dynamo_tpu_torch.run.__main__ import parse_args


def test_wide_phase_on_the_cpu():
    async def go():
        args = parse_args(["--in", "batch:-", "--preset", "test-tiny", "--dtype", "float32",
                           "--device", "cpu", *C.ENGINE_ARGV])
        ref = await C.local_pipeline(args, quant="int8")
        try:
            return await C.wide_phase("CPU", ref, device="cpu", max_tokens=24)
        finally:
            await ref.engine.stop()

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = asyncio.run(go())
    finally:
        torch.set_num_threads(n)
    assert res["launches"] == (0, 0, 0, 0)
    # 32 and 128 run as the batch fills and drains; 8 only if the last
    # admissions fall in few enough windows (host timing)
    assert {32, C.WIDE_SEQS} <= set(res["substeps_by_bucket"]) <= {8, 32, C.WIDE_SEQS}
    assert res["substeps"] == sum(res["substeps_by_bucket"].values()) > 0
    assert len(C.wide_requests()) == C.WIDE_SEQS and len(C.WIDE_SAMPLED) == 8
    assert all(64 <= r["len"] <= 512 for r in C.wide_requests())
    assert res["tokens_per_s"] > 0 and res["divergences"] == len(res["gaps"])
