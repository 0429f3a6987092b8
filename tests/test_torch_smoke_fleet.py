"""chip_smoke.py's phase 7b (the frontend fleet), rehearsed on the CPU.

The phase's own code runs: ``chip_smoke.http_phase(..., fleet=True)``
spawns the port's store server and two workers (``--kv-directory on``,
trace export) with ``--device cpu`` at test-tiny in float32, runs phase 7
through one kv-mode frontend, stops it, and then ``fleet_phase`` starts
``python -m dynamo_tpu_torch.frontend --fleet 2 --global-max-inflight 16``
over the same store and workers and checks, through the port's
``OpenAIClient``, everything it checks on the card: both children
registered on one port and serving, the burst's aggregate responses equal
to the in-process reference bit for bit, the streamed and aggregated chat
equal, the repeat on its prefix holder with cached blocks, every stitched
trace with a frontend and a worker lane and the three engine spans with
their attributes, the engine phases in the aggregated ledger, one
engine.decode span per request on each worker's /metrics, the directory's
blocks under the serving instance, and every exit code 0. On the CPU the
plain attention runs, so the launch counts are 0. One intra-op thread in
this process and in every process the phase spawns, as the other
rehearsals run, so float32 sums round the same way everywhere.
"""

from __future__ import annotations

import asyncio
import os

import pytest
import torch

import chip_smoke as C
from test_torch_smoke_http import in_process_burst


@pytest.fixture(autouse=True, scope="module")
def _one_thread_everywhere():
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def test_fleet_phase_on_the_cpu():
    reference = asyncio.run(in_process_burst())
    res = C.http_phase("CPU", reference, 1.0, preset="test-tiny", device="cpu",
                       dtype="float32", fleet=True)
    fleet = res["fleet"]
    assert set(res["exit_codes"]) == {"frontend", "fleet", "worker0", "worker1", "store"}
    assert set(res["exit_codes"].values()) == {0}
    assert res["launches"] == 0 and fleet["launches"] == 0
    # 8 burst completions, 2 chats and the repeat through the fleet, and a
    # further repeat for each time both children had not yet served; phase
    # 7's 19 requests before them: 64 tokens each.
    extra = fleet["extra_repeats"]
    assert 0 <= extra <= C.FLEET_EXTRA_REPEATS
    assert fleet["requests"] == 11 + extra
    assert sum(w["generated_tokens"] for w in res["workers"]) == (30 + extra) * C.BURST_TOKENS
    assert sum(w["engine_decode_spans"] for w in fleet["workers"].values()) == 30 + extra
    assert set(fleet["served_by_child"]) == {"0", "1"}
    assert fleet["cached_blocks_repeat"] > 0 and fleet["directory_blocks"] > 0
    assert fleet["ttft_max_s"] >= fleet["ttft_p50_s"] > 0
    tr = fleet["trace_us_per_request"]
    assert tr["requests"] == 30 + extra and tr["spans"] > 0 and tr["export_sink"] > 0


def test_fleet_phase_repeats_until_both_children_served(monkeypatch):
    """The kernel spreads the fleet's connections by a hash, so one child
    may serve none of the phase's 11 requests: the phase then sends
    further repeats of request 7 until both have served. Here the first
    two readings hide child 0, so two repeats more run and are held."""
    real, readings = C.served_by_child, []

    def child_0_hidden_twice(text: str) -> dict[str, float]:
        readings.append(text)
        served = real(text)
        return {"1": served.get("1", 0.0)} if len(readings) <= 2 else served

    monkeypatch.setattr(C, "served_by_child", child_0_hidden_twice)
    reference = asyncio.run(in_process_burst())
    res = C.http_phase("CPU", reference, 1.0, preset="test-tiny", device="cpu",
                       dtype="float32", fleet=True)
    fleet = res["fleet"]
    assert fleet["extra_repeats"] == 2 and fleet["requests"] == 13
    assert sum(w["engine_decode_spans"] for w in fleet["workers"].values()) == 32
    assert set(fleet["served_by_child"]) == {"0", "1"}
    assert len(fleet["ttft_s"]) == 8  # the burst's, not the repeats'


def test_span_record_timing_runs():
    assert C.span_record_us(reps=20) > 0
