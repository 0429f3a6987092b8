"""chip_smoke.py's disaggregated phase (phase 11), rehearsed on the CPU.

The phase's own code (``chip_smoke.disagg_phase``) spawns the port's store
server, one ``--is-prefill-worker`` and one default worker (``--disagg
auto``, ``--max-local-prefill-length 512``) with ``--device cpu`` at
test-tiny in float32, and a kv-mode frontend; it sends the main path's
8-request burst as aggregate completions and checks what it checks on the
card: the 768-1536-token prompts (and only they) prefill remotely, their
KV pages streamed to the decode worker and injected; every remote
response equals the in-process engine's pass of the same request on its
cached prefix (token texts and logprobs, bit for bit) and every local one
the cold in-process burst; each transfer moves (prompt - 1) // 16 blocks;
the prefill worker never decodes; the longest prompt sent again alone, from
an empty cache, goes remote and equals its reference too; after a prefill
worker that cuts every
transfer replaces it, the rerun request falls back to a local prefill
(``disagg_fallback_total{reason="transfer"}`` 1) and returns the cold
stream; every process exits 0 on SIGTERM. On the CPU the plain versions
run, so every launch count must be 0.
"""

from __future__ import annotations

import asyncio
import os
import time

import pytest
import torch

import chip_smoke as C
from dynamo_tpu_torch.llm.protocols import CompletionRequest
from dynamo_tpu_torch.run.__main__ import build_pipeline, parse_args
from dynamo_tpu_torch.runtime.engine import Context

ARGV = ["--preset", "test-tiny", "--dtype", "float32", "--device", "cpu", *C.ENGINE_ARGV]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_everywhere():
    """One intra-op thread in this process and in every process the phase
    spawns (they inherit the environment): float32 sums then round the
    same way in the reference and in the workers whatever else the host
    runs, and the phase adds little load beside other tests."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


async def in_process_reference() -> dict:
    """The burst in one process, then the remote requests again on their
    cached prefixes → chip_smoke's reference ("burst", "repeats")."""
    pipe = await build_pipeline(parse_args(["--in", "batch:-", *ARGV]))
    prompts = C.burst_prompts()

    async def one(i):
        req = CompletionRequest.parse({
            "model": pipe.card.name, "prompt": prompts[i], "max_tokens": C.BURST_TOKENS,
            "temperature": C.BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True,
            "logprobs": 0})
        gen, t0, ttft = None, time.perf_counter(), None
        async for g, _chunk in pipe.run(req, Context()):
            ttft = ttft if ttft is not None else time.perf_counter() - t0
            gen = g
        return C.reference_entry(gen, ttft)

    try:
        burst = list(await asyncio.gather(*(one(i) for i in range(8))))
        return {"burst": burst, "repeats": {i: await one(i) for i in C.REMOTE}}
    finally:
        await pipe.engine.stop()


def test_remote_requests_are_the_burst_past_the_threshold():
    assert [C.BURST_LENS[i] for i in C.REMOTE] == [768, 1024, 1280, 1536]
    assert [C.suffix_len(C.BURST_LENS[i]) for i in C.REMOTE] == [16, 16, 16, 16]
    assert C.CHAOS_REQUEST == 7


def test_disagg_phase_on_the_cpu():
    reference = asyncio.run(in_process_reference())
    res = C.disagg_phase("CPU", reference, ("in process", [r["ttft_s"] for r in reference["burst"]]),
                         preset="test-tiny", device="cpu", dtype="float32")
    assert res["launches"] == (0, 0, 0) and res["prefill_launches"] == (0, 0, 0)
    assert set(res["exit_codes"].values()) == {0} and len(res["exit_codes"]) == 5
    assert [t["prompt_tokens"] for t in res["transfers"]] == [768, 1024, 1280, 1536]
    assert all(t["chunks"] >= 1 and t["mb_per_s"] > 0 for t in res["transfers"])
    assert res["chaos"]["fallback_reasons"] == {"transfer": 1}
    assert res["alone"]["prompt_tokens"] == 1536 and res["alone"]["ttft_s"] > 0
    # the burst (8 x 64), request 7 alone and the chaos rerun, all decoded on
    # the decode worker
    assert res["final_counters"]["generated_tokens"] == 10 * C.BURST_TOKENS
    assert res["inject_bytes"] == sum(t["bytes"] for t in res["transfers"])


def test_kv_wire_timing_round_trips():
    wire = C.kv_wire_timing(n_blocks=2, reps=1)
    assert wire["bytes"] == 2 * 32 * 2 * 16 * 1024 * 2 and wire["frames"] == 3
    assert all(wire[k] > 0 for k in ("memcpy_s", "pack_s", "unpack_s", "to_wire_s", "runtime_s"))
