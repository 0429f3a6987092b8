"""chip_smoke.py's HTTP phase, rehearsed on the CPU.

The phase's own code (``chip_smoke.http_phase``) spawns the port's store
server, two workers and a kv-mode frontend with ``--device cpu`` at
test-tiny in float32, sends the main path's 8-request burst over raw
sockets (half SSE, half aggregate), two chat completions, one repeated
prompt and, after clearing the workers' caches, the burst again all
aggregated, and checks what it checks on the card: every response 200
with 64 tokens, streams ending in [DONE], every text equal to the
in-process burst's, every aggregate response's 64 token texts and
logprobs equal to the in-process burst's bit for bit, on both workers,
the repeated prompt routed to its prefix holder and equal
to the in-process prefix-hit pass, and every process exiting 0 on
SIGTERM. On the CPU the plain attention runs, so each worker's kernel
launch count must be 0.
"""

from __future__ import annotations

import asyncio
import time

import chip_smoke as C
from dynamo_tpu_torch.llm.protocols import CompletionRequest
from dynamo_tpu_torch.run.__main__ import build_pipeline, parse_args
from dynamo_tpu_torch.runtime.engine import Context

ARGV = ["--preset", "test-tiny", "--dtype", "float32", "--device", "cpu", *C.ENGINE_ARGV]


async def in_process_burst() -> dict:
    """The main path's burst in one process, then request 7 again on its
    cached prefix → chip_smoke's reference (``reference_entry`` of each)."""
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
        return {"burst": burst, "repeat": await one(7)}
    finally:
        await pipe.engine.stop()


def test_http_phase_on_the_cpu():
    reference = asyncio.run(in_process_burst())
    res = C.http_phase("CPU", reference, 1.0, preset="test-tiny", device="cpu", dtype="float32")
    assert res["launches"] == 0 and set(res["exit_codes"].values()) == {0}
    # two passes of 8 burst requests, 2 chats and the repeat: 64 tokens each
    assert sum(w["generated_tokens"] for w in res["workers"]) == 19 * C.BURST_TOKENS
    assert len(set(res["instances"])) == 2 and sum(res["cleared_blocks"].values()) > 0
    assert res["ttft_max_s"] >= res["ttft_p50_s"] > 0 and res["repeat_ttft_s"] > 0


def test_msgpack_frame_timing_round_trips():
    frames = C.msgpack_frame_us(reps=20)
    assert set(frames) == {"delta_8_tokens", "request_1536_tokens"}
    assert all(v["us"] > 0 and v["bytes"] > 0 for v in frames.values())
