"""The KV tiers' device side and the int8 tied head, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
neither jax nor dynamo_tpu, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tiers_cuda.py

- A ``TorchEngine`` with a G2 tier serves prompts, forgets them in G1
  (clear_kv_blocks) and serves them again: every full prompt block is
  onboarded from G2, the onboarded pages read back from the cache
  bit-equal to the stored ones, and the streams equal the engine's own
  G1-hit run (bf16 pages and int8 pages).
- A flush never waits for the card: with a long kernel in flight,
  ``_flush_offloads`` enqueues the page gather and its copy and returns;
  the blocks reach G2 once the copy has landed.
- The tied head (the int8 embedding used as emb.T) against its plain
  version at llama-1b's and llama-3b's head shapes within ``TOL_INT8``,
  repeats bit-identical.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest
import torch

from chip_smoke import TIED_HEADS, int8_check, int8_tied_case
from dynamo_tpu_torch.engine import kv_transfer
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.ops import int8_matmul as im
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tokens import compute_block_hashes

pytestmark = pytest.mark.cuda

BS = 16
PROMPTS = [np.random.default_rng(s).integers(1, 500, size=n).tolist()
           for s, n in ((1, 70), (2, 129), (3, 200))]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def engine(kv_quant: str, host_blocks: int = 64) -> TorchEngine:
    return TorchEngine(EngineArgs(model=ModelConfig(), block_size=BS, num_kv_blocks=128,
                                  max_num_seqs=4, max_model_len=512, decode_steps=8,
                                  dtype="bfloat16", kv_quant=kv_quant, device="cuda",
                                  host_kv_blocks=host_blocks), seed=5)


async def serve(eng, prompts) -> list[list[int]]:
    async def one(p):
        toks = []
        async for item in eng.generate({"model": "t", "token_ids": p,
                                        "sampling": {"temperature": 0.0, "seed": 0},
                                        "stop": {"max_tokens": 16, "ignore_eos": True}},
                                       Context()):
            toks += item.get("token_ids") or []
        return toks

    out = [await one(p) for p in prompts]
    while eng.busy():
        await asyncio.sleep(0.001)
    await eng.run_on_engine_thread(lambda: None)
    return out


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_onboarded_pages_are_the_stored_pages(dev, kv_quant):
    async def go():
        eng = await engine(kv_quant).start()
        try:
            await serve(eng, PROMPTS)
            hit = await serve(eng, PROMPTS)  # the G1-hit run
            eng.clear_kv_blocks()
            before = eng.tiers.onboarded_blocks
            again = await serve(eng, PROMPTS)
            assert again == hit
            full = sum((len(p) - 1) // BS for p in PROMPTS)
            assert eng.tiers.onboarded_blocks - before == full
            for p in PROMPTS:
                hashes = compute_block_hashes(p, BS)[: (len(p) - 1) // BS]
                ids = eng.pool.match_prefix(hashes)
                got = eng.runner.extract_pages(ids)
                want = kv_transfer.concat_page_run(eng.tiers.read_run(hashes),
                                                   quantized=kv_quant == "int8",
                                                   num_kv_heads=eng.cfg.num_kv_heads,
                                                   dtype="bfloat16")
                assert len(ids) == len(hashes) and len(got) == len(want)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            assert eng.runner.eager_windows == 0
        finally:
            await eng.stop()

    asyncio.run(go())


def test_flush_does_not_wait_for_the_card(dev):
    async def go():
        eng = await engine("none").start()
        try:
            await serve(eng, PROMPTS[:1])
            ids = eng.pool.match_prefix(compute_block_hashes(PROMPTS[0], BS)[:4])
            assert len(ids) == 4

            def flush_behind_a_long_kernel():
                eng.tiers.host.clear()
                eng._offload_pending = [(b, 1000 + i) for i, b in enumerate(ids)]
                torch.cuda._sleep(2_000_000_000)  # ~1 s of spinning on the stream
                t0 = time.perf_counter()
                eng._flush_offloads()
                secs = time.perf_counter() - t0
                queued = len(eng._offload_fetches)
                torch.cuda.synchronize()
                eng._flush_offloads()  # lands what the first one enqueued
                return secs, queued

            secs, queued = await eng.run_on_engine_thread(flush_behind_a_long_kernel)
            assert secs < 0.2 and queued == 1
            assert all(eng.tiers.host.contains(1000 + i) for i in range(4))
            assert not eng._offload_fetches and not eng._offload_inflight
        finally:
            await eng.stop()

    asyncio.run(go())


@pytest.mark.parametrize("head", sorted(TIED_HEADS))
def test_tied_head_at_model_shapes(dev, head):
    K, N = TIED_HEADS[head]
    for M in (1, 8, 64):
        x, wt, s = int8_tied_case(M, K, N, "bfloat16", M, dev)
        t0 = im.tied_launches
        int8_check(x, wt, s, True, f"tied {head} M={M}")  # twice, bit-identical
        assert im.tied_launches == t0 + 2
