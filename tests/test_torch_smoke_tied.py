"""chip_smoke.py's phase 4d (``tied_phase``) rehearsed on the CPU at
test-tiny in float32, 8 tokens a request (32 on the card): test-tiny ties
its head to the int8 embedding, as llama-3b does, and an int8 engine of 128
sequences serves the 128 seeded requests at once, so that its decode runs
buckets 32 and 128 as it fills and drains. Every launch count is 0 here
(the plain versions run on the CPU); the card's checks (the head's x
through the tied entry, graph == eager, replay times) need the card.

Also ``int8_expected`` against the calls a tied int8 engine makes: its
layer products on their rows' routes, its head never on those routes but
on the tied entry, once per forward."""

from __future__ import annotations

import asyncio

import numpy as np
import torch

import chip_smoke as C
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.ops import int8_matmul as im


def _one_thread(fn):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


def test_tied_phase_on_the_cpu():
    res = _one_thread(lambda: asyncio.run(C.tied_phase("CPU", preset="test-tiny", device="cpu",
                                                       dtype="float32", max_tokens=8)))
    assert res["launches"] == (0, 0, 0, 0, 0) and res["model"] == "test-tiny"
    assert {32, C.TIED_SEQS} <= set(res["substeps_by_bucket"]) <= {8, 32, C.TIED_SEQS}
    assert res["substeps"] == sum(res["substeps_by_bucket"].values()) > 0
    chunks = C.prefill_chunk_buckets([r["len"] for r in C.tied_requests()])
    assert len(chunks) > C.TIED_SEQS  # the tail split cuts some prompts in two
    assert res["forwards"] == res["substeps"] + len(chunks)
    assert res["tokens_per_s"] > 0


def test_tied_requests_fit_the_phase():
    reqs = C.tied_requests()
    assert len(reqs) == C.TIED_SEQS and len(C.TIED_SAMPLED) == 8
    assert all(64 <= r["len"] <= 256 and len(r["prompt"]) == r["len"] for r in reqs)
    assert [r["temperature"] for r in reqs].count(0.7) == 8
    assert reqs == C.tied_requests()  # seeded
    # room for every row's prompt, its tokens and the pipeline's lookahead
    need = sum(-(-(r["len"] + C.TIED_TOKENS + C.LOOKAHEAD) // 16) for r in reqs)
    assert need <= C.TIED_KV_BLOCKS


def test_int8_expected_leaves_a_tied_head_to_its_entry(monkeypatch):
    routes = {"kernel": 0, "prefill": 0, "wide": 0, "tied_wide": 0, "tied": 0}
    real = im.int8_matmul

    def counting(x, w, scale, out_f32=False):
        routes[im.route(x, w)] += 1
        return real(x, w, scale, out_f32)

    monkeypatch.setattr(TM.im, "int8_matmul", counting)
    cfg = ModelConfig()
    assert cfg.tie_embeddings
    eng = TorchEngine(EngineArgs(model=cfg, device="cpu", quant="int8", dtype="bfloat16",
                                 block_size=16, num_kv_blocks=1024, max_num_seqs=32,
                                 max_model_len=2048, decode_steps=4))
    lens = [int(n) for n in np.random.default_rng(4).integers(8, 100, 20)]
    rng = np.random.default_rng(9)

    async def go():
        from test_torch_pipeline import run_stream

        await eng.start()
        try:
            await asyncio.gather(*(run_stream(eng, {
                "model": "t", "token_ids": [int(t) for t in rng.integers(1, 500, n)],
                "sampling": {"temperature": 0.0 if i % 3 else 0.7, "seed": 70 + i},
                "stop": {"max_tokens": 5 + i % 4, "ignore_eos": True}})
                for i, n in enumerate(lens)))
        finally:
            await eng.stop()

    _one_thread(lambda: asyncio.run(go()))
    by_bucket = dict(eng.decode_steps_by_bucket)
    want = C.int8_expected(cfg, lens, eng.total_decode_steps, buckets=by_bucket)
    assert (routes["kernel"], routes["prefill"], routes["wide"]) == want
    # bf16 x and a contiguous embedding: the wgmma entry, once per forward
    assert routes["tied_wide"] == eng.total_decode_steps + len(lens) and routes["tied"] == 0
