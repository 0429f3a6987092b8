"""chip_smoke.py's checkpoint phase and its int8 launch count, rehearsed on
the CPU.

- ``chip_smoke.checkpoint_phase`` at test-tiny widths in float32: the
  checkpoint written as two shards, loaded int8 (every leaf equal to
  ``quantize_params_np`` of the written arrays), served by a spawned
  ``worker --model-path --quant int8 --kv-quant int8 --tokenizer byte``
  behind the store and a kv-mode frontend, four aggregate completions
  bit-equal to the in-process engine on the same checkpoint, every
  process exiting 0 (the plain versions run: no launches).
- ``chip_smoke.int8_expected``, the count the card run holds the int8
  kernel's launches to, against the calls the engine really makes: the
  burst's eight prompts through ``TorchEngine`` at ``quant="int8"``, each
  int8 product classified by the wrapper's own shape rule
  (``int8_matmul.route``).
"""

from __future__ import annotations

import asyncio

import pytest
import torch

import chip_smoke as C
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.ops import int8_matmul as im


@pytest.mark.e2e
def test_checkpoint_phase_on_the_cpu():
    res = C.checkpoint_phase("CPU", preset="test-tiny", device="cpu", dtype="float32")
    assert res["launches"] == (0, 0, 0) and res["decode_substeps"] > 0
    assert res["name"] == "test-tiny-2layers" and len(res["latency_s"]) == C.CKPT_REQUESTS


def test_int8_expected_counts_the_engines_calls(monkeypatch):
    routes = {"kernel": 0, "prefill": 0}
    real = im.int8_matmul

    def counting(x, w, scale, out_f32=False):
        routes[im.route(x, w)] += 1
        return real(x, w, scale, out_f32)

    monkeypatch.setattr(TM.im, "int8_matmul", counting)
    cfg = ModelConfig(tie_embeddings=False)
    eng = TorchEngine(EngineArgs(model=cfg, device="cpu", quant="int8", dtype="float32",
                                 block_size=16, num_kv_blocks=512, max_num_seqs=8,
                                 max_model_len=2048, decode_steps=8))
    prompts = C.burst_prompts()

    async def go():
        from test_torch_pipeline import run_stream

        await eng.start()
        try:
            await asyncio.gather(*(run_stream(eng, {
                "model": "t", "token_ids": list(p.encode()),
                "sampling": {"temperature": t, "seed": 1000 + i},
                "stop": {"max_tokens": 16, "ignore_eos": True}})
                for i, (p, t) in enumerate(zip(prompts, C.BURST_TEMPS))))
        finally:
            await eng.stop()

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        asyncio.run(go())
    finally:
        torch.set_num_threads(n)
    want = C.int8_expected(cfg, C.BURST_LENS, eng.total_decode_steps)
    assert (routes["kernel"], routes["prefill"]) == want
    assert want[1] > 0  # both routes taken
