"""Prefill dispatches as CUDA graphs against the same dispatches op by op,
on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
neither jax nor dynamo_tpu, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prefill_cuda.py

- ``warm_prefills`` captures every shape of ``prefill_shapes`` (and each
  one's LoRA variant with an adapter bank); chip_smoke's
  ``prefill_graph_checks`` then holds each captured shape's replay to the
  eager run bit for bit (two waves back to back, logits and KV pages).
- A ``TorchEngine`` whose prefills are graph replays gives the streams of
  an ``enforce_eager`` engine bit for bit on a packed wave with tail-split
  prompts, with no eager prefill, while the eager engine counts every one.
"""

from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import prefill_graph_checks
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.runtime.engine import Context

pytestmark = pytest.mark.cuda

GEOMETRIES = {
    "test-tiny-f32": (ModelConfig(), "float32", "none", "none"),
    "test-tiny-bf16-int8kv": (ModelConfig(), "bfloat16", "none", "int8"),
    # llama-8b widths with 2 layers: int8 weights take the wide entry.
    "llama-8b-2layers-int8": (dataclasses.replace(ModelConfig.preset("llama-8b"), num_layers=2),
                              "bfloat16", "int8", "none"),
}
ARGS = dict(block_size=16, num_kv_blocks=256, max_num_seqs=8, max_model_len=512,
            max_prefill_tokens=256, decode_steps=8, device="cuda")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("rows", [1, 4])
def test_every_prefill_graph_equals_eager(dev, geometry, rows):
    cfg, dtype, quant, kv_quant = GEOMETRIES[geometry]
    args = EngineArgs(model=cfg, dtype=dtype, quant=quant, kv_quant=kv_quant,
                      prefill_batch_max=rows, lora_slots=2 if rows == 1 else 0, **ARGS)
    runner = LocalRunner(args, seed=3)
    runner.start()
    n = runner.warm_prefills()
    shapes = runner.prefill_shapes()
    assert n == len(shapes) * (2 if args.lora_slots else 1)
    assert {k[1:4] for k in runner.graphs.shapes if k[0] == "prefill"} == set(shapes)
    assert runner.warm_prefills() == 0  # all captured once
    st = prefill_graph_checks(runner, geometry, "test")
    assert st["shapes"] == len(shapes)
    assert runner.eager_prefills == 2 * len(shapes)  # the checks' eager runs
    runner.stop()


def test_graph_engine_streams_equal_an_eager_engine(dev):
    rng = np.random.default_rng(9)
    reqs = [{"model": "t", "token_ids": rng.integers(1, 500, n).tolist(),
             "sampling": {"temperature": 0.0 if i % 2 else 0.8, "seed": i, "logprobs": True},
             "stop": {"max_tokens": 12, "ignore_eos": True}}
            for i, n in enumerate((5, 20, 40, 70, 33, 100, 300, 150))]

    async def run(eager: bool):
        eng = TorchEngine(EngineArgs(model=ModelConfig(), dtype="bfloat16", prefill_batch_max=4,
                                     enforce_eager=eager, **ARGS), seed=5)
        outs = []

        async def one(r):
            toks, lps = [], []
            async for item in eng.generate(r, Context()):
                toks += item.get("token_ids") or []
                lps += item.get("log_probs") or []
            return toks, lps

        tasks = [asyncio.ensure_future(one(r)) for r in reqs]
        await asyncio.sleep(0)
        await eng.start()
        try:
            outs = await asyncio.gather(*tasks)
        finally:
            await eng.stop()
        return outs, eng.runner.eager_prefills, eng.runner.eager_windows

    got, eager_pre, eager_win = asyncio.run(run(False))
    want, want_pre, want_win = asyncio.run(run(True))
    assert got == want
    assert (eager_pre, eager_win) == (0, 0)
    # 5, 20 → one pack at T 32; 40, 33 → one at T 48; 70, 100 alone; 300 →
    # chunks of 256 and 44; 150 → the tail split's 128 and 22: 8 dispatches.
    assert want_pre == 8 and want_win > 0
