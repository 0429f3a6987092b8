"""Speculative verify passes on the card: CUDA graphs against the eager pass,
the kernel's multi-query modes inside them, and the engine's streams.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
neither jax nor dynamo_tpu, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spec_cuda.py

- A verify pass (linear fused, stepwise, tree; S1 = 4 and 7; greedy and
  "simple") replayed as a CUDA graph equals the op-by-op pass bit for bit
  in every output, the KV pages it wrote (tree compaction included) and
  the chain buffer (chip_smoke's ``verify_inputs`` and
  ``verify_graph_vs_eager``); each replay adds its kernel calls to the
  counters: the layers' attention calls per forward, 1 forward for a fused
  pass and S1 for a stepwise one.
- ``TorchEngine`` speculating on the card: stepwise greedy streams equal
  the dense ones bit for bit, no verify pass runs eagerly, and a tree run
  dispatches branched passes.
"""

from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import verify_graph_vs_eager, verify_inputs
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.runtime.engine import Context

pytestmark = pytest.mark.cuda

GEOMETRIES = {
    "test-tiny-f32": (ModelConfig(), "float32", "none"),
    "test-tiny-bf16-int8kv": (ModelConfig(), "bfloat16", "int8"),
    "llama-8b-2layers": (dataclasses.replace(ModelConfig.preset("llama-8b"), num_layers=2),
                         "bfloat16", "none"),
}
LENS = [5, 17, 30, 44, 61, 80, 99, 120]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _runner(geometry: str) -> LocalRunner:
    cfg, dtype, kv_quant = GEOMETRIES[geometry]
    args = EngineArgs(model=cfg, block_size=16, num_kv_blocks=128, max_num_seqs=8,
                      max_model_len=512, decode_steps=8, dtype=dtype, kv_quant=kv_quant,
                      device="cuda", spec_tokens=3)
    runner = LocalRunner(args, seed=3)
    runner.start()
    return runner


@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("kind", ["linear", "stepwise", "tree"])
@pytest.mark.parametrize("S1", [4, 7])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_verify_graph_matches_eager(dev, geometry, S1, kind, mode):
    runner = _runner(geometry)
    runner.args.spec_fused = kind != "stepwise"
    kw = verify_inputs(runner, S1, "tree" if kind == "tree" else "linear", mode, lens=LENS)
    n_emit = verify_graph_vs_eager(runner, kw)
    assert runner.graphs.captured == 1 and runner.eager_verifies == 1
    if mode == "greedy":
        assert n_emit[0] == (S1 if kind != "tree" else {4: 3, 7: 4}[S1])
    layers = runner.cfg.num_layers
    before = pa.launches
    runner.spec_verify(**kw)
    forwards = S1 if kind == "stepwise" else 1
    assert pa.launches - before == layers * forwards
    assert runner.graphs.replays == 2


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_speculates_on_the_card(dev, kv_quant):
    # Prompts over a small alphabet, each token followed by several others:
    # a 1-gram context the model revisits has several continuations, so the
    # tree drafter branches.
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, 24, 40)] for _ in range(8)]

    def engine(**kw):
        args = EngineArgs(model=ModelConfig(), block_size=16, num_kv_blocks=128,
                          max_num_seqs=8, max_model_len=256, decode_steps=8, dtype="bfloat16",
                          kv_quant=kv_quant, device="cuda", spec_gate=0.0, **kw)
        return TorchEngine(args, seed=0)

    async def run(eng):
        async def one(p):
            toks, lps = [], []
            req = {"model": "t", "token_ids": p,
                   "sampling": {"temperature": 0.0, "seed": 1, "logprobs": True},
                   "stop": {"max_tokens": 64, "ignore_eos": True}}
            async for item in eng.generate(req, Context()):
                toks.extend(item.get("token_ids") or [])
                lps.extend(item.get("log_probs") or [])
            return toks, lps

        tasks = [asyncio.ensure_future(one(p)) for p in prompts]
        await asyncio.sleep(0)
        await eng.start()
        try:
            return await asyncio.gather(*tasks)
        finally:
            await eng.stop()

    dense = asyncio.run(run(engine()))
    step_eng = engine(spec_tokens=3, spec_fused=False)
    stepwise = asyncio.run(run(step_eng))
    assert [t for t, _ in stepwise] == [t for t, _ in dense]
    assert stepwise == dense
    assert step_eng.runner.verify_passes > 0 and step_eng.runner.eager_verifies == 0
    tree_eng = engine(spec_tokens=3, spec_tree_width=2, spec_tree_depth=3, spec_ngram=1)
    tree = asyncio.run(run(tree_eng))
    assert tree_eng.total_spec_tree_passes > 0 and tree_eng.runner.eager_verifies == 0
    assert all(len(t) == 64 for t, _ in tree)
