"""CUDA-graph decode windows against the eager window, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
neither jax nor dynamo_tpu, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py

The checks are chip_smoke.py's (``window_inputs``, ``graph_vs_eager``,
``chained_vs_drained``): a K=8 window over six live rows (prefilled, first
tokens sampled and folded into ``last_toks``, the window chained from the
folds) replayed as a CUDA graph and run op by op from copies of the same
device state must agree bit for bit in tokens, logprobs, top-n
alternatives, the KV pages it wrote and the chain buffer; and two windows
chained on the device (depth 2) must equal the same two windows with the
host feeding the second (depth 0).
"""

from __future__ import annotations

import asyncio
import dataclasses

import pytest
import torch

from chip_smoke import chained_vs_drained, graph_vs_eager, window_inputs
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.runtime.engine import Context

pytestmark = pytest.mark.cuda

GEOMETRIES = {
    "test-tiny-f32": (ModelConfig(), "float32", "none"),
    "test-tiny-bf16": (ModelConfig(), "bfloat16", "none"),
    "test-tiny-bf16-int8kv": (ModelConfig(), "bfloat16", "int8"),
    # llama-8b widths (vocabulary, hidden, heads, head_dim) with 2 layers.
    "llama-8b-2layers": (dataclasses.replace(ModelConfig.preset("llama-8b"), num_layers=2),
                         "bfloat16", "none"),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _runner(geometry: str) -> LocalRunner:
    cfg, dtype, kv_quant = GEOMETRIES[geometry]
    args = EngineArgs(model=cfg, block_size=16, num_kv_blocks=64, max_num_seqs=8,
                      max_model_len=512, decode_steps=8, dtype=dtype, kv_quant=kv_quant,
                      device="cuda")
    runner = LocalRunner(args, seed=3)
    runner.start()
    return runner


@pytest.mark.parametrize("mode", ["greedy", "simple", "full"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_graph_window_matches_eager(dev, geometry, mode):
    runner = _runner(geometry)
    graph_vs_eager(runner, window_inputs(runner, mode, 7))
    assert runner.graphs.captured == 1 and runner.graphs.replays == 1
    assert runner.eager_windows == 1  # the eager run asked for
    # A second window of the same shape replays the same graph.
    graph_vs_eager(runner, window_inputs(runner, mode, 8))
    assert runner.graphs.captured == 1 and runner.graphs.replays == 2
    assert runner.graphs.pool_bytes() > 0


@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_chained_windows_match_drained(dev, geometry, mode):
    runner = _runner(geometry)
    chained_vs_drained(runner, window_inputs(runner, mode, 9))
    assert runner.eager_windows == 0


def test_replays_count_attention_launches(dev):
    """The attention calls a graph holds are counted per replay; the warmup
    and the capture itself count nothing."""
    runner = _runner("test-tiny-f32")
    kw = window_inputs(runner, "simple", 11)
    before = pa.launches
    runner.multi_decode(**kw)
    runner.multi_decode(**kw)
    torch.cuda.synchronize()
    assert pa.launches - before == 2 * runner.cfg.num_layers * kw["K"]
    assert runner.graphs.replays == 2 and runner.eager_windows == 0


def test_engine_streams_equal_across_depths(dev):
    """TorchEngine on the card: concurrent greedy, sampled and full-sampler
    requests give the same token and logprob streams at pipeline depth 2
    (graph windows chained on the device; unpipelined while the
    full-sampler row runs) and depth 0, and no K-step window runs
    eagerly."""
    reqs = []
    for i, (temp, extra) in enumerate([(0.0, {}), (0.8, {}), (0.0, {}), (0.7, {}),
                                       (0.9, {"top_k": 7, "frequency_penalty": 0.5})]):
        reqs.append({
            "model": "test-tiny", "token_ids": [3 + i, 1, 4, 1, 5, 9, 2, 6][: 3 + i],
            "sampling": {"temperature": temp, "seed": 20 + i, "logprobs": True, **extra},
            "stop": {"max_tokens": 21, "ignore_eos": True},
        })

    async def run(depth):
        args = EngineArgs(model=ModelConfig(), block_size=16, num_kv_blocks=64,
                          max_num_seqs=8, max_model_len=256, decode_steps=4,
                          dtype="float32", device="cuda", pipeline_depth=depth)
        eng = await TorchEngine(args, seed=5).start()
        try:
            outs = await asyncio.gather(*(_collect(eng, r) for r in reqs))
            return outs, eng.runner.eager_windows
        finally:
            await eng.stop()

    async def go():
        d2, eager2 = await run(2)
        d0, _ = await run(0)
        assert eager2 == 0
        assert d2 == d0
        assert all(len(t) == 21 for t, _ in d0)

    asyncio.run(go())


async def _collect(eng, req):
    toks, lps = [], []
    async for item in eng.generate(req, Context()):
        toks += item.get("token_ids") or []
        lps += item.get("log_probs") or []
    return toks, lps
