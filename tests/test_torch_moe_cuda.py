"""Mixture of experts on the card: ``_moe`` against a float64 loop, and
a MoE model's windows, verify passes and engine as CUDA graphs.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
neither jax nor dynamo_tpu, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moe_cuda.py

- ``_moe`` on CUDA tensors at moe-tiny's and moe-wide's widths (one
  layer, bf16 and f32) against the float64 loop on the host under
  chip_smoke's gap rule and ``MOE_TOL`` (``moe_against_reference``); two
  calls bit-identical; a call allocates far less than one expert stack.
- A moe-tiny window in every sampler mode, and every verify pass (linear
  fused, stepwise, tree; S1 4 and 7), replayed as a CUDA graph equals the
  op-by-op run bit for bit (chip_smoke's ``graph_vs_eager`` and
  ``verify_graph_vs_eager``).
- ``TorchEngine`` on moe-tiny in bf16: windows, single steps and the
  verify lattice captured ahead of traffic, no window, step or verify
  pass run eagerly; stepwise speculation's greedy streams equal the dense
  ones bit for bit, and a tree run dispatches branched passes.
"""

from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (
    MOE_LEAVES,
    graph_vs_eager,
    moe_against_reference,
    verify_graph_vs_eager,
    verify_inputs,
    window_inputs,
)
from dynamo_tpu_torch.engine import model as M
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.runtime.engine import Context

pytestmark = pytest.mark.cuda

TINY = ModelConfig.preset("moe-tiny")
WIDE = ModelConfig.preset("moe-wide")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LENS = [5, 17, 30, 44, 61, 80, 99, 120]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _layer(cfg, dtype, seed):
    """One layer's router and expert stacks at ``cfg``'s widths, drawn as
    ``init_params`` draws them, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, E = cfg.hidden_size, cfg.num_experts
    ie = cfg.moe_intermediate_size or cfg.intermediate_size
    shapes = {"w_router": ((d, E), d), "moe_gate": ((E, d, ie), d), "moe_up": ((E, d, ie), d),
              "moe_down": ((E, ie, d), ie)}
    return {n: (torch.randn(s, generator=g, device="cuda") * f ** -0.5).to(dtype)
            for n, (s, f) in shapes.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("cfg", [TINY, WIDE], ids=["moe-tiny", "moe-wide"])
@pytest.mark.parametrize("rows", [1, 8, 37])
def test_moe_matches_float64_loop(dev, cfg, dtype, rows):
    lp = _layer(cfg, DTYPES[dtype], seed=rows)
    g = torch.Generator(device="cuda").manual_seed(100 + rows)
    x = torch.randn((rows, cfg.hidden_size), generator=g, device="cuda").to(DTYPES[dtype])
    res = moe_against_reference(x, lp, cfg, dtype)
    assert res["rows_checked"] + res["rows_left_out"] == rows
    assert res["rows_checked"] >= rows // 3
    a, b = M._moe(x, lp, cfg), M._moe(x, lp, cfg)
    assert torch.equal(a, b)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    M._moe(x, lp, cfg)
    torch.cuda.synchronize()
    stack = lp["moe_gate"].numel() * lp["moe_gate"].element_size()
    assert torch.cuda.max_memory_allocated() - base < stack // 4 + (8 << 20)


def _runner(dtype="bfloat16", **kw) -> LocalRunner:
    args = EngineArgs(model=TINY, block_size=16, num_kv_blocks=128, max_num_seqs=8,
                      max_model_len=512, decode_steps=8, dtype=dtype, device="cuda",
                      spec_tokens=3, **kw)
    runner = LocalRunner(args, seed=3)
    runner.start()
    assert "moe_gate" in runner.params["layers"]
    return runner


@pytest.mark.parametrize("mode", ["greedy", "simple", "full"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_window_graph_matches_eager(dev, dtype, mode):
    runner = _runner(dtype)
    kw = dict(window_inputs(runner, mode, 7, lens=LENS[:6]), top_n=2)
    graph_vs_eager(runner, kw)
    assert runner.graphs.captured == 1 and runner.eager_windows == 1


@pytest.mark.parametrize("kind", ["linear", "stepwise", "tree"])
@pytest.mark.parametrize("S1", [4, 7])
def test_verify_graph_matches_eager(dev, S1, kind):
    runner = _runner()
    runner.args.spec_fused = kind != "stepwise"
    kw = verify_inputs(runner, S1, "tree" if kind == "tree" else "linear", "greedy", lens=LENS)
    n_emit = verify_graph_vs_eager(runner, kw)
    assert runner.graphs.captured == 1 and runner.eager_verifies == 1
    assert n_emit[0] == (S1 if kind != "tree" else {4: 3, 7: 4}[S1])


def test_engine_captures_and_speculates_on_the_card(dev):
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, 24, 40)] for _ in range(8)]

    def engine(**kw):
        args = EngineArgs(model=TINY, block_size=16, num_kv_blocks=128, max_num_seqs=8,
                          max_model_len=256, decode_steps=8, dtype="bfloat16", device="cuda",
                          spec_gate=0.0, **kw)
        return TorchEngine(args, seed=0)

    async def run(eng):
        async def one(i, p):
            toks, lps = [], []
            req = {"model": "t", "token_ids": p,
                   "sampling": {"temperature": 0.0 if i % 4 else 0.7, "seed": i,
                                "logprobs": True},
                   "stop": {"max_tokens": 48, "ignore_eos": True}}
            async for item in eng.generate(req, Context()):
                toks.extend(item.get("token_ids") or [])
                lps.extend(item.get("log_probs") or [])
            return toks, lps

        await eng.start()
        r = eng.runner
        captured = (r.warm_windows(("greedy", "simple"), (0,)), r.warm_steps(("greedy", "simple")))
        if eng.args.spec_tokens:
            captured += (r.warm_spec(("greedy", "simple"), (0,), True),)
        try:
            outs = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
        finally:
            await eng.stop()
        assert all(n > 0 for n in captured), captured
        assert (r.eager_windows, r.eager_steps, r.eager_verifies) == (0, 0, 0)
        return outs

    dense = asyncio.run(run(engine()))
    stepwise_eng = engine(spec_tokens=3, spec_fused=False)
    stepwise = asyncio.run(run(stepwise_eng))
    greedy = [i for i in range(len(prompts)) if i % 4]
    assert [stepwise[i] for i in greedy] == [dense[i] for i in greedy]
    assert stepwise_eng.runner.verify_passes > 0
    tree_eng = engine(spec_tokens=3, spec_tree_width=2, spec_tree_depth=3, spec_ngram=1)
    tree = asyncio.run(run(tree_eng))
    assert tree_eng.total_spec_tree_passes > 0
    assert all(len(t) == 48 for t, _ in tree)


def test_params_carry_every_moe_leaf(dev):
    cfg = dataclasses.replace(WIDE, num_layers=1)
    params = M.init_params(cfg, dev, torch.bfloat16, seed=0)
    layers = params["layers"]
    assert set(MOE_LEAVES) <= set(layers) and "w_gate" not in layers
    assert layers["moe_gate"].shape == (1, 64, 2048, 1024)
    assert layers["moe_down"].shape == (1, 64, 1024, 2048)
    assert all(layers[n].dtype == torch.bfloat16 for n in MOE_LEAVES)
    std = layers["moe_gate"].float().std().item()
    assert abs(std - 2048 ** -0.5) < 0.01 * 2048 ** -0.5
