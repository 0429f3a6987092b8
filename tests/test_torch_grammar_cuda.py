"""Grammar-constrained decoding and embeddings on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
neither jax nor dynamo_tpu, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_grammar_cuda.py

- A masked single step (``runner.decode_sample``: decode step and masked
  sampling) and a masked tree verify pass, each replayed as a CUDA graph,
  equal their op-by-op runs bit for bit in every output, the KV pages and
  the chain buffer (chip_smoke's ``step_graph_vs_eager`` and
  ``verify_graph_vs_eager``), greedy and "simple", at test-tiny and at
  llama-8b width with 2 layers; every sampled token is legal.
- ``TorchEngine`` on the card: constrained greedy tree streams equal the
  dense ones, every response validates, nothing runs eagerly; the
  end-of-life tail (K=1 plans) replays the unmasked single-step graph and
  its streams equal the same engine's op by op; ``embed`` gives a finite
  vector independent of a second padding and within ``EMBED_REL_TOL`` of
  chip_smoke's plain float32 forward.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json

import numpy as np
import pytest
import torch

from chip_smoke import (
    EMBED_REL_TOL,
    GRAMMAR_RF,
    embed_f32_reference,
    grammar_states,
    step_graph_vs_eager,
    verify_graph_vs_eager,
    verify_inputs,
    verify_rows,
)
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.grammar import build_compiler, pack_token_ids
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.runtime.engine import Context

pytestmark = pytest.mark.cuda

GEOMETRIES = {
    "test-tiny-f32": (ModelConfig(), "float32"),
    "llama-8b-2layers": (dataclasses.replace(ModelConfig.preset("llama-8b"), num_layers=2),
                         "bfloat16"),
}
LENS = [5, 17, 30, 44, 61, 80, 99, 120]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _runner(geometry: str) -> LocalRunner:
    cfg, dtype = GEOMETRIES[geometry]
    args = EngineArgs(model=cfg, block_size=16, num_kv_blocks=128, max_num_seqs=8,
                      max_model_len=512, decode_steps=8, dtype=dtype, device="cuda",
                      spec_tokens=3)
    runner = LocalRunner(args, seed=3)
    runner.start()
    return runner


def _masks(runner):
    V = runner.cfg.vocab_size
    g = build_compiler(None, V).compile(GRAMMAR_RF)
    states = grammar_states(g, len(LENS))
    return g, states, np.stack([g.mask(st, pack_token_ids([257], V)) for st in states])


@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_masked_step_graph_matches_eager(dev, geometry, mode):
    runner = _runner(geometry)
    g, states, masks = _masks(runner)
    rows = verify_rows(runner, 4, LENS)
    B = len(LENS)
    temps = np.zeros((B,), np.float32)
    if mode == "simple":
        temps[[3, 6]] = 0.7
    z = np.zeros((B,), np.int32)
    kw = dict(mode=mode, tokens=np.asarray(rows["first"], np.int32),
              positions=rows["lens"].astype(np.int32), tables=rows["tables"],
              active=np.ones((B,), bool), temps=temps, seeds=np.arange(B, dtype=np.int32),
              steps=z, tks=z, tps=np.ones((B,), np.float32), freqs=np.zeros((B,), np.float32),
              press=np.zeros((B,), np.float32), pen=np.full((B, 1), -1, np.int32),
              fold_slots=np.arange(B, dtype=np.int32), top_n=2, masks=masks)
    toks = step_graph_vs_eager(runner, kw)
    assert runner.graphs.captured == 1 and runner.eager_steps == 1
    for st, t in zip(states, toks):
        assert g.advance(st, t) is not None or (t == 257 and g.is_terminal(st))


@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("S1", [4, 7])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_masked_tree_verify_graph_matches_eager(dev, geometry, S1, mode):
    runner = _runner(geometry)
    _g, _states, row_masks = _masks(runner)
    kw = verify_inputs(runner, S1, "tree", mode, lens=LENS)
    masks = np.repeat(row_masks[:, None, :], S1, axis=1)
    for b in range(len(LENS)):
        for t in kw["tokens"][b]:
            masks[b, :, t >> 5] |= np.uint32(1 << (int(t) & 31))
    verify_graph_vs_eager(runner, dict(kw, masks=masks))
    assert runner.graphs.captured == 1 and runner.eager_verifies == 1
    assert any(k[0] == "verify" and k[-1] for k in runner.graphs.shapes)


def test_engine_constrained_tree_equals_dense_on_the_card(dev):
    args = dict(model=ModelConfig(), block_size=16, num_kv_blocks=256, max_num_seqs=8,
                max_model_len=512, decode_steps=8, dtype="float32", device="cuda",
                pipeline_depth=0, spec_gate=0.0, spec_tree_width=2)

    async def run(spec):
        eng = await TorchEngine(EngineArgs(**args, spec_tokens=spec)).start()
        eng.runner.warm_steps(("greedy",))
        eng.runner.warm_spec(("greedy",), (0,), grammar=True)
        try:
            reqs = [{"model": "t", "token_ids": list(f"record {i}: ".encode()),
                     "sampling": {"temperature": 0.0, "seed": i},
                     "stop": {"max_tokens": 128}, "eos_token_ids": [257],
                     "response_format": GRAMMAR_RF} for i in range(4)]

            async def one(r):
                toks = []
                async for item in eng.generate(r, Context()):
                    toks.extend(item.get("token_ids") or [])
                return toks

            out = await asyncio.gather(*(one(r) for r in reqs))
            return out, (eng.runner.eager_windows, eng.runner.eager_steps,
                         eng.runner.eager_verifies)
        finally:
            await eng.stop()

    dense, eager_d = asyncio.run(run(0))
    tree, eager_t = asyncio.run(run(3))
    assert eager_d == eager_t == (0, 0, 0)
    assert tree == dense
    for toks in dense:
        assert toks[-1] == 257
        obj = json.loads(bytes(t for t in toks[:-1]).decode())
        assert list(obj) == list(GRAMMAR_RF["json_schema"]["schema"]["properties"])


def test_engine_tail_replays_single_step_graphs_on_the_card(dev):
    args = EngineArgs(model=ModelConfig(), block_size=16, num_kv_blocks=64, max_num_seqs=4,
                      max_model_len=64, decode_steps=8, dtype="float32", device="cuda")

    async def run(graphs: bool):
        eng = await TorchEngine(args).start()
        if graphs:
            eng.runner.warm_windows(("greedy",))
            eng.runner.warm_steps(("greedy",), masked=(False,))
        else:
            eng.runner.graphs = None  # every dispatch op by op
        try:
            reqs = [{"model": "t", "token_ids": list(range(3 + i, 23 + i)),
                     "sampling": {"temperature": 0.0, "seed": i},
                     "stop": {"max_tokens": 60, "ignore_eos": True}, "eos_token_ids": [257]}
                    for i in range(3)]

            async def one(r):
                toks = []
                async for item in eng.generate(r, Context()):
                    toks.extend(item.get("token_ids") or [])
                return toks

            out = await asyncio.gather(*(one(r) for r in reqs))
            shapes = eng.runner.graphs.shapes if graphs else []
            return out, (eng.runner.eager_windows, eng.runner.eager_steps), shapes
        finally:
            await eng.stop()

    with_graphs, eager_g, shapes = asyncio.run(run(True))
    op_by_op, eager_e, _ = asyncio.run(run(False))
    assert eager_g == (0, 0)
    assert eager_e[0] > 0 and eager_e[1] > 0  # the tail ran single steps
    assert any(k[0] == "step" and not k[-1] for k in shapes)
    assert [len(t) for t in with_graphs] == [44] * 3
    assert with_graphs == op_by_op


def test_embed_on_the_card_ignores_padding(dev):
    runner = _runner("llama-8b-2layers")
    toks = np.random.default_rng(0).integers(1, 1000, 40).astype(np.int32)
    a = runner.embed(np.pad(toks, (0, 8)), 40)
    b = runner.embed(np.pad(toks, (0, 88)), 40)
    assert a.device.type == "cuda" and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)
    ref = TM.embed(runner.cfg, runner.params, torch.from_numpy(np.pad(toks, (0, 8))).cuda(), 40)
    assert torch.equal(a, ref)
    ref32 = embed_f32_reference(runner.cfg, runner.params, toks.tolist())
    assert float(torch.linalg.norm(a - ref32) / torch.linalg.norm(ref32)) < EMBED_REL_TOL
