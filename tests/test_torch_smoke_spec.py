"""chip_smoke.py's phase 10 (speculative decoding) rehearsed on the CPU.

- ``chip_smoke.spec_phase`` at test-tiny in float32 through ``run``'s
  pipeline: the dense, fused (twice), stepwise and tree bursts, their
  checks (stepwise greedy streams bit-equal to dense, fused and tree ones
  within the gap rule, the repeat identical, branched passes dispatched)
  and the launch formula, which counts 0 here (the plain attention runs).
- ``chip_smoke.verify_inputs``, the operands of the card's verify timing:
  each greedy row's draft is its own greedy continuation, so a linear pass
  accepts every slot (row 1 up to its wrong third token) and a tree pass
  walks the path of first children past the rejected siblings.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

import chip_smoke as C
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.runner import LocalRunner


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_spec_phase_on_the_cpu():
    res = asyncio.run(C.spec_phase("CPU", preset="test-tiny", device="cpu", dtype="float32"))
    for name in ("dense", "fused", "stepwise", "tree"):
        st = res[name]
        assert st["attention_launches"] == 0 and st["int8_launches"] == 0
        assert st["verify_passes"] == 0 if name == "dense" else st["verify_passes"] > 0
    assert res["stepwise"]["verify_forwards"] > res["stepwise"]["verify_passes"]
    assert res["fused"]["verify_forwards"] == res["fused"]["verify_passes"]
    assert res["tree"]["tree_passes"] > 0
    assert res["fused"]["tokens_per_weight_pass"] > 1.0


@pytest.mark.parametrize("S1,kind,want", [(4, "linear", 4), (7, "linear", 7), (4, "tree", 3),
                                          (7, "tree", 4)])
def test_verify_inputs_drafts_are_accepted(S1, kind, want):
    args = EngineArgs(model=ModelConfig(), device="cpu", dtype="float32", block_size=16,
                      num_kv_blocks=64, max_num_seqs=8, max_model_len=256, spec_tokens=3)
    runner = LocalRunner(args, seed=0)
    runner.start()
    lens = [5, 17, 30, 44, 61, 80, 99, 120]
    kw = C.verify_inputs(runner, S1, kind, mode="greedy", lens=lens)
    n_emit = runner.spec_verify(**kw).arrs[1].numpy()
    expect = np.full((8,), want)
    if kind == "linear":
        expect[1] = min(3, S1)
    np.testing.assert_array_equal(n_emit, expect)
    if kind == "tree":
        assert runner.verify_forwards == 1
