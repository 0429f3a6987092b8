"""Multi-LoRA on the card: the LoRA graph variants against op by op, and
uploads into a bank that captured graphs read.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
neither jax nor dynamo_tpu, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lora_cuda.py

- A K=8 window, a single step and a tree verify pass whose rows carry
  adapter slots (-1 for base rows) replay as CUDA graphs bit-identical to
  the op-by-op dispatch (chip_smoke's ``graph_vs_eager``); a base row of
  the LoRA window equals the same row of the pre-LoRA window.
- ``upload_adapter`` after the capture changes what the next replay
  computes for that slot's rows and nothing else: the bank keeps its
  addresses.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import graph_vs_eager, verify_graph_vs_eager, verify_inputs, window_inputs
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.lora import LoraAdapterSpec, make_adapter_pages
from dynamo_tpu_torch.engine.runner import LocalRunner

pytestmark = pytest.mark.cuda

SLOTS = np.array([0, 1, -1, 0, 1, -1, -1, -1], np.int32)
LENS = [5, 17, 30, 44, 61, 80, 99, 120]  # rows within max_model_len 512


@pytest.fixture
def runner():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = EngineArgs(model=ModelConfig(), block_size=16, num_kv_blocks=128, max_num_seqs=8,
                      max_model_len=512, decode_steps=8, dtype="bfloat16", device="cuda",
                      spec_tokens=3, lora_slots=2, lora_rank=8)
    r = LocalRunner(args, seed=0)
    r.start()
    for slot, (name, rank) in enumerate((("a", 8), ("b", 4))):
        r.upload_adapter(slot, make_adapter_pages(args.model, LoraAdapterSpec(name, rank, 3), 8))
    yield r
    r.stop()


@pytest.mark.parametrize("mode", ["greedy", "simple"])
def test_lora_window_graph_equals_eager(runner, mode):
    kw = dict(window_inputs(runner, mode, 11), adapter_slots=SLOTS)
    graph_vs_eager(runner, kw)
    assert any(k[-1] for k in runner.graphs.shapes)


def test_lora_verify_graph_equals_eager(runner):
    kw = dict(verify_inputs(runner, 4, "tree", mode="greedy", lens=LENS), adapter_slots=SLOTS)
    verify_graph_vs_eager(runner, kw)
    assert any(k[0] == "verify" and k[8] for k in runner.graphs.shapes)


def test_upload_after_capture_reaches_the_replay(runner):
    kw = dict(window_inputs(runner, "greedy", 12), adapter_slots=SLOTS)
    state = [t.clone() for t in runner.cache if t is not None] + [runner.last_toks.clone()]

    def replay():
        for dst, src in zip([t for t in runner.cache if t is not None] + [runner.last_toks],
                            state):
            dst.copy_(src)
        return runner.multi_decode(**kw).arrs[1].clone()

    before = replay()
    ptrs = {k: v.data_ptr() for k, v in runner.lora_bank.items()}
    runner.upload_adapter(1, make_adapter_pages(runner.cfg, LoraAdapterSpec("c", 8, 5), 8))
    after = replay()
    assert {k: v.data_ptr() for k, v in runner.lora_bank.items()} == ptrs
    moved = (before != after).any(dim=0).cpu().numpy()
    assert moved[SLOTS == 1].all() and not moved[SLOTS != 1].any()
