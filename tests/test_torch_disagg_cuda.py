"""KV pages injected into a runner whose CUDA graphs were already captured,
on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
neither jax nor dynamo_tpu, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_disagg_cuda.py

Runner A prefills six rows (chip_smoke's ``window_inputs``). Runner B, on
the same weights, captures its decode-window graphs first (they hold its
cache tensors' addresses), then receives A's pages through
``extract_pages`` / ``inject_pages`` and A's chain buffer. B's graph replay
of the next K=8 window must equal A's op-by-op window bit for bit: an
inject that rebound the cache would leave the graph reading B's old,
empty pages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import window_inputs
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.runner import LocalRunner

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _runner(dtype: str, kv_quant: str) -> LocalRunner:
    args = EngineArgs(model=ModelConfig(), block_size=16, num_kv_blocks=64, max_num_seqs=8,
                      max_model_len=512, decode_steps=8, dtype=dtype, kv_quant=kv_quant,
                      device="cuda")
    runner = LocalRunner(args, seed=3)
    runner.start()
    return runner


@pytest.mark.parametrize("dtype,kv_quant", [("float32", "none"), ("bfloat16", "none"),
                                            ("bfloat16", "int8")])
@pytest.mark.parametrize("mode", ["greedy", "simple"])
def test_graph_replay_after_inject_equals_eager(dev, dtype, kv_quant, mode):
    a, b = _runner(dtype, kv_quant), _runner(dtype, kv_quant)
    assert b.warm_windows((mode,)) > 0  # B's graphs hold its cache's addresses now
    cache, ptrs = b.cache, [t.data_ptr() for t in b.cache if t is not None]
    kw = window_inputs(a, mode, seed=7)
    used = sorted({int(x) for x in kw["tables"][kw["active"]].ravel() if x > 0})
    b.inject_pages(used, *a.extract_pages(used))
    b.last_toks.copy_(a.last_toks)
    assert b.cache is cache and [t.data_ptr() for t in b.cache if t is not None] == ptrs
    replays = b.graphs.replays
    got = [t.clone() for t in b.multi_decode(**kw).arrs]
    want = [t.clone() for t in a.multi_decode(**kw, eager=True).arrs]
    torch.cuda.synchronize()
    assert b.graphs.replays == replays + 1 and b.eager_windows == 0
    for name, x, y in zip(("tokens", "logprobs", "top_vals", "top_ids"), got, want):
        assert torch.equal(x, y), name
    # and the pages the window wrote next to the injected ones agree too
    for x, y in zip(a.extract_pages(used), b.extract_pages(used)):
        np.testing.assert_array_equal(x, y)
