"""The port's single-process launcher (``python -m dynamo_tpu_torch.run``).

Batch mode runs in a subprocess on the CPU and prints one JSON line per
prompt. In process, the port's LocalPipeline with weights carried over
from the JAX package gives the same completions as the JAX LocalPipeline
(float32, greedy: identical token streams, hence identical text).
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.llm.protocols import CompletionRequest as JRequest
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from dynamo_tpu.run.__main__ import LocalPipeline as JPipeline
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineArgs as TArgs
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard
from dynamo_tpu_torch.llm.protocols import CompletionRequest as TRequest
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.run.__main__ import LocalPipeline
from dynamo_tpu_torch.runtime.engine import Context

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once on a few cores: these
    tiny shapes gain nothing from torch's intra-op thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_batch_mode_prints_one_line_per_prompt(tmp_path):
    prompts = tmp_path / "prompts.jsonl"
    prompts.write_text(
        '{"prompt": "hello world"}\nplain text line\n'
        '{"prompt": "sampled", "temperature": 0.7, "seed": 3, "max_tokens": 5}\n'
    )
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run", "--device", "cpu", "--in",
         f"batch:{prompts}", "--preset", "test-tiny", "--dtype", "float32", "--max-tokens", "8"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    assert [ln["prompt"] for ln in lines] == ["hello world", "plain text line", "sampled"]
    assert [ln["completion_tokens"] for ln in lines] == [8, 8, 5]
    assert all(ln["finish_reason"] == "length" for ln in lines)
    assert "batch done (3 prompts)" in out.stderr


def test_local_pipeline_matches_jax_pipeline():
    np_params = jax.tree.map(
        np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(1), jnp.float32))
    shape = dict(block_size=16, num_kv_blocks=128, max_num_seqs=4, max_model_len=256,
                 dtype="float32")
    prompts = ["hello world", "the quick brown fox jumps over the lazy dog " * 3, "x"]

    def body(name, p):
        return {"model": name, "prompt": p, "max_tokens": 24, "temperature": 0.0, "seed": 0,
                "logprobs": 0}

    async def go():
        t_eng = await TorchEngine(
            TArgs(model=TCfg(), device="cpu", **shape),
            params=params_from_numpy(np_params, "cpu", torch.float32)).start()
        j_eng = await TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **shape),
                                params=np_params).start()
        try:
            t_pipe = LocalPipeline(TCard(name="test-tiny", context_length=256,
                                         eos_token_ids=[ByteTokenizer.EOS]),
                                   t_eng, ByteTokenizer())
            j_pipe = JPipeline(JCard(name="test-tiny", context_length=256,
                                     eos_token_ids=[JByteTokenizer.EOS]),
                               j_eng, JByteTokenizer())
            results = []
            for p in prompts:
                t_gen = j_gen = None
                async for g, _ in t_pipe.run(TRequest.parse(body("test-tiny", p)), Context()):
                    t_gen = g
                async for g, _ in j_pipe.run(JRequest.parse(body("test-tiny", p)), JContext()):
                    j_gen = g
                results.append((t_gen, j_gen))
            return results
        finally:
            await t_eng.stop()
            await j_eng.stop()

    for t_gen, j_gen in asyncio.run(go()):
        t_out, j_out = t_gen.final_response(), j_gen.final_response()
        assert t_gen.lp_tokens == j_gen.lp_tokens and len(t_gen.lp_tokens) == 24
        np.testing.assert_allclose(t_gen.lp_values, j_gen.lp_values, atol=1e-4, rtol=1e-4)
        for key in ("text", "finish_reason"):
            assert t_out["choices"][0][key] == j_out["choices"][0][key]
        assert t_out["usage"] == j_out["usage"]
        assert t_out["choices"][0]["logprobs"]["tokens"] == j_out["choices"][0]["logprobs"]["tokens"]
