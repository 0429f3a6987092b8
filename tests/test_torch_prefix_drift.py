"""A prefix-cache hit in bfloat16, through both engines, on the CPU.

On the card a bf16 prefix-cache hit moved a repeated request's logprobs
from its cold pass (PERF.md). Here one prompt runs cold and then
again on its cached prefix, through ``TpuEngine`` (XLA attention) and
``TorchEngine``, test-tiny in bfloat16 on the same weights. The hit
prefills only the suffix, over the cached pages, so its bf16 products
see other shapes (and summation orders) than the cold pass's: both
engines drift, by the same order. The port is held to the JAX package
pass for pass, cold against cold and hit against hit: greedy tokens
equal, logprobs within 0.15 (the bf16 bound of tests/test_torch_model.py
at test-tiny: 8 significant bits, a few dozen roundings over two layers).
Each package's cold-versus-hit drift is printed (``-s``).
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from test_torch_pipeline import run_stream

BASE = dict(block_size=4, num_kv_blocks=256, max_num_seqs=8, max_model_len=256,
            max_prefill_tokens=256, dtype="bfloat16", decode_steps=4)
BF16_TOL = 0.15


async def _cold_then_hit(eng, req):
    await eng.start()
    try:
        cold = await run_stream(eng, req)
        before = eng.total_prefilled
        hit = await run_stream(eng, req)
        prefilled = eng.total_prefilled - before
    finally:
        await eng.stop()
    return cold, hit, prefilled


def test_prefix_hit_drift_is_the_jax_engines_too():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tree = jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))
        tree16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
        prompt = np.random.default_rng(0).integers(1, 500, 97).tolist()
        req = {"model": "test-tiny", "token_ids": prompt,
               "sampling": {"temperature": 0.0, "seed": 0, "logprobs": True},
               "stop": {"max_tokens": 16, "ignore_eos": True}}
        jax_run = asyncio.run(_cold_then_hit(
            TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **BASE),
                      params=jax.tree.map(jnp.asarray, tree16)), req))
        port_run = asyncio.run(_cold_then_hit(
            TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **BASE),
                        params=params_from_numpy(tree16, "cpu", torch.bfloat16)), req))
    finally:
        torch.set_num_threads(n)
    drift = {}
    for name, (cold, hit, prefilled) in (("jax", jax_run), ("port", port_run)):
        assert prefilled < len(prompt) // 4, (name, prefilled)  # the hit took the cache
        assert cold[0] == hit[0], name
        drift[name] = float(np.abs(np.asarray(cold[1]) - np.asarray(hit[1])).max())
    for i, what in ((0, "cold"), (1, "hit")):
        assert port_run[i][0] == jax_run[i][0], what
        gap = float(np.abs(np.asarray(port_run[i][1]) - np.asarray(jax_run[i][1])).max())
        assert gap <= BF16_TOL, (what, gap)
        print(f"bf16 {what} pass: port vs JAX max |logprob diff| {gap:.4g}")
    print(f"bf16 cold vs prefix-hit drift: JAX {drift['jax']:.4g}, port {drift['port']:.4g}")
    # Both engines drift, and by the same order.
    assert drift["jax"] > 0 and drift["port"] > 0
    assert drift["port"] <= 2 * drift["jax"] + 0.02
