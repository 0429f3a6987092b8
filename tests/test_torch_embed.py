"""Embeddings in the port against the JAX package's, on the CPU.

``model.embed`` (the JAX package's ``embed_impl``: a cache-free causal
forward, mean-pooled final-norm hidden state over the true tokens) on the
same numpy weights (test-tiny) and the same padded token rows:

- float32 within 1e-5 relative (``TOL_F32``: two frameworks' float32
  forwards, tests/test_torch_model.py);
- bfloat16 weights and activations within 2e-2 (``TOL_BF16``: bf16 keeps 8
  significant bits, and the pooled values are of order 1);
- int8 weights (``engine/quant.py``, both packages quantizing the same
  float tree bit for bit) within 1e-5, tied and untied heads, as
  tests/test_quant.py holds the JAX package's int8 embed;
- two paddings of one input give one vector within the same tolerances
  (the port pads a chunk to a block multiple, the JAX engine to its
  prefill bucket; padded keys are masked and padded rows left out).

Then ``TorchEngine.embed`` against ``TpuEngine.embed`` on the same
weights: a short input, a long one chunk-pooled over
``max_prefill_tokens`` (tests/test_engine.py's contract: the token-weighted
mean of the chunks' vectors), and the same refusals (over-long, empty).
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine import quant as JQ
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy

TOL_F32 = dict(atol=1e-5, rtol=1e-5)
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def _row(n: int, pad: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    toks = np.zeros((pad,), np.int32)
    toks[:n] = rng.integers(1, JCfg().vocab_size, n)
    return toks


def _both(jcfg, tcfg, jparams, tparams, toks, n):
    want = np.asarray(JM.embed(jcfg, jparams, jnp.asarray(toks), jnp.int32(n)).astype(jnp.float32))
    got = TM.embed(tcfg, tparams, torch.from_numpy(toks), n).float().numpy()
    return got, want


@pytest.mark.parametrize("n,pad", [(1, 4), (13, 16), (37, 48), (64, 64)])
def test_embed_float32_matches_jax(np_params, n, pad):
    got, want = _both(JCfg(), ModelConfig(), jax.tree.map(jnp.asarray, np_params),
                      params_from_numpy(np_params, CPU, torch.float32), _row(n, pad), n)
    assert got.shape == (ModelConfig().hidden_size,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL_F32)


@pytest.mark.parametrize("n,pad", [(13, 16), (37, 48)])
def test_embed_bfloat16_within_bound(np_params, n, pad):
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), np_params)
    got, want = _both(JCfg(), ModelConfig(), jp, params_from_numpy(np_params, CPU, torch.bfloat16),
                      _row(n, pad), n)
    np.testing.assert_allclose(got, want, **TOL_BF16)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_embed_int8_weights_matches_jax(tied):
    jcfg, tcfg = JCfg(tie_embeddings=tied), ModelConfig(tie_embeddings=tied)
    q = JQ.quantize_params_np(jax.tree.map(
        np.array, JM.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)))
    got, want = _both(jcfg, tcfg, jax.tree.map(jnp.asarray, q),
                      params_from_numpy(q, CPU, torch.float32), _row(12, 16, 4), 12)
    np.testing.assert_allclose(got, want, **TOL_F32)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)],
                         ids=["float32", "bfloat16"])
def test_embed_does_not_depend_on_the_padding(np_params, dtype, tol):
    tparams = params_from_numpy(np_params, CPU, dtype)
    n = 21
    base = _row(n, 24, 9)
    wide = np.zeros((64,), np.int32)
    wide[:n] = base[:n]
    wide[n:] = 77  # junk past the true length must not matter either
    a = TM.embed(ModelConfig(), tparams, torch.from_numpy(base), n).float().numpy()
    b = TM.embed(ModelConfig(), tparams, torch.from_numpy(wide), n).float().numpy()
    np.testing.assert_allclose(a, b, **tol)


BASE = dict(block_size=4, num_kv_blocks=128, max_num_seqs=4, max_model_len=128,
            max_prefill_tokens=16, dtype="float32", decode_steps=4)


def _engines(np_params):
    port = TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **BASE),
                       params=params_from_numpy(np_params, CPU, torch.float32))
    ref = TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **BASE), params=np_params)
    return port, ref


def test_engine_embed_matches_jax_and_chunk_pools(np_params):
    long_ids = [(7 * i) % 500 + 1 for i in range(40)]  # 3 chunks of at most 16

    async def go(eng):
        await eng.start()
        try:
            short = await eng.embed([1, 2, 3])
            pooled = await eng.embed(long_ids)
            chunks = [long_ids[i : i + 16] for i in range(0, 40, 16)]
            parts = [np.asarray(await eng.embed(c)) * len(c) for c in chunks]
            errors = []
            for bad in (list(range(1, 200)), []):
                try:
                    await eng.embed(bad)
                except Exception as e:  # noqa: BLE001 — the refusal is the result
                    errors.append(str(e))
            # The engine keeps serving after a refusal.
            again = await eng.embed([1, 2, 3])
            return np.asarray(short), np.asarray(pooled), sum(parts) / len(long_ids), errors, again
        finally:
            await eng.stop()

    port, ref = _engines(np_params)
    p_short, p_pooled, p_expect, p_err, p_again = asyncio.run(go(port))
    j_short, j_pooled, _, j_err, _ = asyncio.run(go(ref))
    assert p_short.shape == (ModelConfig().hidden_size,)
    np.testing.assert_allclose(p_short, j_short, **TOL_F32)
    np.testing.assert_allclose(p_pooled, j_pooled, **TOL_F32)
    np.testing.assert_allclose(p_pooled, p_expect, rtol=1e-6, atol=1e-7)
    assert p_again == list(p_short)
    assert p_err == j_err and len(p_err) == 2
    assert "max_model_len" in p_err[0] and "empty" in p_err[1]


def test_engine_embed_interleaves_with_generation(np_params):
    """An embedding job served between decode steps leaves a running
    greedy stream as it is alone."""
    from dynamo_tpu_torch.runtime.engine import Context

    req = {"model": "t", "token_ids": [5, 6, 7, 8, 9], "sampling": {"temperature": 0.0, "seed": 1},
           "stop": {"max_tokens": 24, "ignore_eos": True}}

    async def stream(eng):
        toks = []
        async for item in eng.generate(dict(req), Context()):
            toks.extend(item.get("token_ids") or [])
        return toks

    async def go(with_embed):
        eng, _ = _engines(np_params)
        await eng.start()
        try:
            if not with_embed:
                return await stream(eng), None
            out = await asyncio.gather(stream(eng), eng.embed(list(range(1, 30))))
            return out
        finally:
            await eng.stop()

    alone, _ = asyncio.run(go(False))
    toks, vec = asyncio.run(go(True))
    assert toks == alone and len(vec) == ModelConfig().hidden_size
