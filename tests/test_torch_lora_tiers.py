"""Adapter pages in the KV tiers across the two packages (CPU).

An adapter's factor pages are a paged object in the tiers, keyed by
``adapter_tier_hash`` (engine/lora.py), so an engine of either package
pages in an adapter that an engine of the other wrote to a G3 directory
or a shared G4 one. Each case registers "tenant-a" on the writer with
pages of another source (a checkpoint's factors), which land in the
directory; the reader, a fresh engine of the other package on the same
directory, registers "tenant-a" from its seed (the directory already
holds the object, so nothing is written) and serves a request under it:
its stream equals the writer's (tokens, logprobs within 1e-4), so the
factors came from the writer's file, and differs from a reader without
the directory, which serves the seed's factors.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.lora import LoraAdapterSpec as JSpec
from dynamo_tpu.engine.lora import make_adapter_pages as j_pages
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context

BASE = dict(block_size=4, num_kv_blocks=128, max_num_seqs=4, max_model_len=96,
            max_prefill_tokens=64, dtype="float32", decode_steps=4, lora_slots=2,
            lora_rank=4)
REQ = {"model": "test-tiny", "token_ids": list(range(5, 27)), "adapter_id": "tenant-a",
       "sampling": {"temperature": 0.0, "seed": 0, "logprobs": True},
       "stop": {"max_tokens": 8, "ignore_eos": True}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def engine(package: str, np_params, tier: str | None, path) -> TpuEngine | TorchEngine:
    kw = dict(BASE)
    if tier == "g3":
        kw["disk_kv_dir"] = str(path)
    elif tier == "g4":
        kw["fleet_kv_dir"] = str(path)
    if package == "jax":
        return TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **kw), params=np_params)
    return TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **kw),
                       params=params_from_numpy(np_params, "cpu", torch.float32))


async def serve(eng, pages=None) -> tuple[list[int], list[float]]:
    eng.register_adapter("tenant-a", rank=4, seed=7, pages=pages)
    await eng.start()
    try:
        ctx = JContext() if isinstance(eng, TpuEngine) else Context()
        toks, lps = [], []
        async for item in eng.generate(dict(REQ), ctx):
            assert not item.get("error"), item
            toks += item.get("token_ids") or []
            lps += item.get("log_probs") or []
        return toks, lps
    finally:
        await eng.stop()


@pytest.mark.parametrize("tier", ["g3", "g4"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_adapter_pages_cross_packages(np_params, tmp_path, tier, writer, reader):
    other = j_pages(JCfg(), JSpec("other-source", 4, 99), 4)
    written = asyncio.run(serve(engine(writer, np_params, tier, tmp_path), pages=other))
    files = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert files, "the writer put the adapter object into the directory"
    read = asyncio.run(serve(engine(reader, np_params, tier, tmp_path)))
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == files
    assert read[0] == written[0]
    np.testing.assert_allclose(read[1], written[1], atol=1e-4, rtol=1e-4)
    seed_only = asyncio.run(serve(engine(reader, np_params, None, tmp_path)))
    assert seed_only[1] != read[1]
