"""Multi-LoRA under tensor parallelism in the port, against the port at
tp 1 and the JAX package's ``TpuEngine`` at tp 2 with a bank, on the CPU.

Each rank holds its shard of the adapter bank, cut from the full pages in
``LocalRunner.upload_adapter`` (``runner.shard_adapter_pages``): B
of q over tp, B of k/v over tp_kv, A of o over tp, the rest whole.
test-tiny in float32 (4 query heads, 2 kv heads), every request seeded.

- Engines: a ``TorchEngine`` over a ``LeaderRunner`` at tp 2 (kv heads
  split) and at tp 4 (tp_kv 2 × tp_rep 2), followers spawned
  (``tests/torch_tp_ranks.py``), serves a mixed burst (base rows beside
  rows of two adapters, greedy and sampled, submitted before the
  scheduler starts): the same streams as the port engine at tp 1 and as
  ``TpuEngine`` at tp 2 with its replicated bank, tokens equal and
  logprobs within 1e-4; each follower sampled the leader's tokens.
- Forwards on gloo ranks: a prefill and two decode steps with adapter and
  base rows. A base row's logits with the bank equal, bit for bit, the
  same ranks' logits with no bank (the ``where`` contract); adapter rows
  equal tp 1's within 1e-5.
- Each rank's bank holds exactly its columns and rows of the full pages.
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
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineArgs as TArgs
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.lora import LORA_PAGE_KEYS, LoraAdapterSpec, make_adapter_pages
from dynamo_tpu_torch.engine.runner import LeaderRunner
from dynamo_tpu_torch.parallel.comm import TpGroup
from dynamo_tpu_torch.parallel.mesh import ModelSharding
from dynamo_tpu_torch.runtime.engine import Context

from torch_tp_ranks import (
    BS,
    NBLK,
    Followers,
    lora_forward_scenario,
    lora_runner,
    lora_tp_rank,
    run_ranks,
)

ARGS = dict(block_size=4, num_kv_blocks=128, max_num_seqs=8, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4, lora_slots=2, lora_rank=4)
TOL = dict(atol=1e-4, rtol=1e-4)
ADAPTERS = (("tenant-a", 4, 7), ("tenant-b", 2, 9))  # (name, rank, seed)
MIXED = [None, "tenant-a", None, "tenant-b", "tenant-a", None]
CFG = TCfg()


def request(i: int, adapter: str | None) -> dict:
    ids = np.random.default_rng(1000 + i).integers(1, 511, size=13 + 3 * i).tolist()
    return {"model": "test-tiny", "token_ids": ids, "adapter_id": adapter,
            "sampling": {"temperature": 0.0 if i % 2 == 0 else 0.9, "seed": i,
                         "logprobs": True},
            "stop": {"max_tokens": 10, "ignore_eos": True}}


BURST = [request(i, a) for i, a in enumerate(MIXED)]


async def _stream(eng, req) -> dict:
    ctx = JContext() if isinstance(eng, TpuEngine) else Context()
    out = {"tokens": [], "logprobs": [], "error": None}
    async for item in eng.generate(req, ctx):
        out["tokens"] += item.get("token_ids") or []
        out["logprobs"] += item.get("log_probs") or []
        out["error"] = item.get("error") or out["error"]
    return out


async def serve(eng) -> list[dict]:
    """Register ADAPTERS, queue BURST before the scheduler starts, serve it."""
    for name, rank, seed in ADAPTERS:
        eng.register_adapter(name, rank=rank, seed=seed)
    try:
        tasks = [asyncio.ensure_future(_stream(eng, r)) for r in BURST]
        await asyncio.sleep(0)
        await eng.start()
        return list(await asyncio.gather(*tasks))
    finally:
        await eng.stop()


def same_streams(got, want):
    for g, w in zip(got, want):
        assert g["error"] is None and w["error"] is None, (g, w)
        assert g["tokens"] == w["tokens"] and len(g["tokens"]) == 10
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], **TOL)


@pytest.fixture(scope="module")
def loop():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


@pytest.fixture(scope="module")
def reference(loop, np_params):
    """The burst on the port at tp 1 and on ``TpuEngine`` at tp 2."""
    port = TorchEngine(TArgs(model=CFG, device="cpu", **ARGS), params=np_params)
    jeng = TpuEngine(JArgs(model=JCfg(), attn_impl="xla", tp=2, **ARGS), params=np_params)
    return {"port_tp1": loop.run_until_complete(serve(port)),
            "jax_tp2": loop.run_until_complete(serve(jeng))}


def _tp_engine(loop, np_params, tp: int) -> dict:
    eargs = TArgs(model=CFG, device="cpu", tp=tp, **ARGS)
    followers = Followers(tp, eargs, np_params)
    group = TpGroup(0, tp, followers.coordinator, "cpu")
    try:
        runner = LeaderRunner(eargs, params=np_params, group=group,
                              listen_addr=followers.step_addr, num_followers=tp - 1)
        out = {"streams": loop.run_until_complete(serve(TorchEngine(eargs, runner=runner))),
               "leader": runner.digest(), "uploads": runner.adapter_uploads}
        out["followers"] = followers.results()
    finally:
        followers.kill()
        group.close()
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_lora_streams_equal_tp1_and_tpu_engine(loop, np_params, reference, tp):
    got = _tp_engine(loop, np_params, tp)
    same_streams(got["streams"], reference["port_tp1"])
    same_streams(got["streams"], reference["jax_tp2"])
    assert got["uploads"] == len(ADAPTERS)
    assert [f["digest"] for f in got["followers"]] == [got["leader"]] * (tp - 1)
    assert got["leader"] != 0


def _pages():
    return [make_adapter_pages(CFG, LoraAdapterSpec(name, rank, seed), ARGS["lora_rank"])
            for name, rank, seed in ADAPTERS]


def _forward_inputs() -> dict:
    rng = np.random.default_rng(5)
    lens = np.array([13, 9, 6, 11], np.int32)
    toks = np.zeros((4, 16), np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(1, CFG.vocab_size, n)
    tables = np.arange(1, 1 + 4 * 6, dtype=np.int32).reshape(4, 6)
    return {"toks": toks, "lens": lens, "tables": tables,
            "slots": np.array([0, -1, 1, -1], np.int32)}


@pytest.fixture(scope="module")
def forward_tp1(np_params):
    eargs = TArgs(model=CFG, device="cpu", num_kv_blocks=NBLK, block_size=BS,
                  **{k: v for k, v in ARGS.items() if k not in ("num_kv_blocks", "block_size")})
    runner = lora_runner(eargs, np_params, _pages())
    return lora_forward_scenario(runner, _forward_inputs(), True)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_lora_forward_base_rows_bit_exact(np_params, forward_tp1, tp):
    eargs = TArgs(model=CFG, device="cpu", num_kv_blocks=NBLK, block_size=BS, tp=tp,
                  **{k: v for k, v in ARGS.items() if k not in ("num_kv_blocks", "block_size")})
    pages = _pages()
    ranks = run_ranks(lora_tp_rank, tp, eargs, np_params, pages, _forward_inputs())
    base = _forward_inputs()["slots"] < 0
    for rank, (with_bank, without, bank) in enumerate(ranks):
        for got, plain, want in zip(with_bank, without, forward_tp1):
            assert np.array_equal(got[base], plain[base])
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        # The rank's bank: its columns of q's and k/v's B, its rows of o's A.
        sh = ModelSharding(CFG, tp, rank)
        q_w, kv_w = CFG.q_size // tp, CFG.kv_size // sh.tp_kv
        cut = {"qb": np.s_[..., rank * q_w:(rank + 1) * q_w],
               "kb": np.s_[..., sh.i * kv_w:(sh.i + 1) * kv_w],
               "vb": np.s_[..., sh.i * kv_w:(sh.i + 1) * kv_w],
               "oa": np.s_[:, rank * q_w:(rank + 1) * q_w]}
        for slot, full in enumerate(pages):
            for key, page in zip(LORA_PAGE_KEYS, full):
                want = page[cut[key]] if key in cut else page
                np.testing.assert_array_equal(bank[key][:, slot], want, err_msg=key)
