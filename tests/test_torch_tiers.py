"""The port's KV tiers (G2 host, G3 disk) against the JAX package's, on the CPU.

- The pool and stack semantics of ``dynamo_tpu_torch/block_manager/tiers.py``
  (a copy of the JAX module with its own npz codec): LRU and spill, the
  disk round trip with bf16 pages as uint16 bit patterns, G3 → G2
  promotion, protected blocks under churn, the offload bound and the radix
  tree's fan-out protection (tests/test_tiers.py's cases).
- ``TorchEngine`` onboards an evicted prefix from G2 instead of recomputing
  it, with the same stream (tests/test_tiers.py's engine case).
- The same prompts through a ``TpuEngine`` and a ``TorchEngine`` on the same
  weights (test-tiny, float32; G2 only, G2 + G3, and int8 pages): equal
  tokens, and ``tiers.stats()`` and ``total_prefilled`` equal field for
  field. Each engine runs unpipelined; the first wave is queued before
  ``start()`` (prompts of one length, so the JAX engine's prefill packing
  keeps their order), the rest one request at a time.
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
from dynamo_tpu_torch.block_manager.pool import BlockPool
from dynamo_tpu_torch.block_manager.tiers import DiskBlockPool, HostBlockPool, TierStack
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.kv_transfer import f32_to_bf16_bits
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context

CFG = ModelConfig()
ARGS = dict(block_size=4, num_kv_blocks=32, max_num_seqs=4, max_model_len=64,
            max_prefill_tokens=32, dtype="float32", decode_steps=2, pipeline_depth=0,
            pipeline_windows=False)


def page(seed: int, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, 1, 4, 2, 8)).astype(dtype)


def bf16_page(seed: int) -> np.ndarray:
    """A host bf16 page as the port holds it: uint16 bit patterns."""
    return f32_to_bf16_bits(page(seed))


# -- pools and stack (tests/test_tiers.py's cases on the port's copy) ---------


def test_host_pool_lru_and_spill():
    spilled = []
    host = HostBlockPool(2, spill=lambda h, k, v: spilled.append(h))
    host.put(1, page(1), page(1))
    host.put(2, page(2), page(2))
    host.put(3, page(3), page(3))  # evicts 1 → spill
    assert spilled == [1]
    assert host.get(1) is None and host.get(2) is not None
    host.put(4, page(4), page(4))  # 2 was just touched: 3 goes
    assert spilled == [1, 3]


def test_disk_pool_roundtrip_and_capacity(tmp_path):
    disk = DiskBlockPool(str(tmp_path), capacity_blocks=2)
    k1 = bf16_page(1)
    disk.put(1, k1, k1)
    got = disk.get(1)
    assert got is not None and got[0].dtype == np.uint16
    np.testing.assert_array_equal(got[0], k1)
    with np.load(tmp_path / "1.npz") as z:
        assert bytes(z["dtype"]).decode() == "bfloat16"
    disk.put(2, page(2), page(2))
    disk.put(3, page(3), page(3))  # 1 was hit: the cold 2 goes
    assert disk.get(2) is None
    assert disk.get(1) is not None
    assert len(disk) == 2
    disk2 = DiskBlockPool(str(tmp_path), capacity_blocks=2)  # adopts the files
    assert len(disk2) == 2 and disk2.get(3) is not None


def test_tier_stack_promotes_g3_to_g2(tmp_path):
    host = HostBlockPool(4)
    disk = DiskBlockPool(str(tmp_path), capacity_blocks=8)
    stack = TierStack(host, disk)
    disk.put(11, page(11), page(11))
    disk.put(12, page(12), page(12))
    run = stack.lookup_run([11, 12, 13])
    assert len(run) == 2
    assert host.contains(11) and host.contains(12)
    assert stack.stats()["onboarded_blocks"] == 2
    assert stack.peek_run_len([11, 12, 13]) == 2
    assert len(stack.read_run([12, 11])) == 2 and stack.stats()["onboarded_blocks"] == 2


def test_host_pool_protected_blocks_survive_churn():
    host = HostBlockPool(4)
    host.put(100, page(100), page(100), protected=True)
    for h in range(1, 9):
        host.put(h, page(h), page(h))
    assert host.contains(100), "protected block flushed by a one-off burst"
    assert host.protected_evictions >= 1
    assert host.get(100) is not None
    for h in range(20, 26):
        host.put(h, page(h), page(h))
    assert host.contains(100)
    for h in range(40, 80):  # no more hits: its credit decays, it ages out
        host.put(h, page(h), page(h))
    assert not host.contains(100)


def test_disk_pool_protected_and_counters(tmp_path):
    disk = DiskBlockPool(str(tmp_path), capacity_blocks=2)
    disk.put(1, page(1), page(1), protected=True)
    disk.put(2, page(2), page(2))
    disk.put(3, page(3), page(3))
    assert disk.contains(1) and not disk.contains(2)
    assert disk.protected_evictions >= 1


def test_tier_stack_protected_offload_and_hit_rate():
    host = HostBlockPool(2)
    stack = TierStack(host, None)
    stack.offload([(1, page(1), page(1)), (2, page(2), page(2))], protected=[True, False])
    stack.offload([(3, page(3), page(3))], protected=[False])
    assert host.contains(1) and not host.contains(2)
    assert stack.protected_evictions >= 1
    assert stack.lookup_run([1]) and not stack.lookup_run([2])
    s = stack.stats()
    assert s["protected_evictions"] >= 1 and 0.0 < s["hit_rate"] < 1.0


def test_tier_stack_offload_bound():
    stack = TierStack(HostBlockPool(1000), None)
    assert stack.offload([(i, page(i), page(i)) for i in range(100)]) == 64
    assert TierStack.MAX_OFFLOAD_PER_STEP == 64


def test_block_pool_fanout_protection():
    pool = BlockPool(num_blocks=16, block_size=4)
    ids, _ = pool.allocate_sequence([], 3)
    pool.register_block(ids[0], 100, None)
    pool.register_block(ids[1], 201, 100)
    assert pool.hash_fanout(100) == 1 and not pool.hash_protected(100)
    pool.register_block(ids[2], 202, 100)
    assert pool.hash_fanout(100) == 2 and pool.hash_protected(100)
    ids2, _ = pool.allocate_sequence([100], 1)
    assert ids2[0] == ids[0] and pool.hash_protected(201) is False
    pool.free_sequence(ids2)
    pool.free_sequence(ids)
    pool.clear()
    assert pool.hash_fanout(100) == 0 and not pool.hash_protected(100)


def test_host_pool_keeps_no_view_of_the_staging_buffer():
    """Offloaded blocks are slices of one batched host buffer: G2 owns a
    copy of each (the buffer is pinned staging memory on the card)."""
    batch = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    host = HostBlockPool(4)
    host.put(1, batch[:, 0:1], batch[:, 0:1])
    got = host.get(1)
    assert got[0].base is None and not np.shares_memory(got[0], batch)


# -- the engine --------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def request(prompt, max_tokens=4) -> dict:
    return {"model": "test-tiny", "token_ids": list(prompt),
            "sampling": {"temperature": 0.0, "seed": 0},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


async def stream(eng, req) -> list[int]:
    ctx = JContext() if isinstance(eng, TpuEngine) else Context()
    out = []
    async for item in eng.generate(req, ctx):
        out.extend(item.get("token_ids") or [])
    return out


def prompts(seed: int, n: int, length: int = 25) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size - 1, size=length).tolist() for _ in range(n)]


FIRST, CHURN = prompts(0, 3), prompts(1, 6)


async def workload(eng) -> dict:
    """Three prompts in one wave, six others one at a time (G1 holds 31
    blocks, so the first three leave it), then the first three again one
    at a time: → tokens, prefill counts and tier stats."""
    first = [asyncio.ensure_future(stream(eng, request(p))) for p in FIRST]
    await asyncio.sleep(0)
    await eng.start()
    try:
        out = {"first": await asyncio.gather(*first)}
        out["churn"] = [await stream(eng, request(p)) for p in CHURN]
        pre = eng.total_prefilled
        out["again"] = [await stream(eng, request(p)) for p in FIRST]
        out["again_prefilled"] = eng.total_prefilled - pre
        out["total_prefilled"] = eng.total_prefilled
        out["stats"] = eng.tiers.stats()
        return out
    finally:
        await eng.stop()


def port_engine(np_params, **kw) -> TorchEngine:
    return TorchEngine(EngineArgs(model=CFG, device="cpu", **{**ARGS, **kw}),
                       params=params_from_numpy(np_params, "cpu", torch.float32))


def jax_engine(np_params, **kw) -> TpuEngine:
    return TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **{**ARGS, **kw}), params=np_params)


def test_engine_onboards_evicted_prefix_instead_of_recompute(tmp_path, np_params):
    """tests/test_tiers.py's case on TorchEngine: prompt A leaves the tiny
    G1 pool, and its repeat onboards its 6 full blocks from G2, prefilling
    only the suffix token, with the same stream."""

    async def go():
        engine = await port_engine(
            np_params, num_kv_blocks=20, max_num_seqs=2, host_kv_blocks=64,
            disk_kv_dir=str(tmp_path)).start()
        A = prompts(2, 1)[0]
        try:
            first = await stream(engine, request(A))
            assert engine.tiers.offloaded_blocks >= 6
            for other in prompts(3, 6):
                await stream(engine, request(other))
            assert engine.prefix_hit_length(A) == 0
            prefilled, onboarded = engine.total_prefilled, engine.tiers.onboarded_blocks
            second = await stream(engine, request(A))
            assert second == first
            assert engine.tiers.onboarded_blocks - onboarded == 6
            assert engine.total_prefilled - prefilled == 25 - 24
            assert engine.onboard_bytes > 0 and engine.offload_bytes > 0
        finally:
            await engine.stop()

    asyncio.run(go())


@pytest.mark.parametrize("case", [
    dict(host_kv_blocks=64),
    dict(host_kv_blocks=8, disk="g3"),
    dict(host_kv_blocks=8, disk="g3", kv_quant="int8"),
], ids=["g2", "g2_g3", "g2_g3_int8"])
def test_port_tiers_match_jax(tmp_path, np_params, case):
    kw = dict(case)
    disk = kw.pop("disk", None)
    out = {}
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        if disk:
            kw["disk_kv_dir"] = str(tmp_path / name)
        out[name] = asyncio.run(workload(make(np_params, **kw)))
    port, ref = out["port"], out["jax"]
    for key in ("first", "churn", "again", "again_prefilled", "total_prefilled"):
        assert port[key] == ref[key], key
    assert port["again"] == port["first"]
    assert port["stats"] == ref["stats"]
    assert port["stats"]["onboarded_blocks"] > 0
    if disk:
        assert port["stats"]["g3_hits"] > 0 and port["stats"]["g3_blocks"] > 0
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
            sorted(p.name for p in (tmp_path / "jax").iterdir())
