"""Multi-LoRA in the port against the JAX package's, on the CPU (test-tiny).

- ``engine/lora.py``: ``make_adapter_pages``, ``adapter_tier_hash``,
  ``bank_shapes`` and ``adapter_bank_bytes`` equal the JAX module's byte
  for byte and value for value (the port's pure-Python ``xxh3_64`` seeds
  numpy's generator as xxhash does).
- ``block_manager/adapters.py``: the slot pool's answers and stats equal
  the JAX pool's over one seeded sequence of acquires, releases and drops.
- ``model._lora_apply`` against JAX's on decode ``[B, in]`` and verify
  ``[B, T, in]`` inputs whose slots mix -1 and live slots: within 1e-5 in
  float32, and every base row bit-equal to ``y`` (a -0.0 stays -0.0).
- The forward passes with an adapter bank and mixed slots — prefill,
  decode step, a greedy window, and verify (linear fused, stepwise, tree)
  — against JAX's on the same weights, bank and inputs: tokens equal,
  logits, logprobs and KV pages within 1e-4 (the forward pass's float32
  tolerance, tests/test_torch_model.py).
- ``LocalRunner.upload_adapter`` writes the bank in place, rounding to
  bfloat16 as JAX's ``jnp.asarray(page, bfloat16)`` does.
- ``EngineArgs`` and the worker's ``--lora`` parser refuse what the JAX
  ones refuse, with the same messages; ``adapter_cards`` are the JAX
  worker's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.block_manager.adapters import AdapterSlotPool as JPool
from dynamo_tpu.engine import lora as JL
from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.worker import __main__ as JW
from dynamo_tpu_torch.block_manager.adapters import AdapterSlotPool as TPool
from dynamo_tpu_torch.block_manager.adapters import NoFreeAdapterSlotsError
from dynamo_tpu_torch.block_manager.pool import NoFreeBlocksError
from dynamo_tpu_torch.engine import lora as TL
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.worker import __main__ as TW

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
SLOTS, RANK = 3, 4
SPECS = [("tenant-a", 4, 7), ("tenant-b", 2, 11)]  # (name, rank, seed) in slots 0 and 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


@pytest.fixture(scope="module")
def banks():
    """The same float32 bank on both sides: slot 0 tenant-a (rank 4), slot 1
    left zero, slot 2 tenant-b (rank 2, zero-padded)."""
    shapes = JL.bank_shapes(JCfg(), SLOTS, RANK)
    bank = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    for slot, (name, rank, seed) in zip((0, 2), SPECS):
        pages = JL.make_adapter_pages(JCfg(), JL.LoraAdapterSpec(name, rank, seed), RANK)
        for key, page in zip(JL.LORA_PAGE_KEYS, pages):
            bank[key][:, slot] = page
    return ({k: jnp.asarray(v) for k, v in bank.items()},
            {k: torch.from_numpy(v.copy()) for k, v in bank.items()})


# -- host modules ---------------------------------------------------------------


@pytest.mark.parametrize("name,rank,seed,scaling,targets", [
    ("tenant-a", 4, 7, 1.0, "qkvo"), ("tenant-b", 2, 11, 0.5, "qkvo"),
    ("only-qv", 3, 0, 2.0, "qv"), ("ünïcode/名前", 4, 2**40 + 3, 1.0, "ko"),
])
def test_adapter_pages_byte_equal(name, rank, seed, scaling, targets):
    jspec = JL.LoraAdapterSpec(name, rank, seed, scaling, targets)
    tspec = TL.LoraAdapterSpec(name, rank, seed, scaling, targets)
    for cfg_kw in ({}, {"attn_bias": True, "num_kv_heads": 1}):
        jp = JL.make_adapter_pages(JCfg(**cfg_kw), jspec, RANK)
        tp = TL.make_adapter_pages(ModelConfig(**cfg_kw), tspec, RANK)
        assert len(jp) == len(tp) == len(TL.LORA_PAGE_KEYS) == 8
        for a, b in zip(jp, tp):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    with pytest.raises(TL.LoraError, match=f"exceeds the bank's lora_rank={rank - 1}"):
        TL.make_adapter_pages(ModelConfig(), tspec, rank - 1)


@pytest.mark.parametrize("name", ["tenant-a", "", "x" * 300, "ünïcode/名前"])
def test_adapter_tier_hash_equal(name):
    assert TL.adapter_tier_hash(name) == JL.adapter_tier_hash(name)


@pytest.mark.parametrize("preset,slots,rank", [("test-tiny", 3, 4), ("llama-8b", 4, 16),
                                               ("llama-3b", 2, 8)])
def test_bank_shapes_and_bytes_equal(preset, slots, rank):
    assert TL.bank_shapes(ModelConfig.preset(preset), slots, rank) == \
        JL.bank_shapes(JCfg.preset(preset), slots, rank)
    for itemsize in (2, 4):
        assert TL.adapter_bank_bytes(ModelConfig.preset(preset), slots, rank, itemsize) == \
            JL.adapter_bank_bytes(JCfg.preset(preset), slots, rank, itemsize)
    assert TL.LORA_TARGETS == JL.LORA_TARGETS and TL.LORA_PAGE_KEYS == JL.LORA_PAGE_KEYS


def test_slot_pool_equals_jax_over_a_seeded_sequence():
    rng = np.random.default_rng(3)
    jp, tp = JPool(3), TPool(3)
    pins: list[str] = []
    for _ in range(400):
        op = rng.integers(0, 4)
        aid = f"a{rng.integers(0, 7)}"
        if op <= 1:
            outs = []
            for pool in (jp, tp):
                try:
                    outs.append(pool.acquire(aid))
                except Exception as e:  # noqa: BLE001 — both must raise alike
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1]
            if isinstance(outs[1], tuple):
                pins.append(aid)
        elif op == 2 and pins:
            aid = pins.pop(int(rng.integers(0, len(pins))))
            jp.release(aid)
            tp.release(aid)
        elif op == 3 and rng.random() < 0.1:
            jp.drop(aid)
            tp.drop(aid)
            pins = [p for p in pins if p != aid]
        assert jp.stats() == tp.stats() and jp.resident_ids() == tp.resident_ids()
    assert tp.stats()["evictions"] > 0 and tp.stats()["protected_scans"] > 0
    assert issubclass(NoFreeAdapterSlotsError, NoFreeBlocksError)


# -- the delta --------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5,), (4, 6)], ids=["decode", "verify"])
def test_lora_apply_matches_jax(shape, banks):
    jbank, tbank = banks
    rng = np.random.default_rng(1)
    B = 5 if len(shape) == 1 else 4
    d, q = JCfg().hidden_size, JCfg().q_size
    h = rng.standard_normal((*shape, d)).astype(np.float32)
    y = rng.standard_normal((*shape, q)).astype(np.float32)
    y[0, ...] = -0.0  # a base row of negative zeros must stay so
    slots = np.array([-1, 0, 2, 1, -1][:B], np.int32)
    layer = 1
    j = JM._lora_apply(jnp.asarray(y), jnp.asarray(h), jbank["qa"][layer], jbank["qb"][layer],
                       jnp.asarray(slots))
    t = TM._lora_apply(torch.from_numpy(y), torch.from_numpy(h), tbank["qa"][layer],
                       tbank["qb"][layer], TM._lora_rows(tbank, torch.from_numpy(slots)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)
    for r in np.nonzero(slots < 0)[0]:
        assert t[r].numpy().tobytes() == y[r].tobytes()
    assert torch.signbit(t[0]).all()
    # A live row moves; slot 1 is all zeros, so its row comes back equal.
    assert not np.array_equal(t[1].numpy(), y[1])
    np.testing.assert_array_equal(t[3].numpy(), y[3])


def test_lora_apply_bf16_rounds_as_jax(banks):
    """In bfloat16 the two batched products round the intermediate to the
    activation dtype, as JAX's einsums do; the results agree to a bf16
    step and base rows are untouched."""
    jbank, tbank = banks
    rng = np.random.default_rng(2)
    h = rng.standard_normal((4, JCfg().hidden_size)).astype(np.float32)
    y = rng.standard_normal((4, JCfg().kv_size)).astype(np.float32)
    slots = np.array([0, -1, 2, 0], np.int32)
    j = JM._lora_apply(jnp.asarray(y, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16),
                       jbank["ka"][0].astype(jnp.bfloat16), jbank["kb"][0].astype(jnp.bfloat16),
                       jnp.asarray(slots))
    t = TM._lora_apply(torch.from_numpy(y).bfloat16(), torch.from_numpy(h).bfloat16(),
                       tbank["ka"][0].bfloat16(), tbank["kb"][0].bfloat16(),
                       TM._lora_rows(tbank, torch.from_numpy(slots)))
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                               atol=2e-2, rtol=2 ** -7)
    assert torch.equal(t[1], torch.from_numpy(y[1]).bfloat16())


# -- forward passes with a bank -----------------------------------------------------


def _models(np_params):
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jparams, params_from_numpy(np_params, CPU, torch.float32)


def _prefilled(np_params, banks, kv_quant="none"):
    """Three rows prefilled with slots [0, -1, 2] on both sides → the
    models, caches, tables, first tokens and the prefill logits."""
    jbank, tbank = banks
    jparams, tparams = _models(np_params)
    jcache = JM.init_kv_cache(JCfg(), 32, 4, jnp.float32, kv_quant=kv_quant)
    tcache = TM.init_kv_cache(ModelConfig(), 32, 4, torch.float32, CPU, kv_quant=kv_quant)
    toks = np.zeros((3, 16), np.int32)
    lens = np.array([13, 9, 6], np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = np.arange(1 + 40 * r, 1 + 40 * r + n)
    tables = np.zeros((4, 8), np.int32)
    tables[0, :6], tables[1, :5], tables[2, :4] = range(1, 7), range(7, 12), range(12, 16)
    slots = np.array([0, -1, 2], np.int32)
    jl, jcache = JM.prefill_batch(JCfg(), jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(tables[:3]), jnp.zeros((3,), jnp.int32),
                                  jnp.asarray(lens), jbank, jnp.asarray(slots))
    tl = TM.prefill_batch(ModelConfig(), tparams, tcache, torch.from_numpy(toks),
                          torch.from_numpy(tables[:3]), torch.zeros((3,), dtype=torch.int32),
                          torch.from_numpy(lens), tbank, torch.from_numpy(slots))
    return jparams, tparams, jcache, tcache, tables, np.asarray(jl), tl


def _pages_close(jcache, tcache):
    for a, b in zip(jcache, tcache):
        if a is None:
            continue
        a, b = np.asarray(a)[:, 1:], b.numpy()[:, 1:]
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_prefill_and_decode_step_match_jax(np_params, banks, kv_quant):
    jparams, tparams, jcache, tcache, tables, jl, tl = _prefilled(np_params, banks, kv_quant)
    tol = TOL if kv_quant == "none" else dict(atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    tok = np.append(jl.argmax(-1), 0).astype(np.int32)
    pos = np.array([13, 9, 6, 0], np.int32)
    active = np.array([True, True, True, False])
    slots = np.array([0, -1, 2, -1], np.int32)
    jbank, tbank = banks
    jd, jcache = JM.decode_step(JCfg(), jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
                                jnp.asarray(tables), jnp.asarray(active), jbank,
                                jnp.asarray(slots), attn_impl="xla")
    td = TM.decode_step(ModelConfig(), tparams, tcache, torch.from_numpy(tok),
                        torch.from_numpy(pos), torch.from_numpy(tables),
                        torch.from_numpy(active), lora=tbank, adapter_slots=torch.from_numpy(slots))
    np.testing.assert_allclose(td.numpy()[:3], np.asarray(jd)[:3], **tol)
    _pages_close(jcache, tcache)


def test_base_rows_bit_equal_to_the_pre_lora_forward(np_params, banks):
    """A base row in a mixed dispatch equals the same row of a dispatch
    with no bank byte for byte (the where-masked delta), in prefill and
    decode."""
    _, tbank = banks
    _, tparams = _models(np_params)
    outs = []
    for lora in (False, True):
        cache = TM.init_kv_cache(ModelConfig(), 32, 4, torch.float32, CPU)
        toks = torch.zeros((2, 16), dtype=torch.int32)
        toks[0, :13], toks[1, :9] = torch.arange(1, 14), torch.arange(40, 49)
        tables = torch.zeros((2, 8), dtype=torch.int32)
        tables[0, :4], tables[1, :3] = torch.arange(1, 5), torch.arange(5, 8)
        kw = dict(lora=tbank, adapter_slots=torch.tensor([-1, 2], dtype=torch.int32)) \
            if lora else {}
        logits = TM.prefill_batch(ModelConfig(), tparams, cache, toks, tables,
                                  torch.zeros((2,), dtype=torch.int32),
                                  torch.tensor([13, 9], dtype=torch.int32), **kw)
        step = TM.decode_step(ModelConfig(), tparams, cache, torch.tensor([5, 6], dtype=torch.int32),
                              torch.tensor([13, 9], dtype=torch.int32), tables,
                              torch.tensor([True, True]), **kw)
        outs.append((logits, step, cache.k[:, 1:5].clone()))
    (l0, s0, k0), (l1, s1, k1) = outs
    assert l0[0].numpy().tobytes() == l1[0].numpy().tobytes()
    assert s0[0].numpy().tobytes() == s1[0].numpy().tobytes()
    assert k0.numpy().tobytes() == k1.numpy().tobytes()   # row 0's pages
    assert not torch.equal(l0[1], l1[1])                   # the adapter row moved


def test_greedy_window_matches_jax(np_params, banks):
    jparams, tparams, jcache, tcache, tables, jl, _ = _prefilled(np_params, banks)
    jbank, tbank = banks
    K, B = 5, 4
    tok = np.append(jl.argmax(-1), 0).astype(np.int32)
    pos = np.array([13, 9, 6, 0], np.int32)
    active = np.array([True, True, True, False])
    slots = np.array([0, -1, 2, -1], np.int32)
    zf, zi = np.zeros((B,), np.float32), np.zeros((B,), np.int32)
    jt, jlp, _, _, jcache = JM.multi_decode(
        JCfg(), K, "greedy", 0, jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(tables), jnp.asarray(active), jnp.asarray(zf), jnp.asarray(zi, jnp.uint32),
        jnp.asarray(zi), jnp.asarray(zi), jnp.ones((B,), jnp.float32), jnp.asarray(zf),
        jnp.asarray(zf), jnp.full((B, 1), -1, jnp.int32), None, None, None, jbank,
        jnp.asarray(slots), attn_impl="xla")
    tt, tlp, _, _ = TM.multi_decode(
        ModelConfig(), K, "greedy", 0, tparams, tcache, torch.from_numpy(tok),
        torch.from_numpy(pos), torch.from_numpy(tables), torch.from_numpy(active),
        torch.from_numpy(zf), [0] * B, [0] * B, lora=tbank, adapter_slots=torch.from_numpy(slots))
    np.testing.assert_array_equal(tt.numpy()[:, :3], np.asarray(jt)[:, :3])
    np.testing.assert_allclose(tlp.numpy()[:, :3], np.asarray(jlp)[:, :3], **TOL)
    _pages_close(jcache, tcache)


@pytest.mark.parametrize("kind", ["fused", "stepwise", "tree"])
def test_verify_pass_with_adapter_rows_matches_jax(np_params, banks, kind):
    jparams, tparams, jcache, tcache, tables, jl, _ = _prefilled(np_params, banks)
    jbank, tbank = banks
    S1 = 4
    tokens = np.zeros((4, S1), np.int32)
    tokens[:3, 0] = jl.argmax(-1)
    tokens[:3, 1:] = np.array([[7, 8, 9], [17, 18, 19], [27, 28, 29]])
    tree = None
    if kind == "tree":
        parents = np.tile(np.array([0, 0, 0, 1], np.int32), (4, 1))
        anc = np.zeros((4, S1, S1), np.int8)
        depth = np.tile(np.array([0, 1, 1, 2], np.int32), (4, 1))
        for j, p in enumerate([0, 0, 0, 1]):
            anc[:, j] = anc[:, p]
            anc[:, j, j] = 1
        tree = (parents, anc, depth)
    positions0 = np.array([13, 9, 6, 0], np.int32)
    draft_len = np.array([3, 3, 2, 0], np.int32)
    active = np.array([True, True, True, False])
    temps = np.array([0.0, 0.9, 0.0, 0.0], np.float32)
    seeds = np.array([5, 6, 7, 0], np.uint32)
    steps0 = np.array([1, 2, 3, 0], np.int32)
    slots = np.array([2, 0, -1, -1], np.int32)
    args = (tokens, positions0, draft_len, tables, active, temps, seeds, steps0)
    fused = kind != "stepwise"
    j = JM.spec_verify(JCfg(), S1, "simple", 2, jparams, jcache, *map(jnp.asarray, args),
                       *((jnp.asarray(a) for a in tree) if tree else (None,) * 3), None,
                       jbank, jnp.asarray(slots), fused=fused, attn_impl="xla")
    targs = (tokens, positions0, draft_len, tables, active, temps, seeds.astype(np.int64), steps0)
    t = TM.spec_verify(ModelConfig(), S1, "simple", 2, tparams, tcache,
                       *map(torch.from_numpy, targs),
                       *((torch.from_numpy(a) for a in tree) if tree else (None,) * 3), None,
                       tbank, torch.from_numpy(slots), fused=fused)
    n = np.asarray(j[1])[:3]
    np.testing.assert_array_equal(t[1].numpy()[:3], n)
    for r in range(3):
        np.testing.assert_array_equal(t[0].numpy()[r, :n[r]], np.asarray(j[0])[r, :n[r]])
        np.testing.assert_allclose(t[2].numpy()[r, :n[r]], np.asarray(j[2])[r, :n[r]], **TOL)
        np.testing.assert_allclose(t[4].numpy()[r, :n[r]], np.asarray(j[4])[r, :n[r]], **TOL)
    np.testing.assert_array_equal(t[6].numpy()[:3], np.asarray(j[6])[:3])
    _pages_close(j[7], tcache)


# -- the runner's bank ---------------------------------------------------------------


def test_upload_adapter_writes_the_bank_in_place():
    args = EngineArgs(model=ModelConfig(), device="cpu", dtype="bfloat16", block_size=4,
                      num_kv_blocks=16, max_num_seqs=4, max_model_len=64, lora_slots=3,
                      lora_rank=RANK)
    runner = LocalRunner(args, seed=0)
    runner.start()
    assert set(runner.lora_bank) == set(TL.LORA_PAGE_KEYS)
    ptrs = {k: v.data_ptr() for k, v in runner.lora_bank.items()}
    pages = TL.make_adapter_pages(ModelConfig(), TL.LoraAdapterSpec("tenant-a", 4, 7), RANK)
    runner.upload_adapter(1, pages)
    jbank = {k: jnp.zeros(s, jnp.bfloat16) for k, s in JL.bank_shapes(JCfg(), 3, RANK).items()}
    for key, page in zip(JL.LORA_PAGE_KEYS, pages):
        jbank[key] = jbank[key].at[:, 1].set(jnp.asarray(page, jnp.bfloat16))
    for key, t in runner.lora_bank.items():
        assert t.data_ptr() == ptrs[key] and t.dtype == torch.bfloat16
        want = np.asarray(jbank[key].astype(jnp.float32))
        np.testing.assert_array_equal(t.float().numpy(), want)
    assert runner.adapter_uploads == 1
    # No bank: uploads and adapter slots are refused.
    bare = LocalRunner(EngineArgs(model=ModelConfig(), device="cpu", dtype="float32",
                                  block_size=4, num_kv_blocks=16, max_num_seqs=4,
                                  max_model_len=64), seed=0)
    bare.start()
    assert bare.lora_bank is None
    with pytest.raises(ValueError, match="lora_slots == 0"):
        bare.upload_adapter(0, pages)
    with pytest.raises(ValueError, match="lora_slots == 0"):
        bare.prefill_chunk(np.arange(1, 5, dtype=np.int32), np.array([1], np.int32), 0, 4, 0)


# -- configuration and the worker's flags ----------------------------------------------


@pytest.mark.parametrize("kw", [dict(lora_slots=-1), dict(lora_slots=2, lora_rank=0),
                                dict(lora_slots=2, lora_rank=-3)])
def test_engine_args_refuse_as_jax(kw):
    with pytest.raises(ValueError) as je:
        JArgs(model=JCfg(), **kw)
    with pytest.raises(ValueError) as te:
        EngineArgs(model=ModelConfig(), **kw)
    assert str(te.value) == str(je.value)
    assert EngineArgs(model=ModelConfig()).lora_slots == JArgs(model=JCfg()).lora_slots == 0
    assert EngineArgs(model=ModelConfig()).lora_rank == JArgs(model=JCfg()).lora_rank == 8


@pytest.mark.parametrize("entries", [["a"], ["a:4", "b:2:9", "c::5"], ["a:x"], [":3"],
                                     ["a:1:y"], ["name-with-dash:16:0"]])
def test_parse_lora_specs_as_jax(entries):
    def run(mod):
        try:
            return mod.parse_lora_specs(entries, 8)
        except ValueError as e:
            return f"error: {e}"

    assert run(TW) == run(JW)


@pytest.mark.parametrize("argv,err", [
    (["--lora", "a"], "--lora requires --lora-slots > 0"),
    (["--lora-slots", "2", "--lora", "a:x"], "RANK and SEED must be integers"),
    (["--lora-slots", "2", "--lora", ":4"], "empty adapter name"),
])
def test_worker_parser_errors(argv, err, capsys):
    with pytest.raises(SystemExit):
        TW.parse_args(argv)
    assert err in capsys.readouterr().err


def test_worker_flags_and_adapter_cards():
    ns = TW.parse_args(["--lora-slots", "4", "--lora-rank", "8", "--lora", "a:16:3",
                        "--lora", "b"])
    assert ns.lora_specs == [("a", 16, 3), ("b", 8, 0)]
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard

    tcards = TW.adapter_cards(TCard(name="base", kv_cache_block_size=4), ns.lora_specs)
    jcards = JW.adapter_cards(JCard(name="base", kv_cache_block_size=4), ns.lora_specs)
    assert [c.to_dict() for c in tcards] == [c.to_dict() for c in jcards]
    assert [c.name for c in tcards] == ["a", "b"]
