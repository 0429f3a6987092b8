"""The port's forward pass vs the JAX package's, on the CPU (test-tiny).

JAX ``init_params`` → numpy → ``params_from_numpy``: both sides run the
same weights on the same numpy inputs. In float32 the two frameworks
differ only in matmul and reduction order, so logits and KV pages are
held to 1e-4 (absolute and relative) over two layers, and greedy tokens
must be equal. With int8 pages a value that lands within float error of
a rounding midpoint may quantize one step apart on the two sides (a ~1%
change of that element), so logits after reading such pages get 2e-3.
The bfloat16 bound is stated at ``test_bf16_within_bound``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine import sampler as JS
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine import sampler as TS
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.engine.weights import params_from_numpy, params_to_numpy

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
TOL_INT8 = dict(atol=2e-3, rtol=2e-3)
BS, N = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once on a few cores: these
    tiny shapes gain nothing from torch's intra-op thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[False, True], ids=["llama", "attn_bias"])
def models(request):
    jcfg, tcfg = JCfg(attn_bias=request.param), TCfg(attn_bias=request.param)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(np_params, CPU, torch.float32), np_params


def _caches(jcfg, tcfg, kv_quant="none"):
    j = JM.init_kv_cache(jcfg, N, BS, jnp.float32, kv_quant=kv_quant)
    t = TM.init_kv_cache(tcfg, N, BS, torch.float32, CPU, kv_quant=kv_quant)
    return j, t


def _assert_cache_equal(jcache, tcache):
    """Pages match everywhere but the garbage sink, block 0 (padded rows'
    duplicate writes land there in either order)."""
    for a, b in zip(jcache, tcache):
        if a is None:
            continue
        a, b = np.asarray(a)[:, 1:], b.numpy()[:, 1:]
        if a.dtype == np.int8:
            # A value within float error of a rounding midpoint may round
            # either way: int8 pages agree to one step.
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(a, b, **TOL)


def _prefill_inputs():
    tokens = np.zeros((2, 16), np.int32)
    tokens[0, :13] = np.arange(1, 14)
    tokens[1, :9] = np.arange(40, 49)
    tables = np.zeros((2, 8), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :3] = [5, 6, 7]
    return tokens, tables, np.array([0, 0], np.int32), np.array([13, 9], np.int32)


def _prefill_both(models, kv_quant="none"):
    jcfg, tcfg, jparams, tparams, _ = models
    jcache, tcache = _caches(jcfg, tcfg, kv_quant)
    toks, tables, starts, tlens = _prefill_inputs()
    jl, jcache = JM.prefill_batch(jcfg, jparams, jcache, jnp.asarray(toks), jnp.asarray(tables),
                                  jnp.asarray(starts), jnp.asarray(tlens))
    tl = TM.prefill_batch(tcfg, tparams, tcache, torch.from_numpy(toks), torch.from_numpy(tables),
                          torch.from_numpy(starts), torch.from_numpy(tlens))
    return jl, jcache, tl, tcache, tables


def test_params_round_trip(models):
    _, _, _, tparams, np_params = models
    back = params_to_numpy(tparams)
    flat = jax.tree.leaves(np_params)
    assert len(flat) == len(jax.tree.leaves(back))
    for a, b in zip(flat, jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_prefill_batch_matches_jax(models, kv_quant):
    jl, jcache, tl, tcache, _ = _prefill_both(models, kv_quant)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(jcache, tcache)


def test_prefix_cached_prefill_matches_jax(models):
    """Chunked prefill: positions [8, 13) of row 0 over its cached prefix."""
    jcfg, tcfg, jparams, tparams, _ = models
    jl, jcache, tl, tcache, tables = _prefill_both(models)
    toks = np.zeros((8,), np.int32)
    toks[:5] = [60, 61, 62, 63, 64]
    jl2, jcache = JM.prefill(jcfg, jparams, jcache, jnp.asarray(toks), jnp.asarray(tables[0]),
                             jnp.int32(8), jnp.int32(13))
    tl2 = TM.prefill(tcfg, tparams, tcache, torch.from_numpy(toks), torch.from_numpy(tables[0]), 8, 13)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    _assert_cache_equal(jcache, tcache)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_decode_step_matches_jax(models, kv_quant):
    jcfg, tcfg, jparams, tparams, _ = models
    jl, jcache, tl, tcache, tables = _prefill_both(models, kv_quant)
    B = 4  # two live rows + two padding rows
    tok = np.zeros((B,), np.int32)
    tok[:2] = np.asarray(jl).argmax(-1)
    pos = np.array([13, 9, 0, 0], np.int32)
    tab = np.zeros((B, 8), np.int32)
    tab[:2] = tables
    active = np.array([True, True, False, False])
    jd, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
                                jnp.asarray(tab), jnp.asarray(active), attn_impl="xla")
    td = TM.decode_step(tcfg, tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
                        torch.from_numpy(tab), torch.from_numpy(active))
    tol = TOL_INT8 if kv_quant == "int8" else TOL
    np.testing.assert_allclose(td.numpy()[:2], np.asarray(jd)[:2], **tol)
    _assert_cache_equal(jcache, tcache)


def test_multi_decode_greedy_matches_jax(models):
    jcfg, tcfg, jparams, tparams, _ = models
    jl, jcache, tl, tcache, tables = _prefill_both(models)
    K, B = 6, 2
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    pos = np.array([13, 9], np.int32)
    active = np.ones((B,), bool)
    zf, zi = np.zeros((B,), np.float32), np.zeros((B,), np.int32)
    jt, jlp, _, _, jcache = JM.multi_decode(
        jcfg, K, "greedy", 0, jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(tables), jnp.asarray(active), jnp.asarray(zf), jnp.asarray(zi, jnp.uint32),
        jnp.asarray(zi), jnp.asarray(zi), jnp.ones((B,), jnp.float32), jnp.asarray(zf),
        jnp.asarray(zf), jnp.full((B, 1), -1, jnp.int32), attn_impl="xla",
    )
    tt, tlp, _, _ = TM.multi_decode(
        tcfg, K, "greedy", 0, tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
        torch.from_numpy(tables), torch.from_numpy(active), torch.from_numpy(zf), [0, 0], [0, 0],
    )
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **TOL)
    _assert_cache_equal(jcache, tcache)


def test_sample_simple_with_shared_noise(models):
    """Same logits and the same numpy Gumbel noise through the port's
    sample_simple and the JAX sampler's noise-taking core (sample_step
    with top-k and top-p off): the same tokens, greedy rows included."""
    rng = np.random.default_rng(9)
    B, V = 6, models[1].vocab_size
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    noise = rng.gumbel(size=(B, V)).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 1e-6, 1.3, 0.5], np.float32)
    port = TS.sample_simple(torch.from_numpy(logits), torch.from_numpy(temps),
                            torch.from_numpy(noise)).numpy()
    jax_tok = np.asarray(JS.sample_step(
        jnp.asarray(logits), jnp.asarray(temps), jnp.zeros((B,), jnp.int32),
        jnp.ones((B,), jnp.float32), jnp.asarray(noise),
    ))
    np.testing.assert_array_equal(port, jax_tok)
    greedy = temps < TS.GREEDY_EPS
    np.testing.assert_array_equal(port[greedy], logits[greedy].argmax(-1))
    lp = TS.token_logprobs(torch.from_numpy(logits), torch.from_numpy(port)).numpy()
    np.testing.assert_allclose(lp, np.asarray(JS.token_logprobs(jnp.asarray(logits), jnp.asarray(port))),
                               **TOL)
    tv, ti = TS.top_k_logprobs(torch.from_numpy(logits), 3)
    jv, ji = JS.top_k_logprobs(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_row_gumbel_is_seeded_per_row_and_step():
    a = TS.row_gumbel(torch.tensor([5, 5, 6]), torch.tensor([0, 1, 0]), 64)
    b = TS.row_gumbel(torch.tensor([6, 5]), torch.tensor([0, 1]), 64)
    assert torch.equal(a[2], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1])
    assert torch.isfinite(a).all()


def test_bf16_within_bound(models):
    """bfloat16 weights and activations on both sides, each held against
    the float32 JAX logits. Bound: 0.15 absolute on logits of unit scale
    (std ~1) — bf16 keeps 8 significant bits (2^-9 relative per rounding),
    and two layers of residual adds, norms and matmuls over width 128-256
    compound a few dozen such roundings. The port must also stay within
    the JAX bf16 run's own error times two."""
    jcfg, tcfg, jparams, _, np_params = models
    toks, tables, starts, tlens = _prefill_inputs()
    jcache, _ = _caches(jcfg, tcfg)
    ref, _ = JM.prefill_batch(jcfg, jparams, jcache, jnp.asarray(toks), jnp.asarray(tables),
                              jnp.asarray(starts), jnp.asarray(tlens))
    ref = np.asarray(ref)
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), np_params)
    jc16 = JM.init_kv_cache(jcfg, N, BS, jnp.bfloat16)
    j16, _ = JM.prefill_batch(jcfg, jp16, jc16, jnp.asarray(toks), jnp.asarray(tables),
                              jnp.asarray(starts), jnp.asarray(tlens))
    tp16 = params_from_numpy(np_params, CPU, torch.bfloat16)
    tc16 = TM.init_kv_cache(tcfg, N, BS, torch.bfloat16, CPU)
    t16 = TM.prefill_batch(tcfg, tp16, tc16, torch.from_numpy(toks), torch.from_numpy(tables),
                           torch.from_numpy(starts), torch.from_numpy(tlens)).numpy()
    jerr = np.abs(np.asarray(j16) - ref).max()
    terr = np.abs(t16 - ref).max()
    assert terr <= 0.15 and jerr <= 0.15, (terr, jerr)
    assert terr <= 2 * jerr + 0.02, (terr, jerr)


def test_random_int8_init_refuses_moe():
    """The random int8 init has no expert stacks, in either package: both
    refuse a MoE config (int8 MoE trees come from quantize_params_np,
    with float experts; tests/test_torch_moe.py)."""
    from dynamo_tpu.engine import quant as JQ
    from dynamo_tpu_torch.engine import quant as TQ

    with pytest.raises(NotImplementedError):
        TQ.random_int8_params_device(TCfg.preset("moe-tiny"), CPU)
    with pytest.raises(NotImplementedError):
        JQ.random_int8_params(JCfg.preset("moe-tiny"))


def test_local_runner_dispatches_match_model(models):
    """LocalRunner turns host arrays into the same device calls the model
    functions make directly (its own cache, same weights)."""
    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.runner import LocalRunner

    _, tcfg, _, tparams, _ = models
    runner = LocalRunner(EngineArgs(model=tcfg, block_size=BS, num_kv_blocks=N, dtype="float32",
                                    device="cpu"), params=tparams)
    runner.start()
    _, tcache = _caches(JCfg(), tcfg)
    toks, tables, starts, tlens = _prefill_inputs()
    want = TM.prefill_batch(tcfg, tparams, tcache, torch.from_numpy(toks), torch.from_numpy(tables),
                            torch.from_numpy(starts), torch.from_numpy(tlens))
    got = runner.prefill_batch(toks, tables, starts, tlens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    first = got.argmax(-1).to(torch.int32).numpy()
    pos, active = np.array([13, 9], np.int32), np.ones((2,), bool)
    step = runner.decode_step(first, pos, tables, active)
    want_step = TM.decode_step(tcfg, tparams, tcache, torch.from_numpy(first), torch.from_numpy(pos),
                               torch.from_numpy(tables), torch.from_numpy(active))
    torch.testing.assert_close(step, want_step, rtol=0, atol=0)
    zi, zf, pen = np.zeros(2, np.int32), np.zeros(2, np.float32), np.full((2, 1), -1, np.int32)
    ref = runner.sample_rows([step[0], step[1]], "greedy", zf, zi, zf + 1, pen, zf, zf, zi, zi,
                             np.array([0, 1], np.int32))
    toks_s, logps_s = ref.arrs[0].numpy(), ref.arrs[1].numpy()
    np.testing.assert_array_equal(toks_s, step.argmax(-1).numpy())
    assert np.all(logps_s <= 0)
    # The next window chains both rows from the folded samples.
    out = runner.multi_decode(3, "greedy", np.zeros(2, np.int32), ([0, 1], [0, 1]), pos + 1,
                              tables, active, zf, zi, zi + 1, zi, zf + 1, zf, zf, pen,
                              np.array([0, 1], np.int32), top_n=2).arrs
    assert out[0].shape == (3, 2) and out[2].shape == (3, 2, 2) and out[3].dtype == torch.int32
    want = TM.multi_decode(tcfg, 3, "greedy", 2, tparams, tcache, torch.from_numpy(toks_s),
                           torch.from_numpy(pos + 1), torch.from_numpy(tables),
                           torch.from_numpy(active), torch.from_numpy(zf), None, None)
    for g, w in zip(out, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    chunk = runner.prefill_chunk(np.arange(1, 9, dtype=np.int32), np.array([20, 21], np.int32), 0, 8)
    assert chunk.shape == (tcfg.vocab_size,)
