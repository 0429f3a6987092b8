"""Weight-only int8: the port against the JAX package, on the CPU.

- The host quantizers (``quantize_np``, ``quantize_layer_stacks_np``,
  ``quantize_params_np``) are bit-equal to the JAX package's, half-way
  ties (round half to even) and all-zero channels (scale 1.0) included.
- ``_dot_q``, ``_embed_rows`` and ``_logits`` with int8 leaves against the
  JAX functions, tied and untied heads. float32: 1e-5 (absolute and
  relative; only the summation order of one product differs). bfloat16:
  both round ``x @ w`` to bfloat16, and the two sums, taken in different
  orders, may round one bfloat16 step apart before the scale multiplies
  it, so values agree to 2^-7 relative to their size plus 1e-6 absolute.
- ``prefill_batch``, ``decode_step`` and ``multi_decode`` ("greedy",
  "simple") at test-tiny in float32 with an int8 tree: logits to 1e-4,
  KV pages to 1e-4 (float pages) or one int8 step (int8 pages), tokens
  equal (the forward pass's float32 tolerance, tests/test_torch_model.py).
- ``TorchEngine`` against ``TpuEngine`` at ``quant="int8"`` on the same
  int8 tree, greedy and seeded sampled requests, KV pages float and int8,
  the port at depths 0 and 2: tokens equal, logprobs to 1e-4 (2e-3 after
  int8 pages, whose rounding may differ by one step at a midpoint).
- The runner's int8 start: random int8 made on the device with the JAX
  tree's leaves, shapes and dtypes; numpy float params quantized on the
  host; float device params refused with the JAX package's error.
- ``params_from_numpy`` keeps an int8 tree's f32 scales beside bf16 norms.

test-tiny, every request seeded.
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
from dynamo_tpu_torch.engine import quant as TQ
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.ops import int8_matmul as im

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
TOL_INT8 = dict(atol=2e-3, rtol=2e-3)
TOL_F32_OP = dict(atol=1e-5, rtol=1e-5)
TOL_BF16_OP = dict(atol=1e-6, rtol=2.0 ** -7)
BS, N = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(cfg: JCfg, seed: int = 0):
    return jax.tree.map(np.array, JM.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32))


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def int8_models(request):
    jcfg = JCfg(tie_embeddings=request.param)
    tcfg = ModelConfig(tie_embeddings=request.param)
    q = JQ.quantize_params_np(_np_tree(jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, q), params_from_numpy(q, CPU, torch.float32), q


# -- host quantizers ----------------------------------------------------------


def _awkward(rng, shape):
    """Values with exact half-way ties after scaling and all-zero channels."""
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0                                      # an all-zero output channel
    w[..., 1] = 0.0
    w[..., 1].flat[0] = 127.0                            # scale exactly 1.0 ...
    w[..., 1].flat[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]    # ... and ties at .5
    return w


def test_quantizers_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    w = _awkward(rng, (3, 16, 8))
    for axis in (-1, 0, 1):
        jq, js = JQ.quantize_np(w, axis=axis)
        tq, ts = TQ.quantize_np(w, axis=axis)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ts, js)
        assert tq.dtype == np.int8 and ts.dtype == np.float32
    q, s = TQ.quantize_np(w[0], axis=-1)
    assert s[0] == 1.0 and (q[:, 0] == 0).all()
    assert s[1] == 1.0 and q[1:6, 1].tolist() == [0, 2, 2, -0, -2]  # half to even
    layers = {"wq": w, "w_down": _awkward(rng, (3, 8, 16)), "attn_norm": np.ones((3, 16), np.float32)}
    jl, tl = JQ.quantize_layer_stacks_np(layers), TQ.quantize_layer_stacks_np(layers)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])
        assert tl[k].dtype == jl[k].dtype
    for tied in (True, False):
        tree = _np_tree(JCfg(tie_embeddings=tied, attn_bias=True), seed=3)
        tree["layers"]["wk"][0, :, 2] = 0.0
        jt, tt = JQ.quantize_params_np(tree), TQ.quantize_params_np(tree)
        assert jax.tree.structure(jt) == jax.tree.structure(tt)
        for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(tt)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def awkward_tree(seed: int = 0) -> dict:
    """An untied test-tiny params tree (numpy float32) whose layer stacks,
    embedding and head carry half-way ties and all-zero channels."""
    rng = np.random.default_rng(seed)
    tree = _np_tree(JCfg(tie_embeddings=False, attn_bias=True), seed=seed)
    for name in ("wq", "wk", "w_down"):
        tree["layers"][name] = _awkward(rng, tree["layers"][name].shape)
    tree["embed"] = _awkward(rng, tree["embed"].shape[::-1]).T.copy()  # ties along a vocab row
    tree["lm_head"] = _awkward(rng, tree["lm_head"].shape)
    return tree


def test_device_quantizer_bit_equal_to_jax():
    """quantize_params_device (the card's path, run here on the CPU device,
    in row chunks smaller than the embedding) equals the JAX host
    quantizer leaf for leaf; the leaves it does not quantize pass through."""
    tree = awkward_tree()
    want = JQ.quantize_params_np(tree)
    host = jax.tree.map(torch.from_numpy, tree)
    got = TQ.quantize_params_device(host, CPU)
    assert jax.tree.structure(want) == jax.tree.structure(jax.tree.map(np.asarray, got))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    q, s = TQ.quantize_to_device(torch.from_numpy(tree["lm_head"]), 0, CPU, 1, 7)
    jq, js = JQ.quantize_np(tree["lm_head"], axis=-1)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)


# -- the model's int8 pieces ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_q_embed_and_logits_match_jax(int8_models, dtype):
    jcfg, tcfg, _, _, q = int8_models
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = TOL_F32_OP if dtype == "float32" else TOL_BF16_OP
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, tcfg.hidden_size)).astype(np.float32)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jlp = {k: jnp.asarray(v[1]) for k, v in q["layers"].items()}
    tlp = {k: torch.from_numpy(np.ascontiguousarray(v[1])) for k, v in q["layers"].items()}
    for name in ("wq", "wk", "w_gate"):
        want = np.asarray(JM._dot_q(xj, jlp, name).astype(jnp.float32))
        got = TM._dot_q(xt, tlp, name)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    xi = rng.standard_normal((5, tcfg.intermediate_size)).astype(np.float32)
    want = np.asarray(JM._dot_q(jnp.asarray(xi, jdt), jlp, "w_down").astype(jnp.float32))
    got = TM._dot_q(torch.from_numpy(xi).to(tdt), tlp, "w_down").float().numpy()
    np.testing.assert_allclose(got, want, **tol)

    toks = np.array([0, 7, 511, 7, 300], np.int32)
    jpar = jax.tree.map(jnp.asarray, q)
    tpar = params_from_numpy(q, CPU, torch.float32)
    want = np.asarray(JM._embed_rows(jpar, jnp.asarray(toks), jdt).astype(jnp.float32))
    got = TM._embed_rows(tpar, torch.from_numpy(toks), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)  # one rounding, no sum

    jpar = dict(jpar, final_norm=jpar["final_norm"].astype(jdt))
    tpar = dict(tpar, final_norm=tpar["final_norm"].to(tdt))
    want = np.asarray(JM._logits(jcfg, jpar, xj))
    got = TM._logits(tcfg, tpar, xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_logits_keep_the_scale_leaf_dtype():
    """A bf16 lm_head_scale (as the loader gives) multiplies the f32 logits
    in f32, as the JAX package's does."""
    jcfg, tcfg = JCfg(tie_embeddings=False), ModelConfig(tie_embeddings=False)
    q = JQ.quantize_params_np(_np_tree(jcfg, seed=4))
    jpar = jax.tree.map(jnp.asarray, q)
    jpar["lm_head_scale"] = jpar["lm_head_scale"].astype(jnp.bfloat16)
    tpar = params_from_numpy(q, CPU, torch.float32)
    tpar["lm_head_scale"] = tpar["lm_head_scale"].to(torch.bfloat16)
    x = np.random.default_rng(2).standard_normal((3, 128)).astype(np.float32)
    want = np.asarray(JM._logits(jcfg, jpar, jnp.asarray(x)))
    got = TM._logits(tcfg, tpar, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32_OP)


def test_int8_matmul_ref_is_the_cpu_route():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 40)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (40, 24)).astype(np.int8))
    s = torch.from_numpy(rng.random(24).astype(np.float32))
    before = (im.launches, im.prefill_launches)
    y = im.int8_matmul(x, w, s)
    assert y.shape == (2, 3, 24) and (im.launches, im.prefill_launches) == before
    torch.testing.assert_close(y, (x @ w.float()) * s, rtol=0, atol=0)
    yf = im.int8_matmul(x.bfloat16(), w, s.bfloat16(), out_f32=True)
    assert yf.dtype == torch.float32
    torch.testing.assert_close(yf, (x.bfloat16() @ w.bfloat16()).float() * s.bfloat16().float(),
                               rtol=0, atol=0)


# -- forward passes -------------------------------------------------------------


def _prefill_inputs():
    tokens = np.zeros((2, 16), np.int32)
    tokens[0, :13] = np.arange(1, 14)
    tokens[1, :9] = np.arange(40, 49)
    tables = np.zeros((2, 8), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :3] = [5, 6, 7]
    return tokens, tables, np.array([0, 0], np.int32), np.array([13, 9], np.int32)


def _assert_cache_close(jcache, tcache):
    for a, b in zip(jcache, tcache):
        if a is None:
            continue
        a, b = np.asarray(a)[:, 1:], b.numpy()[:, 1:]
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_int8_forward_matches_jax(int8_models, kv_quant):
    jcfg, tcfg, jparams, tparams, _ = int8_models
    jcache = JM.init_kv_cache(jcfg, N, BS, jnp.float32, kv_quant=kv_quant)
    tcache = TM.init_kv_cache(tcfg, N, BS, torch.float32, CPU, kv_quant=kv_quant)
    toks, tables, starts, tlens = _prefill_inputs()
    jl, jcache = JM.prefill_batch(jcfg, jparams, jcache, jnp.asarray(toks), jnp.asarray(tables),
                                  jnp.asarray(starts), jnp.asarray(tlens))
    tl = TM.prefill_batch(tcfg, tparams, tcache, torch.from_numpy(toks), torch.from_numpy(tables),
                          torch.from_numpy(starts), torch.from_numpy(tlens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(jcache, tcache)
    tol = TOL_INT8 if kv_quant == "int8" else TOL

    B = 4
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
    np.testing.assert_allclose(td.numpy()[:2], np.asarray(jd)[:2], **tol)
    _assert_cache_close(jcache, tcache)

    K, Bm = 5, 2
    nxt = np.asarray(jd)[:2].argmax(-1).astype(np.int32)
    pos2 = np.array([14, 10], np.int32)
    act = np.ones((Bm,), bool)
    temps = np.array([0.0, 0.9], np.float32)
    seeds = np.array([11, 12], np.int32)
    steps0 = np.array([1, 1], np.int32)
    zf, zi = np.zeros((Bm,), np.float32), np.zeros((Bm,), np.int32)
    for mode in ("greedy", "simple"):
        jt, jlp, _, _, jcache = JM.multi_decode(
            jcfg, K, mode, 0, jparams, jcache, jnp.asarray(nxt), jnp.asarray(pos2),
            jnp.asarray(tables), jnp.asarray(act), jnp.asarray(temps),
            jnp.asarray(seeds, jnp.uint32), jnp.asarray(steps0), jnp.asarray(zi),
            jnp.ones((Bm,), jnp.float32), jnp.asarray(zf), jnp.asarray(zf),
            jnp.full((Bm, 1), -1, jnp.int32), attn_impl="xla",
        )
        tt, tlp, _, _ = TM.multi_decode(
            tcfg, K, mode, 0, tparams, tcache, torch.from_numpy(nxt), torch.from_numpy(pos2),
            torch.from_numpy(tables), torch.from_numpy(act), torch.from_numpy(temps),
            torch.from_numpy(seeds), torch.from_numpy(steps0),
        )
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **tol)
        _assert_cache_close(jcache, tcache)
        nxt, pos2, steps0 = np.array(jt)[-1], pos2 + K, steps0 + K


# -- the engine -----------------------------------------------------------------

BASE = dict(block_size=4, num_kv_blocks=256, max_num_seqs=8, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4, quant="int8")


def _request(prompt, max_tokens, temperature=0.0, seed=0):
    return {"model": "test-tiny", "token_ids": list(prompt),
            "sampling": {"temperature": temperature, "seed": seed, "logprobs": True},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


WORKLOAD = [_request([1, 2, 3], 9), _request(list(range(10, 47)), 13),
            _request([3, 1, 4, 1, 5], 11, temperature=0.8, seed=7),
            _request([9, 2, 6], 7, temperature=1.1, seed=1000), _request([8, 9], 1)]


async def _streams(eng):
    from test_torch_pipeline import run_stream

    await eng.start()
    try:
        return await asyncio.gather(*(run_stream(eng, r) for r in WORKLOAD))
    finally:
        await eng.stop()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_int8_streams_match_tpu_engine(kv_quant):
    q = JQ.quantize_params_np(_np_tree(JCfg()))
    ref = asyncio.run(_streams(TpuEngine(
        JArgs(model=JCfg(), attn_impl="xla", pipeline_depth=2, kv_quant=kv_quant, **BASE),
        params=q)))
    tol = TOL_INT8 if kv_quant == "int8" else TOL
    for depth in (0, 2):
        port = asyncio.run(_streams(TorchEngine(EngineArgs(
            model=ModelConfig(), device="cpu", pipeline_depth=depth, pipeline_windows=depth > 0,
            kv_quant=kv_quant, **BASE), params=q)))
        for (pt, pl, _, pf), (jt, jl, _, jf) in zip(port, ref):
            assert pt == jt and pf == jf
            np.testing.assert_allclose(pl, jl, **tol)
    assert len({tuple(t) for t, *_ in ref}) == len(WORKLOAD)


# -- the runner's int8 start and the weights' dtypes ---------------------------------


def test_runner_int8_start():
    cfg = ModelConfig(tie_embeddings=False, attn_bias=True)
    args = EngineArgs(model=cfg, device="cpu", quant="int8", block_size=4, num_kv_blocks=8)
    r = LocalRunner(args, seed=3)
    r.start()
    jtree = JQ.random_int8_params_device(JCfg(tie_embeddings=False, attn_bias=True), 3)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, r.params, is_leaf=lambda x: isinstance(x, torch.Tensor)))[0])
    assert sorted(map(str, flat_j)) == sorted(map(str, flat_t))
    for path, a in flat_j.items():
        b = flat_t[path]
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
    again = LocalRunner(args, seed=3)
    again.start()
    assert torch.equal(again.params["layers"]["wq"], r.params["layers"]["wq"])

    q = _np_tree(JCfg())
    host = LocalRunner(EngineArgs(device="cpu", quant="int8", dtype="float32", block_size=4,
                                  num_kv_blocks=8), params=q)
    host.start()
    want = JQ.quantize_params_np(q)
    np.testing.assert_array_equal(host.params["layers"]["w_up"].numpy(), want["layers"]["w_up"])
    np.testing.assert_array_equal(host.params["embed_scale"].numpy(), want["embed_scale"])

    dev = params_from_numpy(q, CPU, torch.float32)
    with pytest.raises(ValueError, match="unquantized device params"):
        LocalRunner(EngineArgs(device="cpu", quant="int8", dtype="float32", block_size=4,
                               num_kv_blocks=8), params=dev).start()
    with pytest.raises(ValueError, match="quant must be"):
        EngineArgs(quant="int4")


def test_params_from_numpy_keeps_scales_beside_bf16_norms():
    """An int8 tree as the JAX package makes it (bf16 norms, f32 scales)
    keeps its f32 scales; the old rule cast every floating leaf to bf16."""
    tree = jax.tree.map(np.asarray, JQ.random_int8_params_device(JCfg(tie_embeddings=False), 0))
    assert tree["layers"]["attn_norm"].dtype.name == "bfloat16"
    t = params_from_numpy(tree, CPU, torch.bfloat16)
    assert t["layers"]["wq"].dtype == torch.int8 and t["embed"].dtype == torch.int8
    assert t["layers"]["attn_norm"].dtype == torch.bfloat16
    for leaf in (t["layers"]["wq_scale"], t["embed_scale"], t["lm_head_scale"]):
        assert leaf.dtype == torch.float32
    np.testing.assert_array_equal(t["lm_head_scale"].numpy(), tree["lm_head_scale"])
    # A float tree still casts to the requested dtype.
    f = params_from_numpy(_np_tree(JCfg()), CPU, torch.bfloat16)
    assert f["embed"].dtype == torch.bfloat16 and f["layers"]["wq"].dtype == torch.bfloat16
