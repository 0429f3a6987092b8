"""The port's mixture-of-experts FFN and MoE forwards against the JAX
package's, on the CPU.

``_moe`` is held against ``dynamo_tpu.engine.model._moe`` and against a
float64 loop over each token's chosen experts (the obviously-correct
path): in float32 within ``TOL`` (1e-4), in bfloat16 by the rule of
``tests/test_torch_model.py``'s bf16 test (the port's error against the
f64 loop at most twice the JAX package's own, plus 0.02). Ties among
router probabilities go to the lower expert index, as ``lax.top_k``
takes them.

Then every forward on ``moe-tiny`` (4 experts, top 2) in float32 on the
JAX package's weights carried across with ``params_from_numpy``: prefill,
decode, multi_decode in its three sampler modes, speculative verify
(linear and tree), embeddings; with int8 KV pages within ``TOL_INT8``;
an int8 tree from ``quantize_params_np`` (int8 attention and head, float
experts); and every preset's parameter counts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine import quant as JQ
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine import quant as TQ
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.engine.weights import params_from_numpy, params_to_numpy

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
TOL_INT8 = dict(atol=2e-3, rtol=2e-3)
BS, N = 4, 32
PRESETS = ("test-tiny", "llama-1b", "llama-3b", "llama-8b", "qwen2-7b", "moe-tiny", "moe-wide",
           "llama-70b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once on a few cores: these
    tiny shapes gain nothing from torch's intra-op thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moe_reference(x, router, gates, ups, downs, top_k):
    """Per-token loop over the chosen experts in float64: softmax over the
    router logits, the top ``top_k`` (lower index first among ties),
    renormalised weights, silu(x @ gate) * (x @ up) @ down."""
    x, router = np.asarray(x, np.float64), np.asarray(router, np.float64)
    logits = x @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    for t in range(x.shape[0]):
        idx = np.argsort(-probs[t], kind="stable")[:top_k]
        w = probs[t, idx] / probs[t, idx].sum()
        for e, wi in zip(idx, w):
            g = x[t] @ np.asarray(gates[e], np.float64)
            u = x[t] @ np.asarray(ups[e], np.float64)
            out[t] += wi * (((g / (1 + np.exp(-g))) * u) @ np.asarray(downs[e], np.float64))
    return out


def _layer(D, E, ie, seed, router_scale=0.3):
    rng = np.random.default_rng(seed)
    return {
        "w_router": (rng.standard_normal((D, E)) * router_scale).astype(np.float32),
        "moe_gate": (rng.standard_normal((E, D, ie)) * D ** -0.5).astype(np.float32),
        "moe_up": (rng.standard_normal((E, D, ie)) * D ** -0.5).astype(np.float32),
        "moe_down": (rng.standard_normal((E, ie, D)) * ie ** -0.5).astype(np.float32),
    }


def _both_moe(x, lp, E, k, jdt, tdt):
    """→ (JAX _moe, port _moe) of x [..., D] on the layer ``lp`` in the
    given dtypes, as float64 arrays."""
    jcfg = JCfg(num_experts=E, num_experts_per_token=k)
    tcfg = TCfg(num_experts=E, num_experts_per_token=k)
    j = JM._moe(jnp.asarray(x, jdt), {n: jnp.asarray(v, jdt) for n, v in lp.items()}, jcfg)
    t = TM._moe(torch.from_numpy(x).to(tdt), {n: torch.from_numpy(v).to(tdt)
                                               for n, v in lp.items()}, tcfg)
    return np.asarray(j.astype(jnp.float32), np.float64), t.float().numpy().astype(np.float64)


@pytest.mark.parametrize("E,k,D,ie", [(4, 2, 16, 32), (8, 2, 32, 16), (16, 4, 64, 32),
                                      (64, 8, 64, 16)])
def test_moe_float32_matches_jax_and_loop(E, k, D, ie):
    lp = _layer(D, E, ie, seed=E)
    x = np.random.default_rng(E + 1).standard_normal((3, 5, D)).astype(np.float32)
    j, t = _both_moe(x, lp, E, k, jnp.float32, torch.float32)
    assert t.shape == x.shape
    ref = moe_reference(x.reshape(-1, D), lp["w_router"], lp["moe_gate"], lp["moe_up"],
                        lp["moe_down"], k).reshape(x.shape)
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(t, ref, **TOL)


@pytest.mark.parametrize("E,k,D,ie", [(4, 2, 128, 256), (16, 4, 128, 64), (64, 8, 256, 32)])
def test_moe_bfloat16_within_bound(E, k, D, ie):
    """bfloat16 weights and activations on both sides, each held against
    the float64 loop on the same (bf16-valued) inputs: the port's error at
    most twice the JAX package's plus 0.02 (tests/test_torch_model.py's
    rule), and both below 0.1 on outputs of unit scale. The router's
    logits are bf16-valued on both sides, so where bf16 rounding moves
    the k-th expert it moves it in both."""
    lp = _layer(D, E, ie, seed=100 + E, router_scale=D ** -0.5)
    x = np.random.default_rng(7 + E).standard_normal((24, D)).astype(np.float32)
    lp16 = {n: np.asarray(torch.from_numpy(v).bfloat16().float()) for n, v in lp.items()}
    x16 = np.asarray(torch.from_numpy(x).bfloat16().float())
    ref = moe_reference(x16, lp16["w_router"], lp16["moe_gate"], lp16["moe_up"],
                        lp16["moe_down"], k)
    j, t = _both_moe(x16, lp16, E, k, jnp.bfloat16, torch.bfloat16)
    jerr, terr = np.abs(j - ref).max(), np.abs(t - ref).max()
    assert terr <= 0.1 and jerr <= 0.1, (terr, jerr)
    assert terr <= 2 * jerr + 0.02, (terr, jerr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ties_go_to_the_lower_expert(dtype):
    """Router columns repeated, so that several experts' probabilities are
    exactly equal for every token and the k-th place falls inside the
    tie: the port chooses the experts ``lax.top_k`` chooses (the lower
    index first), and its output is the JAX package's."""
    D, E, k, ie = 16, 8, 3, 16
    lp = _layer(D, E, ie, seed=5)
    r = lp["w_router"]
    # expert 0 leads; experts 2, 5 and 6 tie for places 2-4; 1, 3, 4, 7
    # trail. Quarters sum exactly in any order, in bf16 as in f32.
    r[:, 0] = 0.0
    r[:, [2, 5, 6]] = -0.5
    r[:, [1, 3, 4, 7]] = -3.0
    x = (np.random.default_rng(6).integers(1, 5, (6, D)) / 4).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    xt = torch.from_numpy(x).to(tdt)
    probs, _, topi = TM._moe_route(xt, torch.from_numpy(r).to(tdt), k)
    jprobs = jax.nn.softmax(jnp.dot(jnp.asarray(x, jdt), jnp.asarray(r, jdt)).astype(jnp.float32))
    _, jtopi = lax.top_k(jprobs, k)
    p = probs.numpy()
    assert (p[:, 2] == p[:, 5]).all() and (p[:, 5] == p[:, 6]).all()
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_array_equal(topi.numpy(), np.tile([0, 2, 5], (6, 1)))
    j, t = _both_moe(x, lp, E, k, jdt, tdt)
    np.testing.assert_allclose(t, j, **(TOL if dtype == "float32" else dict(atol=2e-2,
                                                                            rtol=2e-2)))


# -- the MoE forwards on moe-tiny -------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JCfg.preset("moe-tiny"), TCfg.preset("moe-tiny")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(np_params, CPU, torch.float32), np_params


def _tree_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_shapes(v, (*prefix, k)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("preset", ["moe-tiny", "test-tiny"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_leaves_match_jax(preset, dtype):
    """Names, shapes and dtypes of the port's random init equal the JAX
    package's: a MoE config has the router and the expert stacks and no
    dense FFN."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jtree = jax.eval_shape(lambda: JM.init_params(JCfg.preset(preset), jax.random.PRNGKey(0),
                                                  jnp.dtype(dtype)))
    ttree = TM.init_params(TCfg.preset(preset), CPU, tdt)
    assert _tree_shapes(ttree) == _tree_shapes(jtree)
    if preset == "moe-tiny":
        assert "w_gate" not in ttree["layers"] and ttree["layers"]["moe_gate"].shape == (
            2, 4, 128, 256)


def test_moe_params_round_trip(models):
    """A JAX MoE tree carried to the port and back is bit for bit the same,
    in float32 and bfloat16 leaves."""
    _, _, jparams, tparams, np_params = models
    for tree, want in ((tparams, np_params),
                       (params_from_numpy(jax.tree.map(
                           lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), np_params),
                           CPU, torch.bfloat16), None)):
        back = params_to_numpy(tree)
        ref = want if want is not None else jax.tree.map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), np_params)
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)


def _caches(jcfg, tcfg, kv_quant="none"):
    return (JM.init_kv_cache(jcfg, N, BS, jnp.float32, kv_quant=kv_quant),
            TM.init_kv_cache(tcfg, N, BS, torch.float32, CPU, kv_quant=kv_quant))


def _assert_cache_equal(jcache, tcache):
    for a, b in zip(jcache, tcache):
        if a is None:
            continue
        a, b = np.asarray(a)[:, 1:], b.numpy()[:, 1:]
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(a, b, **TOL)


def _prefill_inputs():
    tokens = np.zeros((3, 16), np.int32)
    lens = np.array([13, 9, 6], np.int32)
    for r, n in enumerate(lens):
        tokens[r, :n] = np.arange(1 + 40 * r, 1 + 40 * r + n)
    tables = np.zeros((4, 8), np.int32)
    tables[0, :6], tables[1, :5], tables[2, :4] = range(1, 7), range(7, 12), range(12, 16)
    return tokens, tables, np.zeros((3,), np.int32), lens


def _prefill_both(jcfg, tcfg, jparams, tparams, kv_quant="none"):
    jcache, tcache = _caches(jcfg, tcfg, kv_quant)
    toks, tables, starts, lens = _prefill_inputs()
    jl, jcache = JM.prefill_batch(jcfg, jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(tables[:3]), jnp.asarray(starts), jnp.asarray(lens))
    tl = TM.prefill_batch(tcfg, tparams, tcache, torch.from_numpy(toks),
                          torch.from_numpy(tables[:3]), torch.from_numpy(starts),
                          torch.from_numpy(lens))
    return jl, jcache, tl, tcache, tables


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_prefill_and_decode_match_jax(models, kv_quant):
    """Prefill of three rows, a prefix-cached chunk of row 0, then a decode
    step of the three rows beside a padding row."""
    jcfg, tcfg, jparams, tparams, _ = models
    jl, jcache, tl, tcache, tables = _prefill_both(jcfg, tcfg, jparams, tparams, kv_quant)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(jcache, tcache)
    toks = np.zeros((4,), np.int32)
    toks[:3] = np.asarray(jl).argmax(-1)
    pos = np.array([13, 9, 6, 0], np.int32)
    active = np.array([True, True, True, False])
    jd, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(toks), jnp.asarray(pos),
                                jnp.asarray(tables), jnp.asarray(active), attn_impl="xla")
    td = TM.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
                        torch.from_numpy(tables), torch.from_numpy(active))
    np.testing.assert_allclose(td.numpy()[:3], np.asarray(jd)[:3],
                               **(TOL_INT8 if kv_quant == "int8" else TOL))
    _assert_cache_equal(jcache, tcache)


def test_prefix_cached_prefill_matches_jax(models):
    jcfg, tcfg, jparams, tparams, _ = models
    jl, jcache, tl, tcache, tables = _prefill_both(jcfg, tcfg, jparams, tparams)
    toks = np.zeros((8,), np.int32)
    toks[:5] = [60, 61, 62, 63, 64]
    tab = np.zeros((8,), np.int32)
    tab[:6] = tables[0, :6]
    jl2, jcache = JM.prefill(jcfg, jparams, jcache, jnp.asarray(toks), jnp.asarray(tab),
                             jnp.int32(8), jnp.int32(13))
    tl2 = TM.prefill(tcfg, tparams, tcache, torch.from_numpy(toks), torch.from_numpy(tab), 8, 13)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    _assert_cache_equal(jcache, tcache)


@pytest.mark.parametrize("mode", ["greedy", "simple", "full"])
def test_multi_decode_matches_jax(models, mode):
    """One chained window in each sampler mode: rows 0 and 1 take their
    token from ``last_toks``, row 2 from the host, row 3 pads."""
    jcfg, tcfg, jparams, tparams, _ = models
    jl, jcache, _, tcache, tables = _prefill_both(jcfg, tcfg, jparams, tparams)
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    last = np.zeros((6,), np.int32)
    last[[2, 0]] = first[:2]
    ops = (np.array([0, 0, first[2], 0], np.int32), np.array([13, 9, 6, 0], np.int32), tables,
           np.array([True, True, True, False]), np.array([0.0, 0.8, 1.1, 0.0], np.float32),
           np.array([5, 6, 2**31 - 1, 0], np.uint32), np.array([1, 1, 1, 0], np.int32),
           np.array([0, 5, 0, 0], np.int32), np.array([1.0, 0.9, 0.8, 1.0], np.float32),
           np.array([0.5, 0.0, 0.25, 0.0], np.float32),
           np.array([0.0, 0.5, 0.25, 0.0], np.float32))
    pen = np.full((4, 16), -1, np.int32)
    pen[:3, 0] = first
    chain = (np.array([True, True, False, False]), np.array([2, 0, 0, 0], np.int32), last)
    K, n = 5, 3
    j = JM.multi_decode(jcfg, K, mode, n, jparams, jcache,
                        *map(jnp.asarray, (*ops, pen, *chain)), attn_impl="xla")
    t = TM.multi_decode(tcfg, K, mode, n, tparams, tcache, *map(torch.from_numpy, (
        *ops[:5], ops[5].astype(np.int64), *ops[6:], pen, *chain)))
    live = slice(0, 3)
    np.testing.assert_array_equal(t[0].numpy()[:, live], np.asarray(j[0])[:, live])
    np.testing.assert_allclose(t[1].numpy()[:, live], np.asarray(j[1])[:, live], **TOL)
    np.testing.assert_array_equal(t[3].numpy()[:, live], np.asarray(j[3])[:, live])
    np.testing.assert_allclose(t[2].numpy()[:, live], np.asarray(j[2])[:, live], **TOL)
    _assert_cache_equal(j[4], tcache)


def _tree_topology(B, S1):
    """Nodes 1 and 2 siblings under the root, node 3 under node 1, every
    later node under the one before it → (parents, anc, depth)."""
    parents = np.zeros((B, S1), np.int32)
    for j in range(3, S1):
        parents[:, j] = 1 if j == 3 else j - 1
    anc = np.zeros((B, S1, S1), np.int8)
    depth = np.zeros((B, S1), np.int32)
    for b in range(B):
        anc[b, 0, 0] = 1
        for j in range(1, S1):
            p = parents[b, j]
            anc[b, j] = anc[b, p]
            anc[b, j, j] = 1
            depth[b, j] = depth[b, p] + 1
    return parents, anc, depth


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("kind", ["linear", "tree"])
def test_spec_verify_matches_jax(models, kind, kv_quant):
    """A fused verify pass (linear, or a tree whose accepted path skips a
    rejected sibling) with drafts the model accepts: tokens, emitted
    counts, per-node argmax and the chain token equal, logprobs and every
    KV page (tree compaction included) within tolerance."""
    jcfg, tcfg, jparams, tparams, _ = models
    S1 = 5
    jl, jcache, _, tcache, tables = _prefill_both(jcfg, tcfg, jparams, tparams, kv_quant)
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    # each row's greedy continuation: the drafts a greedy row accepts
    _, _, _, ccache, _ = _prefill_both(jcfg, tcfg, jparams, tparams, kv_quant)
    tok = torch.from_numpy(np.append(first, 0).astype(np.int32))
    pos = torch.tensor([13, 9, 6, 0], dtype=torch.int32)
    active_t = torch.tensor([True, True, True, False])
    chain = []
    for _ in range(S1 - 1):
        tok = torch.argmax(TM.decode_step(tcfg, tparams, ccache, tok, pos,
                                          torch.from_numpy(tables), active_t), -1).to(torch.int32)
        chain.append(tok.numpy().copy())
        pos = pos + 1
    chain = np.stack(chain, axis=1)
    tokens = np.zeros((4, S1), np.int32)
    tokens[:3, 0] = first
    tree = None
    if kind == "tree":
        tokens[:3, 1] = chain[:3, 0]
        tokens[:3, 2] = (chain[:3, 0] + 7) % 512
        tokens[:3, 3:] = chain[:3, 1 : S1 - 2]
        tree = _tree_topology(4, S1)
    else:
        tokens[:3, 1:] = chain[:3]
        tokens[1, 3] = (tokens[1, 3] + 1) % 512
    args = (tokens, np.array([13, 9, 6, 0], np.int32), np.array([S1 - 1, S1 - 1, 1, 0], np.int32),
            tables, np.array([True, True, True, False]), np.array([0.0, 0.8, 1.2, 0.0], np.float32))
    seeds, steps0 = np.array([5, 6, 7, 0], np.uint32), np.array([1, 2, 3, 0], np.int32)
    j = JM.spec_verify(jcfg, S1, "simple", 3, jparams, jcache,
                       *map(jnp.asarray, (*args, seeds, steps0)),
                       *((jnp.asarray(a) for a in tree) if tree else (None,) * 3),
                       fused=True, attn_impl="xla")
    t = TM.spec_verify(tcfg, S1, "simple", 3, tparams, tcache,
                       *map(torch.from_numpy, (*args, seeds.astype(np.int64), steps0)),
                       *((torch.from_numpy(a) for a in tree) if tree else (None,) * 3))
    tol = TOL_INT8 if kv_quant == "int8" else TOL
    j_n = np.asarray(j[1])[:3]
    np.testing.assert_array_equal(t[1].numpy()[:3], j_n)
    assert j_n[0] == (S1 - 1 if kind == "tree" else S1)
    for r in range(3):
        n, live = j_n[r], args[2][r] + 1
        np.testing.assert_array_equal(t[0].numpy()[r, :n], np.asarray(j[0])[r, :n])
        np.testing.assert_allclose(t[2].numpy()[r, :n], np.asarray(j[2])[r, :n], **tol)
        np.testing.assert_array_equal(t[3].numpy()[r, :live], np.asarray(j[3])[r, :live])
        np.testing.assert_array_equal(t[5].numpy()[r, :n], np.asarray(j[5])[r, :n])
        np.testing.assert_allclose(t[4].numpy()[r, :n], np.asarray(j[4])[r, :n], **tol)
    np.testing.assert_array_equal(t[6].numpy()[:3], np.asarray(j[6])[:3])
    _assert_cache_equal(j[7], tcache)


@pytest.mark.parametrize("n,pad", [(5, 8), (13, 16)])
def test_embed_matches_jax(models, n, pad):
    jcfg, tcfg, jparams, tparams, _ = models
    toks = np.zeros((pad,), np.int32)
    toks[:n] = np.random.default_rng(n).integers(1, 500, n)
    want = np.asarray(JM.embed(jcfg, jparams, jnp.asarray(toks), jnp.int32(n)))
    got = TM.embed(tcfg, tparams, torch.from_numpy(toks), n).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_int8_tree_keeps_experts_float_and_matches_jax(models):
    """``quantize_params_np`` on a MoE tree quantizes attention and the
    head and leaves the router and expert stacks in the float dtype, as
    the JAX package's does; the port's forward on that tree equals the
    JAX forward on the JAX package's own int8 tree."""
    jcfg, tcfg, _, _, np_params = models
    tq, jq = TQ.quantize_params_np(np_params), JQ.quantize_params_np(np_params)
    assert jax.tree.structure(tq) == jax.tree.structure(jq)
    for a, b in zip(jax.tree.leaves(tq), jax.tree.leaves(jq)):
        np.testing.assert_array_equal(a, b)
    for name in ("w_router", "moe_gate", "moe_up", "moe_down"):
        assert tq["layers"][name].dtype == np.float32 and name + "_scale" not in tq["layers"]
    assert tq["layers"]["wq"].dtype == np.int8 and tq["embed"].dtype == np.int8
    dq = TQ.quantize_params_device(params_from_numpy(np_params, CPU, torch.float32), CPU)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tq)[0],
                            jax.tree.leaves(params_to_numpy(dq))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    jparams = jax.tree.map(jnp.asarray, jq)
    tparams = params_from_numpy(tq, CPU, torch.float32)
    jl, jcache, tl, tcache, tables = _prefill_both(jcfg, tcfg, jparams, tparams)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_INT8)
    toks = np.append(np.asarray(jl).argmax(-1), 0).astype(np.int32)
    pos, active = np.array([13, 9, 6, 0], np.int32), np.array([True, True, True, False])
    jd, _ = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(tables), jnp.asarray(active), attn_impl="xla")
    td = TM.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
                        torch.from_numpy(tables), torch.from_numpy(active))
    np.testing.assert_allclose(td.numpy()[:3], np.asarray(jd)[:3], **TOL_INT8)


@pytest.mark.parametrize("preset", PRESETS)
def test_param_counts_match_jax(preset):
    j, t = JCfg.preset(preset), TCfg.preset(preset)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.active_param_count() < t.param_count()) == bool(t.num_experts)
