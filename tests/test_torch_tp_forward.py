"""The port's tensor-parallel forwards against the JAX package's, on the CPU.

A forward scenario (``tests/torch_tp_ranks.py``: a 3-row prefill, a chained
4-step window in the "simple" sampler mode with top-2 logprobs, a linear
and a tree verify pass, an embedding) runs on 2 and 4 gloo ranks of CPU
processes, each on its shards of the same f32 weights (test-tiny: 4 heads
over 2 kv heads, so tp 4 replicates each kv head over 2 ranks, tp_rep 2).
Its outputs, the KV pages gathered into the JAX layout included, are held
against the JAX package's unsharded forward and its ``ModelSharding``
forward on the 8 virtual CPU devices (tp 2 and 4 meshes), within
1e-5 + 1e-5·|x| in f32; sampled tokens and emitted counts exactly.
tests/test_torch_tp_forward_int8.py runs the same with int8 weights and
pages.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.quant import quantize_params_np
from dynamo_tpu.parallel.mesh import ModelSharding as JSharding
from dynamo_tpu.parallel.mesh import build_mesh
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg

from torch_tp_ranks import BS, NBLK, port_forward_rank, run_ranks, scenario_inputs

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_INT8 = dict(atol=2e-3, rtol=2e-3)


def jax_scenario(cfg, params, cache, inp: dict) -> dict:
    """``forward_scenario`` through the JAX package's forwards."""
    a = jnp.asarray
    out = {}
    logits, cache = JM.prefill_batch(cfg, params, cache, a(inp["toks"]), a(inp["tables"][:3]),
                                     jnp.zeros((3,), jnp.int32), a(inp["lens"]))
    out["prefill"] = np.asarray(logits)
    first = np.asarray(logits).argmax(-1).astype(np.int32)
    last = np.zeros((6,), np.int32)
    last[[2, 0]] = first[:2]
    B = 4
    tok = np.array([0, 0, first[2], 0], np.int32)
    pos = np.array([13, 9, 6, 0], np.int32)
    active = np.array([True, True, True, False])
    temps, seeds = inp["temps"], inp["seeds"].astype(np.uint32)
    steps0 = np.ones((B,), np.int32)
    z, one = np.zeros((B,), np.int32), np.ones((B,), np.float32)
    *win, cache = JM.multi_decode(
        cfg, 4, "simple", 2, params, cache, a(tok), a(pos), a(inp["tables"]), a(active),
        a(temps), a(seeds), a(steps0), a(z), a(one), a(z.astype(np.float32)),
        a(z.astype(np.float32)), a(np.full((B, 1), -1, np.int32)),
        a(np.array([True, True, False, False])), a(np.array([2, 0, 0, 0], np.int32)), a(last),
        attn_impl="xla")
    out.update({f"window_{i}": np.asarray(x) for i, x in enumerate(win)})
    S1 = inp["S1"]
    pos0 = pos + 4
    for kind in ("linear", "tree"):
        drafts = inp["drafts"].copy()
        drafts[:3, 0] = np.asarray(win[0])[-1][:3]
        tree = [a(x) for x in inp["tree"]] if kind == "tree" else [None] * 3
        *v, cache = JM.spec_verify(
            cfg, S1, "simple", 2, params, cache, a(drafts), a(pos0),
            a(np.array([S1 - 1, S1 - 1, 1, 0], np.int32)), a(inp["tables"]), a(active),
            a(temps), a(seeds), a(steps0 + 4), *tree, fused=True, attn_impl="xla")
        out.update({f"{kind}_{i}": np.asarray(x) for i, x in enumerate(v)})
        pos0 = pos0 + np.asarray(v[1]).astype(np.int32)
    out["embed"] = np.asarray(JM.embed(cfg, params, a(inp["embed_toks"]),
                                       jnp.int32(inp["embed_len"])))
    out["pages"] = [np.asarray(x) for x in cache if x is not None]
    return out


def _models(quant: str):
    jcfg = JCfg()
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0),
                                                        jnp.float32))
    if quant == "int8":
        np_params = quantize_params_np(np_params)
    return jcfg, np_params


def references_for(quant: str):
    """The JAX scenario unsharded and on tp 2 and 4 meshes → (quant,
    params, inputs, {tp: outputs})."""
    jcfg, np_params = _models(quant)
    inp = scenario_inputs(jcfg.vocab_size)
    refs = {}
    for tp in (1, 2, 4):
        params = jax.tree.map(jnp.asarray, np_params)
        cache = JM.init_kv_cache(jcfg, NBLK, BS, jnp.float32, kv_quant=quant)
        if tp > 1:
            sh = JSharding(build_mesh(tp=tp, cfg=jcfg), jcfg)
            params = sh.shard_params(np_params)
            cache = JM.KVCache(*sh.shard_cache(cache))
        refs[tp] = jax_scenario(jcfg, params, cache, inp)
    return quant, np_params, inp, refs


@pytest.fixture(scope="module")
def references():
    return references_for("none")


def _compare(got: dict, want: dict, quant: str) -> None:
    """Live rows only (row 3 pads); a verify pass's outputs over the slots
    it emitted (per-node argmax over its live slots)."""
    tol = TOL_INT8 if quant == "int8" else TOL
    exact = {"window_0", "window_3", "linear_0", "linear_1", "linear_3", "linear_5",
             "linear_6", "tree_0", "tree_1", "tree_3", "tree_5", "tree_6"}
    live = np.array([4, 4, 1]) + 1  # draft_len + 1
    for k, w in want.items():
        g = got[k]
        if k == "pages":
            for gp, wp in zip(g, w):
                gp, wp = gp[:, 1:], wp[:, 1:]  # block 0 is the garbage sink
                if wp.dtype == np.int8:
                    assert np.abs(gp.astype(np.int32) - wp.astype(np.int32)).max() <= 1
                else:
                    np.testing.assert_allclose(gp, wp, **tol, err_msg=k)
            continue
        kind, _, idx = k.partition("_")
        if kind in ("linear", "tree") and idx not in ("1", "6"):
            n_emit = want[f"{kind}_1"]
            np.testing.assert_array_equal(got[f"{kind}_1"][:3], n_emit[:3], err_msg=k)
            pairs = [(g[r, : (live[r] if idx == "3" else n_emit[r])],
                      w[r, : (live[r] if idx == "3" else n_emit[r])]) for r in range(3)]
        elif kind == "window":
            pairs = [(g[:, :3], w[:, :3])]
        else:
            pairs = [(g[:3] if g.ndim and kind != "embed" else g,
                      w[:3] if w.ndim and kind != "embed" else w)]
        for a, b in pairs:
            if k in exact:
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                np.testing.assert_allclose(a, b, **tol, err_msg=k)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forwards_match_jax(references, tp):
    """Every rank's outputs equal (they gather the same logits and pages);
    rank 0's against the JAX unsharded forward and the JAX ModelSharding
    forward at the same tp."""
    quant, np_params, inp, refs = references
    outs = run_ranks(port_forward_rank, tp, np_params, TCfg(), tp, quant, inp)
    for other in outs[1:]:
        for k in outs[0]:
            for a, b in zip(*(([x[k]] if k != "pages" else x[k]) for x in (outs[0], other))):
                np.testing.assert_array_equal(a, b, err_msg=k)
    _compare(outs[0], refs[1], quant)
    _compare(outs[0], refs[tp], quant)
