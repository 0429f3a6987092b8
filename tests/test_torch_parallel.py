"""The port's shard rules (``dynamo_tpu_torch/parallel/mesh.py``) against the
JAX package's ``parallel/mesh.py``, on the CPU.

``split_tp`` equals JAX's over a grid of configs and tp degrees (llama-70b
at tp 16 included), errors word for word. Each rank's shards equal the
data JAX places on that rank's device: ``jax.device_put(params,
ModelSharding(mesh, cfg).param_shardings(params))`` on the 8 virtual CPU
devices, the device of rank r at (i, j) = divmod(r, tp_rep) of the mesh's
(tp_kv, tp_rep) grid. Covered: tp 2/4/8, tp_rep > 1, int8 weights with
their scales, attention biases, MoE expert stacks, a vocabulary that does
not divide (replicated embed and head), the KV cache's lanes
(``shard_cache``), and the divisibility errors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.quant import quantize_params_np
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.parallel import mesh as tmesh


def _cfg(**kw):
    base = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=8, num_kv_heads=2, head_dim=8)
    base.update(kw)
    return JCfg(**base), TCfg(**base)


@pytest.mark.parametrize("preset", ["test-tiny", "llama-1b", "llama-3b", "llama-8b",
                                    "llama-70b", "qwen2-7b", "moe-tiny"])
def test_split_tp_matches_jax(preset):
    jcfg = JCfg.preset(preset)
    tcfg = TCfg(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TCfg)})
    for tp in (1, 2, 3, 4, 6, 8, 16, 32, 64):
        try:
            want = jmesh.split_tp(tp, jcfg)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tmesh.split_tp(tp, tcfg)
            assert str(got.value) == str(e)
            continue
        assert tmesh.split_tp(tp, tcfg) == want
    if preset == "llama-70b":
        assert tmesh.split_tp(16, tcfg) == (8, 2)


def _device_rank(mesh) -> dict:
    """device id → port rank, from the mesh's row-major (tp_kv, tp_rep) grid."""
    grid = mesh.devices[0, 0]
    tp_rep = grid.shape[1]
    return {grid[i, j].id: i * tp_rep + j for i in range(grid.shape[0])
            for j in range(grid.shape[1])}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


CASES = {
    # name: (config overrides, tp, int8)
    "tp2": ({}, 2, False),
    "tp4_rep2": ({}, 4, False),
    "tp8_rep4": ({}, 8, False),
    "tp4_int8": ({}, 4, True),
    "tp8_int8_bias": ({"attn_bias": True}, 8, True),
    "tp2_bias_untied": ({"attn_bias": True, "tie_embeddings": False}, 2, False),
    "tp4_untied_int8": ({"tie_embeddings": False}, 4, True),
    "tp4_vocab_replicated": ({"vocab_size": 510, "tie_embeddings": False}, 4, True),
    "tp4_moe": ({"num_experts": 4, "num_experts_per_token": 2}, 4, False),
    "tp2_moe_ie": ({"num_experts": 4, "moe_intermediate_size": 64}, 2, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shards_equal_jax_placement(case):
    over, tp, int8 = CASES[case]
    jcfg, tcfg = _cfg(**over)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32))
    if int8:
        params = quantize_params_np(params)
    mesh = jmesh.build_mesh(tp=tp, cfg=jcfg)
    placed = jax.device_put(params, jmesh.ModelSharding(mesh, jcfg).param_shardings(params))
    rank_of = _device_rank(mesh)
    shards = [tmesh.ModelSharding(tcfg, tp, r).shard_params(params) for r in range(tp)]
    for path, leaf in _flat(params):
        arr = _get(placed, path)
        for s in arr.addressable_shards:
            got = _get(shards[rank_of[s.device.id]], path)
            assert got.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(got, np.asarray(s.data), err_msg=str(path))
    # A tree of shards passes through unchanged (the loader's output).
    again = tmesh.ModelSharding(tcfg, tp, 1).shard_params(shards[1])
    for path, leaf in _flat(shards[1]):
        assert _get(again, path) is leaf


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_cache_lanes_equal_jax_shard_cache(tp, kv_quant):
    """``shard_pages`` cuts full pages as ``shard_cache`` places the cache,
    and ``merge_lanes`` of every rank's lanes in rank order is the full
    page again."""
    import torch

    jcfg, tcfg = _cfg()
    rng = np.random.default_rng(0)
    L, N, bs, KVH, hd = 2, 3, 4, jcfg.num_kv_heads, jcfg.head_dim
    full = [rng.standard_normal((L, N, bs, KVH * hd)).astype(np.float32) for _ in range(2)]
    if kv_quant == "int8":
        full = [rng.integers(-127, 128, (L, N, bs, KVH * hd)).astype(np.int8) for _ in range(2)]
        full += [rng.random((L, N, bs, KVH)).astype(np.float32) for _ in range(2)]
    cache = JM.KVCache(*map(jnp.asarray, full))
    mesh = jmesh.build_mesh(tp=tp, cfg=jcfg)
    placed = jmesh.ModelSharding(mesh, jcfg).shard_cache(cache)
    rank_of = _device_rank(mesh)
    lanes = [tmesh.ModelSharding(tcfg, tp, r).shard_pages(tuple(full)) for r in range(tp)]
    for k, arr in enumerate(placed):
        for s in arr.addressable_shards:
            np.testing.assert_array_equal(lanes[rank_of[s.device.id]][k], np.asarray(s.data))
    sh = tmesh.ModelSharding(tcfg, tp, 0)
    for k, page in enumerate(full):
        gathered = torch.cat([torch.from_numpy(lanes[r][k]) for r in range(tp)], dim=-1)
        np.testing.assert_array_equal(sh.merge_lanes(gathered).numpy(), page)


def test_local_view_and_vocab_slices():
    _, tcfg = _cfg()
    sh = tmesh.ModelSharding(tcfg, 8, 5)
    assert (sh.tp_kv, sh.tp_rep, sh.i, sh.j) == (2, 4, 1, 1)
    loc = sh.local
    assert (loc.num_heads, loc.num_kv_heads, loc.intermediate_size, loc.vocab_size) == (
        1, 1, 16, 512)
    assert (sh.vocab_lo, sh.vocab_hi, sh.vocab_sharded) == (320, 384, True)
    assert sh.lanes(tcfg.head_dim) == (8, 16)
    odd = tmesh.ModelSharding(dataclasses.replace(tcfg, vocab_size=510), 4, 3)
    assert (odd.vocab_sharded, odd.vocab_lo, odd.vocab_hi) == (False, 0, 510)


def test_divisibility_errors_match_jax():
    # query groups beyond what tp_rep can split: build_mesh / split_tp
    jcfg, tcfg = _cfg(num_heads=4, num_kv_heads=2)
    with pytest.raises(ValueError) as want:
        jmesh.build_mesh(tp=8, cfg=jcfg)
    with pytest.raises(ValueError) as got:
        tmesh.ModelSharding(tcfg, 8, 0)
    assert str(got.value) == str(want.value)
    # FFN width
    jcfg, tcfg = _cfg(intermediate_size=100)
    with pytest.raises(ValueError) as want:
        jmesh.ModelSharding(jmesh.build_mesh(tp=8, cfg=jcfg), jcfg)
    with pytest.raises(ValueError) as got:
        tmesh.ModelSharding(tcfg, 8, 0)
    assert str(got.value) == str(want.value)
    # experts over ep: the JAX message for an uneven split
    jcfg, tcfg = _cfg(num_experts=3)
    with pytest.raises(ValueError) as want:
        jmesh.ModelSharding(jmesh.build_mesh(tp=2, ep=2, cfg=jcfg), jcfg)
    with pytest.raises(ValueError) as got:
        tmesh.ModelSharding(tcfg, 2, 0, ep=2)
    assert str(got.value) == str(want.value) == "num_experts=3 not divisible by ep=2"
    with pytest.raises(ValueError, match="rank 2 outside tp=2"):
        tmesh.ModelSharding(tcfg, 2, 2)
    # a leaf of neither the model's size nor a shard's
    _, tcfg = _cfg()
    with pytest.raises(ValueError, match="neither the model's"):
        tmesh.ModelSharding(tcfg, 2, 0).shard_leaf(("layers", "wq"), np.zeros((2, 64, 24)))


def test_ep_is_accepted():
    """ep = 2 over tp = 2: four ranks, each with its ep block's experts and
    its tp rank's attention and vocabulary; a dense model takes ep too (its
    FFN replicated over ep), as the JAX ModelSharding does."""
    _, tcfg = _cfg(num_experts=4, num_experts_per_token=2)
    got = [tmesh.ModelSharding(tcfg, 2, r, ep=2) for r in range(4)]
    assert [(sh.e, sh.tp_rank, sh.experts) for sh in got] == [
        (0, 0, (0, 2)), (0, 1, (0, 2)), (1, 0, (2, 4)), (1, 1, (2, 4))]
    assert [(sh.vocab_lo, sh.vocab_hi, sh.lanes(tcfg.head_dim)) for sh in got] == [
        (0, 256, (0, 8)), (256, 512, (8, 16))] * 2
    assert got[3].local.num_experts == 4 and got[3].local.num_heads == 4
    _, dense = _cfg()
    jcfg, _ = _cfg()
    jmesh.ModelSharding(jmesh.build_mesh(tp=2, ep=2, cfg=jcfg), jcfg)
    assert tmesh.ModelSharding(dense, 2, 3, ep=2).leaf_rules(("layers", "w_gate")) == [
        (2, 2, 1)]
