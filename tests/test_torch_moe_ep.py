"""Expert parallelism in the port (``ModelSharding(..., ep=)``, ``model._moe``
under ep) against the JAX package on the CPU.

- Decode steps of moe-tiny in float32 on ep × tp gloo rank processes
  (``tests/torch_tp_ranks.py``), ep 4 × tp 2 and ep 2 × tp 1, from an
  empty cache: the first at tests/test_moe.py's positions, the second at
  its greedy tokens one position on. Every rank's logits equal the port
  unsharded and the JAX sharded step (tests/test_moe.py:64-76, ``build_mesh
  (tp, ep)`` on the virtual CPU devices) within that test's 2e-4. The
  collectives run over the right axes: attention, the embedding and the
  logits over the tp block (none at tp 1), the MoE combine over all ranks.
- Each rank's shards equal the data the JAX ``param_shardings`` place on
  its device, rank r at (e, i, j) of the mesh's row-major (ep, tp_kv,
  tp_rep) grid.
- ``num_experts % ep`` is refused with the JAX message.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import ModelConfig as TCfg
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.parallel import mesh as tmesh

from torch_tp_ranks import moe_ep_rank, run_groups

TOL = dict(atol=2e-4, rtol=2e-4)
GRIDS = ((4, 2), (2, 1))  # (ep, tp)
STEPS = 2
JCFG, TCFG = JCfg.preset("moe-tiny"), TCfg.preset("moe-tiny")


def _inputs() -> dict:
    rng = np.random.default_rng(1)
    N, bs, B, W = 32, 8, 4, 4
    return {"N": N, "bs": bs,
            "tokens": rng.integers(1, JCFG.vocab_size - 1, B).astype(np.int32),
            "positions": np.array([3, 0, 9, 5], np.int32),
            "tables": rng.permutation(np.arange(1, N))[:B * W].reshape(B, W).astype(np.int32)}


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32))


@pytest.fixture(scope="module")
def unsharded(np_params):
    """The port's steps on one process → each step's logits."""
    inp = _inputs()
    params = params_from_numpy(np_params, "cpu", torch.float32)
    cache = TM.init_kv_cache(TCFG, inp["N"], inp["bs"], torch.float32, torch.device("cpu"))
    t = torch.from_numpy
    tokens, pos, out = t(inp["tokens"]), t(inp["positions"]), []
    for _ in range(STEPS):
        logits = TM.decode_step(TCFG, params, cache, tokens, pos, t(inp["tables"]),
                                torch.ones_like(tokens, dtype=torch.bool))
        out.append(logits.numpy())
        tokens, pos = logits.argmax(-1).to(torch.int32), pos + 1
    return out


def _jax_steps(np_params, ep, tp):
    inp = _inputs()
    mesh = jmesh.build_mesh(tp=tp, ep=ep, cfg=JCFG)
    sh = jmesh.ModelSharding(mesh, JCFG)
    params = sh.shard_params(np_params)
    cache = JM.KVCache(*sh.shard_cache(JM.init_kv_cache(JCFG, inp["N"], inp["bs"],
                                                        jnp.float32)))
    tokens, pos = jnp.asarray(inp["tokens"]), jnp.asarray(inp["positions"])
    active = jnp.ones(tokens.shape, bool)
    out = []
    for _ in range(STEPS):
        logits, cache = JM.decode_step(JCFG, params, cache, tokens, pos,
                                       jnp.asarray(inp["tables"]), active)
        out.append(np.asarray(logits))
        tokens, pos = jnp.argmax(logits, -1).astype(jnp.int32), pos + 1
    return out


@pytest.fixture(scope="module")
def port_grids(np_params):
    """(ep, tp) → every rank's (logits by step, counters)."""
    return run_groups({(ep, tp): (moe_ep_rank, ep * tp,
                                  (np_params, TCFG, tp, ep, _inputs(), STEPS), {"ep": ep})
                       for ep, tp in GRIDS})


@pytest.mark.parametrize("ep,tp", GRIDS)
def test_ep_decode_steps_equal_unsharded_and_jax(np_params, unsharded, port_grids, ep, tp):
    want = _jax_steps(np_params, ep, tp)
    for step in range(STEPS):
        np.testing.assert_allclose(unsharded[step], want[step], **TOL)
        for logits, _counters in port_grids[(ep, tp)]:
            np.testing.assert_allclose(logits[step], unsharded[step], **TOL)
            np.testing.assert_allclose(logits[step], want[step], **TOL)


@pytest.mark.parametrize("ep,tp", GRIDS)
def test_ep_collectives_run_over_their_axes(port_grids, ep, tp):
    L, B, D, V = TCFG.num_layers, 4, TCFG.hidden_size, TCFG.vocab_size
    for _logits, counters in port_grids[(ep, tp)]:
        assert (counters["ep"], counters["tp"]) == (ep, tp)
        # A step: the MoE combine a layer over every rank; at tp > 1 also
        # the vocabulary-split embedding, wo a layer and the logits' gather.
        per_step = {"all_reduce": L + (1 + L if tp > 1 else 0),
                    "all_gather": 1 if tp > 1 else 0, "ppermute": 0}
        assert counters["calls"] == {k: STEPS * v for k, v in per_step.items()}
        moved = (per_step["all_reduce"] * B * D + per_step["all_gather"] * B * V // tp) * 4
        assert counters["bytes"] == STEPS * moved


@pytest.mark.parametrize("ep,tp,over", [
    (4, 2, {}), (2, 1, {}), (2, 2, {"moe_intermediate_size": 64}),
    (2, 4, {"num_heads": 8, "num_kv_heads": 2, "num_experts": 8}),
])
def test_ep_shards_equal_jax_placement(ep, tp, over):
    jcfg, tcfg = dataclasses.replace(JCFG, **over), dataclasses.replace(TCFG, **over)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32))
    mesh = jmesh.build_mesh(tp=tp, ep=ep, cfg=jcfg)
    placed = jax.device_put(params, jmesh.ModelSharding(mesh, jcfg).param_shardings(params))
    grid = mesh.devices[0]  # (ep, tp_kv, tp_rep)
    rank_of = {grid[e, i, j].id: e * tp + i * grid.shape[2] + j
               for e in range(grid.shape[0]) for i in range(grid.shape[1])
               for j in range(grid.shape[2])}
    shards = [tmesh.ModelSharding(tcfg, tp, r, ep=ep) for r in range(ep * tp)]
    mine = [sh.shard_params(params) for sh in shards]

    def flat(tree, prefix=()):
        for k, v in tree.items():
            yield from flat(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]

    for path, _leaf in flat(params):
        arr = placed
        for k in path:
            arr = arr[k]
        for s in arr.addressable_shards:
            got = mine[rank_of[s.device.id]]
            for k in path:
                got = got[k]
            assert got.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(got, np.asarray(s.data), err_msg=str(path))
    E = tcfg.num_experts
    assert [sh.experts for sh in shards] == [(r // tp * E // ep, (r // tp + 1) * E // ep)
                                             for r in range(ep * tp)]


def test_ep_refusal_matches_jax():
    jcfg, tcfg = dataclasses.replace(JCFG, num_experts=6), dataclasses.replace(TCFG, num_experts=6)
    with pytest.raises(ValueError) as want:
        jmesh.ModelSharding(jmesh.build_mesh(tp=2, ep=4, cfg=jcfg), jcfg)
    with pytest.raises(ValueError) as got:
        tmesh.ModelSharding(tcfg, 2, 0, ep=4)
    assert str(got.value) == str(want.value) == "num_experts=6 not divisible by ep=4"
