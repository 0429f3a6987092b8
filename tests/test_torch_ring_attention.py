"""The port's ring attention (``dynamo_tpu_torch/ops/ring_attention.py``)
against the JAX package's ``ring_prefill`` on the CPU.

The shapes of tests/test_ring_attention.py (T 64, H 4, KVH 2, hd 16; T
128, H 8, KVH 8, hd 8; T 32, H 2, hd 8), causal, non-causal and GQA, in
float32, on rings of 2, 4 and 8 gloo rank processes
(``tests/torch_tp_ranks.py``) against the JAX op on as many virtual CPU
devices, at that test's 2e-5. Every rank holds the whole output in rank
order; a ring of n makes n − 1 exchanges a call and one gather; a
sequence that does not split evenly is refused.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dynamo_tpu.ops.ring_attention import ring_prefill as jax_ring_prefill

from torch_tp_ranks import ring_rank, run_groups

TOL = dict(atol=2e-5, rtol=2e-5)
# name: (T, H, KVH, hd, causal)
CASES = {"gqa_causal": (64, 4, 2, 16, True), "mha_causal": (128, 8, 8, 8, True),
         "mha_non_causal": (32, 2, 2, 8, False), "gqa_non_causal": (64, 4, 2, 16, False)}
RINGS = (2, 4, 8)


def _inputs(name):
    T, H, KVH, hd, causal = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return (rng.standard_normal((T, H, hd)).astype(np.float32),
            rng.standard_normal((T, KVH, hd)).astype(np.float32),
            rng.standard_normal((T, KVH, hd)).astype(np.float32), causal)


@pytest.fixture(scope="module")
def port_rings():
    """Every case on each ring: n → (outputs by rank and case, rank 0's
    counters, the uneven split's messages by rank)."""
    cases = [_inputs(name) for name in CASES]
    res = run_groups({n: (ring_rank, n, (cases,), {}) for n in RINGS})
    return {n: ([r[0] for r in rs], rs[0][1], [r[2] for r in rs]) for n, rs in res.items()}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n", RINGS)
def test_ring_prefill_matches_jax(port_rings, n, name):
    q, k, v, causal = _inputs(name)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    want = np.asarray(jax_ring_prefill(mesh, "sp", jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal))
    outs, _, _ = port_rings[n]
    idx = list(CASES).index(name)
    for rank_outs in outs:
        assert rank_outs[idx].shape == q.shape
        np.testing.assert_allclose(rank_outs[idx], want, **TOL)


@pytest.mark.parametrize("n", RINGS)
def test_ring_exchanges_and_uneven_split(port_rings, n):
    _, counters, errs = port_rings[n]
    calls = counters["calls"]
    assert calls == {"all_reduce": 0, "all_gather": len(CASES),
                     "ppermute": (n - 1) * len(CASES)}
    kv_bytes = sum(2 * (T // n) * KVH * hd * 4 for T, _, KVH, hd, _ in CASES.values())
    out_bytes = sum((T // n) * H * hd * 4 for T, H, _, hd, _ in CASES.values())
    assert counters["bytes"] == (n - 1) * kv_bytes + out_bytes
    assert errs == [f"sequence length 63 not divisible by {n} ring ranks"] * n
