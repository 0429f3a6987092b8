"""The port's pipeline parallelism (``dynamo_tpu_torch/ops/pipeline.py``)
against the JAX package's ``pipeline_apply`` on the CPU.

tests/test_pipeline.py's network (8 residual RMSNorm + SwiGLU layers, D
32, I 64, batch 16) in float32 at (stages, microbatches) (4, 4), (8, 2)
and (2, 8), each stage a gloo rank process (``tests/torch_tp_ranks.py``),
against the JAX op on as many virtual CPU devices and against the
sequential scan, at that test's 2e-5. Every rank holds the whole output;
a schedule of M microbatches over n stages makes M + n − 1 exchanges and
one sum; a batch that does not split into the microbatches is refused
with the JAX message.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh

from dynamo_tpu.ops.pipeline import pipeline_apply as jax_pipeline_apply

from torch_tp_ranks import pipeline_rank, run_groups

TOL = dict(atol=2e-5, rtol=2e-5)
SCHEDULES = ((4, 4), (8, 2), (2, 8))
L, D, I, B = 8, 32, 64, 16


def _layer_fn(x, lp):
    xf = x.astype(jnp.float32)
    h = (xf * lax.rsqrt(jnp.mean(xf * xf, -1, keepdims=True) + 1e-5)).astype(x.dtype)
    g = jnp.dot(h, lp["w_gate"])
    u = jnp.dot(h, lp["w_up"])
    return x + jnp.dot(jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype) * u, lp["w_down"])


def _params():
    rng = np.random.default_rng(0)
    s = lambda *sh: (rng.standard_normal(sh) * 0.05).astype(np.float32)  # noqa: E731
    return {"w_gate": s(L, D, I), "w_up": s(L, D, I), "w_down": s(L, I, D)}


def _x():
    return np.random.default_rng(1).standard_normal((B, D)).astype(np.float32)


@pytest.fixture(scope="module")
def port_schedules():
    """(stages, M) → every rank's (output, bad-microbatch message,
    counters)."""
    return run_groups({(n, m): (pipeline_rank, n, (_params(), _x(), [m]), {})
                       for n, m in SCHEDULES})


@pytest.mark.parametrize("stages,M", SCHEDULES)
def test_pipeline_matches_jax_and_sequential(port_schedules, stages, M):
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    x = jnp.asarray(_x())
    mesh = Mesh(np.array(jax.devices()[:stages]), ("pp",))
    want = np.asarray(jax_pipeline_apply(mesh, "pp", params, x, _layer_fn, M))
    seq, _ = lax.scan(lambda c, lp: (_layer_fn(c, lp), None), x, params)
    for outs, _err, _counters in port_schedules[(stages, M)]:
        assert outs[0].shape == (B, D)
        np.testing.assert_allclose(outs[0], want, **TOL)
        np.testing.assert_allclose(outs[0], np.asarray(seq), **TOL)


@pytest.mark.parametrize("stages,M", SCHEDULES)
def test_pipeline_exchanges(port_schedules, stages, M):
    for _outs, _err, counters in port_schedules[(stages, M)]:
        assert counters["calls"] == {"all_reduce": 1, "all_gather": 0,
                                     "ppermute": M + stages - 1}
        mb_bytes = B // M * D * 4
        assert counters["bytes"] == (M + stages - 1) * mb_bytes + B * D * 4


def test_pipeline_rejects_bad_microbatch(port_schedules):
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    params = {k: jnp.asarray(v[:4, :8, :16] if k != "w_down" else v[:4, :16, :8])
              for k, v in _params().items()}
    with pytest.raises(ValueError, match="not divisible") as want:
        jax_pipeline_apply(mesh, "pp", params, jnp.zeros((10, 8), jnp.float32), _layer_fn, 3)
    errs = [err for _outs, err, _counters in port_schedules[(2, 8)]]
    assert errs == [str(want.value)] * 2
