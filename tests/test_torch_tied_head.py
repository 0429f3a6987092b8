"""The int8 tied head on the CPU: its route and its plain version.

llama-1b and llama-3b tie the logits to the int8 embedding [V, D], which
``_logits`` passes as the view ``emb.T``. On the card that view goes to the
int8 kernel's tied-head entry (``route`` → "tied"), which reads the
embedding as stored; only more than ``MAX_M`` rows take the prefill route.
Fake CUDA tensors show the routing here (the kernel itself runs only on
the card, tests/test_torch_int8_matmul_cuda.py). On the CPU ``_logits`` of a
tied int8 model is the plain version, which must equal the JAX package's
``_logits`` on the same int8 parameters; the graph counters carry the
tied-head launches.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.quant import quantize_params_np as jquantize
from dynamo_tpu_torch.engine import graphs
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import int8_matmul as im


def test_route_sends_the_transposed_embedding_to_the_tied_entry():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        emb = torch.empty((1000, 256), dtype=torch.int8, device="cuda")
        x8 = torch.empty((8, 256), dtype=torch.bfloat16, device="cuda")
        x65 = torch.empty((65, 256), dtype=torch.bfloat16, device="cuda")
        assert im.route(x8, emb.T) == "tied"
        assert im.route(x8.reshape(2, 4, 256), emb.T) == "tied"
        assert im.route(x65, emb.T) == "prefill"
        # Fake CUDA tensors take no indexing or copies here: build each layout.
        dense = torch.empty_strided((256, 1000), (1000, 1), dtype=torch.int8, device="cuda")
        strided = torch.empty_strided((256, 1000), (2000, 2), dtype=torch.int8, device="cuda")
        assert im.route(x8, dense) == "kernel"
        assert im.route(x8, strided) == "prefill"


def test_tied_cuda_call_launches_or_raises(monkeypatch):
    """A CUDA call with emb.T goes to the tied entry: with the kernel
    library absent it raises; it never takes the prefill route or the plain
    version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def absent(name):
        raise RuntimeError("kernel library absent")

    plain = []
    monkeypatch.setattr(_build, "library", absent)
    monkeypatch.setattr(im, "int8_matmul_ref", lambda *a, **k: plain.append(a))
    before = (im.launches, im.prefill_launches, im.tied_launches)
    with FakeTensorMode():
        emb = torch.empty((1000, 256), dtype=torch.int8, device="cuda")
        s = torch.empty((1000,), device="cuda")
        with pytest.raises(RuntimeError, match="kernel library absent"):
            im.int8_matmul(torch.empty((8, 256), device="cuda"), emb.T, s, out_f32=True)
    assert plain == [] and (im.launches, im.prefill_launches, im.tied_launches) == before


def test_graph_counters_include_the_tied_head():
    assert (im, "tied_launches") in graphs.COUNTERS
    assert graphs.COUNTERS[:3] == ((graphs.pa, "launches"), (im, "launches"),
                                   (im, "prefill_launches"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_int8_logits_equal_the_jax_package(dtype):
    """test-tiny ties its head: ``_logits`` on int8 parameters (quantized by
    the JAX package) against the JAX ``_logits``, f32 within 1e-4 of the
    value; bf16 rounds x @ w to bf16 in both, within 2^-7 relative."""
    cfg = JCfg()
    assert cfg.tie_embeddings and ModelConfig().tie_embeddings
    np_params = jquantize(jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(3),
                                                                  jnp.float32)))
    params = jax.tree.map(jnp.asarray, np_params)
    x = np.random.default_rng(0).standard_normal((5, cfg.hidden_size)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jax.tree.map(lambda a: a if a.dtype == jnp.int8 else a.astype(jdt), params)
    want = np.asarray(JM._logits(cfg, jp, jnp.asarray(x, jdt)), np.float32)
    tdt = getattr(torch, dtype)
    tp = params_from_numpy(np_params, "cpu", tdt)
    assert tp["embed"].dtype == torch.int8
    got = TM._logits(ModelConfig(), tp, torch.from_numpy(x).to(tdt)).numpy()
    ref = im.int8_matmul_ref(TM._rms_norm(torch.from_numpy(x).to(tdt), tp["final_norm"],
                                          cfg.rms_norm_eps),
                             tp["embed"].T, tp["embed_scale"], out_f32=True).numpy()
    assert np.array_equal(got, ref)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
