"""The int8 decode entry's group call and cluster plan, on the CPU.

- ``int8_matmul_group`` on CPU tensors is one ``int8_matmul`` call per
  weight (the plain version), bit for bit, at any row count, dtype and
  leading dims, logits epilogue included; the per-weight calls are what a
  test counting ``int8_matmul``'s calls sees.
- The model's grouped ``_qkv`` and ``_mlp`` (int8 test-tiny weights) match
  JAX ``_qkv``/``_mlp`` built on ``_dot_q``, within
  ``tests/test_torch_int8_route.py``'s tolerances (float32 1e-5; bfloat16
  2^-7 relative plus 1e-6 absolute: both round ``x @ w`` to bfloat16
  before the scale, and sums taken in other orders may round one step
  apart).
- ``cluster_plan`` is a pure function of the shapes: a power of two of
  ranks, at most ``DECODE_MAX_RANKS`` and K's tiles, covering K with no
  empty rank, within one block per SM when it splits at all; its
  constants are the source's.
- ``decode_entry``: bf16 x of 1-8 rows at aligned shapes only.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine import quant as JQ
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.ops import int8_matmul as im

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}
SOURCE = Path(im.__file__).resolve().parent / "csrc" / "int8_matmul.cu"


def _weights(rng, K, ns, scale_dt=torch.float32):
    return [(torch.from_numpy(rng.integers(-127, 128, (K, n), dtype=np.int8)),
             torch.from_numpy(rng.random(n, dtype=np.float32) * 0.02 + 1e-3).to(scale_dt))
            for n in ns]


@pytest.mark.parametrize("M", [1, 5, 8, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_f32", [False, True])
def test_group_on_the_cpu_is_the_plain_version_bit_for_bit(M, dtype, out_f32):
    rng = np.random.default_rng(M)
    K = 96
    for ns, lead in (([64, 16, 16], (M,)), ([48, 48], (1, M)), ([32] * 5, (M, 1))):
        x = torch.from_numpy(rng.standard_normal((*lead, K), dtype=np.float32)).to(
            getattr(torch, dtype))
        ws = _weights(rng, K, ns, torch.bfloat16 if len(ns) == 2 else torch.float32)
        outs = im.int8_matmul_group(x, ws, out_f32=out_f32)
        assert len(outs) == len(ws)
        for o, (w, s) in zip(outs, ws):
            want = im.int8_matmul_ref(x, w, s, out_f32)
            assert o.shape == (*lead, w.shape[1]) and o.dtype == want.dtype
            assert torch.equal(o, want)


def test_group_on_the_cpu_calls_int8_matmul_per_weight(monkeypatch):
    calls = []
    real = im.int8_matmul

    def counting(x, w, scale, out_f32=False):
        calls.append(tuple(w.shape))
        return real(x, w, scale, out_f32)

    monkeypatch.setattr(im, "int8_matmul", counting)
    rng = np.random.default_rng(0)
    x = torch.randn(8, 64)
    before = (im.launches, im.decode_launches)
    im.int8_matmul_group(x, _weights(rng, 64, [32, 16, 16]))
    assert calls == [(64, 32), (64, 16), (64, 16)]
    assert (im.launches, im.decode_launches) == before  # the plain version launches nothing


@pytest.fixture(scope="module")
def int8_layer():
    jcfg = JCfg(tie_embeddings=False)
    tree = jax.tree.map(np.array, JM.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32))
    q = JQ.quantize_params_np(tree)
    return jcfg, ModelConfig(tie_embeddings=False), {k: v[0] for k, v in q["layers"].items()}


@pytest.mark.parametrize("M", [1, 8, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_qkv_and_mlp_match_jax(int8_layer, M, dtype, monkeypatch):
    jcfg, tcfg, layer = int8_layer
    groups = []
    real = im.int8_matmul_group

    def recording(x, weights, out_f32=False):
        groups.append(len(weights))
        return real(x, weights, out_f32)

    monkeypatch.setattr(im, "int8_matmul_group", recording)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jlp = {k: jnp.asarray(v) for k, v in layer.items()}
    tlp = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in layer.items()}
    rng = np.random.default_rng(10 + M)
    h = rng.standard_normal((M, tcfg.hidden_size)).astype(np.float32)
    want = JM._qkv(jnp.asarray(h, jdt), jlp, jcfg)
    got = TM._qkv(torch.from_numpy(h).to(tdt), tlp, tcfg)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   **TOL[dtype])
    want = np.asarray(JM._mlp(jnp.asarray(h, jdt), jlp).astype(jnp.float32))
    got = TM._mlp(torch.from_numpy(h).to(tdt), tlp)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    assert groups == [3, 2]  # q/k/v, then gate/up: one group call each


def test_float_weights_skip_the_group(int8_layer, monkeypatch):
    _, tcfg, layer = int8_layer
    monkeypatch.setattr(im, "int8_matmul_group", lambda *a, **k: pytest.fail("grouped"))
    lp = {k: torch.from_numpy(np.ascontiguousarray(v)).float() for k, v in layer.items()
          if not k.endswith("_scale")}
    q, k, v = TM._qkv(torch.randn(3, tcfg.hidden_size), lp, tcfg)
    assert q.shape[-1] == lp["wq"].shape[1] and v.shape[-1] == lp["wv"].shape[1]


def _source_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def test_plan_constants_are_the_sources():
    assert im.DECODE_BN == _source_constant("D_BN")
    assert im.DECODE_BK == _source_constant("D_BK")
    assert im.DECODE_MAX_RANKS == _source_constant("D_MAX_RANKS")
    assert im.DECODE_MAX_GROUP == _source_constant("D_MAX_GROUP")
    assert im.DECODE_BLOCKS_PER_SM == _source_constant("D_BLOCKS_PER_SM")


@pytest.mark.parametrize("K", [8, 64, 128, 136, 640, 1000, 2048, 3072, 4096, 7168, 14336,
                               18944, 40000])
def test_cluster_plan_covers_k_with_no_empty_rank(K):
    tiles = -(-K // im.DECODE_BK)
    wave = im.SMS
    for cols in (1, 3, 4, 8, 24, 32, 33, 48, 66, 67, 112, 131, 132, 133, 224, 501, 1002, 5000):
        ranks, per = im.cluster_plan(K, cols)
        assert im.cluster_plan(K, cols) == (ranks, per)  # a function of the shapes
        assert 1 <= ranks <= min(im.DECODE_MAX_RANKS, tiles)
        assert ranks & (ranks - 1) == 0
        assert per == -(-tiles // ranks) and (ranks - 1) * per < tiles <= ranks * per
        if ranks > 1:
            assert ranks * cols <= wave
        if cols * 2 > wave:
            assert ranks == 1
        if ranks < min(im.DECODE_MAX_RANKS, tiles):  # twice the ranks: past one wave or empty
            twice = 2 * ranks
            assert twice * cols > wave or (twice - 1) * -(-tiles // twice) >= tiles


def test_cluster_plans_at_llama_8b():
    """wq/wk/wv as one group (48 column blocks), wo, gate/up as one group
    (224), w_down, lm_head (1,002 blocks: one rank), wk alone, and a tp=2
    rank's q/k/v group, wo, gate/up group and w_down."""
    assert im.cluster_plan(4096, 48) == (2, 16)
    assert im.cluster_plan(4096, 32) == (4, 8)
    assert im.cluster_plan(4096, 224) == (1, 32)
    assert im.cluster_plan(14336, 32) == (4, 28)
    assert im.cluster_plan(4096, 1002) == (1, 32)
    assert im.cluster_plan(4096, 8) == (8, 4)
    assert im.cluster_plan(4096, 24) == (4, 8)
    assert im.cluster_plan(2048, 32) == (4, 4)
    assert im.cluster_plan(4096, 112) == (1, 32)
    assert im.cluster_plan(7168, 32) == (4, 14)


def test_decode_entry_takes_aligned_bf16_of_up_to_8_rows():
    w = torch.zeros((4096, 1024), dtype=torch.int8)
    if w.data_ptr() % 16:
        pytest.skip("this allocation is not 16-byte aligned")
    for M in range(1, 9):
        assert im.decode_entry(torch.zeros((M, 4096), dtype=torch.bfloat16), w)
        assert not im.decode_entry(torch.zeros((M, 4096)), w)  # f32 x
    assert not im.decode_entry(torch.zeros((9, 4096), dtype=torch.bfloat16), w)
    assert not im.decode_entry(torch.zeros((0, 4096), dtype=torch.bfloat16), w)
    odd = torch.zeros((1000, 200), dtype=torch.int8)
    assert not im.decode_entry(torch.zeros((8, 1000), dtype=torch.bfloat16), odd)  # N % 16
    assert not im.decode_entry(torch.zeros((8, 4092), dtype=torch.bfloat16),
                               torch.zeros((4092, 1024), dtype=torch.int8))  # K % 8
    shifted = torch.zeros(4096 * 1024 + 1, dtype=torch.int8)[1:].view(4096, 1024)
    assert not im.decode_entry(torch.zeros((8, 4096), dtype=torch.bfloat16), shifted)
