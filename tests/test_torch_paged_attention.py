"""The port's plain paged attention vs the JAX package's, on the CPU.

Same numpy inputs (seeded) go through dynamo_tpu_torch's plain version
and through dynamo_tpu's XLA gather path and its Pallas kernel in
interpret mode (as tests/test_ops_attention.py runs it). Everything is
float32, so the only differences are summation order: tolerance 1e-5
absolute and relative. Dead rows and dead query slots are junk by the
JAX contract, so comparisons against JAX cover live queries; the port's
own contract (zeros there, NaN never leaking) is checked separately.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.ops import paged_attention as tpa

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once on a few cores: these
    tiny shapes gain nothing from torch's intra-op thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_anc(parents: list[int], T: int) -> np.ndarray:
    anc = np.zeros((T, T), np.int8)
    anc[0, 0] = 1
    for j, p in enumerate(parents, start=1):
        anc[j] = anc[p]
        anc[j, j] = 1
    return anc


def _inputs(seed, B, T, L=2, N=40, bs=8, KVH=2, G=2, hd=64, W=6, quant=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, KVH, G, hd)).astype(np.float32)
    tables = rng.integers(1, N, size=(B, W)).astype(np.int32)
    if quant:
        kc = rng.integers(-127, 128, (L, N, bs, KVH * hd)).astype(np.int8)
        vc = rng.integers(-127, 128, (L, N, bs, KVH * hd)).astype(np.int8)
        ks = (np.abs(rng.standard_normal((L, N, bs, KVH))) * 0.02 + 1e-3).astype(np.float32)
        vs = (np.abs(rng.standard_normal((L, N, bs, KVH))) * 0.02 + 1e-3).astype(np.float32)
        return q, kc, vc, tables, ks, vs
    kc = rng.standard_normal((L, N, bs, KVH * hd)).astype(np.float32)
    vc = rng.standard_normal((L, N, bs, KVH * hd)).astype(np.float32)
    return q, kc, vc, tables, None, None


def _both(q, kc, vc, tables, lengths, ks, vs, anc, layer):
    """→ (port plain, JAX XLA, JAX Pallas interpret) outputs as numpy."""
    T = torch.from_numpy
    J = jnp.asarray
    port = tpa.paged_spec_attention(
        T(q), T(kc), T(vc), layer, T(tables), T(lengths),
        None if ks is None else T(ks), None if vs is None else T(vs),
        None if anc is None else T(anc),
    ).numpy()
    jargs = (J(q), J(kc), J(vc), jnp.int32(layer), J(tables), J(lengths),
             None if ks is None else J(ks), None if vs is None else J(vs))
    janc = None if anc is None else J(anc)
    xla = np.asarray(jpa.paged_spec_attention_xla(*jargs, anc=janc))
    pallas = np.asarray(jpa.paged_spec_attention(*jargs, janc, interpret=True))
    return port, xla, pallas


@pytest.mark.parametrize("lengths,quant", [
    ([40, 1, 0, 37, 47], False),   # mixed, incl. inactive + non-block-aligned
    ([16, 16, 8, 40, 5], True),    # int8 pages
])
def test_decode_matches_jax(lengths, quant):
    B = len(lengths)
    q, kc, vc, tables, ks, vs = _inputs(1, B, 1, quant=quant)
    lens = np.asarray(lengths, np.int32)[:, None]
    before = tpa.launches
    for layer in (0, 1):
        port, xla, pallas = _both(q, kc, vc, tables, lens, ks, vs, None, layer)
        live = lens[:, 0] > 0
        np.testing.assert_allclose(port[live], xla[live], **TOL)
        np.testing.assert_allclose(port[live], pallas[live], **TOL)
        assert np.all(port[~live] == 0.0)
        dec = tpa.paged_decode_attention(
            torch.from_numpy(q[:, 0]), torch.from_numpy(kc), torch.from_numpy(vc), layer,
            torch.from_numpy(tables), torch.from_numpy(lens[:, 0]),
            None if ks is None else torch.from_numpy(ks), None if vs is None else torch.from_numpy(vs),
        ).numpy()
        np.testing.assert_array_equal(dec, port[:, 0])
    assert tpa.launches == before  # CPU tensors never reach the kernel


@pytest.mark.parametrize("S,quant", [(4, False), (2, True)])
def test_linear_spec_matches_jax(S, quant):
    T = S + 1
    q, kc, vc, tables, ks, vs = _inputs(2 + S, 4, T, quant=quant)
    base = np.array([7, 8 - T, 3, 0], np.int32).clip(min=0)
    lens = (base[:, None] + np.arange(1, T + 1, dtype=np.int32)[None, :]).astype(np.int32)
    lens[3, :] = 0          # dead row
    lens[2, -1] = 0         # dead trailing slot
    port, xla, pallas = _both(q, kc, vc, tables, lens, ks, vs, None, 1)
    live = lens > 0
    np.testing.assert_allclose(port[live], xla[live], **TOL)
    np.testing.assert_allclose(port[live], pallas[live], **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_tree_matches_jax(quant):
    B, T = 4, 5
    q, kc, vc, tables, ks, vs = _inputs(31, B, T, quant=quant)
    anc = np.broadcast_to(_tree_anc([0, 0, 1, 1], T), (B, T, T)).copy()
    anc[3] = 0               # dead row
    anc[2, 4, :] = 0
    anc[2, :, 4] = 0         # row 2: trailing slot undrafted
    hist = np.array([7, 8, 15, 0], np.int32)
    lens = np.broadcast_to(hist[:, None], (B, T)).copy()
    port, xla, pallas = _both(q, kc, vc, tables, lens, ks, vs, anc, 0)
    live = anc.any(axis=2)
    np.testing.assert_allclose(port[live], xla[live], **TOL)
    np.testing.assert_allclose(port[live], pallas[live], **TOL)
    assert np.all(port[3] == 0.0)


@pytest.mark.parametrize("quant", [False, True])
def test_tree_row_without_live_node_outputs_zeros(quant):
    """The tree-row contract: a row whose ``anc`` is all zero attends
    nothing, even with lengths above zero, so it outputs zeros in the JAX
    package's Pallas kernel (interpret mode, ``rowlen = 0``) and in the
    port's plain version alike; the live rows beside it agree as before."""
    B, T = 4, 5
    q, kc, vc, tables, ks, vs = _inputs(41, B, T, quant=quant)
    anc = np.broadcast_to(_tree_anc([0, 0, 1, 1], T), (B, T, T)).copy()
    anc[1] = 0               # no live node, history 12
    anc[3] = 0               # no live node, history 30
    hist = np.array([7, 12, 15, 30], np.int32)
    lens = np.broadcast_to(hist[:, None], (B, T)).copy()
    port, _xla, pallas = _both(q, kc, vc, tables, lens, ks, vs, anc, 1)
    dead = ~anc.any(axis=(1, 2))
    assert np.all(pallas[dead] == 0.0) and np.all(port[dead] == 0.0)
    np.testing.assert_allclose(port[~dead], pallas[~dead], **TOL)


def test_nan_tails_never_leak():
    """Positions past each row's length hold NaN: the port's output on the
    poisoned cache equals the JAX reference on the clean one."""
    B, T, bs = 4, 3, 8
    q, kc, vc, tables, _, _ = _inputs(5, B, T, bs=bs)
    # Distinct pages per row so poisoning one row's tail never hits another's.
    tables = np.arange(1, 1 + B * 6, dtype=np.int32).reshape(B, 6)
    lens = np.array([[9, 10, 11], [16, 17, 18], [0, 0, 0], [1, 2, 3]], np.int32)
    walk = lens.max(axis=1)
    poisoned_k, poisoned_v = kc.copy(), vc.copy()
    for b in range(B):
        for j in range(6):
            lo = walk[b] - j * bs
            if lo < bs:
                poisoned_k[:, tables[b, j], max(lo, 0):] = np.nan
                poisoned_v[:, tables[b, j], max(lo, 0):] = np.nan
    port = tpa.paged_spec_attention(
        torch.from_numpy(q), torch.from_numpy(poisoned_k), torch.from_numpy(poisoned_v), 1,
        torch.from_numpy(tables), torch.from_numpy(lens),
    ).numpy()
    assert np.isfinite(port).all()
    xla = np.asarray(jpa.paged_spec_attention_xla(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.asarray(tables), jnp.asarray(lens),
    ))
    live = lens > 0
    np.testing.assert_allclose(port[live], xla[live], **TOL)
    assert np.all(port[2] == 0.0)  # zero-length row


def test_gather_dequant_matches_jax():
    q, kc, vc, tables, ks, vs = _inputs(7, 3, 1, quant=True)
    port = tpa.gather_dequant_pages(
        torch.from_numpy(kc[1]), torch.from_numpy(ks[1]), torch.from_numpy(tables), 2, 64,
        torch.float32,
    ).numpy()
    ref = np.asarray(jpa.gather_dequant_pages(
        jnp.asarray(kc[1]), jnp.asarray(ks[1]), jnp.asarray(tables), 2, 64, jnp.float32,
    ))
    np.testing.assert_array_equal(port, ref)


def test_kv_quantize_matches_jax():
    """int8 values and f32 scales identical, incl. all-zero rows (scale 1)
    and exact .5 ties (round half to even)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7, 3, 32)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :] = 0.0
    x[1, 1, 1, 0] = 127.0
    x[1, 1, 1, 1] = 2.5    # 2.5 * 127 / 127 → tie, rounds to 2
    x[1, 1, 1, 2] = -0.5
    tq, ts = TM.kv_quantize(torch.from_numpy(x))
    jq, js = JM.kv_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and float(ts[0, 0, 0]) == 1.0


def test_resolve_attn_impl():
    cpu = torch.device("cpu")
    assert tpa.resolve_attn_impl("auto", cpu) == "torch"
    assert tpa.resolve_attn_impl("torch", cpu) == "torch"
    with pytest.raises(ValueError):
        tpa.resolve_attn_impl("cuda", cpu)
    with pytest.raises(ValueError):
        tpa.resolve_attn_impl("xla", cpu)
