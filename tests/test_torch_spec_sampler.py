"""The port's speculative acceptance against the JAX package's, on the CPU.

Same numpy inputs (seeded logits, drafts and tree topologies) go through
``dynamo_tpu_torch.engine.sampler`` and ``dynamo_tpu.engine.sampler``:

- the noise: the accept uniforms (tags 1 and 3) are bit-exact, the
  residual/correction Gumbels (tags 2 and 4, and the untagged dense key
  of draft-less rows) agree within 2 ulp of max(|g|, 1), float32 ``log``
  differing in the last bit between the frameworks
  (tests/test_torch_threefry.py);
- ``spec_acceptance`` and ``spec_tree_acceptance`` in "greedy" and
  "simple" mode: emitted tokens and ``n_emit`` equal, and for trees the
  path and per-node argmax equal. Logits are drawn so that drafts are
  accepted at every depth (drafts from the argmax chain, or sampled from
  the target distribution, with a share of wrong tokens), so the runs
  exercise acceptance, rejection, correction and bonus tokens.

A row with draft length 0 is a true no-op: its token is the dense
sampler's (``sample_simple`` on the untagged (seed, step) noise).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import sampler as js
from dynamo_tpu_torch.engine import sampler as ts
from dynamo_tpu_torch.engine import threefry

ULP2 = 2 * 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seeds(rng, B):
    return rng.integers(0, 2**31 - 1, B).astype(np.uint32)


def _assert_gumbel_close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.all(np.abs(port - ref) <= ULP2 * np.maximum(np.abs(ref), 1.0))


def test_uniform_minval_bits_match_jax():
    """uniform(minval=1e-12) — the accept draws' range — is jax's."""
    seeds = np.array([0, 1, 7, 2**31 - 1], np.uint32)
    steps = np.array([0, 3, 99, 12345], np.int32)
    key = threefry.fold_in(threefry.prng_key(_t(seeds.astype(np.int64))), _t(steps))
    port = threefry.uniform(key, 64, 1e-12).numpy()
    ref = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(int(s)), int(e)), (64,), jnp.float32,
        minval=1e-12, maxval=1.0)) for s, e in zip(seeds, steps)])
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_noise_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, S1, V = 3, 5, 257
    seeds = _seeds(rng, B)
    steps0 = rng.integers(0, 1000, B).astype(np.int32)
    steps = steps0[:, None] + np.arange(S1, dtype=np.int32)[None, :]
    dense = np.array([True, False, True])
    tseeds = _t(seeds.astype(np.int64))
    np.testing.assert_array_equal(
        ts._spec_uniform(tseeds, _t(steps[:, :-1])).numpy().view(np.int32),
        np.asarray(js._spec_uniform(jnp.asarray(seeds), jnp.asarray(steps[:, :-1]))).view(np.int32))
    np.testing.assert_array_equal(
        ts._tree_uniform(tseeds, _t(steps0), S1).numpy().view(np.int32),
        np.asarray(js._tree_uniform(jnp.asarray(seeds), jnp.asarray(steps0), S1)).view(np.int32))
    _assert_gumbel_close(
        ts._spec_gumbel(tseeds, _t(steps), _t(dense), V),
        js._spec_gumbel(jnp.asarray(seeds), jnp.asarray(steps), jnp.asarray(dense), V))
    _assert_gumbel_close(
        ts._tree_gumbel(tseeds, _t(steps0), _t(dense), S1, V),
        js._tree_gumbel(jnp.asarray(seeds), jnp.asarray(steps0), jnp.asarray(dense), S1, V))
    # The untagged key of a draft-less row is the dense sampler's noise.
    _assert_gumbel_close(
        ts._spec_gumbel(tseeds, _t(steps), _t(np.ones(B, bool)), V)[:, 0],
        ts.row_gumbel(tseeds, _t(steps0), V))


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _linear_case(seed, B, S, V, mode):
    """Logits [B, S1, V] and drafts that the target accepts often: each
    draft token is the argmax (greedy) or a sample from the tempered
    target (simple) of the position before it, or a random token."""
    rng = np.random.default_rng(seed)
    S1 = S + 1
    logits = (rng.standard_normal((B, S1, V)) * 6.0).astype(np.float32)
    temps = np.where(rng.random(B) < 0.3, 0.0, rng.uniform(0.5, 1.5, B)).astype(np.float32)
    if mode == "greedy":
        temps[:] = 0.0
    temps[0] = 0.0  # row 0: a greedy row whose whole draft is the argmax chain
    drafts = np.zeros((B, S), np.int32)
    for b in range(B):
        for j in range(S):
            t = temps[b] if temps[b] > 0 else 1.0
            p = _softmax(logits[b, j] / t)
            r = 0.0 if b == 0 else rng.random()
            if r < 0.85:
                drafts[b, j] = int(np.argmax(logits[b, j])) if temps[b] == 0 else rng.choice(V, p=p)
            else:
                drafts[b, j] = rng.integers(0, V)
    draft_len = rng.integers(0, S + 1, B).astype(np.int32)
    draft_len[0] = S
    draft_len[-1] = 0  # a draft-less row
    seeds = _seeds(rng, B)
    steps0 = rng.integers(0, 500, B).astype(np.int32)
    return logits, drafts, draft_len, temps, seeds, steps0


@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("S", [1, 3, 7])
@pytest.mark.parametrize("seed", range(3))
def test_spec_acceptance_matches_jax(mode, S, seed):
    B, V = 6, 97
    logits, drafts, dlen, temps, seeds, steps0 = _linear_case(100 * S + seed, B, S, V, mode)
    j_out, j_n = js.spec_acceptance(*map(jnp.asarray, (logits, drafts, dlen, temps, seeds,
                                                       steps0)), mode)
    t_out, t_n = ts.spec_acceptance(_t(logits), _t(drafts), _t(dlen), _t(temps),
                                    _t(seeds.astype(np.int64)), _t(steps0), mode)
    j_out, j_n = np.asarray(j_out), np.asarray(j_n)
    np.testing.assert_array_equal(t_n.numpy(), j_n)
    for b in range(B):
        np.testing.assert_array_equal(t_out.numpy()[b, : j_n[b]], j_out[b, : j_n[b]])
    assert j_n[0] == S + 1 and j_n[-1] == 1  # row 0 accepts all, the draft-less row none


def test_spec_acceptance_draftless_row_is_dense_sample():
    """A row with no draft emits one token, the dense sampler's for its
    (seed, step): speculation is a no-op for it."""
    B, S, V = 4, 3, 97
    logits, drafts, _, temps, seeds, steps0 = _linear_case(5, B, S, V, "simple")
    dlen = np.zeros((B,), np.int32)
    out, n = ts.spec_acceptance(_t(logits), _t(drafts), _t(dlen), _t(temps),
                                _t(seeds.astype(np.int64)), _t(steps0), "simple")
    dense = ts.sample_simple(_t(logits[:, 0]), _t(temps),
                             ts.row_gumbel(_t(seeds.astype(np.int64)), _t(steps0), V))
    assert (n.numpy() == 1).all()
    np.testing.assert_array_equal(out.numpy()[:, 0], dense.numpy())


def _random_tree(rng, n_nodes, width):
    """parents of nodes 1..n (each < its index), at most ``width`` children
    per node."""
    parents = [0]
    kids = {0: 0}
    for j in range(1, n_nodes + 1):
        while True:
            p = int(rng.integers(0, j))
            if kids.get(p, 0) < width:
                break
        kids[p] = kids.get(p, 0) + 1
        kids[j] = 0
        parents.append(p)
    return parents


def _tree_case(seed, B, S1, V, mode, width):
    """Logits, node tokens and topologies with distinct siblings; each
    node's token is drawn from its parent's target (or random)."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, S1, V)) * 6.0).astype(np.float32)
    temps = np.where(rng.random(B) < 0.3, 0.0, rng.uniform(0.5, 1.5, B)).astype(np.float32)
    if mode == "greedy":
        temps[:] = 0.0
    temps[0] = 0.0  # row 0: a greedy row whose nodes are argmax or distinct others
    tokens = np.zeros((B, S1), np.int32)
    parents = np.zeros((B, S1), np.int32)
    draft_len = rng.integers(0, S1, B).astype(np.int32)
    draft_len[0] = S1 - 1
    draft_len[-1] = 0
    for b in range(B):
        tokens[b, 0] = rng.integers(0, V)
        pars = _random_tree(rng, int(draft_len[b]), width)
        used: dict[int, set] = {}
        for j in range(1, len(pars)):
            p = pars[j]
            parents[b, j] = p
            taken = used.setdefault(p, set())
            t = temps[b] if temps[b] > 0 else 1.0
            prob = _softmax(logits[b, p] / t)
            while True:
                r = 0.0 if b == 0 and not taken else rng.random()
                if r < 0.5:
                    tok = int(np.argmax(logits[b, p])) if temps[b] == 0 else int(rng.choice(V, p=prob))
                else:
                    tok = int(rng.integers(0, V))
                if tok not in taken:
                    break
            taken.add(tok)
            tokens[b, j] = tok
    seeds = _seeds(rng, B)
    steps0 = rng.integers(0, 500, B).astype(np.int32)
    return logits, tokens, parents, draft_len, temps, seeds, steps0


@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("S1,width", [(2, 1), (5, 2), (9, 3), (9, 1)])
@pytest.mark.parametrize("seed", range(3))
def test_spec_tree_acceptance_matches_jax(mode, S1, width, seed):
    B, V = 6, 61
    case = _tree_case(1000 * S1 + 10 * width + seed, B, S1, V, mode, width)
    logits, tokens, parents, dlen, temps, seeds, steps0 = case
    j = [np.asarray(a) for a in js.spec_tree_acceptance(*map(jnp.asarray, case), mode)]
    t = [a.numpy() for a in ts.spec_tree_acceptance(
        _t(logits), _t(tokens), _t(parents), _t(dlen), _t(temps), _t(seeds.astype(np.int64)),
        _t(steps0), mode)]
    j_out, j_n, j_path, j_cand = j
    np.testing.assert_array_equal(t[1], j_n)
    np.testing.assert_array_equal(t[2], j_path)
    np.testing.assert_array_equal(t[3], j_cand)
    for b in range(B):
        np.testing.assert_array_equal(t[0][b, : j_n[b]], j_out[b, : j_n[b]])
    assert j_n[0] > 1  # row 0's first child of every node is the argmax


def test_tree_chain_equals_linear_acceptance():
    """A chain-shaped tree accepts as the linear rule in greedy mode (same
    tokens, same n_emit)."""
    B, S, V = 6, 4, 97
    logits, drafts, dlen, temps, seeds, steps0 = _linear_case(77, B, S, V, "greedy")
    tokens = np.concatenate([np.zeros((B, 1), np.int32), drafts], axis=1)
    parents = np.maximum(np.arange(S + 1, dtype=np.int32) - 1, 0)[None].repeat(B, 0)
    lo, ln = ts.spec_acceptance(_t(logits), _t(drafts), _t(dlen), _t(temps),
                                _t(seeds.astype(np.int64)), _t(steps0), "greedy")
    to, tn, _path, _cand = ts.spec_tree_acceptance(
        _t(logits), _t(tokens), _t(parents), _t(dlen), _t(temps), _t(seeds.astype(np.int64)),
        _t(steps0), "greedy")
    np.testing.assert_array_equal(tn.numpy(), ln.numpy())
    for b in range(B):
        n = int(ln[b])
        np.testing.assert_array_equal(to.numpy()[b, :n], lo.numpy()[b, :n])
