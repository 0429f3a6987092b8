"""The port's threefry noise and full sampler against the JAX package's.

Bits must be exact: ``threefry2x32`` against the Random123 known answers
(the vectors jax's own tests use), and ``fold_in`` + ``random_bits`` against
``jax.random.bits(fold_in(PRNGKey(s), e), (V,))`` in jax's default bit
layout (``jax_threefry_partitionable`` True, 32-bit mode).

Gumbel noise: the two frameworks' float32 ``log`` differ in the last bit
for some inputs, and ``-log(-log(u))`` near zero turns one ulp of its inner
value (~6e-8 absolute) into many ulps of a tiny result. So the noise is
held to 2 ulp of max(|g|, 1): an absolute bound of ~2.4e-7 below |g| = 1,
two ulps of g above.

The full sampler gets the same logits and the same noise on both sides;
its sort is exact, so tokens must be equal. Penalties are exact binary
fractions, so ``apply_penalties`` is exact on both sides.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import sampler as JS
from dynamo_tpu_torch.engine import sampler as TS
from dynamo_tpu_torch.engine import threefry as TF

SEEDS = [0, 1, 2**31, 2**32 - 1]
STEPS = [0, 1, 7, 4096, 2**31 - 1]
SIZES = [1, 2, 5, 512, 513, 4097]


def _key(s, e):
    return TF.fold_in(TF.prng_key(torch.tensor([s])), torch.tensor([e]))


@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_answers(key, count, want):
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    out = TF.threefry2x32((t(key[0]), t(key[1])), t(count[0]), t(count[1]))
    assert tuple(int(x) for x in out) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_exact_against_jax(seed):
    for e in STEPS:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        key = _key(seed, e)
        assert [int(k) for k in key] == [int(x) for x in np.asarray(jkey)], e
        for V in SIZES:
            want = np.asarray(jax.random.bits(jkey, (V,))).astype(np.int64)
            np.testing.assert_array_equal(TF.random_bits(key, V)[0].numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_exact_and_gumbel_within_2ulp(seed):
    tiny = jnp.finfo(jnp.float32).tiny
    for e in STEPS:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        key = _key(seed, e)
        for V in SIZES:
            ju = np.asarray(jax.random.uniform(jkey, (V,), jnp.float32, minval=tiny, maxval=1.0))
            np.testing.assert_array_equal(TF.uniform(key, V)[0].numpy(), ju)
            jg = np.asarray(jax.random.gumbel(jkey, (V,), jnp.float32))
            tg = TF.gumbel(key, V)[0].numpy()
            ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
            assert np.all(np.abs(tg - jg) <= 2 * ulp), (e, V)


def test_row_gumbel_matches_the_engines_batched_noise():
    """The sampler's per-row draw against the JAX sampler's vmapped one,
    with the engine's operand types (uint32 seeds, int32 steps)."""
    seeds = np.array([5, 2**31 - 1, 0, 77, 123456789], np.uint32)
    steps = np.array([0, 3, 9, 1000, 64], np.int32)
    V = 1031
    jg = np.asarray(JS._row_gumbel(jnp.asarray(seeds), jnp.asarray(steps), V))
    tg = TS.row_gumbel(torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(steps), V).numpy()
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert np.all(np.abs(tg - jg) <= 2 * ulp)
    # Rows are independent of their neighbours.
    one = TS.row_gumbel(torch.tensor([77]), torch.tensor([1000]), V)[0]
    assert torch.equal(one, torch.from_numpy(tg[3]))


def _full_inputs(seed, B=8, V=512, L=24):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 2.5).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.0, 0.5, 0.9, 1e-6], np.float32)
    top_k = np.array([0, 5, 0, 40, 3, 1, 0, 7], np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 0.8, 0.5, 1.0, 0.3, 0.95], np.float32)
    freq = np.array([0.0, 0.5, 0.25, 0.0, 1.0, 0.0, 0.75, 0.5], np.float32)
    pres = np.array([0.0, 0.0, 0.5, 1.0, 0.0, 0.25, 0.5, 0.0], np.float32)
    pen = np.full((B, L), -1, np.int32)
    for b in range(B):
        n = int(rng.integers(0, L))
        pen[b, :n] = rng.integers(0, V, n)
        pen[b, :3] = logits[b].argmax()  # penalize the argmax hard on some rows
    seeds = rng.integers(0, 2**31, B).astype(np.uint32)
    steps = rng.integers(0, 500, B).astype(np.int32)
    return logits, temps, top_k, top_p, freq, pres, pen, seeds, steps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_full_matches_jax(seed):
    logits, temps, top_k, top_p, freq, pres, pen, seeds, steps = _full_inputs(seed)
    V = logits.shape[1]
    t = torch.from_numpy
    counts = TS.token_counts(t(pen), V)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(JS.token_counts(jnp.asarray(pen), V)))
    pen_t = TS.apply_penalties(t(logits), counts, t(freq), t(pres)).numpy()
    pen_j = np.asarray(JS.apply_penalties(jnp.asarray(logits), jnp.asarray(counts.numpy()),
                                          jnp.asarray(freq), jnp.asarray(pres)))
    np.testing.assert_array_equal(pen_t, pen_j)
    # Same noise on both sides (the port's threefry, fed to JAX's core).
    noise = TS.row_gumbel(t(seeds.astype(np.int64)), t(steps), V)
    port = TS.sample_full(t(logits), t(temps), t(top_k), t(top_p), t(pen), t(freq), t(pres),
                          noise).numpy()
    core = np.asarray(JS.sample_step(jnp.asarray(pen_j), jnp.asarray(temps), jnp.asarray(top_k),
                                     jnp.asarray(top_p), jnp.asarray(noise.numpy())))
    np.testing.assert_array_equal(port, core)
    # And JAX's own full sampler, which draws its noise itself.
    whole = np.asarray(JS.sample_full(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_k), jnp.asarray(top_p),
        jnp.asarray(pen), jnp.asarray(freq), jnp.asarray(pres), jnp.asarray(seeds),
        jnp.asarray(steps)))
    np.testing.assert_array_equal(port, whole)
    greedy = temps < TS.GREEDY_EPS
    np.testing.assert_array_equal(port[greedy], pen_t[greedy].argmax(-1))
    # top-k rows pick among their k best penalized, scaled logits
    for b in np.nonzero(~greedy & (top_k > 0))[0]:
        assert port[b] in np.argsort(-pen_t[b], kind="stable")[: top_k[b]]


def test_sample_simple_matches_jax_with_threefry_noise():
    rng = np.random.default_rng(4)
    B, V = 6, 777
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.0, 1e-6, 1.3, 0.5], np.float32)
    seeds = rng.integers(0, 2**31, B).astype(np.uint32)
    steps = rng.integers(0, 100, B).astype(np.int32)
    noise = TS.row_gumbel(torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(steps), V)
    port = TS.sample_simple(torch.from_numpy(logits), torch.from_numpy(temps), noise).numpy()
    jax_tok = np.asarray(JS.sample_simple(jnp.asarray(logits), jnp.asarray(temps),
                                          jnp.asarray(seeds), jnp.asarray(steps)))
    np.testing.assert_array_equal(port, jax_tok)
