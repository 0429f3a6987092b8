"""Grammar masks in the port against the JAX package's, on the CPU.

Same numpy inputs (seeded logits, packed bitsets, drafts and tree
topologies) go through ``dynamo_tpu_torch`` and ``dynamo_tpu``:

- ``unpack_mask`` / ``apply_mask``: exact, on random bitsets whose words
  use the top bit (negative as the port's int32 words), for vocabularies
  that are and are not multiples of 32;
- ``sample_simple`` / ``sample_full`` with masks: tokens equal and legal;
  the raw-model logprobs of the chosen tokens within 1e-6. A state whose
  only legal token is EOS (a terminal state with no text continuation)
  emits EOS in every mode;
- ``spec_tree_acceptance`` with per-node masks, greedy and sampled, on
  the JAX package's threefry bits: emitted tokens, ``n_emit``, path and
  per-node argmax equal;
- ``model.spec_verify`` in tree mode with masks (test-tiny, float32): the
  outputs equal, logprobs and KV pages within 1e-5 (``FWD_TOL``);
- the port's ``engine/grammar.py`` (a copy, tests/test_torch_copies.py)
  on a few of tests/test_grammar.py's cases, against the JAX module: the
  same regexes, forced runs, masks and walks over the byte vocabulary and
  over a trained tokenizer.json vocabulary loaded by each package's own
  tokenizer.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import grammar as jg
from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine import sampler as js
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine import grammar as tg
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine import sampler as ts
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

from test_torch_spec import _chain, _prefilled, _tree_topology

LP_TOL = dict(atol=1e-6, rtol=1e-6)
# Two frameworks' float32 forwards (different matmul blocking) agree to a
# few 1e-6 absolute; their logprobs and KV pages are held to 1e-5.
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 8},
    "age": {"type": "integer"},
    "active": {"type": "boolean"},
    "kind": {"enum": ["a", "bc"]},
}}
RF = {"type": "json_schema", "json_schema": {"name": "x", "schema": SCHEMA}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _words(bits: np.ndarray) -> torch.Tensor:
    """Host uint32 bitsets → the int32 words the port carries."""
    return _t(np.asarray(bits, np.uint32).view(np.int32))


def _random_bits(rng, shape, V, density=0.4):
    """Packed bitsets [*shape, ceil(V/32)] with about ``density`` of the
    V ids legal → (uint32 words, the boolean mask they pack)."""
    dense = rng.random(shape + (V,)) < density
    W32 = (V + 31) // 32
    padded = np.zeros(shape + (W32 * 32,), bool)
    padded[..., :V] = dense
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    words = (padded.reshape(shape + (W32, 32)).astype(np.uint64) * weights).sum(-1)
    return words.astype(np.uint32), dense


@pytest.mark.parametrize("V", [48, 257, 1000])
def test_unpack_and_apply_mask_match_jax(V):
    rng = np.random.default_rng(V)
    bits, dense = _random_bits(rng, (3, 5), V)
    bits[0, 0, :] = 0xFFFFFFFF  # every word negative as int32
    dense[0, 0] = True
    assert (bits.view(np.int32) < 0).any()
    got = ts.unpack_mask(_words(bits), V).numpy()
    want = np.asarray(js.unpack_mask(jnp.asarray(bits), V))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dense)
    logits = rng.normal(0, 2, (3, 5, V)).astype(np.float32)
    np.testing.assert_array_equal(ts.apply_mask(_t(logits), _words(bits)).numpy(),
                                  np.asarray(js.apply_mask(jnp.asarray(logits), jnp.asarray(bits))))
    t = _t(logits)
    assert ts.apply_mask(t, None) is t


def _noise(seeds, steps, V):
    return ts.row_gumbel(_t(seeds.astype(np.int64)), _t(steps), V)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_sample_simple_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, V = 6, 300
    logits = rng.normal(0, 2, (B, V)).astype(np.float32)
    bits, dense = _random_bits(rng, (B,), V, density=0.2)
    temps = np.array([0.0, 0.7, 1.0, 0.0, 1.3, 0.9], np.float32)
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.uint32)
    steps = rng.integers(0, 100, B).astype(np.int32)
    got = ts.sample_simple(_t(logits), _t(temps), _noise(seeds, steps, V), _words(bits))
    want = np.asarray(js.sample_simple(jnp.asarray(logits), jnp.asarray(temps),
                                       jnp.asarray(seeds), jnp.asarray(steps), jnp.asarray(bits)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert dense[np.arange(B), got.numpy()].all()
    # Reported logprobs stay the raw model's, masked or not.
    np.testing.assert_allclose(
        ts.token_logprobs(_t(logits), got).numpy(),
        np.asarray(js.token_logprobs(jnp.asarray(logits), jnp.asarray(want))), **LP_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_sample_full_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    B, V = 5, 300
    logits = rng.normal(0, 2, (B, V)).astype(np.float32)
    bits, dense = _random_bits(rng, (B,), V, density=0.3)
    temps = np.array([0.8, 0.0, 1.1, 0.6, 1.0], np.float32)
    top_k = np.array([0, 5, 20, 0, 3], np.int32)
    top_p = np.array([0.9, 1.0, 0.7, 1.0, 0.95], np.float32)
    pen = rng.integers(-1, V, (B, 16)).astype(np.int32)
    freq = np.array([0.0, 0.5, 0.2, 0.0, 1.0], np.float32)
    pres = np.array([0.3, 0.0, 0.0, 0.4, 0.1], np.float32)
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.uint32)
    steps = rng.integers(0, 100, B).astype(np.int32)
    got = ts.sample_full(_t(logits), _t(temps), _t(top_k), _t(top_p), _t(pen), _t(freq),
                         _t(pres), _noise(seeds, steps, V), _words(bits))
    want = np.asarray(js.sample_full(*map(jnp.asarray, (logits, temps, top_k, top_p, pen, freq,
                                                        pres, seeds, steps, bits))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert dense[np.arange(B), got.numpy()].all()


def test_terminal_state_with_only_eos_legal_emits_eos():
    """At a terminal state with no legal text token the mask holds the EOS
    bits alone (grammar.py ORs them in at terminal states): every sampler
    mode emits EOS, with a finite raw logprob, in both packages."""
    V, eos = 260, 257
    comp = tg.GrammarCompiler(tg.grammar_vocab(ByteTokenizer()), V)
    g = comp.compile({"type": "json_schema", "json_schema": {"schema": {"const": "a"}}})
    st = g.start
    for b in b'"a"':
        st = g.advance(st, b)
    eos_bits = tg.pack_token_ids([eos], V)
    assert g.is_terminal(st) and not g.mask(st).any()
    mask = np.stack([g.mask(st, eos_bits)] * 3)
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (3, V)).astype(np.float32)
    temps = np.array([0.0, 0.8, 1.5], np.float32)
    seeds, steps = np.array([1, 2, 3], np.uint32), np.zeros((3,), np.int32)
    got = ts.sample_simple(_t(logits), _t(temps), _noise(seeds, steps, V), _words(mask))
    want = js.sample_simple(*map(jnp.asarray, (logits, temps, seeds, steps, mask)))
    assert got.tolist() == np.asarray(want).tolist() == [eos] * 3
    full = ts.sample_full(_t(logits), _t(temps), _t(np.zeros(3, np.int32)),
                          _t(np.ones(3, np.float32)), _t(np.full((3, 1), -1, np.int32)),
                          _t(np.zeros(3, np.float32)), _t(np.zeros(3, np.float32)),
                          _noise(seeds, steps, V), _words(mask))
    assert full.tolist() == [eos] * 3
    assert np.isfinite(ts.token_logprobs(_t(logits), got).numpy()).all()


def _tree_case(rng, B, S1, V, mode):
    """Logits, node tokens drawn from each parent's distribution (greedy:
    its argmax, some wrong), a width-2 topology and per-node masks that
    keep every node token legal."""
    parents = np.zeros((B, S1), np.int32)
    for j in range(1, S1):
        parents[:, j] = (j - 1) // 2
    logits = rng.normal(0, 2.5, (B, S1, V)).astype(np.float32)
    tokens = np.zeros((B, S1), np.int32)
    tokens[:, 0] = rng.integers(0, V, B)
    for b in range(B):
        for j in range(1, S1):
            p = parents[b, j]
            if mode == "greedy" and j % 2 == 1:
                tokens[b, j] = int(np.argmax(logits[b, p]))
            else:
                tokens[b, j] = int(rng.integers(0, V))
        # Sibling tokens must be distinct.
        for j in range(2, S1, 2):
            if tokens[b, j] == tokens[b, j - 1]:
                tokens[b, j] = (tokens[b, j] + 1) % V
    bits, _ = _random_bits(rng, (B, S1), V, density=0.3)
    for b in range(B):
        for j in range(1, S1):
            p = parents[b, j]
            t = tokens[b, j]
            bits[b, p, t >> 5] |= np.uint32(1 << (t & 31))
    return logits, tokens, parents, bits


@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_tree_acceptance_matches_jax(mode, seed):
    rng = np.random.default_rng(100 + seed)
    B, S1, V = 5, 7, 96
    logits, tokens, parents, bits = _tree_case(rng, B, S1, V, mode)
    draft_len = np.array([6, 6, 3, 0, 5], np.int32)
    temps = (np.array([0.0, 0.9, 1.0, 0.7, 1.2], np.float32) if mode == "simple"
             else np.zeros((B,), np.float32))
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.uint32)
    steps0 = rng.integers(0, 50, B).astype(np.int32)
    got = ts.spec_tree_acceptance(_t(logits), _t(tokens), _t(parents), _t(draft_len), _t(temps),
                                  _t(seeds.astype(np.int64)), _t(steps0), mode, _words(bits))
    want = js.spec_tree_acceptance(*map(jnp.asarray, (logits, tokens, parents, draft_len, temps,
                                                      seeds, steps0)), mode, jnp.asarray(bits))
    out, n_emit, path, cand = (g.numpy() for g in got)
    j_out, j_n, j_path, j_cand = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(n_emit, j_n)
    np.testing.assert_array_equal(cand, j_cand)
    np.testing.assert_array_equal(path, j_path)
    for b in range(B):
        np.testing.assert_array_equal(out[b, : n_emit[b]], j_out[b, : j_n[b]])
        # Every emitted token is legal under the mask of the node it came from.
        legal = js.unpack_mask(jnp.asarray(bits[b]), V)
        for k in range(n_emit[b]):
            assert bool(legal[path[b, k], out[b, k]])
    if mode == "greedy":
        assert n_emit.max() > 1  # drafts were accepted


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["greedy", "simple"])
def test_masked_tree_verify_pass_matches_jax(np_params, mode, kv_quant):
    """``model.spec_verify`` in tree mode with per-node masks on the same
    prefilled caches: emitted tokens, n_emit, per-node argmax and the
    chain token equal; logprobs (raw) and the KV pages after compaction
    within ``FWD_TOL``."""
    S1 = 5
    jparams, tparams, jcache, tcache, tables, first = _prefilled(np_params, kv_quant)
    chain = _chain(np_params, kv_quant, first, S1 - 1)
    V = JCfg().vocab_size
    tokens = np.zeros((4, S1), np.int32)
    tokens[:3, 0] = first
    tokens[:3, 1] = chain[:3, 0]
    tokens[:3, 2] = (chain[:3, 0] + 7) % V
    tokens[:3, 3:] = chain[:3, 1 : S1 - 2]
    tree = _tree_topology(4, S1)
    rng = np.random.default_rng(7)
    bits, _ = _random_bits(rng, (4, S1), V, density=0.3)
    for b in range(3):
        for j in range(1, S1):
            p, t = tree[0][b, j], tokens[b, j]
            bits[b, p, t >> 5] |= np.uint32(1 << (t & 31))
    positions0 = np.array([13, 9, 6, 0], np.int32)
    draft_len = np.array([S1 - 1, S1 - 1, 2, 0], np.int32)
    active = np.array([True, True, True, False])
    temps = np.array([0.0, 0.8, 1.2, 0.0] if mode == "simple" else [0.0] * 4, np.float32)
    seeds = np.array([5, 6, 7, 0], np.uint32)
    steps0 = np.array([1, 2, 3, 0], np.int32)
    args = (tokens, positions0, draft_len, tables, active, temps, seeds, steps0)
    j = JM.spec_verify(JCfg(), S1, mode, 3, jparams, jcache, *map(jnp.asarray, args),
                       *(jnp.asarray(a) for a in tree), jnp.asarray(bits), fused=True,
                       attn_impl="xla")
    targs = (tokens, positions0, draft_len, tables, active, temps, seeds.astype(np.int64),
             steps0)
    t = TM.spec_verify(ModelConfig(), S1, mode, 3, tparams, tcache, *map(torch.from_numpy, targs),
                       *(torch.from_numpy(a) for a in tree), _words(bits), fused=True)
    j_n = np.asarray(j[1])[:3]
    np.testing.assert_array_equal(t[1].numpy()[:3], j_n)
    if mode == "greedy":
        assert j_n[0] == S1 - 1  # the root path 0 → 1 → 3 → 4, past the sibling
    for r in range(3):
        n, live = j_n[r], draft_len[r] + 1
        np.testing.assert_array_equal(t[0].numpy()[r, :n], np.asarray(j[0])[r, :n])
        np.testing.assert_allclose(t[2].numpy()[r, :n], np.asarray(j[2])[r, :n], **FWD_TOL)
        np.testing.assert_array_equal(t[3].numpy()[r, :live], np.asarray(j[3])[r, :live])
        np.testing.assert_array_equal(t[5].numpy()[r, :n], np.asarray(j[5])[r, :n])
        np.testing.assert_allclose(t[4].numpy()[r, :n], np.asarray(j[4])[r, :n], **FWD_TOL)
    np.testing.assert_array_equal(t[6].numpy()[:3], np.asarray(j[6])[:3])
    for a, b in zip(j[7], tcache):
        if a is not None:
            np.testing.assert_allclose(b.numpy()[:, 1:], np.asarray(a)[:, 1:], **FWD_TOL)


# -- the copied grammar compiler against the JAX module ----------------------

GRAMMAR_CASES = {
    "schema": RF,
    "json_object": {"type": "json_object"},
    "ref": {"type": "json_schema", "json_schema": {"schema": {
        "$defs": {"p": {"type": "object", "properties": {"x": {"type": "number"}}}},
        "type": "array", "items": {"$ref": "#/$defs/p"}, "maxItems": 2}}},
    "enum_const": {"type": "json_schema", "json_schema": {"schema": {
        "type": "object", "properties": {"c": {"const": 3}, "e": {"enum": [1, "two", None]}}}}},
}


@pytest.mark.parametrize("name", sorted(GRAMMAR_CASES))
def test_copied_compiler_matches_jax_on_bytes(name):
    """Same regex, and along seeded masked random walks over the byte
    vocabulary the same masks, forced tokens and terminal flags; every
    completed walk parses as JSON."""
    rf = GRAMMAR_CASES[name]
    assert tg.compile_response_format_regex(rf) == jg.compile_response_format_regex(rf)
    V, eos = 260, 257
    tgr = tg.build_compiler(None, V).compile(rf)
    jgr = jg.build_compiler(None, V).compile(rf)
    eos_bits = tg.pack_token_ids([eos], V)
    rng = np.random.default_rng(len(name))
    done = 0
    for _ in range(6):
        ts_, js_ = tgr.start, jgr.start
        out = []
        for _ in range(200):
            m = tgr.mask(ts_, eos_bits)
            np.testing.assert_array_equal(m, jgr.mask(js_, eos_bits))
            assert tgr.forced(ts_) == jgr.forced(js_)
            legal = np.flatnonzero(ts.unpack_mask(_words(m), V).numpy())
            tok = int(rng.choice(legal))
            if tok == eos:
                done += 1
                json.loads(bytes(out).decode())
                break
            out.append(tok)
            ts_, js_ = tgr.advance(ts_, tok), jgr.advance(js_, tok)
            assert ts_ == js_ and ts_ is not None
    assert done > 0


def test_copied_compiler_matches_jax_on_a_trained_vocabulary(tmp_path):
    """A tokenizer.json vocabulary, each package loading it with its own
    tokenizer: grammar_vocab maps every id to the same bytes, and the
    masks of the states along a greedy walk are equal."""
    from tokenizer_families import build

    spec = {"type": "hf", "path": build("llama3", tmp_path / "llama3", vocab_size=600)}
    from dynamo_tpu.llm.tokenizer import load_tokenizer as jload
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer as tload

    jtok, ttok = jload(spec), tload(spec)
    assert tg.grammar_vocab(ttok) == jg.grammar_vocab(jtok)
    V = jtok.vocab_size
    tgr = tg.build_compiler(spec, V).compile(RF)
    jgr = jg.build_compiler(spec, V).compile(RF)
    st_t, st_j = tgr.start, jgr.start
    for _ in range(12):
        m = tgr.mask(st_t)
        np.testing.assert_array_equal(m, jgr.mask(st_j))
        ids = np.flatnonzero(ts.unpack_mask(_words(m), V).numpy())
        if not len(ids):
            break
        st_t, st_j = tgr.advance(st_t, int(ids[-1])), jgr.advance(st_j, int(ids[-1]))
        assert st_t == st_j


def test_schema_cache_and_errors_match_jax():
    """The copy caches by schema hash and refuses the same malformed specs
    with GrammarError."""
    comp = tg.build_compiler(None, 260)
    a, b = comp.compile(RF), comp.compile(json.loads(json.dumps(RF)))
    assert a is b and (comp.misses, comp.hits) == (1, 1)
    assert comp.compile({"type": "text"}) is None
    for bad in ({"type": "json_schema", "json_schema": {"schema": {"type": "zzz"}}},
                {"type": "nope"}):
        with pytest.raises(tg.GrammarError) as te:
            tg.compile_response_format_regex(bad)
        with pytest.raises(jg.GrammarError) as je:
            jg.compile_response_format_regex(bad)
        assert str(te.value) == str(je.value)
