"""On-device sampling (port of ``dynamo_tpu/engine/sampler.py``).

Three modes, chosen host-side per batch as the JAX engine does:

- "greedy": argmax, no noise;
- "simple": greedy / temperature via the Gumbel-max trick
  (``sample_simple``); no sort;
- "full": frequency/presence penalties over the generated tokens plus
  exact top-k and top-p (nucleus) over a full descending sort
  (``token_counts``, ``apply_penalties``, ``sample_step``).

The noise is jax's: ``row_gumbel`` draws ``gumbel(fold_in(PRNGKey(seed),
step))`` per row with the port's threefry (``engine/threefry.py``) from
device tensors, so a seeded request samples the same tokens as in the
JAX package whatever batch it rides in, and the draw needs no host call
(a CUDA graph captures it). ``sample_simple`` and ``sample_step`` take the
noise as an argument, so tests can feed both packages the same numbers.

Temperature <= 0 means greedy (argmax) for that row in every mode.

Grammar-constrained rows (response_format) carry packed bitsets of their
FSM state's legal tokens: ``mask_bits`` of ``sample_simple``,
``sample_full`` and ``spec_tree_acceptance`` sets every illegal logit to
-inf before sampling (``apply_mask``); None leaves the logits untouched.

Speculative acceptance (``spec_acceptance`` for linear drafts,
``spec_tree_acceptance`` for draft trees) runs on the verify pass's
logits on the device, with its noise from the same threefry.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.engine import threefry

GREEDY_EPS = 1e-5


def unpack_mask(bits: torch.Tensor, V: int) -> torch.Tensor:
    """Packed grammar bitsets → boolean legality mask: [..., W32] → [..., V].
    Bit t of the flattened words marks token t legal. The words are int32
    (torch's uint32 has few operations); the shift comes before the mask,
    so a negative word's arithmetic shift never leaks its sign bit."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    b = (bits.to(torch.int32)[..., :, None] >> shifts) & 1
    return b.reshape(*bits.shape[:-1], -1)[..., :V] != 0


def apply_mask(logits: torch.Tensor, mask_bits: torch.Tensor | None) -> torch.Tensor:
    """Grammar-mask logits: illegal tokens → -inf, so every later softmax,
    argmax and Gumbel-max renormalizes over the legal vocabulary. None =
    unconstrained: the logits pass through untouched (callers pass None
    when no row of the batch carries a grammar)."""
    if mask_bits is None:
        return logits
    return logits.masked_fill(~unpack_mask(mask_bits, logits.shape[-1]), float("-inf"))


def row_gumbel(seeds: torch.Tensor, steps: torch.Tensor, V: int) -> torch.Tensor:
    """Per-row Gumbel noise [B, V] float32 from (seed, emission index)
    integer tensors [B] on the device that the noise is wanted on."""
    return threefry.gumbel(threefry.fold_in(threefry.prng_key(seeds), steps), V)


def sample_simple(
    logits: torch.Tensor,       # [B, V] f32
    temperature: torch.Tensor,  # [B] f32
    gumbel: torch.Tensor,       # [B, V] f32 noise
    mask_bits: torch.Tensor | None = None,  # [B, W32] int32 grammar masks
) -> torch.Tensor:
    logits = apply_mask(logits, mask_bits)
    greedy = temperature < GREEDY_EPS
    temp = torch.where(greedy, torch.ones_like(temperature), temperature)
    noisy = torch.where(greedy[:, None], logits, logits / temp[:, None] + gumbel)
    return torch.argmax(noisy, dim=-1).to(torch.int32)


def token_counts(penalty_tokens: torch.Tensor, V: int) -> torch.Tensor:
    """[B, L] generated ids (-1 pad) → [B, V] f32 occurrence counts."""
    valid = penalty_tokens >= 0
    safe = torch.where(valid, penalty_tokens, 0).long()
    counts = torch.zeros((penalty_tokens.shape[0], V), dtype=torch.float32,
                         device=penalty_tokens.device)
    return counts.scatter_add_(1, safe, valid.float())


def apply_penalties(
    logits: torch.Tensor,        # [B, V] f32
    counts: torch.Tensor,        # [B, V] f32 occurrence counts of generated ids
    freq_penalty: torch.Tensor,  # [B] f32
    pres_penalty: torch.Tensor,  # [B] f32
) -> torch.Tensor:
    """OpenAI frequency/presence penalties over generated tokens."""
    logits = logits - freq_penalty[:, None] * counts
    return logits - pres_penalty[:, None] * (counts > 0).float()


def sample_step(
    logits: torch.Tensor,       # [B, V] f32 (penalties already applied)
    temperature: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,        # [B] int, 0 = off
    top_p: torch.Tensor,        # [B] f32, 1.0 = off
    gumbel: torch.Tensor,       # [B, V] f32 noise
) -> torch.Tensor:
    """Exact top-k + top-p (nucleus) + temperature + Gumbel-max: the core
    of the full sampler and of the fused window's "full" mode. The sort is
    stable, so equal values keep index order as ``lax.top_k`` does."""
    greedy = temperature < GREEDY_EPS
    temp = torch.where(greedy, torch.ones_like(temperature), temperature)
    scaled = logits / temp[:, None]
    V = logits.shape[1]
    svals, sidx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    ranks = torch.arange(V, dtype=torch.int64, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, V, top_k.long())[:, None]
    keep_k = ranks < k
    probs = torch.softmax(svals, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    # nucleus: keep tokens whose preceding cumulative mass < top_p
    keep_p = cum_before < top_p[:, None]
    keep = keep_k & keep_p
    keep[:, 0] = True  # never mask the argmax
    masked = torch.where(keep, svals, torch.full_like(svals, float("-inf")))
    noise = torch.gather(gumbel, 1, sidx)
    pick = torch.argmax(torch.where(greedy[:, None], masked, masked + noise), dim=-1)
    return torch.gather(sidx, 1, pick[:, None])[:, 0].to(torch.int32)


def sample_full(
    logits: torch.Tensor,          # [B, V] f32
    temperature: torch.Tensor,     # [B] f32
    top_k: torch.Tensor,           # [B] int, 0 = off
    top_p: torch.Tensor,           # [B] f32, 1.0 = off
    penalty_tokens: torch.Tensor,  # [B, L] int previously generated ids, -1 pad
    freq_penalty: torch.Tensor,    # [B] f32
    pres_penalty: torch.Tensor,    # [B] f32
    gumbel: torch.Tensor,          # [B, V] f32 noise
    mask_bits: torch.Tensor | None = None,  # [B, W32] int32 grammar masks
) -> torch.Tensor:
    logits = apply_mask(logits, mask_bits)
    counts = token_counts(penalty_tokens, logits.shape[1])
    logits = apply_penalties(logits, counts, freq_penalty, pres_penalty)
    return sample_step(logits, temperature, top_k, top_p, gumbel)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-probability of each row's chosen token: [B, V], [B] → [B]."""
    logz = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    return chosen - logz


def top_k_logprobs(logits: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-n alternative logprobs of the raw model distribution:
    [B, V] → (logprobs [B, n], token ids [B, n] int32), most likely first."""
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    vals, ids = torch.topk(logits, n, dim=-1)
    return vals - logz, ids.to(torch.int32)


# -- speculative acceptance ------------------------------------------------
#
# The noise of a verify pass comes from the same threefry as the dense
# path, under the JAX package's fold-in tags, so a seeded request draws
# the JAX package's bits: tag 1 the linear accept uniforms, tag 2 the
# linear residual gumbels, tag 3 the tree accept uniforms (keyed by node
# slot), tag 4 the tree correction gumbels. A row with no draft at all
# draws its one token from the dense (seed, step) key untagged, so
# speculation is a true no-op for it.

SPEC_UNIFORM_MIN = 1e-12


def _fold_tag(key: threefry.Key, tag: int) -> threefry.Key:
    return threefry.fold_in(key, torch.full_like(key[0], tag))


def _spec_uniform(seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Per-(row, draft position) accept uniforms [B, S]:
    uniform(fold(fold(PRNGKey(seed), step), 1), minval=1e-12)."""
    B, S = steps.shape
    seed = seeds.long()[:, None].expand(B, S).reshape(-1)
    key = threefry.fold_in(threefry.prng_key(seed), steps.reshape(-1))
    return threefry.uniform(_fold_tag(key, 1), 1, SPEC_UNIFORM_MIN)[:, 0].reshape(B, S)


def _spec_gumbel(seeds: torch.Tensor, steps: torch.Tensor, dense_stream: torch.Tensor,
                 V: int) -> torch.Tensor:
    """Per-(row, position) residual/bonus noise [B, S1, V]: the dense key
    fold(PRNGKey(seed), step) for rows with ``dense_stream``, that key
    folded with tag 2 for the others."""
    B, S1 = steps.shape
    seed = seeds.long()[:, None].expand(B, S1).reshape(-1)
    base = threefry.fold_in(threefry.prng_key(seed), steps.reshape(-1))
    tagged = _fold_tag(base, 2)
    dense = dense_stream[:, None].expand(B, S1).reshape(-1)
    key = (torch.where(dense, base[0], tagged[0]), torch.where(dense, base[1], tagged[1]))
    return threefry.gumbel(key, V).reshape(B, S1, V)


def spec_acceptance(
    logits: torch.Tensor,       # [B, S1, V] f32 — raw verify-pass logits
    drafts: torch.Tensor,       # [B, S] int32 — proposed draft tokens
    draft_len: torch.Tensor,    # [B] int — true draft length per row (<= S)
    temperature: torch.Tensor,  # [B] f32 ("simple"; <= 0 → greedy row)
    seeds: torch.Tensor,        # [B] int per-row sample seed
    steps0: torch.Tensor,       # [B] int emission index of the pass's first token
    mode: str,                  # "greedy" | "simple"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative acceptance over one linear verify pass → (out [B, S1]
    int32, n_emit [B] int32). Position j's logits score the token after
    input j, so draft j+1 is checked against position j; the first
    rejected position (or the bonus position S) emits a corrected or
    bonus token. ``out[:, :n_emit]`` is the emitted run.

    "greedy": accept on exact argmax match; the emitted tokens are the
    argmax chain, the dense greedy path's. "simple": rejection sampling
    against the point-mass draft: accept d with probability p(d); on
    rejection sample the residual p restricted to tokens != d (Gumbel-max
    with d masked), which leaves the target distribution unchanged.
    Greedy rows inside a "simple" batch take the argmax rule."""
    B, S1, V = logits.shape
    S = S1 - 1
    dev = logits.device
    jidx = torch.arange(S, device=dev)[None, :]
    slot = torch.arange(S1, device=dev)[None, :]
    in_draft = jidx < draft_len[:, None]
    cand_greedy = torch.argmax(logits, dim=-1).to(torch.int32)            # [B, S1]
    if mode == "greedy":
        accept = (drafts == cand_greedy[:, :-1]) & in_draft
        out = cand_greedy
    else:
        greedy = temperature < GREEDY_EPS
        temp = torch.where(greedy, torch.ones_like(temperature), temperature)
        scaled = logits / temp[:, None, None]
        logz = torch.logsumexp(scaled, dim=-1)                            # [B, S1]
        d_lp = torch.gather(scaled[:, :-1], 2, drafts.long()[:, :, None])[..., 0] - logz[:, :-1]
        steps = steps0[:, None] + slot
        u = _spec_uniform(seeds, steps[:, :-1])                           # [B, S]
        accept = torch.where(greedy[:, None], drafts == cand_greedy[:, :-1],
                             torch.log(u) < d_lp) & in_draft
        # Residual candidates: the rejected draft masked out at true
        # proposal positions only; the bonus position samples unmasked.
        noisy = scaled + _spec_gumbel(seeds, steps, draft_len == 0, V)
        mask = torch.zeros((B, S1, V), dtype=torch.bool, device=dev)
        mask[:, :S].scatter_(2, drafts.long()[:, :, None], True)
        mask &= (slot < draft_len[:, None])[..., None]
        cand_sampled = torch.argmax(noisy.masked_fill(mask, float("-inf")), dim=-1)
        cand = torch.where(greedy[:, None], cand_greedy, cand_sampled.to(torch.int32))
        padded = torch.cat([drafts.to(torch.int32), torch.zeros_like(drafts[:, :1], dtype=torch.int32)],
                           dim=1)
        a = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
        out = torch.where(slot < a[:, None], padded, cand)
        return out, (a + 1).to(torch.int32)
    a = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    return out, (a + 1).to(torch.int32)


def _tree_uniform(seeds: torch.Tensor, steps0: torch.Tensor, S1: int) -> torch.Tensor:
    """Per-(row, tree node) accept uniforms [B, S1]:
    uniform(fold(fold(fold(PRNGKey(seed), steps0), node), 3), minval=1e-12),
    keyed by node slot so sibling rounds draw independently."""
    B = seeds.shape[0]
    node = torch.arange(S1, device=seeds.device)[None, :].expand(B, S1).reshape(-1)
    seed = seeds.long()[:, None].expand(B, S1).reshape(-1)
    e0 = steps0.long()[:, None].expand(B, S1).reshape(-1)
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), e0), node)
    return threefry.uniform(_fold_tag(key, 3), 1, SPEC_UNIFORM_MIN)[:, 0].reshape(B, S1)


def _tree_gumbel(seeds: torch.Tensor, steps0: torch.Tensor, dense_stream: torch.Tensor,
                 S1: int, V: int) -> torch.Tensor:
    """Per-(row, tree node) correction/bonus noise [B, S1, V]: node 0 of a
    row with ``dense_stream`` (no draft) draws from the dense key, every
    other draw from fold(fold(dense key, node), 4)."""
    B = seeds.shape[0]
    nodes = torch.arange(S1, device=seeds.device)[None, :].expand(B, S1)
    seed = seeds.long()[:, None].expand(B, S1).reshape(-1)
    e0 = steps0.long()[:, None].expand(B, S1).reshape(-1)
    base = threefry.fold_in(threefry.prng_key(seed), e0)
    tagged = _fold_tag(threefry.fold_in(base, nodes.reshape(-1)), 4)
    dense = (dense_stream[:, None] & (nodes == 0)).reshape(-1)
    key = (torch.where(dense, base[0], tagged[0]), torch.where(dense, base[1], tagged[1]))
    return threefry.gumbel(key, V).reshape(B, S1, V)


def spec_tree_acceptance(
    logits: torch.Tensor,       # [B, S1, V] f32 — verify logits per tree node
    tokens: torch.Tensor,       # [B, S1] int32 — node input tokens (slot 0 = root)
    parents: torch.Tensor,      # [B, S1] int — parent node (< own index; 0 for the root)
    draft_len: torch.Tensor,    # [B] int — live draft nodes (tree size - 1)
    temperature: torch.Tensor,  # [B] f32 (<= 0 → greedy row)
    seeds: torch.Tensor,        # [B] int per-row sample seed
    steps0: torch.Tensor,       # [B] int emission index of the pass's first token
    mode: str,                  # "greedy" | "simple"
    mask_bits: torch.Tensor | None = None,  # [B, S1, W32] int32 per-node grammar masks
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-path (SpecInfer) acceptance over one tree verify pass →
    (out [B, S1], n_emit [B], path [B, S1], cand [B, S1]), the JAX
    package's ``spec_tree_acceptance``.

    The walk starts at the root and descends into the first accepted live
    child in slot order; where none accepts (or at a leaf) the node emits
    one corrected/bonus token and the walk stops. ``path[k]`` is the node
    whose logits emitted ``out[k]`` (clamped to the stopping node past the
    end). "greedy": edge v → j accepts iff tokens[j] == argmax(p_v).
    "simple": child i accepts with probability p_v(x_i) / (1 - Σ_{j<i}
    p_v(x_j)); after the rejections the stopping node samples the residual
    with every tried child masked.

    Grammar masks (``mask_bits``): node j's bitset is the legal vocabulary
    of the FSM state after node j's token, so it constrains the
    distribution its children are checked against and its correction or
    bonus token samples from. Illegal logits go to -inf before anything
    else: acceptance uses the masked-renormalized target, residuals
    renormalize over the legal vocabulary, greedy rows take the
    constrained argmax chain. All-ones rows pass through unchanged."""
    B, S1, V = logits.shape
    logits = apply_mask(logits, mask_bits)
    dev = logits.device
    par = parents.long()
    node = torch.arange(S1, device=dev)
    live = (node[None, :] <= draft_len[:, None]) & (node[None, :] >= 1)   # edges
    cand = torch.argmax(logits, dim=-1).to(torch.int32)                   # [B, S1]
    cand_par = torch.gather(cand, 1, par)
    acc_greedy = (tokens == cand_par) & live
    if mode == "greedy":
        acc = acc_greedy
        final_per_node = cand
    else:
        greedy = temperature < GREEDY_EPS
        temp = torch.where(greedy, torch.ones_like(temperature), temperature)
        scaled = logits / temp[:, None, None]
        logz = torch.logsumexp(scaled, dim=-1)                            # [B, S1]
        bidx = torch.arange(B, device=dev)[:, None].expand(B, S1)
        tok = tokens.long()
        # p of node j's token under its PARENT's distribution.
        ptok = torch.exp(scaled[bidx, par, tok] - torch.gather(logz, 1, par))
        ptok = torch.where(live, ptok, torch.zeros_like(ptok))
        # Earlier-sibling mass: Σ p_v(x_j') over live siblings j' < j.
        sib = ((par[:, :, None] == par[:, None, :])
               & (node[None, None, :] < node[None, :, None])
               & live[:, None, :])                                        # [B, j, j']
        prevmass = torch.einsum("bjk,bk->bj", sib.float(), ptok)
        Z = 1.0 - prevmass
        u = _tree_uniform(seeds, steps0, S1)
        acc_samp = live & (Z > 0.0) & (u * Z < ptok)
        acc = torch.where(greedy[:, None], acc_greedy, acc_samp)
        # Final token per candidate stopping node v: Gumbel-max of the
        # scaled logits with v's live children masked out.
        contrib = torch.zeros((B, S1, V), dtype=torch.float32, device=dev)
        contrib.index_put_((bidx, par, tok), live.float(), accumulate=True)
        noisy = (scaled + _tree_gumbel(seeds, steps0, draft_len == 0, S1, V)).masked_fill(
            contrib > 0.0, float("-inf"))
        final_sampled = torch.argmax(noisy, dim=-1).to(torch.int32)
        final_per_node = torch.where(greedy[:, None], cand, final_sampled)
    # First accepted child per node, in slot order.
    childmat = (par[:, None, :] == node[None, :, None]) & acc[:, None, :]  # [B, v, j]
    chosen = torch.where(childmat, node[None, None, :],
                         torch.full_like(childmat, S1, dtype=torch.long)).min(dim=2).values
    cur = torch.zeros((B,), dtype=torch.long, device=dev)
    visited = [cur]
    a = torch.zeros((B,), dtype=torch.long, device=dev)
    for _ in range(S1 - 1):
        nxt = torch.gather(chosen, 1, cur[:, None])[:, 0]
        ok = nxt < S1
        cur = torch.where(ok, nxt, cur)
        visited.append(cur)
        a = a + ok.long()
    path = torch.stack(visited, dim=1)                                    # [B, S1]
    # out[k < a] = token of the accepted depth-(k+1) node; out[a] = the
    # stopping node's final token; beyond n_emit the values are junk.
    child_at = torch.cat([path[:, 1:], path[:, -1:]], dim=1)
    tok_child = torch.gather(tokens, 1, child_at).to(torch.int32)
    final = torch.gather(final_per_node, 1, torch.gather(path, 1, a[:, None]))
    out = torch.where(node[None, :] < a[:, None], tok_child, final)
    return out, (a + 1).to(torch.int32), path.to(torch.int32), cand


def row_needs_full(top_k, top_p, freq_penalty, pres_penalty) -> bool:
    """Does one request's sampling config need the full sampler?"""
    return bool(
        (top_k and top_k > 0)
        or (top_p is not None and top_p < 1.0)
        or freq_penalty
        or pres_penalty
    )
