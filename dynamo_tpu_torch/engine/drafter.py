"""Host-side draft-token proposers for speculative decoding.

The engine's verify pass (model.spec_verify) scores any proposed draft
in one weight stream; WHERE drafts come from is pluggable behind the
``Drafter`` interface. Backends:

- ``NgramDrafter`` — n-gram prompt lookup (Saxena 2023, "Prompt Lookup
  Decoding"): match the sequence's trailing n-gram against its own
  prompt+generated history and propose the continuation of the most
  recent earlier occurrence. Zero model cost, zero RNG draws, and
  exactly the TPU-native shape — the expensive half (verification) runs
  on device while drafting is a dict lookup on the host.
- ``TreeDrafter`` — token TREES (SpecInfer, Miao et al. 2023): where
  the per-sequence index holds SEVERAL distinct continuations of the
  same n-gram context, the draft branches instead of committing to one;
  a single topology-masked verify pass then scores every path for the
  price of one weight stream, so expected accepted tokens per pass
  strictly dominates any single linear draft of the same node budget.
  It also carries a Lookahead-style (Fu et al. 2024, arXiv:2402.02057)
  **Jacobi n-gram pool**: every verify pass computes, for free, the
  model's own predicted next token at EVERY tree node — (context,
  prediction) pairs harvested from those logits seed a per-sequence
  candidate pool that drafts on generic traffic with zero history hits
  (the history index only fires once the sequence repeats itself).

A draft-model backend (small model proposing tokens, Leviathan et al.
2023) slots in behind the same methods; its ``draft`` would dispatch
device work, which is why the interface takes the whole token list
rather than a delta.

State is PER SEQUENCE (``new_state``) and fed incrementally: ``draft``
absorbs tokens appended since the last call before matching, so the
steady-state cost is O(new tokens), not O(history). Preemption-by-
recompute keeps ``seq.tokens`` intact, so drafter state survives it
unchanged.
"""

from __future__ import annotations

# Occurrence positions retained per n-gram context: the most recent
# MAX_OCC ends. The linear drafter only ever reads the newest; the tree
# drafter branches over the distinct continuations these ends name.
MAX_OCC = 8
# Jacobi pool bounds: contexts tracked per sequence and candidate
# continuations per context (hit-count-evicted). Small on purpose — the
# pool is a recency cache of the model's own predictions, not an index.
POOL_MAX_CONTEXTS = 512
POOL_MAX_CANDS = 4


class DraftConstraint:
    """Grammar hook for constrained drafting (duck-typed; the engine
    passes a token-FSM adapter). ``state`` is the FSM state at the draft
    ROOT (after every emitted token); ``step`` returns the successor
    state for a legal continuation or None; ``forced`` names the single
    legal continuation of a non-terminal state (or None). An illegal
    draft node can never be accepted — the verify mask zeroes it — so
    pruning to legal continuations is pure win, and a forced token is
    draftable with CERTAINTY (no model signal needed): JSON structure
    (braces, keys, separators) fast-forwards through the draft for
    free."""

    __slots__ = ("state", "step", "forced")

    def __init__(self, state, step, forced):
        self.state = state
        self.step = step
        self.forced = forced


def constrain_chain(draft: list[int], constraint: DraftConstraint,
                    budget: int) -> list[int]:
    """Linear-draft constraint filter: truncate at the first FSM-illegal
    token, then extend with forced continuations up to ``budget`` (the
    grammar often knows the next run of tokens exactly — structural JSON
    — even when the n-gram index has nothing)."""
    out: list[int] = []
    st = constraint.state
    for tok in draft:
        if len(out) >= budget:
            return out
        ns = constraint.step(st, tok)
        if ns is None:
            break
        out.append(int(tok))
        st = ns
    while len(out) < budget:
        f = constraint.forced(st)
        if f is None:
            break
        out.append(int(f))
        st = constraint.step(st, f)
    return out


class TreeDraft:
    """One proposed draft tree. Node 0 is the implicit ROOT (the
    sequence's last real token — the verify pass's slot-0 input);
    ``tokens[i]`` / ``parents[i]`` describe draft node ``i+1``, with
    ``parents[i]`` a NODE index in ``[0, i+1)`` — creation order is
    topological, so a parent always precedes its children."""

    __slots__ = ("tokens", "parents")

    def __init__(self, tokens: list[int] | None = None,
                 parents: list[int] | None = None):
        self.tokens = tokens or []
        self.parents = parents or []

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def num_nodes(self) -> int:
        return len(self.tokens) + 1

    def depths(self) -> list[int]:
        """Per-node depth including the root (depth 0) → [num_nodes]."""
        out = [0]
        for p in self.parents:
            out.append(out[p] + 1)
        return out

    @property
    def max_depth(self) -> int:
        return max(self.depths())

    def is_chain(self) -> bool:
        """True when the tree is a single path — the engine then rides
        the PR 5 linear verify op unchanged (width=1 ≡ linear by
        construction)."""
        return all(p == i for i, p in enumerate(self.parents))

    def truncate(self, n_nodes: int) -> None:
        """Keep only the first ``n_nodes`` draft nodes (batch-budget
        trim). Creation order is topological (a parent always precedes
        its children), so dropping a suffix always leaves a valid tree
        — and with primary-chain-first expansion the kept prefix is
        exactly what a smaller budget would have drafted."""
        del self.tokens[n_nodes:]
        del self.parents[n_nodes:]

    def chain_tokens(self) -> list[int]:
        assert self.is_chain()
        return list(self.tokens)


class NgramState:
    """Incremental n-gram index over one sequence's token history:
    ``index[ngram] = end positions of its occurrences`` (most recent
    last, capped at MAX_OCC) — excluding the n-gram that ends at the
    final token, which is the lookup KEY (indexing it would make every
    lookup find itself). Keeping the occurrence SET rather than only the
    newest end is the raw material tree drafting branches on: distinct
    continuations of the same context become sibling draft nodes."""

    __slots__ = ("index", "observed", "pool")

    def __init__(self):
        self.index: dict[tuple[int, ...], list[int]] = {}
        self.observed = 0  # positions with their ending n-gram indexed
        self.pool: JacobiPool | None = None  # lazily built (tree drafter)


class NgramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier occurrence of the trailing ``n``-gram. Deterministic
    (no RNG — unseeded-request reproducibility is untouched)."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {n}")
        self.n = n

    def new_state(self) -> NgramState:
        return NgramState()

    def observe(self, state: NgramState, hist: list[int], node_tokens,
                parents, node_live, cand) -> None:
        """Verify-pass feedback hook (no-op here; the Jacobi pool in
        ``TreeDrafter`` consumes it)."""

    def _absorb(self, tokens: list[int], state: NgramState) -> None:
        """Index n-grams ending at positions [n-1, L-2]. The tail n-gram
        (ending at L-1) stays unindexed until the sequence grows past
        it."""
        n = self.n
        L = len(tokens)
        start = max(n - 1, state.observed)
        for e in range(start, L - 1):
            occ = state.index.setdefault(tuple(tokens[e - n + 1 : e + 1]), [])
            occ.append(e)
            if len(occ) > MAX_OCC:
                del occ[0]
        state.observed = max(state.observed, L - 1)

    def draft(self, tokens: list[int], state: NgramState, max_len: int) -> list[int]:
        """→ up to ``max_len`` proposed next tokens (possibly empty)."""
        n = self.n
        L = len(tokens)
        if max_len <= 0 or L < n + 1:
            return []
        self._absorb(tokens, state)
        occ = state.index.get(tuple(tokens[L - n :]))
        if not occ:
            return []
        e = occ[-1]  # most recent occurrence
        # Self-extending copy: when the continuation run reaches the tail
        # of the history, keep copying from the draft itself — a period-p
        # loop then drafts max_len tokens (cycling the loop) instead of
        # stopping p tokens in. Repetitive generation usually has short
        # periods, so this is where most of the draft length comes from.
        out: list[int] = []
        src = e + 1
        for _ in range(max_len):
            out.append(tokens[src] if src < L else out[src - L])
            src += 1
        return out


class JacobiPool:
    """Lookahead-style candidate pool: maps a short trailing context to
    the model-predicted continuations observed at verify time. Every
    verify pass scores S+1 positions; the per-node argmax (``cand``)
    is what the model WOULD emit after that node's token — a free
    (context → continuation) sample, including at rejected branches.
    Contexts and candidates are recency/hit bounded; lookups are exact
    context matches (g-gram), so drafting from the pool costs one dict
    probe per node, independent of history length."""

    __slots__ = ("g", "table")

    def __init__(self, g: int):
        self.g = max(1, g)
        # ctx → {token: hits}; dict order doubles as recency (re-insert
        # on touch), candidate dicts hit-count-capped at POOL_MAX_CANDS.
        self.table: dict[tuple[int, ...], dict[int, int]] = {}

    def record(self, ctx: tuple[int, ...], nxt: int) -> None:
        cands = self.table.pop(ctx, None)
        if cands is None:
            cands = {}
            if len(self.table) >= POOL_MAX_CONTEXTS:
                # Drop the least recently touched context.
                self.table.pop(next(iter(self.table)))
        cands[nxt] = cands.get(nxt, 0) + 1
        if len(cands) > POOL_MAX_CANDS:
            # Evict the coldest candidate, never the one just recorded.
            worst = min(cands, key=lambda t: (cands[t], t == nxt))
            del cands[worst]
        self.table[ctx] = cands  # re-insert = most recent

    def lookup(self, ctx: tuple[int, ...]) -> list[int]:
        """Candidate continuations, best (most hits) first."""
        cands = self.table.get(ctx)
        if not cands:
            return []
        return sorted(cands, key=lambda t: -cands[t])


class TreeDrafter(NgramDrafter):
    """Tree drafting over two signal sources: the history n-gram index
    (branching wherever a context has several distinct recorded
    continuations) and the Jacobi pool (model-predicted continuations,
    the zero-history-hit path). Expansion is primary-chain-first: the
    best candidate chain is grown to full depth FIRST — so the tree
    always contains the linear draft as its backbone and the extra
    budget buys side branches — then alternates fill what is left."""

    def __init__(self, n: int, width: int, depth: int, pool_g: int = 2):
        super().__init__(n)
        if width < 1:
            raise ValueError(f"spec_tree_width must be >= 1, got {width}")
        self.width = width
        self.depth = depth
        self.pool_g = pool_g

    def new_state(self) -> NgramState:
        st = NgramState()
        st.pool = JacobiPool(self.pool_g)
        return st

    def observe(self, state: NgramState, hist: list[int], node_tokens,
                parents, node_live, cand) -> None:
        """Refresh the Jacobi pool from one verify pass: for every live
        node j, the g-gram context ending at node j (walking parents
        toward the root and into the history tail) paired with the
        model's argmax prediction ``cand[j]`` — a free (context →
        continuation) sample at EVERY node, accepted or not.
        ``hist`` is the sequence history at dispatch (hist[-1] is the
        root token); ``node_live`` is the live node count."""
        pool = state.pool
        if pool is None:
            return
        g = pool.g
        # Per-node context: token chain of length ≤ g ending at the node.
        chains: list[tuple[int, ...]] = []
        for j in range(node_live):
            if j == 0:
                chains.append(tuple(hist[-g:]))
            else:
                p = int(parents[j])
                chains.append((chains[p] + (int(node_tokens[j]),))[-g:])
            pool.record(chains[j], int(cand[j]))

    def _candidates(self, tokens: list[int], state: NgramState,
                    path: tuple[int, ...], width: int) -> list[int]:
        """Distinct continuation candidates for the context
        ``history + path``, best first: history-index continuations in
        recency order, then Jacobi-pool predictions by hit count."""
        n = self.n
        L = len(tokens)
        out: list[int] = []
        seen: set[int] = set()
        if L + len(path) >= n:
            if len(path) >= n:
                key = path[-n:]
            else:
                key = tuple(tokens[L - (n - len(path)):]) + path
            for e in reversed(state.index.get(key, ())):
                # Continuation of the occurrence ending at e (_absorb
                # records ends up to L-2, so e+1 is always in range).
                tok = tokens[e + 1]
                if tok not in seen:
                    seen.add(tok)
                    out.append(tok)
                    if len(out) >= width:
                        return out
        if state.pool is not None:
            g = state.pool.g
            ctx = (tuple(tokens[max(0, L - g):]) + path)[-g:]
            for tok in state.pool.lookup(ctx):
                if tok not in seen:
                    seen.add(tok)
                    out.append(tok)
                    if len(out) >= width:
                        break
        return out

    def draft_tree(self, tokens: list[int], state: NgramState,
                   budget: int, width: int | None = None,
                   depth: int | None = None,
                   constraint: DraftConstraint | None = None) -> TreeDraft:
        """→ a TreeDraft with up to ``budget`` draft nodes, branching up
        to ``width`` per node, paths up to ``depth`` deep. Empty when
        neither the index nor the pool has anything to say.

        With a ``constraint``, candidates are filtered to FSM-legal
        continuations BEFORE a node is added (illegal nodes can never be
        accepted — pruning is pure win), forced states contribute their
        single legal token even with zero index/pool signal, and paths
        may run to the full node budget (forced runs are certainties;
        the depth knob only shapes model-guessed branches)."""
        width = self.width if width is None else width
        depth = self.depth if depth is None else depth
        tree = TreeDraft()
        if budget <= 0 or depth <= 0 or not tokens:
            return tree
        self._absorb(tokens, state)

        remaining = [budget]

        def expand(path: tuple[int, ...], parent_idx: int, depth_left: int,
                   fsm_state=None) -> None:
            if depth_left <= 0 or remaining[0] <= 0:
                return
            if constraint is None:
                cands = self._candidates(tokens, state, path, width)
            else:
                forced = constraint.forced(fsm_state)
                if forced is not None:
                    cands = [forced]
                else:
                    cands = [
                        tok for tok in
                        self._candidates(tokens, state, path, width * 2)
                        if constraint.step(fsm_state, tok) is not None
                    ][:width]
            for tok in cands:
                if remaining[0] <= 0:
                    return
                tree.tokens.append(int(tok))
                tree.parents.append(parent_idx)
                remaining[0] -= 1
                # Primary-chain-first: recurse before trying the next
                # sibling, so the best chain reaches full depth before
                # any budget goes to alternates.
                expand(
                    path + (int(tok),), len(tree.tokens), depth_left - 1,
                    None if constraint is None
                    else constraint.step(fsm_state, tok),
                )

        # Constrained paths may use the whole budget (forced fast-
        # forward); unconstrained trees keep the depth shape knob.
        depth_cap = budget if constraint is not None else min(depth, budget)
        expand((), 0, depth_cap,
               None if constraint is None else constraint.state)
        return tree


def build_drafter(args) -> NgramDrafter:
    """EngineArgs → drafter instance. The single construction seam for
    future backends (draft model, Medusa-style heads). Width 1 keeps the
    PR 5 linear n-gram drafter byte-for-byte; width > 1 builds the tree
    drafter (history branching + Jacobi pool)."""
    width = getattr(args, "spec_tree_width", 1)
    if width <= 1:
        return NgramDrafter(args.spec_ngram)
    depth = getattr(args, "spec_tree_depth", 0) or args.spec_tokens
    return TreeDrafter(args.spec_ngram, width, depth)
