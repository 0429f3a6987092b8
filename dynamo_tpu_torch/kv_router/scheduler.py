"""KV-aware worker selection: overlap-weighted cost + softmax sampling.

Reference analogue: lib/llm/src/kv_router/scheduler.rs —
cost = ``overlap_score_weight × potential_prefill_blocks +
potential_decode_blocks`` per worker, min-max normalized, then
softmax-sampled with ``router_temperature`` (0 ⇒ deterministic argmin;
scheduler.rs:272-340,356-439). Temperature>0 spreads bursts of identical
prompts across workers instead of herding them onto one.

Transfer-vs-recompute pricing: when a global prefix directory is live
(fleet/directory.py) the router also passes each candidate's FETCHABLE
depth — prefix blocks it is missing locally but could pull from a
directory-listed holder over the credit-flow transfer plane
(llm/peer_kv.py). Those blocks are priced at ``transfer_block_cost``
(< 1.0: a DMA'd block is cheaper than recomputing it, Mooncake's
transfer-vs-compute tradeoff) instead of full recompute, so a cold but
idle engine next to a warm peer can beat a warm but saturated one —
the directory stops being a stickiness booster and becomes an economy.

Migration-aware placement (Llumnix composition): when a fleet balancer
runs (planner/balancer.py), landing on a loaded-but-warm engine is no
longer a terminal decision — the balancer can relocate the decode later
for roughly one migration's worth of transfer. With
``migrate_cost_blocks`` set, each candidate's decode-load term is capped
at the fleet mean plus that cost: excess load above the mean is priced
as "admit here, shed later" instead of at face value, so cache affinity
wins ties it would otherwise lose to a cold idle engine. ``None``
(default) keeps the original pricing for balancer-less deployments.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

from dynamo_tpu_torch.kv_router.indexer import OverlapScores
from dynamo_tpu_torch.kv_router.sequence import ActiveSequences

WorkerId = int


@dataclass
class KvSchedulerConfig:
    overlap_score_weight: float = 1.0
    router_temperature: float = 0.0
    # Candidate pruning: score only `shortlist ∪ least-loaded-m ∪
    # sticky/directory hits` instead of every worker. The shortlist is
    # the overlap index's ranked top-k holders (indexer.find_matches
    # top_k); least-loaded-m comes from the ActiveSequences idle heap.
    # 0 disables pruning entirely — the full-scan loop runs byte-for-byte
    # as before (the escape hatch). Fleets no larger than
    # shortlist_k + least_loaded_m always take the full scan: pruning
    # there saves nothing and the exact argmin is free.
    shortlist_k: int = 16
    least_loaded_m: int = 4
    # Cost of pulling one missing prefix block from a peer, in units of
    # recomputing one block locally (0 = transfers are free, 1 = no
    # cheaper than recompute — directory pricing effectively off).
    # ~0.35 matches the measured peer-fetch vs prefill ratio on the
    # loopback transfer plane (BENCH_DISAGG_r08 frame throughput vs
    # prefill tok/s); a WAN-separated fleet wants it near 1.
    transfer_block_cost: float = 0.35
    # Migration-aware decode pricing: cap each candidate's decode-load
    # term at fleet_mean + migrate_cost_blocks (the amortized price of
    # one later balancer move, in blocks). None = off — load is priced
    # at face value, correct when no balancer will relocate decodes.
    migrate_cost_blocks: float | None = None


@dataclass
class Placement:
    worker: WorkerId
    overlap_blocks: int
    total_blocks: int
    # Blocks the chosen worker should PULL from a peer (directory-priced
    # transfer); 0 when the plain overlap path won.
    fetch_blocks: int = 0
    # Observability: how many workers were actually cost-scored, and
    # whether the full-scan path ran (True for shortlist_k=0, small
    # fleets, or an unsynced roster — the pruned path's fallback).
    candidates_considered: int = 0
    full_scan: bool = True


class KvScheduler:
    def __init__(self, config: KvSchedulerConfig | None = None, rng: random.Random | None = None):
        self.config = config or KvSchedulerConfig()
        self._rng = rng or random.Random()

    def schedule(
        self,
        workers: list[WorkerId],
        request_blocks: int,
        overlaps: OverlapScores,
        active: ActiveSequences,
        fetchable: dict[WorkerId, int] | None = None,
        workers_set: set[WorkerId] | None = None,
        fetch_default: int = 0,
    ) -> Placement:
        """Pick a worker for a request spanning ``request_blocks`` blocks.

        ``fetchable`` maps worker → the deepest leading-run depth any
        OTHER directory-listed holder has for this request (absolute
        blocks from the root); the part beyond the worker's own overlap
        is what a transfer would save, priced at transfer_block_cost.

        With ``shortlist_k > 0`` and a fleet larger than
        shortlist_k + least_loaded_m, only the candidate set
        `overlap holders ∪ fetchable holders ∪ least-loaded-m` is scored
        (O(k), not O(fleet)). Every worker with nonzero overlap/fetch that
        survived index top-k pruning is in the set, and among the
        zero-overlap rest cost differs only by load — so when the index
        shortlist covers all holders the pruned argmin equals the
        full-scan argmin exactly (docs/performance.md, shortlist recall
        policy). ``workers_set`` (eligible-worker membership) avoids an
        O(fleet) set build when the caller already has one."""
        if not workers:
            raise ValueError("no workers")
        k = self.config.shortlist_k
        m = self.config.least_loaded_m
        if k <= 0 or len(workers) <= k + m or active.roster_size() == 0:
            return self._schedule_full(workers, request_blocks, overlaps, active,
                                       fetchable, fetch_default)
        wset = workers_set if workers_set is not None else set(workers)
        cand: list[WorkerId] = []
        seen: set[WorkerId] = set()
        for w in overlaps.scores:
            if w in wset:
                seen.add(w)
                cand.append(w)
        if fetchable:
            for w in fetchable:
                if w in wset and w not in seen:
                    seen.add(w)
                    cand.append(w)
        for w in active.least_loaded(m, exclude=seen):
            if w in wset:
                cand.append(w)
        if not cand:
            return self._schedule_full(workers, request_blocks, overlaps, active,
                                       fetchable, fetch_default)
        mean = active.roster_mean_load()
        return self._score(cand, request_blocks, overlaps, active, fetchable,
                           fetch_default, mean=mean, full_scan=False)

    def _schedule_full(
        self,
        workers: list[WorkerId],
        request_blocks: int,
        overlaps: OverlapScores,
        active: ActiveSequences,
        fetchable: dict[WorkerId, int] | None,
        fetch_default: int = 0,
    ) -> Placement:
        """Legacy O(fleet) scan — the shortlist_k=0 escape hatch. Scores
        every worker and derives the fleet mean from the scored loads,
        byte-identical to the pre-shortlist scheduler."""
        per_worker: list[tuple[int, int]] = []  # (overlap, fetch) per worker
        loads: list[int] = []
        for w in workers:
            overlap = min(overlaps.scores.get(w, 0), request_blocks)
            fetch = self._fetch_blocks(w, overlap, request_blocks, fetchable, fetch_default)
            per_worker.append((overlap, fetch))
            loads.append(active.active_blocks(w))
        priced = self._priced_loads(loads)
        costs: list[float] = []
        for (overlap, fetch), load in zip(per_worker, priced):
            potential_prefill = (
                request_blocks
                - overlap
                - fetch
                + self.config.transfer_block_cost * fetch
            )
            potential_decode = load + request_blocks
            costs.append(
                self.config.overlap_score_weight * potential_prefill + potential_decode
            )
        idx = softmax_sample(costs, self.config.router_temperature, self._rng)
        overlap, fetch = per_worker[idx]
        return Placement(
            worker=workers[idx],
            overlap_blocks=overlap,
            total_blocks=request_blocks,
            fetch_blocks=fetch,
            candidates_considered=len(workers),
            full_scan=True,
        )

    def _score(
        self,
        cand: list[WorkerId],
        request_blocks: int,
        overlaps: OverlapScores,
        active: ActiveSequences,
        fetchable: dict[WorkerId, int] | None,
        fetch_default: int,
        mean: float,
        full_scan: bool,
    ) -> Placement:
        """Cost-score ``cand`` only, using the incrementally-maintained
        roster mean for migration-aware load pricing instead of an
        O(fleet) recompute."""
        cap_extra = self.config.migrate_cost_blocks
        cap = None if cap_extra is None else mean + cap_extra
        per_worker: list[tuple[int, int]] = []
        costs: list[float] = []
        for w in cand:
            overlap = min(overlaps.scores.get(w, 0), request_blocks)
            fetch = self._fetch_blocks(w, overlap, request_blocks, fetchable, fetch_default)
            per_worker.append((overlap, fetch))
            load = float(active.active_blocks(w))
            if cap is not None and load > cap:
                load = cap
            potential_prefill = (
                request_blocks
                - overlap
                - fetch
                + self.config.transfer_block_cost * fetch
            )
            potential_decode = load + request_blocks
            costs.append(
                self.config.overlap_score_weight * potential_prefill + potential_decode
            )
        idx = softmax_sample(costs, self.config.router_temperature, self._rng)
        overlap, fetch = per_worker[idx]
        return Placement(
            worker=cand[idx],
            overlap_blocks=overlap,
            total_blocks=request_blocks,
            fetch_blocks=fetch,
            candidates_considered=len(cand),
            full_scan=full_scan,
        )

    def _priced_loads(self, loads: list[int]) -> list[float]:
        """Decode-load term per worker under migration-aware pricing.

        With a balancer running, load above the fleet mean is transient —
        the balancer sheds it — so excess beyond mean + migrate_cost_blocks
        is not charged against a warm candidate."""
        cap_extra = self.config.migrate_cost_blocks
        if cap_extra is None or len(loads) < 2:
            return [float(l) for l in loads]
        mean = sum(loads) / len(loads)
        return [min(float(l), mean + cap_extra) for l in loads]

    @staticmethod
    def _fetch_blocks(
        w: WorkerId, overlap: int, request_blocks: int,
        fetchable: dict[WorkerId, int] | None,
        default: int = 0,
    ) -> int:
        """``default`` is the compact-fetchable fallback depth for workers
        the dict doesn't list (pruned mode lists holders only; everyone
        else's max-over-other-holders run is the global best run)."""
        if not fetchable:
            return 0
        return max(0, min(fetchable.get(w, default), request_blocks) - overlap)


def softmax_sample(costs: list[float], temperature: float, rng: random.Random) -> int:
    """Sample an index ∝ softmax(-normalized_cost / temperature).
    temperature <= 0 → argmin (ties broken at random, as the reference
    does to avoid herding)."""
    lo, hi = min(costs), max(costs)
    if temperature <= 0.0 or hi == lo:
        best = [i for i, c in enumerate(costs) if c == lo]
        return rng.choice(best)
    norm = [(c - lo) / (hi - lo) for c in costs]
    logits = [-n / temperature for n in norm]
    m = max(logits)
    exps = [math.exp(l - m) for l in logits]
    total = sum(exps)
    r = rng.random() * total
    acc = 0.0
    for i, e in enumerate(exps):
        acc += e
        if r <= acc:
            return i
    return len(costs) - 1
