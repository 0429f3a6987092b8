"""ApproxKvIndexer: predicted-cache index for engines that publish no KV
events.

Reference analogue: lib/llm/src/kv_router/approx.rs:166-294 — on each
routing decision, optimistically record the request's blocks as present
on the chosen worker with a TTL (the reference uses 120 s, matching
typical engine cache residency); expired entries lapse lazily. Same
``find_matches`` interface as the real index.
"""

from __future__ import annotations

import heapq
import time

from dynamo_tpu_torch.kv_router.indexer import OverlapScores, WorkerId

DEFAULT_TTL_S = 120.0


class ApproxKvIndexer:
    def __init__(self, ttl_s: float = DEFAULT_TTL_S, clock=time.monotonic):
        self.ttl_s = ttl_s
        self._clock = clock
        self._by_hash: dict[int, dict[WorkerId, float]] = {}  # hash → worker → expiry
        self._by_worker: dict[WorkerId, set[int]] = {}  # worker → hashes (removal index)
        self._heap: list[tuple[float, int, WorkerId]] = []

    def _drop_entry(self, h: int, w: WorkerId) -> None:
        workers = self._by_hash.get(h)
        if workers is not None:
            workers.pop(w, None)
            if not workers:
                del self._by_hash[h]
        hashes = self._by_worker.get(w)
        if hashes is not None:
            hashes.discard(h)
            if not hashes:
                del self._by_worker[w]

    def _expire(self) -> None:
        now = self._clock()
        while self._heap and self._heap[0][0] <= now:
            _, h, w = heapq.heappop(self._heap)
            workers = self._by_hash.get(h)
            if workers is not None:
                exp = workers.get(w)
                if exp is not None and exp <= now:
                    self._drop_entry(h, w)

    def record_routing(self, worker: WorkerId, seq_hashes: list[int]) -> None:
        """The request was sent to `worker`: assume its blocks will be (or
        are) cached there for the TTL."""
        exp = self._clock() + self.ttl_s
        hashes = self._by_worker.setdefault(worker, set())
        for h in seq_hashes:
            self._by_hash.setdefault(h, {})[worker] = exp
            hashes.add(h)
            heapq.heappush(self._heap, (exp, h, worker))

    def find_matches(self, seq_hashes: list[int], top_k: int = 0) -> OverlapScores:
        self._expire()
        scores: dict[WorkerId, int] = {}
        alive: set[WorkerId] | None = None
        drops: list[tuple[int, set[WorkerId]]] = []
        depth_reached = 0
        for depth, h in enumerate(seq_hashes, start=1):
            present = self._by_hash.get(h)
            if not present:
                break
            current = set(present) if alive is None else (alive & set(present))
            if not current:
                break
            if top_k <= 0:
                for w in current:
                    scores[w] = depth
            else:
                if alive is not None and len(current) < len(alive):
                    drops.append((depth - 1, alive - current))
                depth_reached = depth
            alive = current
        if top_k <= 0:
            return OverlapScores(scores)
        if alive:
            for w in alive:
                scores[w] = depth_reached
                if len(scores) >= top_k:
                    break
        for d, ws in reversed(drops):
            if len(scores) >= top_k:
                break
            for w in ws:
                scores[w] = d
                if len(scores) >= top_k:
                    break
        return OverlapScores(scores)

    def remove_worker(self, worker: WorkerId) -> None:
        # Per-worker hash index: O(worker's entries), not a sweep of the
        # whole table (quadratic under fleet-wide churn).
        for h in list(self._by_worker.get(worker, ())):
            workers = self._by_hash.get(h)
            if workers is not None:
                workers.pop(worker, None)
                if not workers:
                    del self._by_hash[h]
        self._by_worker.pop(worker, None)
