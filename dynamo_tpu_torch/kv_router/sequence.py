"""Active-sequence tracking: the router's view of each worker's load.

Reference analogue: ``ActiveSequences``/``ActiveSequencesMultiWorker``
(reference: lib/llm/src/kv_router/sequence.rs:51-232,240-521): per worker,
the blocks and tokens of requests it is currently serving — *including*
the request being placed ("potential" load) — with prefill-complete and
free transitions. The cost scheduler reads these to balance load.

Cluster-scale addition: the ledger also maintains the *fleet aggregates*
the scheduler used to recompute per request — a running total of active
blocks (for the fleet-load mean) and a lazily-invalidated min-heap of
(load, worker) for least-loaded-m candidate selection. Both are updated
on load deltas, so placement stops paying O(fleet) per request
(docs/performance.md "Control-plane scaling").
"""

from __future__ import annotations

import heapq
from collections.abc import Iterable
from dataclasses import dataclass

WorkerId = int


@dataclass
class _ActiveReq:
    worker: WorkerId
    new_blocks: int      # blocks this request adds (non-overlapping)
    tokens: int          # prompt tokens still prefilling (0 once complete)


class ActiveSequences:
    """Multi-worker active-request ledger (router-side bookkeeping only —
    workers are the source of truth for their real usage)."""

    def __init__(self):
        self._reqs: dict[str, _ActiveReq] = {}
        self._blocks: dict[WorkerId, int] = {}
        self._prefill_tokens: dict[WorkerId, int] = {}
        self._count: dict[WorkerId, int] = {}
        # -- incremental fleet aggregates (shortlist scheduling) ----------
        # Roster = workers eligible for placement, synced by the router on
        # discovery-version change (O(fleet) once per roster change, not
        # per request). The heap uses lazy deletion: every load delta for
        # a rostered worker pushes a fresh (load, worker) entry; stale
        # entries are discarded on pop by comparing against current load.
        self._roster: set[WorkerId] = set()
        self._roster_total: int = 0           # sum of rostered workers' blocks
        self._heap: list[tuple[int, WorkerId]] = []

    # -- request transitions ----------------------------------------------

    def add_request(
        self, request_id: str, worker: WorkerId, total_blocks: int, overlap_blocks: int, prompt_tokens: int
    ) -> None:
        new_blocks = max(0, total_blocks - overlap_blocks)
        self._reqs[request_id] = _ActiveReq(worker, new_blocks, prompt_tokens)
        load = self._blocks.get(worker, 0) + new_blocks
        self._blocks[worker] = load
        self._prefill_tokens[worker] = self._prefill_tokens.get(worker, 0) + prompt_tokens
        self._count[worker] = self._count.get(worker, 0) + 1
        if worker in self._roster:
            self._roster_total += new_blocks
            self._push(load, worker)

    def mark_prefill_complete(self, request_id: str) -> None:
        req = self._reqs.get(request_id)
        if req is not None and req.tokens:
            self._prefill_tokens[req.worker] -= req.tokens
            req.tokens = 0

    def free(self, request_id: str) -> None:
        req = self._reqs.pop(request_id, None)
        if req is None:
            return
        load = self._blocks.get(req.worker, 0) - req.new_blocks
        self._blocks[req.worker] = load
        if req.tokens:
            self._prefill_tokens[req.worker] -= req.tokens
        self._count[req.worker] = self._count.get(req.worker, 0) - 1
        if req.worker in self._roster:
            self._roster_total -= req.new_blocks
            self._push(load, req.worker)

    def remove_worker(self, worker: WorkerId) -> None:
        for rid in [r for r, req in self._reqs.items() if req.worker == worker]:
            self._reqs.pop(rid)
        if worker in self._roster:
            self._roster.discard(worker)
            self._roster_total -= self._blocks.get(worker, 0)
        self._blocks.pop(worker, None)
        self._prefill_tokens.pop(worker, None)
        self._count.pop(worker, None)

    # -- point reads -------------------------------------------------------

    def active_blocks(self, worker: WorkerId) -> int:
        return self._blocks.get(worker, 0)

    def prefill_tokens(self, worker: WorkerId) -> int:
        return self._prefill_tokens.get(worker, 0)

    def active_count(self, worker: WorkerId) -> int:
        return self._count.get(worker, 0)

    # -- fleet aggregates --------------------------------------------------

    def _push(self, load: int, worker: WorkerId) -> None:
        heapq.heappush(self._heap, (load, worker))
        if len(self._heap) > max(64, 4 * len(self._roster)):
            self._rebuild_heap()

    def _rebuild_heap(self) -> None:
        self._heap = [(self._blocks.get(w, 0), w) for w in self._roster]
        heapq.heapify(self._heap)

    def sync_roster(self, workers: Iterable[WorkerId]) -> None:
        """Set the placement-eligible roster (call on discovery change)."""
        roster = set(workers)
        if roster == self._roster:
            return
        self._roster = roster
        self._roster_total = sum(self._blocks.get(w, 0) for w in roster)
        self._rebuild_heap()

    def roster_size(self) -> int:
        return len(self._roster)

    def roster_mean_load(self) -> float:
        """Mean active blocks across the roster (0.0 on an empty roster)."""
        if not self._roster:
            return 0.0
        return self._roster_total / len(self._roster)

    def least_loaded(self, m: int, exclude: frozenset[WorkerId] | set[WorkerId] = frozenset()) -> list[WorkerId]:
        """Up to ``m`` distinct least-loaded rostered workers, skipping
        ``exclude``. Lazy-deletion pops: an entry is valid only if the
        worker is rostered and the recorded load equals its current load
        (a fresher entry always exists otherwise, pushed on the delta)."""
        out: list[WorkerId] = []
        keep: list[tuple[int, WorkerId]] = []
        seen: set[WorkerId] = set()
        heap = self._heap
        while heap and len(out) < m:
            load, w = heapq.heappop(heap)
            if w in seen or w not in self._roster:
                continue
            if load != self._blocks.get(w, 0):
                continue  # stale; the fresher entry is still in the heap
            seen.add(w)
            keep.append((load, w))
            if w not in exclude:
                out.append(w)
        for entry in keep:
            heapq.heappush(heap, entry)
        return out
