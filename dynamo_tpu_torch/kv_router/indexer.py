"""Global KV index: which worker holds which cached blocks.

Reference analogue: the radix tree + event-driven indexer
(reference: lib/llm/src/kv_router/indexer.rs:222-446,641-766).

Because block identity is the *chained* sequence hash (tokens.py), the
"radix tree" collapses to a hash-keyed node table: a node's key already
encodes its whole prefix, so matching a request is walking its hash list
until a miss, accumulating per-worker consecutive-match depth. Node
children links exist for cascade-removal bookkeeping.

The reference also hardens against event gaps with per-worker event_id
tracking; we mirror that: a gap triggers a full drop of the worker's
state (the subscription layer re-snapshots).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from dynamo_tpu_torch.kv_router.protocols import CLEARED, REMOVED, STORED, KvCacheEvent

WorkerId = int


@dataclass
class OverlapScores:
    """worker → number of consecutive prompt blocks already cached there.

    When produced with ``top_k > 0`` the dict holds only the k deepest
    holders (a ranked shortlist), not every holder in the fleet."""

    scores: dict[WorkerId, int] = field(default_factory=dict)

    def best(self) -> int:
        return max(self.scores.values(), default=0)


class _Node:
    __slots__ = ("hash", "parent", "children", "workers")

    def __init__(self, h: int, parent: int | None):
        self.hash = h
        self.parent = parent
        self.children: set[int] = set()
        self.workers: set[WorkerId] = set()


class RadixIndex:
    """Single-threaded (asyncio) index over chained block hashes."""

    def __init__(self):
        self._nodes: dict[int, _Node] = {}
        self._worker_blocks: dict[WorkerId, set[int]] = {}
        self._worker_event_ids: dict[WorkerId, int] = {}

    # -- queries ----------------------------------------------------------

    def find_matches(self, seq_hashes: list[int], top_k: int = 0) -> OverlapScores:
        """Per-worker consecutive-prefix depth over the request's block
        hash chain.

        ``top_k == 0``: full scores dict, every holder (legacy behavior,
        byte-identical to the pre-shortlist code path).

        ``top_k > 0``: ranked shortlist of at most ``top_k`` holders,
        deepest first. Instead of rewriting every surviving worker's
        score at every depth (O(holders x chain)), the walk records only
        *drop events* — the depth at which a worker stops matching — and
        scores each holder exactly once: O(chain + holders)."""
        if top_k <= 0:
            scores: dict[WorkerId, int] = {}
            alive: set[WorkerId] | None = None
            for depth, h in enumerate(seq_hashes, start=1):
                node = self._nodes.get(h)
                if node is None or not node.workers:
                    break
                current = node.workers if alive is None else (alive & node.workers)
                if not current:
                    break
                for w in current:
                    scores[w] = depth
                alive = set(current)
            return OverlapScores(scores)
        return self._find_top_k(seq_hashes, top_k)

    def _find_top_k(self, seq_hashes: list[int], top_k: int) -> OverlapScores:
        alive: set[WorkerId] | None = None
        drops: list[tuple[int, set[WorkerId]]] = []  # (depth scored, workers)
        depth_reached = 0
        for depth, h in enumerate(seq_hashes, start=1):
            node = self._nodes.get(h)
            if node is None or not node.workers:
                break
            current = node.workers if alive is None else (alive & node.workers)
            if not current:
                break
            if alive is not None and len(current) < len(alive):
                drops.append((depth - 1, alive - current))
            alive = set(current)
            depth_reached = depth
        scores: dict[WorkerId, int] = {}
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

    def workers(self) -> set[WorkerId]:
        return set(self._worker_blocks)

    def num_blocks(self, worker: WorkerId) -> int:
        return len(self._worker_blocks.get(worker, ()))

    # -- event application -------------------------------------------------

    def apply(self, worker: WorkerId, event: KvCacheEvent) -> bool:
        """Apply one worker event. Returns False when an event-id gap was
        detected (caller should drop + resubscribe the worker)."""
        if event.event_id == 0:
            # Pre-stream events (subscription reset marker / snapshot):
            # outside the gap-tracked live sequence.
            if event.kind == CLEARED:
                self.remove_worker(worker)
                return True
        else:
            last = self._worker_event_ids.get(worker)
            if last is not None and event.event_id != last + 1:
                self.remove_worker(worker)
                return False
            self._worker_event_ids[worker] = event.event_id
        if event.kind == STORED:
            for b in event.blocks:
                self._store(worker, b.block_hash, b.parent_hash)
        elif event.kind == REMOVED:
            for h in event.block_hashes:
                self._remove(worker, h)
        elif event.kind == CLEARED:
            self._drop_blocks(worker)
        return True

    def _store(self, worker: WorkerId, h: int, parent: int | None) -> None:
        node = self._nodes.get(h)
        if node is None:
            node = self._nodes[h] = _Node(h, parent)
            if parent is not None:
                pnode = self._nodes.get(parent)
                if pnode is not None:
                    pnode.children.add(h)
        node.workers.add(worker)
        self._worker_blocks.setdefault(worker, set()).add(h)

    def _remove(self, worker: WorkerId, h: int) -> None:
        node = self._nodes.get(h)
        if node is None:
            return
        node.workers.discard(worker)
        blocks = self._worker_blocks.get(worker)
        if blocks is not None:
            blocks.discard(h)
        self._prune(node)

    def _prune(self, node: _Node) -> None:
        # Iterative: block chains can be thousands deep (long contexts).
        while not node.workers and not node.children:
            self._nodes.pop(node.hash, None)
            if node.parent is None:
                return
            pnode = self._nodes.get(node.parent)
            if pnode is None:
                return
            pnode.children.discard(node.hash)
            node = pnode

    def _drop_blocks(self, worker: WorkerId) -> None:
        # Batch removal via the per-worker node index: pop the worker's
        # whole hash set once, detach it from each node, then prune only
        # the nodes that actually emptied. The old path called _remove per
        # hash, re-fetching and mutating the per-worker set for every
        # block — under zonal-failure churn at 1000 engines that sweep is
        # the router's dominant stall.
        blocks = self._worker_blocks.pop(worker, None)
        if not blocks:
            return
        emptied: list[_Node] = []
        for h in blocks:
            node = self._nodes.get(h)
            if node is None:
                continue
            node.workers.discard(worker)
            if not node.workers:
                emptied.append(node)
        for node in emptied:
            self._prune(node)

    def remove_worker(self, worker: WorkerId) -> None:
        """Worker died or resubscribed: drop all its blocks."""
        self._drop_blocks(worker)
        self._worker_event_ids.pop(worker, None)


class ShardedRadixIndex:
    """Scale-out indexer (reference: ``KvIndexerSharded``,
    lib/llm/src/kv_router/indexer.rs:856-985): workers are assigned to
    shards least-loaded-first, each shard owns an independent
    ``RadixIndex`` driven by its own thread, and ``find_matches`` merges
    per-shard scores (a worker's blocks live wholly in its shard, so the
    merged dicts are disjoint).

    Python twist on the reference's tokio-tasks-per-shard: daemon threads
    with ordered per-shard queues. The payoff here is less about raw
    events/s (the GIL bounds dict mutation) and more that event FLOODS
    never run on the routing asyncio loop — routing latency stays flat
    while shard threads chew through bursts (tools/profile_indexer.py
    measures both). Overflow policy matches the reference's gap story:
    a shard queue past its bound drops that worker's state and reports
    False so the subscription layer re-snapshots; all mutations ride the
    queue, so drop → resnapshot ordering is preserved."""

    def __init__(self, num_shards: int = 4, max_queue: int = 8192):
        import queue as _queue
        import threading

        self.num_shards = max(1, num_shards)
        self.max_queue = max_queue
        self._shards = [RadixIndex() for _ in range(self.num_shards)]
        self._locks = [threading.Lock() for _ in range(self.num_shards)]
        self._queues: list[_queue.Queue] = [_queue.Queue() for _ in range(self.num_shards)]
        self._assign: dict[WorkerId, int] = {}
        self._counts = [0] * self.num_shards
        # A removed worker that rejoins (gap/overflow → resnapshot) MUST
        # land on its old shard: its queued remove op and the fresh
        # snapshot then share one queue, so ordering guarantees the state
        # never straddles two shards (find_matches merges assuming
        # disjoint workers). Bounded: it only holds ints.
        self._last_shard: dict[WorkerId, int] = {}
        self._worker_event_ids: dict[WorkerId, int] = {}
        self._threads = [
            threading.Thread(target=self._shard_loop, args=(i,),
                             name=f"kv-index-shard-{i}", daemon=True)
            for i in range(self.num_shards)
        ]
        for t in self._threads:
            t.start()

    def _shard_loop(self, i: int) -> None:
        # Ops are drained in batches under ONE lock acquisition, with an
        # explicit yield between batches: per-op lock cycling starves
        # concurrent find_matches callers (measured p99 26→0.1 ms with
        # batching, tools/profile_indexer.py).
        import queue as _queue
        import time as _time

        q, shard, lock = self._queues[i], self._shards[i], self._locks[i]
        while True:
            batch = [q.get()]
            while len(batch) < 256 and batch[-1] is not None:
                try:
                    batch.append(q.get_nowait())
                except _queue.Empty:
                    break
            stop = batch[-1] is None
            if stop:
                batch.pop()
            with lock:
                for kind, worker, event in batch:
                    if kind == "apply":
                        shard.apply(worker, event)
                    else:
                        shard.remove_worker(worker)
            for _ in range(len(batch) + (1 if stop else 0)):
                q.task_done()
            if stop:
                return
            _time.sleep(0)  # let queued find_matches grab the lock

    def _shard_of(self, worker: WorkerId) -> int:
        s = self._assign.get(worker)
        if s is None:
            s = self._last_shard.get(worker)  # sticky rejoin (see above)
            if s is None:
                s = min(range(self.num_shards), key=lambda i: self._counts[i])
            self._assign[worker] = s
            self._counts[s] += 1
        return s

    # -- RadixIndex-compatible surface -------------------------------------

    def apply(self, worker: WorkerId, event: KvCacheEvent) -> bool:
        # Gap tracking stays synchronous (cheap int compare) so the
        # caller's drop+resnapshot contract is preserved; the heavy dict
        # mutation is what moves to the shard thread.
        if event.event_id == 0:
            if event.kind == CLEARED:
                self.remove_worker(worker)
                return True
        else:
            last = self._worker_event_ids.get(worker)
            if last is not None and event.event_id != last + 1:
                self.remove_worker(worker)
                return False
            self._worker_event_ids[worker] = event.event_id
        s = self._shard_of(worker)
        if self._queues[s].qsize() >= self.max_queue:
            # Back-pressure: cheaper to resync this worker from a fresh
            # snapshot than to buffer an unbounded backlog.
            self.remove_worker(worker)
            return False
        self._queues[s].put(("apply", worker, event))
        return True

    def remove_worker(self, worker: WorkerId) -> None:
        s = self._assign.pop(worker, None)
        self._worker_event_ids.pop(worker, None)
        if s is not None:
            self._counts[s] -= 1
            if len(self._last_shard) > 4096:
                self._last_shard.clear()  # churn bound; stickiness is best-effort
            self._last_shard[worker] = s
            self._queues[s].put(("remove", worker, None))

    def find_matches(self, seq_hashes: list[int], top_k: int = 0) -> OverlapScores:
        scores: dict[WorkerId, int] = {}
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                scores.update(shard.find_matches(seq_hashes, top_k=top_k).scores)
        if top_k > 0 and len(scores) > top_k:
            # Per-shard shortlists are disjoint (a worker lives wholly in
            # one shard); re-rank the union down to the global top-k.
            import heapq as _heapq

            scores = dict(_heapq.nlargest(top_k, scores.items(), key=lambda kv: kv[1]))
        return OverlapScores(scores)

    def workers(self) -> set[WorkerId]:
        out: set[WorkerId] = set()
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                out |= shard.workers()
        return out

    def num_blocks(self, worker: WorkerId) -> int:
        s = self._assign.get(worker)
        if s is None:
            return 0
        with self._locks[s]:
            return self._shards[s].num_blocks(worker)

    def flush(self) -> None:
        """Block until every queued mutation has been applied (tests,
        shutdown barriers)."""
        for q in self._queues:
            q.join()

    def close(self) -> None:
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join(timeout=5.0)
