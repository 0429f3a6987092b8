"""G1 (device/HBM) block pool: allocation, ref-counting, prefix reuse, LRU
eviction, KV event emission.

Reference analogue: lib/llm/src/block_manager/pool.rs:156,457 (active +
inactive pools with sequence-hash reuse matching) and the block lifecycle
Reset→Partial→Complete→Registered (block_manager/block/registry.rs).

States here:

- **free**: on the free list, contents meaningless.
- **active**: ref_count > 0, owned by ≥1 live sequence. A block becomes
  *registered* (hash known, event emitted) once it holds a full block of
  tokens; shared prefix blocks are active with ref_count > 1.
- **cached**: ref_count == 0 but registered — contents retained for
  future prefix hits, evictable LRU-first.

Block id 0 is reserved as the garbage sink for padded writes (model.py
contract) and never allocated.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

from dynamo_tpu_torch.kv_router.protocols import KvCacheEvent, StoredBlock

EventSink = Callable[[KvCacheEvent], None]


class NoFreeBlocksError(Exception):
    pass


class _Block:
    __slots__ = ("block_id", "ref_count", "seq_hash", "parent_hash")

    def __init__(self, block_id: int):
        self.block_id = block_id
        self.ref_count = 0
        self.seq_hash: int | None = None
        self.parent_hash: int | None = None


class BlockPool:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        event_sink: EventSink | None = None,
        enable_prefix_caching: bool = True,
    ):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self._blocks = [_Block(i) for i in range(num_blocks)]
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))  # pop() → low ids first
        self._cached: dict[int, int] = {}          # seq_hash → block_id (registered)
        self._lru: OrderedDict[int, None] = OrderedDict()  # block_id → None, oldest first
        # Radix fan-out: parent seq_hash → number of REGISTERED children.
        # A hash with >= 2 children is a branch point (shared prefix that
        # several continuations diverge from) — the tier eviction policy
        # protects those blocks from one-off-prompt churn.
        self._children: dict[int, int] = {}
        self._event_sink = event_sink
        self._event_id = 0
        # Mutations run on the engine scheduler thread while snapshot()/
        # metrics run on the asyncio loop thread (kv_events subscribers,
        # load_metrics) — every public method takes this lock.
        self._lock = threading.RLock()
        # prefix-cache observability
        self.hit_blocks = 0
        self.miss_blocks = 0

    # -- events -----------------------------------------------------------

    def set_event_sink(self, sink: EventSink | None) -> None:
        """Late-bind the event sink (workers construct engine-then-
        broadcaster). Events emitted before binding are recoverable via
        snapshot()."""
        self._event_sink = sink

    def _emit(self, event: KvCacheEvent) -> None:
        if self._event_sink is not None:
            self._event_id += 1
            event.event_id = self._event_id
            self._event_sink(event)

    # -- capacity ---------------------------------------------------------

    @property
    def num_free(self) -> int:
        """Blocks obtainable right now (free list + evictable cached)."""
        with self._lock:
            return len(self._free) + len(self._lru)

    @property
    def num_active(self) -> int:
        return self.num_blocks - 1 - self.num_free

    @property
    def usage(self) -> float:
        cap = self.num_blocks - 1
        return self.num_active / cap if cap else 0.0

    @property
    def hit_rate(self) -> float:
        total = self.hit_blocks + self.miss_blocks
        return self.hit_blocks / total if total else 0.0

    # -- allocation -------------------------------------------------------

    def match_prefix(self, seq_hashes: list[int]) -> list[int]:
        """Longest run of leading hashes present in the cache → block ids.
        (Chained hashes: a hit at i implies hits at 0..i-1 had the same
        content, so greedy front-matching is exact.)"""
        if not self.enable_prefix_caching:
            return []
        with self._lock:
            out: list[int] = []
            for h in seq_hashes:
                bid = self._cached.get(h)
                if bid is None:
                    break
                out.append(bid)
            return out

    def allocate_sequence(self, seq_hashes: list[int], total_blocks: int) -> tuple[list[int], int]:
        """Allocate ``total_blocks`` for a sequence whose complete-prompt
        block hashes are ``seq_hashes``. Reuses cached prefix blocks.

        → (block_ids, num_hit_blocks). Raises NoFreeBlocksError (nothing
        allocated) if the pool can't satisfy the request."""
        with self._lock:
            hits = self.match_prefix(seq_hashes)
            need_new = total_blocks - len(hits)
            if need_new > len(self._free) + len(self._lru) - self._lru_overlap(hits):
                raise NoFreeBlocksError(f"need {need_new}, have {self.num_free}")
            # Claim hits first (removes them from the evictable LRU).
            for bid in hits:
                self._ref(bid)
            block_ids = list(hits)
            try:
                for _ in range(need_new):
                    block_ids.append(self._pop_free())
            except NoFreeBlocksError:
                for bid in block_ids:
                    self._unref(bid)
                raise
            self.hit_blocks += len(hits)
            self.miss_blocks += max(0, len(seq_hashes) - len(hits))
            return block_ids, len(hits)

    def allocate_block(self) -> int:
        """One fresh block (decode growth). Raises NoFreeBlocksError."""
        with self._lock:
            return self._pop_free()

    def _lru_overlap(self, hits: list[int]) -> int:
        # hits currently in LRU will leave it on _ref; they don't reduce
        # the evictable supply for the *new* blocks beyond themselves.
        return sum(1 for b in hits if b in self._lru)

    def _pop_free(self) -> int:
        if self._free:
            bid = self._free.pop()
        elif self._lru:
            bid, _ = self._lru.popitem(last=False)  # oldest
            self._evict(bid)
        else:
            raise NoFreeBlocksError("pool exhausted")
        b = self._blocks[bid]
        b.ref_count = 1
        b.seq_hash = None
        b.parent_hash = None
        return bid

    def _evict(self, bid: int) -> None:
        b = self._blocks[bid]
        if b.seq_hash is not None:
            self._cached.pop(b.seq_hash, None)
            self._emit(KvCacheEvent.removed([b.seq_hash]))
            self._drop_child(b.parent_hash)
            b.seq_hash = None
            b.parent_hash = None

    def _drop_child(self, parent_hash: int | None) -> None:
        if parent_hash is None:
            return
        n = self._children.get(parent_hash, 0) - 1
        if n > 0:
            self._children[parent_hash] = n
        else:
            self._children.pop(parent_hash, None)

    def _ref(self, bid: int) -> None:
        b = self._blocks[bid]
        b.ref_count += 1
        if b.ref_count == 1:
            self._lru.pop(bid, None)

    def _unref(self, bid: int) -> None:
        b = self._blocks[bid]
        b.ref_count -= 1
        if b.ref_count > 0:
            return
        if b.seq_hash is not None and self.enable_prefix_caching:
            self._lru[bid] = None  # retained, evictable
            self._lru.move_to_end(bid)
        else:
            b.seq_hash = None
            self._free.append(bid)

    # -- registration (block completion) ----------------------------------

    def register_block(self, bid: int, seq_hash: int, parent_hash: int | None) -> int:
        """A sequence filled this block: record its identity and emit a
        `stored` event. If an identical registered block already exists
        (same hash, concurrent fill), the caller keeps its copy but the
        canonical cache entry stays with the first — returns the canonical
        block id."""
        with self._lock:
            b = self._blocks[bid]
            canonical = self._cached.get(seq_hash)
            if canonical is not None:
                return canonical  # already registered (this block or a twin): no re-emit
            b.seq_hash = seq_hash
            b.parent_hash = parent_hash
            if self.enable_prefix_caching:
                self._cached[seq_hash] = bid
                if parent_hash is not None:
                    self._children[parent_hash] = self._children.get(parent_hash, 0) + 1
                self._emit(KvCacheEvent.stored([StoredBlock(seq_hash, parent_hash)]))
            return bid

    def hash_fanout(self, seq_hash: int) -> int:
        """Registered children of this hash in the radix chain."""
        with self._lock:
            return self._children.get(seq_hash, 0)

    def hash_protected(self, seq_hash: int) -> bool:
        """Should the KV tiers protect this block from churn eviction?
        True for branch points (>= 2 registered children — shared
        prefixes several continuations diverge from, e.g. a system
        prompt) and blocks multiple live sequences currently share."""
        with self._lock:
            if self._children.get(seq_hash, 0) >= 2:
                return True
            bid = self._cached.get(seq_hash)
            return bid is not None and self._blocks[bid].ref_count >= 2

    # -- release ----------------------------------------------------------

    def free_sequence(self, block_ids: list[int]) -> None:
        with self._lock:
            for bid in block_ids:
                self._unref(bid)

    def snapshot(self) -> list[tuple[int, int | None]]:
        """All currently-registered (hash, parent_hash) pairs in original
        registration order (parents before children — dict insertion
        order). Used to seed a new KV-event subscriber. Thread-safe: may
        be called from the asyncio loop while the engine thread mutates."""
        with self._lock:
            return [(h, self._blocks[bid].parent_hash) for h, bid in self._cached.items()]

    def clear(self) -> int:
        """Drop every cached (ref 0) block — admin /clear_kv_blocks path
        (reference: lib/llm/src/http/service/clear_kv_blocks.rs). Emits a
        `removed` event for exactly the hashes dropped: blocks still
        referenced by running sequences stay registered, so a blanket
        `cleared` would desync remote radix indexers. → count dropped."""
        with self._lock:
            dropped: list[int] = []
            for bid in list(self._lru):
                self._lru.pop(bid)
                b = self._blocks[bid]
                if b.seq_hash is not None:
                    self._cached.pop(b.seq_hash, None)
                    dropped.append(b.seq_hash)
                    self._drop_child(b.parent_hash)
                    b.seq_hash = None
                    b.parent_hash = None
                self._free.append(bid)
            if dropped:
                self._emit(KvCacheEvent.removed(dropped))
            return len(dropped)
