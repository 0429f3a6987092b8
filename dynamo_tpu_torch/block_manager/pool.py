"""Device block pool: allocation, ref-counting, prefix reuse, LRU eviction,
KV event emission (port of ``dynamo_tpu/block_manager/pool.py``).

States:

- **free**: on the free list, contents meaningless.
- **active**: ref_count > 0, owned by at least one live sequence. A block
  becomes *registered* (hash known, event emitted) once its tokens'
  KV is fully written; shared prefix blocks have ref_count > 1.
- **cached**: ref_count == 0 but registered — kept for prefix hits,
  evictable LRU-first.

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
    __slots__ = ("block_id", "ref_count", "seq_hash")

    def __init__(self, block_id: int):
        self.block_id = block_id
        self.ref_count = 0
        self.seq_hash: int | None = None


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
        self._event_sink = event_sink
        self._event_id = 0
        # The engine thread mutates; other threads read capacity — every
        # public method takes this lock.
        self._lock = threading.RLock()
        self.hit_blocks = 0
        self.miss_blocks = 0

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

    # -- allocation -------------------------------------------------------

    def match_prefix(self, seq_hashes: list[int]) -> list[int]:
        """Longest run of leading hashes present in the cache → block ids."""
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
        block hashes are ``seq_hashes``, reusing cached prefix blocks.
        → (block_ids, num_hit_blocks). Raises NoFreeBlocksError (nothing
        allocated) if the pool can't satisfy the request."""
        with self._lock:
            hits = self.match_prefix(seq_hashes)
            need_new = total_blocks - len(hits)
            in_lru = sum(1 for b in hits if b in self._lru)
            if need_new > len(self._free) + len(self._lru) - in_lru:
                raise NoFreeBlocksError(f"need {need_new}, have {self.num_free}")
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
        return bid

    def _evict(self, bid: int) -> None:
        b = self._blocks[bid]
        if b.seq_hash is not None:
            self._cached.pop(b.seq_hash, None)
            self._emit(KvCacheEvent.removed([b.seq_hash]))
            b.seq_hash = None

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
        ``stored`` event. An identical registered block (same hash) keeps
        the canonical cache entry; → the canonical block id."""
        with self._lock:
            canonical = self._cached.get(seq_hash)
            if canonical is not None:
                return canonical
            self._blocks[bid].seq_hash = seq_hash
            if self.enable_prefix_caching:
                self._cached[seq_hash] = bid
                self._emit(KvCacheEvent.stored([StoredBlock(seq_hash, parent_hash)]))
            return bid

    # -- release ----------------------------------------------------------

    def free_sequence(self, block_ids: list[int]) -> None:
        with self._lock:
            for bid in block_ids:
                self._unref(bid)

    def clear(self) -> int:
        """Drop every cached (ref 0) block — the admin clear-KV path.
        Blocks still referenced by running sequences stay registered.
        Emits one ``removed`` event for the dropped hashes; → count."""
        with self._lock:
            dropped: list[int] = []
            for bid in list(self._lru):
                self._lru.pop(bid)
                b = self._blocks[bid]
                if b.seq_hash is not None:
                    self._cached.pop(b.seq_hash, None)
                    dropped.append(b.seq_hash)
                    b.seq_hash = None
                self._free.append(bid)
            if dropped:
                self._emit(KvCacheEvent.removed(dropped))
            return len(dropped)
