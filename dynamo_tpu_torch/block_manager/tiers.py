"""KV cache tiers beyond HBM: G2 host RAM, G3 local disk, G4 fleet pool.

Reference analogue: the KVBM tier stack G1 device / G2 pinned host / G3
disk with offload + onboard (reference: lib/llm/src/block_manager.rs:
68-81, block_manager/offload.rs:16-46). TPU redesign: blocks are
identified by their chained sequence hash (tokens.py semantics), pages
move HBM↔host with the engine's DMA primitives (engine/kv_transfer.py),
and offload is *write-through with batching* — sealed blocks are copied
host-side once per scheduler step in one batched extract — rather than
the reference's eviction-time write-back, because a TPU cache donation
invalidates old device buffers and eviction happens mid-allocation where
a synchronous extract would serialize admission.

Lookup path on prefix miss in G1: G2 dict hit → pages; G2 miss → G3 file
hit → pages (promoted back into G2). Both tiers are hash-keyed and
thread-safe; eviction is **frequency/fan-out-aware LRU** (second-chance):
plain LRU let one burst of one-off prompts flush the hot shared
system-prefix blocks that chat/agentic traffic re-hits constantly. Each
entry carries a small credit — seeded by the caller's ``protected`` hint
(the radix tree knows which hashes have high prefix fan-out or live
sharers) and topped up on every hit, decayed on every spared scan — and
the evictor skips positive-credit entries (re-queueing them MRU, counted
in ``protected_evictions``) until it finds a cold one. Credits age, so a
protected block that stops earning hits still leaves eventually; scans
are bounded, so eviction stays O(spares) and always terminates.

G4 (:class:`FleetBlockPool`) extends the stack across engines: a
directory shared by EVERY worker on the host/filestore (Mooncake's
cluster KV pool shape, 2407.00079). Blocks are keyed by the same salted
sequence-hash chain, so two engines that computed the same prefix write
the same file name — the second write is a dedup no-op, counted, never
re-encoded. G3 eviction SPILLS into G4 by file rename (os.replace:
atomic, zero-copy on one filesystem) instead of deleting, so a block
ages down the whole ladder before the fleet truly forgets it.

Tier residency events: ``TierStack.set_event_sink(cb)`` attaches
``cb(kind, tier, hashes)`` (kind ``stored``/``removed``, tier 2/3/4) to
every pool — the feed the fleet prefix directory
(fleet/directory.py) publishes so routers know who holds what, how warm.
Callbacks fire OUTSIDE the pool locks.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

# Credit seeded by a `protected` put (radix fan-out / live sharers) and
# the cap hits can accumulate to. Spared scans decay credit by 1, so a
# protected-but-cold block survives at most PROTECT_CREDIT burst waves.
PROTECT_CREDIT = 2
MAX_CREDIT = 8


def _credit_seed(credit: dict[int, int], h: int, protected: bool) -> None:
    if protected:
        credit[h] = max(credit.get(h, 0), PROTECT_CREDIT)


def _credit_touch(credit: dict[int, int], h: int) -> None:
    credit[h] = min(credit.get(h, 0) + 1, MAX_CREDIT)


def _second_chance_pop(order, credit: dict[int, int]):
    """Pop the eviction victim from an LRU-ordered dict: the oldest
    ZERO-credit entry within a bounded scan; positive-credit entries are
    spared (credit decayed by 1, re-queued MRU). Falls back to plain
    oldest when everything is warm — the bound keeps eviction
    O(spares), never a livelock. The ONE policy both tiers share.
    → (hash, value, spared_count)."""
    scans = 0
    limit = len(order)
    while scans < limit:
        h, v = order.popitem(last=False)
        c = credit.get(h, 0)
        if c <= 0:
            credit.pop(h, None)
            return h, v, scans
        credit[h] = c - 1
        order[h] = v  # re-queue MRU (second chance)
        scans += 1
    h, v = order.popitem(last=False)
    credit.pop(h, None)
    return h, v, scans


def _dtype_name(a: np.ndarray) -> str:
    """A page array's dtype name in a tier file: host bf16 pages are uint16
    bit patterns (engine/kv_transfer.py; no cache stores uint16), named
    "bfloat16" as the JAX package names them."""
    return "bfloat16" if a.dtype == np.uint16 else str(a.dtype)


def _write_npz(path: str, pages: tuple) -> None:
    """Encode one page tuple to ``path`` atomically (tmp + rename).
    KV page tuples keep the legacy k/v(+scales) layout so a persistent
    ``--disk-kv-dir`` (or a shared ``--fleet-kv-dir``) stays readable
    across versions; general object tuples ride positional arrays.
    bf16 pages are stored as uint16 members under the dtype name
    "bfloat16", the JAX package's encoding, so either package reads the
    other's files."""
    if len(pages) in (2, 4):
        k, v = pages[0], pages[1]
        extra = {}
        if len(pages) == 4:  # int8 pages carry fp32 scale sidecars
            extra = {"k_scale": pages[2], "v_scale": pages[3]}
        payload = {"k": k, "v": v, "dtype": np.bytes_(_dtype_name(k)), **extra}
    else:
        # General object tuples (LoRA adapter pages and any future
        # paged object): positional arrays + per-array dtype names.
        payload = {"n": np.int64(len(pages))}
        for i, a in enumerate(pages):
            payload[f"d{i}"] = np.bytes_(_dtype_name(a))
            payload[f"p{i}"] = a
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def _read_npz(path: str) -> tuple | None:
    """Decode one page tuple from ``path``; None on any corruption/race
    (a shared fleet dir can lose a file to a peer's eviction mid-read).
    bf16 members come back as the uint16 bit patterns they are stored as."""
    try:
        with np.load(path) as z:
            if "n" in z.files:  # general object tuple
                return tuple(z[f"p{i}"] for i in range(int(z["n"])))
            scales = (z["k_scale"], z["v_scale"]) if "k_scale" in z.files else ()
            return (z["k"], z["v"], *scales)
    except (OSError, KeyError, ValueError):
        return None


class HostBlockPool:
    """G2: host-RAM pages keyed by sequence hash, credit-aware-LRU
    bounded (module header).

    A "page" is the tuple of per-block arrays the engine extracts:
    ``(k, v)`` for full-precision caches, ``(k, v, k_scale, v_scale)``
    for int8 KV — the pools are format-agnostic, so the same
    ``capacity_blocks`` budget holds ~2x the tokens under int8."""

    def __init__(self, capacity_blocks: int, spill=None):
        self.capacity = capacity_blocks
        self._pages: OrderedDict[int, tuple[np.ndarray, ...]] = OrderedDict()
        self._credit: dict[int, int] = {}
        # Weighted capacity: entries default to 1 unit (KV blocks), but
        # larger paged objects (LoRA adapters, TierStack.put_object)
        # charge their byte-honest block-equivalent so the blocks-
        # denominated budget stays a byte budget.
        self._weights: dict[int, int] = {}
        self._units = 0
        self._lock = threading.Lock()
        self._spill = spill  # callable(hash, *pages) — e.g. DiskBlockPool.put
        self.hits = 0
        self.misses = 0
        self.protected_evictions = 0  # eviction scans that spared an entry
        # Tier residency feed (module header): callable(kind, tier, hashes),
        # fired outside the lock. TierStack.set_event_sink wires it.
        self.event_sink = None
        self.tier_no = 2

    def _emit(self, kind: str, hashes: list[int]) -> None:
        if self.event_sink is not None and hashes:
            self.event_sink(kind, self.tier_no, hashes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pages)

    def put(self, seq_hash: int, *pages: np.ndarray, protected: bool = False,
            weight: int = 1) -> None:
        spilled = []
        stored = False
        # Own the storage: callers pass views into shared batch buffers
        # (engine extracts up to 64 blocks per DMA and slices per block);
        # retaining a view would pin the whole batch buffer and break the
        # capacity accounting.
        pages = tuple(a.copy() if a.base is not None else a for a in pages)
        with self._lock:
            if seq_hash in self._pages:
                self._pages.move_to_end(seq_hash)
                _credit_seed(self._credit, seq_hash, protected)
                return
            self._pages[seq_hash] = pages
            self._weights[seq_hash] = max(1, int(weight))
            self._units += self._weights[seq_hash]
            _credit_seed(self._credit, seq_hash, protected)
            stored = True
            while self._units > self.capacity and self._pages:
                h, pgs, spared = _second_chance_pop(self._pages, self._credit)
                w = self._weights.pop(h, 1)
                self._units -= w
                self.protected_evictions += spared
                spilled.append((h, pgs, w))
        if stored:
            self._emit("stored", [seq_hash])
        self._emit("removed", [h for h, _, _ in spilled])
        for h, pgs, w in spilled:
            if self._spill is None:
                continue
            if w > 1:  # weight kwarg only when it matters: custom spill
                self._spill(h, *pgs, weight=w)  # sinks predate the kwarg
            else:
                self._spill(h, *pgs)

    def get(self, seq_hash: int) -> tuple[np.ndarray, ...] | None:
        with self._lock:
            pages = self._pages.get(seq_hash)
            if pages is not None:
                self._pages.move_to_end(seq_hash)
                _credit_touch(self._credit, seq_hash)
                self.hits += 1
                return pages
        self.misses += 1
        return None

    def contains(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._pages

    def clear(self) -> int:
        with self._lock:
            dropped = list(self._pages)
            self._pages.clear()
            self._credit.clear()
            self._weights.clear()
            self._units = 0
        self._emit("removed", dropped)
        return len(dropped)


class DiskBlockPool:
    """G3: one file per block hash under a directory, LRU by mtime order
    (tracked in-process; files from a previous process are adopted)."""

    def __init__(self, directory: str, capacity_blocks: int):
        self.dir = directory
        self.capacity = capacity_blocks
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._order: OrderedDict[int, None] = OrderedDict()
        self._credit: dict[int, int] = {}
        # Weighted capacity (same contract as HostBlockPool); adopted
        # files from a previous process count 1 unit — close enough for
        # a cache, and exact again once they are re-put.
        self._weights: dict[int, int] = {}
        self._units = 0
        for fname in sorted(
            os.listdir(directory),
            key=lambda f: os.path.getmtime(os.path.join(directory, f)),
        ):
            if fname.endswith(".npz"):
                try:
                    self._order[int(fname[:-4])] = None
                    self._units += 1
                except ValueError:
                    pass
        self.hits = 0
        self.misses = 0
        self.protected_evictions = 0  # eviction scans that spared an entry
        # G3→G4 spill hook: callable(hash, path) → bool (True = the file
        # was adopted/deduped by the fleet tier; False = delete locally).
        self._spill = None
        self.event_sink = None  # module header: callable(kind, tier, hashes)
        self.tier_no = 3

    def _emit(self, kind: str, hashes: list[int]) -> None:
        if self.event_sink is not None and hashes:
            self.event_sink(kind, self.tier_no, hashes)

    def _path(self, seq_hash: int) -> str:
        return os.path.join(self.dir, f"{seq_hash}.npz")

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)

    def put(self, seq_hash: int, *pages: np.ndarray, protected: bool = False,
            weight: int = 1) -> None:
        evict: list[int] = []
        with self._lock:
            if seq_hash in self._order:
                self._order.move_to_end(seq_hash)
                _credit_seed(self._credit, seq_hash, protected)
                return
            self._order[seq_hash] = None
            self._weights[seq_hash] = max(1, int(weight))
            self._units += self._weights[seq_hash]
            _credit_seed(self._credit, seq_hash, protected)
            while self._units > self.capacity and self._order:
                h, _, spared = _second_chance_pop(self._order, self._credit)
                self._units -= self._weights.pop(h, 1)
                self.protected_evictions += spared
                evict.append(h)
        _write_npz(self._path(seq_hash), pages)
        self._emit("stored", [seq_hash])
        for h in evict:
            # Eviction ages a block DOWN the ladder when a fleet tier is
            # wired: rename into the shared pool (or dedup against a
            # peer's identical copy) instead of deleting.
            if self._spill is not None and self._spill(h, self._path(h)):
                continue
            try:
                os.remove(self._path(h))
            except OSError:
                pass
        self._emit("removed", evict)

    def get(self, seq_hash: int) -> tuple[np.ndarray, ...] | None:
        out = _read_npz(self._path(seq_hash))
        if out is None:
            self.misses += 1
            return None
        with self._lock:
            if seq_hash in self._order:
                self._order.move_to_end(seq_hash)
                _credit_touch(self._credit, seq_hash)
        self.hits += 1
        return out

    def contains(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._order

    def clear(self) -> int:
        with self._lock:
            hashes = list(self._order)
            self._order.clear()
            self._credit.clear()
            self._weights.clear()
            self._units = 0
        for h in hashes:
            try:
                os.remove(self._path(h))
            except OSError:
                pass
        self._emit("removed", hashes)
        return len(hashes)


class FleetBlockPool:
    """G4: a fleet-SHARED block pool on a common directory (NFS mount,
    tmpfs on a multi-engine host, or any mounted object store) — the
    module-header cluster-commodity tier.

    Same one-file-per-hash npz layout as :class:`DiskBlockPool`, so a
    ``--disk-kv-dir`` can be promoted to a fleet dir without migration.
    Because the chained block hash encodes the whole salted prefix, any
    two engines producing the same file name produced the same bytes:
    ``put`` of an existing hash is a **dedup** (counted, skipped), never
    a rewrite. Capacity is enforced by oldest-mtime eviction over the
    SHARED directory — each writer prunes past the cap, so the pool
    stays bounded no matter how many engines feed it; a reader losing a
    race with a peer's eviction just misses (the caller recomputes).
    No in-process LRU/credit state: the filesystem IS the shared truth."""

    def __init__(self, directory: str, capacity_blocks: int):
        self.dir = directory
        self.capacity = capacity_blocks
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.dedup_blocks = 0   # puts/adoptions skipped: a peer already wrote the hash
        self.evictions = 0      # files pruned by the capacity sweep
        self.event_sink = None  # module header: callable(kind, tier, hashes)
        self.tier_no = 4

    def _emit(self, kind: str, hashes: list[int]) -> None:
        if self.event_sink is not None and hashes:
            self.event_sink(kind, self.tier_no, hashes)

    def _path(self, seq_hash: int) -> str:
        return os.path.join(self.dir, f"{seq_hash}.npz")

    def __len__(self) -> int:
        return sum(1 for f in os.listdir(self.dir) if f.endswith(".npz"))

    def contains(self, seq_hash: int) -> bool:
        # Existence probe against the SHARED dir: sees peers' writes too.
        return os.path.exists(self._path(seq_hash))

    def put(self, seq_hash: int, *pages: np.ndarray, protected: bool = False,
            weight: int = 1) -> None:
        if self.contains(seq_hash):
            with self._lock:
                self.dedup_blocks += 1
            return
        _write_npz(self._path(seq_hash), pages)
        self._emit("stored", [seq_hash])
        self._sweep()

    def adopt_file(self, seq_hash: int, src_path: str) -> bool:
        """G3 spill entry: move an evicted npz into the fleet pool by
        rename (zero-copy). → True (the source file is consumed either
        way: renamed in, or removed as a dedup against a peer's copy)."""
        dst = self._path(seq_hash)
        if os.path.exists(dst):
            with self._lock:
                self.dedup_blocks += 1
            try:
                os.remove(src_path)
            except OSError:
                pass
            return True
        try:
            os.replace(src_path, dst)
        except OSError:
            return False  # cross-device rename refused: fall back to delete
        self._emit("stored", [seq_hash])
        self._sweep()
        return True

    def get(self, seq_hash: int) -> tuple[np.ndarray, ...] | None:
        out = _read_npz(self._path(seq_hash))
        if out is None:
            self.misses += 1
            return None
        self.hits += 1
        return out

    def _sweep(self) -> None:
        """Prune oldest-mtime files past capacity. Races with peers are
        benign: a double-remove is an ignored OSError, and over-pruning
        by one writer just leaves headroom for the next."""
        try:
            files = [
                f for f in os.listdir(self.dir) if f.endswith(".npz")
            ]
            if len(files) <= self.capacity:
                return
            files.sort(key=lambda f: os.path.getmtime(os.path.join(self.dir, f)))
            victims = files[: len(files) - self.capacity]
        except OSError:
            return
        removed: list[int] = []
        for f in victims:
            try:
                os.remove(os.path.join(self.dir, f))
                removed.append(int(f[:-4]))
            except (OSError, ValueError):
                pass
        with self._lock:
            self.evictions += len(removed)
        self._emit("removed", removed)

    def clear(self) -> int:
        hashes = []
        for f in list(os.listdir(self.dir)):
            if f.endswith(".npz"):
                try:
                    os.remove(os.path.join(self.dir, f))
                    hashes.append(int(f[:-4]))
                except (OSError, ValueError):
                    pass
        self._emit("removed", hashes)
        return len(hashes)


class TierStack:
    """G2(+G3+G4) lookup/offload facade the engine talks to.

    - ``offload(pairs)``: write-through sealed blocks (bounded per call —
      the offload queue analogue of the reference's OffloadManager
      priority queues; overflow is dropped, it is only a cache).
    - ``lookup_run(hashes)``: longest consecutive run of leading hashes
      available across tiers → list of (k, v) pages, promoting G3/G4 hits
      into G2.

    Spill chain: G2 eviction → G3 ``put`` (re-serialize); G3 eviction →
    G4 ``adopt_file`` (zero-copy rename into the shared pool). With no
    G3, G2 spills straight to G4. A G4 hit found by a PEER engine that
    never produced the block is the cross-engine dedup payoff.
    """

    MAX_OFFLOAD_PER_STEP = 64

    def __init__(self, host: HostBlockPool | None, disk: DiskBlockPool | None,
                 fleet: "FleetBlockPool | None" = None,
                 unit_bytes: int | None = None):
        self.host = host
        self.disk = disk
        self.fleet = fleet
        # Bytes one capacity unit represents (the engine passes its
        # kv_bytes_per_block): NON-KV paged objects charge the pools
        # ceil(bytes/unit) so the blocks-denominated budget stays a byte
        # budget. None → every object costs 1 unit (legacy behavior).
        self.unit_bytes = unit_bytes
        if host is not None and disk is not None:
            host._spill = disk.put
        elif host is not None and fleet is not None:
            host._spill = fleet.put
        if disk is not None and fleet is not None:
            disk._spill = fleet.adopt_file
        self.offloaded_blocks = 0
        self.onboarded_blocks = 0

    def set_event_sink(self, cb) -> None:
        """Attach one ``cb(kind, tier, hashes)`` residency sink across all
        tiers (module header) — the fleet directory publisher's feed."""
        for pool in (self.host, self.disk, self.fleet):
            if pool is not None:
                pool.event_sink = cb

    def _object_weight(self, pages: tuple) -> int:
        if not self.unit_bytes:
            return 1
        nbytes = sum(int(np.asarray(p).nbytes) for p in pages)
        return max(1, -(-nbytes // self.unit_bytes))

    @property
    def enabled(self) -> bool:
        return (self.host is not None or self.disk is not None
                or self.fleet is not None)

    def offload(self, pairs: list[tuple],
                protected: list[bool] | None = None) -> int:
        """pairs: (seq_hash, *page_arrays) — (hash, k, v) for dense
        caches, (hash, k, v, k_scale, v_scale) for int8. ``protected``
        (parallel to pairs) marks blocks the radix tree knows are hot —
        high prefix fan-out or multiple live sharers — so a burst of
        one-off prompts cannot flush them (second-chance eviction,
        module header). → number offloaded."""
        n = 0
        for i, (seq_hash, *pages) in enumerate(pairs[: self.MAX_OFFLOAD_PER_STEP]):
            prot = bool(protected[i]) if protected is not None else False
            if self.host is not None:
                self.host.put(seq_hash, *pages, protected=prot)
            elif self.disk is not None:
                self.disk.put(seq_hash, *pages, protected=prot)
            elif self.fleet is not None:
                self.fleet.put(seq_hash, *pages, protected=prot)
            n += 1
        self.offloaded_blocks += n
        return n

    @property
    def protected_evictions(self) -> int:
        """Eviction scans (both tiers) that spared a protected/warm
        block and evicted a colder one instead — the
        tier_protected_evictions_total feed."""
        n = 0
        if self.host is not None:
            n += self.host.protected_evictions
        if self.disk is not None:
            n += self.disk.protected_evictions
        return n

    @property
    def hit_rate(self) -> float:
        """Cumulative lookup hit rate across both tiers (0.0 when the
        stack is disabled or untouched)."""
        hits = misses = 0
        if self.host is not None:
            hits += self.host.hits
            misses += self.host.misses
        if self.disk is not None:
            hits += self.disk.hits
            misses += self.disk.misses
        if self.fleet is not None:
            hits += self.fleet.hits
            misses += self.fleet.misses
        total = hits + misses
        return hits / total if total else 0.0

    def put_object(self, obj_hash: int, *pages: np.ndarray,
                   protected: bool = False) -> None:
        """Write one NON-KV paged object (e.g. a LoRA adapter's packed
        factors, engine/lora.py) through the tier stack under a synthetic
        hash. It lands in the same pools as KV blocks and competes under
        the same second-chance credits — S-LoRA's unified paging: a burst
        of one-off prompts and a burst of cold tenants press on ONE
        budget — charging its byte-honest block-equivalent weight."""
        w = self._object_weight(pages)
        if self.host is not None:
            self.host.put(obj_hash, *pages, protected=protected, weight=w)
        elif self.disk is not None:
            self.disk.put(obj_hash, *pages, protected=protected, weight=w)
        elif self.fleet is not None:
            self.fleet.put(obj_hash, *pages, protected=protected, weight=w)

    def get_object(self, obj_hash: int) -> tuple[np.ndarray, ...] | None:
        """Fetch one paged object, promoting a G3/G4 hit back into G2
        (same policy as lookup_run). Hit/miss counts feed tier_hit_rate.
        A G4 hit may have been written by a PEER engine — adapter tier
        objects dedup fleet-wide under their synthetic hashes."""
        pages = self.host.get(obj_hash) if self.host is not None else None
        if pages is None and self.disk is not None:
            pages = self.disk.get(obj_hash)
        if pages is None and self.fleet is not None:
            pages = self.fleet.get(obj_hash)
        if pages is not None and self.host is not None and \
                not self.host.contains(obj_hash):
            self.host.put(obj_hash, *pages, weight=self._object_weight(pages))
        return pages

    def peek_run_len(self, hashes: list[int]) -> int:
        """Length of the leading run resident in ANY tier — no page copies,
        no G3→G2 promotion (cheap existence probe for llm/peer_kv.py)."""
        n = 0
        for h in hashes:
            if not (
                (self.host is not None and self.host.contains(h))
                or (self.disk is not None and self.disk.contains(h))
                or (self.fleet is not None and self.fleet.contains(h))
            ):
                break
            n += 1
        return n

    def lookup_run(self, hashes: list[int]) -> list[tuple[np.ndarray, ...]]:
        out: list[tuple[np.ndarray, ...]] = []
        for h in hashes:
            pages = self.host.get(h) if self.host is not None else None
            promoted = False
            if pages is None and self.disk is not None:
                pages = self.disk.get(h)
                promoted = pages is not None
            if pages is None and self.fleet is not None:
                pages = self.fleet.get(h)
                promoted = pages is not None
            if pages is None:
                break
            if promoted and self.host is not None:
                self.host.put(h, *pages)
            out.append(pages)
        self.onboarded_blocks += len(out)
        return out

    def read_run(self, hashes: list[int]) -> list[tuple[np.ndarray, ...]]:
        """Non-promoting ``lookup_run``: G3 hits are NOT copied into G2 and
        the onboard counter is untouched. For serving a PEER's fetch
        (llm/peer_kv.py) — exporting a block must not evict this worker's
        own hot pages or masquerade as a local onboard."""
        out: list[tuple[np.ndarray, ...]] = []
        for h in hashes:
            pages = self.host.get(h) if self.host is not None else None
            if pages is None and self.disk is not None:
                pages = self.disk.get(h)
            if pages is None and self.fleet is not None:
                pages = self.fleet.get(h)
            if pages is None:
                break
            out.append(pages)
        return out

    def stats(self) -> dict:
        return {
            "g2_blocks": len(self.host) if self.host else 0,
            "g2_hits": self.host.hits if self.host else 0,
            "g3_blocks": len(self.disk) if self.disk else 0,
            "g3_hits": self.disk.hits if self.disk else 0,
            "g4_blocks": len(self.fleet) if self.fleet else 0,
            "g4_hits": self.fleet.hits if self.fleet else 0,
            "g4_dedup_blocks": self.fleet.dedup_blocks if self.fleet else 0,
            "g4_evictions": self.fleet.evictions if self.fleet else 0,
            "offloaded_blocks": self.offloaded_blocks,
            "onboarded_blocks": self.onboarded_blocks,
            "protected_evictions": self.protected_evictions,
            "hit_rate": round(self.hit_rate, 4),
        }
