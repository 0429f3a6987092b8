"""Adapter slot pool: the G1 (HBM) residency economy for LoRA adapters.

S-LoRA's unified-paging idea mapped onto this block manager: the device
adapter bank has a fixed number of SLOTS (engine/lora.py describes the
bank itself); which adapter occupies which slot is decided here with the
same second-chance credit policy the KV tiers use (block_manager/
tiers.py) — hits top up credit, spared eviction scans decay it, so a
recently-hot adapter survives a burst of one-off tenants but a cold one
still ages out. Adapters pinned by RUNNING sequences are never victims:
an in-flight batch row reads its slot's bank weights on every dispatch,
so eviction is only legal once the last sequence using the adapter
finished (the engine releases pins at finish/preempt; the serial device
stream orders any subsequent upload after already-dispatched windows, so
zombie rows of just-finished sequences still read the old weights).

Thread affinity: acquire/release run on the engine's scheduler thread
only (same contract as BlockPool); the integer stats are read racily by
bench/metrics like every other monotonic counter.
"""

from __future__ import annotations

from collections import OrderedDict

from dynamo_tpu_torch.block_manager.pool import NoFreeBlocksError
from dynamo_tpu_torch.block_manager.tiers import MAX_CREDIT


class NoFreeAdapterSlotsError(NoFreeBlocksError):
    """Every slot is pinned by a running sequence. Subclasses
    NoFreeBlocksError so engine admission applies its standard
    resource-pressure handling (requeue, retry when capacity frees)."""


class AdapterSlotPool:
    """Maps adapter ids to device bank slots with pinning + second-chance
    eviction. ``acquire`` → (slot, needs_upload); the caller uploads the
    adapter's weights into the slot when asked and MUST ``release`` once
    per acquire when the sequence finishes."""

    def __init__(self, num_slots: int):
        if num_slots <= 0:
            raise ValueError("num_slots must be positive")
        self.num_slots = num_slots
        self._free: list[int] = list(range(num_slots))
        self._order: OrderedDict[str, int] = OrderedDict()  # resident, LRU→MRU
        self._credit: dict[str, int] = {}
        self._pins: dict[str, int] = {}
        self._ever_evicted: set[str] = set()
        # Monotonic stats (racy cross-thread reads are fine):
        self.hits = 0          # acquires served by a resident slot
        self.pageins = 0       # uploads into a slot (cold fetch happened)
        self.evictions = 0     # resident adapters displaced for a page-in
        self.repageins = 0     # page-ins of previously-evicted adapters
        self.protected_scans = 0  # eviction scans that spared a warm entry

    @property
    def resident(self) -> int:
        return len(self._order)

    def resident_ids(self) -> list[str]:
        return list(self._order)

    def slot_of(self, adapter_id: str) -> int | None:
        return self._order.get(adapter_id)

    def _pop_victim(self) -> tuple[str, int]:
        """Oldest unpinned zero-credit resident; warm entries are spared
        (credit decayed, re-queued MRU) within one bounded scan, pinned
        entries are never eligible. Raises NoFreeAdapterSlotsError when
        everything is pinned."""
        scans = 0
        limit = len(self._order)
        while scans < limit:
            aid, slot = self._order.popitem(last=False)
            scans += 1
            if self._pins.get(aid, 0) > 0:
                self._order[aid] = slot  # pinned: re-queue, not evictable
                continue
            c = self._credit.get(aid, 0)
            if c <= 0:
                self._credit.pop(aid, None)
                return aid, slot
            self._credit[aid] = c - 1
            self._order[aid] = slot
            self.protected_scans += 1
        # Everything scanned was pinned or warm: fall back to the oldest
        # unpinned entry regardless of credit (bounded, never livelocks).
        for aid in list(self._order):
            if self._pins.get(aid, 0) == 0:
                slot = self._order.pop(aid)
                self._credit.pop(aid, None)
                return aid, slot
        raise NoFreeAdapterSlotsError(
            "every adapter slot is pinned by a running sequence"
        )

    def acquire(self, adapter_id: str) -> tuple[int, bool, str | None]:
        """Pin ``adapter_id`` into a slot → (slot, needs_upload,
        evicted_adapter_id). ``needs_upload`` means the caller must write
        the adapter's weights into the slot before dispatching rows that
        reference it."""
        slot = self._order.get(adapter_id)
        if slot is not None:
            self._order.move_to_end(adapter_id)
            self._credit[adapter_id] = min(
                self._credit.get(adapter_id, 0) + 1, MAX_CREDIT
            )
            self._pins[adapter_id] = self._pins.get(adapter_id, 0) + 1
            self.hits += 1
            return slot, False, None
        evicted: str | None = None
        if self._free:
            slot = self._free.pop()
        else:
            evicted, slot = self._pop_victim()
            self._ever_evicted.add(evicted)
            self.evictions += 1
        self._order[adapter_id] = slot
        # Credit is EARNED by hits (same policy as the KV tiers): a fresh
        # page-in starts cold, so one-shot tenants age out first.
        self._pins[adapter_id] = self._pins.get(adapter_id, 0) + 1
        self.pageins += 1
        if adapter_id in self._ever_evicted:
            self.repageins += 1
        return slot, True, evicted

    def release(self, adapter_id: str) -> None:
        """Drop one pin (sequence finished/preempted). The adapter stays
        resident — only eviction pressure removes it."""
        n = self._pins.get(adapter_id, 0)
        if n <= 1:
            self._pins.pop(adapter_id, None)
        else:
            self._pins[adapter_id] = n - 1

    def drop(self, adapter_id: str) -> None:
        """Remove a resident entry outright, returning its slot to the
        free list. The FAILED-UPLOAD unwind: acquire() marks residency
        before the caller uploads, so an upload that errors must not
        leave the adapter looking resident — the next acquire would skip
        the upload and rows would decode against a zero/partial bank
        slot. Only legal with no outstanding pins beyond the caller's
        own (a fresh page-in holds exactly one)."""
        slot = self._order.pop(adapter_id, None)
        self._credit.pop(adapter_id, None)
        self._pins.pop(adapter_id, None)
        if slot is not None:
            self._free.append(slot)
            self.pageins = max(0, self.pageins - 1)  # the page-in never landed

    def stats(self) -> dict:
        return {
            "resident": self.resident,
            "num_slots": self.num_slots,
            "hits": self.hits,
            "pageins": self.pageins,
            "evictions": self.evictions,
            "repageins": self.repageins,
            "protected_scans": self.protected_scans,
        }
