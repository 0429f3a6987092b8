"""KV router wire protocols: cache events + worker metrics.

Reference analogue: lib/llm/src/kv_router/protocols.rs:43-180
(``KvCacheEvent{Stored,Removed,Cleared}``, ``ForwardPassMetrics``
{WorkerStats, KvStats}) — msgpack dicts on the wire here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Event types
STORED = "stored"
REMOVED = "removed"
CLEARED = "cleared"


@dataclass
class StoredBlock:
    block_hash: int          # chained sequence hash (tokens.py semantics)
    parent_hash: int | None  # parent sequence hash (None = root block)

    def to_dict(self) -> dict:
        return {"block_hash": self.block_hash, "parent_hash": self.parent_hash}

    @classmethod
    def from_dict(cls, d: dict) -> "StoredBlock":
        return cls(block_hash=int(d["block_hash"]), parent_hash=d.get("parent_hash"))


@dataclass
class KvCacheEvent:
    """One cache mutation on one worker. ``event_id`` is a per-worker
    monotonic sequence number so the indexer can detect gaps."""

    kind: str                                    # stored | removed | cleared
    event_id: int = 0
    blocks: list[StoredBlock] = field(default_factory=list)   # for stored
    block_hashes: list[int] = field(default_factory=list)     # for removed

    @classmethod
    def stored(cls, blocks: list[StoredBlock], event_id: int = 0) -> "KvCacheEvent":
        return cls(kind=STORED, event_id=event_id, blocks=blocks)

    @classmethod
    def removed(cls, hashes: list[int], event_id: int = 0) -> "KvCacheEvent":
        return cls(kind=REMOVED, event_id=event_id, block_hashes=hashes)

    @classmethod
    def cleared(cls, event_id: int = 0) -> "KvCacheEvent":
        return cls(kind=CLEARED, event_id=event_id)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "event_id": self.event_id,
            "blocks": [b.to_dict() for b in self.blocks],
            "block_hashes": list(self.block_hashes),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "KvCacheEvent":
        return cls(
            kind=d["kind"],
            event_id=int(d.get("event_id", 0)),
            blocks=[StoredBlock.from_dict(b) for b in d.get("blocks") or []],
            block_hashes=[int(h) for h in d.get("block_hashes") or []],
        )


@dataclass
class WorkerStats:
    request_active_slots: int = 0
    request_total_slots: int = 0
    num_requests_waiting: int = 0

    def to_dict(self) -> dict:
        return {
            "request_active_slots": self.request_active_slots,
            "request_total_slots": self.request_total_slots,
            "num_requests_waiting": self.num_requests_waiting,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkerStats":
        return cls(
            request_active_slots=int(d.get("request_active_slots", 0)),
            request_total_slots=int(d.get("request_total_slots", 0)),
            num_requests_waiting=int(d.get("num_requests_waiting", 0)),
        )


@dataclass
class KvStats:
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    gpu_cache_usage_perc: float = 0.0      # name kept for dashboard parity
    gpu_prefix_cache_hit_rate: float = 0.0

    def to_dict(self) -> dict:
        return {
            "kv_active_blocks": self.kv_active_blocks,
            "kv_total_blocks": self.kv_total_blocks,
            "gpu_cache_usage_perc": self.gpu_cache_usage_perc,
            "gpu_prefix_cache_hit_rate": self.gpu_prefix_cache_hit_rate,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "KvStats":
        return cls(
            kv_active_blocks=int(d.get("kv_active_blocks", 0)),
            kv_total_blocks=int(d.get("kv_total_blocks", 0)),
            gpu_cache_usage_perc=float(d.get("gpu_cache_usage_perc", 0.0)),
            gpu_prefix_cache_hit_rate=float(d.get("gpu_prefix_cache_hit_rate", 0.0)),
        )


@dataclass
class KVHitRateEvent:
    """One routing decision's prefix-hit outcome (reference:
    lib/llm/src/kv_router/scheduler.rs:107-214 emits these on NATS;
    here they flow to an injectable sink — metrics and the recorder)."""

    worker_id: int
    isl_blocks: int       # request length in blocks
    overlap_blocks: int   # prefix blocks already on the chosen worker

    @property
    def hit_rate(self) -> float:
        return self.overlap_blocks / self.isl_blocks if self.isl_blocks else 0.0

    def to_dict(self) -> dict:
        return {"worker_id": self.worker_id, "isl_blocks": self.isl_blocks,
                "overlap_blocks": self.overlap_blocks}


@dataclass
class ForwardPassMetrics:
    """Per-worker load snapshot served on the ``load_metrics`` endpoint
    (reference: kv_router/publisher.rs:481-523)."""

    worker: WorkerStats = field(default_factory=WorkerStats)
    kv: KvStats = field(default_factory=KvStats)

    def to_dict(self) -> dict:
        return {"worker": self.worker.to_dict(), "kv": self.kv.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "ForwardPassMetrics":
        return cls(
            worker=WorkerStats.from_dict(d.get("worker") or {}),
            kv=KvStats.from_dict(d.get("kv") or {}),
        )
