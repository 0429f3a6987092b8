"""KV cache events (port of the part of ``dynamo_tpu/kv_router/protocols.py``
the block pool emits): plain dicts on the wire, same schema."""

from __future__ import annotations

from dataclasses import dataclass, field

STORED = "stored"
REMOVED = "removed"


@dataclass
class StoredBlock:
    block_hash: int          # chained sequence hash (tokens.py semantics)
    parent_hash: int | None  # parent sequence hash (None = root block)

    def to_dict(self) -> dict:
        return {"block_hash": self.block_hash, "parent_hash": self.parent_hash}


@dataclass
class KvCacheEvent:
    """One cache mutation on one worker. ``event_id`` is a per-worker
    monotonic sequence number so an indexer can detect gaps."""

    kind: str                                    # stored | removed
    event_id: int = 0
    blocks: list[StoredBlock] = field(default_factory=list)   # for stored
    block_hashes: list[int] = field(default_factory=list)     # for removed

    @classmethod
    def stored(cls, blocks: list[StoredBlock]) -> "KvCacheEvent":
        return cls(kind=STORED, blocks=blocks)

    @classmethod
    def removed(cls, hashes: list[int]) -> "KvCacheEvent":
        return cls(kind=REMOVED, block_hashes=hashes)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "event_id": self.event_id,
            "blocks": [b.to_dict() for b in self.blocks],
            "block_hashes": list(self.block_hashes),
        }
