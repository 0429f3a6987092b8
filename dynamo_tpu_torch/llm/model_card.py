"""ModelDeploymentCard: everything a frontend needs to serve a model.

Reference analogue: lib/llm/src/model_card/model.rs:87-138 — name,
tokenizer, context length, kv block size, migration limit — published to
the control-plane store by workers and watched by frontends
(reference: lib/llm/src/discovery/watcher.rs:39-48).

Store layout: ``models/<namespace>/<slug>:<lease_hex>`` → msgpack card.
One key per serving instance; the frontend aggregates instances of the
same slug into one logical model.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

from dynamo_tpu_torch.runtime import msgpack_lite as msgpack

MODEL_ROOT = "models"

_slug_re = re.compile(r"[^a-zA-Z0-9_.-]+")


def slugify(name: str) -> str:
    return _slug_re.sub("-", name).strip("-").lower() or "model"


@dataclass
class ModelDeploymentCard:
    name: str                      # user-visible model name ("meta-llama/Llama-3.2-1B")
    tokenizer: dict[str, Any] = field(default_factory=lambda: {"type": "byte"})
    context_length: int = 8192
    kv_cache_block_size: int = 16
    migration_limit: int = 0       # max re-dispatches for an in-flight request
    chat_template: str | None = None  # jinja2 source; None → default template
    eos_token_ids: list[int] = field(default_factory=list)
    model_type: str = "chat"       # "chat" | "completions" | "embeddings"
    # Where requests for this model are served (runtime addressing).
    component: str = "backend"
    endpoint: str = "generate"
    # Engine capability hints for routers/planners:
    max_batch_size: int | None = None
    total_kv_blocks: int | None = None
    # Multi-LoRA: set on cards that publish a LoRA fine-tune of a base
    # model served by the SAME engine/endpoint —
    # {"adapter_id": str, "base": base model name, "rank": int,
    #  "resident_tier": "G1"|"G2"|"G3"}. The frontend preprocessor stamps
    # adapter_id into every request for this card; /v1/models surfaces
    # the dict so clients can tell adapters from bases. resident_tier is
    # the tier at REGISTRATION time (adapters start cold in the paged
    # tiers and page into G1 on first request); live residency is the
    # engine_lora_resident_adapters gauge.
    lora: dict[str, Any] | None = None
    # Profiled SLA latency curves (planner.interpolate.profile_as_card_dict):
    # the worker that was profiled ships its own prefill-TTFT and
    # decode-ITL samples, so frontends (admission-time TTFT prediction)
    # and the autoscaler (capacity model) pick the profile up via
    # DISCOVERY instead of a --qos-profile CLI path copied to every box.
    sla_profile: dict[str, Any] | None = None

    @property
    def slug(self) -> str:
        return slugify(self.name)

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "tokenizer": dict(self.tokenizer),
            "context_length": self.context_length,
            "kv_cache_block_size": self.kv_cache_block_size,
            "migration_limit": self.migration_limit,
            "chat_template": self.chat_template,
            "eos_token_ids": list(self.eos_token_ids),
            "model_type": self.model_type,
            "component": self.component,
            "endpoint": self.endpoint,
            "max_batch_size": self.max_batch_size,
            "total_kv_blocks": self.total_kv_blocks,
            "lora": dict(self.lora) if self.lora else None,
            "sla_profile": dict(self.sla_profile) if self.sla_profile else None,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelDeploymentCard":
        return cls(
            name=d["name"],
            tokenizer=dict(d.get("tokenizer") or {"type": "byte"}),
            context_length=int(d.get("context_length", 8192)),
            kv_cache_block_size=int(d.get("kv_cache_block_size", 16)),
            migration_limit=int(d.get("migration_limit", 0)),
            chat_template=d.get("chat_template"),
            eos_token_ids=list(d.get("eos_token_ids") or []),
            model_type=d.get("model_type", "chat"),
            component=d.get("component", "backend"),
            endpoint=d.get("endpoint", "generate"),
            max_batch_size=d.get("max_batch_size"),
            total_kv_blocks=d.get("total_kv_blocks"),
            lora=dict(d["lora"]) if d.get("lora") else None,
            sla_profile=dict(d["sla_profile"]) if d.get("sla_profile") else None,
        )

    def to_bytes(self) -> bytes:
        return msgpack.packb(self.to_dict(), use_bin_type=True)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ModelDeploymentCard":
        return cls.from_dict(msgpack.unpackb(raw, raw=False))


def model_key(namespace: str, slug: str, lease_id: int) -> str:
    return f"{MODEL_ROOT}/{namespace}/{slug}:{lease_id:x}"


def model_prefix(namespace: str | None = None) -> str:
    return f"{MODEL_ROOT}/{namespace}/" if namespace else f"{MODEL_ROOT}/"


def parse_model_key(key: str) -> tuple[str, str, int] | None:
    """→ (namespace, slug, lease_id) or None if not a model key."""
    if not key.startswith(MODEL_ROOT + "/"):
        return None
    rest = key[len(MODEL_ROOT) + 1 :]
    try:
        ns, slug_lease = rest.split("/", 1)
        slug, lease_hex = slug_lease.rsplit(":", 1)
        return ns, slug, int(lease_hex, 16)
    except ValueError:
        return None


async def register_model(runtime, namespace: str, card: ModelDeploymentCard) -> str:
    """Publish this worker's model card under its primary lease so it
    disappears automatically if the worker dies
    (reference: components/backends/vllm/src/dynamo/vllm/main.py:215-223).
    Returns the store key."""
    lease_id = await runtime.primary_lease()
    key = model_key(namespace, card.slug, lease_id)
    await runtime.store.put(key, card.to_bytes(), lease_id=lease_id)
    return key
