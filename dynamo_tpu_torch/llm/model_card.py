"""ModelDeploymentCard: what a frontend needs to serve a model (port of
``dynamo_tpu/llm/model_card.py`` without the control-plane store, whose
msgpack serialisation comes with the distributed slice)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelDeploymentCard:
    name: str                      # user-visible model name
    tokenizer: dict[str, Any] = field(default_factory=lambda: {"type": "byte"})
    context_length: int = 8192
    kv_cache_block_size: int = 16
    eos_token_ids: list[int] = field(default_factory=list)
