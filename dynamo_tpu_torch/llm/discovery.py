"""Model discovery: frontends learn which models the cluster serves.

Reference analogue: ``ModelWatcher`` watching etcd MODEL_ROOT_PATH and
adding/removing models on the ``ModelManager`` (reference: lib/llm/src/
discovery/watcher.rs:39-48, discovery/model_manager.rs:33-175).

Workers publish one model-card key per serving instance (model_card.py);
the watcher refcounts instances per (namespace, slug): first instance →
build + start a ModelPipeline; last instance gone → tear it down, so
``/v1/models`` always reflects live capacity.
"""

from __future__ import annotations

import asyncio
import contextlib

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, model_prefix, parse_model_key
from dynamo_tpu_torch.llm.pipeline import ModelPipeline, RouterSettings
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.store import EventKind

log = get_logger("model_discovery")


class ModelManager:
    """Live registry: (namespace, slug) → started ModelPipeline."""

    def __init__(self, runtime, settings: RouterSettings | None = None,
                 on_card=None):
        self.runtime = runtime
        self.settings = settings or RouterSettings()
        self._pipelines: dict[tuple[str, str], ModelPipeline] = {}
        # Called with every newly-discovered ModelDeploymentCard (after
        # its pipeline starts): the frontend hooks this to pick up
        # card-shipped config — e.g. the sla_profile the admission
        # predictor reads — via discovery instead of CLI flags.
        self._on_card = on_card

    def get(self, model_name: str) -> ModelPipeline | None:
        """Resolve a user-facing model name (exact name or slug)."""
        for pipe in self._pipelines.values():
            if pipe.card.name == model_name or pipe.card.slug == model_name:
                return pipe
        return None

    def list_names(self) -> list[str]:
        return sorted(p.card.name for p in self._pipelines.values())

    def items(self) -> list[tuple[str, "ModelPipeline"]]:
        return sorted(
            ((p.card.name, p) for p in self._pipelines.values()), key=lambda x: x[0]
        )

    async def add(self, namespace: str, card: ModelDeploymentCard) -> None:
        key = (namespace, card.slug)
        if key in self._pipelines:
            return
        pipe = ModelPipeline(namespace, card, self.runtime, self.settings)
        self._pipelines[key] = pipe
        await pipe.start()
        log.info("model added: %s (ns=%s)", card.name, namespace)
        if self._on_card is not None:
            try:
                self._on_card(card)
            except Exception:  # noqa: BLE001 — a bad hook must not block model discovery
                log.exception("on_card hook failed for %s", card.name)

    async def remove(self, namespace: str, slug: str) -> None:
        pipe = self._pipelines.pop((namespace, slug), None)
        if pipe is not None:
            await pipe.close()
            log.info("model removed: %s (ns=%s)", slug, namespace)

    async def close(self) -> None:
        for key in list(self._pipelines):
            await self.remove(*key)


class ModelWatcher:
    """Watches the store's model root and drives the ModelManager."""

    def __init__(self, runtime, manager: ModelManager, namespace: str | None = None):
        self.runtime = runtime
        self.manager = manager
        self.namespace = namespace
        self._refs: dict[tuple[str, str], set[int]] = {}
        self._watch = None
        self._task: asyncio.Task | None = None

    async def start(self) -> "ModelWatcher":
        prefix = model_prefix(self.namespace)
        self._watch = await self.runtime.store.watch_prefix(prefix)
        for entry in self._watch.snapshot:
            await self._on_put(entry.key, entry.value)
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def _loop(self) -> None:
        try:
            async for ev in self._watch:
                try:
                    if ev.kind == EventKind.PUT:
                        await self._on_put(ev.key, ev.value)
                    else:
                        await self._on_delete(ev.key)
                except Exception:  # noqa: BLE001 — one bad card must not stop the watch
                    log.exception("model watch event failed for %s", ev.key)
        except asyncio.CancelledError:
            pass

    async def _on_put(self, key: str, value: bytes) -> None:
        parsed = parse_model_key(key)
        if parsed is None:
            return
        ns, slug, lease_id = parsed
        card = ModelDeploymentCard.from_bytes(value)
        refs = self._refs.setdefault((ns, slug), set())
        refs.add(lease_id)
        await self.manager.add(ns, card)

    async def _on_delete(self, key: str) -> None:
        parsed = parse_model_key(key)
        if parsed is None:
            return
        ns, slug, lease_id = parsed
        refs = self._refs.get((ns, slug))
        if refs is None:
            return
        refs.discard(lease_id)
        if not refs:
            del self._refs[(ns, slug)]
            await self.manager.remove(ns, slug)

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
        if self._watch is not None:
            await self._watch.cancel()
