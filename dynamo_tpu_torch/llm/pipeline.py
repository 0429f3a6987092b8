"""Frontend pipeline assembly: one served model = preprocessor → router →
backend → delta generation.

Reference analogue: ``build_routed_pipeline`` — SegmentSource →
OpenAIPreprocessor → Backend → Migration → KvPushRouter/PushRouter
(reference: lib/llm/src/entrypoint/input/common.rs:183-261). Stage order
here matches: tokens go out to workers raw; detokenization + stop-string
enforcement happen frontend-side (Backend), which is also what lets the
Migration operator re-dispatch with accumulated tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, AsyncIterator

from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouterConfig
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.llm.preprocessor import DeltaGenerator, OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols import ChatCompletionRequest, CompletionRequest, EngineError
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import PushRouter, RouterMode

log = get_logger("pipeline")


@dataclass
class RouterSettings:
    mode: RouterMode = RouterMode.ROUND_ROBIN
    kv: KvRouterConfig | None = None
    # Record per-token response streams + router hit-rate events to
    # <record_dir>/<model>.jsonl (llm/recorder.py; reference: perf.rs +
    # recorder.rs replayable captures).
    record_dir: str | None = None
    # Fleet cross-process sticky routing (fleet/decisions.py): one
    # store-backed RouterDecisionCache per frontend process, scoped per
    # model for each KvPushRouter. None outside fleet mode.
    decisions: Any | None = None
    # Global prefix directory (fleet/directory.py PrefixDirectory):
    # block-hash → holders residency mirror for transfer-vs-recompute
    # routing. One per frontend process, shared across every model's
    # router (engine hashes are already adapter/model-salted).
    directory: Any | None = None
    # Fleet-series registry handles the routers should feed (the
    # fleet_kv_transfer_vs_recompute_total counter). None outside fleet
    # mode.
    fleet_metrics: Any | None = None


class _RouterEngine:
    """Adapts PushRouter (positional instance_id API) to the AsyncEngine
    shape used by pipeline operators. A migration resume leg pins its
    first dispatch to the destination instance; a pre-stream failure
    there falls back to normal placement (the resume identity rides the
    request, so any worker serves the leg byte-identically)."""

    def __init__(self, push: PushRouter):
        self.push = push

    def generate(self, request: Any, context: Context):
        pin = None
        if isinstance(request, dict):
            mr = (request.get("kv_transfer_params") or {}).get("migration_resume")
            if isinstance(mr, dict):
                pin = mr.get("instance")
        if pin is not None:
            return self._pinned(request, context, int(pin))
        return self.push.generate(request, context)

    async def _pinned(self, request: Any, context: Context, wid: int):
        from dynamo_tpu_torch.runtime.messaging import (
            NoHandlerError,
            OverloadedError,
            TruncatedStreamError,
        )
        from dynamo_tpu_torch.runtime.push_router import NoInstancesError

        stream = self.push.generate(request, context, instance_id=wid)
        first = True
        try:
            async for item in stream:
                first = False
                yield item
            return
        except (NoInstancesError, TruncatedStreamError, NoHandlerError,
                OverloadedError, ConnectionError, OSError):
            if not first:
                raise  # mid-stream death: Migration's responsibility
            log.warning("migration pin to %x failed pre-stream; re-placing", wid)
        finally:
            await stream.aclose()
        fallback = self.push.generate(request, context)
        try:
            async for item in fallback:
                yield item
        finally:
            await fallback.aclose()


class ModelPipeline:
    """Everything the frontend needs to serve one model."""

    def __init__(
        self,
        namespace: str,
        card: ModelDeploymentCard,
        runtime,
        settings: RouterSettings | None = None,
    ):
        self.namespace = namespace
        self.card = card
        self.runtime = runtime
        self.settings = settings or RouterSettings()
        self.preprocessor = OpenAIPreprocessor(card)
        self.kv_router: KvPushRouter | None = None
        self.backend: Backend | None = None
        self.discovery = None
        self._embed_router = None
        self._admin_router = None
        self._recorder = None
        if self.settings.record_dir:
            import os

            from dynamo_tpu_torch.llm.recorder import JsonlRecorder

            os.makedirs(self.settings.record_dir, exist_ok=True)
            # slug: model names may contain '/' (HF-style); same
            # sanitization discovery/store keys use.
            from dynamo_tpu_torch.llm.model_card import slugify

            self._recorder = JsonlRecorder(
                os.path.join(self.settings.record_dir, f"{slugify(card.name)}.jsonl")
            )

    async def start(self) -> "ModelPipeline":
        ep = (
            self.runtime.namespace(self.namespace)
            .component(self.card.component)
            .endpoint(self.card.endpoint)
        )
        if self.settings.mode == RouterMode.KV:
            push = await ep.router(RouterMode.DIRECT)
            kv_cfg = self.settings.kv or KvRouterConfig()
            kv_cfg.block_size = self.card.kv_cache_block_size
            decisions = (
                self.settings.decisions.scoped(self.card.slug)
                if self.settings.decisions is not None else None
            )
            fm = self.settings.fleet_metrics or {}
            reg = getattr(self.runtime, "metrics", None)
            router_m: dict | None = None
            if reg is not None:
                from dynamo_tpu_torch.kv_router.router import register_router_metrics

                # Placement hot-path series live beside the hit-rate
                # series on the frontend registry (registration dedupes
                # across models — one series set per process).
                router_m = register_router_metrics(reg.child("router"))
            if "transfer_choices" in fm:
                router_m = dict(router_m or {})
                router_m["transfer_choices"] = fm["transfer_choices"]
            self.kv_router = await KvPushRouter(
                push, kv_cfg, event_sink=self._make_hit_rate_sink(),
                decisions=decisions,
                directory=self.settings.directory,
                metrics=router_m,
            ).start()
            engine = self.kv_router
        else:
            push = await ep.router(self.settings.mode)
            engine = _RouterEngine(push)
        self.discovery = push.discovery
        if self._recorder is not None:
            from dynamo_tpu_torch.llm.recorder import RecordingEngine

            engine = RecordingEngine(engine, self._recorder)
        migration = Migration(engine, migration_limit=self.card.migration_limit)
        self.backend = Backend(migration, self.preprocessor.tokenizer)
        return self

    def _make_hit_rate_sink(self):
        """Routing-quality series on the frontend's own registry
        (reference: components/metrics/src/main.rs:20-35 aggregates these;
        deploy/metrics/dashboard.json charts them)."""
        metrics = getattr(self.runtime, "metrics", None)
        if metrics is None:
            return None
        scope = metrics.child("router")
        decisions = scope.counter("router_decisions_total", "KV routing decisions")
        isl = scope.counter("router_isl_blocks_total", "Prompt blocks routed")
        overlap = scope.counter("router_overlap_blocks_total", "Prefix blocks already on the chosen worker")
        hist = scope.histogram("router_hit_rate", "Per-request prefix hit rate")

        rec_sink = self._recorder.hit_rate_sink() if self._recorder else None

        def sink(ev) -> None:
            model = self.card.name
            decisions.inc(model=model, worker=f"{ev.worker_id:x}")
            isl.inc(ev.isl_blocks, model=model)
            overlap.inc(ev.overlap_blocks, model=model)
            hist.observe(ev.hit_rate, model=model)
            if rec_sink is not None:
                rec_sink(ev)

        return sink

    async def _aux_router(self, endpoint: str, mode: RouterMode):
        ep = (
            self.runtime.namespace(self.namespace)
            .component(self.card.component)
            .endpoint(endpoint)
        )
        return await ep.router(mode)

    async def embed(self, token_ids: list[int]) -> list[float]:
        """Route one embedding request to a worker's ``embed`` endpoint
        (reference: /v1/embeddings, http/service/openai.rs:302)."""
        if self._embed_router is None:
            self._embed_router = await self._aux_router("embed", RouterMode.ROUND_ROBIN)
        out = None
        async for item in self._embed_router.generate(
            {"token_ids": [int(t) for t in token_ids]}, Context()
        ):
            out = item
        if not out or "embedding" not in out:
            raise EngineError((out or {}).get("error", "embedding failed"))
        return out["embedding"]

    async def clear_kv_blocks(self) -> dict[str, int]:
        """Admin: clear idle KV on every worker (reference:
        http/service/clear_kv_blocks.rs). → {instance_hex: blocks}."""
        if self._admin_router is None:
            self._admin_router = await self._aux_router("clear_kv", RouterMode.DIRECT)
        results: dict[str, int] = {}
        for inst in list(self._admin_router.discovery.available()):
            try:
                async for item in self._admin_router.generate(
                    {}, Context(), instance_id=inst.instance_id
                ):
                    results[f"{inst.instance_id:x}"] = int(item.get("cleared", 0))
            except Exception as e:  # noqa: BLE001 — report partial results
                results[f"{inst.instance_id:x}"] = -1
                log.warning("clear_kv on %x failed: %s", inst.instance_id, e)
        return results

    async def close(self) -> None:
        if self.kv_router is not None:
            await self.kv_router.close()
        if self._recorder is not None:
            self._recorder.close()

    # -- request execution -------------------------------------------------

    async def run(
        self,
        req: ChatCompletionRequest | CompletionRequest,
        context: Context,
    ) -> AsyncIterator[tuple[DeltaGenerator, dict | None]]:
        """Preprocess + stream. Yields (gen, chunk) pairs: chunk is an SSE
        payload dict, or None for pure bookkeeping deltas. The caller owns
        transport concerns (SSE vs aggregate)."""
        kind = "chat" if isinstance(req, ChatCompletionRequest) else "completion"
        with tracing.start_span(
            "http.preprocess", parent=context.trace, model=self.card.name, kind=kind
        ) as pspan:
            if kind == "chat":
                pre = self.preprocessor.preprocess_chat(req)
            else:
                pre = self.preprocessor.preprocess_completion(req)
            pspan.set_attr("prompt_tokens", len(pre.token_ids))
        gen = DeltaGenerator(
            self.card.name, kind=kind, prompt_tokens=len(pre.token_ids),
            want_logprobs=pre.sampling.logprobs,
            token_text_fn=lambda tid: self.preprocessor.tokenizer.decode([tid]),
            want_tools=(
                bool(getattr(req, "tools", None))
                and getattr(req, "tool_choice", None) != "none"
            ),
            tool_names={
                t.get("function", {}).get("name")
                for t in getattr(req, "tools", []) or []
                if isinstance(t, dict)
            },
        )
        assert self.backend is not None, "pipeline not started"
        stream = self.backend.generate(pre.to_dict(), context)
        try:
            async for raw in stream:
                # Hot path on the raw Backend dict: no LLMEngineOutput
                # construction per delta, and pure text deltas render
                # straight to a preserialized SSE frame (EncodedSse).
                finish = raw.get("finish_reason")
                if finish == "error":
                    raise EngineError(raw.get("error") or "engine error")
                token_ids = raw.get("token_ids") or ()
                text = raw.get("text")
                if finish is None and raw.get("log_probs") is None:
                    if text:
                        fast = gen.encode_content_chunk(text, len(token_ids))
                        if fast is not None:
                            yield gen, fast
                            continue
                    elif token_ids and gen.note_tokens_only(len(token_ids)):
                        yield gen, None
                        continue
                chunks = gen.on_delta(text, len(token_ids), finish,
                                      token_ids=token_ids, logprobs=raw.get("log_probs"),
                                      top_logprobs=raw.get("top_log_probs"))
                if not chunks:
                    yield gen, None
                for c in chunks:
                    yield gen, c
                if finish is not None:
                    return
        finally:
            # Close the operator chain deterministically (span ends, wire
            # cancel) rather than at async-generator GC.
            await stream.aclose()
