"""OpenAI-compatible HTTP ingress.

Reference analogue: the axum HTTP service (reference: lib/llm/src/http/
service/openai.rs:358 — /v1/chat/completions, :166 /v1/completions, :855
/v1/models; service_v2.rs:67-172 builder; disconnect.rs SSE disconnect
detection; metrics.rs:35-119 per-model metrics + inflight guards) — here
on aiohttp.

Also exposes the system surface (/health /live /metrics; reference:
lib/runtime/src/http_server.rs:33-69) since both ride one server here.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import time

from dynamo_tpu_torch.runtime import http_server as web

from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.protocols import (
    SSE_DONE,
    ChatCompletionRequest,
    CompletionRequest,
    OpenAIError,
    ResponsesRequest,
    gen_request_id,
    model_list,
    responses_body,
    responses_message_item,
    responses_usage,
    sse_event,
    sse_typed_event,
)
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.admission import AdmissionController, AdmissionRejected
from dynamo_tpu_torch.runtime.slo import SloBurnTracker, attribution_summary
from dynamo_tpu_torch.runtime.engine import Context, DeadlineExceededError
from dynamo_tpu_torch.runtime.logging import TraceContext, current_trace, get_logger
from dynamo_tpu_torch.runtime.messaging import OverloadedError
from dynamo_tpu_torch.runtime.metrics import InflightGuard, MetricsRegistry
from dynamo_tpu_torch.runtime.push_router import NoInstancesError

log = get_logger("http")
# Lifecycle ledger records ride the logging layer as structured JSONL
# (JsonlFormatter includes extra={} fields) in addition to /debug/requests.
ledger_log = get_logger("ledger")


class HttpService:
    def __init__(
        self,
        manager: ModelManager,
        metrics: MetricsRegistry,
        health=None,
        host: str = "0.0.0.0",
        port: int = 8080,
        admission: AdmissionController | None = None,
        default_timeout: float = 0.0,
        reuse_port: bool = False,
        sock=None,
        admin_port: int | None = None,
        proc_label: str | None = None,
    ):
        self.manager = manager
        # Trace lane for this ingress's spans (http.request + frontend
        # phases). None keeps the process default lane; in-process fleets
        # pass distinct labels so each logical frontend gets its own lane.
        self.proc_label = proc_label
        self.health = health
        self.host = host
        self.port = port
        # Fleet socket sharing: reuse_port binds this process's own
        # listener with SO_REUSEPORT (kernel spreads accepts across the
        # fleet); sock serves an inherited, already-listening socket
        # (platforms without SO_REUSEPORT). admin_port adds a second,
        # per-process site on 127.0.0.1 so the supervisor can scrape
        # THIS process's /metrics + /debug/requests — a GET against the
        # shared port lands on an arbitrary sibling.
        self.reuse_port = reuse_port
        self.sock = sock
        self.admin_port = admin_port
        # Admission gate for the inference surface; an unbounded controller
        # still tracks in-flight count so graceful drain works.
        self.admission = admission or AdmissionController()
        # Applied when the client sends no X-Request-Timeout (0 = none).
        self.default_timeout = default_timeout
        self._runner: web.AppRunner | None = None
        self._main_site: web.BaseSite | None = None
        scope = metrics.child("http")
        self.m_requests = scope.counter("http_requests_total", "HTTP requests")
        self.m_inflight = scope.gauge("http_inflight", "In-flight requests")
        self.m_shed = scope.counter("http_requests_shed_total", "Requests shed at the admission gate")
        self.m_duration = scope.histogram("http_request_duration_seconds", "Request duration")
        self.m_ttft = scope.histogram("http_time_to_first_token_seconds", "Time to first token")
        # Per-request mean inter-token latency — the planner's ITL input
        # (reference observes ITL from frontend metrics, planner_core.py:189-320).
        self.m_itl = scope.histogram("http_inter_token_latency_seconds", "Mean inter-token latency per request")
        self.m_output_tokens = scope.counter("http_output_tokens_total", "Output tokens")
        # Prompt-side twin of output tokens: the autoscaler sizes the
        # PREFILL pool from the observed input-token rate (docs/autoscaler.md).
        self.m_input_tokens = scope.counter("http_input_tokens_total", "Prompt tokens")
        self.m_admission_wait = scope.histogram(
            "admission_wait_seconds", "Time spent waiting at the admission gate"
        )
        self.m_queue_depth = scope.gauge(
            "admission_queue_depth",
            "Requests queued at the admission gate (total, and per QoS "
            "class when a policy is installed)",
        )
        self.m_rejected = scope.counter(
            "admission_rejected_total",
            "Requests shed at the admission gate by QoS class and reason "
            "(capacity / queue_timeout / slo_predicted / draining)",
        )
        self.m_pred_ttft = scope.histogram(
            "admission_predicted_ttft_seconds",
            "Admission-time TTFT predictions (queue depth x profiled "
            "prefill curve) — what early rejection compares to the "
            "class SLO",
        )
        # Route admission-gate predictions into the histogram (the gate
        # itself stays metrics-free; this is its only metrics seam).
        self.admission.predict_observer = (
            lambda cls, seconds: self.m_pred_ttft.observe(
                seconds, **{"class": cls}
            )
        )
        self.m_deadline = scope.counter(
            "deadline_expired_total",
            "Requests that ran out of budget, by enforcement point",
        )
        # SLO attribution plane: burn-rate EMAs fed by the ledger, read
        # back by the admission gate (burn-aware early rejection) and
        # exposed on /debug/slo — the planner/QoS evidence seam.
        self.slo_burn = SloBurnTracker(qos=self.admission.qos, registry=metrics)
        self.admission.burn = self.slo_burn
        self._metrics_registry = metrics

    def build_app(self) -> web.Application:
        app = web.Application()
        app.router.add_post("/v1/chat/completions", self.handle_chat)
        app.router.add_post("/v1/completions", self.handle_completions)
        app.router.add_post("/v1/responses", self.handle_responses)
        app.router.add_get("/v1/models", self.handle_models)
        app.router.add_get("/health", self.handle_health)
        app.router.add_get("/live", self.handle_live)
        app.router.add_get("/metrics", self.handle_metrics)
        app.router.add_post("/v1/embeddings", self.handle_embeddings)
        app.router.add_post("/clear_kv_blocks", self.handle_clear_kv_blocks)
        app.router.add_get("/debug/requests", self.handle_debug_requests)
        app.router.add_get("/debug/traces/{trace_id}", self.handle_debug_trace)
        app.router.add_get("/debug/admission", self.handle_debug_admission)
        app.router.add_get("/debug/slo", self.handle_debug_slo)
        return app

    async def start(self) -> "HttpService":
        self._runner = web.AppRunner(self.build_app(), access_log=None)
        await self._runner.setup()
        if self.sock is not None:
            site: web.BaseSite = web.SockSite(self._runner, self.sock)
            await site.start()
            self.port = self.sock.getsockname()[1]
        else:
            site = web.TCPSite(
                self._runner, self.host, self.port,
                reuse_port=True if self.reuse_port else None,
            )
            await site.start()
            self.port = site._server.sockets[0].getsockname()[1]  # resolved when port=0
        self._main_site = site
        if self.admin_port is not None:
            admin = web.TCPSite(self._runner, "127.0.0.1", self.admin_port)
            await admin.start()
            self.admin_port = admin._server.sockets[0].getsockname()[1]
        log.info("http service listening on %s:%d", self.host, self.port)
        return self

    async def close(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()

    def start_draining(self) -> None:
        """SIGTERM path step 1: refuse new inference requests (503 +
        Retry-After) while in-flight streams keep running."""
        self.admission.start_draining()

    async def stop_accepting(self) -> None:
        """Fleet drain step 0: close the main listener so this process
        leaves the SO_REUSEPORT group (or stops competing on the
        inherited socket) — new connections land only on siblings and
        never see this process's drain 503s. In-flight connections and
        the admin site stay up."""
        if self._main_site is not None:
            await self._main_site.stop()
            self._main_site = None

    async def wait_drained(self, timeout: float | None = None) -> bool:
        """SIGTERM path step 2: wait for in-flight streams to finish.
        → True if fully drained within ``timeout``."""
        return await self.admission.wait_idle(timeout)

    # -- system surface ----------------------------------------------------

    async def handle_health(self, request: web.Request) -> web.Response:
        ready = self.health.ready if self.health is not None else True
        body = {"status": "ready" if ready else "notready", "models": self.manager.list_names()}
        return web.json_response(body, status=200 if ready else 503)

    async def handle_live(self, request: web.Request) -> web.Response:
        live = self.health.live if self.health is not None else True
        return web.json_response({"live": live}, status=200 if live else 503)

    async def handle_metrics(self, request: web.Request) -> web.Response:
        return web.Response(text=self._metrics_registry.render(), content_type="text/plain")

    async def handle_embeddings(self, request: web.Request) -> web.Response:
        """OpenAI /v1/embeddings (reference: http/service/openai.rs:302).
        Accepts string / list-of-strings / token-id inputs; vectors are the
        model's mean-pooled final hidden states."""
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 — HTTP boundary: any malformed body maps to a typed 400, never a 500
            return web.json_response(
                OpenAIError("request body must be JSON").body(), status=400
            )
        model = body.get("model") or ""
        pipe = self.manager.get(model)
        if pipe is None:
            return web.json_response(
                OpenAIError(f"model {model!r} not found", status=404,
                            err_type="not_found_error").body(),
                status=404,
            )
        raw = body.get("input")
        if isinstance(raw, str):
            inputs: list = [raw]
        elif isinstance(raw, list) and raw and all(isinstance(t, int) for t in raw):
            inputs = [raw]
        elif isinstance(raw, list) and raw:
            inputs = raw
        else:
            return web.json_response(
                OpenAIError("'input' must be a string, list of strings, or token ids").body(),
                status=400,
            )
        tok = pipe.preprocessor.tokenizer
        data = []
        total_tokens = 0
        try:
            for i, item in enumerate(inputs):
                ids = tok.encode(item) if isinstance(item, str) else [int(t) for t in item]
                total_tokens += len(ids)
                vec = await pipe.embed(ids)
                data.append({"object": "embedding", "index": i, "embedding": vec})
        except NoInstancesError:
            # No worker serves the embed endpoint (e.g. mocker fleets).
            return web.json_response(
                OpenAIError("embeddings unavailable for this model", status=501,
                            err_type="not_implemented_error").body(),
                status=501,
            )
        except Exception as e:  # noqa: BLE001 — worker- or engine-reported
            # failure: validation errors are the client's (empty/over-limit
            # input → 400); anything else is a 500.
            msg = str(e)
            if "exceeds" in msg or "empty input" in msg:
                return web.json_response(OpenAIError(msg).body(), status=400)
            log.warning("embeddings failed: %s", e)
            return web.json_response(
                OpenAIError("embedding failed", status=500,
                            err_type="internal_error").body(),
                status=500,
            )
        return web.json_response({
            "object": "list",
            "model": model,
            "data": data,
            "usage": {"prompt_tokens": total_tokens, "total_tokens": total_tokens},
        })

    async def handle_clear_kv_blocks(self, request: web.Request) -> web.Response:
        """Admin: clear idle KV blocks on all workers of every model
        (reference: http/service/clear_kv_blocks.rs)."""
        out: dict[str, dict] = {}
        for name, pipe in self.manager.items():
            try:
                out[name] = await pipe.clear_kv_blocks()
            except Exception as e:  # noqa: BLE001 — admin fan-out: one failing worker must not hide the others' results
                out[name] = {"error": str(e)}
        return web.json_response({"status": "ok", "cleared": out})

    async def handle_models(self, request: web.Request) -> web.Response:
        """Every served model, LoRA adapters included: an adapter card
        lists as its own model entry carrying {"lora": {adapter_id, base,
        rank, resident_tier}} so clients can tell fine-tunes from bases.
        Unknown adapter names 404 at request time like any unknown model
        (ModelManager.get returns None) — typed at the frontend, never
        mid-stream."""
        meta = {
            name: {"lora": dict(pipe.card.lora)}
            for name, pipe in self.manager.items()
            if pipe.card.lora
        }
        return web.json_response(
            model_list(self.manager.list_names(), metadata=meta)
        )

    # -- debug surface (span recorder views) -------------------------------

    async def handle_debug_requests(self, request: web.Request) -> web.Response:
        """Lifecycle ledger: one record per finished request, newest first.
        Filters: ``?trace_id=...``, ``?model=...``, ``?limit=N``."""
        rec = tracing.recorder()
        if rec is None:
            return web.json_response({"enabled": False, "requests": []})
        try:
            limit = max(1, min(int(request.query.get("limit", "100")), 1000))
        except ValueError:
            return web.json_response({"error": "limit must be an integer"}, status=400)
        model = request.query.get("model")
        # Filter before truncating: a model whose records are older than the
        # newest `limit` entries must still be findable.
        records = rec.ledger(
            request.query.get("trace_id"),
            limit=rec.ledger_capacity if model else limit,
        )
        if model:
            records = [r for r in records if r.get("model") == model][:limit]
        return web.json_response({"enabled": True, "requests": records})

    async def handle_debug_trace(self, request: web.Request) -> web.Response:
        """One trace as Chrome-trace JSON (load in Perfetto/chrome://tracing,
        or render with tools/trace_report.py)."""
        rec = tracing.recorder()
        if rec is None:
            return web.json_response({"error": "tracing disabled"}, status=404)
        trace_id = request.match_info["trace_id"]
        spans = rec.spans(trace_id)
        if not spans:
            return web.json_response({"error": f"unknown trace {trace_id}"}, status=404)
        body = tracing.chrome_trace(trace_id, spans)
        # Raw span dicts ride along for the fleet supervisor's stitcher
        # (fleet/aggregate.merge_traces) — lossless vs. the Chrome events.
        body["spans"] = [s.to_dict() for s in spans]
        return web.json_response(body)

    async def handle_debug_admission(self, request: web.Request) -> web.Response:
        """Per-class admission-gate state: queued/inflight, load-scaled
        Retry-After, and shed counts by reason — the fleet supervisor
        scrapes this per child into the ``/fleet`` status body."""
        body = self.admission.stats()
        pred = getattr(self.admission, "predictor", None)
        if pred is not None:
            body["predictor"] = {
                "prompt_len_ema": round(pred.prompt_len_ema, 1),
                "drain_interval_s": round(self.admission.drain_interval_s, 4),
                "profiled": pred.prefill is not None,
            }
        return web.json_response(body)

    async def handle_debug_slo(self, request: web.Request) -> web.Response:
        """SLO burn-rate state: per-class/per-phase burn EMAs, attainment
        EMAs, and an attribution summary over the recent ledger window —
        the same schema bench.py and the diurnal simulator emit."""
        body = self.slo_burn.snapshot()
        rec = tracing.recorder()
        if rec is not None:
            body["attribution"] = attribution_summary(rec.ledger(limit=200))
        return web.json_response(body)

    # -- inference surface -------------------------------------------------

    async def handle_chat(self, request: web.Request) -> web.StreamResponse:
        return await self._handle_inference(request, "chat")

    async def handle_completions(self, request: web.Request) -> web.StreamResponse:
        return await self._handle_inference(request, "completion")

    async def handle_responses(self, request: web.Request) -> web.StreamResponse:
        return await self._handle_inference(request, "responses")

    _PARSERS = {
        "chat": ChatCompletionRequest.parse,
        "completion": CompletionRequest.parse,
        "responses": ResponsesRequest.parse,
    }
    _ENDPOINT_LABEL = {"chat": "chat", "completion": "completions", "responses": "responses"}

    def _parse_timeout(self, request: web.Request, body: dict) -> float | None:
        """End-to-end deadline: ``X-Request-Timeout`` header (seconds) or
        ``request_timeout`` body field, else the service default."""
        raw = request.headers.get("X-Request-Timeout")
        if raw is None:
            raw = body.get("request_timeout") if isinstance(body, dict) else None
        if raw is None:
            return self.default_timeout if self.default_timeout > 0 else None
        try:
            timeout = float(raw)
        except (TypeError, ValueError):
            raise OpenAIError(f"invalid request timeout {raw!r}") from None
        # NaN passes a naive <= 0 check and would poison asyncio timers.
        if not math.isfinite(timeout) or timeout <= 0:
            raise OpenAIError("request timeout must be a positive finite number")
        return timeout

    def _retry_after(self, seconds: float | None = None) -> dict[str, str]:
        # Default to the gate's LOAD-SCALED value (base + expected wait
        # from the measured drain rate), not the static base: 429/503
        # backoff should track the queue, or clients retry into the
        # same wall.
        secs = seconds if seconds is not None else self.admission.retry_after_for()
        return {"Retry-After": str(max(1, math.ceil(secs)))}

    @staticmethod
    def _qos_headers(request: web.Request) -> tuple[str | None, str | None]:
        """``x-priority`` / ``x-tenant`` headers → validated (priority,
        tenant). Junk raises a typed 400 :class:`OpenAIError` — headers
        are the pre-body QoS signal (admission runs before the body is
        read), so they must be validated even earlier."""
        from dynamo_tpu_torch.runtime.qos import parse_priority, parse_tenant

        priority = tenant = None
        raw_p = request.headers.get("x-priority")
        if raw_p is not None:
            try:
                priority = parse_priority(raw_p)
            except ValueError as e:
                raise OpenAIError(f"invalid x-priority header: {e}") from None
        raw_t = request.headers.get("x-tenant")
        if raw_t is not None:
            try:
                tenant = parse_tenant(raw_t)
            except ValueError as e:
                raise OpenAIError(f"invalid x-tenant header: {e}") from None
        return priority, tenant

    def _set_queue_gauges(self) -> None:
        self.m_queue_depth.set(self.admission.queued)
        if self.admission.qos is not None:
            for c in self.admission.qos.order:
                self.m_queue_depth.set(
                    self.admission.queued_in(c), **{"class": c}
                )

    async def _handle_inference(self, request: web.Request, kind: str) -> web.StreamResponse:
        """Tracing shell around the real handler: opens the root span (from
        the inbound ``traceparent`` when present, else a fresh trace), and
        emits the lifecycle ledger record on every exit path."""
        endpoint = self._ENDPOINT_LABEL[kind]
        if self.proc_label:
            tracing.set_lane(self.proc_label)
        inbound = None
        tp = request.headers.get("traceparent")
        if tp:
            inbound = TraceContext.parse(tp, request.headers.get("tracestate"))
        root = tracing.start_span(
            "http.request", parent=inbound or current_trace(), endpoint=endpoint
        )
        # Mutable scratch the inner handler + stream helpers fill in:
        # model/status always; ttft_s/itl_s/tokens when generation ran.
        info: dict = {"model": "unknown", "status": None}
        t0 = time.perf_counter()
        try:
            resp = await self._handle_inference_inner(
                request, kind, root, inbound, info, t0
            )
            if info["status"] is None:
                info["status"] = str(resp.status)
            return resp
        except asyncio.CancelledError:
            info["status"] = "499"  # client went away mid-handling
            raise
        finally:
            self._emit_ledger(root, endpoint, info, time.perf_counter() - t0)

    def _emit_ledger(self, root, endpoint: str, info: dict, duration_s: float) -> None:
        if not root.recording:
            return
        status = info.get("status") or "500"
        root.set_attrs(model=info.get("model"), status=status)
        root.end(status="ok" if status.startswith("2") else f"http:{status}")
        rec = tracing.recorder()
        if rec is None:
            return
        # SLO budgets for the burn-rate derivation: the admitted class's
        # policy targets (absent without a QoS policy — the record then
        # carries an empty slo block and the tracker skips it).
        ttft_slo = itl_slo = None
        pol = self.admission.qos
        if pol is not None:
            qc = pol.classes.get(info.get("qos") or pol.default)
            if qc is not None:
                ttft_slo = qc.ttft_slo_s or None
                itl_slo = qc.itl_slo_s or None
        record = tracing.build_ledger(
            root.trace_id,
            # Scope to THIS request's span subtree: one client trace id may
            # carry several requests, which must not sum into each other.
            root_span_id=root.span_id,
            request_id=info.get("request_id", ""),
            model=info.get("model", "unknown"),
            endpoint=endpoint,
            status=status,
            duration_s=duration_s,
            prompt_tokens=info.get("prompt_tokens", 0),
            completion_tokens=info.get("completion_tokens", 0),
            ttft_s=info.get("ttft_s"),
            itl_s=info.get("itl_s"),
            qos=info.get("qos"),
            tenant=info.get("tenant"),
            ttft_slo_s=ttft_slo,
            itl_slo_s=itl_slo,
        )
        rec.record_ledger(record)
        self.slo_burn.observe(record)
        ledger_log.info(
            "request %s %s %s in %.3fs", record["request_id"] or record["trace_id"],
            record["model"], record["status"], record["duration_s"],
            extra={"event": "request_ledger", **record},
        )

    async def _handle_inference_inner(
        self, request: web.Request, kind: str, root, inbound, info: dict, t0: float
    ) -> web.StreamResponse:
        endpoint = self._ENDPOINT_LABEL[kind]
        model = "unknown"
        try:
            # Pre-body QoS identity: headers carry the class the gate
            # admits under (the body is not read yet — shedding must stay
            # O(1)); body fields refine the stamped identity after parse.
            hdr_priority, hdr_tenant = self._qos_headers(request)
        except OpenAIError as e:
            info["status"] = str(e.status)
            self.m_requests.inc(model=model, endpoint=endpoint, status=str(e.status))
            return web.json_response(e.body(), status=e.status)
        adm_span = tracing.start_span(
            "http.admission",
            parent=root.trace_context() if root.recording else None,
        )
        t_adm = time.perf_counter()
        try:
            qos_charge = await self.admission.acquire(hdr_priority)
        except AdmissionRejected as e:
            # Shed, don't queue: 503 while draining (instance going away),
            # 429 under overload — both tell the client when to come back
            # with a load-scaled Retry-After.
            adm_span.end(status="shed")
            status = 503 if e.draining else 429
            info["status"] = str(status)
            self.m_shed.inc(endpoint=endpoint, status=str(status))
            self.m_rejected.inc(**{"class": e.qos, "reason": e.reason})
            self.m_requests.inc(model=model, endpoint=endpoint, status=str(status))
            err = OpenAIError(str(e), status=status, err_type="overloaded_error")
            return web.json_response(
                err.body(), status=status, headers=self._retry_after(e.retry_after)
            )
        except BaseException:
            # Client gave up while queued: the LONGEST waits are exactly the
            # ones that must not vanish from the wait histogram/span record.
            adm_span.end(status="cancelled")
            raise
        else:
            adm_span.end()
            info["qos"] = qos_charge
        finally:
            self.m_admission_wait.observe(time.perf_counter() - t_adm)
            self._set_queue_gauges()
        try:
            try:
                body = await request.json()
            except (json.JSONDecodeError, UnicodeDecodeError):
                raise OpenAIError("request body must be valid JSON") from None
            req = self._PARSERS[kind](body)
            # Merge header-supplied QoS identity (body fields win on
            # conflict — the body is the canonical OpenAI surface; the
            # headers exist so proxies can tag without body rewrites).
            if req.priority is None:
                req.priority = hdr_priority
            if req.tenant is None:
                req.tenant = hdr_tenant
            model = req.model
            info["model"] = model
            info["tenant"] = req.tenant
            if req.tenant is not None and root.recording:
                root.set_attrs(tenant=req.tenant, qos=qos_charge)
            pipe = self.manager.get(req.model)
            if pipe is None:
                raise OpenAIError(f"model {req.model!r} not found", status=404, err_type="not_found_error")

            # Downstream hops parent on the root span, so worker-side spans
            # and log lines share the inbound trace id end to end.
            ctx_trace = (
                root.trace_context() if root.recording
                else (inbound or current_trace())
            )
            ctx = Context.with_timeout(self._parse_timeout(request, body), trace=ctx_trace)
            info["request_id"] = ctx.id
            with InflightGuard(self.m_inflight, model=model):
                try:
                    if kind == "responses":
                        if req.stream:
                            return await self._responses_stream(request, pipe, req, ctx, model, t0, info)
                        return await self._responses_aggregate(pipe, req, ctx, model, t0, info)
                    if req.stream:
                        return await self._stream(request, pipe, req, ctx, model, endpoint, t0, info)
                    return await self._aggregate(pipe, req, ctx, model, endpoint, t0, info)
                finally:
                    ctx.cancel()  # no-op if finished; frees worker if abandoned
                    self.m_duration.observe(time.perf_counter() - t0, model=model)
        except OpenAIError as e:
            info["status"] = str(e.status)
            self.m_requests.inc(model=model, endpoint=endpoint, status=str(e.status))
            return web.json_response(e.body(), status=e.status)
        except DeadlineExceededError:
            info["status"] = "504"
            self.m_deadline.inc(scope="http")
            self.m_requests.inc(model=model, endpoint=endpoint, status="504")
            err = OpenAIError("request exceeded its deadline", status=504, err_type="timeout_error")
            return web.json_response(err.body(), status=504)
        except OverloadedError:
            # Every routing attempt was refused at a worker admission gate.
            info["status"] = "503"
            self.m_requests.inc(model=model, endpoint=endpoint, status="503")
            err = OpenAIError("all workers at capacity", status=503, err_type="overloaded_error")
            return web.json_response(err.body(), status=503, headers=self._retry_after())
        except NoInstancesError:
            info["status"] = "503"
            self.m_requests.inc(model=model, endpoint=endpoint, status="503")
            err = OpenAIError("no workers available for this model", status=503, err_type="overloaded_error")
            return web.json_response(err.body(), status=503, headers=self._retry_after())
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — HTTP boundary
            log.exception("inference request failed")
            info["status"] = "500"
            self.m_requests.inc(model=model, endpoint=endpoint, status="500")
            err = OpenAIError("internal error", status=500, err_type="internal_error")
            return web.json_response(err.body(), status=500)
        finally:
            self.admission.release(qos_charge)
            self._set_queue_gauges()
            # Feed the TTFT predictor the observed prompt length: the
            # gate admits before the body is parsed, so it can only know
            # TYPICAL prompts — this is where "typical" comes from.
            pred = getattr(self.admission, "predictor", None)
            if pred is not None and info.get("prompt_tokens"):
                pred.observe_prompt_len(info["prompt_tokens"])

    async def _stream(
        self, request: web.Request, pipe, req, ctx: Context, model: str, endpoint: str,
        t0: float, info: dict,
    ) -> web.StreamResponse:
        # Pull the FIRST pipeline item before opening the SSE stream: lazy
        # preprocessing (template render, context-length validation) raises
        # on first __anext__, and those must surface as a clean 4xx — once
        # resp.prepare() runs, the 200 is on the wire.
        stream = pipe.run(req, ctx).__aiter__()
        try:
            head = await stream.__anext__()
        except StopAsyncIteration:
            head = None

        resp = web.StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            },
        )
        await resp.prepare(request)
        first = True
        last_gen = None
        failed = False
        t_first_tok = t_last_tok = None
        # Hoisted per-stream: the hot loop below runs once per chunk.
        write = resp.write
        perf_counter = time.perf_counter
        anext_ = stream.__anext__
        try:
            while head is not None:
                gen, chunk = head
                last_gen = gen
                if chunk is not None:
                    t_last_tok = perf_counter()
                    if first:
                        first = False
                        t_first_tok = t_last_tok
                        info["ttft_s"] = t_last_tok - t0
                        self.m_ttft.observe(info["ttft_s"], model=model)
                    try:
                        # Pure content deltas arrive preserialized
                        # (EncodedSse, a bytes subclass); dict chunks (role
                        # / logprobs / finish) serialize generically.
                        if type(chunk) is dict:
                            await write(sse_event(json.dumps(chunk)))
                        else:
                            await write(chunk)
                    except (ConnectionResetError, ConnectionError):
                        # Client went away: propagate cancellation upstream
                        # (reference: lib/llm/src/http/service/disconnect.rs).
                        ctx.cancel()
                        log.info("client disconnected mid-stream (%s)", ctx.id)
                        break
                try:
                    head = await anext_()
                except StopAsyncIteration:
                    head = None
        except asyncio.CancelledError:
            # Client-disconnect cancellation: still close the operator chain
            # now so span finallys run before the 499 ledger is built.
            with contextlib.suppress(Exception):
                await stream.aclose()
            raise
        except Exception as e:  # noqa: BLE001 — mid-stream: SSE error, not a 2nd response
            failed = True
            if not isinstance(e, (OpenAIError, DeadlineExceededError)):
                log.exception("stream failed mid-flight (%s)", ctx.id)
            if isinstance(e, DeadlineExceededError):
                self.m_deadline.inc(scope="http")
            err = self._stream_error(e)
            info["status"] = str(err.status)
            self.m_requests.inc(model=model, endpoint=endpoint, status=str(err.status))
            with contextlib.suppress(ConnectionResetError, ConnectionError):
                await resp.write(sse_event(json.dumps(err.body())))
                await resp.write(SSE_DONE)
                await resp.write_eof()
        with contextlib.suppress(Exception):
            await stream.aclose()  # deterministic span/wire cleanup
        if last_gen is not None:
            info["prompt_tokens"] = last_gen.prompt_tokens
            info["completion_tokens"] = last_gen.completion_tokens
            self.m_output_tokens.inc(last_gen.completion_tokens, model=model)
            self.m_input_tokens.inc(last_gen.prompt_tokens, model=model)
            if last_gen.completion_tokens > 1 and t_first_tok is not None and t_last_tok > t_first_tok:
                info["itl_s"] = (t_last_tok - t_first_tok) / (last_gen.completion_tokens - 1)
                self.m_itl.observe(info["itl_s"], model=model)
        if not ctx.cancelled and not failed:
            info["status"] = "200"
            self.m_requests.inc(model=model, endpoint=endpoint, status="200")
            with contextlib.suppress(ConnectionResetError, ConnectionError):
                await resp.write(SSE_DONE)
                await resp.write_eof()
        elif ctx.cancelled and not failed:
            info["status"] = "499"  # client disconnected mid-stream
        return resp

    @staticmethod
    def _stream_error(e: Exception) -> OpenAIError:
        """Typed mid-stream failure → the SSE error event's shape. Once the
        200 is on the wire the status only lands in metrics, but the typed
        body still tells the client *why* the stream ended."""
        if isinstance(e, OpenAIError):
            return e
        if isinstance(e, DeadlineExceededError):
            return OpenAIError("request exceeded its deadline", status=504, err_type="timeout_error")
        if isinstance(e, OverloadedError):
            return OpenAIError("all workers at capacity", status=503, err_type="overloaded_error")
        return OpenAIError("stream failed", status=500, err_type="internal_error")

    # -- /v1/responses (OpenAI Responses API) ------------------------------
    #
    # Reference parity: lib/llm/src/http/service/openai.rs:584-850 — the
    # reference converts to chat completions and serves unary only; here
    # the streaming path emits the full typed event sequence too.

    @staticmethod
    def _responses_status(finish_reason: str | None) -> tuple[str, str | None]:
        """finish_reason → (response status, incomplete reason)."""
        if finish_reason == "length":
            return "incomplete", "max_output_tokens"
        return "completed", None

    async def _responses_aggregate(
        self, pipe, req: ResponsesRequest, ctx: Context, model: str, t0: float,
        info: dict,
    ) -> web.Response:
        gen = None
        first = True
        t_first_tok = t_last_tok = None
        async for g, _chunk in pipe.run(req.to_chat(), ctx):
            gen = g
            t_last_tok = time.perf_counter()
            if first:
                first = False
                t_first_tok = t_last_tok
                info["ttft_s"] = time.perf_counter() - t0
                self.m_ttft.observe(info["ttft_s"], model=model)
        assert gen is not None
        info["prompt_tokens"] = gen.prompt_tokens
        info["completion_tokens"] = gen.completion_tokens
        self.m_output_tokens.inc(gen.completion_tokens, model=model)
        self.m_input_tokens.inc(gen.prompt_tokens, model=model)
        if gen.completion_tokens > 1 and t_first_tok is not None and t_last_tok > t_first_tok:
            info["itl_s"] = (t_last_tok - t_first_tok) / (gen.completion_tokens - 1)
            self.m_itl.observe(info["itl_s"], model=model)
        status, why = self._responses_status(gen.finish_reason)
        body = responses_body(
            gen_request_id("resp"), model, gen.created, status=status,
            output=[responses_message_item(gen_request_id("msg"), "".join(gen.text_parts))],
            usage=responses_usage(gen.prompt_tokens, gen.completion_tokens),
            incomplete_reason=why, req=req,
        )
        self.m_requests.inc(model=model, endpoint="responses", status="200")
        return web.json_response(body)

    async def _responses_stream(
        self, request: web.Request, pipe, req: ResponsesRequest, ctx: Context,
        model: str, t0: float, info: dict,
    ) -> web.StreamResponse:
        """Typed Responses event stream: created → in_progress →
        output_item.added → content_part.added → output_text.delta* →
        output_text.done → content_part.done → output_item.done →
        completed/incomplete."""
        stream = pipe.run(req.to_chat(), ctx).__aiter__()
        try:
            head = await stream.__anext__()
        except StopAsyncIteration:
            head = None

        resp_id = gen_request_id("resp")
        item_id = gen_request_id("msg")
        created = int(time.time())
        seq = 0

        resp = web.StreamResponse(status=200, headers={
            "Content-Type": "text/event-stream", "Cache-Control": "no-cache",
        })
        await resp.prepare(request)

        disconnected = False

        async def emit(event: str, payload: dict) -> bool:
            nonlocal seq, disconnected
            payload = {"type": event, **payload, "sequence_number": seq}
            seq += 1
            try:
                await resp.write(sse_typed_event(event, json.dumps(payload)))
                return True
            except (ConnectionResetError, ConnectionError):
                disconnected = True
                ctx.cancel()
                log.info("client disconnected mid-stream (%s)", ctx.id)
                return False

        snapshot = responses_body(resp_id, model, created, status="in_progress", req=req)
        ok = await emit("response.created", {"response": snapshot})
        ok = ok and await emit("response.in_progress", {"response": snapshot})
        ok = ok and await emit("response.output_item.added", {
            "output_index": 0,
            "item": responses_message_item(item_id, "", status="in_progress"),
        })
        ok = ok and await emit("response.content_part.added", {
            "item_id": item_id, "output_index": 0, "content_index": 0,
            "part": {"type": "output_text", "text": "", "annotations": []},
        })

        gen = None
        first = True
        failed = False
        t_first_tok = t_last_tok = None
        try:
            while ok and head is not None:
                g, chunk = head
                gen = g
                if chunk is not None:
                    if type(chunk) is dict:
                        delta = (chunk.get("choices") or [{}])[0].get("delta", {}).get("content")
                    else:  # EncodedSse carries its delta text
                        delta = chunk.text
                    if delta:
                        t_last_tok = time.perf_counter()
                        if first:
                            first = False
                            t_first_tok = t_last_tok
                            info["ttft_s"] = time.perf_counter() - t0
                            self.m_ttft.observe(info["ttft_s"], model=model)
                        ok = await emit("response.output_text.delta", {
                            "item_id": item_id, "output_index": 0,
                            "content_index": 0, "delta": delta,
                        })
                try:
                    head = await stream.__anext__()
                except StopAsyncIteration:
                    head = None
        except asyncio.CancelledError:
            with contextlib.suppress(Exception):
                await stream.aclose()
            raise
        except Exception as e:  # noqa: BLE001 — mid-stream failure → error event
            failed = True
            if not isinstance(e, (OpenAIError, DeadlineExceededError)):
                log.exception("responses stream failed mid-flight (%s)", ctx.id)
            if isinstance(e, DeadlineExceededError):
                self.m_deadline.inc(scope="http")
            err = self._stream_error(e)
            info["status"] = str(err.status)
            self.m_requests.inc(model=model, endpoint="responses", status=str(err.status))
            with contextlib.suppress(ConnectionResetError, ConnectionError):
                # Responses typed-event error shape (emit injects
                # type+sequence_number), not the chat-SSE error body.
                await emit("error", {"code": err.err_type, "message": str(err),
                                     "param": None})
                await resp.write_eof()
        with contextlib.suppress(Exception):
            await stream.aclose()  # deterministic span/wire cleanup
        if gen is not None:
            info["prompt_tokens"] = gen.prompt_tokens
            info["completion_tokens"] = gen.completion_tokens
            self.m_output_tokens.inc(gen.completion_tokens, model=model)
            self.m_input_tokens.inc(gen.prompt_tokens, model=model)
            if gen.completion_tokens > 1 and t_first_tok is not None and t_last_tok > t_first_tok:
                info["itl_s"] = (t_last_tok - t_first_tok) / (gen.completion_tokens - 1)
                self.m_itl.observe(info["itl_s"], model=model)
        if ok and not disconnected and not failed and gen is not None:
            text = "".join(gen.text_parts)
            status, why = self._responses_status(gen.finish_reason)
            ok = await emit("response.output_text.done", {
                "item_id": item_id, "output_index": 0, "content_index": 0,
                "text": text,
            })
            ok = ok and await emit("response.content_part.done", {
                "item_id": item_id, "output_index": 0, "content_index": 0,
                "part": {"type": "output_text", "text": text, "annotations": []},
            })
            ok = ok and await emit("response.output_item.done", {
                "output_index": 0,
                "item": responses_message_item(item_id, text),
            })
            final = responses_body(
                resp_id, model, created, status=status,
                output=[responses_message_item(item_id, text)],
                usage=responses_usage(gen.prompt_tokens, gen.completion_tokens),
                incomplete_reason=why, req=req,
            )
            event = "response.completed" if status == "completed" else "response.incomplete"
            ok = ok and await emit(event, {"response": final})
            if ok and not disconnected:
                info["status"] = "200"
                self.m_requests.inc(model=model, endpoint="responses", status="200")
                with contextlib.suppress(ConnectionResetError, ConnectionError):
                    await resp.write_eof()
        if disconnected:
            info["status"] = "499"
        return resp

    async def _aggregate(
        self, pipe, req, ctx: Context, model: str, endpoint: str, t0: float,
        info: dict,
    ) -> web.Response:
        gen = None
        first = True
        t_first_tok = t_last_tok = None
        async for g, _chunk in pipe.run(req, ctx):
            gen = g
            t_last_tok = time.perf_counter()
            if first:
                first = False
                t_first_tok = t_last_tok
                info["ttft_s"] = time.perf_counter() - t0
                self.m_ttft.observe(info["ttft_s"], model=model)
        assert gen is not None
        info["prompt_tokens"] = gen.prompt_tokens
        info["completion_tokens"] = gen.completion_tokens
        self.m_output_tokens.inc(gen.completion_tokens, model=model)
        self.m_input_tokens.inc(gen.prompt_tokens, model=model)
        if gen.completion_tokens > 1 and t_first_tok is not None and t_last_tok > t_first_tok:
            info["itl_s"] = (t_last_tok - t_first_tok) / (gen.completion_tokens - 1)
            self.m_itl.observe(info["itl_s"], model=model)
        info["status"] = "200"
        self.m_requests.inc(model=model, endpoint=endpoint, status="200")
        return web.json_response(gen.final_response())
