"""Distributed span tracing: lightweight spans + bounded in-process recorder.

Reference analogue: tracing spans with ``traceparent`` propagation
(reference: lib/runtime/src/logging.rs:131-204) and the per-request timing
the SLA planner and KV router depend on. The repo already parses and
forwards W3C trace context (runtime/logging.py, messaging.py); this module
adds the *spans* — named, timed, attributed intervals keyed off
:class:`~dynamo_tpu_torch.runtime.logging.TraceContext` — and three derived
views:

- a bounded :class:`SpanRecorder` ring buffer (per process) queryable by
  trace id;
- a per-request **lifecycle ledger** (one structured record per finished
  request: phase durations, TTFT/ITL, tokens, retries, migrations,
  outcome), built by the HTTP ingress from the recorder;
- a Chrome-trace/Perfetto export so a slow request renders as a flame
  timeline (``/debug/traces/{trace_id}``, tools/trace_report.py).

Span recording is process-local: in-process fleets (tests, mocker runs,
single-host deployments) see the full frontend→router→worker nesting;
across real process boundaries each process records its own segment of
the trace, stitched by the shared trace id (grep the JSONL logs, or pull
each process's ``/debug/traces``).

Cost model: spans are per-request/per-phase, never per-token. With the
recorder disabled (``DYNTPU_TRACING=0``) ``start_span`` returns a shared
no-op span after one attribute load — nothing allocates, nothing locks.
Serving-path call sites additionally record spans only for requests that
carry a trace context (the HTTP ingress always sets one): untraced
infrastructure RPCs — exporter scrapes, KV event subscriptions — stay
span-free so they never pollute the phase histograms.
"""

from __future__ import annotations

import contextvars
import os
import secrets
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

from dynamo_tpu_torch.runtime.logging import TraceContext, current_trace

__all__ = [
    "Span",
    "SpanRecorder",
    "NOOP_SPAN",
    "start_span",
    "start_span_if",
    "record_interval",
    "recorder",
    "enabled",
    "set_recorder",
    "build_ledger",
    "chrome_trace",
    "chrome_trace_from_dicts",
    "install_metrics_sink",
    "remove_metrics_sink",
    "PHASE_SPANS",
    "default_lane",
    "set_default_lane",
    "current_lane",
    "set_lane",
    "reset_lane",
]

# Span-name → ledger phase key. The ledger sums durations of all spans
# sharing a phase (a migrated request has several engine.prefill spans).
PHASE_SPANS = {
    "http.admission": "admission_wait",
    "http.preprocess": "preprocess",
    "router.attempt": "route",
    "wire.call": "wire",
    "engine.queue": "queue_wait",
    "engine.prefill": "prefill",
    "engine.decode": "decode",
    # Disagg data plane (llm/disagg.py): dispatch + streamed KV pull.
    "disagg.remote_prefill": "remote_prefill",
    # Cross-process attribution phases (ledger schema v2): the streamed
    # KV transfer window, the client-visible migration freeze gap
    # (resume marker → first token of the next leg), and re-dispatch
    # fallback legs.
    "transfer.kv_pull": "transfer",
    "migration.resume": "migration_freeze",
    "migration.redispatch": "redispatch",
}


# -- process/lane identity ----------------------------------------------------
#
# Every span is stamped with the *lane* it was recorded in — the process
# (or, for in-process fleets, the component standing in for a process)
# that did the work. The fleet-stitched trace view renders one timeline
# lane per distinct value. Default is per-process (DYNTPU_PROC_LANE or
# proc-<pid>, overridden once by the CLI entry points); serving seams
# (EndpointServer, HttpService) narrow it per-task via the contextvar so
# in-process multi-runtime tests get distinct lanes too.

_default_lane: str = os.environ.get("DYNTPU_PROC_LANE") or f"proc-{os.getpid()}"
_lane_var: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "dyntpu_lane", default=None
)


def default_lane() -> str:
    return _default_lane


def set_default_lane(label: str) -> None:
    """Set this process's lane label (CLI entry points, once at startup)."""
    global _default_lane
    _default_lane = label


def current_lane() -> str:
    return _lane_var.get() or _default_lane


def set_lane(label: str):
    """Narrow the lane for the current task. → token for :func:`reset_lane`."""
    return _lane_var.set(label)


def reset_lane(token) -> None:
    _lane_var.reset(token)


class Span:
    """One timed interval in a trace. Not thread-safe per instance — a span
    is owned by the coroutine/thread that started it; only ``end()`` crosses
    into the (locked) recorder."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start_ts", "_t0",
        "duration_s", "attrs", "events", "status", "_recorder", "_ended",
        "flags", "tracestate", "proc",
    )

    recording = True

    def __init__(
        self,
        recorder: "SpanRecorder",
        name: str,
        trace_id: str,
        parent_id: str | None,
        attrs: dict[str, Any],
        flags: str = "01",
        tracestate: str | None = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = secrets.token_hex(8)
        self.parent_id = parent_id
        # Inbound W3C sampled-flag and vendor tracestate ride through
        # trace_context() so downstream hops see the client's values.
        self.flags = flags
        self.tracestate = tracestate
        self.start_ts = time.time()
        self._t0 = time.perf_counter()
        self.duration_s: float | None = None
        self.attrs = attrs
        self.events: list[tuple[str, float, dict]] = []
        self.status = "ok"
        self._recorder = recorder
        self._ended = False
        # Lane stamp: which process/role recorded this span. Stamped at
        # creation (not end) so cross-thread end() keeps the creator's lane.
        self.proc = current_lane()

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def set_attrs(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def add_event(self, name: str, **attrs: Any) -> None:
        """Point-in-time marker within the span (offset seconds from start)."""
        self.events.append((name, time.perf_counter() - self._t0, attrs))

    def trace_context(self) -> TraceContext:
        """This span as a TraceContext — set it as the current trace (or a
        Context's ``trace``) and downstream spans/hops parent on this span."""
        return TraceContext(
            trace_id=self.trace_id, parent_span_id=self.span_id,
            flags=self.flags, tracestate=self.tracestate,
        )

    def end(self, status: str | None = None, at: float | None = None) -> None:
        """Idempotent; safe from ``finally`` on every exit path including
        cancellation. Only the first call records. ``at`` is an optional
        ``time.perf_counter()`` instant for intervals that ended in the past
        (cross-thread stamps, see :func:`record_interval`)."""
        if self._ended:
            return
        self._ended = True
        if status is not None:
            self.status = status
        self.duration_s = (time.perf_counter() if at is None else at) - self._t0
        self._recorder._record(self)

    # Context-manager form for straight-line sections. (Multi-yield
    # generator stages manage end() in their own finally instead.)
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        self.end(status=f"error:{exc_type.__name__}" if exc_type else None)
        return False

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ts": self.start_ts,
            "duration_s": self.duration_s,
            "status": self.status,
            "proc": self.proc,
            "attrs": dict(self.attrs),
            "events": [
                {"name": n, "offset_s": off, **({"attrs": a} if a else {})}
                for n, off, a in self.events
            ],
        }


class _NoopSpan:
    """Shared do-nothing span: the disabled-recorder fast path."""

    __slots__ = ()
    recording = False
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    status = "ok"
    duration_s = None
    proc = ""

    def set_attr(self, key, value) -> None:
        pass

    def set_attrs(self, **attrs) -> None:
        pass

    def add_event(self, name, **attrs) -> None:
        pass

    def trace_context(self) -> None:  # type: ignore[override]
        return None

    def end(self, status=None, at=None) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class SpanRecorder:
    """Bounded ring buffer of *finished* spans + ledger records.

    Thread-safe: the worker engine thread ends spans concurrently with the
    event loop. Eviction is strict FIFO over span end order; the per-trace
    index never outlives the ring (no unbounded growth under trace-id
    cardinality)."""

    # Chaos-note bounds: traces tracked × injections kept per trace.
    CHAOS_TRACES = 256
    CHAOS_PER_TRACE = 16

    def __init__(self, capacity: int = 4096, ledger_capacity: int = 1024):
        self.capacity = capacity
        self.ledger_capacity = ledger_capacity
        self._spans: deque[Span] = deque()
        self._by_trace: dict[str, list[Span]] = {}
        self._ledger: deque[dict] = deque()
        self._lock = threading.Lock()
        self._sinks: dict[int, Callable[[Span], None]] = {}
        self._next_sink = 0
        # trace_id → chaos injection kinds absorbed by that request
        # (ChaosInjector stamps the victim's current trace; the ledger
        # attaches them so a chaos-killed record names its injection).
        self._chaos: dict[str, list[str]] = {}
        self._chaos_order: deque[str] = deque()

    # -- spans --------------------------------------------------------------

    def start_span(
        self, name: str, parent: TraceContext | None = None, **attrs: Any
    ) -> Span:
        """Parent resolution: explicit ``parent`` wins, else the current
        trace contextvar, else a fresh root trace."""
        if parent is None:
            parent = current_trace()
        if parent is not None:
            return Span(
                self, name, parent.trace_id, parent.parent_span_id, attrs,
                flags=parent.flags, tracestate=parent.tracestate,
            )
        return Span(self, name, secrets.token_hex(16), None, attrs)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self._by_trace.setdefault(span.trace_id, []).append(span)
            while len(self._spans) > self.capacity:
                old = self._spans.popleft()
                bucket = self._by_trace.get(old.trace_id)
                if bucket is not None:
                    try:
                        bucket.remove(old)
                    except ValueError:
                        pass
                    if not bucket:
                        del self._by_trace[old.trace_id]
            sinks = list(self._sinks.values())
        for sink in sinks:  # histograms lock themselves; don't nest locks
            try:
                sink(span)
            # dyntpu: allow[DT005] reason=observer pattern: a throwing sink must not break span recording for every other consumer, and logging here could recurse through a logging sink
            except Exception:  # noqa: BLE001 — a sink must never break tracing
                pass

    def spans(self, trace_id: str | None = None) -> list[Span]:
        with self._lock:
            if trace_id is not None:
                return list(self._by_trace.get(trace_id, ()))
            return list(self._spans)

    # -- chaos notes --------------------------------------------------------

    def note_injection(self, trace_id: str, kind: str) -> None:
        """Stamp a chaos injection against the victim request's trace.
        Bounded both ways (traces tracked, kinds per trace); FIFO eviction."""
        if not trace_id:
            return
        with self._lock:
            bucket = self._chaos.get(trace_id)
            if bucket is None:
                bucket = self._chaos[trace_id] = []
                self._chaos_order.append(trace_id)
                while len(self._chaos_order) > self.CHAOS_TRACES:
                    self._chaos.pop(self._chaos_order.popleft(), None)
            if len(bucket) < self.CHAOS_PER_TRACE:
                bucket.append(kind)

    def injections(self, trace_id: str) -> list[str]:
        with self._lock:
            return list(self._chaos.get(trace_id, ()))

    # -- ledger -------------------------------------------------------------

    def record_ledger(self, record: dict) -> None:
        with self._lock:
            self._ledger.append(record)
            while len(self._ledger) > self.ledger_capacity:
                self._ledger.popleft()

    def ledger(self, trace_id: str | None = None, limit: int = 100) -> list[dict]:
        """Most recent first."""
        with self._lock:
            records = list(self._ledger)
        records.reverse()
        if trace_id is not None:
            records = [r for r in records if r.get("trace_id") == trace_id]
        return records[:limit]

    # -- metrics sinks ------------------------------------------------------

    def add_sink(self, fn: Callable[[Span], None]) -> int:
        with self._lock:
            key = self._next_sink
            self._next_sink += 1
            self._sinks[key] = fn
        return key

    def remove_sink(self, key: int) -> None:
        with self._lock:
            self._sinks.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._by_trace.clear()
            self._ledger.clear()
            self._chaos.clear()
            self._chaos_order.clear()


# -- process-global recorder --------------------------------------------------

def _env_enabled() -> bool:
    return os.environ.get("DYNTPU_TRACING", "1").strip().lower() not in (
        "0", "false", "off", "no",
    )


_recorder: SpanRecorder | None = (
    SpanRecorder(
        capacity=int(os.environ.get("DYNTPU_TRACING_CAPACITY", "4096")),
        ledger_capacity=int(os.environ.get("DYNTPU_TRACING_LEDGER", "1024")),
    )
    if _env_enabled()
    else None
)


def recorder() -> SpanRecorder | None:
    return _recorder


def enabled() -> bool:
    return _recorder is not None


def set_recorder(rec: SpanRecorder | None) -> SpanRecorder | None:
    """Swap the process recorder (tests; ``None`` disables). → previous."""
    global _recorder
    prev, _recorder = _recorder, rec
    return prev


def start_span(name: str, parent: TraceContext | None = None, **attrs: Any):
    """The one tracing entry point. Disabled ⇒ the shared no-op span."""
    rec = _recorder
    if rec is None:
        return NOOP_SPAN
    return rec.start_span(name, parent, **attrs)


def start_span_if(parent, name: str, **attrs: Any):
    """``start_span`` gated on a trace context: serving-path call sites
    record spans only for traced requests — an infra RPC without a trace
    (exporter scrape, KV event subscription) passes ``parent=None`` and
    gets the no-op span, keeping the phase histograms request-only."""
    if parent is None:
        return NOOP_SPAN
    return start_span(name, parent, **attrs)


def record_interval(
    name: str,
    parent: TraceContext | None = None,
    *,
    start: float,
    end: float,
    **attrs: Any,
):
    """Record an interval whose endpoints were stamped with
    ``time.perf_counter()`` — possibly on another thread (the engine
    scheduler stamps admission/prefill instants; the request coroutine
    turns them into spans after the fact)."""
    rec = _recorder
    if rec is None:
        return NOOP_SPAN
    span = rec.start_span(name, parent, **attrs)
    # Re-anchor the wall-clock start so the flame timeline lines up.
    span.start_ts = time.time() - (time.perf_counter() - start)
    span._t0 = start
    span.end(at=end)
    return span


def install_metrics_sink(registry):
    """Register ``phase_duration_seconds{phase=<span name>}`` on ``registry``
    and feed it every finished span. → opaque handle for removal, or None
    when tracing is disabled. The handle pins the recorder it was installed
    on, so a later ``set_recorder`` swap can't mis-route the removal."""
    rec = _recorder
    if rec is None:
        return None
    hist = registry.histogram(
        "phase_duration_seconds",
        "Span durations by span name (http.request, router.attempt, "
        "wire.call, wire.serve, engine.queue/prefill/decode, ...)",
    )

    def sink(span: Span) -> None:
        if span.duration_s is not None:
            hist.observe(span.duration_s, phase=span.name)

    return (rec, rec.add_sink(sink))


def remove_metrics_sink(handle) -> None:
    if handle is not None:
        rec, key = handle
        rec.remove_sink(key)


# -- derived views -------------------------------------------------------------

def build_ledger(
    trace_id: str,
    *,
    request_id: str,
    model: str,
    endpoint: str,
    status: str,
    duration_s: float,
    prompt_tokens: int = 0,
    completion_tokens: int = 0,
    ttft_s: float | None = None,
    itl_s: float | None = None,
    spans: Iterable[Span] | None = None,
    root_span_id: str | None = None,
    qos: str | None = None,
    tenant: str | None = None,
    ttft_slo_s: float | None = None,
    itl_slo_s: float | None = None,
) -> dict:
    """One lifecycle record for a finished request, derived from the
    recorder's spans for its trace. Phase durations are sums over the spans
    named in :data:`PHASE_SPANS`; retries/migrations are span counts.

    Schema v2 adds cross-process phases (transfer, migration_freeze,
    redispatch), QoS identity (``qos``/``tenant``), per-budget SLO burn
    ratios (``slo.ttft_burn = ttft_s / ttft_slo_s``), and the chaos
    injections the request absorbed (``chaos_injections``).

    ``root_span_id`` restricts the derivation to that span's subtree — a
    client may send several requests under ONE traceparent trace id
    (OpenTelemetry parent operations), and without the filter their
    phases/retries would sum into each other's ledgers."""
    if spans is None:
        rec = _recorder
        spans = rec.spans(trace_id) if rec is not None else []
    spans = list(spans)
    if root_span_id is not None:
        keep = {root_span_id}
        # Recorder order is by end time (children usually precede parents),
        # so expand to a fixpoint rather than assuming topological order.
        changed = True
        while changed:
            changed = False
            for span in spans:
                if span.span_id not in keep and span.parent_id in keep:
                    keep.add(span.span_id)
                    changed = True
        spans = [s for s in spans if s.span_id in keep]
    phases: dict[str, float] = {}
    attempts = 0
    migrations = 0
    for span in spans:
        phase = PHASE_SPANS.get(span.name)
        if phase is not None and span.duration_s is not None:
            phases[phase] = phases.get(phase, 0.0) + span.duration_s
        if span.name == "router.attempt":
            attempts += 1
        elif span.name == "migration.redispatch":
            migrations += 1
    slo: dict[str, Any] = {}
    if ttft_slo_s is not None and ttft_slo_s > 0 and ttft_s is not None:
        slo["ttft_slo_s"] = ttft_slo_s
        slo["ttft_burn"] = round(ttft_s / ttft_slo_s, 6)
        slo["ttft_attained"] = ttft_s <= ttft_slo_s
    if itl_slo_s is not None and itl_slo_s > 0 and itl_s is not None:
        slo["itl_slo_s"] = itl_slo_s
        slo["itl_burn"] = round(itl_s / itl_slo_s, 6)
        slo["itl_attained"] = itl_s <= itl_slo_s
    rec = _recorder
    chaos = rec.injections(trace_id) if rec is not None else []
    return {
        "schema": 2,
        "trace_id": trace_id,
        "request_id": request_id,
        "model": model,
        "endpoint": endpoint,
        "status": status,
        "qos": qos,
        "tenant": tenant,
        "duration_s": round(duration_s, 6),
        "ttft_s": None if ttft_s is None else round(ttft_s, 6),
        "itl_s": None if itl_s is None else round(itl_s, 6),
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "retries": max(attempts - 1, 0),
        "migrations": migrations,
        "phases": {k: round(v, 6) for k, v in sorted(phases.items())},
        "slo": slo,
        "chaos_injections": chaos,
        "ts": time.time(),
    }


def chrome_trace(trace_id: str, spans: Iterable[Span] | None = None) -> dict:
    """Chrome-trace ("catapult") JSON for one trace: complete ("X") events,
    loadable in ``chrome://tracing`` / Perfetto. Span lineage travels in
    ``args`` (span_id/parent_id) so tooling can rebuild the tree exactly."""
    if spans is None:
        rec = _recorder
        spans = rec.spans(trace_id) if rec is not None else []
    return chrome_trace_from_dicts(trace_id, [s.to_dict() for s in spans])


def chrome_trace_from_dicts(trace_id: str, span_dicts: Iterable[dict]) -> dict:
    """Chrome-trace JSON from span *dicts* (``Span.to_dict`` shape). This is
    the fleet-stitch entry point: spans scraped from several processes or
    loaded from the store merge into ONE timeline, with a pid **lane** per
    distinct ``proc`` label (named via "M" process_name metadata events).
    Output is deterministic for a given span set — duplicate span_ids are
    dropped and ordering is (start_ts, span_id) — so repeated assembly of
    the same trace is byte-stable."""
    seen: set[str] = set()
    spans = []
    for d in span_dicts:
        sid = d.get("span_id", "")
        if sid in seen:
            continue
        seen.add(sid)
        spans.append(d)
    spans.sort(key=lambda d: (d.get("start_ts") or 0.0, d.get("span_id", "")))
    lanes = sorted({d.get("proc") or "proc" for d in spans})
    pid_of = {lane: i + 1 for i, lane in enumerate(lanes)}
    events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid_of[lane],
            "tid": 1,
            "args": {"name": lane},
        }
        for lane in lanes
    ]
    for d in spans:
        pid = pid_of[d.get("proc") or "proc"]
        start_ts = d.get("start_ts") or 0.0
        events.append({
            "name": d.get("name", ""),
            "cat": "serving",
            "ph": "X",
            "ts": int(start_ts * 1e6),
            "dur": int((d.get("duration_s") or 0.0) * 1e6),
            "pid": pid,
            "tid": 1,
            "args": {
                "span_id": d.get("span_id"),
                "parent_id": d.get("parent_id"),
                "status": d.get("status", "ok"),
                "proc": d.get("proc") or "proc",
                **(d.get("attrs") or {}),
            },
        })
        for ev in d.get("events") or []:
            events.append({
                "name": f"{d.get('name', '')}:{ev.get('name', '')}",
                "cat": "serving",
                "ph": "i",
                "s": "t",
                "ts": int((start_ts + (ev.get("offset_s") or 0.0)) * 1e6),
                "pid": pid,
                "tid": 1,
                "args": dict(ev.get("attrs") or {}),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": {"trace_id": trace_id}}
