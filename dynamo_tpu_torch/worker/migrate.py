"""Live sequence migration: worker-side coordinator + receiver.

Relocates an IN-FLIGHT decode between two engines with zero client
impact: the source keeps decoding while its KV streams in chunks over
the disagg credit-flow transfer plane (the same ``kv_fetch`` windowed
pull disagg uses — int8 scales ride along per chunk), then a bounded
cutover window freezes the sequence, ships the delta pages plus the
full resume identity (tokens, sampler seed/step, spec EMA, grammar
state, adapter, prompt boundary), and the destination resumes the SAME
client stream byte-identically (the Migration operator consumes the
handoff marker and re-dispatches pinned to the destination).

Three phases, each with its own failure fallback — every failure mode
degrades to a COMPLETED stream, never a client-visible error:

- **streaming** — source publishes full KV blocks as the decode writes
  them; destination pulls concurrently. Source/dest/store death here
  aborts the migration and the source just keeps decoding.
- **cutover** — source freezes the sequence (out of the batch, slot and
  KV retained), force-drains pending device tokens, publishes the delta
  since the stream cursor and seals. If the destination never confirms
  the commit inside the freeze window, the source unfreezes and decodes
  on; if the coordinator itself dies, the engine's freeze deadline
  unfreezes the sequence autonomously.
- **rebind** — the source posts the ``{"migration": ...}`` marker; the
  frontend's Migration operator re-dispatches pinned to the
  destination and the router rebinds stickiness atomically on the
  destination's first frame. A dead store pins with ``rebind: False``
  (no decision-cache write against a store that can't take it); a
  destination that dies after committing simply misses its staged
  inject — the resume identity rides the request, so ANY worker can
  serve the leg by re-prefilling, still byte-identical.

``chaos.maybe_cut_migration(phase)`` (runtime/chaos.py) injects a
seeded victim — source, dest, or store — at each phase boundary, which
is how tests/test_migration_live.py pins every cell of the failure
matrix (docs/robustness.md).
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from typing import Any

from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.logging import TraceContext, get_logger
from dynamo_tpu_torch.transfer.stream import (
    DEFAULT_CREDIT_BYTES,
    CreditBudget,
    inject_payload_from_chunks,
    process_credit_budget,
    pull_kv_stream,
)

log = get_logger("worker.migrate")

# Streaming is "caught up" when the stream cursor trails the KV write
# head by at most this many blocks — the cutover delta stays tiny.
DEFAULT_LAG_BLOCKS = 2
# How long the source waits for the stream to catch up before giving up
# (the sequence keeps decoding the whole time, so this only bounds the
# migration attempt, never the request).
DEFAULT_STREAM_TIMEOUT_S = 30.0
# Staged injects the destination holds for a resume leg that never
# arrives (frontend died between commit and re-dispatch) are reaped
# after this long.
DEFAULT_STAGE_TTL_S = 120.0
# Bandwidth pacing: at most this many outbound
# migrations may stream concurrently per engine. The balancer issues
# one move per cycle, but pool moves/retirement fan out over the whole
# running batch — without the cap those N concurrent streams contend
# with the disagg KV plane for the same egress.
DEFAULT_MAX_OUTBOUND = 2


class MigrationError(Exception):
    """Typed failure of one migration attempt. Never propagates to a
    client: the coordinator aborts engine-side (the sequence resumes
    decoding locally) and answers ``{"ok": False, "reason"}``."""


def register_migration_metrics(registry) -> dict:
    """The live-migration observability series (DT006-cataloged) —
    registered by the worker runtime and by the catalog guard."""
    return {
        "attempts": registry.counter(
            "migration_attempts_total",
            "Live migration attempts by outcome (ok | fallback | noop | paced)",
        ),
        "fallbacks": registry.counter(
            "migration_fallback_total",
            "Live migrations abandoned to in-place decode, by reason",
        ),
        "bytes": registry.counter(
            "migration_kv_bytes_total",
            "KV bytes received by migration destinations over the stream plane",
        ),
        "cutover_gap": registry.histogram(
            "migration_cutover_gap_seconds",
            "Source freeze to destination commit-ack wall time per migration",
        ),
        "inflight": registry.gauge(
            "migration_inflight",
            "Migrations this worker is currently driving as the source",
        ),
        "outbound_inflight": registry.gauge(
            "migration_outbound_inflight",
            "Outbound migrations currently STREAMING from this worker "
            "(the bandwidth-pacing cap applies to this gauge)",
        ),
    }


class MigrationCoordinator:
    """Source-side driver of one worker's outbound migrations.

    ``engine`` is the local TpuEngine (all engine mutations ship to the
    scheduler thread via ``run_on_engine_thread``); ``admin_router`` is
    a DIRECT PushRouter on ``workerctl/admin`` (the same RPC surface the
    autoscaler actuates through); ``component`` / ``source_instance``
    tell the destination where to pull our ``kv_fetch`` endpoint."""

    def __init__(self, engine, admin_router, component: str,
                 source_instance: int, chaos=None, metrics: dict | None = None,
                 lag_blocks: int = DEFAULT_LAG_BLOCKS,
                 stream_timeout_s: float = DEFAULT_STREAM_TIMEOUT_S,
                 max_outbound: int = DEFAULT_MAX_OUTBOUND):
        self.engine = engine
        self.admin_router = admin_router
        self.component = component
        self.source_instance = source_instance
        self.chaos = chaos
        self.metrics = metrics
        self.lag_blocks = lag_blocks
        self.stream_timeout_s = stream_timeout_s
        # Bandwidth pacing: concurrent outbound migrations beyond the
        # cap answer typed {"ok": False, "reason": "paced"} instead of
        # opening another stream (callers retry or keep the sequence).
        self.max_outbound = max(int(max_outbound), 1)
        self._outbound = 0
        # In-process ledgers (tests/bench assert against these; the
        # metrics dict mirrors them when bound).
        self.outcomes: dict[str, int] = {}
        self.fallback_reasons: dict[str, int] = {}

    # -- bookkeeping --------------------------------------------------------

    def _outcome(self, outcome: str) -> None:
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        if self.metrics is not None:
            self.metrics["attempts"].inc(outcome=outcome)

    def _fallback(self, reason: str) -> None:
        self.fallback_reasons[reason] = self.fallback_reasons.get(reason, 0) + 1
        if self.metrics is not None:
            self.metrics["fallbacks"].inc(reason=reason)

    def _chaos_victim(self, phase: str, trace: TraceContext | None = None) -> str | None:
        if self.chaos is None:
            return None
        victim = self.chaos.maybe_cut_migration(phase)
        if victim is not None and trace is not None:
            # Bind the injection to the MIGRATING request's trace (the
            # admin RPC's ambient trace is the planner's, not the
            # victim's) so its ledger record carries the fault.
            with contextlib.suppress(Exception):
                tracing.recorder().note_injection(
                    trace.trace_id, f"migration_cut:{phase}:{victim}"
                )
        return victim

    # -- the protocol -------------------------------------------------------

    async def migrate_out(self, request_id: str, dest_instance: int) -> dict:
        """Relocate one running decode to ``dest_instance``. Always
        answers typed — ``{"ok": True, "handle"}`` on a completed
        handoff, ``{"ok": False, "reason"}`` on any fallback (the
        sequence then simply keeps decoding here)."""
        eng = self.engine
        if dest_instance == self.source_instance:
            self._outcome("noop")
            return {"ok": False, "reason": "self"}
        if self._outbound >= self.max_outbound:
            # Pacing cap: refuse typed rather than queue — a queued move
            # would actuate against stale load scores, and the caller
            # (balancer, pool move loop) re-plans from live state anyway.
            self._outcome("paced")
            return {"ok": False, "reason": "paced"}
        self._outbound += 1
        if self.metrics is not None:
            self.metrics["inflight"].add(1)
            self.metrics["outbound_inflight"].set(self._outbound)
        begun = False
        trace: TraceContext | None = None
        mspan = tracing.NOOP_SPAN
        try:
            # -- phase: streaming -------------------------------------------
            victim = self._chaos_victim("streaming")
            if victim is not None:
                raise MigrationError(f"chaos:streaming:{victim}")
            res = await eng.run_on_engine_thread(
                lambda: eng.migration_begin(request_id)
            )
            if res.get("error"):
                self._outcome("noop")
                return {"ok": False, "reason": res["error"]}
            begun = True
            handle = res["handle"]
            # Join the CLIENT REQUEST's trace, not a coordinator-local
            # root: the engine stamps every running sequence with its
            # traceparent at submit and hands it back from
            # migration_begin, so the source's admin RPCs and the
            # destination's pull all stitch into the original tree.
            if res.get("traceparent"):
                with contextlib.suppress(Exception):
                    trace = TraceContext.parse(str(res["traceparent"]))
            mspan = tracing.start_span_if(
                trace, "migration.out",
                request_id=request_id, dest=str(dest_instance),
            )
            if mspan.recording:
                trace = mspan.trace_context()
            start_payload = {
                "cmd": "migrate_in_start",
                "handle": handle,
                "source_component": self.component,
                "source_instance": self.source_instance,
            }
            if trace is not None:
                start_payload["traceparent"] = trace.traceparent()
            await self._admin(dest_instance, start_payload, trace=trace)
            await self._await_caught_up(request_id)

            # -- phase: cutover ---------------------------------------------
            victim = self._chaos_victim("cutover", trace)
            if victim == "source":
                raise MigrationError("chaos:cutover:source")
            cut = await eng.run_on_engine_thread(
                lambda: eng.migration_cutover(request_id)
            )
            if cut.get("error"):
                if cut["error"] == "done":
                    # The force-drain finished the sequence in place —
                    # the client has its complete stream; nothing to move.
                    begun = False
                    self._outcome("noop")
                    mspan.set_attrs(outcome="finished")
                    mspan.end()
                    return {"ok": False, "reason": "finished"}
                raise MigrationError(f"cutover:{cut['error']}")
            t_freeze = time.monotonic()
            if victim is not None and victim != "source":
                # dest/store died mid-cutover: the commit can never
                # confirm — unfreeze and decode on.
                raise MigrationError(f"chaos:cutover:{victim}")
            ack = await self._admin(dest_instance, {
                "cmd": "migrate_in_commit",
                "handle": handle,
                "kv_blocks": cut["kv_blocks"],
            }, trace=trace)
            gap = time.monotonic() - t_freeze

            # -- phase: rebind ----------------------------------------------
            rebind = True
            victim = self._chaos_victim("rebind", trace)
            if victim == "source":
                # Source dying here would truncate the client stream —
                # the Migration operator's re-dispatch completes it. The
                # injected stand-in keeps the sequence alive locally
                # (same client outcome, no stream cut to engineer).
                raise MigrationError("chaos:rebind:source")
            if victim == "store":
                # No decision-cache write against a dead store: the
                # destination pin rides the request itself.
                rebind = False
            if victim == "dest":
                # Destination died after committing: its staged inject
                # is gone, but the resume identity rides the request —
                # the pinned leg falls through to any live worker and
                # re-prefills, still byte-identical.
                with contextlib.suppress(MigrationError):
                    await self._admin(dest_instance, {
                        "cmd": "migrate_in_abort", "handle": handle,
                    }, trace=trace)
            marker: dict[str, Any] = {
                "handle": handle,
                "dest_instance": dest_instance,
                "request": cut["request"],
            }
            if not rebind:
                marker["rebind"] = False
            fin = await eng.run_on_engine_thread(
                lambda: eng.migration_finish(request_id, marker)
            )
            if fin.get("error"):
                # The freeze deadline (or a racing finish) already tore
                # the migration down — the sequence is decoding locally.
                raise MigrationError(f"finish:{fin['error']}")
            if self.metrics is not None:
                self.metrics["cutover_gap"].observe(gap)
            mspan.set_attrs(outcome="ok", kv_blocks=cut["kv_blocks"],
                            cutover_gap_ms=round(gap * 1e3, 3))
            mspan.end()
            self._outcome("ok")
            log.info(
                "migrated %s → %x (%d KV blocks, cutover gap %.1f ms)",
                request_id, dest_instance, cut["kv_blocks"], gap * 1e3,
            )
            return {"ok": True, "handle": handle,
                    "kv_blocks": cut["kv_blocks"],
                    "kv_bytes": int(ack.get("total_bytes", 0)),
                    "cutover_gap_s": gap}
        except MigrationError as e:
            reason = str(e)
            mspan.set_attrs(outcome="fallback", reason=reason)
            mspan.end(status="error")
            if begun:
                await eng.run_on_engine_thread(
                    lambda: eng.migration_abort(request_id, reason)
                )
            self._outcome("fallback")
            self._fallback(reason)
            log.warning(
                "migration of %s → %x fell back (%s); decoding in place",
                request_id, dest_instance, reason,
            )
            return {"ok": False, "reason": reason}
        finally:
            mspan.end()  # idempotent — closes the span on surprise exits
            self._outbound -= 1
            if self.metrics is not None:
                self.metrics["inflight"].add(-1)
                self.metrics["outbound_inflight"].set(self._outbound)

    async def _await_caught_up(self, request_id: str) -> None:
        """Poll until the stream cursor trails the KV write head by at
        most ``lag_blocks`` — the cutover delta is then bounded."""
        eng = self.engine
        deadline = time.monotonic() + self.stream_timeout_s
        while True:
            st = await eng.run_on_engine_thread(
                lambda: eng.migration_status(request_id)
            )
            if st.get("error"):
                raise MigrationError(f"stream:{st['error']}")
            if st.get("aborted"):
                raise MigrationError(f"stream:{st['aborted']}")
            if st["written"] - st["published"] <= self.lag_blocks:
                return
            if time.monotonic() >= deadline:
                raise MigrationError("stream_lag")
            await asyncio.sleep(0.01)

    async def _admin(self, instance_id: int, payload: dict,
                     trace: TraceContext | None = None) -> dict:
        """One admin RPC to the destination; transport faults and error
        frames both become the typed MigrationError fallback. ``trace``
        stitches the hop into the migrating request's span tree."""
        last: dict = {}
        try:
            async for frame in self.admin_router.generate(
                dict(payload), Context(trace=trace), instance_id=instance_id
            ):
                if isinstance(frame, dict):
                    last = frame
        except Exception as e:  # noqa: BLE001 — a dead/unreachable destination is an expected fallback, surfaced typed
            raise MigrationError(
                f"dest_rpc:{payload.get('cmd')}:{type(e).__name__}"
            ) from e
        if last.get("error"):
            raise MigrationError(f"dest:{payload.get('cmd')}:{last['error']}")
        return last


class MigrationReceiver:
    """Destination-side: pulls the source's KV chunk stream while the
    source still decodes, then stages the assembled inject payload under
    the migration handle for the resume leg to claim at admission."""

    def __init__(self, rt, namespace: str, chaos=None, metrics: dict | None = None,
                 credit_bytes: int = DEFAULT_CREDIT_BYTES,
                 stall_timeout_s: float = 20.0, window_wait_s: float = 2.0,
                 stage_ttl_s: float = DEFAULT_STAGE_TTL_S,
                 fetch_endpoint: str = "kv_fetch",
                 budget: CreditBudget | None = None):
        self.rt = rt
        self.namespace = namespace
        self.chaos = chaos
        self.metrics = metrics
        self.credit_bytes = credit_bytes
        # Migration pulls ride the BACKGROUND tier of the shared credit
        # budget: each window's credit shrinks while disagg prefill
        # pulls (the priority tier) hold credit, so rebalancing never
        # starves the TTFT-critical plane.
        self.budget = process_credit_budget() if budget is None else budget
        self.stall_timeout_s = stall_timeout_s
        self.window_wait_s = window_wait_s
        self.stage_ttl_s = stage_ttl_s
        self.fetch_endpoint = fetch_endpoint
        self._pulls: dict[str, asyncio.Task] = {}
        self._staged: dict[str, tuple[dict, float]] = {}
        self._routers: dict[str, Any] = {}

    async def _fetch_router(self, component: str):
        router = self._routers.get(component)
        if router is None:
            from dynamo_tpu_torch.runtime.push_router import RouterMode

            router = await (
                self.rt.namespace(self.namespace)
                .component(component)
                .endpoint(self.fetch_endpoint)
                .router(RouterMode.DIRECT)
            )
            self._routers[component] = router
        return router

    async def start_pull(self, handle: str, source_component: str,
                         source_instance: int,
                         traceparent: str | None = None) -> dict:
        """Begin pulling the migration stream in the background (the
        source is still decoding — this overlaps the transfer with the
        remaining generation, the same push-on-ready shape as disagg).
        ``traceparent`` joins the pull's spans to the migrating
        request's trace (the coordinator forwards it from the source
        engine's sequence stamp)."""
        self._reap()
        if handle in self._pulls or handle in self._staged:
            return {"ok": True}
        router = await self._fetch_router(source_component)
        trace: TraceContext | None = None
        if traceparent:
            with contextlib.suppress(Exception):
                trace = TraceContext.parse(str(traceparent))

        def window_call(cursor: int, credit: int, wait_s: float):
            return router.generate(
                {"handle": handle, "stream": True, "cursor": cursor,
                 "credit_bytes": credit, "wait_s": wait_s},
                Context(trace=trace), instance_id=source_instance,
            )

        async def pull():
            # The destination lane's transfer phase: same span name the
            # disagg KV pull records, so the stitched timeline shows
            # migration transfers with identical semantics.
            span = tracing.start_span_if(trace, "transfer.kv_pull",
                                         handle=handle, kind="migration")
            try:
                pulled = await pull_kv_stream(
                    window_call,
                    credit_bytes=self.credit_bytes,
                    stall_timeout_s=self.stall_timeout_s,
                    window_wait_s=self.window_wait_s,
                    budget=self.budget,
                    budget_kind="migration",
                )
            except BaseException:
                span.end(status="error")
                raise
            span.set_attrs(blocks=pulled.num_blocks, bytes=pulled.total_bytes)
            span.end()
            return pulled

        self._pulls[handle] = asyncio.get_running_loop().create_task(pull())
        return {"ok": True}

    async def commit(self, handle: str, kv_blocks: int) -> dict:
        """Cutover confirm: the stream is sealed — finish the pull,
        verify full coverage, and stage the inject. An error answer here
        makes the SOURCE unfreeze and keep the sequence (the commit is
        the migration's point of no return)."""
        task = self._pulls.pop(handle, None)
        if task is None:
            return {"error": f"unknown migration handle {handle!r}"}
        try:
            pulled = await asyncio.wait_for(task, self.stall_timeout_s)
        except asyncio.TimeoutError:
            task.cancel()
            with contextlib.suppress(BaseException):
                await task
            return {"error": "pull_timeout"}
        except Exception as e:  # noqa: BLE001 — any data-plane failure (abort, stall, truncation) answers typed; the source keeps the sequence
            return {"error": f"pull:{type(e).__name__}: {e}"}
        if pulled.num_blocks < int(kv_blocks or 0):
            # A short stream would leave a KV gap at admission — refuse,
            # the source decodes on.
            return {"error": f"short_stream:{pulled.num_blocks}<{kv_blocks}"}
        if self.metrics is not None:
            self.metrics["bytes"].inc(pulled.total_bytes)
        self._staged[handle] = (
            inject_payload_from_chunks(pulled),
            time.monotonic() + self.stage_ttl_s,
        )
        return {"ok": True, "num_blocks": pulled.num_blocks,
                "total_bytes": pulled.total_bytes}

    async def abort(self, handle: str) -> dict:
        task = self._pulls.pop(handle, None)
        if task is not None:
            task.cancel()
            with contextlib.suppress(BaseException):
                await task
        self._staged.pop(handle, None)
        return {"ok": True}

    def take(self, handle: str) -> dict | None:
        """Claim the staged inject for a resume leg at admission (one
        shot). None when unknown/expired — the leg then re-prefills from
        its own tokens, which is correct on any worker."""
        self._reap()
        item = self._staged.pop(handle, None)
        return item[0] if item is not None else None

    def _reap(self) -> None:
        now = time.monotonic()
        for h in [h for h, (_, dl) in self._staged.items() if dl < now]:
            log.warning("staged migration inject %s expired unclaimed", h)
            self._staged.pop(h, None)

    async def close(self) -> None:
        for h in list(self._pulls):
            await self.abort(h)
        self._staged.clear()
