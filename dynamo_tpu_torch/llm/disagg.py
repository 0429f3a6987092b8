"""Disaggregated prefill/decode: handlers + conditional routing decision.

Reference analogue: the vLLM decode-first disagg flow (reference:
components/backends/vllm/src/dynamo/vllm/handlers.py:83-165) and the
conditional disagg router (reference: lib/llm/src/disagg_router.rs:
147-259). The decode worker owns the flow: when a prompt's *local*
prefill work exceeds a threshold, it sends a max_tokens=1 copy of the
request to a prefill worker (round-robin push or the competing-consumer
work queue), and moves the exported KV pages into its own cache as a
materialized prefix hit before decoding.

Two data-plane shapes (``DisaggConfig.stream``):

- **streaming (default)** — push-on-ready over ``dynamo_tpu/transfer``:
  the decode worker mints a stream handle, dispatches the prefill, and
  concurrently pulls KV chunk windows under credit-based flow control
  while the remote prefill is still running (the NIXL-overlap analogue);
  chunks inject incrementally at admission.
- **one-shot (legacy)** — pull the whole payload after prefill finishes.

Failures are observable, never silent: every fallback to local prefill
increments ``disagg_fallback_total{reason}`` (and the in-process
``fallback_reasons`` map), remote successes count in
``disagg_remote_prefill_total``, and a traced request carries a
``disagg.remote_prefill`` span (ledger phase ``remote_prefill``) with
transfer bytes/overlap attributes. Disagg remains an optimization,
never a correctness dependency — any data-plane failure degrades to
aggregated serving with byte-identical output (tests/test_disagg.py).
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.transfer.stream import (
    DEFAULT_CREDIT_BYTES,
    TransferAbortedError,
    TransferError,
    TransferTimeoutError,
    inject_payload_from_chunks,
    process_credit_budget,
    pull_kv_stream,
    serve_kv_window,
)

log = get_logger("disagg")


@dataclass
class DisaggConfig:
    # Remote-prefill when (prompt_len - prefix_hit_len) exceeds this
    # (reference: disagg_router.rs max_local_prefill_length).
    max_local_prefill_length: int = 512
    # Component serving prefill workers.
    prefill_component: str = "prefill"
    prefill_endpoint: str = "generate"
    fetch_endpoint: str = "kv_fetch"
    # Competing-consumer prefill queue (runtime/queue.py; reference:
    # the NATS JetStream prefill queue, transports/nats.rs:345-473).
    queue_name: str = "prefill"
    # How long the decode worker waits for a queued prefill before
    # falling back to local prefill (streaming mode: wait for the CLAIM,
    # after which the stream's own stall timeout takes over).
    queue_timeout_s: float = 60.0
    # KV page stream chunking (transfer.chunk_to_frames / legacy
    # KvPagePayload.to_frames).
    frame_bytes: int = 16 << 20
    # Streaming data plane (dynamo_tpu/transfer): pull KV chunk windows
    # while the remote prefill is still running (push-on-ready). False =
    # legacy one-shot pull after the prefill completes.
    stream: bool = True
    # Receiver-driven flow control: unacked streamed bytes allowed in
    # flight per pull window (each pull acks the previous window).
    credit_bytes: int = DEFAULT_CREDIT_BYTES
    # Max seconds without a single new chunk before the pull falls back
    # (bounds the STALL, not total transfer time — a healthy many-GB
    # stream may legitimately outlast any fixed total budget).
    pull_stall_timeout_s: float = 20.0
    # Server-side wait per pull window before answering kv_more.
    pull_window_wait_s: float = 2.0


def should_prefill_remote(
    prefill_length: int, prefix_hit_length: int, max_local_prefill_length: int
) -> bool:
    """The conditional-disagg decision (reference: disagg_router.rs:
    147-259): remote only when the work the decode worker would do
    locally — prompt minus already-cached prefix — is above threshold."""
    return (prefill_length - prefix_hit_length) > max_local_prefill_length


def register_disagg_metrics(registry):
    """Register the disagg data-plane series on a MetricsRegistry →
    (remote counter, fallback counter, transfer bytes counter, inflight
    gauge, overlap gauge). Shared by the worker (bind_metrics) and the
    DT006 metrics-catalog guard."""
    return (
        registry.counter(
            "disagg_remote_prefill_total",
            "Requests whose prefill ran remotely on the prefill fleet",
        ),
        registry.counter(
            "disagg_fallback_total",
            "Remote-prefill attempts that fell back to local prefill, by reason",
        ),
        registry.counter(
            "disagg_kv_transfer_bytes_total",
            "KV bytes received over the streaming disagg data plane",
        ),
        registry.gauge(
            "disagg_kv_transfer_inflight_bytes",
            "KV bytes of the in-progress streamed pull (0 when idle)",
        ),
        registry.gauge(
            "disagg_kv_transfer_overlap_frac",
            "Fraction of the last streamed transfer's bytes that arrived "
            "while the remote prefill was still running",
        ),
    )


class PrefillHandler:
    """Prefill-worker side: pass-through to the engine plus the
    ``kv_fetch`` endpoint — legacy one-shot payload frames, or (with
    ``stream``) flow-controlled chunk windows against a live
    KvStreamExport while the prefill is still running.

    ``chaos`` (runtime/chaos.py) injects kill-mid-transfer faults
    between streamed chunks — on the wire indistinguishable from the
    prefill worker dying."""

    def __init__(self, engine, frame_bytes: int = 16 << 20, chaos=None):
        self.engine = engine
        self.frame_bytes = frame_bytes
        self.chaos = chaos

    async def generate(self, payload: Any, ctx: Context) -> AsyncIterator[dict]:
        async for item in self.engine.generate(payload, ctx):
            yield item

    async def kv_fetch(self, payload: Any, ctx: Context) -> AsyncIterator[dict]:
        payload = payload or {}
        handle = payload.get("handle", "")
        if not hasattr(self.engine, "get_stream_export"):
            # Control-plane-only deployments (role-managed mocker
            # workers) serve prefill pass-through but have no KV export
            # surface — answer typed so the decode side falls back.
            yield {"error": "engine has no KV export surface"}
            return
        if not payload.get("stream"):
            # Legacy one-shot pull (whole payload after prefill).
            export = self.engine.take_export(handle)
            if export is None:
                yield {"error": f"unknown or expired export handle {handle!r}"}
                return
            for frame in export.to_frames(self.frame_bytes):
                yield frame
            return
        cursor = int(payload.get("cursor") or 0)
        credit = int(payload.get("credit_bytes") or DEFAULT_CREDIT_BYTES)
        wait_s = min(float(payload.get("wait_s") or 2.0), 30.0)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + wait_s
        export = self.engine.get_stream_export(handle)
        while export is None:
            # The prefill may still be queued/admitting — wait (bounded)
            # for the export to register instead of erroring the pull;
            # the consumer's stall deadline owns the give-up decision.
            if loop.time() >= deadline:
                yield {"kind": "kv_more", "cursor": cursor}
                return
            await asyncio.sleep(0.01)
            export = self.engine.get_stream_export(handle)
        eos = False
        async for frame in serve_kv_window(
            export, cursor, credit, deadline - loop.time(),
            self.frame_bytes, chaos=self.chaos,
        ):
            eos = frame.get("kind") == "kv_eos"
            yield frame
        if eos:
            self.engine.release_stream_export(handle)


class PrefillPuller:
    """Competing-consumer prefill loop (reference: the NATS work-queue
    feeding prefill workers, transports/nats.rs:345-473 + docs/
    architecture/disagg_serving.md:62).

    Pops queued prefill jobs, runs them on the local engine, and posts
    to the job's store reply key. A streaming job (the request carries a
    ``stream_handle``) gets an EARLY claim reply — ``{"status":
    "claimed", "instance_id"}`` — the moment it is dequeued, so the
    decode worker starts pulling chunks while the prefill runs; the
    completion reply follows as before. A crashed puller simply never
    replies — the decode side times out into local prefill.
    """

    def __init__(self, engine, queue, store, instance_id: int, lane: str | None = None):
        self.engine = engine
        self.queue = queue
        self.store = store
        self.instance_id = instance_id
        # Trace lane: the puller loop is a long-lived task (it would
        # otherwise inherit whatever lane was current at start()), so it
        # pins its own process/role label for the spans its jobs record.
        self.lane = lane
        self.jobs_done = 0
        self._task = None
        self._busy = False

    def start(self) -> "PrefillPuller":
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            # dyntpu: allow[DT005] reason=stop() awaits its own cancelled task; CancelledError is the expected outcome and a crash that raced the cancel has no caller left to act on it
            except BaseException:  # noqa: BLE001 — cancellation path
                pass

    async def drain(self, timeout_s: float = 30.0) -> None:
        """Graceful stop for live pool moves: let the CURRENT job finish
        (its decode-side consumer is mid-pull — cancelling it would turn
        a clean migration into a fallback) before cancelling the loop.
        Jobs still queued simply stay queued for the remaining prefill
        fleet; past ``timeout_s`` the job is cut anyway (typed fallback
        on the decode side — disagg is never a correctness dependency)."""
        deadline = time.monotonic() + timeout_s
        while self._busy and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        await self.stop()

    async def _loop(self) -> None:
        if self.lane:
            tracing.set_lane(self.lane)
        while True:
            job = await self.queue.dequeue()
            if job is None:
                continue
            # The decode side has already fallen back past its deadline:
            # don't waste a prefill on it (its reply key is gone too).
            expires = job.get("expires_at")
            if expires is not None and time.time() > expires:
                log.info("dropping expired prefill job")
                continue
            try:
                self._busy = True
                await self._run_job(job)
                self.jobs_done += 1
            except Exception:  # noqa: BLE001 — keep consuming; an empty
                # reply unblocks the decode worker immediately instead of
                # making it wait out its full queue timeout.
                log.exception("queued prefill job failed")
                with contextlib.suppress(Exception):
                    await self._reply(job["reply_key"], {"instance_id": self.instance_id})
            finally:
                self._busy = False

    async def _run_job(self, job: dict) -> None:
        req, reply_key = job["req"], job["reply_key"]
        ktp = (req.get("kv_transfer_params") or {}) if isinstance(req, dict) else {}
        if ktp.get("stream_handle"):
            # Claim first: the decode worker can open the chunk pull
            # against this instance before the prefill finishes.
            await self._reply(
                reply_key, {"status": "claimed", "instance_id": self.instance_id}
            )
        # The job rode the store, not the wire — rehydrate the dispatcher's
        # trace context so this worker's engine spans join the request's
        # trace instead of starting an orphan fragment.
        from dynamo_tpu_torch.runtime.logging import TraceContext

        trace = None
        if job.get("traceparent"):
            trace = TraceContext.parse(job["traceparent"], job.get("tracestate"))
        meta = None
        async for item in self.engine.generate(req, Context(trace=trace)):
            if isinstance(item, dict) and item.get("kv_transfer_params"):
                meta = item["kv_transfer_params"]
        reply = {"instance_id": self.instance_id}
        if meta and meta.get("num_blocks"):
            reply["handle"] = meta["remote_handle"]
            reply["num_blocks"] = meta["num_blocks"]
        await self._reply(reply_key, reply)

    async def _reply(self, reply_key: str, reply: dict) -> None:
        from dynamo_tpu_torch.runtime import msgpack_lite as msgpack

        # Lease-attached (instance_id == the worker's lease): an orphaned
        # reply key (decode timed out and stopped watching) dies with this
        # process instead of accumulating in the store.
        await self.store.put(
            reply_key, msgpack.packb(reply, use_bin_type=True),
            lease_id=self.instance_id,
        )


class DisaggDecodeHandler:
    """Decode-worker side: conditional remote prefill in front of the
    local engine. ``prefill_router``/``fetch_router`` are PushRouters on
    the prefill component's generate/kv_fetch endpoints.

    With ``queue``+``store`` set, prefill dispatch goes through the
    competing-consumer work queue instead of round-robin push: free
    prefill workers pull jobs at their own pace (reference:
    docs/architecture/disagg_serving.md:62), and the decode worker
    rendezvouses on a store reply key.

    This handler is wired by DEFAULT on every TPU decode worker
    (worker/__main__ ``--disagg auto``): with no prefill fleet
    discovered it costs one set lookup per long prompt and serves
    aggregated, so disagg is the default serving shape, not a mode."""

    def __init__(self, engine, prefill_router, fetch_router,
                 cfg: DisaggConfig | None = None, queue=None, store=None):
        self.engine = engine
        self.prefill_router = prefill_router
        self.fetch_router = fetch_router
        self.cfg = cfg or DisaggConfig()
        self.queue = queue
        self.store = store
        # Observability: how many requests actually went remote, and why
        # the ones that didn't fell back (mirrored to the registry
        # counters when bind_metrics was called).
        self.remote_prefills = 0
        self.local_fallbacks = 0
        self.fallback_reasons: dict[str, int] = {}
        self.transfer_bytes_total = 0
        self.transfer_overlapped_total = 0
        self.last_transfer: dict = {}
        self._metrics = None
        # Per-pull inflight bytes (keyed by stream handle): concurrent
        # remote prefills each report their own slot; the gauge is the sum.
        self._inflight_pulls: dict[str, int] = {}

    def bind_metrics(self, registry) -> None:
        """Attach the disagg data-plane series (register_disagg_metrics)."""
        self._metrics = register_disagg_metrics(registry)

    def _count_remote(self) -> None:
        if self._metrics is not None:
            self._metrics[0].inc()

    def _count_fallback(self, reason: str) -> None:
        self.fallback_reasons[reason] = self.fallback_reasons.get(reason, 0) + 1
        if self._metrics is not None:
            self._metrics[1].inc(reason=reason)

    def _set_inflight(self, key: str, nbytes: int) -> None:
        if nbytes > 0:
            self._inflight_pulls[key] = nbytes
        else:
            self._inflight_pulls.pop(key, None)
        if self._metrics is not None:
            self._metrics[3].set(sum(self._inflight_pulls.values()))

    def _record_transfer(self, pulled) -> dict:
        """Fold one completed pull into the running totals. → the pull's
        span attributes (returned, not read back off the handler —
        ``last_transfer`` is a concurrently-clobbered informational slot)."""
        self.transfer_bytes_total += pulled.total_bytes
        self.transfer_overlapped_total += pulled.overlapped_bytes
        attrs = {
            "bytes": pulled.total_bytes,
            "chunks": len(pulled.chunks),
            "overlap_frac": round(pulled.overlap_frac, 4),
        }
        self.last_transfer = attrs
        if self._metrics is not None:
            self._metrics[2].inc(pulled.total_bytes)
            self._metrics[4].set(pulled.overlap_frac)
        return attrs

    async def generate(self, payload: Any, ctx: Context) -> AsyncIterator[dict]:
        req = dict(payload) if isinstance(payload, dict) else payload
        if isinstance(req, dict) and self.prefill_router is not None:
            tokens = req.get("token_ids") or []
            plen = len(tokens)
            hit_blocks = req.get("estimated_prefix_hit_num_blocks") or 0
            # Router hint OR the local engine's own prefix cache — a prompt
            # this worker already holds must not round-trip to prefill.
            # Probed in the request's (model, adapter) identity domain:
            # adapter KV is hash-salted, so a base hit never masks an
            # adapter request's real cache state.
            hit_len = max(
                hit_blocks * self.engine.args.block_size,
                self.engine.prefix_hit_length(tokens, req.get("adapter_id")),
            )
            # A peer-fetched prefix (llm/peer_kv.py) already attached as an
            # inject payload counts as cached work too — it covers
            # [0, block_offset*bs + num_tokens) (the offset part is local).
            inject = (req.get("kv_transfer_params") or {}).get("inject")
            if isinstance(inject, dict):
                covered = (
                    int(inject.get("block_offset") or 0) * self.engine.args.block_size
                    + int(inject.get("num_tokens") or 0)
                )
                hit_len = max(hit_len, covered)
            if should_prefill_remote(plen, hit_len, self.cfg.max_local_prefill_length):
                inject, why = await self._remote_prefill(req, ctx)
                if inject is not None:
                    req = dict(req)
                    req["kv_transfer_params"] = {"inject": inject}
                    self.remote_prefills += 1
                    self._count_remote()
                else:
                    self.local_fallbacks += 1
                    self._count_fallback(why or "unknown")
        async for item in self.engine.generate(req, ctx):
            yield item

    async def _remote_prefill(self, req: dict, ctx: Context):
        """Run the prompt on a prefill worker, move its KV pages here.
        → (inject payload dict | None, fallback reason | None). The span
        (ledger phase ``remote_prefill``) carries the outcome either way."""
        span = tracing.start_span_if(
            ctx.trace, "disagg.remote_prefill",
            prompt_tokens=len(req.get("token_ids") or ()),
        )
        # Fail fast on an empty prefill fleet: the default serving shape
        # must cost ~nothing on aggregated-only deployments (no queue
        # timeout, no router retry/backoff budget).
        if not list(self.prefill_router.discovery.available()):
            span.end(status="fallback:no_workers")
            return None, "no_workers"
        preq = dict(req)
        preq["stop"] = {"max_tokens": 1, "ignore_eos": True}
        preq.pop("estimated_prefix_hit_num_blocks", None)
        if self.cfg.stream:
            inject, why, attrs = await self._remote_prefill_stream(preq, ctx)
        else:
            inject, why, attrs = await self._remote_prefill_oneshot(preq, ctx)
        if inject is not None:
            if attrs:
                span.set_attrs(**attrs)
            span.end()
            return inject, None
        span.end(status=f"fallback:{why}")
        return None, why

    # -- streaming data plane (default) -----------------------------------

    async def _remote_prefill_stream(self, preq: dict, ctx: Context):
        """Push-on-ready: dispatch the prefill and pull its KV chunk
        stream concurrently. → (inject | None, reason | None, attrs | None)."""
        handle = f"kvstream-{os.urandom(8).hex()}"
        preq["kv_transfer_params"] = {
            "do_remote_decode": True, "stream_handle": handle,
        }
        if self.queue is not None and self.store is not None:
            try:
                disp = await self._dispatch_stream_queue(preq, ctx)
            except Exception as e:  # noqa: BLE001 — a store/queue fault during dispatch must degrade to local prefill, never fail the request (disagg is not a correctness dependency)
                log.warning("queued prefill dispatch failed (%s); falling back", e)
                return None, "dispatch", None
            if disp is None:
                log.warning("queued prefill was not claimed in time; falling back")
                return None, "queue_timeout", None
        else:
            disp = await self._dispatch_stream_push(preq, ctx)
            if disp is None:
                return None, "dispatch", None
        instance_for, prefill_done, prefill_failed, done_task = disp

        def window_call(cursor: int, credit: int, wait_s: float):
            return self.fetch_router.generate(
                {"handle": handle, "stream": True, "cursor": cursor,
                 "credit_bytes": credit, "wait_s": wait_s},
                Context(trace=ctx.trace), instance_id=instance_for(),
            )

        tspan = tracing.start_span_if(ctx.trace, "transfer.kv_pull", handle=handle)
        ok = False
        try:
            pulled = await pull_kv_stream(
                window_call,
                credit_bytes=self.cfg.credit_bytes,
                stall_timeout_s=self.cfg.pull_stall_timeout_s,
                window_wait_s=self.cfg.pull_window_wait_s,
                prefill_done=prefill_done,
                failed=prefill_failed,
                on_inflight=lambda nbytes: self._set_inflight(handle, nbytes),
                # Priority tier of the shared budget: disagg pulls are on
                # the TTFT critical path, so they always get full credit
                # and background migration pulls pace around them.
                budget=process_credit_budget(),
                budget_kind="disagg",
            )
            ok = True
        except TransferAbortedError as e:
            log.warning("kv stream aborted by publisher (%s); falling back", e)
            tspan.end(status="error:abort")
            return None, "abort", None
        except TransferTimeoutError as e:
            log.warning("kv stream stalled (%s); falling back", e)
            tspan.end(status="error:timeout")
            return None, "timeout", None
        except Exception as e:  # noqa: BLE001 — any data-plane/transport failure (truncation, connection cut, protocol error) degrades to local prefill
            log.warning("kv stream pull failed (%s); falling back", e)
            tspan.end(status="error:transfer")
            return None, "transfer", None
        finally:
            self._set_inflight(handle, 0)
            if ok:
                # The dispatch is done or near-done once the stream
                # sealed; let it settle so the prefill request closes
                # cleanly.
                await self._settle_dispatch(done_task)
            else:
                # Failed pull: abandon the remote prefill immediately —
                # the fallback local prefill must not wait on it.
                await self._cancel_dispatch(done_task)
        if not pulled.chunks:
            tspan.end(status="empty")
            return None, "empty", None  # tiny prompt exported no full block
        attrs = self._record_transfer(pulled)
        tspan.set_attrs(**attrs)
        tspan.end()
        return inject_payload_from_chunks(pulled), None, attrs

    @staticmethod
    async def _settle_dispatch(task: asyncio.Task | None) -> None:
        """Let the prefill dispatch finish, surfacing nothing — the pull
        outcome is authoritative; a post-transfer wire hiccup must not
        fail the request."""
        if task is None:
            return
        try:
            await asyncio.wait_for(asyncio.shield(task), 5.0)
        except Exception:  # noqa: BLE001 — dispatch-side errors after a settled pull are advisory; the KV (or the fallback decision) is already in hand
            task.cancel()
            with contextlib.suppress(BaseException):
                await task

    @staticmethod
    async def _cancel_dispatch(task: asyncio.Task | None) -> None:
        if task is None:
            return
        task.cancel()
        with contextlib.suppress(BaseException):
            await task

    async def _dispatch_stream_push(self, preq: dict, ctx: Context):
        """Round-robin push, consumed in a background task so the pull
        can overlap it. → (instance_for, prefill_done, prefill_failed,
        task) | None."""
        pctx = Context(trace=ctx.trace)

        async def consume() -> bool:
            ok = False
            try:
                async for raw in self.prefill_router.generate(preq, pctx):
                    if isinstance(raw, dict) and raw.get("kv_transfer_params"):
                        ok = True
            except Exception as e:  # noqa: BLE001 — the prefill stream failing shows up as a stream abort/stall on the pull side; log, don't crash the task
                log.warning("remote prefill dispatch failed (%s)", e)
                return False
            return ok

        task = asyncio.get_running_loop().create_task(consume())

        def prefill_failed() -> bool:
            # A prefill that dies BEFORE registering its export never
            # produces kv_abort on the wire — this is the pull's only
            # signal to stop waiting (pull_kv_stream ``failed``).
            if not task.done() or task.cancelled():
                return False
            try:
                return task.result() is not True
            except BaseException:  # noqa: BLE001 — a crashed consume task means the prefill failed
                return True

        # The router records the chosen instance at pick time — before
        # any frame flows — so the pull knows where to go almost
        # immediately; re-read per window (a retry may move instances).
        for _ in range(400):
            if pctx.metadata.get("worker_instance_id") is not None or task.done():
                break
            await asyncio.sleep(0.005)
        if pctx.metadata.get("worker_instance_id") is None:
            task.cancel()
            with contextlib.suppress(BaseException):
                await task
            return None
        return (
            lambda: pctx.metadata.get("worker_instance_id"),
            task.done,
            prefill_failed,
            task,
        )

    async def _dispatch_stream_queue(self, preq: dict, ctx: Context | None = None):
        """Enqueue the job and rendezvous on the CLAIM reply (posted at
        dequeue time, before the prefill runs). → (instance_for,
        prefill_done, prefill_failed, watch task) | None when nothing
        claims in time. A FAILURE reply (non-claimed, no ``num_blocks``
        — the puller's bare unblock reply) raises TransferError: its
        whole point is immediate fallback, not a 20s pull stall against
        an export that will never exist."""
        from dynamo_tpu_torch.runtime import msgpack_lite as msgpack

        reply_key = f"disagg/reply/{os.urandom(8).hex()}"
        job = {
            "req": preq, "reply_key": reply_key,
            "expires_at": time.time() + self.cfg.queue_timeout_s,
        }
        # Store-queued jobs bypass the wire's traceparent header — carry
        # the trace in the job itself so the claiming prefill worker's
        # spans join this request's tree.
        if ctx is not None and ctx.trace is not None:
            job["traceparent"] = ctx.trace.traceparent()
            if ctx.trace.tracestate:
                job["tracestate"] = ctx.trace.tracestate
        job_key = await self.queue.enqueue(job)
        deadline = time.monotonic() + self.cfg.queue_timeout_s
        watch = await self.store.watch_prefix(reply_key)
        claimed: dict | None = None
        done = asyncio.Event()
        failed = asyncio.Event()
        try:
            pending = [
                msgpack.unpackb(e.value, raw=False)
                for e in watch.snapshot
                if e.key == reply_key and e.value is not None
            ]
            while claimed is None:
                for reply in pending:
                    claimed = reply
                    if reply.get("status") != "claimed":
                        if not reply.get("num_blocks"):
                            raise TransferError("prefill job failed")
                        done.set()  # fast completion reply straight away
                    break
                pending = []
                if claimed is not None:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TransferTimeoutError("prefill job unclaimed")
                try:
                    ev = await asyncio.wait_for(watch.__anext__(), remaining)
                except (asyncio.TimeoutError, StopAsyncIteration):
                    raise TransferTimeoutError("prefill job unclaimed") from None
                if ev.key == reply_key and ev.value is not None:
                    pending = [msgpack.unpackb(ev.value, raw=False)]
        except TransferTimeoutError:
            # A degraded store must not leak the watch: delete faults are
            # suppressed so cancel() always runs (replies are written
            # lease-attached, so an orphaned key dies with the prefill
            # worker instead of accumulating).
            with contextlib.suppress(Exception):
                await self.store.delete(job_key)  # unclaimed job: reclaim
            with contextlib.suppress(Exception):
                await watch.cancel()
            with contextlib.suppress(Exception):
                await self.store.delete(reply_key)
            return None
        except Exception:
            await watch.cancel()
            with contextlib.suppress(Exception):
                await self.store.delete(reply_key)
            raise
        instance_id = claimed["instance_id"]
        if done.is_set():
            # A fast prefill's completion overwrote the claim before the
            # watch snapshot — there is nothing left to watch for, and a
            # watcher task here would never terminate (no further event
            # arrives) and stall _settle_dispatch for its full budget.
            await watch.cancel()
            with contextlib.suppress(Exception):
                await self.store.delete(reply_key)
            return (lambda: instance_id), done.is_set, failed.is_set, None

        async def watch_done() -> None:
            try:
                async for ev in watch:
                    if ev.key == reply_key and ev.value is not None:
                        reply = msgpack.unpackb(ev.value, raw=False)
                        if reply.get("status") != "claimed":
                            if not reply.get("num_blocks"):
                                # Mid-pull failure: a prefill that died
                                # before registering its export never
                                # aborts on the wire — fail the pull fast.
                                failed.set()
                            done.set()
                            return
            finally:
                await watch.cancel()
                with contextlib.suppress(Exception):
                    await self.store.delete(reply_key)

        task = asyncio.get_running_loop().create_task(watch_done())
        return (lambda: instance_id), done.is_set, failed.is_set, task

    # -- legacy one-shot pull ---------------------------------------------

    async def _remote_prefill_oneshot(self, preq: dict, ctx: Context):
        """Pull the whole payload after the prefill finishes (pre-
        streaming wire shape, kept for compatibility and as the
        ``stream=False`` escape hatch). → (inject | None, reason,
        attrs | None)."""
        preq["kv_transfer_params"] = {"do_remote_decode": True}
        if self.queue is not None and self.store is not None:
            handle_info, why = await self._dispatch_via_queue(preq, ctx)
        else:
            handle_info = await self._dispatch_via_push(preq, ctx)
            why = "dispatch"
        if handle_info is None:
            return None, why, None
        handle, instance_id = handle_info
        try:
            frames: list[dict] = []
            async for resp in self.fetch_router.generate(
                {"handle": handle}, Context(trace=ctx.trace),
                instance_id=instance_id,
            ):
                frames.append(resp)
            if not frames or frames[0].get("error"):
                log.warning("kv fetch failed: %s",
                            (frames[0] if frames else {}).get("error", "empty"))
                return None, "fetch", None
            if frames[0].get("kind") == "kv_header":
                from dynamo_tpu_torch.engine.kv_transfer import KvPagePayload

                return KvPagePayload.from_frames(frames).to_dict(), None, None
            return frames[-1], None, None  # legacy single-frame payload
        except Exception as e:  # noqa: BLE001 — remote KV reuse is an optimization; ANY fetch failure falls back to local prefill
            log.warning("kv fetch failed (%s); falling back to local", e)
            return None, "fetch", None

    async def _dispatch_via_push(self, preq: dict, ctx: Context):
        """Round-robin push to a prefill worker. → (handle, instance_id)."""
        meta = None
        try:
            pctx = Context(trace=ctx.trace)
            async for raw in self.prefill_router.generate(preq, pctx):
                if isinstance(raw, dict) and raw.get("kv_transfer_params"):
                    meta = raw["kv_transfer_params"]
            instance_id = pctx.metadata.get("worker_instance_id")
        except Exception as e:  # noqa: BLE001 — disagg is best-effort
            log.warning("remote prefill failed (%s); falling back to local", e)
            return None
        if not meta or not meta.get("num_blocks") or instance_id is None:
            return None
        return meta["remote_handle"], instance_id

    async def _dispatch_via_queue(self, preq: dict, ctx: Context | None = None):
        """Enqueue the job, rendezvous on the reply key.
        → ((handle, instance_id) | None, fallback_reason | None) — the
        reason distinguishes a claim timeout from a failed/empty prefill
        job so disagg_fallback_total{reason} stays truthful."""
        from dynamo_tpu_torch.runtime import msgpack_lite as msgpack

        reply_key = f"disagg/reply/{os.urandom(8).hex()}"
        job_key = None
        try:
            job = {
                "req": preq, "reply_key": reply_key,
                "expires_at": time.time() + self.cfg.queue_timeout_s,
            }
            if ctx is not None and ctx.trace is not None:
                job["traceparent"] = ctx.trace.traceparent()
                if ctx.trace.tracestate:
                    job["tracestate"] = ctx.trace.tracestate
            job_key = await self.queue.enqueue(job)
            deadline = time.monotonic() + self.cfg.queue_timeout_s
            watch = await self.store.watch_prefix(reply_key)
            try:
                value = None
                for e in watch.snapshot:
                    if e.key == reply_key:
                        value = e.value
                while value is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        log.warning("queued prefill timed out; falling back to local")
                        await self.store.delete(job_key)  # unclaimed job: reclaim
                        return None, "queue_timeout"
                    try:
                        ev = await asyncio.wait_for(watch.__anext__(), remaining)
                    except (asyncio.TimeoutError, StopAsyncIteration):
                        log.warning("queued prefill timed out; falling back to local")
                        await self.store.delete(job_key)
                        return None, "queue_timeout"
                    if ev.key == reply_key and ev.value is not None:
                        value = ev.value
            finally:
                await watch.cancel()
                await self.store.delete(reply_key)
            reply = msgpack.unpackb(value, raw=False)
            if not reply.get("handle"):
                # prefill ran but exported nothing (tiny prompt)
                return None, "empty"
            return (reply["handle"], reply["instance_id"]), None
        except Exception as e:  # noqa: BLE001 — disagg is best-effort; any queue/transfer failure degrades to aggregated serving
            log.warning("queued prefill failed (%s); falling back to local", e)
            return None, "dispatch"
