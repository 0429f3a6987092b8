"""Instance-selecting router with fault detection and retry hygiene.

Reference analogue: ``PushRouter`` with RoundRobin/Random/Direct modes and
``generate_with_fault_detection`` — a worker that answers "no responders" or
truncates its stream before any payload is marked down and the request
retried on another instance (reference: lib/runtime/src/pipeline/network/
egress/push_router.rs:61-75,168-201).

Retry hygiene on top of the reference behaviour:

- attempts are separated by jittered exponential backoff (never a hot
  loop into a dying fleet), bounded by the request deadline;
- an empty instance set is not instant failure — discovery may be
  mid-churn (rolling restart), so the router waits briefly for the watch
  to repopulate and retries within the same attempt budget;
- a worker that refuses at its admission gate (``OverloadedError``) is
  retried elsewhere but NOT circuit-broken — it is alive, just busy;
- a successful stream reports the instance up, closing its breaker.

Once payload frames have flowed, mid-stream death is *not* retried here —
that is the Migration operator's job (it owns accumulated-token re-dispatch;
see dynamo_tpu/llm/migration.py).
"""

from __future__ import annotations

import asyncio
import random
from enum import Enum
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.client import DiscoveryClient
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.messaging import (
    MessageClient,
    NoHandlerError,
    OverloadedError,
    TruncatedStreamError,
)

log = get_logger("push_router")


class RouterMode(Enum):
    ROUND_ROBIN = "round-robin"
    RANDOM = "random"
    DIRECT = "direct"
    KV = "kv"  # handled by KvPushRouter, which wraps a DIRECT PushRouter


class NoInstancesError(Exception):
    pass


class PushRouter:
    def __init__(
        self,
        discovery: DiscoveryClient,
        messaging: MessageClient,
        mode: RouterMode = RouterMode.ROUND_ROBIN,
        max_attempts: int = 3,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        no_instances_wait: float = 1.0,
        metrics=None,
    ):
        self.discovery = discovery
        self.messaging = messaging
        self.mode = mode
        self.max_attempts = max_attempts
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        # How long one attempt waits for discovery to repopulate when the
        # instance set is empty (watch-driven, returns early on change).
        self.no_instances_wait = no_instances_wait
        self._rr_last = -1
        self.m_retries = (
            metrics.counter(
                "router_retries_total",
                "Routing attempts beyond the first, by endpoint subject",
            )
            if metrics is not None
            else None
        )

    def _pick(self, instance_id: int | None) -> Any:
        instances = self.discovery.available()
        if not instances:
            raise NoInstancesError(
                f"no available instances for {self.discovery.namespace}/"
                f"{self.discovery.component}/{self.discovery.endpoint}"
            )
        if instance_id is not None:
            inst = self.discovery.get(instance_id)
            if inst is None:
                raise NoInstancesError(f"instance {instance_id} not found")
            return inst
        if self.mode == RouterMode.RANDOM:
            return random.choice(instances)
        # Stable round-robin: serve instance ids in sorted order, resuming
        # after the last id actually served. A counter over a re-sorted
        # list skews under membership churn (an id shifting position can
        # be skipped forever); resuming by id guarantees every live
        # instance is visited once per cycle regardless of joins/leaves.
        by_id = sorted(instances, key=lambda i: i.instance_id)
        for inst in by_id:
            if inst.instance_id > self._rr_last:
                break
        else:  # wrapped past the highest id
            inst = by_id[0]
        self._rr_last = inst.instance_id
        return inst

    def _backoff_delay(self, attempt: int) -> float:
        """Jittered exponential backoff before retry ``attempt`` (2-based):
        full jitter in [0.5, 1.5) of base * 2^(attempt-2), capped."""
        delay = min(self.backoff_base * (2 ** (attempt - 2)), self.backoff_max)
        return delay * (0.5 + random.random())

    async def _sleep_backoff_delay(self, delay: float, context: Context) -> None:
        remaining = context.time_remaining()
        if remaining is not None:
            delay = min(delay, max(remaining, 0.0))
        if delay > 0:
            await asyncio.sleep(delay)

    def _breaker_state(self, instance_id: int) -> str:
        breaker_state = getattr(self.discovery, "breaker_state", None)
        return breaker_state(instance_id) if breaker_state is not None else "unknown"

    async def _wait_for_instances(self, context: Context) -> None:
        """Block (bounded) until the discovery set changes — rolling
        restarts leave sub-second windows with zero registered instances,
        which should read as "wait", not "fail"."""
        timeout = self.no_instances_wait
        remaining = context.time_remaining()
        if remaining is not None:
            timeout = min(timeout, max(remaining, 0.0))
        if timeout > 0:
            await self.discovery.wait_changed(self.discovery.version, timeout)

    async def generate(
        self,
        request: Any,
        context: Context,
        instance_id: int | None = None,
    ) -> AsyncIterator[Any]:
        """Route and stream. Yields (instance_id, payload) framing is NOT
        exposed — payloads only; the chosen instance id is recorded in
        ``context.metadata['worker_instance_id']``.

        Raises typed errors: NoInstancesError (fleet empty after retries),
        OverloadedError (every attempt refused at the admission gate),
        DeadlineExceededError (budget ran out — never retried),
        TruncatedStreamError (mid-stream death, Migration's to handle)."""
        attempts = 0
        last_err: Exception | None = None
        while attempts < self.max_attempts:
            attempts += 1
            context.check_deadline()
            backoff = 0.0
            if attempts > 1:
                if self.m_retries is not None:
                    self.m_retries.inc(subject=(
                        f"{self.discovery.namespace}/{self.discovery.component}"
                        f"/{self.discovery.endpoint}"
                    ))
                backoff = self._backoff_delay(attempts)
                await self._sleep_backoff_delay(backoff, context)
                context.check_deadline()
            # Per-attempt span: covers backoff already slept (as attr), the
            # pick, the wire call, and — for the winning attempt — the whole
            # response stream. Retry cause lands in ``status``. Only traced
            # requests record spans: infra calls without a trace context
            # (exporter scrapes, KV event subscriptions) must not feed the
            # phase histograms.
            span = tracing.start_span_if(
                context.trace, "router.attempt",
                attempt=attempts, backoff_s=round(backoff, 6),
            )
            try:
                inst = self._pick(instance_id)
            except NoInstancesError as e:
                # Satellite fix: an empty set on ANY attempt used to escape
                # the retry loop immediately; now it consumes an attempt
                # waiting for the watch to repopulate.
                last_err = e
                span.end(status="error:no_instances")
                if instance_id is not None:
                    raise
                await self._wait_for_instances(context)
                continue
            context.metadata["worker_instance_id"] = inst.instance_id
            span.set_attrs(
                instance=f"{inst.instance_id:x}",
                breaker=self._breaker_state(inst.instance_id),
            )
            sub = context.child()
            if span.recording:
                sub.trace = span.trace_context()
            try:
                stream = await self.messaging.call(
                    inst.address, inst.subject, request, sub
                )
            except (TruncatedStreamError, ConnectionError, OSError) as e:
                log.warning("instance %x unreachable: %s", inst.instance_id, e)
                self.discovery.report_instance_down(inst.instance_id)
                last_err = e
                span.end(status="error:unreachable")
                if instance_id is not None:
                    raise
                continue
            except BaseException:
                span.end(status="error:dispatch")
                raise

            first = True
            try:
                async for item in stream:
                    if first:
                        first = False
                        # Payload flowed — the instance serves traffic;
                        # close its breaker (half-open probe success).
                        self.discovery.report_instance_up(inst.instance_id)
                    yield item
                span.end()
                return
            except NoHandlerError as e:
                # Worker registered but not serving (draining) — mark + retry.
                self.discovery.report_instance_down(inst.instance_id)
                last_err = e
                span.end(status="error:no_handler")
                if instance_id is not None or not first:
                    raise
                continue
            except OverloadedError as e:
                # Admission-gate refusal: the instance is healthy, so no
                # down-marking — back off and try another instance.
                log.debug("instance %x at capacity", inst.instance_id)
                last_err = e
                span.end(status="error:overloaded")
                if instance_id is not None or not first:
                    raise
                continue
            except TruncatedStreamError:
                self.discovery.report_instance_down(inst.instance_id)
                span.end(status="error:truncated")
                if first and instance_id is None:
                    last_err = TruncatedStreamError(f"instance {inst.instance_id:x} died pre-stream")
                    continue
                raise  # mid-stream death: Migration's responsibility
            except asyncio.CancelledError:
                span.end(status="cancelled")
                raise
            except GeneratorExit:
                # Consumer closed the stream: payload flowed ⇒ the attempt
                # served its request (normal post-finish close).
                span.end(status="ok" if not first else "abandoned")
                raise
            except BaseException as e:
                # Mid-stream deadline/StreamError/etc: a failed request must
                # not leave an "ok" route span in its flame.
                span.end(status=f"error:{type(e).__name__}")
                raise
            finally:
                span.end(status="ok" if not first else "abandoned")  # no-op if ended above
                await stream.aclose()
        raise last_err or NoInstancesError("exhausted retries")
