"""Migration operator: mid-stream relocation and fault tolerance.

Reference analogue: ``Migration`` (reference: lib/llm/src/migration.rs:
38-60, docs/architecture/request_migration.md:46-90): sit between the
Backend and the router, accumulate the tokens a worker has emitted, and
keep the client stream alive across worker changes. Two paths share the
loop:

- **re-dispatch fallback** — the stream dies mid-flight (worker crash →
  ``TruncatedStreamError``): re-issue the request to another worker with
  the accumulated tokens appended to the prompt — the new worker prefills
  prompt+generated (prefix cache makes this cheap if blocks were shared)
  and generation continues seamlessly. Bounded by the model card's
  ``migration_limit``.
- **live-migration resume** — the source worker hands the sequence off
  deliberately (planner pool move, retirement, QoS defrag): the engine
  posts a ``{"migration": ...}`` marker frame carrying the full resume
  identity (tokens, sampler seed/step, prompt boundary, adapter, KV
  handle) instead of a finish. The marker is consumed HERE — never
  client-visible — and the next leg is dispatched pinned to the
  destination, which resumes the SAME stream byte-identically. A clean
  handoff does not count against ``migration_limit``.

Token accounting is exactly-once across legs: ``delivered`` accumulates
every token yielded to the client and is NEVER reset, so re-dispatch
budgets always derive from the ORIGINAL request. A leg that dies after
delivering the full ``max_tokens`` budget is semantically complete — the
operator synthesizes the ``length`` finish locally instead of
re-dispatching for ≥1 more token (the old ``max(1, ...)`` floor
over-delivered and double-counted usage).

Pre-stream failures are NOT handled here — the routers already retry
those; this operator owns only the post-first-token window the routers
deliberately re-raise.
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, Operator
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.messaging import TruncatedStreamError

log = get_logger("migration")


class Migration(Operator):
    def __init__(self, inner: AsyncEngine, migration_limit: int = 0):
        super().__init__(inner)
        self.migration_limit = migration_limit
        # Client-side event ledger: resume (clean handoffs followed),
        # redispatch (truncation fallbacks), budget_exhausted (finish
        # synthesized after a full-budget leg died pre-finish-frame).
        self.counts: dict[str, int] = {}
        self._m_events = None

    def bind_metrics(self, registry) -> "Migration":
        """Expose the event ledger as ``migration_client_total{kind}``."""
        self._m_events = registry.counter(
            "migration_client_total",
            "Migration operator client-side events by kind",
        )
        return self

    def _count(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if self._m_events is not None:
            self._m_events.inc(kind=kind)

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        if not isinstance(request, dict):
            stream = self.inner.generate(request, context.child())
            try:
                async for item in stream:
                    yield item
                return
            finally:
                await stream.aclose()

        orig = dict(request)
        orig_prompt = list(orig.get("token_ids") or [])
        orig_stop = dict(orig.get("stop") or {})
        orig_max = orig_stop.get("max_tokens")
        orig_min = orig_stop.get("min_tokens") or 0
        migrations = 0
        delivered: list[int] = []  # every token the CLIENT saw, all legs
        finished = False
        request = orig
        # Client-visible inter-leg gap span (the ledger's migration_freeze
        # / redispatch phases): opened when a leg ends in a handoff marker
        # or a truncation, closed by the NEXT leg's first frame — so its
        # duration is exactly how long the client's stream sat silent.
        gap_span = tracing.NOOP_SPAN
        try:
            while True:
                stream = self.inner.generate(request, context.child())
                marker: dict | None = None
                try:
                    async for raw in stream:
                        if (
                            isinstance(raw, dict)
                            and raw.get("migration") is not None
                            and not raw.get("finish_reason")
                        ):
                            # Live-migration handoff frame: the stream resumes
                            # elsewhere. Consumed here — the client never sees
                            # it. The freeze gap starts NOW (the source posts
                            # the marker as its very last act).
                            marker = raw["migration"]
                            gap_span.end()
                            gap_span = tracing.start_span_if(
                                context.trace, "migration.resume",
                                dest=str(marker.get("dest_instance")),
                                carried_tokens=len(delivered),
                            )
                            continue
                        if isinstance(raw, dict) and (
                            raw.get("token_ids") or raw.get("finish_reason")
                        ):
                            # First frame of a resumed/re-dispatched leg
                            # closes the gap interval.
                            gap_span.end()
                            gap_span = tracing.NOOP_SPAN
                        if isinstance(raw, dict) and raw.get("token_ids"):
                            delivered.extend(raw["token_ids"])
                        if isinstance(raw, dict) and raw.get("finish_reason"):
                            finished = True
                        yield raw
                    if marker is not None and not finished:
                        if orig_max is not None and len(delivered) >= orig_max:
                            # Handoff raced the budget edge: nothing left to
                            # generate — complete locally instead of resuming.
                            self._count("budget_exhausted")
                            yield {"token_ids": [], "finish_reason": "length"}
                            return
                        migrated_to = marker.get("dest_instance")
                        log.info(
                            "live handoff for %s → instance %s (%d tokens carried)",
                            context.id, migrated_to, len(delivered),
                        )
                        request = self._resume_request(orig, marker, orig_prompt,
                                                       orig_stop, delivered)
                        self._count("resume")
                        continue
                    return
                except TruncatedStreamError:
                    if finished:
                        # The worker died between the last payload (which carried
                        # a finish_reason) and the final bookkeeping frame: the
                        # generation is semantically complete. Re-dispatching
                        # would append tokens past the client's budget.
                        return
                    if orig_max is not None and len(delivered) >= orig_max:
                        # The leg delivered its entire budget, then died before
                        # the finish frame. Exactly-once accounting: synthesize
                        # the finish instead of re-dispatching — a retry leg
                        # would emit (and the ledger would bill) extra tokens.
                        self._count("budget_exhausted")
                        yield {"token_ids": [], "finish_reason": "length"}
                        return
                    if migrations >= self.migration_limit or context.cancelled:
                        raise
                    # A request that can't finish shouldn't migrate: re-dispatch
                    # means re-prefilling prompt+carried tokens on a new worker,
                    # pure waste if the deadline already passed (and the typed
                    # deadline error beats a truncation error for the client).
                    context.check_deadline()
                    migrations += 1
                    # Gap span: truncation detected → retry leg's first frame.
                    # Attrs carry the re-dispatch arithmetic for the timeline;
                    # the ledger bills the duration as the redispatch phase.
                    gap_span.end()
                    gap_span = tracing.start_span_if(
                        context.trace, "migration.redispatch",
                        migration=migrations, limit=self.migration_limit,
                        carried_tokens=len(delivered),
                    )
                    log.warning(
                        "stream died mid-flight for %s; migrating (%d/%d, %d tokens carried)",
                        context.id, migrations, self.migration_limit, len(delivered),
                    )
                    request = self._redispatch_request(orig, orig_prompt, orig_stop,
                                                       delivered)
                    self._count("redispatch")
                    continue
                finally:
                    await stream.aclose()
        finally:
            # A gap that never saw its next leg (error, cancellation) still
            # records — truncated at teardown rather than lost.
            gap_span.end(status=None if finished else "cancelled")

    # -- next-leg request builders ------------------------------------------
    #
    # Both derive budgets from the ORIGINAL stop conditions minus the
    # cross-leg delivered count — never from the previous leg's (already
    # shrunk) budget — so token accounting is exact however many legs run.

    @staticmethod
    def _resume_request(orig: dict, marker: dict, orig_prompt: list[int],
                        orig_stop: dict, delivered: list[int]) -> dict:
        """Leg request following a clean handoff marker: full identity
        (seed/step/prompt boundary/adapter) rides ``kv_transfer_params``
        and the router pins the first attempt to the destination."""
        mreq = (marker.get("request") or {})
        resume = dict(mreq.get("resume") or {})
        # Our own ledger is the source of truth for what the client saw;
        # the prompt boundary stays the ORIGINAL prompt however many legs
        # ran (penalty window + grammar replay both key off it).
        resume["prompt_len"] = len(orig_prompt)
        req = dict(orig)
        req["token_ids"] = orig_prompt + delivered
        stop = dict(orig_stop)
        if orig_stop.get("max_tokens") is not None:
            stop["max_tokens"] = max(1, orig_stop["max_tokens"] - len(delivered))
        if orig_stop.get("min_tokens"):
            stop["min_tokens"] = max(0, orig_stop["min_tokens"] - len(delivered))
        req["stop"] = stop
        ktp = dict(orig.get("kv_transfer_params") or {})
        ktp["resume"] = resume
        pin = {
            "handle": marker.get("handle"),
            "instance": marker.get("dest_instance"),
        }
        if marker.get("rebind") is False:
            pin["rebind"] = False
        ktp["migration_resume"] = pin
        req["kv_transfer_params"] = ktp
        return req

    @staticmethod
    def _redispatch_request(orig: dict, orig_prompt: list[int],
                            orig_stop: dict, delivered: list[int]) -> dict:
        """Leg request after a truncation: generated tokens become part of
        the prompt; the generation budget (max AND min) shrinks by what
        was already delivered so the client-requested lengths hold."""
        req = dict(orig)
        req["token_ids"] = orig_prompt + delivered
        stop = dict(orig_stop)
        if orig_stop.get("max_tokens") is not None:
            stop["max_tokens"] = max(1, orig_stop["max_tokens"] - len(delivered))
        if orig_stop.get("min_tokens"):
            stop["min_tokens"] = max(0, orig_stop["min_tokens"] - len(delivered))
        req["stop"] = stop
        # Seeded sampling: the new worker's emission index restarts at 0,
        # so fold the carried-token count into the seed — the continuation
        # draws fresh noise instead of replaying the gumbel indices the
        # dead worker already consumed. (A truncation-migrated seeded
        # stream is a fresh draw, not a bitwise continuation — same stance
        # as engine restart. Clean handoffs, by contrast, continue the
        # exact seed/step in _resume_request.)
        sampling = dict(orig.get("sampling") or {})
        if sampling.get("seed") is not None:
            sampling["seed"] = (
                int(sampling["seed"]) + 0x9E3779B1 * len(delivered)
            ) & 0x7FFFFFFF
            req["sampling"] = sampling
        # Strip any previous handoff's pin/identity; keep only the prompt
        # boundary so penalties and grammar replay still see carried
        # tokens as GENERATED on the retry worker.
        ktp = dict(orig.get("kv_transfer_params") or {})
        ktp.pop("resume", None)
        ktp.pop("migration_resume", None)
        if delivered:
            ktp["resume"] = {"prompt_len": len(orig_prompt)}
        if ktp:
            req["kv_transfer_params"] = ktp
        return req
