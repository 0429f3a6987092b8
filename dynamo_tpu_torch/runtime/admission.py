"""Admission control: bounded in-flight gate with load shedding, drain,
and (optionally) weighted fair shares across QoS classes.

Under overload the reference stack's HTTP ingress keeps accepting work and
queues it into the routers, so latency grows without bound; a production
frontend must shed instead (429/503 + ``Retry-After``) and must stop
admitting — while finishing in-flight streams — on SIGTERM.

One :class:`AdmissionController` fronts the HTTP service; the worker-side
analogue is the per-subject ``max_inflight`` gate in
:class:`~dynamo_tpu_torch.runtime.messaging.EndpointServer`, which refuses with a
typed ``overloaded`` error the router retries on another instance.

With a :class:`~dynamo_tpu_torch.runtime.qos.QosPolicy` installed the gate
becomes multi-tenant aware:

- waiters queue **per class** and freed slots are handed out by
  **weighted deficit round-robin** (each replenish round credits every
  class-with-demand its weight; a credit buys one admission; classes are
  scanned most-urgent-first within a round) — work-conserving by
  construction (an empty interactive queue means its share flows to
  batch) and starvation-free (batch always holds ≥ its weight share of
  freed slots), with an **aging bonus** credit for any class whose head
  waiter has outwaited ``aging_s``;
- a Mooncake-style **early-rejection** predictor (arXiv 2407.00079) is
  consulted before a request is queued: when the predicted TTFT already
  violates the class SLO, the request 429s at the door — before prefill
  spends chips — with a load-scaled ``Retry-After``;
- per-class **caps** (``set_class_caps``) bound each class's admitted
  count independently — the fleet's per-class budget pools drive these
  from store chunk leases, so fleet-wide per-class caps hold by
  construction (borrowing happens at the budget layer, never here).

Without a policy every request lands in the single default class and
all of the above degenerates to the strict-FIFO single-queue gate this
module always was — byte-identical behavior for no-QoS deployments.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import time

from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.qos import DEFAULT_CLASS, QosPolicy

log = get_logger("admission")

# Exponential weight for the inter-release interval EMA (the observed
# drain-rate signal behind load-scaled Retry-After and the predictor's
# queue-wait estimate).
_DRAIN_EMA_ALPHA = 0.2


class AdmissionRejected(Exception):
    """Request shed at the admission gate."""

    def __init__(
        self,
        message: str,
        retry_after: float,
        draining: bool = False,
        reason: str | None = None,
        qos: str = DEFAULT_CLASS,
    ):
        super().__init__(message)
        self.retry_after = retry_after
        # Draining maps to 503 (instance going away); overload maps to 429
        # (client should slow down and retry the same fleet).
        self.draining = draining
        # Why: "capacity" (queue full), "queue_timeout" (waited out the
        # bound), "slo_predicted" (early rejection), "draining".
        self.reason = reason or ("draining" if draining else "capacity")
        self.qos = qos


class _Waiter:
    __slots__ = ("fut", "qos", "t_enq")

    def __init__(self, fut: asyncio.Future, qos: str, t_enq: float):
        self.fut = fut
        self.qos = qos
        self.t_enq = t_enq


class AdmissionController:
    """Counting gate: at most ``max_inflight`` admitted, at most
    ``max_queue_depth`` more waiting for a slot; everything beyond that is
    rejected immediately. ``max_inflight=0`` disables the bound but still
    tracks in-flight count so draining works.

    Freed slots are handed to queued waiters by ``release()`` itself (the
    waiter's future is resolved with the slot already assigned) — new
    arrivals can neither barge past same-or-higher-class waiters via the
    fast path nor race a wakeup, so no waiter can be starved. Without a
    QoS policy there is one class and the hand-off is strict FIFO.

    Subclasses with externally-leased capacity (the fleet's
    ``BudgetedAdmissionController``) set ``allow_unbounded = False`` so
    ``max_inflight == 0`` means *no slots leased yet* (queue and wait)
    rather than "unlimited", and drive the limit via ``set_limit`` /
    ``set_class_caps``."""

    allow_unbounded = True

    def __init__(
        self,
        max_inflight: int = 0,
        max_queue_depth: int = 0,
        retry_after: float = 1.0,
        queue_timeout: float = 5.0,
        qos: QosPolicy | None = None,
        predictor=None,
    ):
        self.max_inflight = max_inflight
        self.max_queue_depth = max_queue_depth
        self.retry_after = retry_after
        # Bound on how long a queued request waits for a slot before being
        # shed anyway — a queued wait must never become a hang.
        self.queue_timeout = queue_timeout
        self.qos = qos
        # TtftPredictor (runtime/qos.py) or None; consulted only for
        # requests that would QUEUE (an idle gate never predicts), so the
        # no-load path is untouched.
        self.predictor = predictor
        # callable(cls, predicted_seconds) | None — metrics hook the HTTP
        # layer installs (admission_predicted_ttft_seconds).
        self.predict_observer = None
        # SloBurnTracker | None — the SLO attribution plane's read seam
        # (runtime/slo.py, installed by the HTTP layer): when a class's
        # TTFT attainment EMA has slipped, early rejection tightens.
        self.burn = None
        self._inflight = 0
        self._inflight_by: collections.Counter = collections.Counter()
        self._class_caps: dict[str, int] | None = None
        self._draining = False
        self._idle = asyncio.Event()
        self._idle.set()
        # Per-class waiter queues (FIFO within a class). Without a policy
        # only DEFAULT_CLASS ever appears and WDRR reduces to plain FIFO.
        self._queues: dict[str, collections.deque[_Waiter]] = {}
        # WDRR deficit credits per class (fairness memory across
        # hand-off bursts; bounded so an idle spell can't bank a burst).
        self._deficit: collections.Counter = collections.Counter()
        # Observed drain rate: EMA of seconds between releases — feeds
        # load-scaled Retry-After and the predictor's queue-wait term.
        self._release_iv_ema = 0.0
        self._t_last_release: float | None = None
        self._last_release_busy = False
        # Shed accounting per (class, reason) — surfaced via stats() on
        # the /debug/admission + /fleet surfaces.
        self.shed_counts: collections.Counter = collections.Counter()
        self.admitted_counts: collections.Counter = collections.Counter()

    # -- introspection -----------------------------------------------------

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queued(self) -> int:
        return sum(
            1 for q in self._queues.values() for w in q if not w.fut.done()
        )

    def queued_in(self, cls: str) -> int:
        q = self._queues.get(cls)
        return sum(1 for w in q if not w.fut.done()) if q else 0

    def inflight_in(self, cls: str) -> int:
        return self._inflight_by.get(cls, 0)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drain_interval_s(self) -> float:
        """EMA of seconds between releases (0 = nothing observed yet)."""
        return self._release_iv_ema

    def _order(self) -> list[str]:
        if self.qos is not None:
            return self.qos.order
        return [DEFAULT_CLASS]

    def _rank(self, cls: str) -> int:
        return self.qos.rank(cls) if self.qos is not None else 0

    def _resolve(self, priority: str | None) -> str:
        if self.qos is None:
            return DEFAULT_CLASS
        try:
            return self.qos.resolve(priority)
        except ValueError:
            # The HTTP layer is the validation boundary (typed 400s);
            # the gate itself never crashes on a stale wire value.
            return self.qos.default

    def _queued_ahead(self, cls: str) -> int:
        """Waiters that would drain before a new ``cls`` arrival: every
        queued request in a same-or-higher-rank class. (Lower classes
        still receive their WDRR share, so this is a mild overestimate
        of urgency-ordered position — conservative for prediction.)"""
        if self.qos is None:
            return self.queued
        rank = self._rank(cls)
        return sum(
            self.queued_in(c) for c in self._queues if self._rank(c) >= rank
        )

    def retry_after_for(self, cls: str | None = None) -> float:
        """Load-scaled Retry-After seconds: base + the expected wait for
        this class's next slot from the measured drain rate, so 429
        backoff actually tracks load instead of advertising a constant.
        Falls back to scaling by queue/capacity before any release has
        been observed; clamped to [base, 60]."""
        ahead = self._queued_ahead(cls) if cls is not None else self.queued
        if self._release_iv_ema > 0.0:
            est = ahead * self._release_iv_ema
        elif self.max_inflight > 0:
            est = self.retry_after * (ahead / self.max_inflight)
        else:
            est = 0.0
        return min(60.0, self.retry_after + est)

    def stats(self) -> dict:
        """Per-class gate state for the /debug/admission + /fleet
        surfaces: queued/inflight/retry_after plus shed counts by
        reason."""
        classes = self._order()
        out: dict = {
            "draining": self._draining,
            # The observed drain-rate EMA — the autoscaler's queue-term
            # input (docs/autoscaler.md): the operator scrapes it off
            # /debug/admission alongside the /metrics deltas.
            "drain_interval_s": round(self._release_iv_ema, 6),
            "classes": {},
        }
        for c in classes:
            sheds = {
                reason: n
                for (cc, reason), n in self.shed_counts.items()
                if cc == c
            }
            out["classes"][c] = {
                "queued": self.queued_in(c),
                "inflight": self.inflight_in(c),
                "admitted_total": self.admitted_counts.get(c, 0),
                "retry_after": round(self.retry_after_for(c), 3),
                "shed": sheds,
            }
        return out

    # -- admission ---------------------------------------------------------

    async def acquire(self, priority: str | None = None) -> str:
        """Admit one request or raise :class:`AdmissionRejected`.
        → the charge class to pass back to :meth:`release`.

        Over-limit requests wait for a slot only while queue headroom
        exists; the queue bound is what keeps shedding O(1) — a shed
        response costs nothing, a queued one holds memory and latency.
        """
        cls = self._resolve(priority)
        if self._draining:
            raise AdmissionRejected(
                "service is draining", self.retry_after, draining=True, qos=cls
            )
        charge = self._try_admit_now(cls)
        if charge is not None:
            return charge
        # The request would queue: this is the Mooncake early-rejection
        # point — shed NOW if the predicted TTFT already violates the
        # class SLO, before any prefill work is committed.
        self._maybe_early_reject(cls)
        if self.queued >= self.max_queue_depth:
            self._shed(cls, "capacity")
            raise AdmissionRejected(
                f"at capacity ({self._inflight} in flight, {self.queued} queued)",
                self.retry_after_for(cls),
                reason="capacity",
                qos=cls,
            )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        waiter = _Waiter(fut, cls, time.monotonic())
        self._queues.setdefault(cls, collections.deque()).append(waiter)
        try:
            # Resolution ⇒ the slot was already assigned by release()/
            # _hand_off (or a draining rejection was set); the result is
            # the charge class.
            return await asyncio.wait_for(fut, self.queue_timeout)
        except asyncio.TimeoutError:
            # Queued past the bound: shed — a wait must never become a hang.
            # (wait_for only times out if the future is still unresolved, so
            # no slot was assigned.)
            self._discard(waiter)
            self._shed(cls, "queue_timeout")
            raise AdmissionRejected(
                f"queued {self.queue_timeout:.0f}s without a slot",
                self.retry_after_for(cls),
                reason="queue_timeout",
                qos=cls,
            ) from None
        except asyncio.CancelledError:
            # The waiter's own task was cancelled (client disconnected while
            # queued). If _hand_off already assigned us the slot, give it
            # back — otherwise inflight leaks one unit per occurrence and
            # capacity shrinks until everything is shed (semaphore-style
            # cancellation safety).
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                # dyntpu: allow[DT002] reason=result() on a provably-done future (fut.done() checked on the line above) returns immediately
                self.release(fut.result())
            else:
                self._discard(waiter)
            raise

    def _discard(self, waiter: _Waiter) -> None:
        q = self._queues.get(waiter.qos)
        if q is not None:
            with contextlib.suppress(ValueError):
                q.remove(waiter)

    def _shed(self, cls: str, reason: str) -> None:
        self.shed_counts[(cls, reason)] += 1

    # Burn-aware tightening: attainment EMA below this target shrinks the
    # effective SLO budget proportionally (floored so a bad spell can't
    # collapse the gate to rejecting everything).
    BURN_TIGHTEN_BELOW = 0.9
    BURN_MIN_SLO_SCALE = 0.25

    def _maybe_early_reject(self, cls: str) -> None:
        if self.predictor is None or self.qos is None:
            return
        slo = self.qos.ttft_slo(cls)
        if slo <= 0:
            return
        # SLO attribution read seam: if this class is already missing its
        # TTFT target (attainment EMA from the ledger-fed burn tracker),
        # compare the prediction against a shrunken budget — admitting
        # more borderline work while budget is burning only digs deeper.
        if self.burn is not None:
            att = self.burn.attainment(cls, "ttft")
            if att is not None and att < self.BURN_TIGHTEN_BELOW:
                slo *= max(att / self.BURN_TIGHTEN_BELOW, self.BURN_MIN_SLO_SCALE)
        pred = self.predictor.predict(self._queued_ahead(cls), self._release_iv_ema)
        if pred is None:
            return
        if self.predict_observer is not None:
            self.predict_observer(cls, pred)
        if pred > slo:
            self._shed(cls, "slo_predicted")
            raise AdmissionRejected(
                f"predicted TTFT {pred:.2f}s exceeds the {cls} SLO {slo:.2f}s",
                self.retry_after_for(cls),
                reason="slo_predicted",
                qos=cls,
            )

    def _try_admit_now(self, cls: str) -> str | None:
        """Fast path: admit immediately when capacity exists and no
        waiter that could use this request's capacity is queued ahead of
        it. Shared pool: any same-or-higher-class waiter blocks
        (overtaking strictly-lower classes is what priority means;
        overtaking the own-class queue would break FIFO). Per-class
        caps: capacity is DISJOINT, so only the own-class queue blocks —
        a higher class queued on its own exhausted cap must not pin
        another class's idle capacity."""
        if self._class_caps is not None:
            if self.queued_in(cls):
                return None
        else:
            rank = self._rank(cls)
            for c in self._queues:
                if self._rank(c) >= rank and self.queued_in(c):
                    return None
        charge = self._charge_for(cls)
        if charge is None:
            return None
        self._admit(charge)
        return charge

    def _charge_for(self, cls: str) -> str | None:
        """→ the class to charge an admission of ``cls`` against, or
        None when no capacity is available for it right now."""
        if self._class_caps is not None:
            if self._inflight_by.get(cls, 0) < self._class_caps.get(cls, 0):
                return cls
            return None
        if self.max_inflight <= 0:
            return cls if self.allow_unbounded else None
        return cls if self._inflight < self.max_inflight else None

    def _admit(self, charge: str) -> None:
        self._inflight += 1
        self._inflight_by[charge] += 1
        self.admitted_counts[charge] += 1
        self._idle.clear()

    def release(self, qos: str = DEFAULT_CLASS) -> None:
        """Return one slot. ``qos`` must be the class :meth:`acquire`
        returned (per-class cap accounting); legacy single-class callers
        omit it."""
        self._inflight -= 1
        if self._inflight_by.get(qos, 0) > 0:
            self._inflight_by[qos] -= 1
        now = time.monotonic()
        # Only intervals measured UNDER PRESSURE inform the drain
        # signal: an idle gap between bursts is not a drain rate, and
        # folding one in would make the predictor 429 the next burst's
        # head (and inflate Retry-After) for a dozen releases while the
        # EMA decays. Pressure must hold at BOTH endpoints — the first
        # pressured release after an idle spell still spans the gap.
        busy = self.queued > 0
        if busy and self._last_release_busy and self._t_last_release is not None:
            iv = now - self._t_last_release
            self._release_iv_ema = (
                iv
                if self._release_iv_ema == 0.0
                else (1 - _DRAIN_EMA_ALPHA) * self._release_iv_ema
                + _DRAIN_EMA_ALPHA * iv
            )
        self._last_release_busy = busy
        self._t_last_release = now
        self._hand_off()
        if self._inflight == 0:
            self._idle.set()

    # -- weighted deficit round-robin hand-off ----------------------------

    def _eligible(self) -> list[str]:
        """Classes with a live waiter AND available capacity, in drain
        order (most urgent first). Settled futures at queue heads are
        dropped here; a class whose queue empties forfeits its banked
        deficit (standard DRR: credit is demand-contingent)."""
        out = []
        for c in self._order():
            q = self._queues.get(c)
            if not q:
                self._deficit.pop(c, None)
                continue
            while q and q[0].fut.done():
                q.popleft()
            if not q:
                self._deficit.pop(c, None)
                continue
            if self._charge_for(c) is not None:
                out.append(c)
        return out

    def _hand_off(self) -> None:
        """Assign freed capacity to queued waiters: strict FIFO within a
        class, weighted deficit round-robin across classes. One class
        (the no-QoS deployment) reduces to the pre-QoS FIFO hand-off."""
        while True:
            elig = self._eligible()
            if not elig:
                return
            if self.qos is None or len(self._queues) == 1:
                cls = elig[0]
            else:
                cls = next((c for c in elig if self._deficit[c] >= 1.0), None)
                if cls is None:
                    # Replenish round: every eligible class earns its
                    # weight, plus one aging bonus credit when its head
                    # waiter has outwaited aging_s (weights bound
                    # shares; aging bounds waits).
                    now = time.monotonic()
                    for c in elig:
                        w = float(self.qos.weight(c))
                        head = self._queues[c][0]
                        if (
                            self.qos.aging_s > 0
                            and now - head.t_enq >= self.qos.aging_s
                        ):
                            w += 1.0
                        # Bounded banking: an idle spell must not let one
                        # class burst far past its share later.
                        self._deficit[c] = min(
                            self._deficit[c] + w, 4.0 * self.qos.weight(c) + 1.0
                        )
                    cls = next(c for c in elig if self._deficit[c] >= 1.0)
                self._deficit[cls] -= 1.0
            waiter = self._queues[cls].popleft()
            charge = self._charge_for(cls)
            if charge is None:  # raced a cap change; requeue at the head
                self._queues[cls].appendleft(waiter)
                return
            self._admit(charge)  # on the waiter's behalf, before it wakes
            waiter.fut.set_result(charge)

    # -- capacity / lifecycle ----------------------------------------------

    def set_limit(self, max_inflight: int) -> None:
        """Adjust capacity at runtime (budget lease grew or shrank). A
        raised limit hands the new slots to queued waiters immediately;
        a lowered one simply stops further admissions — in-flight
        requests above the new bound run to completion."""
        self.max_inflight = max_inflight
        self._hand_off()

    def set_class_caps(self, caps: dict[str, int]) -> None:
        """Per-class admitted bounds (fleet: driven by the per-class
        budget pools' chunk leases). ``max_inflight`` becomes their sum;
        a class above its new cap runs down by attrition."""
        self._class_caps = dict(caps)
        self.max_inflight = sum(caps.values())
        self._hand_off()

    def start_draining(self) -> None:
        """Refuse all new admissions from now on (SIGTERM path); queued
        waiters are rejected immediately."""
        self._draining = True
        for cls, q in self._queues.items():
            while q:
                waiter = q.popleft()
                if not waiter.fut.done():
                    waiter.fut.set_exception(
                        AdmissionRejected(
                            "service is draining",
                            self.retry_after,
                            draining=True,
                            qos=cls,
                        )
                    )

    async def wait_idle(self, timeout: float | None = None) -> bool:
        """Wait for in-flight requests to finish. → True if fully drained."""
        if timeout is None:
            await self._idle.wait()
            return True
        try:
            await asyncio.wait_for(self._idle.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False
