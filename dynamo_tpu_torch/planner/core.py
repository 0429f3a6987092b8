"""The planner loop: observe → correct → predict → scale.

Reference analogue: components/planner/src/dynamo/planner/utils/
planner_core.py:189-341. Each ``adjustment_interval``:

1. observe the frontend's metrics (request rate, TTFT, ITL) and the
   live replica count,
2. feed the request rate to a load predictor,
3. compute the replica count that serves the predicted rate — from the
   profiled per-replica capacity, SLA-corrected when interpolators are
   available (ITL over SLA ⇒ effective capacity shrinks),
4. clamp to [min, max] and apply through the connector.

The metrics source and connector are injected, so the same core drives
the real HTTP frontend + subprocess workers and the synthetic-load unit
tests (reference's planner test strategy).

Port of ``dynamo_tpu/planner/core.py``; ``HttpMetricsSource`` reads
/metrics through the standard library in place of httpx.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch.planner.connector import Connector
from dynamo_tpu_torch.planner.interpolate import DecodeInterpolator, PrefillInterpolator
from dynamo_tpu_torch.planner.predictors import make_predictor
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner")


@dataclass
class PlannerObservation:
    request_rate: float = 0.0        # requests/s over the interval
    output_token_rate: float = 0.0   # generated tokens/s over the interval
    input_token_rate: float = 0.0    # prompt tokens/s over the interval
    ttft_ms: float | None = None     # mean over the interval
    itl_ms: float | None = None      # mean over the interval
    # Cold start / no-data marker: True when the source had NO basis for
    # rates this interval (first scrape after a planner restart). A
    # restarted planner must not read "rate 0.0" off its first tick and
    # scale a loaded fleet to min_replicas — empty windows clamp to a
    # no-op decision.
    empty_window: bool = False
    # Admission-gate signals (fed by the operator loop's richer source;
    # zero when unobserved): queued requests and the gate's observed
    # inter-release EMA — the drain-rate half of the decision inputs.
    queue_depth: float = 0.0
    drain_interval_s: float = 0.0

    def sanitize(self) -> "PlannerObservation":
        """Clamp non-finite/negative inputs so no observation can push
        NaN into pool-size math: junk rates → 0 (+ empty_window, since a
        poisoned window carries no information), junk latencies → None."""
        import math as _m

        out = PlannerObservation(
            request_rate=self.request_rate, output_token_rate=self.output_token_rate,
            input_token_rate=self.input_token_rate,
            ttft_ms=self.ttft_ms, itl_ms=self.itl_ms,
            empty_window=self.empty_window,
            queue_depth=self.queue_depth, drain_interval_s=self.drain_interval_s,
        )
        for f in ("request_rate", "output_token_rate", "input_token_rate",
                  "queue_depth", "drain_interval_s"):
            v = getattr(out, f)
            if not _m.isfinite(v) or v < 0.0:
                setattr(out, f, 0.0)
                out.empty_window = True
        for f in ("ttft_ms", "itl_ms"):
            v = getattr(out, f)
            if v is not None and (not _m.isfinite(v) or v < 0.0):
                setattr(out, f, None)
        return out


@dataclass
class PlannerConfig:
    component: str = "backend"
    # Disaggregated deployments scale prefill separately (reference:
    # planner_core.py:241-276 computes prefill and decode replica counts
    # from distinct interpolators). None = aggregated, single component.
    prefill_component: str | None = None
    mean_input_tokens: float = 512.0   # converts request rate → prefill token rate
    prefill_tok_s: float = 8000.0      # per-replica prefill throughput fallback
    adjustment_interval_s: float = 30.0
    predictor: str = "ar"
    min_replicas: int = 1
    max_replicas: int = 8
    # Capacity model: tokens/s one replica sustains (from profiling; the
    # decode interpolator overrides this when present + an ITL SLA is set).
    replica_tok_s: float = 1000.0
    mean_output_tokens: float = 128.0  # converts request rate → token rate
    itl_sla_ms: float | None = None
    ttft_sla_ms: float | None = None
    scale_down_headroom: float = 1.3   # hysteresis: scale down only under 1/headroom


@dataclass
class PlannerState:
    replicas: int = 0
    last_prediction: float = 0.0
    adjustments: list[tuple[float, int]] = field(default_factory=list)


class Planner:
    def __init__(
        self,
        cfg: PlannerConfig,
        connector: Connector,
        metrics_source,  # async callable → PlannerObservation
        decode_interp: DecodeInterpolator | None = None,
        prefill_interp: PrefillInterpolator | None = None,
    ):
        self.cfg = cfg
        self.connector = connector
        self.metrics_source = metrics_source
        self.decode_interp = decode_interp
        self.prefill_interp = prefill_interp
        self.predictor = make_predictor(cfg.predictor)
        self.state = PlannerState()
        self._last_current = 0
        self._last_prefill_current = 0
        self._task: asyncio.Task | None = None
        self._stop = asyncio.Event()

    # -- one adjustment ----------------------------------------------------

    def replica_capacity_tok_s(self) -> float:
        """Per-replica sustainable token rate under the SLA."""
        if self.decode_interp is not None and self.cfg.itl_sla_ms is not None:
            cap = self.decode_interp.best_throughput_under_itl(self.cfg.itl_sla_ms)
            if cap > 0:
                return cap
        return self.cfg.replica_tok_s

    def target_replicas(self, obs: PlannerObservation) -> int:
        self.predictor.observe(obs.request_rate)
        pred_rate = self.predictor.predict()
        self.state.last_prediction = pred_rate
        token_rate = pred_rate * self.cfg.mean_output_tokens
        cap = self.replica_capacity_tok_s()
        need = math.ceil(token_rate / cap) if cap > 0 else self.cfg.max_replicas

        # SLA correction (reference: planner_core.py correction factors):
        # observed ITL/TTFT over SLA means the capacity model is optimistic
        # for the live workload — scale the need up proportionally.
        if self.cfg.itl_sla_ms and obs.itl_ms and obs.itl_ms > self.cfg.itl_sla_ms:
            need = math.ceil(need * obs.itl_ms / self.cfg.itl_sla_ms)
        if (
            self.cfg.ttft_sla_ms and obs.ttft_ms and obs.ttft_ms > self.cfg.ttft_sla_ms
            and not self.cfg.prefill_component  # disagg: TTFT scales prefill instead
        ):
            need = max(need, self.connector.get_replicas(self.cfg.component) + 1)

        current = self.connector.get_replicas(self.cfg.component)
        if need < current:
            # Hysteresis: only scale down when the predicted demand fits
            # comfortably in fewer replicas.
            if token_rate * self.cfg.scale_down_headroom > (current - 1) * cap:
                need = current
        self._last_current = current  # reused by _step_sync's _apply
        return max(self.cfg.min_replicas, min(self.cfg.max_replicas, need))

    def initial_pool_split(self, total_workers: int) -> dict:
        """Static prefill:decode split for a fixed fleet from the
        profiled interpolators (interpolate.plan_disagg_pools) — the
        day-0 deployment shape before the observe→scale loop has any
        traffic to react to. Requires both interpolators and an ITL SLA."""
        from dynamo_tpu_torch.planner.interpolate import plan_disagg_pools

        if (
            self.decode_interp is None or self.prefill_interp is None
            or self.cfg.itl_sla_ms is None
        ):
            raise ValueError(
                "initial_pool_split needs decode + prefill interpolators "
                "and an itl_sla_ms"
            )
        return plan_disagg_pools(
            total_workers, self.decode_interp, self.prefill_interp,
            prompt_len=self.cfg.mean_input_tokens,
            gen_len=self.cfg.mean_output_tokens,
            itl_sla_ms=self.cfg.itl_sla_ms,
            ttft_sla_ms=self.cfg.ttft_sla_ms,
        )

    def target_prefill_replicas(self, obs: PlannerObservation) -> int:
        """Prefill fleet sizing from the PREDICTED input-token rate and
        the profiled prefill throughput, TTFT-corrected (reference:
        planner_core.py:241-251). Uses the prediction made by
        target_replicas this step (call order matters)."""
        input_rate = self.state.last_prediction * self.cfg.mean_input_tokens
        cap = self.cfg.prefill_tok_s
        if self.prefill_interp is not None:
            t = self.prefill_interp.throughput_at(self.cfg.mean_input_tokens)
            if t > 0:
                cap = t
        need = math.ceil(input_rate / cap) if cap > 0 else self.cfg.max_replicas
        # TTFT over SLA: prefill capacity is the TTFT lever in a disagg
        # deployment — scale prefill, not decode, on TTFT breach.
        if self.cfg.ttft_sla_ms and obs.ttft_ms and obs.ttft_ms > self.cfg.ttft_sla_ms:
            need = math.ceil(need * obs.ttft_ms / self.cfg.ttft_sla_ms)
        current = self.connector.get_replicas(self.cfg.prefill_component)
        if need < current and input_rate * self.cfg.scale_down_headroom > (current - 1) * cap:
            need = current
        self._last_prefill_current = current
        return max(self.cfg.min_replicas, min(self.cfg.max_replicas, need))

    def _apply(self, component: str, target: int, obs: PlannerObservation,
               current: int | None = None) -> None:
        if current is None:
            current = self.connector.get_replicas(component)
        if target != current:
            log.info(
                "scaling %s: %d → %d (rate=%.2f req/s pred=%.2f ttft=%s itl=%s ms)",
                component, current, target,
                obs.request_rate, self.state.last_prediction, obs.ttft_ms, obs.itl_ms,
            )
            self.connector.set_replicas(component, target)
            self.state.adjustments.append((time.monotonic(), target))

    def _step_sync(self, obs: PlannerObservation) -> int:
        """Target computation + connector calls. Runs in a worker thread:
        connectors may block on I/O (the Kubernetes one does HTTPS
        round-trips), which must not stall the planner's event loop."""
        target = self.target_replicas(obs)
        self._apply(self.cfg.component, target, obs, current=self._last_current)
        if self.cfg.prefill_component:
            ptarget = self.target_prefill_replicas(obs)
            self._apply(self.cfg.prefill_component, ptarget, obs,
                        current=self._last_prefill_current)
        return target

    async def step(self) -> int:
        obs = (await self.metrics_source()).sanitize()
        if obs.empty_window:
            # No basis for a decision (cold start / poisoned scrape):
            # hold the current replica count instead of reading the
            # zeroed rates as "idle" and scaling a loaded fleet down.
            current = await asyncio.to_thread(
                self.connector.get_replicas, self.cfg.component
            )
            self.state.replicas = max(current, self.cfg.min_replicas)
            return self.state.replicas
        target = await asyncio.to_thread(self._step_sync, obs)
        self.state.replicas = target
        return target

    # -- loop --------------------------------------------------------------

    async def run(self) -> None:
        while not self._stop.is_set():
            try:
                await self.step()
            except Exception:  # noqa: BLE001 — planner must not die
                log.exception("planner step failed")
            try:
                await asyncio.wait_for(self._stop.wait(), self.cfg.adjustment_interval_s)
            except asyncio.TimeoutError:
                pass

    async def start(self) -> "Planner":
        self._task = asyncio.get_running_loop().create_task(self.run())
        return self

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task


# ---------------------------------------------------------------------------
# Metrics sources
# ---------------------------------------------------------------------------


class HttpMetricsSource:
    """Scrapes the frontend's /metrics (our own Prometheus text) and
    differences counters across calls → rates + interval means. The
    requests go through the standard library (``runtime/urlfetch.py``,
    in a worker thread): httpx is absent on the card's machine.

    ``admission_url`` (the frontend's /debug/admission) additionally
    supplies the gate's live queue depth and observed drain-interval
    EMA — the overload signals the closed-loop autoscaler's queue term
    reads (docs/autoscaler.md). Scrape failures there degrade to
    zeroed signals, never a failed observation."""

    def __init__(self, url: str, admission_url: str | None = None):
        self.url = url
        self.admission_url = admission_url
        self._last: dict[str, float] | None = None
        self._last_t: float | None = None

    @staticmethod
    def _parse(text: str) -> dict[str, float]:
        out: dict[str, float] = {}
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            try:
                name_labels, value = line.rsplit(" ", 1)
            except ValueError:
                continue
            name = name_labels.split("{", 1)[0]
            try:
                out[name] = out.get(name, 0.0) + float(value)
            except ValueError:
                continue
        return out

    async def __call__(self) -> PlannerObservation:
        import time

        from dynamo_tpu_torch.runtime import urlfetch

        r = await asyncio.to_thread(urlfetch.request, "GET", self.url, timeout=10)
        cur = self._parse(r.text)
        now = time.monotonic()
        # First scrape after (re)start: no previous sample to difference
        # against — an EMPTY window, not an idle one.
        obs = PlannerObservation(empty_window=self._last is None)
        if self._last is not None and self._last_t is not None:
            dt = max(now - self._last_t, 1e-6)

            def delta(name: str) -> float:
                return cur.get(name, 0.0) - self._last.get(name, 0.0)

            p = "dynamo_tpu_http_"
            obs.request_rate = max(0.0, delta(p + "requests_total") / dt)
            obs.output_token_rate = max(0.0, delta(p + "output_tokens_total") / dt)
            obs.input_token_rate = max(0.0, delta(p + "input_tokens_total") / dt)
            dttft_n = delta(p + "time_to_first_token_seconds_count")
            if dttft_n > 0:
                obs.ttft_ms = delta(p + "time_to_first_token_seconds_sum") / dttft_n * 1000
            ditl_n = delta(p + "inter_token_latency_seconds_count")
            if ditl_n > 0:
                obs.itl_ms = delta(p + "inter_token_latency_seconds_sum") / ditl_n * 1000
        self._last, self._last_t = cur, now
        if self.admission_url:
            try:
                a = (await asyncio.to_thread(
                    urlfetch.request, "GET", self.admission_url, timeout=10)).json()
                obs.drain_interval_s = float(a.get("drain_interval_s") or 0.0)
                obs.queue_depth = float(sum(
                    c.get("queued", 0) for c in (a.get("classes") or {}).values()
                ))
            except Exception:  # noqa: BLE001 — the admission surface is optional signal; a failed scrape degrades to zeroed overload terms
                pass
        return obs
