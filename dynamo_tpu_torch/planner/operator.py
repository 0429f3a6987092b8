"""The closed-loop SLA autoscaler: observe → decide → ACTUATE.

``Planner`` (core.py) computes targets; this module closes the loop
(ROADMAP item 4): a pure, deterministic :class:`ControlLaw` turns
observations into the typed action vocabulary of
:mod:`~dynamo_tpu_torch.planner.actions`, and the :class:`SlaAutoscaler`
shell journals, traces, metric-counts and dispatches each action to the
fleet through the actuator seams in :mod:`~dynamo_tpu_torch.planner.actuate`.

Control law (docs/autoscaler.md has the full derivation):

- **decode pool** sizes from the predicted output-token rate over the
  per-replica SLA capacity — the profiled DecodeInterpolator's best
  throughput under the ITL SLA (DistServe's per-pool operating point,
  arXiv 2401.09670) — with an observed-ITL breach forcing +1;
- **prefill pool** sizes from the predicted input-token rate over the
  profiled prefill throughput, with an observed-TTFT breach or a
  queue-drain estimate over the TTFT SLA (queue_depth × the admission
  gate's inter-release EMA — Mooncake's overload signal, 2407.00079)
  forcing +1;
- at a **fixed engine count** the law converts opposing pressure into a
  POOL MOVE: the pool whose SLO is breached harder pulls a worker from
  the pool with headroom — chips follow the bottleneck;
- the **frontend fleet** sizes from predicted request rate over the
  profiled per-child capacity.

Stability: every proposal must repeat for ``hysteresis_cycles``
consecutive cycles before it actuates, each action kind then enters a
``cooldown_s`` window, scale-down additionally needs the demand to fit
under ``scale_down_headroom``, and an all-idle signal must persist
``idle_cycles_for_scale_down`` cycles — so the loop cannot flap. Cold
starts, empty metric windows, non-finite inputs and beyond-profile
operating points all clamp to an explicit :class:`~dynamo_tpu_torch.planner.
actions.Hold` with a reason, never to NaN or a negative pool size.

Failure model: actuation errors mark the action ``outcome="error"`` and
the loop re-plans from LIVE state next cycle — convergence is
level-based, so killing the operator (or a worker) mid-action leaves at
worst a partially-applied step that the next cycle observes and
finishes (chaos-pinned in tests/test_autoscaler_chaos.py).

Port of ``dynamo_tpu/planner/operator.py``. The port adds the cycle
record: ``SlaAutoscaler(recorder=...)`` is fed each cycle's inputs,
decisions and actuations (``cycle_record``), and ``replay_law`` drives a
fresh law through them — an audit that the law is a pure function of
what it observed.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import asdict, dataclass, field

from dynamo_tpu_torch.planner.actions import (
    KIND_FLEET_RESIZE,
    KIND_POOL_MOVE,
    KIND_REPLICA_SCALE,
    POOL_DECODE,
    POOL_PREFILL,
    ActionJournal,
    FleetResize,
    Hold,
    PoolMove,
    ReplicaScale,
    ScaleAction,
    ScaleActionError,
)
from dynamo_tpu_torch.planner.core import PlannerObservation
from dynamo_tpu_torch.planner.interpolate import DecodeInterpolator, PrefillInterpolator
from dynamo_tpu_torch.planner.predictors import make_predictor
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.operator")


@dataclass
class OperatorConfig:
    operator_id: str = "default"
    interval_s: float = 5.0
    # SLOs + workload shape (the decision inputs the interpolators map).
    ttft_sla_ms: float | None = None
    itl_sla_ms: float | None = None
    mean_input_tokens: float = 512.0
    mean_output_tokens: float = 128.0
    predictor: str = "ar"
    # Pool bounds. max_engines caps prefill+decode TOTAL (replica
    # scaling); pool moves never change the total.
    min_prefill: int = 1
    min_decode: int = 1
    max_engines: int = 8
    # Frontend fleet bounds; fleet_child_rps == 0 disables fleet scaling.
    min_fleet: int = 1
    max_fleet: int = 8
    fleet_child_rps: float = 0.0
    # Capacity fallbacks when no profile is discovered.
    decode_tok_s: float = 1000.0
    prefill_tok_s: float = 8000.0
    # Stability knobs (docs/autoscaler.md "never flaps").
    hysteresis_cycles: int = 2
    cooldown_s: float = 30.0
    idle_cycles_for_scale_down: int = 3
    scale_down_headroom: float = 1.3
    # False = fixed chip count: the law only MOVES engines between
    # pools (the bench's equal-chip-count shape); True also scales the
    # replica total within [min_prefill+min_decode, max_engines].
    replica_scaling: bool = True


@dataclass
class LawState:
    """Introspectable decision state (surfaced by /debug + the bench)."""

    last_prediction: float = 0.0
    idle_cycles: int = 0
    holds: dict[str, int] = field(default_factory=dict)
    proposals: dict[str, int] = field(default_factory=dict)


class ControlLaw:
    """Pure decision core: (observation, pool sizes, now) → actions.

    Deterministic and clock-injected, so the discrete-event bench and
    the unit suite drive the EXACT production decision code."""

    def __init__(
        self,
        cfg: OperatorConfig,
        decode_interp: DecodeInterpolator | None = None,
        prefill_interp: PrefillInterpolator | None = None,
    ):
        self.cfg = cfg
        self.decode_interp = decode_interp
        self.prefill_interp = prefill_interp
        self.predictor = make_predictor(cfg.predictor)
        self.state = LawState()
        # proposal signature per action kind → consecutive-cycle count.
        self._pending: dict[str, tuple[tuple, int]] = {}
        self._cooldown_until: dict[str, float] = {}
        self._last_gate = "steady"  # why the last proposal was held

    # -- capacities ---------------------------------------------------------

    def decode_capacity_tok_s(self) -> float:
        if self.decode_interp is not None and self.cfg.itl_sla_ms is not None:
            cap = self.decode_interp.best_throughput_under_itl(self.cfg.itl_sla_ms)
            if cap > 0 and math.isfinite(cap):
                return cap
        return self.cfg.decode_tok_s

    def prefill_capacity_tok_s(self, mean_input_tokens: float | None = None) -> float:
        plen = (
            self.cfg.mean_input_tokens
            if mean_input_tokens is None else mean_input_tokens
        )
        if self.prefill_interp is not None:
            cap = self.prefill_interp.throughput_at(plen)
            if cap > 0 and math.isfinite(cap):
                return cap
        return self.cfg.prefill_tok_s

    # -- target computation (pure, clamped) ---------------------------------

    @staticmethod
    def _clamp(n: float, lo: int, hi: int) -> int:
        """Every pool size passes here: integral, finite, in [lo, hi] —
        a NaN/negative intermediate can never become a pool size."""
        if not math.isfinite(n):
            return lo
        return max(lo, min(hi, int(n)))

    def targets(self, obs: PlannerObservation, prefill_n: int, decode_n: int) -> tuple[int, int]:
        """→ (desired_prefill, desired_decode) under the SLA model, with
        the scale-down headroom hold applied. Observation must already
        be sanitized."""
        want_p, want_d, _raw_p, _raw_d = self._targets_full(obs, prefill_n, decode_n)
        return want_p, want_d

    def _targets_full(
        self, obs: PlannerObservation, prefill_n: int, decode_n: int
    ) -> tuple[int, int, int, int]:
        """→ (want_p, want_d, raw_p, raw_d): the held targets plus the
        RAW demand-only targets. Scaling decisions use the held values
        (hysteresis against shrink); pool-move donor checks use the raw
        ones — a donor whose raw demand fits in one fewer worker can
        give that worker to a breached pool even while the shrink hold
        would keep it for a standalone scale-down."""
        cfg = self.cfg
        pred = self.state.last_prediction
        # Observed token-per-request shape beats the configured static
        # means: a diurnal trace shifts prompt/generation lengths by
        # hours of day, and sizing the prefill pool off yesterday's mean
        # prompt length is exactly the miss the closed loop exists to
        # fix. Fall back to the configured shape when unobserved.
        mean_out = cfg.mean_output_tokens
        if obs.request_rate > 0 and obs.output_token_rate > 0:
            mean_out = obs.output_token_rate / obs.request_rate
        mean_in = cfg.mean_input_tokens
        if obs.request_rate > 0 and obs.input_token_rate > 0:
            mean_in = obs.input_token_rate / obs.request_rate
        out_rate = pred * mean_out
        in_rate = pred * mean_in

        d_cap = self.decode_capacity_tok_s()
        raw_d = math.ceil(out_rate / d_cap) if d_cap > 0 else decode_n
        if cfg.itl_sla_ms and obs.itl_ms and obs.itl_ms > cfg.itl_sla_ms:
            # Observed breach: the capacity model is optimistic for the
            # live workload — one replica at a time, not a ratio jump
            # (the ratio can be wild on a cold-cache tick).
            raw_d = max(raw_d, decode_n + 1)
        want_d = raw_d
        if want_d < decode_n and out_rate * cfg.scale_down_headroom > (decode_n - 1) * d_cap:
            want_d = decode_n

        p_cap = self.prefill_capacity_tok_s(mean_in)
        raw_p = math.ceil(in_rate / p_cap) if p_cap > 0 else prefill_n
        ttft_pressure = bool(
            cfg.ttft_sla_ms and obs.ttft_ms and obs.ttft_ms > cfg.ttft_sla_ms
        )
        if cfg.ttft_sla_ms and obs.queue_depth > 0 and obs.drain_interval_s > 0:
            # Mooncake-style queue estimate: requests waiting × observed
            # drain interval ≈ the TTFT a new arrival would see.
            if obs.queue_depth * obs.drain_interval_s * 1000.0 > cfg.ttft_sla_ms:
                ttft_pressure = True
        if ttft_pressure:
            raw_p = max(raw_p, prefill_n + 1)
        want_p = raw_p
        if want_p < prefill_n and in_rate * cfg.scale_down_headroom > (prefill_n - 1) * p_cap:
            want_p = prefill_n

        hi_p = max(cfg.max_engines - cfg.min_decode, cfg.min_prefill)
        hi_d = max(cfg.max_engines - cfg.min_prefill, cfg.min_decode)
        return (
            self._clamp(want_p, cfg.min_prefill, hi_p),
            self._clamp(want_d, cfg.min_decode, hi_d),
            self._clamp(raw_p, cfg.min_prefill, hi_p),
            self._clamp(raw_d, cfg.min_decode, hi_d),
        )

    def _breach_ratio(self, obs: PlannerObservation, pool: str) -> float:
        """How hard a pool's SLO is violated (1.0 = at SLO). The pool
        with the harder breach wins the worker on a contested move."""
        if pool == POOL_PREFILL:
            if self.cfg.ttft_sla_ms and obs.ttft_ms:
                return obs.ttft_ms / self.cfg.ttft_sla_ms
        elif self.cfg.itl_sla_ms and obs.itl_ms:
            return obs.itl_ms / self.cfg.itl_sla_ms
        return 0.0

    # -- stability gates ----------------------------------------------------

    def _propose(self, kind: str, signature: tuple, now: float):
        """Hysteresis + cooldown gate: → True when a proposal with this
        signature has held for hysteresis_cycles consecutive cycles and
        the kind is out of cooldown."""
        if now < self._cooldown_until.get(kind, 0.0):
            self.state.holds["cooldown"] = self.state.holds.get("cooldown", 0) + 1
            self._last_gate = "cooldown"
            return False
        prev, count = self._pending.get(kind, (None, 0))
        count = count + 1 if prev == signature else 1
        self._pending[kind] = (signature, count)
        self.state.proposals[kind] = count
        if count < self.cfg.hysteresis_cycles:
            self.state.holds["hysteresis"] = self.state.holds.get("hysteresis", 0) + 1
            self._last_gate = "hysteresis"
            return False
        return True

    def _drop(self, kind: str) -> None:
        self._pending.pop(kind, None)
        self.state.proposals.pop(kind, None)

    def notify_actuated(self, kind: str, now: float) -> None:
        """Called by the shell after a SUCCESSFUL actuation: reset the
        proposal and open the cooldown window."""
        self._drop(kind)
        self._cooldown_until[kind] = now + self.cfg.cooldown_s

    # -- the decision -------------------------------------------------------

    def decide(
        self,
        obs: PlannerObservation,
        prefill_n: int,
        decode_n: int,
        fleet_n: int = 0,
        now: float | None = None,
    ) -> list[ScaleAction | Hold]:
        """One control cycle. Pools of size 0 are treated as their
        minimums pending discovery (a cold store must not trigger a
        scale storm)."""
        now = time.monotonic() if now is None else now
        obs = obs.sanitize()
        if obs.empty_window:
            # No information: drop momentum too — a pre-restart proposal
            # must not fire on post-restart garbage.
            self._pending.clear()
            self.state.proposals.clear()
            self.state.holds["empty_window"] = self.state.holds.get("empty_window", 0) + 1
            return [Hold("empty_window")]

        self.predictor.observe(obs.request_rate)
        pred = self.predictor.predict()
        if not math.isfinite(pred) or pred < 0.0:
            pred = obs.request_rate
        self.state.last_prediction = pred

        idle = (
            obs.request_rate <= 0.0 and obs.queue_depth <= 0.0
            and obs.ttft_ms is None and obs.itl_ms is None
        )
        if idle:
            self.state.idle_cycles += 1
            if self.state.idle_cycles < self.cfg.idle_cycles_for_scale_down:
                self.state.holds["idle_settling"] = self.state.holds.get("idle_settling", 0) + 1
                return [Hold("idle_settling")]
        else:
            self.state.idle_cycles = 0

        actions: list[ScaleAction | Hold] = []
        want_p, want_d, raw_p, raw_d = self._targets_full(obs, prefill_n, decode_n)
        have_pools = prefill_n > 0 or decode_n > 0
        if have_pools:
            actions.extend(
                self._pool_actions(
                    obs, prefill_n, decode_n, want_p, want_d, raw_p, raw_d, now
                )
            )
        if self.cfg.fleet_child_rps > 0 and fleet_n > 0:
            actions.extend(self._fleet_actions(pred, fleet_n, now))
        if not actions:
            actions.append(Hold("steady"))
        return actions

    def _pool_actions(
        self, obs, prefill_n: int, decode_n: int, want_p: int, want_d: int,
        raw_p: int, raw_d: int, now: float
    ) -> list[ScaleAction | Hold]:
        cfg = self.cfg
        total = prefill_n + decode_n
        want_total = want_p + want_d
        out: list[ScaleAction | Hold] = []

        if cfg.replica_scaling and want_total != total:
            target_total = self._clamp(
                want_total, cfg.min_prefill + cfg.min_decode, cfg.max_engines
            )
            if target_total > total:
                pool = POOL_PREFILL if want_p - prefill_n >= want_d - decode_n else POOL_DECODE
                cur = prefill_n if pool == POOL_PREFILL else decode_n
                tgt = min(cur + (target_total - total),
                          want_p if pool == POOL_PREFILL else want_d)
                if tgt > cur and self._propose(
                    KIND_REPLICA_SCALE, ("up", pool, tgt), now
                ):
                    return [ReplicaScale(pool=pool, target=tgt, current=cur)]
                return [Hold("settling")]
            if target_total < total:
                pool = POOL_PREFILL if prefill_n - want_p >= decode_n - want_d else POOL_DECODE
                cur = prefill_n if pool == POOL_PREFILL else decode_n
                tgt = max(cur - (total - target_total),
                          want_p if pool == POOL_PREFILL else want_d,
                          cfg.min_prefill if pool == POOL_PREFILL else cfg.min_decode)
                if tgt < cur and self._propose(
                    KIND_REPLICA_SCALE, ("down", pool, tgt), now
                ):
                    return [ReplicaScale(pool=pool, target=tgt, current=cur)]
                return [Hold("settling")]

        # Fixed total (or replica scaling saturated/disabled): opposing
        # pressure becomes a pool MOVE — one worker per cycle, donor
        # must keep its minimum and have headroom per its RAW demand
        # (the scale-down hold protects standalone shrinks, but must
        # not pin idle capacity in a pool while the other one breaches).
        grow_p = want_p > prefill_n
        grow_d = want_d > decode_n
        if grow_p and grow_d:
            # Both pools want chips and there are none: move toward the
            # harder breach only if the donor is NOT itself breached.
            rp = self._breach_ratio(obs, POOL_PREFILL)
            rd = self._breach_ratio(obs, POOL_DECODE)
            if rp > 1.0 >= rd and decode_n > cfg.min_decode:
                grow_d = False
            elif rd > 1.0 >= rp and prefill_n > cfg.min_prefill:
                grow_p = False
            else:
                out.append(Hold("contended"))
                return out
        if grow_p and decode_n > cfg.min_decode and raw_d <= decode_n - 1:
            if self._propose(KIND_POOL_MOVE, (POOL_DECODE, POOL_PREFILL), now):
                out.append(PoolMove(worker="", instance_id=0,
                                    src=POOL_DECODE, dst=POOL_PREFILL))
            else:
                out.append(Hold(self._last_gate))
        elif grow_d and prefill_n > cfg.min_prefill and raw_p <= prefill_n - 1:
            if self._propose(KIND_POOL_MOVE, (POOL_PREFILL, POOL_DECODE), now):
                out.append(PoolMove(worker="", instance_id=0,
                                    src=POOL_PREFILL, dst=POOL_DECODE))
            else:
                out.append(Hold(self._last_gate))
        else:
            self._drop(KIND_POOL_MOVE)
        return out

    def _fleet_actions(self, pred: float, fleet_n: int, now: float) -> list:
        cfg = self.cfg
        want = math.ceil(pred / cfg.fleet_child_rps) if pred > 0 else cfg.min_fleet
        if want < fleet_n and pred * cfg.scale_down_headroom > (fleet_n - 1) * cfg.fleet_child_rps:
            want = fleet_n
        want = self._clamp(want, cfg.min_fleet, cfg.max_fleet)
        if want == fleet_n:
            self._drop(KIND_FLEET_RESIZE)
            return []
        if self._propose(KIND_FLEET_RESIZE, (want,), now):
            return [FleetResize(target=want, current=fleet_n)]
        return []


class SlaAutoscaler:
    """The async shell around :class:`ControlLaw`: observes, decides,
    and actuates — journaling, tracing and metric-counting every
    action. ``observe`` is an async callable → PlannerObservation;
    ``pool_actuator``/``fleet_actuator`` implement the protocols in
    :mod:`~dynamo_tpu_torch.planner.actuate` (either may be None)."""

    def __init__(
        self,
        law: ControlLaw,
        observe,
        pool_actuator=None,
        fleet_actuator=None,
        journal: ActionJournal | None = None,
        metrics: dict | None = None,
        chaos=None,
        clock=time.monotonic,
        balancer=None,
        recorder=None,
    ):
        self.law = law
        self.observe = observe
        self.pool_actuator = pool_actuator
        self.fleet_actuator = fleet_actuator
        self.journal = journal
        self.metrics = metrics
        self.chaos = chaos
        self._clock = clock
        # Optional FleetBalancer (planner/balancer.py): stepped inside
        # this loop's cadence AFTER the scale decisions — rebalancing
        # works WITHIN the pool sizes the scale law just converged, so
        # the two policies never race over the same observation.
        self.balancer = balancer
        # Optional callable fed one ``cycle_record`` dict per cycle: the
        # law's inputs, its decisions and the actuations' outcomes, enough
        # for ``replay_law`` to drive a fresh law through the same run.
        self.recorder = recorder
        self._cycle_actuated: list[tuple[str, str, float | None]] = []
        self.actions_done: list[tuple[ScaleAction, str]] = []
        self.last_decisions: list = []
        self._task: asyncio.Task | None = None
        self._stop = asyncio.Event()

    def _set_pool_gauges(self, sizes: dict[str, int]) -> None:
        if self.metrics is not None:
            for pool, n in sizes.items():
                self.metrics["pool_size"].set(n, pool=pool)

    async def step(self) -> list:
        t0 = self._clock()
        obs = await self.observe()
        sizes = {POOL_PREFILL: 0, POOL_DECODE: 0}
        if self.pool_actuator is not None:
            pools = await self.pool_actuator.pools()
            sizes = {p: len(pools.get(p, ())) for p in sizes}
        fleet_n = 0
        if self.fleet_actuator is not None:
            try:
                fleet_n = await self.fleet_actuator.fleet_size()
            except Exception as e:  # noqa: BLE001 — an unreachable fleet supervisor must only disable FLEET decisions this cycle; engine-pool scaling is an independent plane and keeps running
                log.warning("fleet supervisor unreachable (%s); skipping fleet decisions", e)
                fleet_n = 0
        self._set_pool_gauges(sizes)
        now = self._clock()
        decisions = self.law.decide(
            obs, sizes[POOL_PREFILL], sizes[POOL_DECODE], fleet_n, now=now
        )
        self.last_decisions = decisions
        self._cycle_actuated = []
        for action in decisions:
            if isinstance(action, Hold):
                continue
            await self._actuate(action, t0)
        if self.recorder is not None:
            self.recorder(cycle_record(obs, sizes[POOL_PREFILL], sizes[POOL_DECODE],
                                       fleet_n, now, decisions, self._cycle_actuated))
        if self.pool_actuator is not None:
            pools = await self.pool_actuator.pools()
            self._set_pool_gauges({p: len(pools.get(p, ())) for p in sizes})
        if self.balancer is not None:
            try:
                await self.balancer.step()
            except Exception:  # noqa: BLE001 — the balancer is an optimization; a failed cycle must not take the scale loop down with it
                log.exception("balancer step failed")
        return decisions

    async def _actuate(self, action: ScaleAction, t0: float) -> None:
        span = tracing.start_span(f"planner.{action.kind}", detail=action.describe())
        seq = None
        if self.journal is not None:
            seq = await self.journal.record_intent(action)
        outcome, detail = "ok", ""
        try:
            if action.kind == KIND_FLEET_RESIZE:
                if self.fleet_actuator is None:
                    raise ScaleActionError("no fleet actuator wired")
                await self.fleet_actuator.resize_fleet(action.target)
            elif action.kind == KIND_POOL_MOVE:
                if self.pool_actuator is None:
                    raise ScaleActionError("no pool actuator wired")
                await self.pool_actuator.move(action)
            elif action.kind == KIND_REPLICA_SCALE:
                if self.pool_actuator is None:
                    raise ScaleActionError("no pool actuator wired")
                await self.pool_actuator.scale(action)
            else:  # pragma: no cover - the vocabulary is closed
                raise ScaleActionError(f"unknown action kind {action.kind!r}")
            t_done = self._clock()
            self.law.notify_actuated(action.kind, t_done)
            log.info("actuated: %s", action.describe())
        except asyncio.CancelledError:
            # Operator killed mid-scale: the intent stays "started" in
            # the journal (then dies with our lease); the successor
            # converges from live state.
            span.end(status="cancelled")
            raise
        except Exception as e:  # noqa: BLE001 — actuation failure is an expected chaos outcome; the loop must survive it and re-plan from live state
            outcome, detail = "error", f"{type(e).__name__}: {e}"
            log.warning("action failed (%s): %s", action.describe(), detail)
            span.set_attr("error", detail)
        lag = max(self._clock() - t0, 0.0)
        if self.metrics is not None:
            self.metrics["actions"].inc(kind=action.kind, outcome=outcome)
            self.metrics["decision_lag"].set(lag)
        if self.journal is not None and seq is not None:
            await self.journal.record_outcome(seq, action, outcome, detail)
        self.actions_done.append((action, outcome))
        self._cycle_actuated.append((action.kind, outcome, t_done if outcome == "ok" else None))
        span.set_attr("lag_s", round(lag, 4))
        span.end(status=None if outcome == "ok" else "error")

    async def run(self) -> None:
        while not self._stop.is_set():
            if self.chaos is not None:
                # OUTSIDE the catch-all: an injected operator death must
                # actually kill the loop (the chaos suite then proves a
                # successor converges) — swallowing it would test nothing.
                self.chaos.maybe_kill_operator()
            try:
                await self.step()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the operator loop must not die; next cycle re-observes
                log.exception("autoscaler step failed")
            try:
                await asyncio.wait_for(
                    self._stop.wait(), self.law.cfg.interval_s
                )
            except asyncio.TimeoutError:
                pass

    async def start(self) -> "SlaAutoscaler":
        self._task = asyncio.get_running_loop().create_task(self.run())
        return self

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            # dyntpu: allow[DT005] reason=stop() awaits its own cancelled task; CancelledError is the expected outcome and there is no caller left to route a racing crash to
            except BaseException:  # noqa: BLE001 — cancellation path
                pass


def decision_dict(d) -> dict:
    """One decision (an action or a Hold) → its kind and every field."""
    return {"kind": d.kind, **asdict(d)}


def cycle_record(obs: PlannerObservation, prefill_n: int, decode_n: int, fleet_n: int,
                 now: float, decisions: list, actuated) -> dict:
    """One autoscaler cycle as plain data: the observation and pool sizes
    the law was given, the clock it read, its decisions, and each
    actuation's (kind, outcome, clock at its notify_actuated)."""
    return {"obs": asdict(obs), "prefill_n": prefill_n, "decode_n": decode_n,
            "fleet_n": fleet_n, "now": now,
            "decisions": [decision_dict(d) for d in decisions],
            "actuated": [list(a) for a in actuated]}


def replay_law(law: ControlLaw, records) -> list[list[dict]]:
    """Drive ``law`` (a fresh one, configured as the recorded run's) through
    recorded cycles → its decisions per cycle, as ``decision_dict``s. A
    deterministic law returns the recorded decisions."""
    out = []
    for r in records:
        decisions = law.decide(PlannerObservation(**r["obs"]), r["prefill_n"], r["decode_n"],
                               r["fleet_n"], now=r["now"])
        out.append([decision_dict(d) for d in decisions])
        for kind, outcome, t in r["actuated"]:
            if outcome == "ok":
                law.notify_actuated(kind, t)
    return out


def register_planner_metrics(registry) -> dict:
    """The autoscaler's observability series (DT006-cataloged):
    actions by kind/outcome, live pool sizes, and the decision lag —
    observation snapshot → actuation complete — of the last action."""
    return {
        "actions": registry.counter(
            "planner_scale_actions_total",
            "Autoscaler scale actions actuated, by kind and outcome",
        ),
        "pool_size": registry.gauge(
            "planner_pool_size",
            "Engines per pool as the autoscaler last observed them",
        ),
        "decision_lag": registry.gauge(
            "planner_decision_lag_seconds",
            "Observation-to-actuation latency of the last scale action",
        ),
    }
