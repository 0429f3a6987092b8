"""Deterministic fault injection for the serving stack.

The reference validates fault tolerance with process-kill integration tests
(tests/fault_tolerance/test_request_migration.py); this module adds the
complementary in-process harness: a seeded :class:`ChaosInjector` that the
messaging layer and the mock engine consult at well-defined fault points —

- **frame drop / stream truncation** — the server cuts the connection at a
  frame boundary instead of delivering the frame. The client's pump sees
  EOF before the ``final`` frame and raises ``TruncatedStreamError``, which
  is exactly the signal a crashed worker produces. Faults are *detectable
  by construction*: chaos never silently corrupts payloads, it only kills
  transports, so any undetected data loss is a real protocol bug.
- **worker kill** — the engine raises :class:`ChaosKillError` mid-
  generation; the endpoint server translates it into a transport cut
  (no error frame), indistinguishable on the wire from process death.
- **latency injection** — bounded uniform delay before response frames,
  for exercising deadline enforcement.

Every draw comes from one ``random.Random(seed)``, so a failing chaos run
replays bit-identically from its seed.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import random
from dataclasses import dataclass

from dynamo_tpu_torch.runtime.config import ChaosConfig
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("chaos")


class ChaosKillError(Exception):
    """Injected worker death. Must never escape to a client as an error
    frame — the messaging layer converts it into a dropped connection so
    recovery paths see a real truncation signal."""


@dataclass
class ChaosStats:
    """Counters of injected faults (for test assertions/reporting)."""

    frames_dropped: int = 0
    streams_truncated: int = 0
    kills: int = 0
    transfer_cuts: int = 0
    frontend_kills: int = 0
    operator_kills: int = 0
    migration_cuts: int = 0
    latency_injections: int = 0

    def total(self) -> int:
        return (
            self.frames_dropped + self.streams_truncated + self.kills
            + self.transfer_cuts + self.frontend_kills + self.operator_kills
            + self.migration_cuts
        )


class ChaosInjector:
    """Seeded fault source consulted at the messaging/engine fault points.

    Thread-unsafe by design: all consumers run on one event loop. The RNG
    stream is shared across fault kinds so a single seed pins the whole
    scenario.
    """

    def __init__(self, config: ChaosConfig | None = None, **overrides):
        cfg = config or ChaosConfig(enabled=True)
        if overrides:
            # Never mutate the caller's (possibly shared) config object.
            cfg = dataclasses.replace(cfg, **overrides)
        self.config = cfg
        self.rng = random.Random(cfg.seed)
        self.stats = ChaosStats()
        self._m_injections = None

    def bind_metrics(self, registry) -> "ChaosInjector":
        """Expose injected-fault counts as ``chaos_injections_total{kind}``
        on ``registry`` (the process's /metrics)."""
        self._m_injections = registry.counter(
            "chaos_injections_total", "Injected faults by kind"
        )
        return self

    def _count(self, kind: str) -> None:
        if self._m_injections is not None:
            self._m_injections.inc(kind=kind)
        # Stamp the victim request's trace: when a fault fires inside a
        # traced request, the injection kind lands in that request's SLO
        # ledger record (``chaos_injections``), so attribution can tell
        # "slow because chaos froze it" from "slow, cause unknown".
        # suppress broadly: observability must never alter a chaos scenario
        with contextlib.suppress(Exception):
            from dynamo_tpu_torch.runtime import tracing
            from dynamo_tpu_torch.runtime.logging import current_trace

            trace = current_trace()
            if trace is not None and tracing.enabled():
                tracing.recorder().note_injection(trace.trace_id, kind)

    @classmethod
    def from_config(cls, cfg: ChaosConfig) -> "ChaosInjector | None":
        return cls(cfg) if cfg.enabled else None

    # -- fault points -------------------------------------------------------

    def should_drop_frame(self) -> bool:
        """Consulted per response data frame: True ⇒ cut the connection
        instead of sending this frame."""
        if self.config.frame_drop_p > 0 and self.rng.random() < self.config.frame_drop_p:
            self.stats.frames_dropped += 1
            self._count("frame_drop")
            return True
        return False

    def should_truncate(self) -> bool:
        """Consulted once per stream right before its final frame: True ⇒
        cut the connection instead of completing the stream."""
        if self.config.truncate_p > 0 and self.rng.random() < self.config.truncate_p:
            self.stats.streams_truncated += 1
            self._count("truncate")
            return True
        return False

    def maybe_kill(self) -> None:
        """Consulted per generation step by the engine: raises
        :class:`ChaosKillError` to simulate the worker dying mid-request."""
        if self.config.kill_p > 0 and self.rng.random() < self.config.kill_p:
            self.stats.kills += 1
            self._count("kill")
            raise ChaosKillError("injected worker death")

    def maybe_cut_transfer(self) -> None:
        """Consulted by the streaming KV data plane AFTER each chunk's
        frames (transfer.serve_kv_window): raises :class:`ChaosKillError`
        so the endpoint server cuts the transport BETWEEN chunks — on
        the wire, a prefill worker dying mid-transfer. The decode side
        must fall back to local prefill with byte-identical output
        (tests/test_disagg.py pins this)."""
        if (
            self.config.transfer_cut_p > 0
            and self.rng.random() < self.config.transfer_cut_p
        ):
            self.stats.transfer_cuts += 1
            self._count("transfer_cut")
            raise ChaosKillError("injected kv-transfer death")

    def maybe_kill_operator(self) -> None:
        """Consulted once per autoscaler control cycle: on a hit the
        operator process dies (``ChaosKillError``) BEFORE observing —
        possibly with a scale action half-applied. Recovery is the
        successor operator's level-based convergence
        (tests/test_autoscaler_chaos.py pins it)."""
        if (
            self.config.operator_kill_p > 0
            and self.rng.random() < self.config.operator_kill_p
        ):
            self.stats.operator_kills += 1
            self._count("operator_kill")
            raise ChaosKillError("injected operator death")

    MIGRATION_VICTIMS = ("source", "dest", "store")

    def maybe_cut_migration(self, phase: str) -> str | None:
        """Consulted by the migration coordinator (worker/migrate.py) at
        each phase boundary (``streaming``/``cutover``/``rebind``): on a
        hit, → a (seeded-)random victim among source/dest/store whose
        death the coordinator must then simulate at that phase. The
        client stream must still complete byte-identically via fallback
        (tests/test_migration_live.py pins every phase × victim cell).
        ``migration_cut_plan = "<phase>:<victim>"`` deterministically
        forces one cell. → None on no fault."""
        plan = self.config.migration_cut_plan
        if plan:
            want_phase, _, want_victim = plan.partition(":")
            if want_phase == phase and want_victim in self.MIGRATION_VICTIMS:
                self.stats.migration_cuts += 1
                self._count("migration_cut")
                return want_victim
        if (
            self.config.migration_cut_p > 0
            and self.rng.random() < self.config.migration_cut_p
        ):
            self.stats.migration_cuts += 1
            self._count("migration_cut")
            return self.rng.choice(self.MIGRATION_VICTIMS)
        return None

    def maybe_kill_frontend(self, candidates: list):
        """Consulted once per fleet-supervisor monitor tick: on a hit,
        → a (seeded-)random pick from ``candidates`` for the supervisor
        to SIGKILL — a frontend process dying under live traffic. The
        supervisor must restart it with backoff and the store lease TTL
        must return its admission-budget chunks (tests/test_fleet_chaos.py
        pins both). → None on no fault or no candidates."""
        if (
            not candidates
            or self.config.frontend_kill_p <= 0
            or self.rng.random() >= self.config.frontend_kill_p
        ):
            return None
        self.stats.frontend_kills += 1
        self._count("frontend_kill")
        return self.rng.choice(candidates)

    async def inject_latency(self) -> None:
        """Sleep a seeded uniform delay in [0, latency_ms]."""
        if self.config.latency_ms > 0:
            self.stats.latency_injections += 1
            self._count("latency")
            await asyncio.sleep(self.rng.uniform(0, self.config.latency_ms) / 1000.0)
