"""Layered runtime configuration.

Mirrors the reference's figment stack — defaults → TOML file → env overrides
(reference: lib/runtime/src/config.rs:25-214) — with ``DYNTPU_*`` environment
variables in place of ``DYN_RUNTIME_*``.

Precedence (lowest→highest): dataclass defaults, TOML file named by
``DYNTPU_CONFIG``, then ``DYNTPU_<SECTION>_<FIELD>`` env vars.
"""

from __future__ import annotations

import dataclasses
import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11 — TOML layer degrades to a no-op
    try:
        import tomli as tomllib  # type: ignore[no-redef]
    except ModuleNotFoundError:
        tomllib = None  # type: ignore[assignment]
from dataclasses import dataclass, field
from typing import Any

_ENV_PREFIX = "DYNTPU"


class ConfigError(Exception):
    """Startup configuration is unusable (missing parser, bad layer) —
    typed so launchers can distinguish operator error from a crash."""


def _coerce(value: str, typ: Any) -> Any:
    if typ is bool:
        return value.strip().lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


@dataclass
class RuntimeConfig:
    """Worker/runtime-level knobs (section ``[runtime]``, env ``DYNTPU_RUNTIME_*``)."""

    # Number of worker threads for compute-adjacent thread pools (0 = ncpu).
    num_worker_threads: int = 0
    # Grace period (s) for in-flight requests during shutdown.
    graceful_shutdown_timeout: float = 30.0
    # Maximum concurrent in-flight requests an endpoint accepts; excess
    # requests are refused with a typed "overloaded" error the router
    # retries elsewhere (worker-side admission gate).
    max_inflight: int = 4096
    # Default end-to-end request deadline seconds (0 = unbounded); the
    # ingress applies it when the client sends no X-Request-Timeout.
    default_request_timeout: float = 0.0
    # Router retry hygiene: jittered exponential backoff between attempts.
    retry_backoff_base: float = 0.05
    retry_backoff_max: float = 2.0
    # Per-instance circuit breaker: seconds an instance marked down stays
    # excluded before a half-open probe is allowed.
    circuit_cooldown: float = 5.0

    @classmethod
    def section(cls) -> str:
        return "runtime"


@dataclass
class StoreConfig:
    """Control-plane store client config (section ``[store]``, env ``DYNTPU_STORE_*``)."""

    # URL of the store server, e.g. "tcp://127.0.0.1:3280". "memory://" selects
    # the in-process store (single-process deployments and tests).
    url: str = "memory://"
    # Lease time-to-live seconds; keepalives are sent at ttl/3.
    lease_ttl: float = 10.0
    connect_timeout: float = 5.0

    @classmethod
    def section(cls) -> str:
        return "store"


@dataclass
class SystemConfig:
    """System status server (section ``[system]``, env ``DYNTPU_SYSTEM_*``).

    Reference analogue: env-gated health/metrics server
    (reference: lib/runtime/src/config.rs:98-123, http_server.rs:33-69).
    """

    enabled: bool = False
    host: str = "0.0.0.0"
    port: int = 9090

    @classmethod
    def section(cls) -> str:
        return "system"


@dataclass
class AdmissionConfig:
    """Frontend admission control (section ``[admission]``, env
    ``DYNTPU_ADMISSION_*``): bound what the ingress accepts instead of
    queueing unboundedly under overload."""

    # Maximum concurrent inference requests admitted (0 = unlimited).
    max_inflight: int = 0
    # Additional requests allowed to queue for a slot before shedding
    # (only meaningful with max_inflight > 0).
    max_queue_depth: int = 0
    # Retry-After seconds advertised on 429/503 shed responses.
    retry_after: float = 1.0
    # Max seconds a queued request waits for a slot before it is shed
    # anyway (a queued wait must never become a hang).
    queue_timeout: float = 5.0

    @classmethod
    def section(cls) -> str:
        return "admission"


@dataclass
class QosConfig:
    """Multi-tenant QoS (section ``[qos]``, env ``DYNTPU_QOS_*``):
    priority classes, WDRR fair-share weights, per-class TTFT/ITL SLOs,
    and the anti-starvation aging bonus (see runtime/qos.py and
    docs/qos.md). ``enabled`` gates the whole feature — off (the
    default) keeps every request in ``default_class`` and the admission
    gate byte-identical to the pre-QoS FIFO path."""

    enabled: bool = False
    # Class every request without a priority resolves to.
    default_class: str = "standard"
    # WDRR weights: the share of freed admission slots each class with
    # demand receives per replenish round.
    weight_interactive: int = 8
    weight_standard: int = 4
    weight_batch: int = 1
    # TTFT SLOs (s) the early-rejection predictor enforces per class
    # (0 = never early-reject this class).
    ttft_slo_interactive_s: float = 2.0
    ttft_slo_standard_s: float = 10.0
    ttft_slo_batch_s: float = 60.0
    # ITL SLOs (s/token; 0 = none) — goodput accounting inputs.
    itl_slo_interactive_s: float = 0.2
    itl_slo_standard_s: float = 1.0
    itl_slo_batch_s: float = 0.0
    # A class whose head-of-queue waiter has waited this long earns one
    # bonus WDRR credit per replenish round (bounds batch's worst-case
    # wait under sustained interactive overload; 0 disables aging).
    aging_s: float = 5.0
    # Fleet-wide per-class budget shares (relative; normalized over the
    # sum). Drives how --global-max-inflight splits into per-class
    # chunk pools when QoS is enabled in fleet mode.
    share_interactive: int = 8
    share_standard: int = 4
    share_batch: int = 4

    @classmethod
    def section(cls) -> str:
        return "qos"


@dataclass
class ChaosConfig:
    """Deterministic fault injection (section ``[chaos]``, env
    ``DYNTPU_CHAOS_*``). Off by default; when enabled, the messaging layer
    and mock engine draw faults from a seeded RNG so failure scenarios are
    reproducible (see runtime/chaos.py)."""

    enabled: bool = False
    seed: int = 0
    # Probability a response data frame is "dropped": the connection is cut
    # at a frame boundary (detectable truncation, never silent corruption).
    frame_drop_p: float = 0.0
    # Probability a stream is truncated right before its final frame.
    truncate_p: float = 0.0
    # Probability the (mock) engine dies mid-generation.
    kill_p: float = 0.0
    # Probability the streaming KV data plane (llm/disagg.py kv_fetch)
    # cuts the connection AFTER a chunk — the prefill worker "dying
    # between chunks" mid-transfer.
    transfer_cut_p: float = 0.0
    # Probability (per fleet-supervisor monitor tick) a random frontend
    # child is SIGKILLed — exercises restart backoff + budget-lease
    # reclamation while sibling processes keep streaming.
    frontend_kill_p: float = 0.0
    # Probability (per autoscaler control cycle) the operator process
    # dies before its step — exercises level-based convergence: the
    # successor must finish any half-applied scale from live state.
    operator_kill_p: float = 0.0
    # Injected per-frame latency: uniform in [0, latency_ms].
    latency_ms: float = 0.0
    # Probability a live-migration phase boundary (worker/migrate.py:
    # streaming, cutover, rebind) is cut, killing a seeded-random victim
    # among source/dest/store. The stream must still complete via the
    # re-dispatch fallback — never a client-visible error.
    migration_cut_p: float = 0.0
    # Deterministic pin for the migration chaos grid: "<phase>:<victim>"
    # (e.g. "cutover:dest") forces exactly that cut on every matching
    # phase consult, independent of migration_cut_p. Empty = off.
    migration_cut_plan: str = ""

    @classmethod
    def section(cls) -> str:
        return "chaos"


@dataclass
class FleetConfig:
    """Frontend fleet (section ``[fleet]``, env ``DYNTPU_FLEET_*``):
    multi-process HTTP tier knobs (dynamo_tpu/fleet/)."""

    # Fleet-wide concurrent-request budget shared by every frontend
    # process through store chunk leases (0 = no shared budget; each
    # process falls back to its own [admission] bounds).
    global_max_inflight: int = 0
    # Slots per budget chunk — the claim granularity. Smaller chunks
    # pack tighter under skewed load; larger ones claim less often.
    budget_chunk_slots: int = 8
    # Seconds a published router decision stays visible to sibling
    # processes (rotating write leases; entries live TTL/2..TTL).
    decision_ttl: float = 120.0
    # Supervisor restart hygiene: jittered exponential backoff between
    # respawns of a crashing child, reset once it survives reset_after.
    restart_backoff_base: float = 0.5
    restart_backoff_max: float = 10.0
    restart_reset_after: float = 30.0
    # Supervisor crash-detection poll interval (also the chaos
    # frontend-kill draw cadence).
    monitor_interval: float = 0.25

    @classmethod
    def section(cls) -> str:
        return "fleet"


@dataclass
class Config:
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    system: SystemConfig = field(default_factory=SystemConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    qos: QosConfig = field(default_factory=QosConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "Config":
        """Build config honoring precedence defaults < TOML < env."""
        env = dict(os.environ if env is None else env)
        layers: dict[str, dict[str, Any]] = {}
        toml_path = env.get(f"{_ENV_PREFIX}_CONFIG")
        if toml_path and os.path.exists(toml_path):
            if tomllib is None:
                raise ConfigError(
                    f"{_ENV_PREFIX}_CONFIG={toml_path!r} set but no TOML parser "
                    "available (Python < 3.11 without tomli)"
                )
            with open(toml_path, "rb") as f:
                layers = tomllib.load(f)

        cfg = cls()
        for section_obj in (cfg.runtime, cfg.store, cfg.system, cfg.admission, cfg.qos, cfg.chaos, cfg.fleet):
            section = section_obj.section()
            toml_section = layers.get(section, {})
            for f_ in dataclasses.fields(section_obj):
                if f_.name in toml_section:
                    setattr(section_obj, f_.name, toml_section[f_.name])
                env_key = f"{_ENV_PREFIX}_{section.upper()}_{f_.name.upper()}"
                if env_key in env:
                    setattr(section_obj, f_.name, _coerce(env[env_key], f_.type if isinstance(f_.type, type) else type(getattr(section_obj, f_.name))))
        return cfg


_GLOBAL: Config | None = None


def global_config() -> Config:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Config.from_env()
    return _GLOBAL


def reset_global_config() -> None:
    global _GLOBAL
    _GLOBAL = None
