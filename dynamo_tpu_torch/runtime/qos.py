"""Multi-tenant QoS: priority classes, weighted fair shares, and
admission-time SLO prediction.

Millions of users means tenants with different SLOs sharing one fleet.
This module defines the shared vocabulary every layer speaks:

- **classes** — ``interactive`` / ``standard`` / ``batch``, ranked by
  urgency. A request carries its class (``priority`` body field or
  ``x-priority`` header) and tenant end to end: HTTP → preprocessor →
  wire → engine, so every admission and eviction decision can be
  goodput-aware (DistServe's headline metric: SLO-attaining tokens per
  second at equal chip count, arXiv 2401.09670).
- **policy** — per-class weight (the WDRR fair share the admission gate
  drains queues by), TTFT SLO (what the early-rejection predictor
  checks against), and an aging bonus so batch can't starve.
- **prediction** — Mooncake-style (arXiv 2407.00079) admission-time
  TTFT estimation from queue depth + the profiled
  :class:`~dynamo_tpu_torch.planner.interpolate.PrefillInterpolator`, so an
  overloaded frontend 429s *before* prefill spends chips instead of
  shedding mid-stream.

No-QoS deployments never construct a policy: requests without a
priority resolve to the default class and every fair-share mechanism
degenerates to strict FIFO — byte-identical to the pre-QoS path.
"""

from __future__ import annotations

from dataclasses import dataclass

# Canonical class names, highest urgency first. The rank is the
# engine's preemption/admission sort key (higher = served first,
# preempted last); the index into this tuple is NOT the rank.
QOS_CLASSES = ("interactive", "standard", "batch")
DEFAULT_CLASS = "standard"

_RANK = {"batch": 0, "standard": 1, "interactive": 2}


def qos_rank(priority: str | None) -> int:
    """Class name → scheduling rank (higher served first). Unknown or
    absent priorities rank as the default class — the engine must never
    crash on a wire value a newer/older frontend stamped."""
    return _RANK.get(priority or DEFAULT_CLASS, _RANK[DEFAULT_CLASS])


def parse_priority(value: str) -> str:
    """Validate a client-supplied priority value → canonical class name.
    Raises ``ValueError`` on junk (the HTTP layer maps it to a typed
    400; the engine treats unknowns as the default class instead —
    the frontend is the validation boundary, the engine is not)."""
    name = value.strip().lower()
    if name not in QOS_CLASSES:
        raise ValueError(
            f"priority must be one of {', '.join(QOS_CLASSES)}; got {value!r}"
        )
    return name


def parse_tenant(value: str) -> str:
    """Validate a client-supplied tenant id. Bounded printable string —
    it becomes a metrics label and a ledger field, so junk must stop at
    the door. Raises ``ValueError`` on junk."""
    tenant = value.strip()
    if not tenant or len(tenant) > 128:
        raise ValueError("tenant must be a non-empty string of at most 128 chars")
    if any(c.isspace() or not c.isprintable() for c in tenant) or '"' in tenant:
        raise ValueError("tenant must be printable without whitespace or quotes")
    return tenant


@dataclass(frozen=True)
class QosClass:
    """One priority class's policy knobs."""

    name: str
    rank: int            # scheduling rank: higher = more urgent
    weight: int          # WDRR fair share of freed admission slots
    ttft_slo_s: float    # TTFT SLO the early-rejection predictor enforces
    itl_slo_s: float = 0.0  # ITL SLO (0 = none) — goodput accounting input


class QosPolicy:
    """The admission gate's view of the class system: WDRR weights,
    SLOs, the default class, and the anti-starvation aging bonus.

    ``aging_s``: a class whose head-of-queue waiter has waited this
    long earns one bonus deficit credit per replenish round on top of
    its weight — so under sustained interactive overload batch still
    advances faster than its weight alone would allow (weights bound
    shares, aging bounds waits)."""

    def __init__(
        self,
        classes: list[QosClass] | None = None,
        default: str = DEFAULT_CLASS,
        aging_s: float = 5.0,
    ):
        if classes is None:
            classes = [
                QosClass("interactive", 2, 8, 2.0, 0.2),
                QosClass("standard", 1, 4, 10.0, 1.0),
                QosClass("batch", 0, 1, 60.0, 0.0),
            ]
        if not classes:
            raise ValueError("QosPolicy needs at least one class")
        # Weight 0 would starve the WDRR replenish round (a class with
        # demand must always earn at least one credit eventually).
        classes = [
            c if c.weight >= 1 else QosClass(c.name, c.rank, 1, c.ttft_slo_s,
                                             c.itl_slo_s)
            for c in classes
        ]
        self.classes = {c.name: c for c in classes}
        if default not in self.classes:
            raise ValueError(f"default class {default!r} not in {list(self.classes)}")
        self.default = default
        self.aging_s = aging_s
        # Drain order: most urgent first (WDRR serves eligible classes
        # in this order within a replenish round).
        self.order = [c.name for c in sorted(classes, key=lambda c: -c.rank)]

    @classmethod
    def from_config(cls, qcfg) -> "QosPolicy":
        """Build from the ``[qos]`` config section
        (:class:`~dynamo_tpu_torch.runtime.config.QosConfig`)."""
        return cls(
            classes=[
                QosClass("interactive", 2, qcfg.weight_interactive,
                         qcfg.ttft_slo_interactive_s, qcfg.itl_slo_interactive_s),
                QosClass("standard", 1, qcfg.weight_standard,
                         qcfg.ttft_slo_standard_s, qcfg.itl_slo_standard_s),
                QosClass("batch", 0, qcfg.weight_batch,
                         qcfg.ttft_slo_batch_s, qcfg.itl_slo_batch_s),
            ],
            default=qcfg.default_class,
            aging_s=qcfg.aging_s,
        )

    def resolve(self, priority: str | None) -> str:
        """Request priority → class name (absent → default). Unknown
        names raise ``ValueError`` — callers validate at the boundary."""
        if priority is None:
            return self.default
        if priority not in self.classes:
            raise ValueError(f"unknown priority class {priority!r}")
        return priority

    def rank(self, name: str) -> int:
        return self.classes[name].rank

    def weight(self, name: str) -> int:
        return self.classes[name].weight

    def ttft_slo(self, name: str) -> float:
        return self.classes[name].ttft_slo_s


class TtftPredictor:
    """Admission-time TTFT prediction (Mooncake, arXiv 2407.00079 §5):
    estimate what this request's TTFT *would* be from the current queue
    depth and the chip's profiled prefill curve, so the gate can shed
    with a 429 before prefill spends chips.

    Two independent estimates, combined by max (either signal alone is
    enough evidence of violation):

    - **model-based**: the profiled single-request TTFT at the running
      mean prompt length, serialized behind the ``queued_ahead``
      requests that the fair-share gate would drain first — each of
      them needs its own prefill pass before ours runs;
    - **observed**: ``queued_ahead`` × the gate's measured inter-release
      interval (supplied by the caller — the admission controller owns
      that EMA), which captures decode-bound drain the prefill curve
      can't see.

    With no profile loaded the model half returns ``None`` and only the
    observed half (if any) applies — a frontend without a profile sheds
    on queue-timeout exactly as before."""

    def __init__(self, prefill=None, decode=None, prompt_len_ema: float = 256.0,
                 alpha: float = 0.1):
        self.prefill = prefill    # planner.interpolate.PrefillInterpolator | None
        self.decode = decode      # planner.interpolate.DecodeInterpolator | None
        self._prompt_ema = float(prompt_len_ema)
        self._alpha = alpha

    @property
    def prompt_len_ema(self) -> float:
        return self._prompt_ema

    def observe_prompt_len(self, n: int) -> None:
        """Feed an observed prompt length (post-tokenization, reported
        back by the serving path) into the running mean the prediction
        uses — admission runs before the body is even parsed, so the
        predictor can only know *typical* prompts, not this one."""
        self._prompt_ema += self._alpha * (float(n) - self._prompt_ema)

    def predict(self, queued_ahead: int, drain_interval_s: float = 0.0) -> float | None:
        """→ predicted TTFT seconds for a request entering the queue
        behind ``queued_ahead`` others, or None when there is no basis
        for a model estimate and no observed drain signal."""
        model_est = None
        if self.prefill is not None:
            per_req_s = self.prefill.ttft_at(self._prompt_ema) / 1000.0
            model_est = (queued_ahead + 1) * per_req_s
        observed_est = (
            queued_ahead * drain_interval_s if drain_interval_s > 0.0 else None
        )
        if model_est is None and observed_est is None:
            return None
        return max(model_est or 0.0, observed_est or 0.0)
