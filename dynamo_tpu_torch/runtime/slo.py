"""SLO attribution: per-class burn-rate EMAs + the shared attribution schema.

The ledger (runtime/tracing.py, schema v2) decomposes each finished
request into cross-process phases. This module turns that stream into
the control plane's evidence:

- :class:`SloBurnTracker` — per-class, per-phase **burn ratios**
  (``phase_duration / budget``) and attainment EMAs, exported as
  ``slo_budget_burn_ratio{class,phase}`` / ``slo_attainment_ema{class,budget}``
  gauges and consumed by the QoS admission gate (burn-aware early
  rejection) and anything else that wants to know *which pool* is
  spending the budget (Mooncake/DistServe framing — see PAPERS.md).
- :func:`attribution_summary` — one aggregation of ledger-shaped records
  into the shared attribution schema that ``bench.py``, the diurnal
  simulator, and ``/debug/slo`` all emit, so a regression localizes to a
  phase instead of a wall-clock delta.

Budget semantics: TTFT-phase burn divides by the class TTFT SLO;
decode-window burn divides by the total ITL budget
(``itl_slo × max(completion_tokens − 1, 1)``). Phases overlap by design
(``wire`` wraps the engine spans) so per-phase ratios are attribution
signals, not a partition that sums to 1.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable

from dynamo_tpu_torch.runtime.qos import DEFAULT_CLASS

__all__ = [
    "TTFT_PHASES",
    "DECODE_PHASES",
    "SloBurnTracker",
    "attribution_summary",
]

# Phases that spend the TTFT budget vs. the decode-window (ITL) budget.
# "wire" is excluded: it wraps queue_wait/prefill/decode and would
# double-attribute their time.
TTFT_PHASES = (
    "admission_wait", "preprocess", "route", "queue_wait",
    "prefill", "remote_prefill", "transfer",
)
DECODE_PHASES = ("decode", "migration_freeze", "redispatch")


class SloBurnTracker:
    """EMAs of SLO budget burn per (class, phase) + attainment per class.

    Fed one ledger record (schema v2) per finished request by the HTTP
    ingress; read by the admission gate (:meth:`attainment`), the
    ``/debug/slo`` surface (:meth:`snapshot`), and Prometheus via the
    two gauges. Thread-safe (the ledger is emitted from request tasks)."""

    def __init__(self, qos=None, registry=None, alpha: float = 0.15):
        # QosPolicy | None — fallback source of budgets for records that
        # carry phases but no slo block (e.g. merged from older children).
        self.qos = qos
        self._alpha = alpha
        self._lock = threading.Lock()
        self._burn: dict[tuple[str, str], float] = {}
        self._attain: dict[tuple[str, str], float] = {}
        self._observed: dict[str, int] = {}
        if registry is not None:
            scope = registry.child("slo")
            self.m_burn = scope.gauge(
                "slo_budget_burn_ratio",
                "EMA of per-phase SLO budget burn by QoS class: phase "
                "duration / TTFT SLO for pre-first-token phases, / total "
                "ITL budget for decode-window phases (ledger schema v2)",
            )
            self.m_attain = scope.gauge(
                "slo_attainment_ema",
                "EMA of SLO attainment (1 = attained) by QoS class and "
                "budget (ttft / itl)",
            )
        else:
            self.m_burn = None
            self.m_attain = None

    # -- write side ---------------------------------------------------------

    def observe(self, record: dict) -> None:
        """Fold one ledger record (schema v2) into the EMAs."""
        cls = record.get("qos") or DEFAULT_CLASS
        slo = record.get("slo") or {}
        ttft_slo = slo.get("ttft_slo_s")
        itl_slo = slo.get("itl_slo_s")
        if self.qos is not None and cls in self.qos.classes:
            qc = self.qos.classes[cls]
            if ttft_slo is None and qc.ttft_slo_s > 0:
                ttft_slo = qc.ttft_slo_s
            if itl_slo is None and qc.itl_slo_s > 0:
                itl_slo = qc.itl_slo_s
        phases = record.get("phases") or {}
        completion = record.get("completion_tokens") or 0
        itl_budget = (
            itl_slo * max(completion - 1, 1) if itl_slo else None
        )
        updates: list[tuple[str, float]] = []
        for phase, dur in phases.items():
            if phase in DECODE_PHASES:
                if itl_budget:
                    updates.append((phase, dur / itl_budget))
            elif ttft_slo:
                updates.append((phase, dur / ttft_slo))
        with self._lock:
            self._observed[cls] = self._observed.get(cls, 0) + 1
            for phase, ratio in updates:
                key = (cls, phase)
                prev = self._burn.get(key)
                ema = ratio if prev is None else prev + self._alpha * (ratio - prev)
                self._burn[key] = ema
                if self.m_burn is not None:
                    self.m_burn.set(ema, **{"class": cls, "phase": phase})
            for budget, attained in (
                ("ttft", slo.get("ttft_attained")),
                ("itl", slo.get("itl_attained")),
            ):
                if attained is None:
                    continue
                key = (cls, budget)
                x = 1.0 if attained else 0.0
                prev = self._attain.get(key)
                ema = x if prev is None else prev + self._alpha * (x - prev)
                self._attain[key] = ema
                if self.m_attain is not None:
                    self.m_attain.set(ema, **{"class": cls, "budget": budget})

    # -- read side ----------------------------------------------------------

    def burn(self, cls: str, phase: str) -> float | None:
        with self._lock:
            return self._burn.get((cls, phase))

    def attainment(self, cls: str, budget: str = "ttft") -> float | None:
        with self._lock:
            return self._attain.get((cls, budget))

    def observed(self, cls: str) -> int:
        with self._lock:
            return self._observed.get(cls, 0)

    def snapshot(self) -> dict:
        """Whole-tracker view for ``/debug/slo`` and planner reads."""
        with self._lock:
            classes: dict[str, Any] = {}
            for (cls, phase), ema in sorted(self._burn.items()):
                classes.setdefault(cls, {"burn": {}, "attainment": {}})
                classes[cls]["burn"][phase] = round(ema, 6)
            for (cls, budget), ema in sorted(self._attain.items()):
                classes.setdefault(cls, {"burn": {}, "attainment": {}})
                classes[cls]["attainment"][budget] = round(ema, 6)
            for cls, n in self._observed.items():
                classes.setdefault(cls, {"burn": {}, "attainment": {}})
                classes[cls]["observed"] = n
        return {"schema": 2, "classes": classes}


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def attribution_summary(
    records: Iterable[dict],
    *,
    ttft_slo_s: float | None = None,
    itl_slo_ms: float | None = None,
) -> dict:
    """Aggregate ledger-shaped records into the shared attribution schema.

    ``records`` need only be ledger-*shaped*: dicts with optional
    ``ttft_s``, ``itl_s``, ``duration_s``, ``completion_tokens`` and a
    ``phases`` mapping — bench.py and the diurnal simulator synthesize
    them from their own bookkeeping; the HTTP ingress passes real ledger
    records. Output schema (stable — emitted verbatim into bench/diurnal
    result JSON and ``/debug/slo``)::

        {"schema": 2, "requests": N,
         "phases": {phase: {"total_s", "mean_s", "share"}},
         "ttft": {"mean_s", "p99_s"},
         "slo": {"ttft_slo_s", "ttft_attainment", "itl_slo_ms",
                 "itl_attainment", "burn": {phase: mean_ratio}}}

    ``share`` is each phase's fraction of summed phase time (where the
    time went); ``burn`` divides by the budget (what it cost) — absent
    without SLO targets.
    """
    recs = [r for r in records if isinstance(r, dict)]
    n = len(recs)
    phase_tot: dict[str, float] = {}
    phase_n: dict[str, int] = {}
    ttfts: list[float] = []
    ttft_ok = 0
    ttft_n = 0
    itl_ok = 0
    itl_n = 0
    burn_tot: dict[str, float] = {}
    burn_n: dict[str, int] = {}
    for r in recs:
        phases = r.get("phases") or {}
        completion = r.get("completion_tokens") or 0
        itl_budget_s = (
            (itl_slo_ms / 1000.0) * max(completion - 1, 1)
            if itl_slo_ms else None
        )
        for phase, dur in phases.items():
            if dur is None:
                continue
            phase_tot[phase] = phase_tot.get(phase, 0.0) + dur
            phase_n[phase] = phase_n.get(phase, 0) + 1
            budget = (
                itl_budget_s if phase in DECODE_PHASES else ttft_slo_s
            )
            if budget:
                burn_tot[phase] = burn_tot.get(phase, 0.0) + dur / budget
                burn_n[phase] = burn_n.get(phase, 0) + 1
        ttft = r.get("ttft_s")
        if ttft is not None:
            ttfts.append(ttft)
            if ttft_slo_s:
                ttft_n += 1
                ttft_ok += 1 if ttft <= ttft_slo_s else 0
        itl = r.get("itl_s")
        if itl is not None and itl_slo_ms:
            itl_n += 1
            itl_ok += 1 if itl * 1000.0 <= itl_slo_ms else 0
    total_phase_s = sum(phase_tot.values())
    ttfts.sort()
    out: dict[str, Any] = {
        "schema": 2,
        "requests": n,
        "phases": {
            phase: {
                "total_s": round(tot, 6),
                "mean_s": round(tot / phase_n[phase], 6),
                "share": round(tot / total_phase_s, 4) if total_phase_s else 0.0,
            }
            for phase, tot in sorted(phase_tot.items())
        },
        "ttft": {
            "mean_s": round(sum(ttfts) / len(ttfts), 6) if ttfts else None,
            "p99_s": round(_percentile(ttfts, 0.99), 6) if ttfts else None,
        },
    }
    if ttft_slo_s or itl_slo_ms:
        slo: dict[str, Any] = {"burn": {
            phase: round(burn_tot[phase] / burn_n[phase], 6)
            for phase in sorted(burn_tot)
        }}
        if ttft_slo_s:
            slo["ttft_slo_s"] = ttft_slo_s
            slo["ttft_attainment"] = (
                round(ttft_ok / ttft_n, 4) if ttft_n else None
            )
        if itl_slo_ms:
            slo["itl_slo_ms"] = itl_slo_ms
            slo["itl_attainment"] = (
                round(itl_ok / itl_n, 4) if itl_n else None
            )
        out["slo"] = slo
    return out
