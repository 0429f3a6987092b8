"""Hierarchical Prometheus-style metrics registry.

Reference analogue: ``MetricsRegistry`` with hierarchical names
drt→namespace→component→endpoint and auto-labels
(reference: lib/runtime/src/metrics.rs:69,385).

Pure-Python implementation: counters, gauges, histograms with constant
labels inherited down the hierarchy; text exposition compatible with the
Prometheus scrape format.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

PREFIX = "dynamo_tpu"

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, math.inf,
)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, const_labels: dict[str, str]):
        self.name = name
        self.help = help_
        self.const_labels = dict(const_labels)
        self._lock = threading.Lock()

    def _header(self, with_header: bool) -> list[str]:
        if not with_header:
            return []
        return [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]

    def render(self, with_header: bool = True) -> list[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def _render_values(self, values: dict, with_header: bool) -> list[str]:
        lines = self._header(with_header)
        for key, v in values.items() or [((), 0.0)]:
            labels = {**self.const_labels, **dict(key)}
            lines.append(f"{self.name}{_fmt_labels(labels)} {_fmt_value(v)}")
        return lines


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, help_, const_labels):
        super().__init__(name, help_, const_labels)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self, with_header: bool = True) -> list[str]:
        with self._lock:
            values = dict(self._values)
        return self._render_values(values, with_header)


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name, help_, const_labels):
        super().__init__(name, help_, const_labels)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def remove(self, **labels: str) -> None:
        """Drop one label series (e.g. a scaled-down worker's gauges —
        without this, dead workers report their last values forever)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values.pop(key, None)

    def add(self, amount: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self, with_header: bool = True) -> list[str]:
        with self._lock:
            values = dict(self._values)
        return self._render_values(values, with_header)


class InflightGuard:
    """RAII-style guard incrementing a gauge for the lifetime of a request
    (reference: per-model inflight guards, lib/llm/src/http/service/metrics.rs:35-119)."""

    def __init__(self, gauge: Gauge, **labels: str):
        self._gauge = gauge
        self._labels = labels
        gauge.add(1.0, **labels)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._gauge.add(-1.0, **self._labels)
        return False


@dataclass
class _HistState:
    buckets: list[float] = field(default_factory=list)
    counts: list[int] = field(default_factory=list)
    total: float = 0.0
    n: int = 0


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, help_, const_labels, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, const_labels)
        self.buckets = tuple(buckets) if buckets[-1] == math.inf else tuple(buckets) + (math.inf,)
        self._states: dict[tuple, _HistState] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = _HistState(list(self.buckets), [0] * len(self.buckets))
                self._states[key] = st
            for i, b in enumerate(st.buckets):
                if value <= b:
                    st.counts[i] += 1
            st.total += value
            st.n += 1

    def render(self, with_header: bool = True) -> list[str]:
        lines = self._header(with_header)
        with self._lock:
            items = list(self._states.items())
        for key, st in items:
            base = {**self.const_labels, **dict(key)}
            for b, c in zip(st.buckets, st.counts):
                lines.append(
                    f"{self.name}_bucket{_fmt_labels({**base, 'le': _fmt_value(b)})} {c}"
                )
            lines.append(f"{self.name}_sum{_fmt_labels(base)} {_fmt_value(st.total)}")
            lines.append(f"{self.name}_count{_fmt_labels(base)} {st.n}")
        return lines


class MetricsRegistry:
    """A node in the metrics hierarchy.

    ``registry.child("ns").child("component")`` produces scoped registries:
    metric names get no extra nesting, but constant labels
    (``dynamo_namespace``, ``dynamo_component``, ``dynamo_endpoint``) are
    inherited, matching the reference's auto-label scheme
    (reference: lib/runtime/src/metrics.rs:385)."""

    _LEVEL_LABELS = ("dynamo_namespace", "dynamo_component", "dynamo_endpoint")

    def __init__(self, const_labels: dict[str, str] | None = None, _root: "MetricsRegistry | None" = None, depth: int = 0):
        self.const_labels = dict(const_labels or {})
        self._root = _root or self
        self._depth = depth
        if _root is None:
            # Keyed by (name, const-label set): the same metric name used in two
            # scopes (e.g. two components) must be two series, not one.
            self._metrics: dict[tuple[str, frozenset], Metric] = {}
            self._kinds: dict[str, type] = {}
            self._lock = threading.Lock()

    def child(self, name: str) -> "MetricsRegistry":
        labels = dict(self.const_labels)
        if self._depth < len(self._LEVEL_LABELS):
            labels[self._LEVEL_LABELS[self._depth]] = name
        return MetricsRegistry(labels, _root=self._root, depth=self._depth + 1)

    def _register(self, cls, name: str, help_: str, **kw) -> Metric:
        full = f"{PREFIX}_{name}"
        key = (full, frozenset(self.const_labels.items()))
        root = self._root
        with root._lock:
            registered = root._kinds.get(full)
            if registered is not None and registered is not cls:
                # Same name must be one type everywhere: Prometheus emits one
                # TYPE header per name across all label scopes.
                raise TypeError(
                    f"metric {full} already registered as {registered.kind}"
                )
            root._kinds[full] = cls
            existing = root._metrics.get(key)
            if existing is not None:
                return existing
            metric = cls(full, help_, self.const_labels, **kw)
            root._metrics[key] = metric
            return metric

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._register(Counter, name, help_)  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._register(Gauge, name, help_)  # type: ignore[return-value]

    def histogram(self, name: str, help_: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help_, buckets=buckets)  # type: ignore[return-value]

    def render(self) -> str:
        root = self._root
        with root._lock:
            metrics = list(root._metrics.values())
        lines: list[str] = []
        seen_names: set[str] = set()
        for m in sorted(metrics, key=lambda m: m.name):
            lines.extend(m.render(with_header=m.name not in seen_names))
            seen_names.add(m.name)
        return "\n".join(lines) + "\n"
