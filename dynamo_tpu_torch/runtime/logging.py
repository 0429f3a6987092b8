"""Structured logging with W3C trace-context propagation.

Reference analogue: tracing-subscriber setup with ``DYN_LOG`` filter, JSONL
mode, and ``traceparent`` propagation into spans
(reference: lib/runtime/src/logging.rs:8-16,69-75,131-204).

Here: stdlib logging with an optional JSONL formatter (``DYNTPU_LOGGING_JSONL``),
level from ``DYNTPU_LOG``, and a ``TraceContext`` carried per-request through
contextvars so every log line within a request handler is stamped with the
distributed trace id.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import re
import secrets
import sys
import time
from dataclasses import dataclass

_TRACEPARENT_RE = re.compile(r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


@dataclass(frozen=True)
class TraceContext:
    """Parsed W3C ``traceparent`` plus opaque ``tracestate``."""

    trace_id: str
    parent_span_id: str
    flags: str = "01"
    tracestate: str | None = None

    @classmethod
    def parse(cls, traceparent: str, tracestate: str | None = None) -> "TraceContext | None":
        m = _TRACEPARENT_RE.match(traceparent.strip().lower())
        if not m:
            return None
        version, trace_id, span_id, flags = m.groups()
        if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return cls(trace_id=trace_id, parent_span_id=span_id, flags=flags, tracestate=tracestate)

    @classmethod
    def new_root(cls) -> "TraceContext":
        return cls(trace_id=secrets.token_hex(16), parent_span_id=secrets.token_hex(8))

    # NOTE: span ids within a trace are minted by runtime/tracing.py at
    # actual span boundaries (Span.trace_context()); re-minting one here
    # would reference a span id no span owns and orphan downstream spans.

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.parent_span_id}-{self.flags}"


_current_trace: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "dynamo_tpu_trace", default=None
)


def current_trace() -> TraceContext | None:
    return _current_trace.get()


def set_current_trace(ctx: TraceContext | None) -> contextvars.Token:
    return _current_trace.set(ctx)


def reset_current_trace(token: contextvars.Token) -> None:
    _current_trace.reset(token)


# LogRecord's own attributes — everything else on a record arrived via
# ``extra={...}`` and belongs in the JSON output as structured fields.
_RESERVED_RECORD_ATTRS = frozenset(
    vars(logging.makeLogRecord({}))
) | {"message", "asctime", "taskName"}


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        trace = current_trace()
        if trace is not None:
            out["trace_id"] = trace.trace_id
            out["span_id"] = trace.parent_span_id
        # Structured extra={...} fields (ledger records, subsystem key/values)
        # ride along instead of being dropped; core keys are never shadowed.
        for key, value in record.__dict__.items():
            if key in _RESERVED_RECORD_ATTRS or key.startswith("_") or key in out:
                continue
            out[key] = value
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False, default=repr)


class TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        trace = current_trace()
        tid = f" trace={trace.trace_id[:8]}" if trace else ""
        base = (
            f"{self.formatTime(record, '%H:%M:%S')} {record.levelname:<5} "
            f"{record.name}{tid}: {record.getMessage()}"
        )
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


_configured = False


def init_logging(level: str | None = None, jsonl: bool | None = None) -> None:
    """Idempotent global logging setup. Level from ``DYNTPU_LOG`` (default INFO)."""
    global _configured
    if _configured:
        return
    _configured = True
    level = level or os.environ.get("DYNTPU_LOG", "INFO")
    if jsonl is None:
        jsonl = os.environ.get("DYNTPU_LOGGING_JSONL", "").lower() in ("1", "true")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(JsonlFormatter() if jsonl else TextFormatter())
    root = logging.getLogger("dynamo_tpu_torch")
    root.setLevel(level.upper())
    root.addHandler(handler)
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    init_logging()
    return logging.getLogger(f"dynamo_tpu_torch.{name}")
