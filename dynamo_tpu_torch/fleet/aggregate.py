"""Fleet aggregation: merge per-process observability surfaces into one.

The fleet shares ONE inference port, so a ``GET /metrics`` against it
lands on an arbitrary child — useless for scraping. Each child therefore
exposes a per-process admin site (ephemeral port, registered in the
store), and the supervisor's aggregation endpoint merges them:

- ``/metrics``: Prometheus expositions concatenated per metric family
  (HELP/TYPE once, all children's samples grouped) with every sample
  relabeled ``fleet_worker_id="<i>"`` so per-process series stay
  distinguishable after aggregation;
- ``/debug/requests``: ledger records concatenated, each tagged with
  ``fleet_worker_id``;
- ``/debug/traces/{trace_id}``: per-child Chrome-trace bodies stitched
  into ONE timeline — each child's spans keep (or gain) a process lane,
  relabeled ``<worker_id>/<lane>`` by the same convention the metrics
  merge uses, then reassembled deterministically by
  :func:`~dynamo_tpu_torch.runtime.tracing.chrome_trace_from_dicts`.
"""

from __future__ import annotations

import re

_SAMPLE_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})?\s+(\S+)\s*$")
_FAMILY_SUFFIXES = ("_bucket", "_sum", "_count")


def relabel_sample(line: str, label: str, value: str) -> str | None:
    """Inject ``label="value"`` into one exposition sample line.
    → None when the line is not a sample (blank/comment/garbage)."""
    m = _SAMPLE_RE.match(line)
    if m is None:
        return None
    name, labels, val = m.groups()
    inject = f'{label}="{value}"'
    if labels:
        body = labels[1:-1]
        new = "{" + (f"{inject},{body}" if body else inject) + "}"
    else:
        new = "{" + inject + "}"
    return f"{name}{new} {val}"


def _family(name: str, families: set[str]) -> str:
    """Histogram samples (``x_bucket``/``x_sum``/``x_count``) belong to
    family ``x``; everything else is its own family."""
    for suffix in _FAMILY_SUFFIXES:
        if name.endswith(suffix) and name[: -len(suffix)] in families:
            return name[: -len(suffix)]
    return name


def merge_metrics(parts: list[tuple[str, str]], label: str = "fleet_worker_id") -> str:
    """Merge per-child expositions: ``parts`` is [(worker_id, text)].
    Samples of one metric family stay contiguous under one HELP/TYPE
    header (the exposition format's grouping requirement)."""
    headers: dict[str, list[str]] = {}
    samples: dict[str, list[str]] = {}
    order: list[str] = []
    families: set[str] = set()
    for wid, text in parts:
        for raw in text.splitlines():
            line = raw.strip()
            if not line:
                continue
            if line.startswith("#"):
                toks = line.split(None, 3)
                if len(toks) >= 3 and toks[1] in ("HELP", "TYPE"):
                    fam = toks[2]
                    families.add(fam)
                    if fam not in headers:
                        headers[fam] = []
                        order.append(fam)
                    if line not in headers[fam]:
                        headers[fam].append(line)
                continue
            relabeled = relabel_sample(line, label, wid)
            if relabeled is None:
                continue
            fam = _family(line.split("{", 1)[0].split(" ", 1)[0], families)
            if fam not in headers:
                headers[fam] = []
                order.append(fam)
            samples.setdefault(fam, []).append(relabeled)
    out: list[str] = []
    for fam in order:
        out.extend(headers.get(fam, ()))
        out.extend(samples.get(fam, ()))
    return "\n".join(out) + "\n"


def _child_spans(body: dict) -> list[dict]:
    """Span dicts out of one child's ``/debug/traces/{id}`` body. Children
    ship a ``spans`` list next to the Chrome events; bodies without one
    (older children) are reconstructed from the complete ("X") events."""
    spans = body.get("spans")
    if isinstance(spans, list):
        return [d for d in spans if isinstance(d, dict)]
    trace_id = (body.get("otherData") or {}).get("trace_id", "")
    out: list[dict] = []
    for ev in body.get("traceEvents", ()):
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        args = dict(ev.get("args") or {})
        out.append({
            "name": ev.get("name", ""),
            "trace_id": trace_id,
            "span_id": args.pop("span_id", None),
            "parent_id": args.pop("parent_id", None),
            "start_ts": (ev.get("ts") or 0) / 1e6,
            "duration_s": (ev.get("dur") or 0) / 1e6,
            "status": args.pop("status", "ok"),
            "proc": args.pop("proc", None),
            "attrs": args,
            "events": [],
        })
    return out


def merge_traces(
    trace_id: str,
    parts: list[tuple[str, dict]],
    label: str = "fleet_worker_id",
    extra_spans: list[dict] | None = None,
) -> dict:
    """Stitch per-child ``/debug/traces/{trace_id}`` bodies (plus optional
    store-exported span dicts) into one fleet-wide Chrome-trace body.
    Scraped spans get their lane relabeled ``<worker_id>/<lane>`` — the
    trace-plane analogue of the metrics merge's ``fleet_worker_id``
    injection; store-exported spans keep their own lane (the exporter
    already stamped process identity). Deterministic: spans dedup by
    span_id over a sorted ordering, so the same fragment set always
    renders byte-identically."""
    del label  # lane carries the worker id; kept for signature symmetry
    spans: list[dict] = [d for d in (extra_spans or []) if isinstance(d, dict)]
    for wid, body in parts:
        if not isinstance(body, dict):
            continue
        for d in _child_spans(body):
            lane = d.get("proc") or "proc"
            spans.append({**d, "proc": f"{wid}/{lane}"})
    spans.sort(key=lambda d: (d.get("span_id") or "", d.get("proc") or ""))
    seen: set[str] = set()
    uniq: list[dict] = []
    for d in spans:
        sid = d.get("span_id") or ""
        if not sid or sid in seen:
            continue
        seen.add(sid)
        uniq.append(d)
    from dynamo_tpu_torch.runtime.tracing import chrome_trace_from_dicts

    uniq.sort(key=lambda d: (d.get("start_ts") or 0.0, d.get("span_id") or ""))
    body = chrome_trace_from_dicts(trace_id, uniq)
    body["spans"] = uniq
    return body


def merge_ledgers(parts: list[tuple[str, dict]], label: str = "fleet_worker_id") -> dict:
    """Merge per-child ``/debug/requests`` bodies: ``parts`` is
    [(worker_id, body)]. Enabled iff any child has tracing enabled."""
    merged: list[dict] = []
    enabled = False
    for wid, body in parts:
        enabled = enabled or bool(body.get("enabled"))
        for rec in body.get("requests", []):
            merged.append({label: wid, **rec})
    return {"enabled": enabled, "requests": merged}
