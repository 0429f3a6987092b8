"""Perf interpolators: profiled (batch → TTFT/ITL/throughput) samples →
the lookup functions the SLA planner needs.

Reference analogue: components/planner/src/dynamo/planner/utils/
perf_interpolation.py:20-146 (npz from profile_sla sweeps). Here the
profile is produced by planner/profile_sweep.py on the serving card and
the interpolation is plain monotone np.interp — batch is the only knob
on a fixed mesh; mesh-shape sweeps add a file per mesh.

Port of ``dynamo_tpu/planner/interpolate.py``: the same numpy code and
the same npz keys, so either package reads the other's profile file.
"""

from __future__ import annotations

import numpy as np


def _finite(arrays: dict[str, np.ndarray]) -> None:
    """Profiles feed the autoscaler's control law — a NaN sample would
    propagate into pool-size math, so it is rejected at construction
    (the satellite clamp audit: never NaN/negative pool sizes)."""
    for name, a in arrays.items():
        if not np.all(np.isfinite(a)):
            raise ValueError(f"profile array {name!r} contains non-finite samples")


class DecodeInterpolator:
    """Samples: concurrent batch size → ITL (ms) and per-chip tok/s.

    Lookups OUTSIDE the profiled sample range clamp to the endpoint
    values (``np.interp`` semantics) — extrapolation never invents
    capacity; :meth:`in_range` tells the control law when it is
    operating beyond the profile so it can act conservatively."""

    def __init__(self, batch: np.ndarray, itl_ms: np.ndarray, tok_s: np.ndarray):
        order = np.argsort(batch)
        self.batch = np.asarray(batch, np.float64)[order]
        self.itl_ms = np.asarray(itl_ms, np.float64)[order]
        self.tok_s = np.asarray(tok_s, np.float64)[order]
        _finite({"batch": self.batch, "itl_ms": self.itl_ms, "tok_s": self.tok_s})

    def in_range(self, batch: float) -> bool:
        return bool(self.batch[0] <= batch <= self.batch[-1])

    def itl_at(self, batch: float) -> float:
        return float(np.interp(batch, self.batch, self.itl_ms))

    def throughput_at(self, batch: float) -> float:
        return float(np.interp(batch, self.batch, self.tok_s))

    def max_batch_under_itl(self, itl_sla_ms: float) -> float:
        """Largest batch whose interpolated ITL stays under the SLA
        (reference: planner_core.py:253-276 inverse lookup)."""
        grid = np.linspace(self.batch[0], self.batch[-1], 256)
        ok = grid[np.interp(grid, self.batch, self.itl_ms) <= itl_sla_ms]
        return float(ok[-1]) if len(ok) else 0.0

    def best_throughput_under_itl(self, itl_sla_ms: float) -> float:
        b = self.max_batch_under_itl(itl_sla_ms)
        return self.throughput_at(b) if b > 0 else 0.0


class PrefillInterpolator:
    """Samples: prompt length → TTFT (ms) and prefill tok/s."""

    def __init__(self, prompt_len: np.ndarray, ttft_ms: np.ndarray, tok_s: np.ndarray):
        order = np.argsort(prompt_len)
        self.prompt_len = np.asarray(prompt_len, np.float64)[order]
        self.ttft_ms = np.asarray(ttft_ms, np.float64)[order]
        self.tok_s = np.asarray(tok_s, np.float64)[order]
        _finite({"prompt_len": self.prompt_len, "ttft_ms": self.ttft_ms,
                 "tok_s": self.tok_s})

    def in_range(self, prompt_len: float) -> bool:
        return bool(self.prompt_len[0] <= prompt_len <= self.prompt_len[-1])

    def ttft_at(self, prompt_len: float) -> float:
        return float(np.interp(prompt_len, self.prompt_len, self.ttft_ms))

    def throughput_at(self, prompt_len: float) -> float:
        return float(np.interp(prompt_len, self.prompt_len, self.tok_s))


def plan_disagg_pools(
    total_workers: int,
    decode: DecodeInterpolator,
    prefill: PrefillInterpolator,
    *,
    prompt_len: float,
    gen_len: float,
    itl_sla_ms: float,
    ttft_sla_ms: float | None = None,
) -> dict:
    """Split a fixed fleet between prefill and decode pools so neither
    side bottlenecks goodput — the DistServe argument (2401.09670): under
    disaggregation each pool runs at ITS best SLA-respecting operating
    point, so the right split equalizes per-pool REQUEST rates, not
    token rates.

    Per-worker request capacity from the profiled interpolators:
    decode = best_throughput_under_itl(itl_sla) / gen_len;
    prefill = throughput_at(prompt_len) / prompt_len. The integer split
    maximizes min(prefill_rps, decode_rps) with ≥1 worker per pool.
    → {"prefill_workers", "decode_workers", "ratio", "goodput_rps",
       "prefill_rps_per_worker", "decode_rps_per_worker", ...}.

    ``ttft_sla_ms``: when the profiled single-request TTFT at prompt_len
    already exceeds the SLA, no ratio can fix it (that is a chip-count /
    chunking problem) — reported as ``ttft_feasible`` rather than
    silently folded into the split."""
    if total_workers < 2:
        raise ValueError("disagg needs at least 2 workers (1 prefill + 1 decode)")
    d_tok = decode.best_throughput_under_itl(itl_sla_ms)
    d_rps = d_tok / max(gen_len, 1.0)
    p_tok = prefill.throughput_at(prompt_len)
    p_rps = p_tok / max(prompt_len, 1.0)
    best_p, best_goodput = 1, -1.0
    for p in range(1, total_workers):
        goodput = min(p * p_rps, (total_workers - p) * d_rps)
        if goodput > best_goodput:
            best_p, best_goodput = p, goodput
    out = {
        "prefill_workers": best_p,
        "decode_workers": total_workers - best_p,
        # prefill workers needed per decode worker to keep it fed
        "ratio": round(d_rps / p_rps, 4) if p_rps > 0 else 0.0,
        "goodput_rps": round(max(best_goodput, 0.0), 4),
        "prefill_rps_per_worker": round(p_rps, 4),
        "decode_rps_per_worker": round(d_rps, 4),
        "decode_tok_s_under_itl_sla": round(d_tok, 2),
        "prefill_tok_s": round(p_tok, 2),
    }
    if ttft_sla_ms is not None:
        out["ttft_feasible"] = prefill.ttft_at(prompt_len) <= ttft_sla_ms
    return out


def profile_as_card_dict(
    decode: DecodeInterpolator | None = None,
    prefill: PrefillInterpolator | None = None,
) -> dict:
    """Interpolators → a plain-list dict small enough to ride inside a
    msgpack ModelDeploymentCard (``sla_profile`` field): the worker that
    was profiled publishes its own latency curves, and frontends/the
    planner pick them up via DISCOVERY instead of a ``--qos-profile``
    CLI path that has to be copied to every box (ROADMAP 2c)."""
    out: dict = {}
    if decode is not None:
        out["d_batch"] = decode.batch.tolist()
        out["d_itl"] = decode.itl_ms.tolist()
        out["d_tok"] = decode.tok_s.tolist()
    if prefill is not None:
        out["p_len"] = prefill.prompt_len.tolist()
        out["p_ttft"] = prefill.ttft_ms.tolist()
        out["p_tok"] = prefill.tok_s.tolist()
    return out


def interpolators_from_card_dict(
    d: dict | None,
) -> tuple[DecodeInterpolator | None, PrefillInterpolator | None]:
    """Inverse of :func:`profile_as_card_dict`. Malformed or non-finite
    payloads → (None, None): a bad card must degrade the consumer to
    its no-profile behaviour, never crash discovery."""
    if not d:
        return None, None
    decode = prefill = None
    try:
        if d.get("d_batch"):
            decode = DecodeInterpolator(
                np.asarray(d["d_batch"], np.float64),
                np.asarray(d["d_itl"], np.float64),
                np.asarray(d["d_tok"], np.float64),
            )
        if d.get("p_len"):
            prefill = PrefillInterpolator(
                np.asarray(d["p_len"], np.float64),
                np.asarray(d["p_ttft"], np.float64),
                np.asarray(d["p_tok"], np.float64),
            )
    except (ValueError, TypeError, KeyError):
        return None, None
    return decode, prefill


def save_profile(path: str, *, decode: DecodeInterpolator | None = None,
                 prefill: PrefillInterpolator | None = None, meta: dict | None = None) -> None:
    arrays: dict = {"meta": np.bytes_(repr(meta or {}))}
    if decode is not None:
        arrays.update(d_batch=decode.batch, d_itl=decode.itl_ms, d_tok=decode.tok_s)
    if prefill is not None:
        arrays.update(p_len=prefill.prompt_len, p_ttft=prefill.ttft_ms, p_tok=prefill.tok_s)
    np.savez(path, **arrays)


def load_profile(path: str) -> tuple[DecodeInterpolator | None, PrefillInterpolator | None]:
    with np.load(path) as z:
        decode = (
            DecodeInterpolator(z["d_batch"], z["d_itl"], z["d_tok"])
            if "d_batch" in z else None
        )
        prefill = (
            PrefillInterpolator(z["p_len"], z["p_ttft"], z["p_tok"])
            if "p_len" in z else None
        )
    return decode, prefill
