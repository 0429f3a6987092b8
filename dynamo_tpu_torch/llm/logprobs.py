"""Logprob analysis toolkit: sensitivity / uncertainty over recorded
streams.

Reference analogue: ``lib/llm/src/perf/logprobs.rs`` — the reference
extracts per-position token logprobs from recorded response streams and
ranks positions by how CLOSE the top candidates were (a close top-2 is
where sampling nondeterminism, quantization error, or engine divergence
will first flip a token). Used there by the accuracy-debugging workflow
(logprob_analysis_integration.rs); same role here over
``llm/recorder.py`` JSONL captures or live response dicts.

Inputs accepted per position: OpenAI chat ``logprobs.content[]`` entries
(with or without ``top_logprobs`` alternatives) and completions
``token_logprobs`` arrays. Without alternatives the top-2 gap is
unknowable, so closeness falls back to the selected token's own
probability (a low-probability selection is the uncertainty signal the
chosen-token stream still carries).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator


@dataclass
class TokenLogprob:
    token: str
    logprob: float
    bytes: list[int] | None = None

    @property
    def prob(self) -> float:
        return math.exp(min(self.logprob, 0.0))


@dataclass
class TokenLogProbs:
    """One position: the selected token + ranked alternatives."""

    selected: TokenLogprob
    alternatives: list[TokenLogprob] = field(default_factory=list)

    def __post_init__(self):
        self.alternatives.sort(key=lambda t: t.logprob, reverse=True)

    def all_tokens(self) -> list[TokenLogprob]:
        """Selected merged with alternatives (unique by token), ranked."""
        out = {t.token: t for t in self.alternatives}
        out.setdefault(self.selected.token, self.selected)
        return sorted(out.values(), key=lambda t: t.logprob, reverse=True)

    @property
    def normalized(self) -> bool:
        """True when the candidate probabilities account for ~all mass."""
        return abs(1.0 - sum(t.prob for t in self.all_tokens())) < 1e-3

    def missing_mass(self) -> float:
        return max(0.0, 1.0 - sum(t.prob for t in self.all_tokens()))

    def top2_probability_gap(self) -> float | None:
        """Linear-space probability gap between the top two candidates;
        None without alternatives (closeness unknowable)."""
        ranked = self.all_tokens()
        if len(ranked) < 2:
            return None
        return ranked[0].prob - ranked[1].prob


@dataclass
class PositionCloseness:
    stream_index: int      # response chunk the position arrived in
    token_index: int       # position within the generated sequence
    closeness: float       # smaller = more uncertain
    probability_gap: float | None
    selected_prob: float
    missing_mass: float
    candidates: list[TokenLogprob]


@dataclass
class ChoiceAnalysis:
    choice: int
    positions: list[PositionCloseness] = field(default_factory=list)

    def close_positions(self, threshold: float) -> list[PositionCloseness]:
        return [p for p in self.positions if p.closeness <= threshold]

    def closest(self, n: int) -> list[PositionCloseness]:
        return self.positions[:n]


@dataclass
class SensitivityAnalysis:
    """Positions ranked most-uncertain-first, per choice."""

    responses_analyzed: int = 0
    choices: dict[int, ChoiceAnalysis] = field(default_factory=dict)

    def summary(self) -> dict:
        out: dict[str, Any] = {"responses_analyzed": self.responses_analyzed, "choices": {}}
        for idx, ch in sorted(self.choices.items()):
            probs = [p.selected_prob for p in ch.positions]
            lps = [math.log(max(p, 1e-30)) for p in probs]
            out["choices"][str(idx)] = {
                "positions": len(ch.positions),
                "close_at_0.1": len(ch.close_positions(0.1)),
                "close_at_0.3": len(ch.close_positions(0.3)),
                "mean_selected_logprob": (
                    round(sum(lps) / len(lps), 4) if lps else None
                ),
                "perplexity": (
                    round(math.exp(-sum(lps) / len(lps)), 3) if lps else None
                ),
                "top5_closest": [
                    {
                        "token_index": p.token_index,
                        "closeness": round(p.closeness, 4),
                        "selected": p.candidates[0].token if p.candidates else None,
                    }
                    for p in ch.closest(5)
                ],
            }
        return out


def _positions_from_chat_logprobs(lp: dict) -> Iterator[TokenLogProbs]:
    for entry in lp.get("content") or []:
        sel = TokenLogprob(
            token=entry.get("token", ""),
            logprob=float(entry.get("logprob", 0.0)),
            bytes=entry.get("bytes"),
        )
        alts = [
            TokenLogprob(t.get("token", ""), float(t.get("logprob", 0.0)), t.get("bytes"))
            for t in entry.get("top_logprobs") or []
            if t.get("token") != sel.token
        ]
        yield TokenLogProbs(sel, alts)


def _positions_from_completion_logprobs(lp: dict) -> Iterator[TokenLogProbs]:
    toks = lp.get("tokens") or []
    tlps = lp.get("token_logprobs") or []
    tops = lp.get("top_logprobs") or [None] * len(toks)
    for tok, tlp, top in zip(toks, tlps, tops):
        sel = TokenLogprob(token=tok, logprob=float(tlp))
        alts = [
            TokenLogprob(t, float(v))
            for t, v in (top or {}).items()
            if t != tok
        ]
        yield TokenLogProbs(sel, alts)


def extract_logprobs(response: dict) -> dict[int, list[TokenLogProbs]]:
    """Per-choice positions from one chat/completions response or stream
    chunk (the reference's ``LogprobExtractor`` surface)."""
    out: dict[int, list[TokenLogProbs]] = {}
    for choice in response.get("choices") or []:
        lp = choice.get("logprobs")
        if not lp:
            continue
        idx = int(choice.get("index", 0))
        if "content" in lp:
            positions = list(_positions_from_chat_logprobs(lp))
        else:
            positions = list(_positions_from_completion_logprobs(lp))
        if positions:
            out.setdefault(idx, []).extend(positions)
    return out


def analyze_logprob_sensitivity(responses: Iterable[dict]) -> SensitivityAnalysis:
    """Rank every generated position by closeness across a stream of
    response dicts (the reference's ``analyze_logprob_sensitivity``,
    logprobs.rs:270)."""
    analysis = SensitivityAnalysis()
    token_counts: dict[int, int] = {}
    for si, resp in enumerate(responses):
        analysis.responses_analyzed += 1
        for choice_idx, positions in extract_logprobs(resp).items():
            ch = analysis.choices.setdefault(choice_idx, ChoiceAnalysis(choice_idx))
            for pos in positions:
                ti = token_counts.get(choice_idx, 0)
                token_counts[choice_idx] = ti + 1
                gap = pos.top2_probability_gap()
                closeness = gap if gap is not None else pos.selected.prob
                ch.positions.append(PositionCloseness(
                    stream_index=si,
                    token_index=ti,
                    closeness=closeness,
                    probability_gap=gap,
                    selected_prob=pos.selected.prob,
                    missing_mass=pos.missing_mass(),
                    candidates=pos.all_tokens(),
                ))
    for ch in analysis.choices.values():
        ch.positions.sort(key=lambda p: p.closeness)
    return analysis


def analyze_recording(path: str, rid: str | None = None) -> SensitivityAnalysis:
    """Analyze a ``llm/recorder.py`` JSONL capture: delta records carry
    the raw stream chunks; filter to one request with ``rid``."""
    def deltas():
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("kind") != "delta":
                    continue
                if rid is not None and rec.get("rid") != rid:
                    continue
                item = rec.get("item") or {}
                if "choices" in item:
                    yield item
                elif item.get("log_probs"):
                    # Engine-output delta (LLMEngineOutput): chosen-token
                    # ids+logprobs only — adapt to the chat shape (token
                    # label = the id; detokenized text is not recorded).
                    yield {"choices": [{"index": 0, "logprobs": {"content": [
                        {"token": str(t), "logprob": float(lp)}
                        for t, lp in zip(item.get("token_ids") or [],
                                         item["log_probs"])
                    ]}}]}

    return analyze_logprob_sensitivity(deltas())


def main(argv=None) -> int:
    """CLI: ``python -m dynamo_tpu_torch.llm.logprobs capture.jsonl [--rid R]``
    → one JSON summary line."""
    import argparse

    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.llm.logprobs")
    p.add_argument("path", help="recorder JSONL capture")
    p.add_argument("--rid", default=None, help="restrict to one request id")
    args = p.parse_args(argv)
    print(json.dumps(analyze_recording(args.path, args.rid).summary()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
