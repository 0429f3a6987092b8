"""Backend operator: incremental detokenization + stop-condition jail
(port of ``dynamo_tpu/llm/backend.py``).

- incremental detokenize via ``DecodeStream`` (never splits multi-byte
  characters across deltas);
- the stop jail: while emitted text could be the prefix of a stop
  string, hold it back; on a match truncate there and finish "stop";
- stop_token_ids / eos enforcement (the stop token's text never leaks).

``min_tokens`` defers token-level stops only; a stop string always ends
the stream.
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm.protocols import FinishReason, LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, Tokenizer
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, Operator


class StopJail:
    """Holds back text that might be a prefix of a stop sequence."""

    def __init__(self, stop: list[str]):
        self.stop = [s for s in stop if s]
        self.held = ""

    def push(self, text: str) -> tuple[str, bool]:
        """→ (releasable_text, stopped). Once stopped, held is truncated at
        the match and the remainder is discarded."""
        if not self.stop:
            return text, False
        self.held = text if not self.held else self.held + text
        best = -1
        for s in self.stop:
            idx = self.held.find(s)
            if idx != -1 and (best == -1 or idx < best):
                best = idx
        if best != -1:
            out = self.held[:best]
            self.held = ""
            return out, True
        max_hold = 0
        for s in self.stop:
            # longest proper prefix of s that is a suffix of held
            for k in range(min(len(s) - 1, len(self.held)), 0, -1):
                if self.held.endswith(s[:k]):
                    max_hold = max(max_hold, k)
                    break
        if max_hold == 0:
            out, self.held = self.held, ""
            return out, False
        out = self.held[:-max_hold] if max_hold < len(self.held) else ""
        self.held = self.held[len(out) :]
        return out, False

    def flush(self) -> str:
        out, self.held = self.held, ""
        return out


class Backend(Operator):
    """Wraps a token-emitting engine; yields delta dicts with ``text``
    filled and stop conditions enforced."""

    def __init__(self, inner: AsyncEngine, tokenizer: Tokenizer):
        super().__init__(inner)
        self.tokenizer = tokenizer

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        req = request if isinstance(request, PreprocessedRequest) else PreprocessedRequest.from_dict(request)
        stream = DecodeStream(self.tokenizer)
        stop_strings = [s for s in req.stop.stop if s]
        jail = StopJail(stop_strings)
        eos_ids = set(req.eos_token_ids) | set(req.stop.stop_token_ids)
        ignore_eos = req.stop.ignore_eos
        min_tokens = req.stop.min_tokens
        scan_eos = bool(eos_ids) and not ignore_eos
        n_emitted = 0
        finished = False
        text_parts: list[str] = []

        inner_stream = self.inner.generate(req.to_dict(), context.child())
        try:
            async for raw in inner_stream:
                finish_raw = raw.get("finish_reason")
                if finish_raw == "error":
                    yield raw
                    return
                token_ids = raw.get("token_ids") or ()
                text_parts.clear()
                stop_kind: str | None = None  # "token" (eos/stop id) | "string"
                n_new = len(token_ids)
                if not stop_strings and not (scan_eos and any(t in eos_ids for t in token_ids)):
                    piece = stream.step_many(token_ids)
                    if piece is not None:
                        text_parts.append(piece)
                    n_emitted += n_new
                else:
                    n_new = 0
                    for tid in token_ids:
                        n_emitted += 1
                        n_new += 1
                        if not ignore_eos and tid in eos_ids and n_emitted >= min_tokens:
                            stop_kind = "token"
                            break  # never detokenize the stop token itself
                        piece = stream.step(tid)
                        if piece is not None:
                            released, matched = jail.push(piece)
                            if released:
                                text_parts.append(released)
                            if matched:
                                stop_kind = "string"
                                break
                finish = finish_raw
                if stop_kind is not None:
                    finish = "stop"
                if finish is not None and stop_kind != "string":
                    # Natural end or eos stop: text still held in the decode
                    # window / jail is legitimate output — flush it.
                    tail = stream.flush()
                    if tail:
                        released, matched = jail.push(tail)
                        if released:
                            text_parts.append(released)
                        if matched:
                            finish = "stop"
                        else:
                            rest = jail.flush()
                            if rest:
                                text_parts.append(rest)
                    else:
                        rest = jail.flush()
                        if rest:
                            text_parts.append(rest)
                if n_new or text_parts or finish is not None:
                    delta: dict[str, Any] = {"token_ids": list(token_ids[:n_new])}
                    if text_parts:
                        delta["text"] = "".join(text_parts)
                    if finish is not None:
                        delta["finish_reason"] = finish
                    log_probs = raw.get("log_probs")
                    if log_probs:
                        delta["log_probs"] = list(log_probs[:n_new])
                    top_lp = raw.get("top_log_probs")
                    if top_lp:
                        delta["top_log_probs"] = top_lp[:n_new]
                    yield delta
                if finish is not None:
                    finished = True
                    break
            if not finished:
                # Engine stream ended without a finish reason — surface as stop.
                yield LLMEngineOutput(finish_reason=FinishReason.STOP).to_dict()
        finally:
            await inner_stream.aclose()
