"""Wire protocols: engine request/response + the OpenAI completions surface
(port of the parts of ``dynamo_tpu/llm/protocols.py`` this slice serves).

Everything serializes to plain JSON-able dicts with the JAX package's
schema, so the two packages' engines speak the same request and delta
format.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any


class FinishReason(str, Enum):
    STOP = "stop"           # hit a stop string / stop token / EOS
    LENGTH = "length"       # hit max_tokens or context limit
    CANCELLED = "cancelled"  # client disconnected or cancelled
    ERROR = "error"


@dataclass
class SamplingOptions:
    """Sampling knobs forwarded to the engine's on-device sampler."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0          # 0 = disabled
    seed: int | None = None
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    logprobs: bool = False  # return chosen-token logprobs per delta
    top_logprobs: int = 0   # alternatives per position (0 = chosen only)

    def to_dict(self) -> dict[str, Any]:
        return {
            "temperature": self.temperature,
            "top_p": self.top_p,
            "top_k": self.top_k,
            "seed": self.seed,
            "frequency_penalty": self.frequency_penalty,
            "presence_penalty": self.presence_penalty,
            "logprobs": self.logprobs,
            "top_logprobs": self.top_logprobs,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SamplingOptions":
        return cls(
            temperature=float(d.get("temperature", 1.0)),
            top_p=float(d.get("top_p", 1.0)),
            top_k=int(d.get("top_k", 0)),
            seed=d.get("seed"),
            frequency_penalty=float(d.get("frequency_penalty", 0.0)),
            presence_penalty=float(d.get("presence_penalty", 0.0)),
            logprobs=bool(d.get("logprobs", False)),
            top_logprobs=int(d.get("top_logprobs", 0)),
        )


@dataclass
class StopConditions:
    """When generation must end. ``stop`` strings are enforced by the
    Backend operator (it sees text); token-level conditions by the engine."""

    max_tokens: int | None = None
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    min_tokens: int = 0
    ignore_eos: bool = False

    def to_dict(self) -> dict[str, Any]:
        return {
            "max_tokens": self.max_tokens,
            "stop": list(self.stop),
            "stop_token_ids": list(self.stop_token_ids),
            "min_tokens": self.min_tokens,
            "ignore_eos": self.ignore_eos,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "StopConditions":
        return cls(
            max_tokens=d.get("max_tokens"),
            stop=list(d.get("stop") or []),
            stop_token_ids=list(d.get("stop_token_ids") or []),
            min_tokens=int(d.get("min_tokens", 0)),
            ignore_eos=bool(d.get("ignore_eos", False)),
        )


@dataclass
class PreprocessedRequest:
    """The tokenized, engine-ready request produced by the preprocessor."""

    model: str
    token_ids: list[int]
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    eos_token_ids: list[int] = field(default_factory=list)
    annotations: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "model": self.model,
            "token_ids": list(self.token_ids),
            "sampling": self.sampling.to_dict(),
            "stop": self.stop.to_dict(),
            "eos_token_ids": list(self.eos_token_ids),
            "annotations": dict(self.annotations),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PreprocessedRequest":
        return cls(
            model=d["model"],
            token_ids=list(d["token_ids"]),
            sampling=SamplingOptions.from_dict(d.get("sampling") or {}),
            stop=StopConditions.from_dict(d.get("stop") or {}),
            eos_token_ids=list(d.get("eos_token_ids") or []),
            annotations=dict(d.get("annotations") or {}),
        )


@dataclass
class LLMEngineOutput:
    """One streamed delta from the engine. ``token_ids`` are the new
    tokens; ``text`` is filled by the Backend operator."""

    token_ids: list[int] = field(default_factory=list)
    text: str | None = None
    finish_reason: FinishReason | None = None
    # Per-token logprobs aligned with token_ids (when requested).
    log_probs: list[float] | None = None
    # Per-token top alternatives: one [[token_id, logprob], ...] per token.
    top_log_probs: list[list[list[float]]] | None = None
    # Error detail when finish_reason == ERROR.
    error: str | None = None

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"token_ids": list(self.token_ids)}
        if self.text is not None:
            d["text"] = self.text
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason.value
        if self.log_probs is not None:
            d["log_probs"] = list(self.log_probs)
        if self.top_log_probs is not None:
            d["top_log_probs"] = self.top_log_probs
        if self.error is not None:
            d["error"] = self.error
        return d


class EngineError(Exception):
    """An engine-reported stream failure surfaced to the pipeline (a delta
    carried ``finish_reason=error``, or the engine refused the request)."""


class OpenAIError(Exception):
    """Maps to an OpenAI-style error JSON body + HTTP status."""

    def __init__(self, message: str, status: int = 400, err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type


def _opt_float(d: dict, key: str, lo: float, hi: float) -> float | None:
    v = d.get(key)
    if v is None:
        return None
    try:
        v = float(v)
    except (TypeError, ValueError):
        raise OpenAIError(f"'{key}' must be a number") from None
    if not lo <= v <= hi:
        raise OpenAIError(f"'{key}' must be in [{lo}, {hi}]")
    return v


def _parse_stop(d: dict) -> list[str]:
    stop = d.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    if isinstance(stop, list) and all(isinstance(s, str) for s in stop):
        if len(stop) > 16:
            raise OpenAIError("'stop' supports at most 16 sequences")
        return stop
    raise OpenAIError("'stop' must be a string or list of strings")


@dataclass
class CompletionRequest:
    """Parsed+validated POST /v1/completions body."""

    model: str
    prompt: str | list[int]
    stream: bool = False
    logprobs: int | None = None       # OpenAI completions: top-N (0 = chosen token only)
    max_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    seed: int | None = None
    stop: list[str] = field(default_factory=list)
    min_tokens: int | None = None
    ignore_eos: bool = False
    annotations: list[str] = field(default_factory=list)

    @classmethod
    def parse(cls, d: Any) -> "CompletionRequest":
        if not isinstance(d, dict):
            raise OpenAIError("request body must be a JSON object")
        model = d.get("model")
        if not model or not isinstance(model, str):
            raise OpenAIError("'model' is required")
        prompt = d.get("prompt")
        if isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
            pass  # pre-tokenized prompt
        elif not isinstance(prompt, str):
            raise OpenAIError("'prompt' must be a string or list of token ids")
        max_tokens = d.get("max_tokens")
        if max_tokens is not None and (not isinstance(max_tokens, int) or max_tokens < 1):
            raise OpenAIError("'max_tokens' must be a positive integer")
        logprobs = d.get("logprobs")
        if isinstance(logprobs, bool):
            logprobs = 0 if logprobs else None
        elif logprobs is not None and (not isinstance(logprobs, int) or logprobs < 0):
            raise OpenAIError("'logprobs' must be a non-negative integer")
        ext = d.get("nvext") or d.get("ext") or {}
        return cls(
            model=model,
            prompt=prompt,
            stream=bool(d.get("stream", False)),
            logprobs=logprobs,
            max_tokens=max_tokens,
            temperature=_opt_float(d, "temperature", 0.0, 2.0),
            top_p=_opt_float(d, "top_p", 0.0, 1.0),
            top_k=d.get("top_k"),
            seed=d.get("seed"),
            stop=_parse_stop(d),
            min_tokens=d.get("min_tokens"),
            ignore_eos=bool(d.get("ignore_eos", False)),
            annotations=list(ext.get("annotations") or []),
        )


def gen_request_id(prefix: str = "cmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict[str, int]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def completion_chunk(
    request_id: str,
    model: str,
    created: int,
    *,
    text: str = "",
    finish_reason: str | None = None,
    usage: dict[str, int] | None = None,
    logprobs: dict | None = None,
) -> dict[str, Any]:
    body: dict[str, Any] = {
        "id": request_id,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [{"index": 0, "text": text, "finish_reason": finish_reason,
                     "logprobs": logprobs}],
    }
    if usage is not None:
        body["usage"] = usage
    return body


def completion_response(
    request_id: str,
    model: str,
    created: int,
    text: str,
    finish_reason: str,
    usage: dict[str, int],
    logprobs: dict | None = None,
) -> dict[str, Any]:
    body = completion_chunk(
        request_id, model, created, text=text, finish_reason=finish_reason,
        logprobs=logprobs,
    )
    body["usage"] = usage
    return body
