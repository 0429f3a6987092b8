"""Wire protocols: internal engine request/response + OpenAI compatibility.

Reference analogue: ``PreprocessedRequest``/``LLMEngineOutput`` and the
OpenAI protocol types + SSE codec (reference: lib/llm/src/protocols/
common/llm_backend.rs, protocols/openai/, protocols/codec.rs:755).

Everything here serializes to plain msgpack/JSON-able dicts — these types
cross process boundaries (frontend → router → worker) on the framed-TCP
request plane, so they must stay schema-stable and language-neutral.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field
from typing import ClassVar
from enum import Enum
from typing import Any, Iterable


class FinishReason(str, Enum):
    STOP = "stop"           # hit a stop string / stop token / EOS
    LENGTH = "length"       # hit max_tokens or context limit
    CANCELLED = "cancelled"  # client disconnected or cancelled
    ERROR = "error"

    @classmethod
    def parse(cls, v: str | None) -> "FinishReason | None":
        return None if v is None else cls(v)


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
    """When generation must end.

    ``stop`` strings are enforced by the Backend operator (which sees
    detokenized text); token-level conditions are enforced in the engine.
    """

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
    """The tokenized, engine-ready request produced by the preprocessor
    (reference: lib/llm/src/protocols/common/preprocessor.rs)."""

    model: str
    token_ids: list[int]
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    eos_token_ids: list[int] = field(default_factory=list)
    # Router-injected hint: how many prefix blocks the chosen worker already
    # holds (reference: lib/llm/src/kv_router.rs:299-369).
    estimated_prefix_hit_num_blocks: int | None = None
    annotations: dict[str, Any] = field(default_factory=dict)
    # Disaggregation control (reference: vLLM handlers' extra_args
    # kv_transfer_params, components/backends/vllm/src/dynamo/vllm/
    # handlers.py:130-163): {"do_remote_decode": true} marks a prefill-only
    # request whose KV should be exported; the in-process decode handler
    # attaches {"inject": {...}} with fetched pages before admission.
    kv_transfer_params: dict[str, Any] | None = None
    # Structured output: the validated OpenAI response_format dict
    # (json_object / json_schema). Travels the wire as plain JSON; the
    # worker engine compiles it to a token-mask FSM, cached by schema
    # hash, and decodes under the mask (engine/grammar.py).
    response_format: dict[str, Any] | None = None
    # Multi-LoRA: the adapter identity this request decodes under
    # (None = base model). Stamped by the preprocessor from the model
    # card's lora metadata; the worker engine resolves it to a resident
    # bank slot at admission (engine/lora.py) and the kv_router salts
    # block hashes with it so KV stickiness is keyed by (model, adapter).
    adapter_id: str | None = None
    # Multi-tenant QoS (runtime/qos.py): the request's priority class
    # ("interactive"/"standard"/"batch") and tenant id, validated at the
    # HTTP boundary and carried over the wire so the engine's admission
    # ordering and preemption victim selection are class-aware. Absent
    # (None) = no QoS — the wire dict omits both keys, byte-identical
    # to the pre-QoS format.
    priority: str | None = None
    tenant: str | None = None

    def to_dict(self) -> dict[str, Any]:
        d = {
            "model": self.model,
            "token_ids": list(self.token_ids),
            "sampling": self.sampling.to_dict(),
            "stop": self.stop.to_dict(),
            "eos_token_ids": list(self.eos_token_ids),
            "estimated_prefix_hit_num_blocks": self.estimated_prefix_hit_num_blocks,
            "annotations": dict(self.annotations),
        }
        if self.kv_transfer_params is not None:
            d["kv_transfer_params"] = self.kv_transfer_params
        if self.response_format is not None:
            d["response_format"] = self.response_format
        if self.adapter_id is not None:
            d["adapter_id"] = self.adapter_id
        if self.priority is not None:
            d["priority"] = self.priority
        if self.tenant is not None:
            d["tenant"] = self.tenant
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PreprocessedRequest":
        return cls(
            model=d["model"],
            token_ids=list(d["token_ids"]),
            sampling=SamplingOptions.from_dict(d.get("sampling") or {}),
            stop=StopConditions.from_dict(d.get("stop") or {}),
            eos_token_ids=list(d.get("eos_token_ids") or []),
            estimated_prefix_hit_num_blocks=d.get("estimated_prefix_hit_num_blocks"),
            annotations=dict(d.get("annotations") or {}),
            kv_transfer_params=d.get("kv_transfer_params"),
            response_format=d.get("response_format"),
            adapter_id=d.get("adapter_id"),
            priority=d.get("priority"),
            tenant=d.get("tenant"),
        )


@dataclass
class LLMEngineOutput:
    """One streamed delta from the engine (reference: lib/llm/src/protocols/
    common/llm_backend.rs LLMEngineOutput).

    ``token_ids`` are the *new* tokens in this delta. ``text`` is filled by
    the Backend operator after incremental detokenization; engines emit
    tokens only.
    """

    token_ids: list[int] = field(default_factory=list)
    text: str | None = None
    finish_reason: FinishReason | None = None
    cum_log_probs: float | None = None
    # Per-token logprobs aligned with token_ids (when requested).
    log_probs: list[float] | None = None
    # Per-token top alternatives aligned with token_ids (when requested):
    # one [[token_id, logprob], ...] list per token, most likely first.
    top_log_probs: list[list[list[float]]] | None = None
    # Disaggregation: prefill workers return KV block descriptors here.
    kv_transfer_params: dict[str, Any] | None = None
    # Error detail when finish_reason == ERROR.
    error: str | None = None

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"token_ids": list(self.token_ids)}
        if self.text is not None:
            d["text"] = self.text
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason.value
        if self.cum_log_probs is not None:
            d["cum_log_probs"] = self.cum_log_probs
        if self.log_probs is not None:
            d["log_probs"] = list(self.log_probs)
        if self.top_log_probs is not None:
            d["top_log_probs"] = self.top_log_probs
        if self.kv_transfer_params is not None:
            d["kv_transfer_params"] = self.kv_transfer_params
        if self.error is not None:
            d["error"] = self.error
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LLMEngineOutput":
        return cls(
            token_ids=list(d.get("token_ids") or []),
            text=d.get("text"),
            finish_reason=FinishReason.parse(d.get("finish_reason")),
            cum_log_probs=d.get("cum_log_probs"),
            log_probs=d.get("log_probs"),
            top_log_probs=d.get("top_log_probs"),
            kv_transfer_params=d.get("kv_transfer_params"),
            error=d.get("error"),
        )


# ---------------------------------------------------------------------------
# OpenAI API surface (validation + response builders)
# ---------------------------------------------------------------------------


class EngineError(Exception):
    """A worker/engine-reported stream failure surfaced to the frontend
    pipeline (the delta carried ``finish_reason=error``). Typed (DT005) so
    the HTTP boundary can map it deliberately instead of catching a bare
    RuntimeError."""


class OpenAIError(Exception):
    """Maps to an OpenAI-style error JSON body + HTTP status."""

    def __init__(self, message: str, status: int = 400, err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type

    def body(self) -> dict[str, Any]:
        return {"error": {"message": str(self), "type": self.err_type, "code": self.status}}


@dataclass
class ChatMessage:
    role: str
    content: str
    name: str | None = None
    # Tool-use turns: an assistant turn's calls and a tool turn's id —
    # templates reference both (second turn of every tool conversation).
    tool_calls: list[dict] = field(default_factory=list)
    tool_call_id: str | None = None

    @classmethod
    def parse(cls, d: Any) -> "ChatMessage":
        if not isinstance(d, dict) or "role" not in d:
            raise OpenAIError("each message must be an object with a 'role'")
        content = d.get("content")
        if content is None:
            content = ""
        if isinstance(content, list):  # multimodal-style parts: concatenate text parts
            content = "".join(
                p.get("text", "") for p in content if isinstance(p, dict) and p.get("type") == "text"
            )
        if not isinstance(content, str):
            raise OpenAIError("message content must be a string or content-part list")
        return cls(
            role=str(d["role"]), content=content, name=d.get("name"),
            tool_calls=list(d.get("tool_calls") or []),
            tool_call_id=d.get("tool_call_id"),
        )

    def to_dict(self) -> dict[str, Any]:
        d = {"role": self.role, "content": self.content}
        if self.name:
            d["name"] = self.name
        if self.tool_calls:
            d["tool_calls"] = self.tool_calls
        if self.tool_call_id:
            d["tool_call_id"] = self.tool_call_id
        return d


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


def validate_response_format(d: dict) -> dict | None:
    """Parse + structurally validate an OpenAI ``response_format`` value
    → a normalized dict ({"type": "json_object"} or {"type":
    "json_schema", "json_schema": {...}}), None for text/absent.
    Malformed specs raise a 400 :class:`OpenAIError` with a typed body.
    Deep schema validation (unsupported constructs, bad patterns)
    happens in the preprocessor via the grammar compiler — this layer
    only enforces the wire shape."""
    rf = d.get("response_format")
    if rf is None:
        return None
    if not isinstance(rf, dict):
        raise OpenAIError("'response_format' must be an object")
    ftype = rf.get("type")
    if ftype == "text":
        return None
    if ftype == "json_object":
        return {"type": "json_object"}
    if ftype == "json_schema":
        js = rf.get("json_schema")
        if not isinstance(js, dict):
            raise OpenAIError(
                "'response_format.json_schema' must be an object"
            )
        schema = js.get("schema")
        if not isinstance(schema, dict):
            raise OpenAIError(
                "'response_format.json_schema.schema' must be a JSON schema object"
            )
        out: dict[str, Any] = {"type": "json_schema",
                               "json_schema": {"schema": schema}}
        if js.get("name") is not None:
            out["json_schema"]["name"] = str(js["name"])
        if js.get("strict") is not None:
            out["json_schema"]["strict"] = bool(js["strict"])
        return out
    raise OpenAIError(
        "'response_format.type' must be one of 'text', 'json_object', "
        "'json_schema'"
    )


def parse_qos_fields(d: dict) -> tuple[str | None, str | None]:
    """Parse + validate the OpenAI-surface QoS extension fields
    (``priority`` ∈ interactive/standard/batch, ``tenant`` a bounded
    printable id) → (priority, tenant), both None when absent. Junk
    raises a typed 400 :class:`OpenAIError` — validation happens at the
    boundary, never mid-stream (the engine treats unknown wire values
    as the default class)."""
    from dynamo_tpu_torch.runtime.qos import parse_priority, parse_tenant

    priority = tenant = None
    raw_p = d.get("priority")
    if raw_p is not None:
        if not isinstance(raw_p, str):
            raise OpenAIError("'priority' must be a string")
        try:
            priority = parse_priority(raw_p)
        except ValueError as e:
            raise OpenAIError(str(e)) from None
    raw_t = d.get("tenant")
    if raw_t is not None:
        if not isinstance(raw_t, str):
            raise OpenAIError("'tenant' must be a string")
        try:
            tenant = parse_tenant(raw_t)
        except ValueError as e:
            raise OpenAIError(str(e)) from None
    return priority, tenant


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
class ChatCompletionRequest:
    """Parsed+validated POST /v1/chat/completions body
    (reference: lib/llm/src/protocols/openai/chat_completions/)."""

    model: str
    messages: list[ChatMessage]
    stream: bool = False
    logprobs: bool = False            # chosen-token logprobs per delta
    top_logprobs: int = 0             # 0-20 ranked alternatives per position
    tools: list[dict] = field(default_factory=list)   # OpenAI function tools
    tool_choice: Any = None           # "auto" | "none" | {...}
    max_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None          # extension (vLLM-compatible)
    seed: int | None = None
    n: int = 1
    stop: list[str] = field(default_factory=list)
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    min_tokens: int | None = None     # extension
    ignore_eos: bool = False          # extension
    # OpenAI structured output: None | {"type": "json_object"} |
    # {"type": "json_schema", "json_schema": {"schema": ...}} — compiled
    # to a token-mask FSM engine-side (engine/grammar.py).
    response_format: dict[str, Any] | None = None
    # Multi-tenant QoS extension fields (validated; None = unset). The
    # x-priority/x-tenant headers fill these when the body omits them
    # (body wins on conflict) — see HttpService._merge_qos.
    priority: str | None = None
    tenant: str | None = None
    annotations: list[str] = field(default_factory=list)  # nvext-style debug annotations
    raw: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def parse(cls, d: Any) -> "ChatCompletionRequest":
        if not isinstance(d, dict):
            raise OpenAIError("request body must be a JSON object")
        model = d.get("model")
        if not model or not isinstance(model, str):
            raise OpenAIError("'model' is required")
        msgs = d.get("messages")
        if not isinstance(msgs, list) or not msgs:
            raise OpenAIError("'messages' must be a non-empty array")
        max_tokens = d.get("max_tokens", d.get("max_completion_tokens"))
        if max_tokens is not None and (not isinstance(max_tokens, int) or max_tokens < 1):
            raise OpenAIError("'max_tokens' must be a positive integer")
        n = d.get("n", 1)
        if n != 1:
            raise OpenAIError("'n' != 1 is not supported")
        top_lp = d.get("top_logprobs", 0)
        if top_lp:
            # bool is an int subclass; {"top_logprobs": true} is a type
            # error (clients confusing it with the logprobs flag).
            if isinstance(top_lp, bool) or not isinstance(top_lp, int) or not 0 <= top_lp <= 20:
                raise OpenAIError("'top_logprobs' must be an integer in [0, 20]")
            if not d.get("logprobs"):
                raise OpenAIError("'top_logprobs' requires 'logprobs': true")
        ext = d.get("nvext") or d.get("ext") or {}
        priority, tenant = parse_qos_fields(d)
        return cls(
            model=model,
            messages=[ChatMessage.parse(m) for m in msgs],
            stream=bool(d.get("stream", False)),
            logprobs=bool(d.get("logprobs", False)),
            top_logprobs=int(top_lp or 0),
            tools=list(d.get("tools") or []),
            tool_choice=d.get("tool_choice"),
            max_tokens=max_tokens,
            temperature=_opt_float(d, "temperature", 0.0, 2.0),
            top_p=_opt_float(d, "top_p", 0.0, 1.0),
            top_k=d.get("top_k"),
            seed=d.get("seed"),
            stop=_parse_stop(d),
            frequency_penalty=_opt_float(d, "frequency_penalty", -2.0, 2.0),
            presence_penalty=_opt_float(d, "presence_penalty", -2.0, 2.0),
            min_tokens=d.get("min_tokens"),
            ignore_eos=bool(d.get("ignore_eos", False)),
            response_format=validate_response_format(d),
            priority=priority,
            tenant=tenant,
            annotations=list(ext.get("annotations") or []),
            raw=d,
        )


@dataclass
class CompletionRequest:
    """Parsed+validated POST /v1/completions body."""

    model: str
    prompt: str | list[int]
    stream: bool = False
    logprobs: int | None = None       # OpenAI completions: top-N (we serve N=0/1: chosen token)
    max_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    seed: int | None = None
    echo: bool = False
    stop: list[str] = field(default_factory=list)
    min_tokens: int | None = None
    ignore_eos: bool = False
    priority: str | None = None
    tenant: str | None = None
    annotations: list[str] = field(default_factory=list)
    raw: dict[str, Any] = field(default_factory=dict)

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
        # OpenAI completions: int top-N (0 still returns chosen-token
        # logprobs). Chat-style booleans from confused clients are
        # normalized: false → off, true → 0 (chosen token only).
        logprobs = d.get("logprobs")
        if isinstance(logprobs, bool):
            logprobs = 0 if logprobs else None
        elif logprobs is not None and (not isinstance(logprobs, int) or logprobs < 0):
            raise OpenAIError("'logprobs' must be a non-negative integer")
        ext = d.get("nvext") or d.get("ext") or {}
        priority, tenant = parse_qos_fields(d)
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
            echo=bool(d.get("echo", False)),
            stop=_parse_stop(d),
            min_tokens=d.get("min_tokens"),
            ignore_eos=bool(d.get("ignore_eos", False)),
            priority=priority,
            tenant=tenant,
            annotations=list(ext.get("annotations") or []),
            raw=d,
        )


@dataclass
class ResponsesRequest:
    """Parsed+validated POST /v1/responses body (OpenAI Responses API).

    Reference parity: lib/llm/src/http/service/openai.rs:584-850 converts
    the request to chat completions and serves it unary-only (":TODO:
    handle streaming"); here streaming is served too. Text-only input;
    agentic fields (tools, previous_response_id, background, include)
    are rejected with 501 like the reference's
    validate_response_unsupported_fields (openai.rs:739). Unlike the
    reference, `instructions` IS supported — it is just a leading system
    message."""

    model: str
    messages: list[ChatMessage]          # converted from `input` (+instructions)
    stream: bool = False
    max_output_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    seed: int | None = None
    instructions: str | None = None
    # Responses-API structured output: `text.format` mapped to the chat
    # response_format shape (json_object / json_schema — the Responses
    # flavor flattens name/schema/strict into the format object).
    response_format: dict[str, Any] | None = None
    priority: str | None = None
    tenant: str | None = None
    raw: dict[str, Any] = field(default_factory=dict)

    _UNSUPPORTED = (
        "background", "include", "max_tool_calls", "parallel_tool_calls",
        "previous_response_id", "prompt", "reasoning", "service_tier",
        "tool_choice", "tools", "truncation",
    )
    # Values of "unsupported" fields that mean the same as omitting them
    # (incl. everything responses_body echoes back, so a response's own
    # fields round-trip into a new request).
    _NOOP_VALUES: ClassVar[dict[str, tuple]] = {
        "truncation": ("disabled",),
        "tool_choice": ("none", "auto"),
        "service_tier": ("auto", "default"),
    }

    @staticmethod
    def _parse_text_format(d: dict) -> dict | None:
        """`text.format` (Responses structured output) → the chat
        ``response_format`` shape. Previously 501-rejected; now mapped."""
        text = d.get("text")
        if text in (None, {}):
            return None
        if not isinstance(text, dict):
            raise OpenAIError("'text' must be an object")
        # Only `format` is implemented; other text.* options (verbosity,
        # ...) keep the explicit unsupported signal they had when the
        # whole field was 501-rejected — silently dropping them would
        # lie to clients that rely on them.
        extra = sorted(set(text) - {"format"})
        if extra:
            raise OpenAIError(
                f"'text.{extra[0]}' is not supported", status=501,
                err_type="not_implemented_error",
            )
        fmt = text.get("format")
        if fmt in (None, {}):
            return None
        if not isinstance(fmt, dict):
            raise OpenAIError("'text.format' must be an object")
        ftype = fmt.get("type")
        if ftype == "text":
            return None
        if ftype == "json_object":
            return {"type": "json_object"}
        if ftype == "json_schema":
            schema = fmt.get("schema")
            if not isinstance(schema, dict):
                raise OpenAIError(
                    "'text.format.schema' must be a JSON schema object"
                )
            js: dict[str, Any] = {"schema": schema}
            if fmt.get("name") is not None:
                js["name"] = str(fmt["name"])
            if fmt.get("strict") is not None:
                js["strict"] = bool(fmt["strict"])
            return {"type": "json_schema", "json_schema": js}
        raise OpenAIError(
            "'text.format.type' must be one of 'text', 'json_object', "
            "'json_schema'"
        )

    @classmethod
    def parse(cls, d: Any) -> "ResponsesRequest":
        if not isinstance(d, dict):
            raise OpenAIError("request body must be a JSON object")
        model = d.get("model")
        if not model or not isinstance(model, str):
            raise OpenAIError("'model' is required")
        for key in cls._UNSUPPORTED:
            v = d.get(key)
            if v in (None, False) or v == [] or v == {}:
                continue
            if v in cls._NOOP_VALUES.get(key, ()):
                continue
            raise OpenAIError(
                f"'{key}' is not supported", status=501,
                err_type="not_implemented_error",
            )
        if d.get("store") is True:
            raise OpenAIError("'store: true' is not supported (stateless service)",
                              status=501, err_type="not_implemented_error")
        instructions = d.get("instructions")
        if instructions is not None and not isinstance(instructions, str):
            raise OpenAIError("'instructions' must be a string")
        messages: list[ChatMessage] = []
        if instructions:
            messages.append(ChatMessage(role="system", content=instructions))
        messages.extend(cls._parse_input(d.get("input")))
        max_out = d.get("max_output_tokens")
        if max_out is not None and (not isinstance(max_out, int) or max_out < 1):
            raise OpenAIError("'max_output_tokens' must be a positive integer")
        priority, tenant = parse_qos_fields(d)
        return cls(
            model=model,
            messages=messages,
            stream=bool(d.get("stream", False)),
            max_output_tokens=max_out,
            temperature=_opt_float(d, "temperature", 0.0, 2.0),
            top_p=_opt_float(d, "top_p", 0.0, 1.0),
            top_k=d.get("top_k"),
            seed=d.get("seed"),
            instructions=instructions,
            response_format=cls._parse_text_format(d),
            priority=priority,
            tenant=tenant,
            raw=d,
        )

    @staticmethod
    def _parse_input(raw: Any) -> list[ChatMessage]:
        """`input`: a string (one user message) or a list of message items.
        Text-only: content parts must be input_text/output_text."""
        if isinstance(raw, str):
            return [ChatMessage(role="user", content=raw)]
        if not isinstance(raw, list) or not raw:
            raise OpenAIError("'input' must be a string or a non-empty array")
        out: list[ChatMessage] = []
        for item in raw:
            if not isinstance(item, dict):
                raise OpenAIError("'input' items must be objects")
            itype = item.get("type", "message")
            if itype != "message":
                raise OpenAIError(
                    f"input item type {itype!r} is not supported (text-only)",
                    status=501, err_type="not_implemented_error",
                )
            role = item.get("role")
            if role not in ("user", "assistant", "system", "developer"):
                raise OpenAIError("input message 'role' must be user/assistant/system/developer")
            content = item.get("content")
            if isinstance(content, list):
                parts = []
                for p in content:
                    if not isinstance(p, dict) or p.get("type") not in (
                        "input_text", "output_text", "text"
                    ):
                        raise OpenAIError(
                            "only text content parts are supported",
                            status=501, err_type="not_implemented_error",
                        )
                    parts.append(str(p.get("text", "")))
                content = "".join(parts)
            if not isinstance(content, str):
                raise OpenAIError("input message 'content' must be a string or part list")
            # `developer` is the Responses-era spelling of `system`.
            out.append(ChatMessage(role="system" if role == "developer" else role,
                                   content=content))
        return out

    def to_chat(self) -> ChatCompletionRequest:
        return ChatCompletionRequest(
            model=self.model,
            messages=self.messages,
            stream=self.stream,
            max_tokens=self.max_output_tokens,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            seed=self.seed,
            response_format=self.response_format,
            priority=self.priority,
            tenant=self.tenant,
            raw=self.raw,
        )


def responses_usage(prompt_tokens: int, completion_tokens: int) -> dict[str, Any]:
    return {
        "input_tokens": prompt_tokens,
        "input_tokens_details": {"cached_tokens": 0},
        "output_tokens": completion_tokens,
        "output_tokens_details": {"reasoning_tokens": 0},
        "total_tokens": prompt_tokens + completion_tokens,
    }


def responses_message_item(item_id: str, text: str, status: str = "completed") -> dict[str, Any]:
    return {
        "type": "message", "id": item_id, "status": status, "role": "assistant",
        "content": [{"type": "output_text", "text": text, "annotations": []}]
        if status != "in_progress" else [],
    }


def responses_body(
    response_id: str,
    model: str,
    created: int,
    *,
    status: str = "completed",
    output: list[dict] | None = None,
    usage: dict | None = None,
    incomplete_reason: str | None = None,
    req: "ResponsesRequest | None" = None,
) -> dict[str, Any]:
    """The Responses API response object (final or in-progress snapshot)."""
    return {
        "id": response_id,
        "object": "response",
        "created_at": created,
        "status": status,
        "error": None,
        "incomplete_details": (
            {"reason": incomplete_reason} if incomplete_reason else None
        ),
        "instructions": req.instructions if req else None,
        "max_output_tokens": req.max_output_tokens if req else None,
        "model": model,
        "output": output or [],
        "parallel_tool_calls": False,
        "previous_response_id": None,
        "store": False,
        "temperature": req.temperature if req else None,
        "top_p": req.top_p if req else None,
        "tool_choice": "none",
        "tools": [],
        "truncation": "disabled",
        "usage": usage,
        "metadata": {},
    }


def gen_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict[str, int]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def chat_chunk(
    request_id: str,
    model: str,
    created: int,
    *,
    content: str | None = None,
    role: str | None = None,
    finish_reason: str | None = None,
    usage: dict[str, int] | None = None,
    logprobs: dict | None = None,
    tool_calls: list[dict] | None = None,
) -> dict[str, Any]:
    """One `chat.completion.chunk` SSE payload."""
    delta: dict[str, Any] = {}
    if role is not None:
        delta["role"] = role
    if content is not None:
        delta["content"] = content
    if tool_calls:
        delta["tool_calls"] = [
            dict(tc, index=i) for i, tc in enumerate(tool_calls)
        ]
    choice: dict[str, Any] = {"index": 0, "delta": delta, "finish_reason": finish_reason}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    body: dict[str, Any] = {
        "id": request_id,
        "object": "chat.completion.chunk",
        "created": created,
        "model": model,
        "choices": [choice],
    }
    if usage is not None:
        body["usage"] = usage
    return body


def chat_completion(
    request_id: str,
    model: str,
    created: int,
    content: str,
    finish_reason: str,
    usage: dict[str, int],
    logprobs: dict | None = None,
) -> dict[str, Any]:
    choice: dict[str, Any] = {
        "index": 0,
        "message": {"role": "assistant", "content": content},
        "finish_reason": finish_reason,
    }
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return {
        "id": request_id,
        "object": "chat.completion",
        "created": created,
        "model": model,
        "choices": [choice],
        "usage": usage,
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


def model_list(models: Iterable[str], owned_by: str = "dynamo-tpu",
               metadata: dict[str, dict] | None = None) -> dict[str, Any]:
    """OpenAI /v1/models body. ``metadata`` adds per-model extra keys —
    LoRA adapter cards surface {"lora": {base, rank, resident_tier}} so
    clients can tell an adapter entry from its base model."""
    now = int(time.time())
    data = []
    for m in models:
        entry: dict[str, Any] = {
            "id": m, "object": "model", "created": now, "owned_by": owned_by,
        }
        md = (metadata or {}).get(m)
        if md:
            entry.update(md)
        data.append(entry)
    return {"object": "list", "data": data}


# ---------------------------------------------------------------------------
# Engine-delta coalescing (frontend streaming fast path)
# ---------------------------------------------------------------------------


def coalesce_delta(head: dict, tail: dict) -> dict | None:
    """Merge two adjacent LLMEngineOutput dicts into one, or None when they
    can't merge. Used by the engine emit layer to batch a backlog of decode
    deltas into one wire frame. ``head`` must be an open delta (no finish/
    error); ``tail`` may carry the finish — it rides the merged frame.
    Merging is refused when optional per-token fields (logprobs) are
    present on one side only, so alignment with token_ids never breaks."""
    if head.get("finish_reason") or head.get("error") or tail.get("error"):
        return None
    # A migration handoff marker must reach the Migration operator as its
    # own frame: merging it into a token delta would silently drop the
    # resume payload (only the whitelisted keys below survive a merge).
    if head.get("migration") is not None or tail.get("migration") is not None:
        return None
    h_ids, t_ids = head.get("token_ids") or [], tail.get("token_ids") or []
    for key in ("log_probs", "top_log_probs"):
        h, t = head.get(key), tail.get(key)
        # The side missing a per-token field must have no tokens, or the
        # merged field would misalign with the merged token_ids.
        if (h is None) != (t is None) and (t_ids if t is None else h_ids):
            return None
    if head.get("text") is not None or tail.get("text") is not None:
        return None  # detokenized deltas are not engine-mergeable
    out = {"token_ids": h_ids + t_ids}
    for key in ("log_probs", "top_log_probs"):
        h, t = head.get(key), tail.get(key)
        if h is not None or t is not None:
            out[key] = (h or []) + (t or [])
    for key in ("finish_reason", "cum_log_probs", "kv_transfer_params"):
        v = tail.get(key)
        if v is None:
            v = head.get(key)
        if v is not None:
            out[key] = v
    return out


# ---------------------------------------------------------------------------
# SSE codec (reference: lib/llm/src/protocols/codec.rs:755)
# ---------------------------------------------------------------------------

SSE_DONE = b"data: [DONE]\n\n"


def sse_event(data: str) -> bytes:
    return f"data: {data}\n\n".encode()


class EncodedSse(bytes):
    """A fully-rendered ``data: ...\\n\\n`` SSE frame, spliced from a
    per-stream preserialized envelope. ``text`` carries the raw delta text
    so consumers that need the content (the Responses event stream) don't
    re-parse the JSON."""

    text: str

    def __new__(cls, data: bytes, text: str) -> "EncodedSse":
        self = super().__new__(cls, data)
        self.text = text
        return self


_SSE_SENTINEL = "\x00@@dyntpu-delta@@\x00"


def sse_content_template(chunk: dict[str, Any]) -> tuple[bytes, bytes] | None:
    """→ (prefix, suffix) byte fragments of ``sse_event(json.dumps(chunk))``
    split at ``chunk``'s sentinel-valued content field, so a per-delta frame
    is ``prefix + json.dumps(text).encode() + suffix`` — byte-identical to
    serializing the whole chunk dict, at the cost of encoding only the new
    text. ``chunk`` must carry :data:`_SSE_SENTINEL` as the value of the
    content field. None when the split isn't unambiguous."""
    rendered = json.dumps(chunk)
    marker = json.dumps(_SSE_SENTINEL)
    pre, sep, post = rendered.partition(marker)
    if not sep or marker in post:
        return None
    return b"data: " + pre.encode(), post.encode() + b"\n\n"


def sse_typed_event(event: str, data: str) -> bytes:
    """Named SSE frame (`event:` + `data:`) — the Responses API stream
    format (each semantic event carries its type both in the SSE field
    and in the JSON payload)."""
    return f"event: {event}\ndata: {data}\n\n".encode()


def parse_sse_lines(chunks: Iterable[bytes]) -> Iterable[str]:
    """Parse an SSE byte stream into `data:` payload strings ("[DONE]"
    included). Test/client helper; tolerant of split chunks."""
    buf = b""
    for chunk in chunks:
        buf += chunk
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            for line in event.split(b"\n"):
                if line.startswith(b"data: "):
                    yield line[6:].decode()
                elif line.startswith(b"data:"):
                    yield line[5:].decode()
