"""OpenAI → engine-ready preprocessing: chat templating, tokenization,
sampling/stop mapping; plus the response-side DeltaGenerator.

Reference analogue: ``OpenAIPreprocessor`` (lib/llm/src/preprocessor.rs:
92-144,320) with minijinja chat templates (preprocessor/prompt/template/)
— here jinja2, same template contract as HF `chat_template`.
"""

from __future__ import annotations

import json
import re
import time
import uuid
from typing import Any

from dynamo_tpu_torch.llm import template as jinja2

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import (
    ChatCompletionRequest,
    ChatMessage,
    CompletionRequest,
    EncodedSse,
    OpenAIError,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
    _SSE_SENTINEL,
    chat_chunk,
    completion_chunk,
    gen_request_id,
    sse_content_template,
    usage_dict,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer, load_tokenizer

# Generic chat template used when the model card carries none. Matches the
# widely-used ChatML-ish shape; ByteTokenizer round-trips it exactly.
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message.role }}|>\n{{ message.content }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


class ChatTemplate:
    def __init__(self, source: str | None = None):
        env = jinja2.Environment(
            loader=jinja2.BaseLoader(),
            autoescape=False,
            undefined=jinja2.StrictUndefined,
            trim_blocks=True,
            lstrip_blocks=True,
        )
        # HF templates call raise_exception(); provide it.
        env.globals["raise_exception"] = _raise_template_exception
        self._template = env.from_string(source or DEFAULT_CHAT_TEMPLATE)

    def render(self, messages: list[ChatMessage], add_generation_prompt: bool = True,
               tools: list[dict] | None = None) -> str:
        try:
            return self._template.render(
                tools=tools or None,
                messages=[m.to_dict() for m in messages],
                add_generation_prompt=add_generation_prompt,
                bos_token="",
                eos_token="",
            )
        except jinja2.UndefinedError as e:
            raise OpenAIError(f"chat template error: {e}", status=500) from e


def _raise_template_exception(msg: str):
    raise OpenAIError(f"chat template rejected request: {msg}")


class OpenAIPreprocessor:
    """Stateless per-model request preprocessor. Built from a model card;
    owns the tokenizer and chat template."""

    def __init__(self, card: ModelDeploymentCard, tokenizer: Tokenizer | None = None):
        self.card = card
        self.tokenizer = tokenizer or load_tokenizer(card.tokenizer)
        self.template = ChatTemplate(card.chat_template)
        eos = list(card.eos_token_ids) or list(self.tokenizer.eos_token_ids)
        self._eos_ids = eos

    # -- request side -----------------------------------------------------

    def _common(
        self,
        req: ChatCompletionRequest | CompletionRequest,
        token_ids: list[int],
        annotations: dict[str, Any],
    ) -> PreprocessedRequest:
        if not token_ids:
            raise OpenAIError("prompt must not be empty")
        if len(token_ids) >= self.card.context_length:
            raise OpenAIError(
                f"prompt ({len(token_ids)} tokens) exceeds model context length "
                f"({self.card.context_length})"
            )
        sampling = SamplingOptions(
            temperature=1.0 if req.temperature is None else req.temperature,
            top_p=1.0 if req.top_p is None else req.top_p,
            top_k=int(req.top_k or 0),
            seed=req.seed,
            frequency_penalty=getattr(req, "frequency_penalty", None) or 0.0,
            presence_penalty=getattr(req, "presence_penalty", None) or 0.0,
            # Chat: logprobs is a bool. Completions: an int top-N where
            # even 0 means "return chosen-token logprobs with 0
            # alternatives" (OpenAI semantics), so presence enables it.
            logprobs=(
                getattr(req, "logprobs", None) is not None
                if isinstance(req, CompletionRequest)
                else bool(getattr(req, "logprobs", False))
            ),
            # Chat: explicit top_logprobs (0-20). Completions: logprobs=N
            # asks for N ranked alternatives per position.
            top_logprobs=(
                int(getattr(req, "logprobs", 0) or 0)
                if isinstance(req, CompletionRequest)
                else int(getattr(req, "top_logprobs", 0) or 0)
            ),
        )
        # Budget: explicit max_tokens, else whatever fits in context.
        budget = self.card.context_length - len(token_ids)
        max_tokens = min(req.max_tokens, budget) if req.max_tokens else budget
        stop = StopConditions(
            max_tokens=max_tokens,
            stop=list(req.stop),
            min_tokens=int(req.min_tokens or 0),
            ignore_eos=req.ignore_eos,
        )
        # Structured output needs grammar-constrained decoding on the
        # device, which the port's engine does not have yet: refuse it at
        # the frontend with a typed 400 rather than serve unconstrained text.
        response_format = getattr(req, "response_format", None)
        if response_format is not None:
            raise OpenAIError(
                "response_format is not supported by this server yet "
                "(grammar-constrained decoding is not ported)"
            )
        return PreprocessedRequest(
            model=self.card.name,
            token_ids=token_ids,
            sampling=sampling,
            stop=stop,
            eos_token_ids=self._eos_ids,
            annotations=annotations,
            response_format=response_format,
            # Multi-LoRA: a card published for a LoRA fine-tune stamps its
            # adapter identity into every request — the engine resolves it
            # to a resident bank slot and the router keys KV stickiness by
            # (model, adapter).
            adapter_id=(self.card.lora or {}).get("adapter_id"),
            # Multi-tenant QoS identity: validated at parse time (body
            # fields / headers), carried to the engine so admission
            # ordering and preemption are class-aware end to end.
            priority=getattr(req, "priority", None),
            tenant=getattr(req, "tenant", None),
        )

    def preprocess_chat(self, req: ChatCompletionRequest) -> PreprocessedRequest:
        # Tool definitions render through the chat template's `tools`
        # variable — the HF chat-template contract (reference analogue:
        # preprocessor/tools.rs builds the tool prompt for the template).
        tools = req.tools if req.tool_choice != "none" else []
        prompt = self.template.render(req.messages, add_generation_prompt=True,
                                      tools=tools)
        token_ids = self.tokenizer.encode(prompt)
        annotations: dict[str, Any] = {}
        if "formatted_prompt" in req.annotations:
            annotations["formatted_prompt"] = prompt
        if "token_ids" in req.annotations:
            annotations["token_ids"] = token_ids
        return self._common(req, token_ids, annotations)

    def preprocess_completion(self, req: CompletionRequest) -> PreprocessedRequest:
        if isinstance(req.prompt, list):
            token_ids = [int(t) for t in req.prompt]
        else:
            token_ids = self.tokenizer.encode(req.prompt)
        annotations: dict[str, Any] = {}
        if "token_ids" in req.annotations:
            annotations["token_ids"] = token_ids
        return self._common(req, token_ids, annotations)


_TOOL_CALL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.S)


def parse_tool_calls(text: str, tool_names: set[str] | None = None) -> list[dict]:
    """Best-effort tool-call extraction from generated text (reference:
    preprocessor/tools.rs parses engine output into tool calls).
    Recognizes the two common open-model conventions:
    - Hermes/Qwen: ``<tool_call>{"name": ..., "arguments": {...}}</tool_call>``
    - Llama-3.x JSON: the whole completion is one JSON object with
      ``name`` + ``arguments``/``parameters``.
    The bare-JSON fallback only fires when the parsed name matches a
    DECLARED tool (``tool_names``) — a legitimate JSON answer that merely
    contains a "name" key must not be hijacked into a phantom call.
    → OpenAI-shaped tool_calls list ([] = no call detected)."""
    calls: list[dict] = []

    def mk(obj) -> dict | None:
        if not isinstance(obj, dict) or "name" not in obj:
            return None
        args = obj.get("arguments", obj.get("parameters", {}))
        if not isinstance(args, str):
            args = json.dumps(args)
        return {
            "id": f"call_{uuid.uuid4().hex[:24]}",
            "type": "function",
            "function": {"name": str(obj["name"]), "arguments": args},
        }

    for m in _TOOL_CALL_RE.finditer(text):
        try:
            call = mk(json.loads(m.group(1)))
        except json.JSONDecodeError:
            continue
        if call:
            calls.append(call)
    if calls:
        return calls
    stripped = text.strip()
    if stripped.startswith("{") and stripped.endswith("}"):
        try:
            obj = json.loads(stripped)
        except json.JSONDecodeError:
            return []
        if (
            isinstance(obj, dict)
            and tool_names is not None
            and obj.get("name") in tool_names
        ):
            call = mk(obj)
            if call:
                return [call]
    return []


class DeltaGenerator:
    """Turns Backend text deltas into OpenAI SSE chunk payloads and the
    final aggregated response (reference: preprocessor.rs DeltaGenerator +
    protocols/openai/*/aggregator.rs)."""

    def __init__(
        self,
        model: str,
        kind: str = "chat",
        request_id: str | None = None,
        prompt_tokens: int = 0,
        want_logprobs: bool = False,
        token_text_fn=None,  # tid -> str, for logprob token labels
        want_tools: bool = False,       # scan output for tool calls
        tool_names: set[str] | None = None,  # declared tools (bare-JSON filter)
    ):
        assert kind in ("chat", "completion")
        self.kind = kind
        self.model = model
        self.id = request_id or gen_request_id("chatcmpl" if kind == "chat" else "cmpl")
        self.created = int(time.time())
        self.prompt_tokens = prompt_tokens
        self.completion_tokens = 0
        self.text_parts: list[str] = []
        self.finish_reason: str | None = None
        self._first = True
        self.want_logprobs = want_logprobs
        self.want_tools = want_tools
        self.tool_names = tool_names or set()
        self._token_text = token_text_fn or (lambda tid: "")
        # Accumulated (token_id, logprob, alternatives) for the final
        # response; alternatives entries are [[token_id, logprob], ...].
        self.lp_tokens: list[int] = []
        self.lp_values: list[float] = []
        self.lp_tops: list[list | None] = []
        # Preserialized SSE envelope for pure content deltas (built lazily
        # per stream; False = template unsplittable, use the generic path).
        self._sse_tpl: tuple[bytes, bytes] | bool | None = None

    # -- streaming fast path ------------------------------------------------

    def _build_sse_template(self) -> tuple[bytes, bytes] | bool:
        if self.kind == "chat":
            chunk = chat_chunk(self.id, self.model, self.created, content=_SSE_SENTINEL)
        else:
            chunk = completion_chunk(self.id, self.model, self.created, text=_SSE_SENTINEL)
        return sse_content_template(chunk) or False

    def note_tokens_only(self, n_tokens: int) -> bool:
        """Bookkeeping for a tokens-only delta (text still held in the stop
        jail / decode window): count toward usage, emit no chunk. False when
        the generic path must run instead (the first chat delta emits the
        role chunk even without text)."""
        if self._first and self.kind == "chat":
            return False
        self.completion_tokens += n_tokens
        return True

    def encode_content_chunk(self, text: str, n_tokens: int) -> EncodedSse | None:
        """Fast path for a pure text delta: returns the fully-rendered SSE
        frame (byte-identical to ``sse_event(json.dumps(chunk))`` of the
        equivalent :func:`chat_chunk`/:func:`completion_chunk`) built from a
        cached per-stream envelope — the per-delta cost is one json string
        encode of the new text. None when the generic path must run (first
        chunk still pending, logprobs requested, or no template)."""
        if self.want_logprobs or (self._first and self.kind == "chat"):
            return None
        tpl = self._sse_tpl
        if tpl is None:
            tpl = self._sse_tpl = self._build_sse_template()
        if tpl is False:
            return None
        self.completion_tokens += n_tokens
        self.text_parts.append(text)
        prefix, suffix = tpl
        return EncodedSse(prefix + json.dumps(text).encode() + suffix, text)

    def _top_entries(self, top: list | None) -> list[dict]:
        """One token's ranked alternatives → OpenAI chat entries."""
        if not top:
            return []
        return [
            {"token": self._token_text(int(tid)), "logprob": float(lp),
             "bytes": list(self._token_text(int(tid)).encode())}
            for tid, lp in top
        ]

    def _top_map(self, top: list | None, chosen_id=None, chosen_lp=None) -> dict | None:
        """One token's alternatives → completions {token: logprob} map.
        OpenAI includes the CHOSEN token as an extra entry when it fell
        outside the top-N (maps may hold N+1 entries)."""
        if not top:
            return None
        out = {self._token_text(int(tid)): float(lp) for tid, lp in top}
        if chosen_id is not None:
            out.setdefault(self._token_text(int(chosen_id)), float(chosen_lp))
        return out

    def _lp_delta(self, token_ids, logprobs, top_logprobs=None) -> dict | None:
        """OpenAI logprobs payload for this delta: chosen token plus the
        engine's ranked alternatives when top_logprobs was requested."""
        if not (self.want_logprobs and token_ids and logprobs):
            return None
        n = min(len(token_ids), len(logprobs))
        tops = list(top_logprobs[:n]) if top_logprobs else [None] * n
        tops += [None] * (n - len(tops))
        self.lp_tokens += list(token_ids[:n])
        self.lp_values += [float(x) for x in logprobs[:n]]
        self.lp_tops += tops
        if self.kind == "chat":
            content = [
                {"token": self._token_text(t), "logprob": float(lp),
                 "bytes": list(self._token_text(t).encode()),
                 "top_logprobs": self._top_entries(top)}
                for t, lp, top in zip(token_ids[:n], logprobs[:n], tops)
            ]
            return {"content": content}
        toks = [self._token_text(t) for t in token_ids[:n]]
        return {"tokens": toks, "token_logprobs": [float(x) for x in logprobs[:n]],
                "top_logprobs": (
                    [self._top_map(t, tid, lp)
                     for t, tid, lp in zip(tops, token_ids[:n], logprobs[:n])]
                    if any(tops) else None
                ),
                "text_offset": []}

    def final_logprobs(self) -> dict | None:
        if not self.want_logprobs or not self.lp_tokens:
            return None
        if self.kind == "chat":
            return {"content": [
                {"token": self._token_text(t), "logprob": lp,
                 "bytes": list(self._token_text(t).encode()),
                 "top_logprobs": self._top_entries(top)}
                for t, lp, top in zip(self.lp_tokens, self.lp_values, self.lp_tops)
            ]}
        return {"tokens": [self._token_text(t) for t in self.lp_tokens],
                "token_logprobs": self.lp_values,
                "top_logprobs": (
                    [self._top_map(t, tid, lp) for t, tid, lp in
                     zip(self.lp_tops, self.lp_tokens, self.lp_values)]
                    if any(self.lp_tops) else None
                ),
                "text_offset": []}

    def usage(self) -> dict[str, int]:
        return usage_dict(self.prompt_tokens, self.completion_tokens)

    def on_delta(self, text: str | None, n_tokens: int, finish_reason: str | None,
                 token_ids=None, logprobs=None, top_logprobs=None) -> list[dict]:
        """→ list of SSE chunk payload dicts for this engine delta."""
        self.completion_tokens += n_tokens
        chunks: list[dict] = []
        if text:
            self.text_parts.append(text)
        lp = self._lp_delta(token_ids, logprobs, top_logprobs)
        if self.kind == "chat":
            if self._first:
                self._first = False
                chunks.append(chat_chunk(self.id, self.model, self.created, role="assistant", content=""))
            if text:
                chunks.append(chat_chunk(self.id, self.model, self.created, content=text, logprobs=lp))
            if finish_reason:
                self.finish_reason = finish_reason
                calls = (
                    parse_tool_calls("".join(self.text_parts), self.tool_names)
                    if self.want_tools else []
                )
                if calls:
                    # Streaming tool use: one delta carrying the parsed
                    # calls, then the finish chunk flips to tool_calls —
                    # matching the aggregate path (clients must never see
                    # the two modes disagree).
                    self.finish_reason = finish_reason = "tool_calls"
                    chunks.append(chat_chunk(self.id, self.model, self.created,
                                             tool_calls=calls))
                chunks.append(
                    chat_chunk(
                        self.id, self.model, self.created,
                        finish_reason=finish_reason, usage=self.usage(),
                    )
                )
        else:
            if text:
                chunks.append(completion_chunk(self.id, self.model, self.created, text=text, logprobs=lp))
            if finish_reason:
                self.finish_reason = finish_reason
                chunks.append(
                    completion_chunk(
                        self.id, self.model, self.created,
                        finish_reason=finish_reason, usage=self.usage(),
                    )
                )
        return chunks

    def final_response(self) -> dict:
        """Aggregated non-streaming response."""
        from dynamo_tpu_torch.llm.protocols import chat_completion, completion_response

        text = "".join(self.text_parts)
        finish = self.finish_reason or "stop"
        lp = self.final_logprobs()
        if self.kind == "chat":
            body = chat_completion(self.id, self.model, self.created, text, finish,
                                   self.usage(), logprobs=lp)
            if self.want_tools:
                calls = parse_tool_calls(text, self.tool_names)
                if calls:
                    msg = body["choices"][0]["message"]
                    msg["content"] = None
                    msg["tool_calls"] = calls
                    body["choices"][0]["finish_reason"] = "tool_calls"
            return body
        return completion_response(self.id, self.model, self.created, text, finish,
                                   self.usage(), logprobs=lp)
