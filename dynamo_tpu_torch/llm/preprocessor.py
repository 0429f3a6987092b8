"""OpenAI completions → engine-ready request, and the response-side
DeltaGenerator (port of ``dynamo_tpu/llm/preprocessor.py``, completion
path only: chat templates need jinja2 and come with the HTTP slice)."""

from __future__ import annotations

import time
from typing import Any

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import (
    CompletionRequest,
    OpenAIError,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
    completion_chunk,
    completion_response,
    gen_request_id,
    usage_dict,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer, load_tokenizer


class OpenAIPreprocessor:
    """Stateless per-model request preprocessor built from a model card."""

    def __init__(self, card: ModelDeploymentCard, tokenizer: Tokenizer | None = None):
        self.card = card
        self.tokenizer = tokenizer or load_tokenizer(card.tokenizer)
        self._eos_ids = list(card.eos_token_ids) or list(self.tokenizer.eos_token_ids)

    def preprocess_completion(self, req: CompletionRequest) -> PreprocessedRequest:
        if isinstance(req.prompt, list):
            token_ids = [int(t) for t in req.prompt]
        else:
            token_ids = self.tokenizer.encode(req.prompt)
        if not token_ids:
            raise OpenAIError("prompt must not be empty")
        if len(token_ids) >= self.card.context_length:
            raise OpenAIError(
                f"prompt ({len(token_ids)} tokens) exceeds model context length "
                f"({self.card.context_length})"
            )
        annotations: dict[str, Any] = {}
        if "token_ids" in req.annotations:
            annotations["token_ids"] = token_ids
        sampling = SamplingOptions(
            temperature=1.0 if req.temperature is None else req.temperature,
            top_p=1.0 if req.top_p is None else req.top_p,
            top_k=int(req.top_k or 0),
            seed=req.seed,
            # Completions: logprobs is an int top-N where even 0 means
            # "chosen-token logprobs, no alternatives", so presence enables it.
            logprobs=req.logprobs is not None,
            top_logprobs=int(req.logprobs or 0),
        )
        budget = self.card.context_length - len(token_ids)
        max_tokens = min(req.max_tokens, budget) if req.max_tokens else budget
        stop = StopConditions(
            max_tokens=max_tokens,
            stop=list(req.stop),
            min_tokens=int(req.min_tokens or 0),
            ignore_eos=req.ignore_eos,
        )
        return PreprocessedRequest(
            model=self.card.name,
            token_ids=token_ids,
            sampling=sampling,
            stop=stop,
            eos_token_ids=self._eos_ids,
            annotations=annotations,
        )


class DeltaGenerator:
    """Turns Backend text deltas into OpenAI completion chunk payloads and
    the final aggregated response."""

    def __init__(
        self,
        model: str,
        prompt_tokens: int = 0,
        want_logprobs: bool = False,
        token_text_fn=None,  # tid -> str, for logprob token labels
    ):
        self.model = model
        self.id = gen_request_id("cmpl")
        self.created = int(time.time())
        self.prompt_tokens = prompt_tokens
        self.completion_tokens = 0
        self.text_parts: list[str] = []
        self.finish_reason: str | None = None
        self.want_logprobs = want_logprobs
        self._token_text = token_text_fn or (lambda tid: "")
        # Accumulated (token_id, logprob, alternatives) for the final response.
        self.lp_tokens: list[int] = []
        self.lp_values: list[float] = []
        self.lp_tops: list[list | None] = []

    def _top_map(self, top: list | None, chosen_id=None, chosen_lp=None) -> dict | None:
        """One token's alternatives → completions {token: logprob} map
        (the chosen token is added when it fell outside the top-N)."""
        if not top:
            return None
        out = {self._token_text(int(tid)): float(lp) for tid, lp in top}
        if chosen_id is not None:
            out.setdefault(self._token_text(int(chosen_id)), float(chosen_lp))
        return out

    def _logprobs_body(self, token_ids, values, tops) -> dict:
        return {
            "tokens": [self._token_text(t) for t in token_ids],
            "token_logprobs": [float(x) for x in values],
            "top_logprobs": (
                [self._top_map(t, tid, lp) for t, tid, lp in zip(tops, token_ids, values)]
                if any(tops) else None
            ),
            "text_offset": [],
        }

    def _lp_delta(self, token_ids, logprobs, top_logprobs=None) -> dict | None:
        if not (self.want_logprobs and token_ids and logprobs):
            return None
        n = min(len(token_ids), len(logprobs))
        tops = list(top_logprobs[:n]) if top_logprobs else [None] * n
        tops += [None] * (n - len(tops))
        self.lp_tokens += list(token_ids[:n])
        self.lp_values += [float(x) for x in logprobs[:n]]
        self.lp_tops += tops
        return self._logprobs_body(token_ids[:n], logprobs[:n], tops)

    def usage(self) -> dict[str, int]:
        return usage_dict(self.prompt_tokens, self.completion_tokens)

    def on_delta(self, text: str | None, n_tokens: int, finish_reason: str | None,
                 token_ids=None, logprobs=None, top_logprobs=None) -> list[dict]:
        """→ list of chunk payload dicts for this engine delta."""
        self.completion_tokens += n_tokens
        chunks: list[dict] = []
        if text:
            self.text_parts.append(text)
        lp = self._lp_delta(token_ids, logprobs, top_logprobs)
        if text:
            chunks.append(completion_chunk(self.id, self.model, self.created, text=text, logprobs=lp))
        if finish_reason:
            self.finish_reason = finish_reason
            chunks.append(completion_chunk(
                self.id, self.model, self.created,
                finish_reason=finish_reason, usage=self.usage(),
            ))
        return chunks

    def final_response(self) -> dict:
        """Aggregated non-streaming response."""
        lp = (
            self._logprobs_body(self.lp_tokens, self.lp_values, self.lp_tops)
            if self.want_logprobs and self.lp_tokens else None
        )
        return completion_response(
            self.id, self.model, self.created, "".join(self.text_parts),
            self.finish_reason or "stop", self.usage(), logprobs=lp,
        )
