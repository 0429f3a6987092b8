"""Single-process launcher: ``python -m dynamo_tpu_torch.run --in batch:F|text``
(port of ``dynamo_tpu/run/__main__.py``).

The whole LLM chain (preprocessor → detokenizing backend → engine) runs
in this one process, on the card unless ``--device cpu`` is given. Batch
mode prints one JSON line per prompt, as the JAX launcher does. ``--in
http`` comes with the HTTP slice.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from typing import AsyncIterator

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import DeltaGenerator, OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols import CompletionRequest, EngineError
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer, parse_tokenizer_spec
from dynamo_tpu_torch.runtime.engine import Context


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.run")
    p.add_argument("--in", dest="input", default="text", help="text | batch:<jsonl path>")
    p.add_argument("--preset", default="test-tiny")
    p.add_argument("--tokenizer", default="byte")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-kv-blocks", type=int, default=512)
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--decode-steps", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--dtype", default=None, help="default: bfloat16 on cuda, float32 on cpu")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


class LocalPipeline:
    """One served model wired straight to an in-process engine:
    preprocessor → Backend(engine) → DeltaGenerator (the JAX package's
    LocalPipeline / ModelPipeline.run, completions only)."""

    def __init__(self, card: ModelDeploymentCard, engine, tokenizer):
        self.card = card
        self.engine = engine
        self.preprocessor = OpenAIPreprocessor(card, tokenizer)
        self.backend = Backend(engine, tokenizer)

    async def run(self, req: CompletionRequest,
                  context: Context) -> AsyncIterator[tuple[DeltaGenerator, dict | None]]:
        """Preprocess + stream. Yields (gen, chunk) pairs: chunk is a
        completion chunk payload, or None for a bookkeeping-only delta."""
        pre = self.preprocessor.preprocess_completion(req)
        gen = DeltaGenerator(
            self.card.name, prompt_tokens=len(pre.token_ids),
            want_logprobs=pre.sampling.logprobs,
            token_text_fn=lambda tid: self.preprocessor.tokenizer.decode([tid]),
        )
        stream = self.backend.generate(pre.to_dict(), context)
        try:
            async for raw in stream:
                finish = raw.get("finish_reason")
                if finish == "error":
                    raise EngineError(raw.get("error") or "engine error")
                token_ids = raw.get("token_ids") or ()
                chunks = gen.on_delta(raw.get("text"), len(token_ids), finish,
                                      token_ids=token_ids, logprobs=raw.get("log_probs"),
                                      top_logprobs=raw.get("top_log_probs"))
                if not chunks:
                    yield gen, None
                for c in chunks:
                    yield gen, c
                if finish is not None:
                    return
        finally:
            await stream.aclose()


async def build_pipeline(args) -> LocalPipeline:
    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    if args.dtype is None:
        args.dtype = "float32" if args.device == "cpu" else "bfloat16"
    model = ModelConfig.preset(args.preset)
    engine = await TorchEngine(EngineArgs(
        model=model, block_size=args.block_size, num_kv_blocks=args.num_kv_blocks,
        max_num_seqs=args.max_num_seqs, max_model_len=args.max_model_len,
        dtype=args.dtype, decode_steps=args.decode_steps, device=args.device,
    ), seed=args.seed).start()
    tokenizer = load_tokenizer(parse_tokenizer_spec(args.tokenizer))
    card = ModelDeploymentCard(
        name=model.name,
        tokenizer=parse_tokenizer_spec(args.tokenizer),
        context_length=args.max_model_len,
        kv_cache_block_size=args.block_size,
        eos_token_ids=list(tokenizer.eos_token_ids) or [ByteTokenizer.EOS],
    )
    return LocalPipeline(card, engine, tokenizer)


async def run_text(args, pipe: LocalPipeline) -> None:
    print(f"dynamo_tpu_torch.run: {pipe.card.name} ready. Empty line or Ctrl-D exits.", flush=True)
    loop = asyncio.get_running_loop()
    while True:
        try:
            line = await loop.run_in_executor(None, lambda: input("> "))
        except (EOFError, KeyboardInterrupt):
            break
        if not line.strip():
            break
        req = CompletionRequest.parse({
            "model": pipe.card.name, "prompt": line,
            "max_tokens": args.max_tokens, "temperature": args.temperature, "stream": True,
        })
        async for _gen, chunk in pipe.run(req, Context()):
            if chunk is not None:
                print(chunk["choices"][0].get("text") or "", end="", flush=True)
        print(flush=True)


async def run_batch(args, pipe: LocalPipeline, path: str) -> None:
    """Each input line: JSON {"prompt": ...} or raw text. Emits JSONL
    results on stdout."""
    n = 0
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    for ln in lines:
        obj: dict = {}
        try:
            parsed = json.loads(ln)
            prompt = parsed["prompt"] if isinstance(parsed, dict) else str(parsed)
            if isinstance(parsed, dict):
                obj = parsed
        except (json.JSONDecodeError, KeyError):
            prompt = ln
        # Per-line sampling overrides win over the CLI defaults.
        req = CompletionRequest.parse({
            "model": pipe.card.name, "prompt": prompt,
            "max_tokens": obj.get("max_tokens", args.max_tokens),
            "temperature": obj.get("temperature", args.temperature),
            "top_p": obj.get("top_p"), "seed": obj.get("seed"),
            "stop": obj.get("stop"),
        })
        gen = None
        async for g, _chunk in pipe.run(req, Context()):
            gen = g
        out = gen.final_response()
        print(json.dumps({
            "prompt": prompt,
            "text": out["choices"][0]["text"],
            "finish_reason": out["choices"][0]["finish_reason"],
            "completion_tokens": out["usage"]["completion_tokens"],
        }), flush=True)
        n += 1
    print(f"dynamo_tpu_torch.run: batch done ({n} prompts)", file=sys.stderr, flush=True)


async def async_main(args) -> None:
    pipe = await build_pipeline(args)
    try:
        if args.input == "text":
            await run_text(args, pipe)
        elif args.input.startswith("batch:"):
            await run_batch(args, pipe, args.input[len("batch:"):])
        else:
            raise SystemExit(f"unknown --in {args.input!r} (text | batch:<path>)")
    finally:
        await pipe.engine.stop()


def main(argv=None) -> int:
    asyncio.run(async_main(parse_args(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
