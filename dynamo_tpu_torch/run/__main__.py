"""Single-process launcher: ``python -m dynamo_tpu_torch.run --in
text|http|batch:F`` (port of ``dynamo_tpu/run/__main__.py``).

The whole LLM chain (preprocessor → detokenizing backend → engine) runs
in this one process, on the card unless ``--device cpu`` is given. Batch
mode prints one JSON line per prompt, as the JAX launcher does; ``--in
http`` serves the OpenAI surface of the distributed frontend without a
store or worker, after capturing the engine's decode-window graphs, its
single-step graphs, unmasked and masked (and with ``--spec-tokens`` its verify graphs,
masked tree shapes included); the speculative-decoding flags are the
worker's. ``response_format`` and /v1/embeddings are served by the
in-process engine.
``--model-path`` serves a checkpoint (HF directory, .gguf file or cached
hub name) with its own tokenizer unless ``--tokenizer`` names another, as
the worker does. ``--engine mocker`` serves the mocker
(``mocker/engine.py``, its default timing) as ``mock-model`` with the byte
tokenizer, as the JAX launcher does; it touches no device.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import signal
import sys

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.pipeline import ModelPipeline
from dynamo_tpu_torch.llm.protocols import CompletionRequest
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer, tokenizer_spec_for
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.run")
    p.add_argument("--in", dest="input", default="text",
                   help="text | http | batch:<jsonl path>")
    p.add_argument("--engine", choices=["tpu", "mocker"], default="tpu",
                   help="tpu = the engine (TorchEngine), mocker = the simulated one")
    p.add_argument("--preset", default="test-tiny")
    p.add_argument("--model-path", default=None)
    p.add_argument("--tokenizer", default=None,
                   help='"byte" | "hf:<path>" | "gguf:<path>" (default: the checkpoint\'s own '
                        "with --model-path, byte without)")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-kv-blocks", type=int, default=512)
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--decode-steps", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--dtype", default=None, help="default: bfloat16 on cuda, float32 on cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--seed", type=int, default=0)
    # Speculative decoding, the worker's flags and defaults.
    p.add_argument("--spec-tokens", type=int, default=0,
                   help="max draft tokens verified per speculative pass (0 = off)")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="n-gram match length for the prompt-lookup drafter")
    p.add_argument("--spec-stepwise", action="store_true",
                   help="verify drafts with a stepwise loop of the dense decode step")
    p.add_argument("--spec-tree-width", type=int, default=1,
                   help="max draft-tree branching factor (1 = linear drafts)")
    p.add_argument("--spec-tree-depth", type=int, default=0,
                   help="max draft-tree path depth (0 = spec-tokens)")
    p.add_argument("--spec-budget", choices=["adaptive", "uniform"], default="adaptive",
                   help="per-pass draft-node allocation across the batch")
    return p.parse_args(argv)


class LocalPipeline(ModelPipeline):
    """ModelPipeline wired straight to an in-process engine (no router,
    no store): Backend(engine) replaces the network chain."""

    def __init__(self, card, engine, tokenizer):
        super().__init__(namespace="local", card=card, runtime=None)
        self.engine = engine
        self.backend = Backend(engine, tokenizer)

    async def embed(self, token_ids):
        return await self.engine.embed(token_ids)

    async def clear_kv_blocks(self):
        return {"local": self.engine.clear_kv_blocks()}


class LocalManager:
    def __init__(self, pipe: LocalPipeline):
        self.pipe = pipe

    def get(self, model_name: str):
        return self.pipe if model_name == self.pipe.card.name else None

    def list_names(self):
        return [self.pipe.card.name]

    def items(self):
        return [(self.pipe.card.name, self.pipe)]


async def build_pipeline(args, quant: str = "none", kv_quant: str = "none") -> LocalPipeline:
    """The CLI's pipeline. ``quant`` / ``kv_quant`` (no flags, as in the JAX
    launcher) set the engine's weight and KV page formats for callers that
    drive the pipeline in process (a ``--model-path`` checkpoint is
    quantized as it loads, as the worker does)."""
    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig, spec_engine_args
    from dynamo_tpu_torch.engine.engine import TorchEngine

    if args.engine == "mocker":
        from dynamo_tpu_torch.mocker.engine import MockerArgs, MockerEngine

        engine = MockerEngine(MockerArgs(block_size=args.block_size,
                                         num_kv_blocks=args.num_kv_blocks))
        card = ModelDeploymentCard(name="mock-model", tokenizer={"type": "byte"},
                                   context_length=args.max_model_len,
                                   kv_cache_block_size=args.block_size,
                                   eos_token_ids=[ByteTokenizer.EOS])
        return LocalPipeline(card, engine, ByteTokenizer())
    if args.dtype is None:
        args.dtype = "float32" if args.device == "cpu" else "bfloat16"
    params = None
    if args.model_path:
        from dynamo_tpu_torch.engine.hub import resolve_model

        args.model_path = resolve_model(args.model_path)
    tok_spec = tokenizer_spec_for(args.model_path, args.tokenizer)
    if args.model_path:
        from dynamo_tpu_torch.engine.loader import load_model

        model, params = load_model(args.model_path, args.dtype, quant, device=args.device)
    else:
        model = ModelConfig.preset(args.preset)
    engine = await TorchEngine(EngineArgs(
        model=model, block_size=args.block_size, num_kv_blocks=args.num_kv_blocks,
        max_num_seqs=args.max_num_seqs, max_model_len=args.max_model_len,
        dtype=args.dtype, decode_steps=args.decode_steps, device=args.device,
        quant=quant, kv_quant=kv_quant,
        # response_format masks compile over the serving tokenizer's vocabulary.
        grammar_tokenizer=tok_spec, **spec_engine_args(args),
    ), params=params, seed=args.seed).start()
    tokenizer = load_tokenizer(tok_spec)
    card = ModelDeploymentCard(
        name=model.name,
        tokenizer=tok_spec,
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


async def run_http(args, pipe: LocalPipeline) -> None:
    # Capture the decode-window, single-step and verify graphs before
    # listening, so that no request waits for a capture (none on the CPU
    # or the mocker).
    if args.engine != "mocker":
        runner = pipe.engine.runner
        await asyncio.to_thread(runner.warm_windows, ("greedy", "simple"))
        await asyncio.to_thread(runner.warm_steps, ("greedy", "simple"))
        await asyncio.to_thread(runner.warm_spec, ("greedy", "simple"), (0,), True)
    http = await HttpService(
        LocalManager(pipe), MetricsRegistry(), host=args.host, port=args.port
    ).start()
    print(f"dynamo_tpu_torch.run: http://{args.host}:{http.port} serving {pipe.card.name}",
          flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    # Same SIGTERM contract as the distributed frontend: shed new work,
    # finish in-flight streams, then close.
    from dynamo_tpu_torch.runtime.config import global_config

    http.start_draining()
    await http.wait_drained(global_config().runtime.graceful_shutdown_timeout)
    await http.close()


async def async_main(args) -> None:
    pipe = await build_pipeline(args)
    try:
        if args.input == "text":
            await run_text(args, pipe)
        elif args.input == "http":
            await run_http(args, pipe)
        elif args.input.startswith("batch:"):
            await run_batch(args, pipe, args.input[len("batch:"):])
        else:
            raise SystemExit(f"unknown --in {args.input!r} (text | http | batch:<path>)")
    finally:
        stop = getattr(pipe.engine, "stop", None)  # the mocker has no thread to stop
        if stop is not None:
            await stop()


def main(argv=None) -> int:
    asyncio.run(async_main(parse_args(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
