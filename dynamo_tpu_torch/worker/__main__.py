"""Worker CLI: ``python -m dynamo_tpu_torch.worker`` (port of
``dynamo_tpu/worker/__main__.py``, the aggregated serving path).

Boots a ``TorchEngine`` (on the card unless ``--device cpu``), captures
its decode-window CUDA graphs, serves the ``generate`` endpoint plus the
KV-event, load-metrics and clear-KV endpoints, and registers the model
card: a frontend of either package discovers the model through the
store watch and routes to it over the runtime's wire.

``--model-path`` serves a checkpoint (an HF directory, a .gguf file or a
hub name in the local hub cache) instead of a preset's random weights;
``--quant int8`` quantizes it on the host before it goes to the card, and
the checkpoint's own tokenizer (its ``tokenizer.json`` or GGUF vocabulary,
in the port's pure-Python pipeline) is served unless ``--tokenizer`` names
another; ``--tokenizer byte`` serves bytes.

SIGTERM drains: the endpoints deregister and finish their in-flight
streams, then the engine stops. The last line the worker logs is one
JSON object with its engine's counters (decode substeps dispatched, the
kernels' launches, tokens generated); SIGUSR1 logs the same line and
serves on.

Not ported yet (ROADMAP A): LoRA, disaggregated prefill/decode roles,
peer KV fetch, the autoscaler role manager, the dp spawner, multi-host
followers, trace export, the fleet prefix directory and ``--sla-profile``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import signal
import time

from dynamo_tpu_torch.kv_router.publisher import KvEventBroadcaster, serve_kv_endpoints
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, register_model
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer, tokenizer_spec_for
from dynamo_tpu_torch.ops import int8_matmul as im
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("worker")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.worker")
    p.add_argument("--store-url", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--model-name", default=None, help="served model name (defaults to preset name)")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--preset", default="llama-1b", help="model preset (random weights from --seed)")
    p.add_argument(
        "--model-path", default=None,
        help="HF checkpoint dir (config.json + *.safetensors), .gguf file or cached "
             "org/repo hub name; overrides --preset with real weights",
    )
    p.add_argument("--tokenizer", default=None,
                   help='"byte" | "hf:<path>" | "gguf:<path>" (default: the checkpoint\'s own '
                        "with --model-path, byte without)")
    p.add_argument("--context-length", type=int, default=None)
    p.add_argument("--migration-limit", type=int, default=0)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-kv-blocks", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=16)
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--decode-steps", type=int, default=8)
    # Decode-window pipelining: max windows dispatched-but-unfetched (0 =
    # unpipelined; fetches still start async).
    p.add_argument("--pipeline-depth", type=int, default=2)
    # Streaming delta coalescing: cap on tokens merged into one wire frame
    # when a stream's consumer lags (0 = one frame per decode window), and
    # an optional bounded gather wait in ms (adds up to that much ITL).
    p.add_argument("--delta-max-tokens", type=int, default=64)
    p.add_argument("--delta-max-ms", type=float, default=0.0)
    p.add_argument("--qos-sched", choices=["on", "off"], default="on",
                   help="class-aware engine scheduling: admission and "
                        "KV-pressure preemption ordered by (priority "
                        "class, age). No-priority traffic is byte-"
                        "identical either way; off pins one class")
    p.add_argument("--kv-quant", choices=["none", "int8"], default="none",
                   help="paged KV cache storage (int8 = quantized pages + "
                        "per-position-per-head scales)")
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="weight format (int8 = weight-only quantization, engine/quant.py)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


async def build_engine(args):
    """→ (engine, model_card)."""
    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    params = None
    if args.model_path:
        from dynamo_tpu_torch.engine.hub import resolve_model

        args.model_path = resolve_model(args.model_path)
    tok_spec = tokenizer_spec_for(args.model_path, args.tokenizer)
    tokenizer = load_tokenizer(tok_spec)
    if args.model_path:
        from dynamo_tpu_torch.engine.loader import load_model

        t0 = time.perf_counter()
        model, params = await asyncio.to_thread(
            load_model, args.model_path, args.dtype, args.quant, args.device)
        print(f"dynamo_tpu_torch worker: loaded {args.model_path} (quant {args.quant}) in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    else:
        model = ModelConfig.preset(args.preset)
    engine = await TorchEngine(EngineArgs(
        model=model,
        block_size=args.block_size,
        num_kv_blocks=args.num_kv_blocks,
        max_num_seqs=args.max_num_seqs,
        max_model_len=args.max_model_len,
        dtype=args.dtype,
        decode_steps=args.decode_steps,
        pipeline_depth=args.pipeline_depth,
        pipeline_windows=args.pipeline_depth > 0,
        delta_max_tokens=args.delta_max_tokens,
        delta_max_ms=args.delta_max_ms,
        qos_scheduling=args.qos_sched == "on",
        quant=args.quant,
        kv_quant=args.kv_quant,
        device=args.device,
    ), params=params, seed=args.seed).start()
    card = ModelDeploymentCard(
        name=args.model_name or model.name,
        tokenizer=tok_spec,
        context_length=args.context_length or min(args.max_model_len, model.max_position),
        kv_cache_block_size=args.block_size,
        migration_limit=args.migration_limit,
        eos_token_ids=list(tokenizer.eos_token_ids) or [ByteTokenizer.EOS],
        component=args.component,
        endpoint=args.endpoint,
        max_batch_size=args.max_num_seqs,
        total_kv_blocks=args.num_kv_blocks,
    )
    return engine, card


def engine_counters(engine) -> dict:
    """The engine's monotonic counters as one JSON-able dict."""
    return {
        "event": "engine_counters",
        "decode_substeps": engine.total_decode_steps,
        "paged_attention_launches": pa.launches,
        "int8_matmul_launches": im.launches,
        "int8_matmul_prefill_launches": im.prefill_launches,
        "num_layers": engine.cfg.num_layers,
        "generated_tokens": engine.total_generated,
        "prefilled_tokens": engine.total_prefilled,
        "preemptions": engine.total_preemptions,
        "eager_windows": engine.runner.eager_windows,
    }


async def async_main(args) -> None:
    from dynamo_tpu_torch.runtime import tracing

    lane = os.environ.get("DYNTPU_PROC_LANE")
    if not lane:
        lane = f"worker-{os.getpid()}"
        tracing.set_default_lane(lane)
    t_launch = time.perf_counter()
    rt = await DistributedRuntime.create(store_url=args.store_url, proc_label=lane)
    engine, card = await build_engine(args)
    # Capture the decode-window graphs before registering, so that no
    # request waits for a capture (none on the CPU).
    t0 = time.perf_counter()
    graphs = await asyncio.to_thread(engine.runner.warm_windows, ("greedy", "simple"))
    warm_s = time.perf_counter() - t0
    # The warm-up replays served no request: the kernels' launch counts
    # start here, beside the engine's decode substeps (all 0 now).
    pa.launches = im.launches = im.prefill_launches = 0
    # Engine hot-loop series on this process's /metrics (system server).
    engine.bind_metrics(rt.metrics)
    broadcaster = KvEventBroadcaster(engine.pool)
    engine.pool.set_event_sink(broadcaster.publish)

    comp = rt.namespace(args.namespace).component(args.component)

    async def gen_handler(payload, ctx):
        async for item in engine.generate(payload, ctx):
            yield item

    await comp.endpoint(args.endpoint).serve(gen_handler)
    await serve_kv_endpoints(comp, broadcaster, engine.metrics)

    async def clear_handler(payload, ctx):
        yield {"cleared": engine.clear_kv_blocks()}

    await comp.endpoint("clear_kv").serve(clear_handler)
    await register_model(rt, args.namespace, card)
    print(
        f"dynamo_tpu_torch worker: serving {card.name} as "
        f"{args.namespace}/{args.component}/{args.endpoint} on {args.device} "
        f"({graphs} window graphs captured in {warm_s:.2f}s; registered "
        f"{time.perf_counter() - t_launch:.2f}s after the runtime started)",
        flush=True,
    )

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    with contextlib.suppress(NotImplementedError):
        loop.add_signal_handler(signal.SIGUSR1, lambda: print(
            json.dumps(engine_counters(engine)), flush=True))
    await stop.wait()
    log.info("worker shutting down")
    # Deregister and drain the endpoints first, so in-flight streams
    # finish on the engine; then stop it.
    await rt.shutdown()
    await engine.stop()
    print(json.dumps(engine_counters(engine)), flush=True)


def main(argv=None) -> int:
    asyncio.run(async_main(parse_args(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
