"""Profile sweep: a running engine → (batch → ITL/tok_s, prompt length →
TTFT) curves for the SLA planner's interpolators, saved as the npz that
``planner/interpolate.py`` (and the JAX package's) ``load_profile`` reads.

Port of ``tools/profile_sweep.py``, with its method: each batch size B is
warmed once, then measured as B concurrent greedy requests of a 64-token
random prompt and ``gen_len`` tokens; tokens/s is their tokens over the
wall time (their serial prefills included, so a short ``gen_len`` would
measure prefill, not decode) and ITL = 1000·B / tokens/s, the inter-token
latency each of the B sequences sees. TTFT is measured per prompt length
on an idle engine, one request alone, after one warm-up request of the
same length. Every timed sample starts once the engine is idle: the
warm-up's last windows, still queued on the card when its stream ends,
would otherwise run ahead of the timed request.

    python -m dynamo_tpu_torch.planner.profile_sweep --preset llama-8b \\
        --out profile.npz
    python -m dynamo_tpu_torch.worker ... --sla-profile profile.npz

``sweep`` runs over any started ``TorchEngine`` (chip_smoke.py sweeps
its main path's engine); the CLI builds its own, on the card unless
``--device cpu`` (bfloat16 on the card, float32 on the CPU, seed 0, as
the JAX tool). The npz's ``meta`` records the model, the device and, on
the card, its name and power limit.
"""

from __future__ import annotations

import argparse
import asyncio
import subprocess
import time

import numpy as np

from dynamo_tpu_torch.planner.interpolate import (
    DecodeInterpolator,
    PrefillInterpolator,
    save_profile,
)

DEFAULT_BATCHES = (8, 16, 32, 64, 128)
DEFAULT_PROMPT_LENS = (64, 128, 256, 512, 1024)
DECODE_PROMPT_LEN = 64


async def sweep(engine, batches, prompt_lens, gen_len: int = 96,
                log=print) -> tuple[DecodeInterpolator, PrefillInterpolator]:
    """Sweep a started engine → (decode, prefill) interpolators."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context

    vocab = engine.cfg.vocab_size
    warm_gen = engine.args.decode_steps + 2
    rng = np.random.default_rng(0)

    def req(plen: int, gen: int) -> PreprocessedRequest:
        r = PreprocessedRequest(
            model=engine.cfg.name,
            token_ids=rng.integers(1, vocab - 1, size=plen).tolist(),
        )
        r.sampling.temperature = 0.0
        r.stop.max_tokens = gen
        r.stop.ignore_eos = True
        return r

    async def run_one(r, rec=None) -> int:
        t0 = time.perf_counter()
        n, t_first, t_last = 0, None, None
        async for item in engine.generate(r, Context()):
            if item.get("error"):
                raise RuntimeError(f"profile sweep request failed: {item['error']}")
            if item.get("token_ids"):
                t_last = time.perf_counter()
                t_first = t_first or t_last
                n += len(item["token_ids"])
        if rec is not None:
            rec.append((t0, t_first, t_last, n))
        return n

    async def idle() -> None:
        while engine.busy():
            await asyncio.sleep(0.001)

    d_itl, d_tok = [], []
    for b in batches:
        await asyncio.gather(*(run_one(req(DECODE_PROMPT_LEN, warm_gen)) for _ in range(b)))
        await idle()
        t0 = time.perf_counter()
        recs: list = []
        await asyncio.gather(*(run_one(req(DECODE_PROMPT_LEN, gen_len), recs) for _ in range(b)))
        el = time.perf_counter() - t0
        tok_s = sum(r[3] for r in recs) / el
        itl_ms = 1000.0 * b / tok_s
        d_itl.append(itl_ms)
        d_tok.append(tok_s)
        log(f"decode B={b}: {tok_s:.1f} tok/s, itl {itl_ms:.2f} ms")

    p_ttft, p_tok = [], []
    for plen in prompt_lens:
        await run_one(req(plen, 2))
        await idle()
        recs = []
        await run_one(req(plen, 2), recs)
        t0, t_first, _, _ = recs[0]
        p_ttft.append((t_first - t0) * 1000)
        p_tok.append(plen / (t_first - t0))
        log(f"prefill len={plen}: ttft {p_ttft[-1]:.2f} ms")

    return (DecodeInterpolator(np.array(batches), np.array(d_itl), np.array(d_tok)),
            PrefillInterpolator(np.array(prompt_lens), np.array(p_ttft), np.array(p_tok)))


def card_meta() -> dict:
    """The card's name and power limit, as the profile's ``meta`` keeps
    them (empty off the card)."""
    import torch

    if not torch.cuda.is_available():
        return {}
    meta = {"card": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        meta["nvidia_smi"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        meta["nvidia_smi"] = "not available"
    return meta


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.planner.profile_sweep")
    p.add_argument("--preset", default="llama-1b")
    p.add_argument("--out", default="profile.npz")
    p.add_argument("--batches", default=",".join(map(str, DEFAULT_BATCHES)))
    p.add_argument("--prompt-lens", default=",".join(map(str, DEFAULT_PROMPT_LENS)))
    p.add_argument("--gen-len", type=int, default=96)
    p.add_argument("--decode-steps", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return p.parse_args(argv)


async def async_main(args) -> None:
    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    model = ModelConfig.preset(args.preset)
    batches = [int(b) for b in args.batches.split(",")]
    prompt_lens = [int(n) for n in args.prompt_lens.split(",")]
    max_b = max(batches)
    block_size = 16
    seq_len = max(prompt_lens) + args.gen_len + args.decode_steps
    blocks_per_seq = (seq_len + block_size - 1) // block_size + 1
    dtype = "float32" if args.device == "cpu" else "bfloat16"
    engine = await TorchEngine(EngineArgs(
        model=model, block_size=block_size,
        num_kv_blocks=max(max_b * blocks_per_seq, 256),
        max_num_seqs=max_b, max_model_len=(blocks_per_seq + 1) * block_size,
        max_prefill_tokens=max(512, max(prompt_lens)),
        dtype=dtype, decode_steps=args.decode_steps, device=args.device,
    ), seed=0).start()
    try:
        runner = engine.runner
        if runner.graphs is not None:
            n = runner.warm_windows(("greedy",), (0,))
            print(f"profile sweep: {n} window graphs captured", flush=True)
        decode, prefill = await sweep(engine, batches, prompt_lens, args.gen_len,
                                      log=lambda m: print(m, flush=True))
    finally:
        await engine.stop()
    save_profile(args.out, decode=decode, prefill=prefill,
                 meta={"model": model.name, "device": args.device, "dtype": dtype,
                       "decode_steps": args.decode_steps, **card_meta()})
    print(f"wrote {args.out}", flush=True)


def main(argv=None) -> int:
    asyncio.run(async_main(parse_args(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
