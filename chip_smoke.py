#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. Card: torch version, device name, nvidia-smi's name and power limit.
2. Build: every kernel under dynamo_tpu_torch/ops/csrc with nvcc
   (sm_90a) into build/kernels/, timed.
3. Kernel parity and timing at the main path's shapes (llama-8b decode
   geometry: B=8, KVH=8, G=4, hd=128, bs=16), every mode of the paged
   attention kernel against its plain PyTorch version on the same CUDA
   tensors, with NaN in every position past each row's walk; then decode
   again at the row lengths the main path's burst reaches
   (`decode_bfloat16_burst`). Each case times the whole wrapper call (the
   split kernel and its merge).
4. Main path at full width: `run --in batch:`'s pipeline (preprocessor →
   Backend → TorchEngine) serving 8 concurrent llama-8b completions with
   random weights made on the card, at the default pipeline depth 2 with
   every K-step window a CUDA-graph replay (the burst's window shapes are
   captured first, `LocalRunner.warm_windows`); the kernel's launch
   counter is zeroed just before the requests and read just after. Then
   the same burst again at pipeline_depth=0 (its own counts zeroed and
   read), whose 8 token and logprob streams must be identical, request 7
   once more on its cached prefix (the reference of phase 7's repeat),
   and one prompt alone again under torch.profiler. Decode ms per substep,
   tokens/s, TTFT per request, the host-blocked share, graph capture and
   pool numbers and the device-busy share are printed beside the card's
   name and power limit.
5. Graph parity: one K=8 window at llama-8b shapes (all 32 layers, the
   engine's weights, its own small cache) as a CUDA-graph replay and op by
   op, in each sampler mode: tokens, logprobs, top-n, the written KV pages
   and the chain buffer bit-identical; two chained windows against the
   same two drained; at the burst's row lengths, each mode's replay device
   time per substep against the op-by-op window, one profiled replay by
   kernel family; and the threefry noise's device time per substep
   (batch 8, the full vocabulary).
6. A small-input reference: test-tiny in float32 through the model with
   the kernel and with the plain attention, tokens equal.
7. The distributed serving path over HTTP: the in-process engine freed,
   the port's store server, two `python -m dynamo_tpu_torch.worker`
   processes (the main path's engine arguments, seed 0, so the same
   weights) and a kv-mode `python -m dynamo_tpu_torch.frontend`. The same
   8 /v1/completions as the main path's burst (even ones as SSE streams,
   odd ones aggregated, over raw asyncio sockets), two chat completions
   (streamed and aggregated, equal), one burst prompt again, then, after
   /clear_kv_blocks, the burst once more, all 8 aggregated. Every
   response must be 200, every stream end in [DONE], every completion
   carry 64 tokens and equal the in-process burst's text for the same
   request; every aggregate response must carry the in-process burst's
   64 token texts and logprobs bit for bit, and both workers must have
   served such a response; the repeated prompt must land
   on the worker that served it first (the router's choice, read from the
   frontend's ledger and traces) and carry the token texts and logprobs
   of the in-process prefix-hit pass bit for bit; each worker's kernel
   launches (counted from after its graph warm-up, printed on its last
   line at SIGTERM) must equal 32 x its decode substeps; every process
   must exit 0 on SIGTERM. The frontend ledger's TTFT of the aggregate
   requests, each pass's tokens/s against the in-process burst, each
   worker's start-up and graph warm-up seconds and msgpack_lite's
   microseconds per frame are printed beside the card's
   name and power limit.

The last lines are the kernels JSON line, nvidia-smi's name/power line,
and {"ok": true, "device": {...}}. Without CUDA, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core bf16
            "float32": 67e12}      # f32 outside the tensor cores
TIMED_RUNS = 30
WARMUP_RUNS = 3
SPIN_CYCLES = 400_000  # ~0.2 ms of GPU spin ahead of each timed call
KERNEL_SOURCE = "dynamo_tpu_torch/ops/csrc/paged_attention.cu"
KERNEL_REPLACES = "dynamo_tpu/ops/paged_attention.py:210"
KERNEL_VERSION = 3
# Row lengths the main path's decode sees: the burst's prompts (64-1536
# byte-tokens) at mid-generation.
BURST_HIST = [96, 192, 352, 544, 800, 1056, 1312, 1568]
# The main path's burst: 8 prompts of these byte lengths, these
# temperatures, seeds 1000-1007, 64 tokens each.
BURST_LENS = [64, 160, 320, 512, 768, 1024, 1280, 1536]
BURST_TEMPS = [0.0, 0.0, 0.0, 0.7, 0.0, 0.0, 0.7, 0.0]
BURST_TOKENS = 64
# Engine arguments of the main path, shared by its in-process pipeline and
# the HTTP phase's workers.
ENGINE_ARGV = ["--block-size", "16", "--num-kv-blocks", "2048", "--max-num-seqs", "8",
               "--max-model-len", "2048", "--decode-steps", "8", "--seed", "0"]
HERE = os.path.dirname(os.path.abspath(__file__))

# The kernel is held against its plain PyTorch version evaluated in float32
# on the same values (bf16 → f32 is exact; int8 pages are first dequantized
# and rounded to q's dtype, the kernel's own rounding point), as
# |kernel - plain| <= atol + rtol * |plain|. float32 q: only the summation
# order differs. bfloat16 q: the kernel also rounds its f32 result to
# bfloat16 once, at most half a bfloat16 step (2^-8 of the value).
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-4, 2.0 ** -8 + 1e-3)}


def log(msg: str) -> None:
    print(msg, flush=True)


def reference_entry(gen, ttft_s: float) -> dict:
    """One in-process request as the HTTP phase's reference: its text, and
    its per-token logprobs and token texts as an aggregate completion
    carries them."""
    choice = gen.final_response()["choices"][0]
    return {"text": choice["text"], "logprobs": list(gen.lp_values),
            "lp_tokens": choice["logprobs"]["tokens"], "ttft_s": ttft_s}


def burst_prompts() -> list[str]:
    import numpy as np

    rng = np.random.default_rng(2024)
    return ["".join(chr(c) for c in rng.integers(32, 127, n)) for n in BURST_LENS]


def _tree_anc(parents, T):
    import numpy as np

    anc = np.zeros((T, T), np.int8)
    anc[0, 0] = 1
    for j, p in enumerate(parents, start=1):
        anc[j] = anc[p]
        anc[j, j] = 1
    return anc


def make_case(mode, qdt_name, quant, seed, device, hist, T=5, KVH=8, G=4, hd=128, bs=16,
              L=2, layer=1, width=None):
    """Inputs for one kernel case → dict with the wrapper's ``args`` (CUDA
    tensors on ``device``) and host metadata. ``hist`` are per-row history
    lengths (0 = dead row); mode decode|linear|tree. Rows own disjoint
    pages; every position past a row's walk and every page no row owns
    holds NaN (NaN scales for int8 pages). ``width`` widens the block table
    to that many pages (the extra entries name unowned, NaN pages)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    B = len(hist)
    hist = np.asarray(hist, np.int64)
    live = hist > 0
    anc = None
    if mode == "decode":
        T = 1
        lengths = hist[:, None].copy()
        walk = hist.copy()
    elif mode == "linear":
        lengths = np.where(live[:, None], hist[:, None] + np.arange(1, T + 1)[None, :], 0)
        walk = lengths.max(axis=1)
    else:
        lengths = np.where(live[:, None], hist[:, None], 0).repeat(T, axis=1)
        anc = np.where(live[:, None, None], _tree_anc([0, 0, 1, 1], T)[None], 0).astype(np.int8)
        walk = np.where(live, hist + T, 0)
    pages = -(-walk // bs)
    W = max(int(pages.max()), width or 0)
    N = int(pages.sum()) + 16
    perm = rng.permutation(np.arange(1, N))
    tables = rng.integers(1, N, size=(B, W)).astype(np.int32)
    owned = np.zeros(N, bool)
    i = 0
    for b in range(B):
        tables[b, : pages[b]] = perm[i : i + pages[b]]
        owned[perm[i : i + pages[b]]] = True
        i += pages[b]
    D = KVH * hd
    qdt = getattr(torch, qdt_name)
    q = torch.from_numpy(rng.standard_normal((B, T, KVH, G, hd)).astype(np.float32)).to(device, qdt)
    if quant:
        kc = rng.integers(-127, 128, (L, N, bs, D)).astype(np.int8)
        vc = rng.integers(-127, 128, (L, N, bs, D)).astype(np.int8)
        ks = (np.abs(rng.standard_normal((L, N, bs, KVH))) * 0.02 + 1e-3).astype(np.float32)
        vs = (np.abs(rng.standard_normal((L, N, bs, KVH))) * 0.02 + 1e-3).astype(np.float32)
        poison = (ks, vs)
    else:
        kc = rng.standard_normal((L, N, bs, D)).astype(np.float32)
        vc = rng.standard_normal((L, N, bs, D)).astype(np.float32)
        ks = vs = None
        poison = (kc, vc)
    for arr in poison:
        arr[:, ~owned] = np.nan
        for b in range(B):
            for j in range(pages[b]):
                lo = walk[b] - j * bs
                if lo < bs:
                    arr[:, tables[b, j], max(lo, 0):] = np.nan
    pdt = torch.int8 if quant else qdt
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    # Attended (query, position) pairs: the work the data needs.
    pos = np.arange(W * bs)
    att = pos[None, None, :] < lengths[:, :, None]
    if anc is not None:
        slot = pos[None, None, :] - lengths[:, :, None]
        ok = (slot >= 0) & (slot < T)
        att |= ok & np.take_along_axis(anc != 0, np.clip(slot, 0, T - 1), axis=2)
    return {
        "args": (q, t(kc).to(pdt), t(vc).to(pdt), layer, t(tables), t(lengths.astype(np.int32)),
                 t(ks) if quant else None, t(vs) if quant else None,
                 t(anc) if anc is not None else None),
        "walk": walk, "pages": pages, "att": att, "B": B, "T": T, "KVH": KVH, "G": G,
        "hd": hd, "bs": bs, "W": W, "q_bytes": 2 if qdt_name == "bfloat16" else 4,
        "page_bytes": 1 if quant else (2 if qdt_name == "bfloat16" else 4),
    }


def plain_f32(args):
    """The plain version evaluated in float32 on the kernel's input values."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    q, kc, vc, layer, tables, lengths, ks, vs, anc = args
    if ks is not None:
        kc, vc = dequant_cache(kc, ks, q.dtype), dequant_cache(vc, vs, q.dtype)
    return pa.paged_spec_attention_ref(q.float(), kc.float(), vc.float(), layer, tables,
                                       lengths, anc=anc)


def dequant_cache(c, s, dtype):
    """int8 pages [L, N, bs, KVH*hd] × scales [L, N, bs, KVH] → dtype pages
    (widen to f32, scale, round once: gather_dequant_pages's rounding)."""
    L, N, bs, D = c.shape
    KVH = s.shape[-1]
    return (c.view(L, N, bs, KVH, D // KVH).float() * s[..., None]).to(dtype).reshape(L, N, bs, D)


def bound(case, qdt_name, quant):
    """Least time (ms) the card could take for one call: each needed input
    byte read once and each output byte written once over HBM bandwidth,
    against the operations the data needs over the peak rate."""
    B, T, KVH, G, hd = case["B"], case["T"], case["KVH"], case["G"], case["hd"]
    rows = int(case["walk"].sum())
    nbytes = rows * KVH * hd * 2 * case["page_bytes"]
    if quant:
        nbytes += rows * KVH * 4 * 2
    nbytes += 2 * B * T * KVH * G * hd * case["q_bytes"]      # q in, out
    nbytes += int(case["pages"].sum()) * 4 + B * T * 4          # table entries, lengths
    if case["args"][8] is not None:
        nbytes += B * T * T
    ops = 4.0 * int(case["att"].sum()) * KVH * G * hd            # QK^T and PV, 2 ops per MAC
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[qdt_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, flush) -> float:
    """Median of TIMED_RUNS CUDA-event timings after WARMUP_RUNS. Before
    each run the L2 cache is flushed (the decode loop's other layers evict
    a layer's pages before it is read again) and the GPU spins briefly, so
    the host's enqueue of a single-launch call hides behind the spin; a
    call made of many small launches still shows its launch gaps."""
    import torch

    for _ in range(WARMUP_RUNS):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def library_call(case):
    """One PyTorch call computing the same function over K/V pre-gathered
    to dense (scaled_dot_product_attention with GQA): a yardstick only."""
    import torch
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.paged_attention import gather_dequant_pages

    q, kc, vc, layer, tables, lengths, ks, vs, _anc = case["args"]
    B, T, KVH, G, hd = q.shape
    k = gather_dequant_pages(kc[layer], None if ks is None else ks[layer], tables, KVH, hd, q.dtype)
    v = gather_dequant_pages(vc[layer], None if vs is None else vs[layer], tables, KVH, hd, q.dtype)
    seen = torch.from_numpy(case["att"].any(axis=1)).to(q.device)[:, :, None, None]
    k = torch.where(seen, k, torch.zeros((), dtype=k.dtype, device=k.device)).permute(0, 2, 1, 3).contiguous()
    v = torch.where(seen, v, torch.zeros((), dtype=v.dtype, device=v.device)).permute(0, 2, 1, 3).contiguous()
    qd = q.permute(0, 2, 3, 1, 4).reshape(B, KVH * G, T, hd).contiguous()
    mask = torch.from_numpy(case["att"]).to(q.device)[:, None]       # [B, 1, T, C]
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask, enable_gqa=True)


def kernel_phase(device):
    import torch

    from dynamo_tpu_torch.ops import paged_attention as pa

    hist = [0, 1, 15, 16, 17, 300, 1024, 2047]
    cases = [
        ("decode", "bfloat16", False, hist), ("decode", "float32", False, hist),
        ("decode", "bfloat16", True, hist), ("linear", "bfloat16", False, hist),
        ("tree", "bfloat16", False, hist), ("tree", "bfloat16", True, hist),
        ("decode", "bfloat16", False, BURST_HIST),
    ]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    results = []
    for i, (mode, qdt_name, quant, rows) in enumerate(cases):
        name = f"{mode}_{'int8' if quant else qdt_name}" + ("_burst" if rows is BURST_HIST else "")
        case = make_case(mode, qdt_name, quant, 100 + i, device, rows)
        args = case["args"]
        out = pa.paged_spec_attention(*args)
        ref = plain_f32(args)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            raise RuntimeError(f"{name}: non-finite output (kernel or plain)")
        if rows[0] == 0 and float(out[0].abs().max()) != 0.0:
            raise RuntimeError(f"{name}: the length-0 row must output zeros")
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        atol, rtol = TOL[qdt_name]
        excess = float((diff - rtol * ref.abs()).max())
        ok = excess <= atol
        ms = time_ms(lambda: pa.paged_spec_attention(*args), flush)
        plain_ms = time_ms(lambda: pa.paged_spec_attention_ref(*args), flush)
        lib_ms = time_ms(library_call(case), flush)
        b_ms, b_by = bound(case, qdt_name, quant)
        splits = pa.split_plan(case["B"], case["KVH"], case["T"] * case["G"], case["hd"],
                               case["W"], case["bs"]).splits
        r = {"case": name, "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok,
             "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "bound_ms": b_ms, "bound_by": b_by, "T": case["T"], "splits": splits}
        log(f"kernel {name}: max_abs_err={err:.3e} (tol {atol:g} + {rtol:g}*|plain|, "
            f"{'ok' if ok else 'FAIL'}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) splits={splits}")
        if not ok:
            raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                               f"(max |err| - rtol*|plain| = {excess:.3e} > {atol})")
        results.append(r)
    return results


DECODE_PHASES = ("decode_dispatch", "drain_sync", "drain_ready", "emit")


async def main_path(card_line: str, preset: str = "llama-8b", device: str = "cuda"):
    import numpy as np
    import torch

    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.run.__main__ import build_pipeline, parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    args = parse_args(["--in", "batch:-", "--preset", preset, "--dtype", "bfloat16",
                       "--device", device, *ENGINE_ARGV])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    pipe = await build_pipeline(args)
    engine = pipe.engine
    runner = engine.runner
    torch.cuda.synchronize()
    log(f"main: {preset} pipeline up in {time.perf_counter() - t0:.1f}s "
        f"(random bf16 weights made on the card), pipeline_depth "
        f"{engine.args.effective_pipeline_depth}")
    cfg = engine.cfg
    g = runner.graphs
    n = runner.warm_windows(("greedy", "simple"), (0,))
    log(f"main: {n} window graphs captured ahead of traffic in {g.capture_s:.2f}s "
        f"(shapes B, W, L, K, mode, top_n: {g.shapes}), graph pool "
        f"{g.pool_bytes() / 2**20:.1f} MiB ({card_line})")
    lens, temps, max_tokens = BURST_LENS, BURST_TEMPS, BURST_TOKENS
    prompts = burst_prompts()

    async def one(i, prompt, temp, seed):
        req = CompletionRequest.parse({
            "model": pipe.card.name, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": temp, "seed": seed, "ignore_eos": True, "logprobs": 0,
        })
        t_start = time.perf_counter()
        t_first = None
        gen = None
        async for g, _chunk in pipe.run(req, Context()):
            if t_first is None:
                t_first = time.perf_counter() - t_start
            gen = g
        return {"i": i, "ttft_s": t_first, "resp": gen.final_response(),
                "tokens": list(gen.lp_tokens), "logprobs": list(gen.lp_values),
                "ref": reference_entry(gen, t_first)}

    async def burst(label):
        """The 8 requests at once; every count zeroed just before, read just
        after, once the engine has drained its queue."""
        steps0, phases0 = _counters(engine)
        replays0, eager0 = runner.graphs.replays, runner.eager_windows
        pa.launches = 0
        t0 = time.perf_counter()
        outs = await asyncio.gather(*(one(i, p, t, 1000 + i)
                                      for i, (p, t) in enumerate(zip(prompts, temps))))
        wall = time.perf_counter() - t0
        while engine.busy():
            await asyncio.sleep(0.001)
        launches = pa.launches
        steps1, phases1 = _counters(engine)
        substeps = steps1 - steps0
        phase = {k: v - phases0.get(k, 0.0) for k, v in phases1.items()}
        for o in outs:
            usage, choice = o["resp"]["usage"], o["resp"]["choices"][0]
            if usage["completion_tokens"] != max_tokens or choice["finish_reason"] != "length":
                raise RuntimeError(f"{label} request {o['i']}: {usage['completion_tokens']} "
                                   f"tokens, finish {choice['finish_reason']!r}")
            if len(o["tokens"]) != max_tokens or not all(
                    np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]):
                raise RuntimeError(f"{label} request {o['i']}: bad token/logprob stream")
            if not all(0 <= t < cfg.vocab_size for t in o["tokens"]):
                raise RuntimeError(f"{label} request {o['i']}: token id out of range")
        if launches != cfg.num_layers * substeps or substeps == 0:
            raise RuntimeError(f"{label}: kernel launches {launches} != layers "
                               f"{cfg.num_layers} x substeps {substeps}")
        eager = runner.eager_windows - eager0
        if eager:
            raise RuntimeError(f"{label}: {eager} K-step windows ran eagerly on the card")
        decode_s = sum(phase.get(k, 0.0) for k in DECODE_PHASES)
        total_tokens = sum(o["resp"]["usage"]["completion_tokens"] for o in outs)
        st = {"launches": launches, "substeps": substeps, "wall_s": wall,
              "tokens_per_s": total_tokens / wall, "substep_ms": decode_s / substeps * 1e3,
              "decode_s": decode_s, "host_blocked": phase.get("drain_sync", 0.0) / decode_s,
              "prefill_dispatch_s": phase.get("prefill", 0.0),
              "replays": runner.graphs.replays - replays0,
              "ttft_s": [o["ttft_s"] for o in outs]}
        log(f"main[{label}]: 8 requests, {total_tokens} completion tokens in {wall:.3f}s → "
            f"{st['tokens_per_s']:.1f} tokens/s ({card_line})")
        for o in outs:
            log(f"main[{label}]: request {o['i']} prompt {lens[o['i']]} tokens, temperature "
                f"{temps[o['i']]}: TTFT {o['ttft_s'] * 1e3:.1f} ms ({card_line})")
        log(f"main[{label}]: decode {substeps} substeps, {st['substep_ms']:.3f} ms per substep "
            f"(host time in decode phases {decode_s:.3f}s / substeps; batch of 8), host blocked "
            f"on fetches {100 * st['host_blocked']:.1f}% of it, {st['replays']} graph replays "
            f"({card_line})")
        log(f"main[{label}]: phases " + json.dumps({k: round(v, 4) for k, v in phase.items()}))
        log(f"main[{label}]: paged_attention launches {launches} = {cfg.num_layers} layers x "
            f"{substeps} substeps")
        return outs, st

    first, st2 = await burst("depth2")
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    weight_bound_ms = param_bytes / HBM_BYTES_PER_S * 1e3
    log(f"main: weight-stream bound {weight_bound_ms:.3f} ms per substep "
        f"({param_bytes / 1e9:.2f} GB / 3.35 TB/s) ({card_line})")
    log(f"main: {g.captured} window graphs in all, captured in {g.capture_s:.2f}s, graph pool "
        f"{g.pool_bytes() / 2**20:.1f} MiB, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card_line})")

    # The same burst unpipelined, from an empty prefix cache (so every
    # prefill takes the same path): the streams must not change.
    engine.clear_kv_blocks()
    engine.args.pipeline_depth = 0
    second, st0 = await burst("depth0")
    engine.args.pipeline_depth = 2
    for a, b in zip(first, second):
        if a["tokens"] != b["tokens"] or a["logprobs"] != b["logprobs"]:
            raise RuntimeError(f"request {a['i']}: depth 2 and depth 0 streams differ")
    log("main: all 8 token and logprob streams identical at pipeline_depth 2 and 0")
    # Request 7 again, on the prefix its depth-0 pass cached: the reference
    # of the HTTP phase's repeat, which takes the same prefix-hit path.
    repeat = await one(7, prompts[7], temps[7], 1007)
    drift = max(abs(a - b) for a, b in zip(repeat["logprobs"], first[7]["logprobs"]))
    log(f"main: request 7 again on its cached prefix: tokens "
        f"{'equal to' if repeat['tokens'] == first[7]['tokens'] else 'not equal to'} its cold "
        f"pass, max |logprob - cold pass| {drift:.3g}, TTFT {repeat['ttft_s'] * 1e3:.1f} ms "
        f"({card_line})")

    # One greedy prompt alone again, under torch.profiler, whose CUDA kernel
    # records split the pass's wall time into device-busy time and the rest.
    from torch.profiler import ProfilerActivity, profile

    engine.clear_kv_blocks()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = await one(0, prompts[0], temps[0], 1000)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    if again["tokens"] != first[0]["tokens"]:
        raise RuntimeError("second greedy pass of request 0 differs from its first pass")
    log("main: second greedy pass of request 0 alone is token-identical to its first pass")
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if "CUDA" in str(e.device_type) and e.self_device_time_total > 0),
        key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    busy_share = None
    if busy_ms == 0:
        log("profile: the profiler recorded no device time (device busy share not measured)")
    else:
        busy_share = busy_ms / (wall2 * 1e3)
        attn_ms = sum(k[1] for k in kernels if "paged_attention" in k[0])
        log(f"profile: second pass (1 request, 64 tokens, profiler on): wall {wall2 * 1e3:.1f} ms, "
            f"device busy {busy_ms:.1f} ms ({100 * busy_share:.1f}%), "
            f"paged_attention {attn_ms:.1f} ms ({card_line})")
        for name, ms, n in kernels[:6]:
            log(f"profile:   {ms:9.3f} ms  {n:6d}x  {name[:90]}")
    stats = {"launches": st2["launches"], "substeps": st2["substeps"],
             "tokens_per_s": st2["tokens_per_s"], "substep_ms": st2["substep_ms"],
             "host_blocked": st2["host_blocked"], "ttft_s": st2["ttft_s"],
             "depth0": {k: st0[k] for k in ("substeps", "tokens_per_s", "substep_ms",
                                             "host_blocked", "ttft_s")},
             "weight_bound_ms": weight_bound_ms, "graphs": g.captured,
             "capture_s": g.capture_s, "graph_pool_bytes": g.pool_bytes(),
             "replays": st2["replays"], "device_busy_share": busy_share,
             "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    stats.update(window_phase(engine, card_line))
    await engine.stop()
    del pipe, engine, runner
    torch.cuda.empty_cache()
    reference = {"burst": [o["ref"] for o in first], "repeat": repeat["ref"]}
    return stats, reference


def window_inputs(runner, mode, seed, K=8, lens=None):
    """Prefill six rows of random prompts (of lengths ``lens``, else random
    5..39) on ``runner`` (disjoint blocks, room for two K-step windows),
    sample their first tokens in
    ``mode`` with the fold into ``last_toks``, and return the operands of
    the next K-step window over them, chained from the folds and padded to
    the batch bucket. The rows mix greedy and sampled temperatures; in
    "full" mode they also carry top-k, top-p and both penalties."""
    import numpy as np

    live = 6
    args, V = runner.args, runner.cfg.vocab_size
    bs, B, sink = args.block_size, args.bucket_decode(live), args.max_num_seqs
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 40, live) if lens is None else np.asarray(lens)
    tables, logits, nxt = [], [], 1
    for n in lens:
        nblk = -(-(int(n) + 2 * K + 1) // bs)
        tables.append(list(range(nxt, nxt + nblk)))
        nxt += nblk
        toks = np.zeros((-(-int(n) // bs) * bs,), np.int32)
        toks[:n] = rng.integers(1, V, n)
        logits.append(runner.prefill_chunk(toks, np.asarray(tables[-1], np.int32), 0, int(n)))
    W = args.bucket_table(max(len(t) for t in tables))
    tab = np.zeros((B, W), np.int32)
    for i, t in enumerate(tables):
        tab[i, : len(t)] = t
    f = lambda v, dt=np.float32: np.asarray(v + [0] * (B - live), dt)  # noqa: E731
    temps = f([0.0, 0.8, 0.0, 1.1, 0.6, 0.9])
    if mode == "greedy":
        temps[:] = 0.0
    full = mode == "full"
    tks = f([0, 5, 40, 0, 3, 0] if full else [0] * live, np.int32)
    tps = f([1.0, 0.9, 1.0, 0.8, 1.0, 0.95] if full else [1.0] * live)
    freqs = f([0.0, 0.5, 0.25, 0.0, 1.0, 0.5] if full else [0.0] * live)
    press = f([0.0, 0.25, 0.0, 0.5, 0.0, 1.0] if full else [0.0] * live)
    seeds = f(list(range(100 + seed, 100 + seed + live)), np.int32)
    slots = np.full((B,), sink, np.int32)
    slots[:live] = np.arange(live)
    pen = np.full((B, args.max_model_len if full else 1), -1, np.int32)
    ref = runner.sample_rows(logits + [logits[0]] * (B - live), mode, temps, tks, tps, pen,
                             freqs, press, seeds, np.zeros((B,), np.int32), slots, 0)
    first = ref.arrs[0].cpu().numpy()
    if full:
        pen[:live, 0] = first[:live]
    active = np.zeros((B,), bool)
    active[:live] = True
    return dict(
        K=K, mode=mode, tokens=np.zeros((B,), np.int32),
        chain=(list(range(live)), list(range(live))),
        positions=f([int(n) for n in lens], np.int32), tables=tab, active=active,
        temps=temps, seeds=seeds, steps0=f([1] * live, np.int32), tks=tks, tps=tps,
        freqs=freqs, press=press, pen=pen, fold_slots=slots,
        top_n=runner.args.top_logprobs_max,
    )


def _device_state(runner):
    return [t.clone() for t in runner.cache if t is not None] + [runner.last_toks.clone()]


def _restore(runner, state):
    for dst, src in zip([t for t in runner.cache if t is not None] + [runner.last_toks], state):
        dst.copy_(src)


def graph_vs_eager(runner, kw):
    """Run the window ``kw`` as a CUDA-graph replay and op by op from the
    same device state; raise unless outputs, KV pages (block 0, the garbage
    sink, aside) and the chain buffer (sink slot aside) are bit-identical.
    → the window's token ids."""
    import torch

    before = _device_state(runner)
    runs = []
    for eager in (False, True):
        _restore(runner, before)
        outs = [a.clone() for a in runner.multi_decode(**kw, eager=eager).arrs]
        runs.append((outs, _device_state(runner)))
    torch.cuda.synchronize()
    (g_out, g_state), (e_out, e_state) = runs
    names = ("tokens", "logprobs", "top_vals", "top_ids")
    for name, a, b in zip(names, g_out, e_out):
        if not torch.equal(a, b):
            raise RuntimeError(f"{kw['mode']}: graph and eager windows differ in {name}")
    for i, (a, b) in enumerate(zip(g_state, e_state)):
        a, b = (a[:-1], b[:-1]) if i == len(g_state) - 1 else (a[:, 1:], b[:, 1:])
        if not torch.equal(a, b):
            raise RuntimeError(f"{kw['mode']}: graph and eager windows differ in device state {i}")
    return g_out[0]


def chained_vs_drained(runner, kw):
    """Two windows back to back: the second dispatched before the first is
    fetched, chaining from the fold (depth 2), against the first fetched
    and the second fed its tokens from the host (depth 0). Raise unless
    both windows' outputs are bit-identical."""
    import numpy as np
    import torch

    K = kw["K"]
    live = len(kw["chain"][0])
    kw2 = dict(kw, positions=kw["positions"] + K, steps0=kw["steps0"] + K * kw["active"])
    before = _device_state(runner)
    r1 = runner.multi_decode(**kw)
    o1 = [a.clone() for a in r1.arrs]
    o2 = [a.clone() for a in runner.multi_decode(**kw2).arrs]
    _restore(runner, before)
    d1 = [a.clone() for a in runner.multi_decode(**kw).arrs]
    toks = np.zeros_like(kw["tokens"])
    toks[:live] = d1[0][-1].cpu().numpy()[:live]
    d2 = [a.clone() for a in runner.multi_decode(**dict(kw2, tokens=toks, chain=None)).arrs]
    torch.cuda.synchronize()
    for a, b in zip(o1 + o2, d1 + d2):
        if not torch.equal(a, b):
            raise RuntimeError(f"{kw['mode']}: chained windows differ from drained ones")


def profile_replay(runner, kw, card_line: str) -> dict:
    """torch.profiler over one graph replay of the window ``kw``: its
    kernels by family, device time per substep."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    runner.multi_decode(**kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.multi_decode(**kw)
        torch.cuda.synchronize()
    K = kw["K"]
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    families = {"gemm (nvjet/cutlass/gemv)": ("nvjet", "gemm", "gemv", "cutlass", "splitK"),
                "paged_attention": ("paged_attention",), "copy": ("copy",),
                "reduce": ("reduce",), "index/scatter/gather": ("index", "scatter", "gather"),
                "sort/topk": ("sort", "topk", "Sort", "radix")}
    fam = {k: [0.0, 0] for k in [*families, "other elementwise"]}
    for key, ms, n in rows:
        name = next((f for f, pats in families.items() if any(p in key for p in pats)),
                    "other elementwise")
        fam[name][0] += ms / K
        fam[name][1] += n / K
    total = sum(v[0] for v in fam.values())
    kernels = sum(v[1] for v in fam.values())
    log(f"graphs: profiled replay ({kw['mode']}, burst lengths): {total:.3f} ms device time "
        f"and {kernels:.0f} kernels per substep ({card_line})")
    for name, (ms, n) in sorted(fam.items(), key=lambda kv: -kv[1][0]):
        log(f"graphs:   {ms:7.3f} ms {n:6.0f} kernels per substep  {name}")
    return {"ms_per_substep": total, "kernels_per_substep": kernels,
            "families": {k: {"ms": v[0], "kernels": v[1]} for k, v in fam.items()}}


def window_phase(engine, card_line: str):
    """Graph vs eager at llama-8b shapes in every sampler mode, chained vs
    drained windows, and the threefry noise's device time per substep."""
    import torch

    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.runner import LocalRunner
    from dynamo_tpu_torch.engine.sampler import row_gumbel

    import numpy as np

    args = EngineArgs(model=engine.cfg, block_size=16, num_kv_blocks=256, max_num_seqs=8,
                      max_model_len=2048, decode_steps=8, dtype="bfloat16", device="cuda")
    runner = LocalRunner(args, params=engine.runner.params)
    runner.start()
    out = {}
    for i, mode in enumerate(("greedy", "simple", "full")):
        kw = window_inputs(runner, mode, 40 + i)
        toks = graph_vs_eager(runner, kw)
        log(f"graphs: {engine.cfg.name} K=8 {mode} window, graph replay bit-identical to eager "
            f"(tokens, logprobs, top-{kw['top_n']}, KV pages, chain buffer); row 1 tokens "
            f"{toks[:, 1].tolist()}")
        # One window at the burst's row lengths (W = 128): the replay's
        # device time, against the same window run op by op (host clock).
        kw = dict(window_inputs(runner, mode, 60 + i, lens=BURST_HIST[:6]), top_n=0)
        runner.multi_decode(**kw)
        times = []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            runner.multi_decode(**kw)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times) / kw["K"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.multi_decode(**kw, eager=True)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / kw["K"]
        out[f"replay_ms_per_substep_{mode}"] = ms
        out[f"eager_ms_per_substep_{mode}"] = eager_ms
        log(f"graphs: {mode} window at the burst's lengths (W={np.shape(kw['tables'])[1]}): "
            f"{ms:.3f} ms device time per substep as one graph replay, {eager_ms:.3f} ms per "
            f"substep op by op (host clock) ({card_line})")
        if mode == "simple":
            out["replay_profile"] = profile_replay(runner, kw, card_line)
    chained_vs_drained(runner, window_inputs(runner, "simple", 50))
    log("graphs: two chained windows (depth 2) bit-identical to drained ones (depth 0)")

    B, V = 8, engine.cfg.vocab_size
    seeds = torch.arange(1000, 1000 + B, device="cuda")
    steps = torch.full((B,), 7, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            row_gumbel(seeds, steps, V)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        noise = row_gumbel(seeds, steps, V)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.isfinite(noise).all():
        raise RuntimeError("threefry noise is not finite")
    times = []
    for _ in range(TIMED_RUNS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    log(f"graphs: threefry Gumbel noise for {B} rows x {V} tokens (one sampled substep): "
        f"{ms:.4f} ms device time as one graph replay ({card_line})")
    runner.stop()
    out["threefry_ms"] = ms
    return out


def _counters(engine):
    """(decode substeps dispatched, host seconds per phase) so far; read
    while the engine is idle between request waves."""
    return engine.total_decode_steps, dict(engine.phase_s)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def small_reference(device):
    """test-tiny in float32: prefill + a greedy 8-step window with the
    kernel and with the plain attention, from identical caches."""
    import torch

    from dynamo_tpu_torch.engine import model as M
    from dynamo_tpu_torch.engine.config import ModelConfig

    cfg = ModelConfig.preset("test-tiny")
    params = M.init_params(cfg, device, torch.float32, seed=7)
    toks = torch.zeros(48, dtype=torch.int32, device=device)
    toks[:40] = torch.arange(1, 41, dtype=torch.int32, device=device)
    table = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32, device=device)
    one = lambda *v, dt=torch.int32: torch.tensor(v, dtype=dt, device=device)  # noqa: E731
    outs = {}
    for impl in ("cuda", "torch"):
        cache = M.init_kv_cache(cfg, 64, 16, torch.float32, device)
        logits = M.prefill(cfg, params, cache, toks, table, 0, 40)
        first = torch.argmax(logits).to(torch.int32).reshape(1)
        tk, lp, _, _ = M.multi_decode(
            cfg, 8, "greedy", 0, params, cache, first, one(40), table[None],
            one(True, dt=torch.bool), one(0.0, dt=torch.float32), [0], [0], attn_impl=impl)
        outs[impl] = (tk.cpu(), lp.cpu())
    if not torch.equal(outs["cuda"][0], outs["torch"][0]):
        raise RuntimeError("test-tiny greedy tokens differ between the kernel and the plain path")
    err = float((outs["cuda"][1] - outs["torch"][1]).abs().max())
    if err > 1e-4:
        raise RuntimeError(f"test-tiny logprobs differ by {err}")
    log(f"reference: test-tiny float32, 8 greedy tokens equal with the kernel and the plain "
        f"path, logprob max diff {err:.2e}")


# -- phase 7: the distributed serving path over HTTP ---------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Proc:
    """A child process of the HTTP phase: stdout and stderr go to a log
    file under build/http_phase/ and, line by line, to ``lines``."""

    def __init__(self, name: str, argv: list[str], env: dict | None = None):
        self.name = name
        os.makedirs(os.path.join(HERE, "build", "http_phase"), exist_ok=True)
        self.log = open(os.path.join(HERE, "build", "http_phase", f"{name}.log"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": HERE, "PYTHONUNBUFFERED": "1", **(env or {})})
        self.lines: list[str] = []
        self._cv = threading.Condition()
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.log.write(line)
            self.log.flush()
            with self._cv:
                self.lines.append(line.rstrip("\n"))
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    def wait_for(self, pattern: str, timeout: float) -> tuple[re.Match, float]:
        """→ (the first line matching ``pattern``, seconds since launch)."""
        rx = re.compile(pattern)
        deadline = time.monotonic() + timeout
        seen = 0
        with self._cv:
            while True:
                for line in self.lines[seen:]:
                    m = rx.search(line)
                    if m:
                        return m, time.perf_counter() - self.t0
                seen = len(self.lines)
                if self.proc.poll() is not None and not self._reader.is_alive():
                    raise RuntimeError(f"{self.name} exited rc={self.proc.returncode}: "
                                       + " | ".join(self.lines[-15:]))
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"{self.name}: no line matching {pattern!r} in {timeout}s: "
                                       + " | ".join(self.lines[-15:]))
                self._cv.wait(min(left, 0.5))

    def stop(self, timeout: float = 60.0) -> int:
        """SIGTERM, wait → the exit code."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout)
        finally:
            self._reader.join(5)
            self.log.close()
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)
        if not self.log.closed:
            self._reader.join(5)
            self.log.close()


async def http_request(port: int, path: str, body=None, headers=None, method: str = "POST"):
    """One HTTP/1.1 request over a raw asyncio socket → (status, headers,
    [(arrival perf_counter, body piece)], send perf_counter). Chunked
    bodies come back one piece per chunk."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else json.dumps(body).encode()
    head = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1", "Connection: close",
            "Content-Type: application/json", f"Content-Length: {len(data)}"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    t0 = time.perf_counter()
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
    await writer.drain()
    try:
        status = int((await reader.readline()).split()[1])
        hdrs = {}
        while (line := await reader.readline()) not in (b"\r\n", b""):
            k, _, v = line.decode("latin-1").partition(":")
            hdrs[k.strip().lower()] = v.strip()
        pieces = []
        if hdrs.get("transfer-encoding") == "chunked":
            while (size := int((await reader.readline()).split(b";")[0], 16)) > 0:
                pieces.append((time.perf_counter(), await reader.readexactly(size)))
                await reader.readexactly(2)
            await reader.readline()
        else:
            n = int(hdrs.get("content-length", "0"))
            pieces.append((time.perf_counter(), await reader.readexactly(n)))
    finally:
        writer.close()
    return status, hdrs, pieces, t0


def sse_payloads(pieces) -> list[tuple[float, str]]:
    """Chunked SSE pieces → [(arrival time, data payload)]."""
    out, buf = [], b""
    for t, piece in pieces:
        buf += piece
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            for line in event.split(b"\n"):
                if line.startswith(b"data: "):
                    out.append((t, line[6:].decode()))
    return out


async def http_completion(port: int, body: dict, trace_id: str) -> dict:
    """POST one completion (SSE or aggregate) with a W3C traceparent →
    its text, usage, finish reason, TTFT (streams) and latency."""
    kind = "chat" if "messages" in body else "completion"
    path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
    status, _hdrs, pieces, t0 = await http_request(
        port, path, body, {"traceparent": f"00-{trace_id}-{'1' * 16}-01"})
    out = {"status": status, "latency_s": pieces[-1][0] - t0 if pieces else None,
           "trace_id": trace_id, "stream": bool(body.get("stream"))}
    if status != 200:
        out["error"] = b"".join(p for _, p in pieces)[:300].decode("utf-8", "replace")
        return out
    if not body.get("stream"):
        resp = json.loads(b"".join(p for _, p in pieces))
        choice = resp["choices"][0]
        lp = choice.get("logprobs") or {}
        out.update(text=choice["message"]["content"] if kind == "chat" else choice["text"],
                   finish=choice["finish_reason"], usage=resp["usage"], done=True,
                   logprobs=lp.get("token_logprobs"), lp_tokens=lp.get("tokens"))
        return out
    events = sse_payloads(pieces)
    out["done"] = bool(events) and events[-1][1] == "[DONE]"
    texts, usage, finish = [], None, None
    # A completion chunk goes out only with text; a chat stream's first
    # event (the role) goes out with its first token.
    first_event = events[0][0] - t0 if events and events[0][1] != "[DONE]" else None
    for _t, data in events:
        if data == "[DONE]":
            continue
        ev = json.loads(data)
        if "error" in ev:
            out["error"] = ev["error"]
            continue
        ch = ev["choices"][0]
        piece = (ch.get("delta") or {}).get("content") if kind == "chat" else ch.get("text")
        if piece:
            texts.append(piece)
        usage = ev.get("usage") or usage
        finish = ch.get("finish_reason") or finish
    out.update(text="".join(texts), usage=usage, finish=finish, first_event_s=first_event)
    return out


async def routed(port: int, trace_id: str) -> tuple[str, float | None]:
    """The frontend's record of one request: its ledger entry (looked up by
    trace id) → the TTFT the frontend saw, and the trace's router.attempt
    span → the instance the router chose. → (instance, ledger ttft_s)."""
    status, _, pieces, _ = await http_request(
        port, f"/debug/requests?trace_id={trace_id}", method="GET")
    records = json.loads(b"".join(p for _, p in pieces))["requests"]
    if status != 200 or not records or records[0]["status"] != "200":
        raise RuntimeError(f"http: no 200 ledger record for trace {trace_id}: {records}")
    _, _, pieces, _ = await http_request(port, f"/debug/traces/{trace_id}", method="GET")
    spans = json.loads(b"".join(p for _, p in pieces))["spans"]
    served = [s["attrs"]["instance"] for s in spans
              if s["name"] == "router.attempt" and s.get("status", "ok") == "ok"]
    if not served:
        raise RuntimeError(f"http: trace {trace_id} has no router.attempt span")
    return served[-1], records[0].get("ttft_s")


def msgpack_frame_us(reps: int = 2000) -> dict:
    """Microseconds to pack + unpack one frame with the port's pure-Python
    msgpack, for the two frames the serving path sends most: a decode
    window's delta (8 tokens with logprobs) and the longest burst request."""
    from dynamo_tpu_torch.runtime import msgpack_lite

    delta = {"t": "data", "id": "0" * 32, "payload": {
        "token_ids": [91234, 17, 40012, 3, 128000, 77, 1045, 9981],
        "log_probs": [-0.125, -2.5, -0.03125, -7.75, -1.0, -0.5, -3.25, -0.0625],
        "finish_reason": None}}
    request = {"t": "request", "id": "0" * 32, "subject": "dynamo/backend/generate",
               "headers": {"timeout_s": 60.0, "traceparent": "00-" + "1" * 32 + "-" + "2" * 16 + "-01"},
               "payload": {"model": "llama-8b", "token_ids": list(range(1536)),
                           "sampling": {"temperature": 0.7, "seed": 1007, "logprobs": False},
                           "stop": {"max_tokens": 64, "ignore_eos": True},
                           "eos_token_ids": [257]}}
    out = {}
    for name, frame in (("delta_8_tokens", delta), ("request_1536_tokens", request)):
        raw = msgpack_lite.packb(frame)
        if msgpack_lite.unpackb(raw) != frame:
            raise RuntimeError(f"msgpack_lite: {name} does not round-trip")
        t0 = time.perf_counter()
        for _ in range(reps):
            msgpack_lite.unpackb(msgpack_lite.packb(frame))
        out[name] = {"bytes": len(raw), "us": (time.perf_counter() - t0) / reps * 1e6}
    return out


def _metric(text: str, name: str) -> float | None:
    m = re.search(rf"^{re.escape(name)}(?:{{[^}}]*}})? ([0-9.eE+-]+)$", text, re.M)
    return float(m.group(1)) if m else None


def http_phase(card_line: str, reference: dict, inproc_tps: float,
               preset: str = "llama-8b", device: str = "cuda", dtype: str = "bfloat16") -> dict:
    """Phase 7: store + two workers + kv frontend as separate processes,
    the main path's burst over HTTP. ``reference``: the in-process burst's
    requests (``reference_entry``) under "burst", and request 7 served
    again on its cached prefix under "repeat"."""
    procs: list[Proc] = []
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    try:
        store = Proc("store", ["dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                               "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        workers = []
        for i in range(2):
            sys_port = _free_port()
            w = Proc(f"worker{i}", [
                "dynamo_tpu_torch.worker", "--store-url", store_url, "--preset", preset,
                "--dtype", dtype, "--device", device, *ENGINE_ARGV],
                env={"DYNTPU_SYSTEM_ENABLED": "1", "DYNTPU_SYSTEM_PORT": str(sys_port)})
            w.sys_port = sys_port
            procs.append(w)
            workers.append(w)
        startup = []
        for w in workers:
            m, secs = w.wait_for(r"serving .* \((\d+) window graphs captured in ([0-9.]+)s", 600)
            startup.append({"launch_to_registered_s": secs, "graphs": int(m.group(1)),
                            "graph_warmup_s": float(m.group(2))})
            log(f"http: {w.name} registered {secs:.2f}s after launch, {m.group(1)} window graphs "
                f"captured in {m.group(2)}s ({card_line})")
        fe = Proc("frontend", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                               "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"])
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))
        result = asyncio.run(_drive_http(port, preset, reference, inproc_tps, card_line))

        for w in workers:
            _, _, pieces, _ = asyncio.run(http_request(w.sys_port, "/metrics", method="GET"))
            text = b"".join(p for _, p in pieces).decode()
            w.metrics = {k: _metric(text, f"dynamo_tpu_{k}") for k in (
                "engine_kv_cache_bytes", "engine_prefill_pad_ratio", "engine_inflight_windows",
                "engine_kv_quant_enabled")}
            if w.metrics["engine_kv_cache_bytes"] is None:
                raise RuntimeError(f"http: {w.name}'s /metrics has no engine series")
        rcs = {p.name: p.stop() for p in [fe, *workers, store]}
        if any(rcs.values()):
            raise RuntimeError(f"http: processes did not exit 0 on SIGTERM: {rcs}")
        per_worker, total = [], 0
        for w, st in zip(workers, startup):
            counters = next(json.loads(line) for line in reversed(w.lines)
                            if line.startswith('{"event": "engine_counters"'))
            launches, substeps = counters["paged_attention_launches"], counters["decode_substeps"]
            # On the CPU (a rehearsal) the plain attention runs: no launch.
            want = counters["num_layers"] * substeps if device == "cuda" else 0
            if launches != want:
                raise RuntimeError(f"http: {w.name} kernel launches {launches} != layers "
                                   f"{counters['num_layers']} x substeps {substeps}")
            total += launches
            per_worker.append({**st, **counters, "metrics": w.metrics})
            log(f"http: {w.name} paged_attention launches {launches} (= {want}: "
                f"{counters['num_layers']} layers x {substeps} substeps on the card, 0 on the CPU), "
                f"{counters['generated_tokens']} tokens generated, "
                f"eager windows {counters['eager_windows']}, /metrics {w.metrics}")
        if total <= 0 and device == "cuda":
            raise RuntimeError("http: no worker launched the kernel")
        log(f"http: every process exited 0 on SIGTERM ({rcs})")
        result.update(workers=per_worker, launches=total, exit_codes=rcs)
        return result
    finally:
        for p in procs:
            p.kill()


async def clear_kv(port: int, model: str) -> dict[str, int]:
    """POST /clear_kv_blocks until a call drops nothing on any worker (a
    row still draining its last windows frees its blocks a moment after
    its response) → blocks dropped per instance."""
    await asyncio.sleep(1.0)
    total: dict[str, int] = {}
    for _ in range(50):
        status, _, pieces, _ = await http_request(port, "/clear_kv_blocks", {})
        cleared = json.loads(b"".join(p for _, p in pieces))["cleared"].get(model) or {}
        if status != 200 or len(cleared) != 2 or any(n < 0 for n in cleared.values()):
            raise RuntimeError(f"http: /clear_kv_blocks answered {status}: {cleared}")
        for inst, n in cleared.items():
            total[inst] = total.get(inst, 0) + n
        if total and not any(cleared.values()):
            return total
        await asyncio.sleep(0.2)
    raise RuntimeError(f"http: the workers' caches never came up empty: {total}")


async def _drive_http(port: int, model: str, reference: dict, inproc_tps: float,
                      card_line: str) -> dict:
    for _ in range(600):
        _, _, pieces, _ = await http_request(port, "/v1/models", method="GET")
        if [m["id"] for m in json.loads(b"".join(p for _, p in pieces))["data"]] == [model]:
            break
        await asyncio.sleep(0.1)
    else:
        raise RuntimeError(f"http: the frontend never listed {model}")
    prompts = burst_prompts()

    def body(i: int, stream: bool) -> dict:
        return {"model": model, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
                "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True,
                "logprobs": 0, "stream": stream}

    def check(label: str, r: dict, ref: dict | None) -> None:
        """200, [DONE], 64 tokens; against the in-process request: the same
        text and, for an aggregate response (which carries every token's
        text and logprob), the same 64 token texts and logprobs bit for bit."""
        if r["status"] != 200 or r.get("error"):
            raise RuntimeError(f"http {label}: status {r['status']} {r.get('error')}")
        if not r["done"]:
            raise RuntimeError(f"http {label}: the stream did not end in [DONE]")
        if (r["usage"] or {}).get("completion_tokens") != BURST_TOKENS or r["finish"] != "length":
            raise RuntimeError(f"http {label}: usage {r['usage']}, finish {r['finish']!r}")
        if ref is None:
            return
        if r["text"] != ref["text"]:
            raise RuntimeError(f"http {label}: text differs from the in-process request's")
        if not r["stream"] and (r["logprobs"] != ref["logprobs"]
                                or r["lp_tokens"] != ref["lp_tokens"]):
            raise RuntimeError(f"http {label}: token logprobs differ from the in-process request's")

    async def burst_pass(n: int, sse: bool) -> dict:
        """All 8 at once, the even ones streamed if ``sse``, the others
        aggregated; every aggregate one held to the in-process burst bit
        for bit."""
        t0 = time.perf_counter()
        rs = await asyncio.gather(*(
            http_completion(port, body(i, sse and i % 2 == 0), f"{0xB00 + 0x10 * n + i:032x}")
            for i in range(8)))
        wall = time.perf_counter() - t0
        for i, r in enumerate(rs):
            check(f"pass {n} request {i} ({'SSE' if r['stream'] else 'aggregate'})", r,
                  reference["burst"][i])
        seen = [await routed(port, r["trace_id"]) for r in rs]
        tps = 8 * BURST_TOKENS / wall
        instances = [inst for inst, _ in seen]
        log(f"http: pass {n}: 8 requests ({'4 SSE, 4' if sse else 'all 8'} aggregate), "
            f"{8 * BURST_TOKENS} completion tokens in "
            f"{wall:.3f}s → {tps:.1f} tokens/s over HTTP against {inproc_tps:.1f} in process "
            f"({tps / inproc_tps:.3f}x); routed to instances "
            + ", ".join(f"{i}:{inst}" for i, inst in enumerate(instances)) + f" ({card_line})")
        return {"responses": rs, "wall": wall, "tps": tps, "instances": instances,
                "ledger_ttft": [t for _, t in seen]}

    # Pass 1: the burst, even requests streamed, odd aggregated.
    one = await burst_pass(1, sse=True)
    burst, wall, tps, instances = one["responses"], one["wall"], one["tps"], one["instances"]
    if len(set(instances)) != 2:
        raise RuntimeError(f"http: the kv router used {len(set(instances))} of 2 workers")

    # Two chat completions, the same greedy request streamed and aggregated.
    chat = {"model": model, "max_tokens": BURST_TOKENS, "temperature": 0.0, "seed": 42,
            "ignore_eos": True,
            "messages": [{"role": "system", "content": "You are a helpful assistant."},
                         {"role": "user", "content": prompts[2]}]}
    chats = await asyncio.gather(http_completion(port, dict(chat, stream=True), f"{0xC0:032x}"),
                                 http_completion(port, dict(chat, stream=False), f"{0xC1:032x}"))
    for r in chats:
        check(f"chat ({'SSE' if r['stream'] else 'aggregate'})", r, None)
    if chats[0]["text"] != chats[1]["text"]:
        raise RuntimeError("http: the streamed and aggregated chat completions differ")
    log(f"http: two chat completions (SSE and aggregate) of 64 tokens, equal; the SSE one's "
        f"first event (its first token) after {chats[0]['first_event_s'] * 1e3:.1f} ms "
        f"({card_line})")

    # One burst prompt again: the KV router must send it to the worker
    # holding its prefix (the longest prompt: 96 cached blocks). Only its
    # last block is prefilled, attending over the cached pages: its token
    # stream must equal the in-process engine's on the same prefix hit.
    again = await http_completion(port, body(7, False), f"{0xD7:032x}")
    check("repeated request 7", again, reference["repeat"])
    drift = max(abs(a - b) for a, b in zip(again["logprobs"], reference["burst"][7]["logprobs"]))
    inst, again_ttft = await routed(port, again["trace_id"])
    if inst != instances[7]:
        raise RuntimeError(f"http: repeated request 7 went to instance {inst}, not {instances[7]} "
                           "which holds its prefix")
    log(f"http: repeated request 7 routed to instance {inst} again (its prefix holder); its 64 "
        f"token texts and logprobs equal the in-process prefix-hit pass's bit for bit (max "
        f"|logprob - cold pass| {drift:.3g}); frontend ledger TTFT {again_ttft * 1e3:.1f} ms, "
        f"latency {again['latency_s'] * 1e3:.1f} ms ({card_line})")

    # Pass 2, from empty caches: the same burst all aggregated, so every
    # request is held bit for bit, on whichever worker serves it.
    cleared = await clear_kv(port, model)
    log(f"http: /clear_kv_blocks dropped {cleared} cached blocks per instance")
    two = await burst_pass(2, sse=False)
    held = {inst for p in (one, two) for inst, r in zip(p["instances"], p["responses"])
            if not r["stream"]}
    if held != set(instances):
        raise RuntimeError(f"http: only instances {held} served a request held bit for bit")
    visible = sum(len(r["text"]) for r in burst)
    # TTFT: the frontend ledger's, for the aggregate requests of both
    # passes (a completion's SSE chunk waits for visible text, and random
    # weights mostly emit ids the byte tokenizer renders as nothing).
    ttfts = sorted(t for p in (one, two) for t, r in zip(p["ledger_ttft"], p["responses"])
                   if not r["stream"])
    log(f"http: frontend ledger TTFT of the {len(ttfts)} aggregate requests (4 in pass 1, 8 in "
        f"pass 2) p50 "
        f"{statistics.median(ttfts) * 1e3:.1f} ms, max {max(ttfts) * 1e3:.1f} ms; in process "
        + ", ".join(f"{ref['ttft_s'] * 1e3:.0f}" for ref in reference["burst"])
        + " ms for requests 0-7; pass 1 client latencies " + ", ".join(
            f"{r['latency_s'] * 1e3:.0f}" for r in burst) + f" ms ({card_line})")
    log(f"http: every completion's text ({visible} visible characters in pass 1) equals the "
        "in-process burst's, and the 64 token texts and logprobs of every aggregate one (4 in "
        f"pass 1, 8 in pass 2) equal it bit for bit, on instances {sorted(held)}")
    return {"tokens_per_s": tps, "inproc_tokens_per_s": inproc_tps, "wall_s": wall,
            "tokens_per_s_pass2": two["tps"], "wall_s_pass2": two["wall"],
            "ttft_p50_s": statistics.median(ttfts), "ttft_max_s": max(ttfts),
            "ttft_s": one["ledger_ttft"], "ttft_s_pass2": two["ledger_ttft"],
            "latency_s": [r["latency_s"] for r in burst], "instances": instances,
            "instances_pass2": two["instances"], "visible_chars": visible,
            "cleared_blocks": cleared,
            "chat_first_event_s": chats[0]["first_event_s"], "repeat_ttft_s": again_ttft,
            "repeat_latency_s": again["latency_s"], "repeat_logprob_drift": drift}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from dynamo_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: torch {torch.__version__} (CUDA {torch.version.cuda}), {kind}; nvidia-smi: {card_line}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} kernel source(s) built in {time.perf_counter() - t0:.1f}s → "
        f"{', '.join(str(v) for v in libs.values())}")

    cases = kernel_phase(device)
    stats, reference = asyncio.run(main_path(card_line))
    small_reference(device)
    frames = msgpack_frame_us()
    log("wire: msgpack_lite pack+unpack per frame: " + ", ".join(
        f"{k} {v['us']:.1f} us ({v['bytes']} bytes)" for k, v in frames.items())
        + f" (host CPU beside {card_line})")
    torch.cuda.empty_cache()
    http = http_phase(card_line, reference, stats["tokens_per_s"])
    http["msgpack_lite"] = frames

    head = cases[0]  # decode on bf16 pages: the main path's mode
    burst = cases[-1]  # the same at the burst's row lengths
    entry = {
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "version": KERNEL_VERSION, "splits": burst["splits"],
        "launches": stats["launches"], "launches_http": http["launches"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "cases": cases,
    }
    log("main_path: " + json.dumps(stats))
    log("http_path: " + json.dumps(http))
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
