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
   read), whose 8 token and logprob streams must be identical, and one
   prompt alone again under torch.profiler. Decode ms per substep,
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

The last lines are the kernels JSON line, nvidia-smi's name/power line,
and {"ok": true, "device": {...}}. Without CUDA, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
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

# The kernel is held against its plain PyTorch version evaluated in float32
# on the same values (bf16 → f32 is exact; int8 pages are first dequantized
# and rounded to q's dtype, the kernel's own rounding point), as
# |kernel - plain| <= atol + rtol * |plain|. float32 q: only the summation
# order differs. bfloat16 q: the kernel also rounds its f32 result to
# bfloat16 once, at most half a bfloat16 step (2^-8 of the value).
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-4, 2.0 ** -8 + 1e-3)}


def log(msg: str) -> None:
    print(msg, flush=True)


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

    args = parse_args([
        "--in", "batch:-", "--preset", preset, "--dtype", "bfloat16",
        "--block-size", "16", "--num-kv-blocks", "2048", "--max-num-seqs", "8",
        "--max-model-len", "2048", "--decode-steps", "8", "--device", device, "--seed", "0",
    ])
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
    rng = np.random.default_rng(2024)
    lens = [64, 160, 320, 512, 768, 1024, 1280, 1536]
    prompts = ["".join(chr(c) for c in rng.integers(32, 127, n)) for n in lens]
    temps = [0.0, 0.0, 0.0, 0.7, 0.0, 0.0, 0.7, 0.0]
    max_tokens = 64

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
                "tokens": list(gen.lp_tokens), "logprobs": list(gen.lp_values)}

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
    return stats


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
    stats = asyncio.run(main_path(card_line))
    small_reference(device)

    head = cases[0]  # decode on bf16 pages: the main path's mode
    burst = cases[-1]  # the same at the burst's row lengths
    entry = {
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "version": KERNEL_VERSION, "splits": burst["splits"],
        "launches": stats["launches"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "cases": cases,
    }
    log("main_path: " + json.dumps(stats))
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
