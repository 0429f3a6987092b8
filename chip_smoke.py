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
   tensors, with NaN in every position past each row's walk.
4. Main path at full width: `run --in batch:`'s pipeline (preprocessor →
   Backend → TorchEngine) serving 8 concurrent llama-8b completions with
   random weights made on the card, then one prompt alone again. The
   kernel's launch counter is zeroed just before the requests and read
   just after.
5. A small-input reference: test-tiny in float32 through the model with
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
              L=2, layer=1):
    """Inputs for one kernel case → dict with the wrapper's ``args`` (CUDA
    tensors on ``device``) and host metadata. ``hist`` are per-row history
    lengths (0 = dead row); mode decode|linear|tree. Rows own disjoint
    pages; every position past a row's walk and every page no row owns
    holds NaN (NaN scales for int8 pages)."""
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
    W = int(pages.max())
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
        ("decode", "bfloat16", False), ("decode", "float32", False),
        ("decode", "bfloat16", True), ("linear", "bfloat16", False),
        ("tree", "bfloat16", False), ("tree", "bfloat16", True),
    ]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    results = []
    for i, (mode, qdt_name, quant) in enumerate(cases):
        name = f"{mode}_{'int8' if quant else qdt_name}"
        case = make_case(mode, qdt_name, quant, 100 + i, device, hist)
        args = case["args"]
        out = pa.paged_spec_attention(*args)
        ref = plain_f32(args)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            raise RuntimeError(f"{name}: non-finite output (kernel or plain)")
        if float(out[0].abs().max()) != 0.0:
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
        r = {"case": name, "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok,
             "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "bound_ms": b_ms, "bound_by": b_by, "T": case["T"]}
        log(f"kernel {name}: max_abs_err={err:.3e} (tol {atol:g} + {rtol:g}*|plain|, "
            f"{'ok' if ok else 'FAIL'}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        if not ok:
            raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                               f"(max |err| - rtol*|plain| = {excess:.3e} > {atol})")
        results.append(r)
    return results


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
    torch.cuda.synchronize()
    log(f"main: {preset} pipeline up in {time.perf_counter() - t0:.1f}s "
        f"(random bf16 weights made on the card)")
    cfg = engine.cfg
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

    steps0, decode_s0, _ = _phase_totals(engine)
    pa.launches = 0
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(one(i, p, t, 1000 + i)
                                  for i, (p, t) in enumerate(zip(prompts, temps))))
    wall = time.perf_counter() - t0
    launches = pa.launches
    steps1, decode_s1, prefill_s = _phase_totals(engine)
    substeps, decode_s = steps1 - steps0, decode_s1 - decode_s0
    for o in outs:
        usage, choice = o["resp"]["usage"], o["resp"]["choices"][0]
        if usage["completion_tokens"] != max_tokens or choice["finish_reason"] != "length":
            raise RuntimeError(f"request {o['i']}: {usage['completion_tokens']} tokens, "
                               f"finish {choice['finish_reason']!r}")
        if len(o["tokens"]) != max_tokens or not all(
                np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]):
            raise RuntimeError(f"request {o['i']}: bad token/logprob stream")
        if not all(0 <= t < cfg.vocab_size for t in o["tokens"]):
            raise RuntimeError(f"request {o['i']}: token id out of range")
    if launches != cfg.num_layers * substeps or substeps == 0:
        raise RuntimeError(f"kernel launches {launches} != layers {cfg.num_layers} x "
                           f"substeps {substeps}")
    total_tokens = sum(o["resp"]["usage"]["completion_tokens"] for o in outs)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(engine._runner.params))
    weight_bound_ms = param_bytes / HBM_BYTES_PER_S * 1e3
    substep_ms = decode_s / substeps * 1e3
    log(f"main: card {card_line}")
    log(f"main: 8 requests, {total_tokens} completion tokens in {wall:.3f}s → "
        f"{total_tokens / wall:.1f} tokens/s ({card_line})")
    for o in outs:
        log(f"main: request {o['i']} prompt {lens[o['i']]} tokens, temperature "
            f"{temps[o['i']]}: TTFT {o['ttft_s'] * 1e3:.1f} ms ({card_line})")
    log(f"main: decode {substeps} substeps, {substep_ms:.3f} ms per substep (batch of 8, "
        f"host clock around each window incl. its fetch) vs weight-stream bound "
        f"{weight_bound_ms:.3f} ms ({param_bytes / 1e9:.2f} GB / 3.35 TB/s) ({card_line})")
    log(f"main: prefill of the 8 prompts ({sum(lens)} tokens, one row at a time, first "
        f"token sampled per wave): {prefill_s * 1e3:.1f} ms host clock ({card_line})")
    log(f"main: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({card_line})")
    log(f"main: paged_attention launches {launches} = {cfg.num_layers} layers x {substeps} substeps")

    # Second pass: one greedy prompt alone, after clearing the idle prefix
    # cache so it takes the same prefill path, must give the same tokens.
    # It runs under torch.profiler, whose CUDA kernel records split the
    # pass's wall time into device-busy time per kernel and host time.
    from torch.profiler import ProfilerActivity, profile

    engine.clear_kv_blocks()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = await one(0, prompts[0], temps[0], 1000)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    if again["tokens"] != outs[0]["tokens"]:
        raise RuntimeError("second greedy pass of request 0 differs from its first pass")
    log("main: second greedy pass of request 0 alone is token-identical to its first pass")
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if "CUDA" in str(e.device_type) and e.self_device_time_total > 0),
        key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    if busy_ms == 0:
        log("profile: the profiler recorded no device time (device busy share not measured)")
    else:
        attn_ms = sum(k[1] for k in kernels if "paged_attention_kernel" in k[0])
        log(f"profile: second pass (1 request, 64 tokens, profiler on): wall {wall2 * 1e3:.1f} ms, "
            f"device busy {busy_ms:.1f} ms ({100 * busy_ms / (wall2 * 1e3):.1f}%), "
            f"paged_attention {attn_ms:.1f} ms ({card_line})")
        for name, ms, n in kernels[:6]:
            log(f"profile:   {ms:9.3f} ms  {n:6d}x  {name[:90]}")
    await engine.stop()
    stats = {"launches": launches, "substeps": substeps, "tokens_per_s": total_tokens / wall,
             "substep_ms": substep_ms, "weight_bound_ms": weight_bound_ms,
             "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del pipe, engine
    torch.cuda.empty_cache()
    return stats


def _phase_totals(engine):
    """(decode substeps, host seconds in decode windows, host seconds in
    prefill) so far; read while the engine is idle between request waves."""
    return engine.total_decode_steps, engine.phase_s["decode"], engine.phase_s["prefill"]


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
    entry = {
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": stats["launches"],
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
