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
3b. The int8 weight product (`dynamo_tpu_torch/ops/csrc/int8_matmul.cu`)
   against its plain version evaluated in float32 on the same values, at
   every llama-8b decode shape (wq/wo, wk/wv, w_gate/w_up, w_down, lm_head
   with f32 logits) for M = 1, 8 and 64 rows, an odd shape in bf16 and f32,
   wq in f32 and lm_head with a bf16 scale (`TOL_INT8`); every case called
   twice, bit-identical. Kernel, plain, library (one `torch.matmul` of the
   same x with a bf16 w of the same shape) and bound times, and their sums
   over one substep's 225 products.
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
4b. The main path at int8 weights (random int8 made on the card, seed 0),
   twice: bf16 KV pages and int8 KV pages. Each serves the same burst at
   depth 2 and 0 (streams identical), holds the attention launches to 32 x
   substeps and the int8 launches to the shape rule (`int8_expected`: 225
   per decode substep on the kernel; a prefill of more than 64 rows on the
   prefill route, its last-token head on the kernel), and times and
   profiles one "simple" window replay. Printed beside the bf16 burst's
   numbers: tokens/s, host ms per substep, replay device ms per substep,
   TTFT, peak memory and graph-pool bytes.
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

8. A checkpoint on disk through the worker: llama-8b widths with 2 layers
   (seed 0, bf16, two safetensors shards, an index and config.json, ~3 GB)
   under build/checkpoints/, loaded in process with `load_model(quant=
   "int8")` (every leaf equal to `quantize_params_np` of the written
   arrays), then served by `python -m dynamo_tpu_torch.worker --model-path
   <dir> --quant int8 --kv-quant int8 --tokenizer byte` behind the store and
   a kv-mode frontend: the burst's first 4 requests as aggregate
   completions, each bit-equal (token texts and logprobs) to an in-process
   engine on the loaded weights with the same engine arguments; launches
   held as in 4b; load and launch-to-registration seconds printed.
9. The checkpoint's own tokenizer at full width: a Llama-3.1-shaped
   tokenizer.json (128,256 ids: 128,000 BPE tokens, the first merges
   learned from README.md and SURVEY.md, the rest filled from a seeded RNG,
   and the 256 specials; Split + ByteLevel, ignore_merges, a BOS template)
   and a generation_config.json (EOS 128001, 128008, 128009) written into
   phase 8's checkpoint, which `python -m dynamo_tpu_torch.worker
   --model-path <dir> --quant int8 --kv-quant int8` then serves with no
   --tokenizer behind the store and a kv-mode frontend: 4 chat and 4
   completion requests cut from README.md at the burst's lengths, 64
   tokens each, each bit-equal (token texts and logprobs) to an in-process
   engine on the loaded weights fed the port tokenizer's ids, with
   usage.prompt_tokens as the port's preprocessor counts them; the worker's
   launches for them (read on SIGUSR1) held as in phase 8. Then one
   mixed-priority check on the same worker (its KV pool sized so that two
   batch requests outgrow it): engine_preemptions_total{class="batch"}
   rises and the interactive response equals its solo run. The
   tokenizer's load seconds (frontend, in process), encode microseconds
   per token and characters per token over the 8 prompts, DecodeStream
   microseconds per token over the 512 generated tokens and the worker's
   launch-to-registration seconds are printed as host numbers beside the
   card's name and power limit.

The last lines are the kernels JSON line (both kernels), nvidia-smi's name/power line,
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


# -- the int8 weight product ----------------------------------------------------

INT8_SOURCE = "dynamo_tpu_torch/ops/csrc/int8_matmul.cu"
INT8_REPLACES = "dynamo_tpu/engine/model.py:156"
# llama-8b's decode products (K, N): wq/wo, wk/wv, w_gate/w_up, w_down, and
# lm_head; calls per substep beside each (32 layers).
INT8_SHAPES = {"wq_wo": (4096, 4096, 64), "wk_wv": (4096, 1024, 64),
               "w_gate_up": (4096, 14336, 64), "w_down": (14336, 4096, 32),
               "lm_head": (4096, 128256, 1)}
INT8_ODD = ("odd", 1000, 200)  # breaks every tile and 16-byte alignment
# The kernel is held against its plain version evaluated in float32 on the
# same values (int8_matmul_ref on f32 x and scale), as |kernel - plain| <=
# rtol * |plain| + c * (|x| @ |w|) * |scale|. The c term is the summation
# order (the kernel's split-K and warp order against cuBLAS's, each within
# a few units of f32 rounding of the sum of |x w| over K; the tensor
# cores' f32 accumulation is looser than IEEE). The rtol term is the plain
# version's rounding points the f32 evaluation skips: for bf16 x, x @ w,
# the scale and their product each rounded to bf16, half a step (2^-8 of
# the value) each.
TOL_INT8 = {"float32": (1e-6, 2.0 ** -16), "bfloat16": (3 * 2.0 ** -8, 2.0 ** -14)}


def int8_case(M, K, N, xdt_name, seed, device, scale_dt="float32"):
    """x [M, K] unit normals in ``xdt_name``, w [K, N] uniform int8 in
    [-127, 127], per-column scales in ``scale_dt``, from a generator on the
    card seeded with ``seed``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=device).to(getattr(torch, xdt_name))
    w = torch.randint(-127, 128, (K, N), generator=g, device=device, dtype=torch.int8)
    s = (torch.rand((N,), generator=g, device=device) * 0.02 + 1e-3).to(getattr(torch, scale_dt))
    return x, w, s


def int8_check(x, w, s, out_f32, label):
    """Kernel vs plain (f32 on the same values): → max |err|, or raise."""
    import torch

    from dynamo_tpu_torch.ops import int8_matmul as im

    out = im.int8_matmul(x, w, s, out_f32=out_f32)
    again = im.int8_matmul(x, w, s, out_f32=out_f32)
    ref = im.int8_matmul_ref(x.float(), w, s.float(), out_f32=True)
    absref = (x.float().abs() @ w.float().abs()) * s.float().abs()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise RuntimeError(f"int8 {label}: two calls on the same inputs differ")
    want_dt = torch.float32 if out_f32 else x.dtype
    if out.dtype != want_dt or out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"int8 {label}: output {out.dtype} {tuple(out.shape)} not finite "
                           f"{want_dt} {tuple(ref.shape)}")
    rtol, c = TOL_INT8[str(x.dtype).removeprefix("torch.")]
    diff = (out.float() - ref).abs()
    excess = float((diff - rtol * ref.abs() - c * absref).max())
    if excess > 0:
        raise RuntimeError(f"int8 {label}: kernel disagrees with its plain version by "
                           f"{excess:.3e} beyond the tolerance")
    return float(diff.max())


def int8_bound(M, K, N, x_bytes, out_bytes, scale_bytes, qdt_name):
    """Least time (ms): each weight, x, scale and output byte moved once over
    HBM bandwidth, against 2*M*K*N operations over the peak rate."""
    nbytes = K * N + M * K * x_bytes + N * scale_bytes + M * N * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * K * N / PEAK_OPS[qdt_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def int8_kernel_phase(device, card_line):
    """The int8 kernel against its plain version at every llama-8b decode
    shape for M in (1, 8, 64) (bf16 x; lm_head with f32 logits out), the
    odd shape in bf16 and f32, and wq in f32: bit-identical repeats,
    tolerance TOL_INT8, and kernel, plain, library and bound times."""
    import torch

    from dynamo_tpu_torch.ops import int8_matmul as im

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    cases = [(name, M, K, N, "bfloat16", name == "lm_head")
             for name, (K, N, _) in INT8_SHAPES.items() for M in (1, 8, 64)]
    cases += [(INT8_ODD[0], M, INT8_ODD[1], INT8_ODD[2], dt, False)
              for M in (5, 64) for dt in ("bfloat16", "float32")]
    cases += [("wq_wo", 8, 4096, 4096, "float32", False),
              ("lm_head_bf16_scale", 8, 4096, 128256, "bfloat16", True)]
    results = []
    for i, (name, M, K, N, xdt, out_f32) in enumerate(cases):
        x, w, s = int8_case(M, K, N, xdt, 500 + i, device,
                            "bfloat16" if name.endswith("bf16_scale") else "float32")
        err = int8_check(x, w, s, out_f32, f"{name} M={M} {xdt}")
        ms = time_ms(lambda: im.int8_matmul(x, w, s, out_f32=out_f32), flush)
        plain_ms = time_ms(lambda: im.int8_matmul_ref(x, w, s, out_f32=out_f32), flush)
        wb = w.to(x.dtype)
        lib_ms = time_ms(lambda: torch.matmul(x, wb), flush)
        del wb
        xb = x.element_size()
        b_ms, b_by = int8_bound(M, K, N, xb, 4 if out_f32 else xb, s.element_size(), xdt)
        r = {"case": f"{name}_M{M}_{xdt}", "M": M, "K": K, "N": N, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
             "bound_by": b_by, "splits": im.split_k(K, N)}
        log(f"int8 {r['case']} ({K}x{N}): max_abs_err={err:.3e} (tol {TOL_INT8[xdt]}) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) splits={r['splits']} ({card_line})")
        results.append(r)
    by = {r["case"]: r for r in results}
    substep = {k: sum(by[f"{name}_M8_bfloat16"][k] * calls
                      for name, (_, _, calls) in INT8_SHAPES.items())
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"int8: the 225 products of one llama-8b substep at M=8, from the cases above: kernel "
        f"{substep['ms']:.3f} ms, plain {substep['plain_ms']:.3f}, library (bf16 weights) "
        f"{substep['library_ms']:.3f}, bound {substep['bound_ms']:.3f} ({card_line})")
    return results, substep


DECODE_PHASES = ("decode_dispatch", "drain_sync", "drain_ready", "emit")


def int8_expected(cfg, lens, substeps: int, bs: int = 16) -> tuple[int, int]:
    """int8 calls a burst makes on each route (kernel, prefill): 7 per layer
    plus lm_head per forward pass; every decode substep has 8 rows (the
    kernel); each cold single-row prefill of a prompt padded to T tokens
    runs its layer products on the kernel when T <= MAX_M rows and on the
    prefill route otherwise, and its last-token head (1 row) on the kernel."""
    from dynamo_tpu_torch.ops.int8_matmul import MAX_M

    per_pass = 7 * cfg.num_layers
    kernel, prefill = (per_pass + 1) * substeps, 0
    for n in lens:
        T = -(-n // bs) * bs
        kernel += 1 + (per_pass if T <= MAX_M else 0)
        prefill += per_pass if T > MAX_M else 0
    return kernel, prefill


async def main_path(card_line: str, preset: str = "llama-8b", device: str = "cuda",
                    quant: str = "none", kv_quant: str = "none"):
    """The burst through ``run --in batch:``'s pipeline. The bf16 run
    (quant "none") also serves the prefix-hit repeat, the profiled pass and
    the graph phase; an int8 run times one replay and profiles it."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.ops import int8_matmul as im
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.run.__main__ import build_pipeline, parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    tag = "main" if quant == "none" else f"main-int8-kv{kv_quant}"
    args = parse_args(["--in", "batch:-", "--preset", preset, "--dtype", "bfloat16",
                       "--device", device, *ENGINE_ARGV])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    pipe = await build_pipeline(args, quant=quant, kv_quant=kv_quant)
    engine = pipe.engine
    runner = engine.runner
    torch.cuda.synchronize()
    log(f"{tag}: {preset} pipeline up in {time.perf_counter() - t0:.1f}s "
        f"(random {'int8' if quant == 'int8' else 'bf16'} weights made on the card, "
        f"{kv_quant} KV pages), pipeline_depth {engine.args.effective_pipeline_depth}")
    cfg = engine.cfg
    g = runner.graphs
    n = runner.warm_windows(("greedy", "simple"), (0,))
    log(f"{tag}: {n} window graphs captured ahead of traffic in {g.capture_s:.2f}s "
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
        pa.launches = im.launches = im.prefill_launches = 0
        t0 = time.perf_counter()
        outs = await asyncio.gather(*(one(i, p, t, 1000 + i)
                                      for i, (p, t) in enumerate(zip(prompts, temps))))
        wall = time.perf_counter() - t0
        while engine.busy():
            await asyncio.sleep(0.001)
        launches, i8, i8_prefill = pa.launches, im.launches, im.prefill_launches
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
        want_i8 = int8_expected(cfg, lens, substeps) if quant == "int8" else (0, 0)
        if (i8, i8_prefill) != want_i8:
            raise RuntimeError(f"{label}: int8_matmul launches (kernel, prefill route) "
                               f"{(i8, i8_prefill)} != {want_i8} for {substeps} substeps")
        eager = runner.eager_windows - eager0
        if eager:
            raise RuntimeError(f"{label}: {eager} K-step windows ran eagerly on the card")
        decode_s = sum(phase.get(k, 0.0) for k in DECODE_PHASES)
        total_tokens = sum(o["resp"]["usage"]["completion_tokens"] for o in outs)
        st = {"launches": launches, "int8_launches": i8, "int8_prefill_launches": i8_prefill,
              "substeps": substeps, "wall_s": wall,
              "tokens_per_s": total_tokens / wall, "substep_ms": decode_s / substeps * 1e3,
              "decode_s": decode_s, "host_blocked": phase.get("drain_sync", 0.0) / decode_s,
              "prefill_dispatch_s": phase.get("prefill", 0.0),
              "replays": runner.graphs.replays - replays0,
              "ttft_s": [o["ttft_s"] for o in outs]}
        log(f"{tag}[{label}]: 8 requests, {total_tokens} completion tokens in {wall:.3f}s → "
            f"{st['tokens_per_s']:.1f} tokens/s ({card_line})")
        for o in outs:
            log(f"{tag}[{label}]: request {o['i']} prompt {lens[o['i']]} tokens, temperature "
                f"{temps[o['i']]}: TTFT {o['ttft_s'] * 1e3:.1f} ms ({card_line})")
        log(f"{tag}[{label}]: decode {substeps} substeps, {st['substep_ms']:.3f} ms per substep "
            f"(host time in decode phases {decode_s:.3f}s / substeps; batch of 8), host blocked "
            f"on fetches {100 * st['host_blocked']:.1f}% of it, {st['replays']} graph replays "
            f"({card_line})")
        log(f"{tag}[{label}]: phases " + json.dumps({k: round(v, 4) for k, v in phase.items()}))
        log(f"{tag}[{label}]: paged_attention launches {launches} = {cfg.num_layers} layers x "
            f"{substeps} substeps; int8_matmul launches {i8} on the kernel, {i8_prefill} on the "
            f"prefill route")
        return outs, st

    first, st2 = await burst("depth2")
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    weight_bound_ms = param_bytes / HBM_BYTES_PER_S * 1e3
    log(f"{tag}: weight-stream bound {weight_bound_ms:.3f} ms per substep "
        f"({param_bytes / 1e9:.2f} GB / 3.35 TB/s) ({card_line})")
    log(f"{tag}: {g.captured} window graphs in all, captured in {g.capture_s:.2f}s, graph pool "
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
            raise RuntimeError(f"{tag} request {a['i']}: depth 2 and depth 0 streams differ")
    log(f"{tag}: all 8 token and logprob streams identical at pipeline_depth 2 and 0")
    stats = {"launches": st2["launches"], "int8_launches": st2["int8_launches"],
             "int8_prefill_launches": st2["int8_prefill_launches"], "substeps": st2["substeps"],
             "tokens_per_s": st2["tokens_per_s"], "substep_ms": st2["substep_ms"],
             "host_blocked": st2["host_blocked"], "ttft_s": st2["ttft_s"],
             "depth0": {k: st0[k] for k in ("substeps", "tokens_per_s", "substep_ms",
                                             "host_blocked", "ttft_s")},
             "weight_bound_ms": weight_bound_ms, "graphs": g.captured,
             "capture_s": g.capture_s, "graph_pool_bytes": g.pool_bytes(),
             "replays": st2["replays"],
             "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    reference = {"burst": [o["ref"] for o in first]}
    if quant == "none":
        # Request 7 again, on the prefix its depth-0 pass cached: the
        # reference of the HTTP phase's repeat, which takes the same path.
        repeat = await one(7, prompts[7], temps[7], 1007)
        drift = max(abs(a - b) for a, b in zip(repeat["logprobs"], first[7]["logprobs"]))
        log(f"main: request 7 again on its cached prefix: tokens "
            f"{'equal to' if repeat['tokens'] == first[7]['tokens'] else 'not equal to'} its "
            f"cold pass, max |logprob - cold pass| {drift:.3g}, TTFT "
            f"{repeat['ttft_s'] * 1e3:.1f} ms ({card_line})")
        reference["repeat"] = repeat["ref"]
        stats["device_busy_share"] = await busy_pass(engine, one, prompts, temps, first,
                                                     card_line)
        stats.update(window_phase(engine, card_line))
    else:
        stats.update(replay_phase(engine, card_line, tag))
    await engine.stop()
    del pipe, engine, runner
    torch.cuda.empty_cache()
    return stats, reference


async def busy_pass(engine, one, prompts, temps, first, card_line):
    """One greedy prompt alone again, under torch.profiler, whose CUDA kernel
    records split the pass's wall time into device-busy time and the rest.
    → the busy share (None when the profiler saw no device time)."""
    import torch
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
    if busy_ms == 0:
        log("profile: the profiler recorded no device time (device busy share not measured)")
        return None
    busy_share = busy_ms / (wall2 * 1e3)
    attn_ms = sum(k[1] for k in kernels if "paged_attention" in k[0])
    log(f"profile: second pass (1 request, 64 tokens, profiler on): wall {wall2 * 1e3:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_share:.1f}%), "
        f"paged_attention {attn_ms:.1f} ms ({card_line})")
    for name, ms, n in kernels[:6]:
        log(f"profile:   {ms:9.3f} ms  {n:6d}x  {name[:90]}")
    return busy_share


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
    families = {"int8_matmul": ("int8_matmul",),
                "gemm (nvjet/cutlass/gemv)": ("nvjet", "gemm", "gemv", "cutlass", "splitK"),
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


def replay_ms(runner, kw) -> float:
    """Device time per substep of the window ``kw`` as one graph replay:
    the median of 5 CUDA-event timings after one warm replay."""
    import torch

    runner.multi_decode(**kw)
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        runner.multi_decode(**kw)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) / kw["K"]


def replay_phase(engine, card_line: str, tag: str) -> dict:
    """An int8 run's window: the "simple" window at the burst's lengths on
    the engine's weights and KV page format (its own small cache), its
    replay device time per substep and one profiled replay by family."""
    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.runner import LocalRunner

    args = EngineArgs(model=engine.cfg, block_size=16, num_kv_blocks=256, max_num_seqs=8,
                      max_model_len=2048, decode_steps=8, dtype="bfloat16", device="cuda",
                      kv_quant=engine.args.kv_quant)
    runner = LocalRunner(args, params=engine.runner.params)
    runner.start()
    kw = dict(window_inputs(runner, "simple", 61, lens=BURST_HIST[:6]), top_n=0)
    ms = replay_ms(runner, kw)
    log(f"{tag}: simple window at the burst's lengths: {ms:.3f} ms device time per substep as "
        f"one graph replay ({card_line})")
    out = {"replay_ms_per_substep_simple": ms, "replay_profile": profile_replay(runner, kw, card_line)}
    runner.stop()
    return out


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
        ms = replay_ms(runner, kw)
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
        out.update(choice_view(kind, resp["choices"][0]), usage=resp["usage"], done=True)
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


def choice_view(kind: str, choice: dict) -> dict:
    """An aggregate response's choice → its text, finish reason, and per
    token logprobs and token texts (chat: ``logprobs.content``)."""
    lp = choice.get("logprobs") or {}
    if kind == "chat":
        content = lp.get("content")
        return {"text": choice["message"]["content"], "finish": choice["finish_reason"],
                "logprobs": [e["logprob"] for e in content] if content else None,
                "lp_tokens": [e["token"] for e in content] if content else None}
    return {"text": choice["text"], "finish": choice["finish_reason"],
            "logprobs": lp.get("token_logprobs"), "lp_tokens": lp.get("tokens")}


async def clear_kv(port: int, model: str, workers: int = 2) -> dict[str, int]:
    """POST /clear_kv_blocks until a call drops nothing on any worker (a
    row still draining its last windows frees its blocks a moment after
    its response) → blocks dropped per instance."""
    await asyncio.sleep(1.0)
    total: dict[str, int] = {}
    for _ in range(50):
        status, _, pieces, _ = await http_request(port, "/clear_kv_blocks", {})
        cleared = json.loads(b"".join(p for _, p in pieces))["cleared"].get(model) or {}
        if status != 200 or len(cleared) != workers or any(n < 0 for n in cleared.values()):
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


# -- a checkpoint on disk, served int8 through the worker -----------------------

CKPT_REQUESTS = 4  # the burst's first four requests


def _host_f32(tree):
    if isinstance(tree, dict):
        return {k: _host_f32(v) for k, v in tree.items()}
    return tree.numpy() if str(tree.dtype) == "torch.int8" else tree.float().numpy()


def checkpoint_phase(card_line: str, preset: str = "llama-8b", layers: int = 2,
                     device: str = "cuda", dtype: str = "bfloat16", keep: bool = False,
                     vocab_size: int | None = None) -> dict:
    """A checkpoint of ``preset``'s widths with ``layers`` layers (seed 0,
    two safetensors shards, an index and config.json; ``vocab_size`` if
    given) written under build/ (and left there with ``keep`` for phase 9),
    loaded int8 in process (leaves held to quantize_params_np of the
    written arrays) and served by one ``python -m dynamo_tpu_torch.worker
    --model-path <dir> --quant int8 --kv-quant int8 --tokenizer byte``
    behind the store and a kv-mode frontend: 4 aggregate completions, each
    bit-equal (token texts and logprobs) to the in-process engine built
    from the port's ``load_model(<dir>, quant="int8")``."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from dynamo_tpu_torch.engine import model as M
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.loader import load_model, save_checkpoint
    from dynamo_tpu_torch.engine.quant import quantize_params_np

    cfg = dataclasses.replace(ModelConfig.preset(preset), num_layers=layers,
                              **({"vocab_size": vocab_size} if vocab_size else {}))
    name = f"{preset}-{layers}layers" + (f"-v{vocab_size}" if vocab_size else "")
    path = os.path.join(HERE, "build", "checkpoints", name)
    tdt = getattr(torch, dtype)
    shutil.rmtree(path, ignore_errors=True)
    procs: list[Proc] = []
    try:
        t0 = time.perf_counter()
        dev_tree = M.init_params(cfg, torch.device(device), tdt, seed=0)
        host = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                for k, v in dev_tree.items()}
        del dev_tree
        save_checkpoint(path, cfg, host, shards=2)
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        write_s = time.perf_counter() - t0
        log(f"ckpt: {name} written ({size / 1e9:.2f} GB, 2 shards + index + config.json) in "
            f"{write_s:.1f}s")

        t0 = time.perf_counter()
        lcfg, params = load_model(path, dtype=dtype, quant="int8", device=device)
        load_s = time.perf_counter() - t0
        want = quantize_params_np(_host_f32(host))
        del host
        for k, leaf in _flat(params):
            exp = torch.from_numpy(np.ascontiguousarray(_get(want, k)))
            if leaf.dtype != torch.int8:
                exp = exp.to(leaf.dtype)
            if leaf.dtype != exp.dtype or not torch.equal(leaf.cpu(), exp):
                raise RuntimeError(f"ckpt: loaded leaf {k} differs from quantize_params_np of "
                                   "the written arrays")
        del want
        log(f"ckpt: load_model(quant='int8') in {load_s:.1f}s on {device}; every leaf equals "
            f"quantize_params_np of the written arrays bit for bit ({card_line})")
        ref, ref_counts = asyncio.run(_checkpoint_reference(lcfg, params, name, device, dtype))
        del params
        if device == "cuda":
            torch.cuda.empty_cache()

        store_port = _free_port()
        store_url = f"tcp://127.0.0.1:{store_port}"
        store = Proc("ckpt-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                    "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        worker = Proc("ckpt-worker", [
            "dynamo_tpu_torch.worker", "--store-url", store_url, "--model-path", path,
            "--quant", "int8", "--kv-quant", "int8", "--tokenizer", "byte", "--dtype", dtype,
            "--device", device, *ENGINE_ARGV])
        procs.append(worker)
        m, _ = worker.wait_for(r"loaded .* \(quant int8\) in ([0-9.]+)s", 600)
        worker_load_s = float(m.group(1))
        _, registered_s = worker.wait_for(r"serving " + re.escape(name), 600)
        log(f"ckpt: worker loaded the checkpoint int8 in {worker_load_s:.1f}s, registered "
            f"{registered_s:.1f}s after launch ({card_line})")
        fe = Proc("ckpt-frontend", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                                    "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"])
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))
        got = asyncio.run(_checkpoint_http(port, name))
        for i, (r, want_r) in enumerate(zip(got, ref)):
            if r["status"] != 200 or r.get("error") or r["finish"] != "length":
                raise RuntimeError(f"ckpt request {i}: {r['status']} {r.get('error')} "
                                   f"{r.get('finish')!r}")
            if r["logprobs"] != want_r["logprobs"] or r["lp_tokens"] != want_r["lp_tokens"]:
                raise RuntimeError(f"ckpt request {i}: token logprobs differ from the in-process "
                                   "engine's on the same checkpoint")
        rcs = {p.name: p.stop() for p in [fe, worker, store]}
        if any(rcs.values()):
            raise RuntimeError(f"ckpt: processes did not exit 0 on SIGTERM: {rcs}")
        counters = next(json.loads(line) for line in reversed(worker.lines)
                        if line.startswith('{"event": "engine_counters"'))
        got_counts = (counters["paged_attention_launches"], counters["int8_matmul_launches"],
                      counters["int8_matmul_prefill_launches"])
        want_counts = _ckpt_counts(lcfg, counters["decode_substeps"], device)
        if got_counts != want_counts:
            raise RuntimeError(f"ckpt: worker launches (attention, int8 kernel, int8 prefill) "
                               f"{got_counts} != {want_counts}")
        wall = max(r["latency_s"] for r in got)
        log(f"ckpt: {CKPT_REQUESTS} aggregate completions through worker --model-path --quant "
            f"int8 --kv-quant int8, each bit-equal to the in-process engine on the same "
            f"checkpoint (token texts and logprobs); worker launches {got_counts} (attention, "
            f"int8 kernel, int8 prefill route) for {counters['decode_substeps']} substeps; "
            f"in-process {ref_counts}; slowest request {wall:.2f}s ({card_line})")
        return {"name": name, "path": path, "cfg": lcfg, "bytes": size, "write_s": write_s,
                "load_s": load_s,
                "worker_load_s": worker_load_s, "launch_to_registered_s": registered_s,
                "launches": got_counts, "decode_substeps": counters["decode_substeps"],
                "inproc_launches": ref_counts, "latency_s": [r["latency_s"] for r in got]}
    finally:
        for p in procs:
            p.kill()
        if not keep:
            shutil.rmtree(path, ignore_errors=True)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, key):
    for k in key:
        tree = tree[k]
    return tree


def _ckpt_counts(cfg, substeps: int, device: str,
                 lens=tuple(BURST_LENS[:CKPT_REQUESTS])) -> tuple[int, int, int]:
    """(attention, int8 kernel, int8 prefill route) launches of the phase's
    requests (cold prompts of ``lens`` tokens); all 0 on the CPU, where the
    plain versions run."""
    if device != "cuda":
        return 0, 0, 0
    kernel, prefill = int8_expected(cfg, lens, substeps)
    return cfg.num_layers * substeps, kernel, prefill


async def _checkpoint_reference(cfg, params, name, device, dtype):
    """The phase's requests through an in-process engine on the loaded
    weights, with the worker's engine arguments → (reference entries,
    launches as _ckpt_counts counts them)."""
    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.ops import int8_matmul as im
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.run.__main__ import LocalPipeline
    from dynamo_tpu_torch.runtime.engine import Context

    engine = await TorchEngine(EngineArgs(
        model=cfg, block_size=16, num_kv_blocks=2048, max_num_seqs=8, max_model_len=2048,
        decode_steps=8, dtype=dtype, quant="int8", kv_quant="int8", device=device,
    ), params=params).start()
    card = ModelDeploymentCard(name=name, tokenizer={"type": "byte"}, context_length=2048,
                               kv_cache_block_size=16, eos_token_ids=[ByteTokenizer.EOS])
    pipe = LocalPipeline(card, engine, ByteTokenizer())
    await asyncio.to_thread(engine.runner.warm_windows, ("greedy", "simple"))
    pa.launches = im.launches = im.prefill_launches = 0
    steps0 = engine.total_decode_steps
    prompts = burst_prompts()

    async def one(i):
        req = CompletionRequest.parse({
            "model": name, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
            "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True, "logprobs": 0})
        gen = None
        async for g, _chunk in pipe.run(req, Context()):
            gen = g
        return reference_entry(gen, 0.0)

    try:
        refs = await asyncio.gather(*(one(i) for i in range(CKPT_REQUESTS)))
        while engine.busy():
            await asyncio.sleep(0.001)
        counts = (pa.launches, im.launches, im.prefill_launches)
        want = _ckpt_counts(cfg, engine.total_decode_steps - steps0, device)
        if counts != want:
            raise RuntimeError(f"ckpt in process: launches {counts} != {want}")
    finally:
        await engine.stop()
    return refs, counts


async def _checkpoint_http(port: int, model: str) -> list[dict]:
    await _wait_listed(port, model)
    prompts = burst_prompts()
    return await asyncio.gather(*(
        http_completion(port, {"model": model, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
                               "temperature": BURST_TEMPS[i], "seed": 1000 + i,
                               "ignore_eos": True, "logprobs": 0, "stream": False},
                        f"{0xE00 + i:032x}")
        for i in range(CKPT_REQUESTS)))


# -- phase 9: the checkpoint's own tokenizer at full width ----------------------

# Meta-Llama-3.1-8B's pre-tokenizer split and its 256 added specials
# (ids 128000-128255 after 128,000 BPE tokens); EOS as its
# generation_config.json names them.
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_SPECIALS = (["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                    "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                    "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
                    "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
                   + [f"<|reserved_special_token_{i}|>" for i in range(3, 248)])
LLAMA3_EOS = ("<|end_of_text|>", "<|eom_id|>", "<|eot_id|>")
TOK_LEARNED_MAX = 20_000  # merges learned from the repository's Markdown at most
TOK_MARGIN_BLOCKS = 16    # KV blocks the worker holds beyond the burst's need
LOOKAHEAD = 24            # tokens a decoding row reserves ahead: K x (depth + 1)


def _llama3_words(texts) -> "collections.Counter":
    """Byte-level words of ``texts`` under the Llama-3 split (the port's
    own pre-tokenizer) → their counts."""
    import collections

    from dynamo_tpu_torch.llm.tokenizer_json import TokenizerJson

    pre = TokenizerJson({"model": {"type": "BPE", "vocab": {}, "merges": []},
                         "pre_tokenizer": _llama3_pre_tokenizer()}).pre_tokenize
    words = collections.Counter()
    for t in texts:
        words.update(w for w, _ in pre([(t, True)]))
    return words


def _llama3_pre_tokenizer() -> dict:
    return {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": False}]}


def learn_merges(words, limit: int) -> list[tuple[str, str]]:
    """Byte-pair merges learned from word counts, most frequent pair first
    (ties: the smallest pair), until ``limit`` or no pair occurs twice."""
    import collections
    import heapq

    syms = [list(w) for w in words]
    counts = list(words.values())
    pairs: collections.Counter = collections.Counter()
    where = collections.defaultdict(set)
    for i, s in enumerate(syms):
        for q in zip(s, s[1:]):
            pairs[q] += counts[i]
            where[q].add(i)
    heap = [(-c, q) for q, c in pairs.items()]
    heapq.heapify(heap)
    merges: list[tuple[str, str]] = []
    while heap and len(merges) < limit:
        neg, q = heapq.heappop(heap)
        if pairs.get(q, 0) != -neg:
            continue  # a stale entry
        if -neg < 2:
            break
        a, b = q
        merges.append(q)
        touched = set()
        for i in where.pop(q):
            s, c = syms[i], counts[i]
            out, j = [], 0
            while j < len(s):
                if j + 1 < len(s) and s[j] == a and s[j + 1] == b:
                    out.append(a + b)
                    j += 2
                else:
                    out.append(s[j])
                    j += 1
            if len(out) == len(s):
                continue
            for p in zip(s, s[1:]):
                pairs[p] -= c
                touched.add(p)
            for p in zip(out, out[1:]):
                pairs[p] += c
                where[p].add(i)
                touched.add(p)
            syms[i] = out
        for p in touched:
            if pairs[p] > 0:
                heapq.heappush(heap, (-pairs[p], p))
            else:
                pairs.pop(p, None)
    return merges


def write_llama3_tokenizer(path: str, n_bpe: int = 128_000, learned_max: int = TOK_LEARNED_MAX,
                           seed: int = 0) -> dict:
    """A Llama-3.1-shaped tokenizer.json and generation_config.json in
    ``path``: ``n_bpe`` BPE tokens (the 256 byte-level characters, merges
    learned from README.md and SURVEY.md, then merges filled from a seeded
    RNG, each joining two existing tokens, until the vocabulary is full)
    and the 256 specials after them; Split + ByteLevel(use_regex=false),
    ignore_merges, a TemplateProcessing BOS, the ByteLevel decoder."""
    import random

    from dynamo_tpu_torch.llm.tokenizer_json import bytes_to_unicode

    texts = []
    for name in ("README.md", "SURVEY.md"):
        with open(os.path.join(HERE, name), encoding="utf-8") as f:
            texts += [p for p in f.read().split("\n\n") if p.strip()]
    vocab = {ch: i for i, ch in enumerate(bytes_to_unicode()[b] for b in range(256))}
    merges: list[tuple[str, str]] = []
    for a, b in learn_merges(_llama3_words(texts), min(learned_max, n_bpe - 256)):
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
    learned = len(vocab) - 256
    rng = random.Random(seed)
    tokens = list(vocab)
    while len(vocab) < n_bpe:
        a = tokens[rng.randrange(len(tokens))]
        b = tokens[rng.randrange(min(len(tokens), 4096))]
        if a + b in vocab:
            continue
        vocab[a + b] = len(vocab)
        tokens.append(a + b)
        merges.append((a, b))
    bos = LLAMA3_SPECIALS[0]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": n_bpe + i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(LLAMA3_SPECIALS)],
        "normalizer": None,
        "pre_tokenizer": _llama3_pre_tokenizer(),
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [n_bpe], "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    eos = [n_bpe + LLAMA3_SPECIALS.index(t) for t in LLAMA3_EOS]
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"bos_token_id": n_bpe, "eos_token_id": eos}, f)
    return {"ids": n_bpe + len(LLAMA3_SPECIALS), "learned_tokens": learned,
            "merges": len(merges), "eos": eos}


def readme_cuts() -> list[str]:
    """The burst's lengths cut from README.md one after another (distinct
    prefixes, so no request hits another's cached blocks)."""
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    out, at = [], 0
    for n in BURST_LENS:
        out.append(text[at:at + n])
        at += n
    return out


def tok_bodies(model: str) -> list[dict]:
    """Phase 9's requests: even ones chat, odd ones completions, the
    burst's temperatures and seeds, 64 tokens, logprobs, aggregated."""
    out = []
    for i, prompt in enumerate(readme_cuts()):
        body = {"model": model, "max_tokens": BURST_TOKENS, "temperature": BURST_TEMPS[i],
                "seed": 1000 + i, "ignore_eos": True, "stream": False}
        if i % 2 == 0:
            body.update(messages=[{"role": "user", "content": prompt}], logprobs=True)
        else:
            body.update(prompt=prompt, logprobs=0)
        out.append(body)
    return out


def tok_prompt_tokens(card, tokenizer, bodies) -> list[int]:
    """Each body's prompt tokens as the port's preprocessor makes them (chat:
    the rendered template)."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols import ChatCompletionRequest, CompletionRequest

    pre = OpenAIPreprocessor(card, tokenizer)
    out = []
    for b in bodies:
        if "messages" in b:
            out.append(len(pre.preprocess_chat(ChatCompletionRequest.parse(b)).token_ids))
        else:
            out.append(len(pre.preprocess_completion(CompletionRequest.parse(b)).token_ids))
    return out


def tok_geometry(prompt_tokens: list[int], batch_prompt_tokens: list[int],
                 max_model_len: int = 2048, bs: int = 16) -> dict:
    """The worker's KV blocks and the mixed-priority check's batch lengths:
    the burst fits with TOK_MARGIN_BLOCKS to spare (no preemption there),
    and the two batch requests together need more blocks than the pool
    holds, each within max_model_len, so running both forces a
    preemption."""
    need = sum(-(-(n + BURST_TOKENS + LOOKAHEAD) // bs) for n in prompt_tokens)
    blocks = need + TOK_MARGIN_BLOCKS + 1  # block 0 is the sink
    per_batch = -(-((blocks - 1) * bs * 11) // 20)  # 55% of the pool each
    if per_batch > max_model_len - 8:
        raise RuntimeError(f"tok: the burst needs {need} blocks; two batch requests of "
                           f"{per_batch} tokens would not fit max_model_len {max_model_len}")
    gens = [per_batch - n for n in batch_prompt_tokens]
    if min(gens) < BURST_TOKENS:
        raise RuntimeError(f"tok: batch prompts of {batch_prompt_tokens} tokens leave "
                           f"{gens} to generate")
    return {"num_kv_blocks": blocks, "burst_blocks": need, "batch_max_tokens": gens}


def tok_mixed_prompts() -> tuple[list[str], str]:
    """The mixed-priority check's two batch prompts (README's first 5,000
    characters, halved) and its interactive one (a short cut from README's
    end, so that it decodes within one 128-position attention chunk)."""
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    return [text[:2500], text[2500:5000]], text[-170:-20]


def tokenizer_phase(card_line: str, path: str, cfg, device: str = "cuda",
                    dtype: str = "bfloat16") -> dict:
    """Phase 9: a Llama-3.1-shaped tokenizer written into the phase-8
    checkpoint ``path``, served by ``worker --model-path --quant int8
    --kv-quant int8`` with no --tokenizer behind the store and a kv-mode
    frontend; 4 chat and 4 completion requests bit-equal to an in-process
    engine on the loaded weights fed the port tokenizer's ids, the launches
    held, one mixed-priority check with a preemption, and the tokenizer's
    host numbers."""
    import shutil

    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.tokenizer import DecodeStream, HFTokenizer, load_tokenizer

    name = os.path.basename(path)
    procs: list[Proc] = []
    try:
        t0 = time.perf_counter()
        wrote = write_llama3_tokenizer(path, cfg.vocab_size - len(LLAMA3_SPECIALS))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok = load_tokenizer({"type": "hf", "path": path})
        load_s = time.perf_counter() - t0
        bos = wrote["ids"] - len(LLAMA3_SPECIALS)
        if (tok.vocab_size != cfg.vocab_size or tok.eos_token_ids != wrote["eos"]
                or tok.encode("<|begin_of_text|>") != [bos, bos]):
            raise RuntimeError(f"tok: the written tokenizer reads back wrong: vocab "
                               f"{tok.vocab_size}, eos {tok.eos_token_ids}")
        log(f"tok: tokenizer.json written ({wrote['ids']} ids, {wrote['learned_tokens']} "
            f"tokens learned from README.md and SURVEY.md, {wrote['merges']} merges) in "
            f"{write_s:.1f}s; loaded in process in {load_s:.3f}s (host CPU beside {card_line})")

        # Host numbers: encode over the 8 prompts on a fresh tokenizer (its
        # BPE cache cold), then again (warm).
        prompts = readme_cuts()
        fresh = HFTokenizer(path)
        t0 = time.perf_counter()
        enc = [fresh.encode(p) for p in prompts]
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p in prompts:
            fresh.encode(p)
        warm_s = time.perf_counter() - t0
        n_tok = sum(len(e) for e in enc)
        chars = sum(len(p) for p in prompts)

        bodies = tok_bodies(name)
        card = ModelDeploymentCard(name=name, tokenizer={"type": "hf", "path": path},
                                   context_length=2048, kv_cache_block_size=16,
                                   eos_token_ids=tok.eos_token_ids)
        prompt_tokens = tok_prompt_tokens(card, tok, bodies)
        if any(prompt_tokens[i] != len(enc[i]) for i in range(1, len(bodies), 2)):
            raise RuntimeError("tok: a completion's prompt tokens differ from encode()")
        batch_prompts, inter_prompt = tok_mixed_prompts()
        geo = tok_geometry(prompt_tokens, [len(tok.encode(p)) for p in batch_prompts])
        engine_argv = ["--block-size", "16", "--num-kv-blocks", str(geo["num_kv_blocks"]),
                       "--max-num-seqs", "8", "--max-model-len", "2048", "--decode-steps", "8",
                       "--seed", "0"]
        ref, ref_counts, lp_ids = asyncio.run(_tok_reference(
            cfg, path, card, tok, bodies, prompt_tokens, geo["num_kv_blocks"], device, dtype))
        t0 = time.perf_counter()
        for ids in lp_ids:
            ds = DecodeStream(tok)
            for t in ids:
                ds.step(t)
            ds.flush()
        decode_us = (time.perf_counter() - t0) / sum(len(i) for i in lp_ids) * 1e6
        if device == "cuda":
            import torch

            torch.cuda.empty_cache()

        store_port = _free_port()
        store_url = f"tcp://127.0.0.1:{store_port}"
        store = Proc("tok-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                   "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        sys_port = _free_port()
        worker = Proc("tok-worker", [
            "dynamo_tpu_torch.worker", "--store-url", store_url, "--model-path", path,
            "--quant", "int8", "--kv-quant", "int8", "--dtype", dtype, "--device", device,
            *engine_argv], env={"DYNTPU_SYSTEM_ENABLED": "1", "DYNTPU_SYSTEM_PORT": str(sys_port)})
        procs.append(worker)
        _, registered_s = worker.wait_for(r"serving " + re.escape(name), 600)
        fe = Proc("tok-frontend", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                                   "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"])
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))
        got = asyncio.run(_tok_http(port, name, bodies))
        fe_load = next((float(m.group(1)) for m in (
            re.search(r"tokenizer hf:\S+ loaded in ([0-9.]+)s", line) for line in fe.lines) if m),
            None)
        if fe_load is None:
            raise RuntimeError("tok: the frontend logged no tokenizer load")
        for i, (r, want) in enumerate(zip(got, ref)):
            if r["status"] != 200 or r.get("error") or r["finish"] != "length":
                raise RuntimeError(f"tok request {i}: {r['status']} {r.get('error')} "
                                   f"{r.get('finish')!r}")
            if (r["logprobs"] != want["logprobs"] or r["lp_tokens"] != want["lp_tokens"]
                    or r["text"] != want["text"]):
                raise RuntimeError(f"tok request {i}: token texts or logprobs differ from the "
                                   "in-process engine's on the same checkpoint and tokenizer")
            if r["usage"]["prompt_tokens"] != prompt_tokens[i]:
                raise RuntimeError(f"tok request {i}: usage.prompt_tokens "
                                   f"{r['usage']['prompt_tokens']} != {prompt_tokens[i]}")
        time.sleep(1.0)  # the burst's last in-flight windows drain
        worker.proc.send_signal(signal.SIGUSR1)
        m, _ = worker.wait_for(r'^(\{"event": "engine_counters".*\})$', 60)
        counters = json.loads(m.group(1))
        got_counts = (counters["paged_attention_launches"], counters["int8_matmul_launches"],
                      counters["int8_matmul_prefill_launches"])
        want_counts = _ckpt_counts(cfg, counters["decode_substeps"], device, prompt_tokens)
        if got_counts != want_counts:
            raise RuntimeError(f"tok: worker launches (attention, int8 kernel, int8 prefill) "
                               f"{got_counts} != {want_counts}")
        mixed = asyncio.run(_tok_mixed(port, sys_port, name, batch_prompts, inter_prompt,
                                       geo["batch_max_tokens"]))
        rcs = {p.name: p.stop() for p in [fe, worker, store]}
        if any(rcs.values()):
            raise RuntimeError(f"tok: processes did not exit 0 on SIGTERM: {rcs}")
        final = next(json.loads(line) for line in reversed(worker.lines)
                     if line.startswith('{"event": "engine_counters"'))
        if final["paged_attention_launches"] != (
                cfg.num_layers * final["decode_substeps"] if device == "cuda" else 0):
            raise RuntimeError(f"tok: worker attention launches {final} != layers x substeps")
        log(f"tok: {len(bodies)} aggregate requests (4 chat, 4 completions) through worker "
            f"--model-path --quant int8 --kv-quant int8 with no --tokenizer, each bit-equal to "
            f"the in-process engine on the port tokenizer's ids (token texts and logprobs), "
            f"prompt tokens {prompt_tokens}; worker launches {got_counts} (attention, int8 "
            f"kernel, int8 prefill route) for {counters['decode_substeps']} substeps; "
            f"in-process {ref_counts}; mixed priority: {mixed['preempted_batch']} batch "
            f"preemption(s), the interactive stream equal to its solo run ({card_line})")
        log(f"tok: host CPU beside {card_line}: tokenizer load {fe_load:.3f}s in the frontend, "
            f"{load_s:.3f}s in process; encode {cold_s / n_tok * 1e6:.2f} us/token cold, "
            f"{warm_s / n_tok * 1e6:.2f} warm, {chars / n_tok:.3f} chars/token over the "
            f"{len(prompts)} prompts ({n_tok} tokens); DecodeStream {decode_us:.2f} us/token "
            f"over {sum(len(i) for i in lp_ids)} tokens; worker registered {registered_s:.1f}s "
            f"after launch")
        return {"name": name, "ids": wrote["ids"], "learned_tokens": wrote["learned_tokens"],
                "merges": wrote["merges"], "write_s": write_s, "load_s_inproc": load_s,
                "load_s_frontend": fe_load, "encode_us_per_token_cold": cold_s / n_tok * 1e6,
                "encode_us_per_token_warm": warm_s / n_tok * 1e6, "chars_per_token": chars / n_tok,
                "decode_stream_us_per_token": decode_us, "prompt_tokens": prompt_tokens,
                "launch_to_registered_s": registered_s, "num_kv_blocks": geo["num_kv_blocks"],
                "launches": got_counts, "decode_substeps": counters["decode_substeps"],
                "inproc_launches": ref_counts, "mixed": mixed,
                "latency_s": [r["latency_s"] for r in got]}
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(path, ignore_errors=True)


async def _tok_reference(cfg, path, card, tok, bodies, prompt_tokens, num_kv_blocks, device,
                         dtype):
    """Phase 9's requests through an in-process engine on the loaded
    weights with the worker's engine arguments → (choice views, launches,
    generated token ids)."""
    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.loader import load_model
    from dynamo_tpu_torch.llm.protocols import ChatCompletionRequest, CompletionRequest
    from dynamo_tpu_torch.ops import int8_matmul as im
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.run.__main__ import LocalPipeline
    from dynamo_tpu_torch.runtime.engine import Context

    _, params = await asyncio.to_thread(load_model, path, dtype, "int8", device)
    engine = await TorchEngine(EngineArgs(
        model=cfg, block_size=16, num_kv_blocks=num_kv_blocks, max_num_seqs=8,
        max_model_len=2048, decode_steps=8, dtype=dtype, quant="int8", kv_quant="int8",
        device=device), params=params).start()
    del params
    pipe = LocalPipeline(card, engine, tok)
    await asyncio.to_thread(engine.runner.warm_windows, ("greedy", "simple"))
    pa.launches = im.launches = im.prefill_launches = 0
    steps0 = engine.total_decode_steps

    async def one(body):
        chat = "messages" in body
        req = (ChatCompletionRequest if chat else CompletionRequest).parse(body)
        gen = None
        async for g, _chunk in pipe.run(req, Context()):
            gen = g
        view = choice_view("chat" if chat else "completion", gen.final_response()["choices"][0])
        return view, list(gen.lp_tokens)

    try:
        out = await asyncio.gather(*(one(b) for b in bodies))
        while engine.busy():
            await asyncio.sleep(0.001)
        counts = (pa.launches, im.launches, im.prefill_launches)
        want = _ckpt_counts(cfg, engine.total_decode_steps - steps0, device, prompt_tokens)
        if counts != want:
            raise RuntimeError(f"tok in process: launches {counts} != {want}")
    finally:
        await engine.stop()
    return [v for v, _ in out], counts, [ids for _, ids in out]


async def _wait_listed(port: int, model: str) -> None:
    for _ in range(600):
        _, _, pieces, _ = await http_request(port, "/v1/models", method="GET")
        if [m["id"] for m in json.loads(b"".join(p for _, p in pieces))["data"]] == [model]:
            return
        await asyncio.sleep(0.1)
    raise RuntimeError(f"the frontend never listed {model}")


async def _tok_http(port: int, model: str, bodies: list[dict]) -> list[dict]:
    await _wait_listed(port, model)
    return await asyncio.gather(*(http_completion(port, b, f"{0xF00 + i:032x}")
                                  for i, b in enumerate(bodies)))


async def _preemptions(sys_port: int) -> dict[str, float]:
    _, _, pieces, _ = await http_request(sys_port, "/metrics", method="GET")
    text = b"".join(p for _, p in pieces).decode()
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^dynamo_tpu_engine_preemptions_total\{class="(\w+)"\} ([0-9.eE+-]+)$', text, re.M)}


async def _tok_mixed(port: int, sys_port: int, model: str, batch_prompts: list[str],
                     inter_prompt: str, batch_max_tokens: list[int]) -> dict:
    """Two batch requests whose KV outgrows the pool, then an interactive
    one: a batch sequence is preempted (engine_preemptions_total{class=
    "batch"} rises, the interactive class's does not), and the interactive
    response equals its solo run, both cold (token texts and logprobs)."""
    def inter(tag):
        return http_completion(port, {
            "model": model, "prompt": inter_prompt, "max_tokens": BURST_TOKENS,
            "temperature": 0.0, "seed": 7, "ignore_eos": True, "logprobs": 0,
            "priority": "interactive"}, tag)

    solo = await inter(f"{0xF10:032x}")
    await clear_kv(port, model, workers=1)
    before = await _preemptions(sys_port)
    batch = [asyncio.ensure_future(http_completion(port, {
        "model": model, "prompt": p, "max_tokens": n, "temperature": 0.0, "seed": 8 + i,
        "ignore_eos": True, "priority": "batch"}, f"{0xF20 + i:032x}"))
        for i, (p, n) in enumerate(zip(batch_prompts, batch_max_tokens))]
    await asyncio.sleep(0.5)  # both batch requests admitted
    mixed = await inter(f"{0xF30:032x}")
    done = await asyncio.gather(*batch)
    after = await _preemptions(sys_port)
    rose = after.get("batch", 0.0) - before.get("batch", 0.0)
    for r, n in zip(done, batch_max_tokens):
        if r["status"] != 200 or r["usage"]["completion_tokens"] != n:
            raise RuntimeError(f"tok mixed: a batch request ended {r['status']} {r.get('usage')}")
    if rose < 1 or after.get("interactive", 0.0) != before.get("interactive", 0.0):
        raise RuntimeError(f"tok mixed: preemptions by class {before} → {after}")
    for r in (solo, mixed):
        if r["status"] != 200 or r["finish"] != "length":
            raise RuntimeError(f"tok mixed: interactive {r['status']} {r.get('error')}")
    if (mixed["logprobs"], mixed["lp_tokens"]) != (solo["logprobs"], solo["lp_tokens"]):
        raise RuntimeError("tok mixed: the interactive stream differs from its solo run")
    return {"preempted_batch": rose, "batch_max_tokens": batch_max_tokens,
            "interactive_latency_s": mixed["latency_s"], "solo_latency_s": solo["latency_s"]}


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
    int8_cases, int8_substep = int8_kernel_phase(device, card_line)
    stats, reference = asyncio.run(main_path(card_line))
    int8_runs = {}
    for kv_quant in ("none", "int8"):
        int8_runs[kv_quant], _ = asyncio.run(main_path(card_line, quant="int8", kv_quant=kv_quant))
        torch.cuda.empty_cache()
    for kv_quant, st in int8_runs.items():
        log(f"int8 vs bf16 ({kv_quant} KV pages for int8): tokens/s {st['tokens_per_s']:.1f} vs "
            f"{stats['tokens_per_s']:.1f}, host ms per substep {st['substep_ms']:.3f} vs "
            f"{stats['substep_ms']:.3f}, simple replay {st['replay_ms_per_substep_simple']:.3f} "
            f"vs {stats['replay_ms_per_substep_simple']:.3f} ms per substep, peak memory "
            f"{st['max_mem_gib']:.2f} vs {stats['max_mem_gib']:.2f} GiB, graph pool "
            f"{st['graph_pool_bytes'] / 2**20:.1f} vs {stats['graph_pool_bytes'] / 2**20:.1f} MiB "
            f"({card_line})")
    small_reference(device)
    frames = msgpack_frame_us()
    log("wire: msgpack_lite pack+unpack per frame: " + ", ".join(
        f"{k} {v['us']:.1f} us ({v['bytes']} bytes)" for k, v in frames.items())
        + f" (host CPU beside {card_line})")
    torch.cuda.empty_cache()
    http = http_phase(card_line, reference, stats["tokens_per_s"])
    http["msgpack_lite"] = frames
    ckpt = checkpoint_phase(card_line, keep=True)
    tok = tokenizer_phase(card_line, ckpt.pop("path"), ckpt.pop("cfg"))

    head = cases[0]  # decode on bf16 pages: the main path's mode
    burst = cases[-1]  # the same at the burst's row lengths
    entry = {
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "version": KERNEL_VERSION, "splits": burst["splits"],
        "launches": stats["launches"], "launches_http": http["launches"],
        "launches_tokenizer_worker": tok["launches"][0],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "cases": cases,
    }
    i8 = next(r for r in int8_cases if r["case"] == "w_gate_up_M8_bfloat16")
    int8_entry = {
        "name": "int8_matmul", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES, "launches": int8_runs["none"]["int8_launches"],
        "prefill_route_launches": int8_runs["none"]["int8_prefill_launches"],
        "launches_kv_int8": int8_runs["int8"]["int8_launches"],
        "launches_checkpoint_worker": ckpt["launches"][1],
        "launches_tokenizer_worker": tok["launches"][1],
        "max_abs_err": i8["max_abs_err"], "ms": i8["ms"], "plain_ms": i8["plain_ms"],
        "bound_ms": i8["bound_ms"], "bound_by": i8["bound_by"], "library_ms": i8["library_ms"],
        "case": i8["case"], "substep_225_calls": int8_substep, "cases": int8_cases,
    }
    log("main_path: " + json.dumps(stats))
    for kv_quant, st in int8_runs.items():
        log(f"main_path_int8_kv{kv_quant}: " + json.dumps(st))
    log("http_path: " + json.dumps(http))
    log("checkpoint_path: " + json.dumps(ckpt))
    log("tokenizer_path: " + json.dumps(tok))
    print(json.dumps({"kernels": [entry, int8_entry]}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
