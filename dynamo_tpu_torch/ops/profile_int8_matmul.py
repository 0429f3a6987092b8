"""Where the int8 weight product's time goes, on the card.

    python -m dynamo_tpu_torch.ops.profile_int8_matmul [--sweep] [--m 8]
    python -m dynamo_tpu_torch.ops.profile_int8_matmul --substeps 8,32,64,128,256
    python -m dynamo_tpu_torch.ops.profile_int8_matmul --tied
    python -m dynamo_tpu_torch.ops.profile_int8_matmul --trace
    python -m dynamo_tpu_torch.ops.profile_int8_matmul --versus [--sweep]
    python -m dynamo_tpu_torch.ops.profile_int8_matmul --variants pdl,spread [--window-too]

Run from the repository root (inputs come from chip_smoke.py's
``int8_case``). For each llama-8b decode shape it prints the call's
CUDA-event time (L2 flushed first, as chip_smoke.py times it) with the
wrapper's split plan, and with ``--sweep`` with every other split count
too. Then one decode substep's 225 products (7 per layer over 32 layers
of distinct llama-8b-sized int8 weights, then lm_head with f32 out), all
captured in one CUDA graph: the device time of a replay through the
wrapper (the decode kernel at M <= 8, the wide entry above), its plain
version, dequantize + ``torch.matmul`` (the prefill route, inline), the
same products with bf16 weights through ``torch.matmul`` (the library
yardstick), and the bound (weight bytes at 3.35 TB/s or operations at 989
TFLOP/s, whichever is larger). ``--substeps`` runs only that graph, at
each row count given. ``--window``
instead times one "simple" decode window of llama-8b (all 32 layers,
random weights made on the card, chip_smoke.py's window at the burst's
row lengths) with bf16 and with int8 weights in turns (bf16, int8, int8,
bf16; 20 CUDA-event replays each), and profiles one replay of each by
kernel family: the substep's device time with and without the int8
product, within one call. ``--tied`` times the tied head (the int8
embedding [V, D] used as emb.T, f32 logits) at chip_smoke.py's
``TIED_CASES`` (llama-3b at 1-256 rows, llama-1b at 8, f32 x at 8), in
turns (kernel, library, library, kernel): the wrapper (the tied wgmma
entry for bf16 x), its plain version, dequantize + ``torch.matmul`` (the
prefill route), bf16 ``torch.matmul`` on the dequantized head (the library
yardstick) and the bound; then, past 256 rows, the tied wgmma entry with
row tiles of 128 and of 256 in turns (the choice ``tied_plan`` makes from
the rows each pads). ``--trace`` builds copies of the source with
``%globaltimer`` stamps, one in the split-K decode kernel and its merge
kernel (one block's start, each k tile landed, the loop's end, its
partials written; every block's first start and last end through
atomics), one in the decode entry (one block's start, each k tile landed,
the loop's end, its k quarters summed, the cluster barrier passed, its
outputs written), and prints, for each llama-8b shape at ``--m`` rows
(and the decode entry's two groups), cold (L2 flushed) and warm: the
kernel's span, the traced block's first tile, its steady time per tile
and the phases of its end, and the merge kernel's start and span after
the split kernel; then one replay of each's 225-product graph under
torch.profiler, by kernel name (device ms and launches; a programmatic
dependent launch counts the time it waits for the kernel before it).
``--versus`` times, at M = 1 and 8, each product and the two groups on
the split-K kernel (one call a weight) and on the decode entry, in turns,
with ``--sweep`` the decode entry at every cluster rank count, beside
library and bound, and the 225 products as one graph both ways, in turns.
``--variants`` compares the shipped decode entry with builds of it that
differ in one decision (``pdl``: a programmatic dependent launch whose
producer issues the first weights before waiting for the kernel before
it; ``spread`` / ``spread2``: launches of up to one block an SM ask for
shared memory that keeps them one / two to an SM; ``stagesN``: another ring depth; ``split_k``: the split-K kernel in
its place; ``plan3``: cluster ranks that fill three blocks an SM; ``a+b``
both), in round robin, per case and as the 225-product graph
(``--window-too``: and as one int8 window). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

import chip_smoke as cs
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import int8_matmul as im

LAYERS = 32

# Stamps inserted into a copy of csrc/int8_matmul.cu: (anchor text, stamped
# text). Slots 0-44: the traced block (start, k tile i landed at 1 + i, the
# loop's end at 45, its last write at 46); 50-52: the merge kernel's block
# 0 (start, griddepcontrol.wait returned, end); 60/61 and 62/63: the first
# start and last end of any block of the split and the merge kernel.
_TRACE_HEAD = '''
__device__ unsigned long long dtpu_trace[64];
__device__ __forceinline__ unsigned long long dtpu_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define TRACE(i) do { if (TR) dtpu_trace[(i)] = dtpu_now(); } while (0)
'''
_TRACE_POINTS = [
    ("namespace {\n", "namespace {\n" + _TRACE_HEAD),
    ("  const int cw = ch * 16 + g;               // its A rows' column words\n",
     "  const int cw = ch * 16 + g;               // its A rows' column words\n"
     "  const bool TR = threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0;\n  TRACE(0);\n"
     "  if (threadIdx.x == 0) atomicMin(&dtpu_trace[60], dtpu_now());\n"),
    ("    const bf16* xs = reinterpret_cast<const bf16*>(st + BK * WROW);\n",
     "    const bf16* xs = reinterpret_cast<const bf16*>(st + BK * WROW);\n"
     "    if (i < 44) TRACE(1 + i);\n"),
    ("  finish<bf16, MP, 2>(p, red, n0, 0, s);\n",
     "  TRACE(45);\n  finish<bf16, MP, 2>(p, red, n0, 0, s);\n  TRACE(46);\n"
     "  if (threadIdx.x == 0) atomicMax(&dtpu_trace[61], dtpu_now());\n"),
    ('  asm volatile("griddepcontrol.wait;\\n" ::: "memory");  // the partials are complete\n',
     "  const bool TM = threadIdx.x == 0;\n"
     "  if (TM && blockIdx.x == 0) dtpu_trace[50] = dtpu_now();\n"
     "  if (TM) atomicMin(&dtpu_trace[62], dtpu_now());\n"
     '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");  // the partials are complete\n'
     "  if (TM && blockIdx.x == 0) dtpu_trace[51] = dtpu_now();\n"),
    ("  epilogue<XT>(p, static_cast<int>(idx / p.N), static_cast<int>(idx % p.N), v);\n}\n",
     "  epilogue<XT>(p, static_cast<int>(idx / p.N), static_cast<int>(idx % p.N), v);\n"
     "  if (TM) atomicMax(&dtpu_trace[63], dtpu_now());\n"
     "  if (TM && blockIdx.x == 0) dtpu_trace[52] = dtpu_now();\n}\n"),
]
# The decode entry's stamps: the traced block is rank 0 of column block 0,
# its thread 0 a consumer (start, k tile i landed at 1 + i, the loop's end
# at 45, its k quarters summed at 46, past the cluster barrier at 47, its
# outputs written at 48); 60/61 every block's first start and last end.
_TRACE_POINTS_DECODE = [
    ("namespace {\n", "namespace {\n" + _TRACE_HEAD),
    ("  // The partial sums of the block: [4 k quarters][8 x rows][D_BN] f32 over\n",
     "  const bool TR = threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0;\n  TRACE(0);\n"
     "  if (threadIdx.x == 0) atomicMin(&dtpu_trace[60], dtpu_now());\n"
     "  // The partial sums of the block: [4 k quarters][8 x rows][D_BN] f32 over\n"),
    ("      mbar_wait(full + st, (i / D_STAGES) & 1);\n      const uint8_t* wt = smem + st * D_STAGE;\n",
     "      mbar_wait(full + st, (i / D_STAGES) & 1);\n      const uint8_t* wt = smem + st * D_STAGE;\n"
     "      if (i < 44) TRACE(1 + i);\n"),
    ("    // Every TMA copy has landed and every consumer is past the ring: stage 0\n",
     "    TRACE(45);\n"
     "    // Every TMA copy has landed and every consumer is past the ring: stage 0\n"),
    ("  if (ranks > 1)\n    cluster_sync();\n  else\n    __syncthreads();\n",
     "  TRACE(46);\n  if (ranks > 1)\n    cluster_sync();\n  else\n    __syncthreads();\n  TRACE(47);\n"),
    ("  if (ranks > 1) cluster_sync();\n}\n",
     "  TRACE(48);\n  if (ranks > 1) cluster_sync();\n"
     "  if (threadIdx.x == 0) atomicMax(&dtpu_trace[61], dtpu_now());\n}\n"),
]
_TRACE_IO = '''
extern "C" int dtpu_trace_read(unsigned long long* h) {
  return cudaMemcpyFromSymbol(h, dtpu_trace, sizeof(unsigned long long) * 64);
}
extern "C" int dtpu_trace_reset() {
  unsigned long long h[64] = {};
  h[60] = h[62] = ~0ull;
  return cudaMemcpyToSymbol(dtpu_trace, h, sizeof(h));
}
'''


def _with_splits(splits: int, fn):
    """``fn()`` with every split plan (the decode kernel's and the wide
    entry's) forced to ``splits``."""
    keep = im.split_k, im.wide_plan
    im.split_k = lambda K, N: splits
    im.wide_plan = lambda M, K, N: (*keep[1](M, K, N)[:2], splits)
    try:
        return fn()
    finally:
        im.split_k, im.wide_plan = keep


def _graph_ms(calls, reps: int = 20) -> float:
    """Device ms of one replay of ``calls`` (a list of thunks) captured as
    one CUDA graph, the median of ``reps`` CUDA-event timings."""
    return _replay_ms(_capture(calls), reps)


def substep(dev, M: int, card: str) -> dict:
    """The 225 products of one substep at M rows as one graph, four ways:
    the int8 wrapper (the decode kernel at M <= 8, the wide entry above),
    its plain version, dequantize + ``torch.matmul`` (the prefill route,
    inline) and bf16 ``torch.matmul`` (the library); and the bound."""
    xs = {K: torch.randn((M, K), device=dev).to(torch.bfloat16)
          for K, _, _ in cs.INT8_SHAPES.values()}
    out = {}
    for kind in ("int8", "plain", "dequant", "bf16"):
        weights = []
        g = torch.Generator(device=dev).manual_seed(1)
        for _layer in range(LAYERS):
            for name, (K, N, _) in cs.INT8_SHAPES.items():
                if name == "lm_head":
                    continue
                reps = 2 if name in ("wq_wo", "wk_wv", "w_gate_up") else 1
                for _ in range(reps):
                    w = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
                    weights.append((w if kind != "bf16" else w.to(torch.bfloat16), K, N, False))
        K, N, _ = cs.INT8_SHAPES["lm_head"]
        w = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        weights.append((w if kind != "bf16" else w.to(torch.bfloat16), K, N, True))
        scales = {N: torch.rand((N,), device=dev) * 0.01 for _, _, N, _ in weights}
        if kind == "int8":
            calls = [lambda w=w, K=K, N=N, f=f: im.int8_matmul(xs[K], w, scales[N], out_f32=f)
                     for w, K, N, f in weights]
        elif kind == "plain":
            calls = [lambda w=w, K=K, N=N, f=f: im.int8_matmul_ref(xs[K], w, scales[N], out_f32=f)
                     for w, K, N, f in weights]
        elif kind == "dequant":
            calls = [lambda w=w, K=K, N=N, f=f: (
                torch.matmul(xs[K], w.to(torch.bfloat16)).float() * scales[N] if f else
                torch.matmul(xs[K], w.to(torch.bfloat16)) * scales[N].to(torch.bfloat16))
                for w, K, N, f in weights]
        else:
            calls = [lambda w=w, K=K: torch.matmul(xs[K], w) for w, K, _, _ in weights]
        assert len(calls) == 7 * LAYERS + 1
        out[kind] = _graph_ms(calls)
        del weights, calls
        torch.cuda.empty_cache()
    nbytes = sum(K * N * calls for K, N, calls in cs.INT8_SHAPES.values())
    flops = sum(2 * M * K * N * calls for K, N, calls in cs.INT8_SHAPES.values())
    t_bytes = nbytes / cs.HBM_BYTES_PER_S * 1e3
    t_ops = flops / cs.PEAK_OPS["bfloat16"] * 1e3
    out["bound"], out["bound_by"] = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"
    print(f"substep (M={M}, 225 products in one graph): int8 wrapper {out['int8']:.3f} ms, "
          f"plain {out['plain']:.3f}, dequantize + torch.matmul {out['dequant']:.3f}, bf16 "
          f"torch.matmul {out['bf16']:.3f}, bound {out['bound']:.3f} ({out['bound_by']}) "
          f"({card})", flush=True)
    return out


def window(card: str) -> None:
    """bf16 vs int8 weights: one simple window's replay, in turns."""
    import statistics

    from dynamo_tpu_torch.engine import model as M
    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
    from dynamo_tpu_torch.engine.runner import LocalRunner

    cfg = ModelConfig.preset("llama-8b")
    runners, kws = {}, {}
    for quant in ("none", "int8"):
        args = EngineArgs(model=cfg, block_size=16, num_kv_blocks=256, max_num_seqs=8,
                          max_model_len=2048, decode_steps=8, dtype="bfloat16", device="cuda",
                          quant=quant)
        r = LocalRunner(args, params=None if quant == "int8" else M.init_params(
            cfg, torch.device("cuda"), torch.bfloat16, seed=0))
        r.start()
        runners[quant] = r
        kws[quant] = dict(cs.window_inputs(r, "simple", 61, lens=cs.BURST_HIST[:6]), top_n=0)
    times = {"none": [], "int8": []}
    for quant in ("none", "int8", "int8", "none"):
        times[quant] += [cs.replay_ms(runners[quant], kws[quant]) for _ in range(4)]
    for quant, label in (("none", "bf16"), ("int8", "int8")):
        print(f"window ({label} weights): {statistics.median(times[quant]):.3f} ms device time per "
              f"substep as one graph replay (median of {len(times[quant])} medians of 5; "
              f"{min(times[quant]):.3f}-{max(times[quant]):.3f}) ({card})", flush=True)
        cs.profile_replay(runners[quant], kws[quant], card)


def _with_tied_tile(tile: int, fn):
    """``fn()`` with the tied wgmma entry's row tile forced to ``tile``."""
    keep = im.tied_plan

    def plan(M, N):
        row_tiles = -(-M // tile)
        tiles = -(-N // im.TIED_BN) * row_tiles
        blocks = min(tiles, im.SMS * im.TIED_BLOCKS_PER_SM)
        return tile, row_tiles, blocks, -(-tiles // blocks)

    im.tied_plan = plan
    try:
        return fn()
    finally:
        im.tied_plan = keep


def tied(dev, card: str) -> None:
    """The tied head at chip_smoke.py's cases: kernel and library in turns
    (the medians of two timings each), plain, dequantize + matmul, bound;
    then row tiles of 128 and 256 past 256 rows, in turns."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for i, (name, M, xdt) in enumerate(cs.TIED_CASES):
        K, N = cs.TIED_HEADS[name]
        x, wt, s = cs.int8_tied_case(M, K, N, xdt, 700 + i, dev)
        wb = wt.to(x.dtype)
        kernel = lambda: im.int8_matmul(x, wt, s, out_f32=True)  # noqa: E731
        library = lambda: torch.matmul(x, wb)  # noqa: E731
        t = {"kernel": [], "library": []}
        for which in ("kernel", "library", "library", "kernel"):
            t[which].append(cs.time_ms(kernel if which == "kernel" else library, flush))
        plain = cs.time_ms(lambda: im.int8_matmul_ref(x, wt, s, out_f32=True), flush)
        dequant = cs.time_ms(lambda: torch.matmul(x, wt.to(x.dtype)).float() * s, flush)
        b_ms, b_by = cs.int8_bound(M, K, N, x.element_size(), 4, 4, xdt)
        print(f"tied {name} [{N}, {K}] M={M} {xdt} ({im.route(x, wt)}, plan "
              f"{im.tied_plan(M, N) if im.route(x, wt) == 'tied_wide' else None}): kernel "
              f"{' / '.join(f'{v:.4f}' for v in t['kernel'])} ms, library "
              f"{' / '.join(f'{v:.4f}' for v in t['library'])}, plain {plain:.4f}, dequantize + "
              f"torch.matmul {dequant:.4f}, bound {b_ms:.4f} ({b_by}) ({card})", flush=True)
        del x, wt, s, wb
    K, N = cs.TIED_HEADS["llama-3b"]
    for M in (129, 257, 384, 512):
        x, wt, s = cs.int8_tied_case(M, K, N, "bfloat16", 900 + M, dev)
        t = {128: [], 256: []}
        for tile in (128, 256, 256, 128):
            t[tile].append(_with_tied_tile(tile, lambda: cs.time_ms(
                lambda: im.int8_matmul(x, wt, s, out_f32=True), flush)))
        print(f"tied llama-3b M={M}: row tile 128 {' / '.join(f'{v:.4f}' for v in t[128])} ms, "
              f"256 {' / '.join(f'{v:.4f}' for v in t[256])} (the plan's: "
              f"{im.tied_plan(M, N)[0]}) ({card})", flush=True)
        del x, wt, s


def _traced_library(name: str, points, io: str) -> ctypes.CDLL:
    """Build a copy of csrc/int8_matmul.cu with the stamps ``points`` and the
    read/reset entry points ``io`` into build/kernels/trace/; raise if an
    anchor is missing from the source."""
    src = (_build.CSRC / "int8_matmul.cu").read_text()
    for anchor, stamped in points:
        if src.count(anchor) != 1:
            raise RuntimeError(f"trace anchor not found once in the kernel source: {anchor!r}")
        src = src.replace(anchor, stamped, 1)
    out = _build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src + io)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.dtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dtpu_cuda_error_string.restype = ctypes.c_char_p
    if io:
        lib.dtpu_trace_read.argtypes = [ctypes.c_void_p]
    return lib


def _stamped_runs(lib, call, flush) -> dict:
    """``call()`` once cold (L2 flushed) and once warm after three warm-up
    calls, on the traced library → {"cold"/"warm": the 64 stamps (ns)}."""
    keep = _build._libs.get("int8_matmul")
    _build._libs["int8_matmul"] = lib
    buf = (ctypes.c_ulonglong * 64)()
    out = {}
    try:
        for _ in range(3):
            call()
        for label in ("cold", "warm"):
            if label == "cold":
                flush.zero_()
            torch.cuda.synchronize()
            _build.check(lib, lib.dtpu_trace_reset(), "trace reset")
            call()
            torch.cuda.synchronize()
            _build.check(lib, lib.dtpu_trace_read(buf), "trace read")
            out[label] = list(buf)
    finally:
        if keep is None:
            _build._libs.pop("int8_matmul", None)
        else:
            _build._libs["int8_matmul"] = keep
    return out


def trace_v1(dev, M: int, card: str, flush) -> list[dict]:
    """Phase stamps of the split-K decode kernel and its merge at M rows for
    each llama-8b shape (the decode kernel taken directly: ``im._launch``)."""
    lib = _traced_library("int8_matmul_trace_v1", _TRACE_POINTS, _TRACE_IO)
    rows = []
    for name, (K, N, _) in cs.INT8_SHAPES.items():
        x, w, s = cs.int8_case(M, K, N, "bfloat16", 1, dev)
        f = name == "lm_head"
        splits = im.split_k(K, N)
        nt = -(-(-(-K // im.BK)) // splits)  # k tiles of split 0's blocks
        runs = _stamped_runs(lib, lambda: im._launch(x, w, s, f, M, K, N), flush)
        for label, t in runs.items():
            us = lambda a, b: (t[b] - t[a]) / 1e3  # noqa: E731
            r = {"shape": name, "K": K, "N": N, "M": M, "splits": splits, "tiles": nt,
                 "run": label, "split_kernel_us": us(60, 61),
                 "block_start_us": us(60, 0), "first_tile_us": us(0, 1),
                 "steady_us_per_tile": us(1, nt) / max(1, nt - 1),
                 "drain_us": us(nt, 46), "block_us": us(0, 46)}
            if splits > 1:
                r.update(merge_start_after_split_us=us(61, 62),
                         merge_wait_returned_after_split_us=us(61, 51),
                         merge_end_after_split_us=us(61, 63), total_us=us(60, 63))
            else:
                r["total_us"] = r["split_kernel_us"]
            rows.append(r)
            print(f"trace v1 {name} {K}x{N} M={M} splits {splits} ({nt} tiles a block), "
                  f"{label}: " + ", ".join(f"{k} {v:.2f}" for k, v in r.items()
                                           if k.endswith(("_us", "_per_tile")))
                  + f" ({card})", flush=True)
        del x, w, s
    return rows


def trace_decode(dev, M: int, card: str, flush) -> list[dict]:
    """Phase stamps of the decode entry at M rows for each llama-8b shape
    alone and for the two groups (q/k/v, gate/up)."""
    lib = _traced_library("int8_matmul_trace_decode", _TRACE_POINTS_DECODE, _TRACE_IO)
    rows = []
    for name, dims, f in _decode_cases():
        x, ws = _group_case(dev, M, dims)
        K = dims[0][0]
        ranks, per = im.cluster_plan(K, sum(-(-N // im.DECODE_BN) for _, N in dims))
        runs = _stamped_runs(lib, lambda: im.int8_matmul_group(x, ws, out_f32=f)
                             if len(ws) > 1 else im.int8_matmul(x, *ws[0], out_f32=f), flush)
        for label, t in runs.items():
            us = lambda a, b: (t[b] - t[a]) / 1e3  # noqa: E731
            r = {"case": name, "M": M, "ranks": ranks, "tiles": per, "run": label,
                 "kernel_us": us(60, 61), "block_start_us": us(60, 0),
                 "first_tile_us": us(0, 1), "steady_us_per_tile": us(1, per) / max(1, per - 1),
                 "last_tile_to_loop_end_us": us(per, 45), "quarters_summed_us": us(45, 46),
                 "cluster_barrier_us": us(46, 47), "reduce_and_store_us": us(47, 48),
                 "block_us": us(0, 48)}
            rows.append(r)
            print(f"trace decode entry {name} M={M} ranks {ranks} ({per} tiles a block), "
                  f"{label}: " + ", ".join(f"{k} {v:.2f}" for k, v in r.items()
                                           if k.endswith(("_us", "_per_tile")))
                  + f" ({card})", flush=True)
        del x, ws
    return rows


def _decode_cases():
    """(name, [(K, N)] of the weights that share x, logits out) of the
    llama-8b decode products, alone and in the model's two groups."""
    S = cs.INT8_SHAPES
    return [("wq_wo", [S["wq_wo"][:2]], False), ("wk_wv", [S["wk_wv"][:2]], False),
            ("w_gate_up", [S["w_gate_up"][:2]], False), ("w_down", [S["w_down"][:2]], False),
            ("lm_head", [S["lm_head"][:2]], True),
            ("qkv", [S["wq_wo"][:2], S["wk_wv"][:2], S["wk_wv"][:2]], False),
            ("gate_up", [S["w_gate_up"][:2]] * 2, False)]


def _group_case(dev, M: int, dims):
    """x [M, K] bf16 and the weights (w [K, N] int8, scale [N] f32) of
    ``dims``, seeded."""
    g = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn((M, dims[0][0]), generator=g, device=dev).to(torch.bfloat16)
    return x, [(torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
                torch.rand((N,), generator=g, device=dev) * 0.02 + 1e-3) for K, N in dims]


def _with_ranks(ranks: int, fn):
    """``fn()`` with the decode entry's cluster plan forced to ``ranks``
    (fewer where K has fewer tiles)."""
    keep = im.cluster_plan

    def plan(K, cols):
        tiles = -(-K // im.DECODE_BK)
        r = min(ranks, tiles)
        while r > 1 and (r - 1) * -(-tiles // r) >= tiles:
            r //= 2
        return r, -(-tiles // r)

    im.cluster_plan = plan
    try:
        return fn()
    finally:
        im.cluster_plan = keep


def versus(dev, card: str, flush, sweep: bool) -> list[dict]:
    """At M = 1 and 8, each llama-8b product and the two groups: the split-K
    kernel (one call per weight) and the decode entry in turns (split-K,
    decode, decode, split-K), with ``sweep`` the decode entry at every rank
    count too; library (bf16 ``torch.matmul`` per weight) and bound. Then
    the 225 products as one graph, split-K kernel against decode entry
    (grouped as the model groups them), in turns."""
    rows = []
    for M in (1, 8):
        for name, dims, f in _decode_cases():
            x, ws = _group_case(dev, M, dims)
            old = lambda: [im._launch(x, w, s, f, M, *w.shape) for w, s in ws]  # noqa: E731
            new = lambda: (im.int8_matmul_group(x, ws, out_f32=f) if len(ws) > 1  # noqa: E731
                           else im.int8_matmul(x, *ws[0], out_f32=f))
            t = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                t[which].append(cs.time_ms(old if which == "old" else new, flush))
            wbs = [w.to(torch.bfloat16) for w, _ in ws]
            lib = cs.time_ms(lambda: [torch.matmul(x, wb) for wb in wbs], flush)
            del wbs
            K = dims[0][0]
            bound = sum(cs.int8_bound(M, K, N, 2, 4 if f else 2, 4, "bfloat16")[0]
                        for _, N in dims)
            cols = sum(-(-N // im.DECODE_BN) for _, N in dims)
            r = {"case": name, "M": M, "split_k_ms": t["old"], "decode_ms": t["new"],
                 "library_ms": lib, "bound_ms": bound, "plan": im.cluster_plan(K, cols)}
            if sweep:
                r["by_ranks"] = {rk: _with_ranks(rk, lambda: cs.time_ms(new, flush))
                                 for rk in (1, 2, 4, 8)}
            rows.append(r)
            print(f"versus {name} M={M}: split-K kernel {' / '.join(f'{v:.4f}' for v in t['old'])} "
                  f"ms, decode entry {' / '.join(f'{v:.4f}' for v in t['new'])} (plan "
                  f"{r['plan']}), library {lib:.4f}, bound {bound:.4f}"
                  + (", by ranks " + ", ".join(f"{k}: {v:.4f}" for k, v in r["by_ranks"].items())
                     if sweep else "") + f" ({card})", flush=True)
            del x, ws
    for M in (1, 8):
        t = {"old": [], "new": []}
        graphs = {"old": _substep_graph(dev, M, grouped=False),
                  "new": _substep_graph(dev, M, grouped=True)}
        for which in ("old", "new", "new", "old"):
            t[which].append(graphs[which]())
        print(f"versus substep graph M={M} (225 products): split-K kernel "
              f"{' / '.join(f'{v:.3f}' for v in t['old'])} ms, decode entry "
              f"{' / '.join(f'{v:.3f}' for v in t['new'])} ({card})", flush=True)
        rows.append({"case": "substep_225", "M": M, "split_k_ms": t["old"], "decode_ms": t["new"]})
        del graphs
        torch.cuda.empty_cache()
    return rows


def _source_line(prefix: str) -> str:
    src = (_build.CSRC / "int8_matmul.cu").read_text()
    return next(ln for ln in src.splitlines() if ln.startswith(prefix))


# Builds of the decode entry the shipped one is compared with (``--variants``),
# each differing in one decision: name → (anchor, replacement) pairs applied to
# a copy of the source, or a patch of the wrapper in force while the build's
# calls run and its graphs are captured. "a+b" applies both.
_SPREAD = """  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  cfg.dynamicSmemBytes = ranks * p.col0[group] <= sms ? SPREAD_KB * 1024 : D_SMEM;
"""


_PDL = [
    # The producer issues the ring's first weights, then waits for the kernel
    # before (x may be its output), then loads x; it triggers its dependents
    # once every load is issued. The consumers wait before the scales.
    ("""      for (int i = 0; i < nt; ++i) {
        const int st = i % D_STAGES;
        if (i >= D_STAGES) mbar_wait(empty + st, (i / D_STAGES - 1) & 1);
        uint8_t* stage = smem + st * D_STAGE;
        const int k0 = (t0 + i) * D_BK;
        mbar_expect_tx(full + st, D_STAGE);
        tma_load_2d(stage, tw, n0, k0, full + st);
        tma_load_2d(stage + D_WBYTES, &p.tm_x, k0, 0, full + st);
""", """      for (int i = 0; i < min(nt, D_STAGES); ++i) {
        mbar_expect_tx(full + i, D_STAGE);
        tma_load_2d(smem + i * D_STAGE, tw, n0, (t0 + i) * D_BK, full + i);
      }
      asm volatile("griddepcontrol.wait;\\n" ::: "memory");
      for (int i = 0; i < nt; ++i) {
        const int st = i % D_STAGES;
        uint8_t* stage = smem + st * D_STAGE;
        const int k0 = (t0 + i) * D_BK;
        if (i >= D_STAGES) {
          mbar_wait(empty + st, (i / D_STAGES - 1) & 1);
          mbar_expect_tx(full + st, D_STAGE);
          tma_load_2d(stage, tw, n0, k0, full + st);
        }
        tma_load_2d(stage + D_WBYTES, &p.tm_x, k0, 0, full + st);
"""),
    ("""        tma_load_2d(stage + D_WBYTES + D_XBYTES / 2, &p.tm_x, k0 + D_XBOX, 0, full + st);
      }
    }
""", """        tma_load_2d(stage + D_WBYTES + D_XBYTES / 2, &p.tm_x, k0 + D_XBOX, 0, full + st);
      }
      asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");
    }
"""),
    ("    // The scales' load hides behind the first stage.\n",
     "    asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n"),
    ("""  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
""", """  cudaLaunchAttribute attr[2];
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  attr[0].id = cudaLaunchAttributeClusterDimension;
"""),
    ("  cfg.numAttrs = 1;\n  return cudaLaunchKernelEx(&cfg, int8_matmul_decode_kernel, p);",
     "  cfg.numAttrs = 2;\n  return cudaLaunchKernelEx(&cfg, int8_matmul_decode_kernel, p);"),
]


def _variant_points(name: str) -> list:
    points = []
    for part in name.split("+"):
        if part == "pdl":  # a programmatic dependent launch, weights before the wait
            points += _PDL
        elif part in ("spread", "spread2"):  # launches of no more blocks than SMs one
            kb = 116 if part == "spread" else 100  # (two) block(s) to an SM at most
            points += [("      int8_matmul_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,"
                        " D_SMEM);\n",
                        "      int8_matmul_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,"
                        f" {kb} * 1024);\n"),
                       ("  cfg.dynamicSmemBytes = D_SMEM;\n",
                        _SPREAD.replace("SPREAD_KB", str(kb)))]
        elif part.startswith("stages"):  # another ring depth, and the blocks an SM it leaves
            st = int(part.removeprefix("stages"))
            bps = 3 if st <= 4 else 2 if st <= 6 else 1
            points += [(_source_line("constexpr int D_STAGES = "),
                        f"constexpr int D_STAGES = {st};"),
                       (_source_line("constexpr int D_BLOCKS_PER_SM = "),
                        f"constexpr int D_BLOCKS_PER_SM = {bps};")]
        elif part not in _PATCHES:
            raise ValueError(f"unknown variant {part!r}")
    return points


def _plan_three_an_sm(K: int, col_blocks: int) -> tuple[int, int]:
    tiles = -(-K // im.DECODE_BK)
    want = min(im.DECODE_MAX_RANKS, tiles, max(1, im.SMS * 3 // col_blocks))
    ranks = 1 << (want.bit_length() - 1)
    while ranks > 1 and (ranks - 1) * -(-tiles // ranks) >= tiles:
        ranks //= 2
    return ranks, -(-tiles // ranks)


_PATCHES = {
    "split_k": ("decode_entry", lambda x, w: False),  # every product on the split-K kernel
    "plan3": ("cluster_plan", _plan_three_an_sm),     # ranks to fill three blocks an SM
}


class _patched:
    """The wrapper patches of a variant ``name``, in force inside ``with``."""

    def __init__(self, name: str):
        self.patches = [_PATCHES[p] for p in name.split("+") if p in _PATCHES]

    def __enter__(self):
        self.kept = [(attr, getattr(im, attr)) for attr, _ in self.patches]
        for attr, fn in self.patches:
            setattr(im, attr, fn)

    def __exit__(self, *exc):
        for attr, fn in self.kept:
            setattr(im, attr, fn)


def variants(dev, card: str, flush, names: list[str], window_too: bool) -> None:
    """The shipped decode entry and each variant of ``names`` in round
    robin (forward, then backward): every case of ``versus`` at M = 8 (L2
    flushed), the 225 products as one graph, and with ``window_too`` one
    int8 llama-8b "simple" window, each graph captured once per build."""
    keep = _build._libs.get("int8_matmul")
    libs = {"shipped": _build.library("int8_matmul")}
    for name in names:
        pts = _variant_points(name)
        libs[name] = (_traced_library("int8_matmul_" + name.replace("+", "_"), pts, "")
                      if pts else libs["shipped"])
    order = [*libs, *reversed(libs)]
    try:
        for case, dims, f in _decode_cases():
            x, ws = _group_case(dev, 8, dims)
            call = lambda: (im.int8_matmul_group(x, ws, out_f32=f) if len(ws) > 1  # noqa: E731
                            else im.int8_matmul(x, *ws[0], out_f32=f))
            t = {k: [] for k in libs}
            for label in order:
                _build._libs["int8_matmul"] = libs[label]
                with _patched(label):
                    t[label].append(cs.time_ms(call, flush))
            print(f"variants {case} M=8: " + "; ".join(
                f"{k} {' / '.join(f'{v:.4f}' for v in ts)}" for k, ts in t.items())
                + f" ms ({card})", flush=True)
            del x, ws
        weights = substep_weights(dev, 8)  # one set, read by every build's graph
        graphs, runners, kws, params = {}, {}, {}, None
        for label, lib in libs.items():
            _build._libs["int8_matmul"] = lib
            with _patched(label):
                graphs[label] = _capture(substep_calls(dev, 8, None, grouped=True,
                                                       weights=weights))
                if window_too:
                    runners[label], kws[label] = _int8_window_runner(params)
                    params = runners[label].params  # one set of weights for every runner
                    cs.replay_ms(runners[label], kws[label])  # captures it on this build
        t = {k: {"graph": [], "window": []} for k in libs}
        for label in order:
            t[label]["graph"].append(_replay_ms(graphs[label]))
            if window_too:
                t[label]["window"] += [cs.replay_ms(runners[label], kws[label]) for _ in range(3)]
        for label in libs:
            print(f"variants, {label}: 225 products as one graph "
                  f"{' / '.join(f'{v:.3f}' for v in t[label]['graph'])} ms"
                  + (f"; int8 window {' / '.join(f'{v:.3f}' for v in t[label]['window'])} "
                     "ms a substep" if window_too else "") + f" ({card})", flush=True)
    finally:
        if keep is None:
            _build._libs.pop("int8_matmul", None)
        else:
            _build._libs["int8_matmul"] = keep


def _int8_window_runner(params=None):
    """An int8 llama-8b runner (on ``params``, or random weights made on the
    card) and the keyword arguments of one "simple" window at the burst's
    row lengths."""
    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
    from dynamo_tpu_torch.engine.runner import LocalRunner

    args = EngineArgs(model=ModelConfig.preset("llama-8b"), block_size=16, num_kv_blocks=256,
                      max_num_seqs=8, max_model_len=2048, decode_steps=8, dtype="bfloat16",
                      device="cuda", quant="int8")
    r = LocalRunner(args, params=params)
    r.start()
    return r, dict(cs.window_inputs(r, "simple", 61, lens=cs.BURST_HIST[:6]), top_n=0)


def _capture(calls) -> "torch.cuda.CUDAGraph":
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    g.replay()
    return g


def _replay_ms(g, reps: int = 20) -> float:
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _substep_graph(dev, M: int, grouped: bool):
    """One substep's 225 products at M rows captured as one graph: the
    split-K kernel per product, or the decode entry grouped as the model
    groups them (q/k/v, gate/up) → a function timing one replay (the median
    of 20, ms)."""
    if grouped:
        calls = substep_calls(dev, M, None, grouped=True)
    else:
        calls = substep_calls(dev, M, lambda x, w, s, f: im._launch(x, w, s, f, x.shape[0],
                                                                     *w.shape))
    return lambda: _graph_ms(calls)


def by_kernel(calls, card: str, label: str) -> dict:
    """One replay of ``calls`` captured as one graph (after a warm replay),
    under torch.profiler: device ms and launches by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    g.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    rows = {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0}
    total = sum(v[0] for v in rows.values())
    n = sum(v[1] for v in rows.values())
    print(f"{label}: one replay {total:.3f} ms device time, {n} kernels ({card})", flush=True)
    for key, (ms, cnt) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:8.3f} ms {cnt:5d} launches  {key[:110]}", flush=True)
    return {"ms": total, "kernels": n, "by_kernel": {k: {"ms": v[0], "launches": v[1]}
                                                      for k, v in rows.items()}}


def substep_weights(dev, M: int):
    """Distinct random llama-8b int8 weights of one substep's 225 products,
    as the model groups them (per layer: wq, wk, wv; wo; w_gate, w_up;
    w_down; then lm_head), and bf16 x of M rows for each K."""
    S = cs.INT8_SHAPES
    xs = {K: torch.randn((M, K), device=dev).to(torch.bfloat16) for K, _, _ in S.values()}
    g = torch.Generator(device=dev).manual_seed(1)

    def weight(name):
        K, N, _ = S[name]
        return (torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
                torch.rand((N,), device=dev) * 0.01)

    layers = [[[weight("wq_wo"), weight("wk_wv"), weight("wk_wv")], [weight("wq_wo")],
               [weight("w_gate_up"), weight("w_gate_up")], [weight("w_down")]]
              for _ in range(LAYERS)]
    return xs, layers, weight("lm_head")


def substep_calls(dev, M: int, route, grouped: bool = False, weights=None) -> list:
    """One substep's 225 products at M rows (``weights``, or new ones from
    ``substep_weights``) as thunks calling ``route(x, w, scale, out_f32)``,
    or with ``grouped`` as the model calls them: a layer's wq, wk, wv as
    one ``int8_matmul_group`` call, wo, w_gate and w_up as one, w_down; then
    lm_head."""
    xs, layers, (w, s) = weights or substep_weights(dev, M)
    calls, products = [], 0
    for layer in layers:
        for ws in layer:
            x = xs[ws[0][0].shape[0]]
            products += len(ws)
            if grouped:
                calls.append(lambda x=x, ws=ws: im.int8_matmul_group(x, ws) if len(ws) > 1
                             else im.int8_matmul(x, *ws[0]))
            else:
                calls += [lambda x=x, w=w, s=s: route(x, w, s, False) for w, s in ws]
    x = xs[w.shape[0]]
    calls.append(lambda: im.int8_matmul(x, w, s, out_f32=True) if grouped else route(x, w, s, True))
    assert products + 1 == 7 * LAYERS + 1
    return calls


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true", help="time every split count too")
    ap.add_argument("--m", type=int, default=8, help="rows of x (the decode batch bucket)")
    ap.add_argument("--substeps", default="",
                    help="comma-separated row counts: only the 225-product graph at each")
    ap.add_argument("--window", action="store_true",
                    help="bf16 vs int8 weights: one llama-8b decode window, in turns")
    ap.add_argument("--tied", action="store_true",
                    help="the tied head (llama-3b, llama-1b) at chip_smoke.py's cases")
    ap.add_argument("--trace", action="store_true",
                    help="phase stamps of one block per shape, and the substep graph by kernel")
    ap.add_argument("--versus", action="store_true",
                    help="the split-K kernel against the decode entry, in turns")
    ap.add_argument("--variants", default="",
                    help="comma-separated builds of the decode entry to compare with the "
                         "shipped one: pdl, spread, stagesN, split_k, plan3, or a+b")
    ap.add_argument("--window-too", action="store_true",
                    help="with --variants: an int8 window per build too")
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.window:
        window(card)
        return
    if args.tied:
        tied(dev, card)
        return
    if args.trace:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        trace_v1(dev, args.m, card, flush)
        trace_decode(dev, args.m, card, flush)
        by_kernel(substep_calls(dev, args.m, lambda x, w, s, f: im._launch(
            x, w, s, f, x.shape[0], *w.shape)), card,
            f"substep graph, 225 products at M={args.m} on the split-K decode kernel")
        by_kernel(substep_calls(dev, args.m, None, grouped=True), card,
                  f"substep graph, 225 products at M={args.m} on the decode entry, grouped")
        return
    if args.variants:
        variants(dev, card, torch.empty(64 << 20, dtype=torch.uint8, device=dev),
                 args.variants.split(","), args.window_too)
        return
    if args.versus:
        versus(dev, card, torch.empty(64 << 20, dtype=torch.uint8, device=dev), args.sweep)
        return
    if args.substeps:
        for M in (int(m) for m in args.substeps.split(",")):
            substep(dev, M, card)
        return
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for name, (K, N, _) in cs.INT8_SHAPES.items():
        x, w, s = cs.int8_case(args.m, K, N, "bfloat16", 1, dev)
        f = name == "lm_head"
        wide = im.route(x, w) == "wide"
        plan = im.wide_plan(args.m, K, N)[2] if wide else im.split_k(K, N)
        tiles = -(-K // (im.WIDE_BK if wide else im.BK))
        options = sorted({plan} | ({s_ for s_ in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48)
                                    if s_ <= tiles and (s_ - 1) * -(-tiles // s_) < tiles}
                                   if args.sweep else set()))
        for splits in options:
            ms = _with_splits(splits, lambda: cs.time_ms(lambda: im.int8_matmul(x, w, s, out_f32=f),
                                                         flush))
            blocks = -(-N // im.BN) * splits * (im.wide_plan(args.m, K, N)[1] if wide else 1)
            print(f"{name} {K}x{N} M={args.m}: splits {splits:2d} ({blocks} blocks) "
                  f"{ms:.4f} ms{' (plan)' if splits == plan else ''} ({card})", flush=True)
    del flush
    substep(dev, args.m, card)


if __name__ == "__main__":
    main()
