"""Where the int8 weight product's time goes, on the card.

    python -m dynamo_tpu_torch.ops.profile_int8_matmul [--sweep] [--m 8]
    python -m dynamo_tpu_torch.ops.profile_int8_matmul --substeps 8,32,64,128,256
    python -m dynamo_tpu_torch.ops.profile_int8_matmul --tied

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
the rows each pads). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

import chip_smoke as cs
from dynamo_tpu_torch.ops import int8_matmul as im

LAYERS = 32


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
