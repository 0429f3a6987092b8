"""Where the int8 weight product's time goes, on the card.

    python -m dynamo_tpu_torch.ops.profile_int8_matmul [--sweep] [--m 8]

Run from the repository root (inputs come from chip_smoke.py's
``int8_case``). For each llama-8b decode shape it prints the call's
CUDA-event time (L2 flushed first, as chip_smoke.py times it) with the
wrapper's split plan, and with ``--sweep`` with every other split count
too. Then one decode substep's 225 products (7 per layer over 32 layers
of distinct llama-8b-sized int8 weights, then lm_head with f32 out), all
captured in one CUDA graph: the device time of a replay, against the same
products with bf16 weights through ``torch.matmul`` (the library
yardstick) and against the weight-byte bound at 3.35 TB/s. ``--window``
instead times one "simple" decode window of llama-8b (all 32 layers,
random weights made on the card, chip_smoke.py's window at the burst's
row lengths) with bf16 and with int8 weights in turns (bf16, int8, int8,
bf16; 20 CUDA-event replays each), and profiles one replay of each by
kernel family: the substep's device time with and without the int8
product, within one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

import chip_smoke as cs
from dynamo_tpu_torch.ops import int8_matmul as im

LAYERS = 32


def _with_splits(splits: int, fn):
    keep = im.split_k
    im.split_k = lambda K, N: splits
    try:
        return fn()
    finally:
        im.split_k = keep


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
    """The 225 products of one substep as one graph: int8 kernel, bf16
    library, bound."""
    xs = {K: torch.randn((M, K), device=dev).to(torch.bfloat16)
          for K, _, _ in cs.INT8_SHAPES.values()}
    out = {}
    for kind in ("int8", "bf16"):
        weights = []
        g = torch.Generator(device=dev).manual_seed(1)
        for _layer in range(LAYERS):
            for name, (K, N, _) in cs.INT8_SHAPES.items():
                if name == "lm_head":
                    continue
                reps = 2 if name in ("wq_wo", "wk_wv", "w_gate_up") else 1
                for _ in range(reps):
                    w = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
                    weights.append((w if kind == "int8" else w.to(torch.bfloat16), K, N, False))
        K, N, _ = cs.INT8_SHAPES["lm_head"]
        w = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        weights.append((w if kind == "int8" else w.to(torch.bfloat16), K, N, True))
        scales = {N: torch.rand((N,), device=dev) * 0.01 for _, _, N, _ in weights}
        if kind == "int8":
            calls = [lambda w=w, K=K, N=N, f=f: im.int8_matmul(xs[K], w, scales[N], out_f32=f)
                     for w, K, N, f in weights]
        else:
            calls = [lambda w=w, K=K: torch.matmul(xs[K], w) for w, K, _, _ in weights]
        assert len(calls) == 7 * LAYERS + 1
        out[kind] = _graph_ms(calls)
        del weights, calls
        torch.cuda.empty_cache()
    nbytes = sum(K * N * calls for K, N, calls in cs.INT8_SHAPES.values())
    out["bound"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
    print(f"substep (M={M}, 225 products in one graph): int8 kernel {out['int8']:.3f} ms, "
          f"bf16 torch.matmul {out['bf16']:.3f} ms, weight-byte bound {out['bound']:.3f} ms "
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true", help="time every split count too")
    ap.add_argument("--m", type=int, default=8, help="rows of x (the decode batch bucket)")
    ap.add_argument("--window", action="store_true",
                    help="bf16 vs int8 weights: one llama-8b decode window, in turns")
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.window:
        window(card)
        return
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for name, (K, N, _) in cs.INT8_SHAPES.items():
        x, w, s = cs.int8_case(args.m, K, N, "bfloat16", 1, dev)
        f = name == "lm_head"
        plan = im.split_k(K, N)
        tiles = -(-K // im.BK)
        options = sorted({plan} | ({s_ for s_ in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48)
                                    if s_ <= tiles and (s_ - 1) * -(-tiles // s_) < tiles}
                                   if args.sweep else set()))
        for splits in options:
            ms = _with_splits(splits, lambda: cs.time_ms(lambda: im.int8_matmul(x, w, s, out_f32=f),
                                                         flush))
            blocks = -(-N // im.BN) * splits
            print(f"{name} {K}x{N} M={args.m}: splits {splits:2d} ({blocks} blocks) "
                  f"{ms:.4f} ms{' (plan)' if splits == plan else ''} ({card})", flush=True)
    del flush
    substep(dev, args.m, card)


if __name__ == "__main__":
    main()
