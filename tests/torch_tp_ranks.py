"""Helpers of the port's tensor-parallel tests: run a function on every rank
of a gloo group of CPU processes and collect what each returns.

Not a test module: it imports torch and the port only (no jax), so the
spawned ranks start quickly. ``run_ranks(fn, n, *args)`` starts ``n``
processes from the ``spawn`` context, each calling ``fn(rank, group,
*args)`` with its ``parallel.comm.TpGroup`` (``ep`` blocks of n/ep tp
ranks, given as ``ep=``), and returns their results in rank order; a rank
that raises fails the call with its traceback.
"""

from __future__ import annotations

import socket
import traceback

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, tp, coord, args, q, ep=1):
    from dynamo_tpu_torch.parallel.comm import TpGroup

    torch.set_num_threads(1)
    try:
        group = TpGroup(rank, tp, coord, "cpu", ep=ep)
        try:
            q.put((rank, "ok", fn(rank, group, *args)))
        finally:
            group.close()
    except BaseException:  # noqa: BLE001 — report to the parent, which raises
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, tp: int, *args, timeout: float = 120.0, ep: int = 1) -> list:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    coord = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, tp, coord, args, q, ep), daemon=True)
             for r in range(tp)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    try:
        for _ in range(tp):
            rank, status, val = q.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"tp rank {rank} failed:\n{val}")
            out[rank] = val
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [out[r] for r in range(tp)]


def run_groups(calls: dict) -> dict:
    """``run_ranks`` of several groups at once, each on its own ports: key →
    (fn, n, args, kwargs) → key → its ranks' results."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        futs = {key: pool.submit(run_ranks, fn, n, *args, **kw)
                for key, (fn, n, args, kw) in calls.items()}
        return {key: f.result() for key, f in futs.items()}


# -- the forward scenario of tests/test_torch_tp_forward.py ---------------------

BS, NBLK = 4, 32


def scenario_inputs(vocab: int) -> dict:
    """Seeded host inputs of the forward scenario: a 3-row prefill, one
    chained 4-step window, a linear and a tree verify pass, an embedding."""
    rng = np.random.default_rng(7)
    lens = np.array([13, 9, 6], np.int32)
    toks = np.zeros((3, 16), np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(1, vocab, n)
    tables = np.zeros((4, 8), np.int32)
    tables[0, :6], tables[1, :5], tables[2, :4] = range(1, 7), range(7, 12), range(12, 16)
    S1 = 5
    parents = np.zeros((4, S1), np.int32)
    for j in range(3, S1):
        parents[:, j] = 1 if j == 3 else j - 1
    anc = np.zeros((4, S1, S1), np.int8)
    depth = np.zeros((4, S1), np.int32)
    for b in range(4):
        anc[b, 0, 0] = 1
        for j in range(1, S1):
            p = parents[b, j]
            anc[b, j] = anc[b, p]
            anc[b, j, j] = 1
            depth[b, j] = depth[b, p] + 1
    emb = np.zeros((16,), np.int32)
    emb[:11] = rng.integers(1, vocab, 11)
    return {"toks": toks, "lens": lens, "tables": tables, "S1": S1,
            "drafts": rng.integers(1, vocab, (4, S1)).astype(np.int32),
            "tree": (parents, anc, depth), "embed_toks": emb, "embed_len": 11,
            "temps": np.array([0.0, 0.8, 1.1, 0.0], np.float32),
            "seeds": np.array([5, 6, 2**31 - 1, 0], np.int64)}


def forward_scenario(cfg, p, cache, inp: dict, tp=None, gather=None) -> dict:
    """The scenario through the port's forwards: ``tp`` is the rank's
    ModelSharding (None: one process), ``gather`` turns the rank's page
    lanes into the full layout. → numpy outputs, the KV pages included."""
    from dynamo_tpu_torch.engine import model

    t = torch.from_numpy
    out = {}
    logits = model.prefill_batch(cfg, p, cache, t(inp["toks"]), t(inp["tables"][:3]),
                                 torch.zeros((3,), dtype=torch.int32), t(inp["lens"]), tp=tp)
    out["prefill"] = logits.numpy()
    first = logits.argmax(-1).to(torch.int32)
    last = torch.zeros((6,), dtype=torch.int32)
    last[[2, 0]] = first[:2]
    B = 4
    tok = torch.tensor([0, 0, int(first[2]), 0], dtype=torch.int32)
    pos = torch.tensor([13, 9, 6, 0], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    temps, seeds = t(inp["temps"]), t(inp["seeds"])
    steps0 = torch.ones((B,), dtype=torch.int32)
    win = model.multi_decode(
        cfg, 4, "simple", 2, p, cache, tok, pos, t(inp["tables"]), active, temps, seeds, steps0,
        chain_mask=torch.tensor([True, True, False, False]),
        chain_src=torch.tensor([2, 0, 0, 0], dtype=torch.int32), last_toks=last, tp=tp)
    out.update({f"window_{i}": a.numpy() for i, a in enumerate(win)})
    S1 = inp["S1"]
    pos0 = pos + 4
    for kind in ("linear", "tree"):
        drafts = t(inp["drafts"].copy())
        drafts[:3, 0] = win[0][-1][:3]
        tree = [t(a) for a in inp["tree"]] if kind == "tree" else [None] * 3
        v = model.spec_verify(cfg, S1, "simple", 2, p, cache, drafts, pos0,
                              torch.tensor([S1 - 1, S1 - 1, 1, 0], dtype=torch.int32),
                              t(inp["tables"]), active, temps, seeds, steps0 + 4, *tree, tp=tp)
        out.update({f"{kind}_{i}": a.numpy() for i, a in enumerate(v)})
        pos0 = pos0 + v[1].to(torch.int32)
    out["embed"] = model.embed(cfg, p, t(inp["embed_toks"]), inp["embed_len"], tp=tp).numpy()
    pages = [a for a in cache if a is not None]
    out["pages"] = [(gather(a) if gather else a).numpy() for a in pages]
    return out


def port_forward_rank(rank, group, np_params, cfg, tp, kv_quant, inp):
    """One rank of ``forward_scenario`` at ``tp`` on the rank's shards →
    its outputs (each rank returns the same full-layout outputs)."""
    from dynamo_tpu_torch.engine import model as TM
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.parallel.mesh import ModelSharding

    sh = ModelSharding(cfg, tp, rank, group)
    params = params_from_numpy(sh.shard_params(np_params), "cpu", torch.float32)
    cache = TM.init_kv_cache(sh.local, NBLK, BS, torch.float32, torch.device("cpu"),
                             kv_quant=kv_quant)
    return forward_scenario(cfg, params, cache, inp, tp=sh,
                            gather=lambda a: sh.merge_lanes(group.all_gather(a)))


# -- follower ranks of an in-process leader -----------------------------------


def _follower_main(rank, tp, coord, step, eargs, np_params, seed, q):
    from dynamo_tpu_torch.engine.runner import follower_loop
    from dynamo_tpu_torch.parallel.comm import TpGroup

    torch.set_num_threads(1)
    try:
        group = TpGroup(rank, tp, coord, "cpu")
        runner = follower_loop(eargs, step, params=np_params, seed=seed, group=group)
        q.put((rank, "ok", {"digest": runner.digest(), "collectives": group.counters()}))
        runner.stop()
        group.close()
    except BaseException:  # noqa: BLE001 — report to the parent, which raises
        q.put((rank, "error", traceback.format_exc()))


class Followers:
    """Ranks 1..tp-1 of a tp group whose leader (rank 0) is the calling
    process: each a spawned process replaying the leader's stream
    (``follower_loop``) with ``eargs`` and the full ``np_params``.
    ``coordinator`` and ``step_addr`` are what the leader's TpGroup and
    LeaderRunner take; ``results()`` waits for every follower's end → their
    digests and collective counters, in rank order."""

    def __init__(self, tp: int, eargs, np_params, seed: int = 0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        self.coordinator = f"127.0.0.1:{free_port()}"
        self.step_addr = f"127.0.0.1:{free_port()}"
        self.procs = [ctx.Process(target=_follower_main, daemon=True, args=(
            r, tp, self.coordinator, self.step_addr, eargs, np_params, seed, self.q))
            for r in range(1, tp)]
        for p in self.procs:
            p.start()

    def results(self, timeout: float = 60.0) -> list[dict]:
        out = {}
        try:
            for _ in self.procs:
                rank, status, val = self.q.get(timeout=timeout)
                if status != "ok":
                    raise RuntimeError(f"follower {rank} failed:\n{val}")
                out[rank] = val
        finally:
            self.kill()
        return [out[r] for r in sorted(out)]

    def kill(self) -> None:
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()


# -- the pipeline, ring-attention and expert-parallel ops ----------------------


def ring_rank(rank, group, cases):
    """``ring_prefill`` of each (q, k, v, causal) case → the rank's outputs,
    its collective counters, then the message of a sequence one token
    short of the first case's (None if none raised)."""
    from dynamo_tpu_torch.ops.ring_attention import ring_prefill

    t = torch.from_numpy
    outs = [ring_prefill(group, t(q), t(k), t(v), causal=causal).numpy()
            for q, k, v, causal in cases]
    counters = group.counters()
    q, k, v, _ = cases[0]
    try:
        ring_prefill(group, t(q[1:]), t(k[1:]), t(v[1:]))
        err = None
    except ValueError as e:
        err = str(e)
    return outs, counters, err


def pipeline_rank(rank, group, params, x, microbatches):
    """``pipeline_apply`` of chip_smoke's ``swiglu_block`` (tests/test_pipeline.py's
    layer) at each microbatch count → the
    rank's outputs, then the message of a count that does not divide the
    batch (None if none raised)."""
    from chip_smoke import swiglu_block
    from dynamo_tpu_torch.ops.pipeline import pipeline_apply

    p = {k: torch.from_numpy(v) for k, v in params.items()}
    outs = [pipeline_apply(group, p, torch.from_numpy(x), swiglu_block, m).numpy()
            for m in microbatches]
    try:
        pipeline_apply(group, p, torch.zeros((10, x.shape[1])), swiglu_block, 3)
        err = None
    except ValueError as e:
        err = str(e)
    return outs, err, group.counters()


def moe_ep_rank(rank, group, np_params, cfg, tp, ep, inp, steps):
    """``steps`` decode steps of the ep × tp rank on its shards, from an
    empty cache: the first at ``inp``'s tokens and positions, each later
    one at the greedy tokens one position on → each step's logits, the
    collective counters."""
    from dynamo_tpu_torch.engine import model as TM
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.parallel.mesh import ModelSharding

    sh = ModelSharding(cfg, tp, rank, group, ep=ep)
    params = params_from_numpy(sh.shard_params(np_params), "cpu", torch.float32)
    cache = TM.init_kv_cache(sh.local, inp["N"], inp["bs"], torch.float32, torch.device("cpu"))
    t = torch.from_numpy
    tokens, pos = t(inp["tokens"]), t(inp["positions"])
    out = []
    for _ in range(steps):
        logits = TM.decode_step(cfg, params, cache, tokens, pos, t(inp["tables"]),
                                torch.ones_like(tokens, dtype=torch.bool), tp=sh)
        out.append(logits.numpy())
        tokens, pos = logits.argmax(-1).to(torch.int32), pos + 1
    return out, group.counters()


# -- LoRA under tp -------------------------------------------------------------


def lora_forward_scenario(runner, inp: dict, bank: bool) -> list:
    """A 4-row prefill then two chained decode steps on ``runner``'s params
    and a fresh cache of its own (the rank's lanes under tp), each row
    under its adapter slot (``inp["slots"]``, -1 = base) with the runner's
    bank, or every row on the exact base path without it (``bank`` False)
    → the logits of each forward."""
    from dynamo_tpu_torch.engine import model as TM

    cfg, sh = runner.cfg, runner.sharding
    local = cfg if sh is None else sh.local
    cache = TM.init_kv_cache(local, NBLK, BS, torch.float32, torch.device("cpu"))
    t = torch.from_numpy
    lora = runner.lora_bank if bank else None
    slots = t(inp["slots"]) if bank else None
    lens = t(inp["lens"])
    logits = TM.prefill_batch(cfg, runner.params, cache, t(inp["toks"]), t(inp["tables"]),
                              torch.zeros_like(lens), lens, lora, slots, tp=sh)
    out = [logits.numpy()]
    tokens, pos = logits.argmax(-1).to(torch.int32), lens.clone()
    for _ in range(2):
        logits = TM.decode_step(cfg, runner.params, cache, tokens, pos, t(inp["tables"]),
                                torch.ones_like(lens, dtype=torch.bool), lora=lora,
                                adapter_slots=slots, tp=sh)
        out.append(logits.numpy())
        tokens, pos = logits.argmax(-1).to(torch.int32), pos + 1
    return out


def lora_runner(eargs, np_params, pages: list, group=None):
    """A started LocalRunner of ``eargs`` (the rank's under tp) with each of
    ``pages`` (full adapter pages) uploaded to the slot of its index."""
    from dynamo_tpu_torch.engine.runner import LocalRunner

    runner = LocalRunner(eargs, params=np_params, group=group)
    runner.start()
    for slot, p in enumerate(pages):
        runner.upload_adapter(slot, p)
    return runner


def lora_tp_rank(rank, group, eargs, np_params, pages, inp):
    """One tp rank of ``lora_forward_scenario``, with its bank and without
    → (logits with, logits without, the rank's bank as numpy arrays)."""
    runner = lora_runner(eargs, np_params, pages, group)
    return (lora_forward_scenario(runner, inp, True), lora_forward_scenario(runner, inp, False),
            {k: v.numpy() for k, v in runner.lora_bank.items()})
