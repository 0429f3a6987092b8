"""CUDA-graph decode windows, verify passes and single steps: the port's
counterpart of the JAX package's one jitted dispatch per window
(``dynamo_tpu/engine/runner.py`` ``multi_decode``), per speculative verify
pass (``spec_verify``, whose shape lattice the JAX package AOT-compiles)
and per grammar-constrained single step (``decode_step`` then masked
``sample_rows``).

An eager window issues hundreds of small launches per substep and leaves
the card idle while the host issues them. Here each window shape (B
bucket, W bucket, penalty width, K, sampler mode, top_n, and whether its
rows carry adapter slots) is captured once,
at first use, as one ``torch.cuda.CUDAGraph`` of the whole window:
``multi_decode`` plus the fold of its last tokens into ``last_toks``.
Later windows of that shape copy their packed inputs into the graph's
static input buffer and replay it.

- Capture follows torch's documented pattern: the window runs twice on a
  side stream first, on inert inputs (every row inactive, so KV writes land
  in block 0, the garbage sink, and folds land in the sink slot), then is
  captured. A capture that fails raises; nothing falls back to the eager
  window.
- All graphs share one memory pool. Each keeps references to its static
  inputs and outputs, so no capture reuses another graph's live buffers;
  every replay runs on the one stream, in dispatch order, and the runner
  enqueues the copy of a replay's outputs to the host right behind it,
  before any later replay.
- The kernels' launch counters (``paged_attention.launches``,
  ``int8_matmul.launches``, its ``prefill_launches``, ``tied_launches``
  and ``wide_launches``) count in Python,
  so a capture records each call once; the warmup and capture counts are
  taken back, and each replay adds the calls its graph holds.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from dynamo_tpu_torch.ops import int8_matmul as im
from dynamo_tpu_torch.ops import paged_attention as pa

WARMUP_RUNS = 2
# (module, counter) of every kernel wrapper a window can call.
COUNTERS = ((pa, "launches"), (im, "launches"), (im, "prefill_launches"),
            (im, "tied_launches"), (im, "wide_launches"))


def read_counts() -> tuple[int, ...]:
    """The COUNTERS' current values, in their order."""
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def set_counts(values) -> None:
    for (mod, name), v in zip(COUNTERS, values):
        setattr(mod, name, v)


class _Graph:
    __slots__ = ("graph", "static_in", "outs", "calls", "capture_s", "pool_bytes")

    def __init__(self, graph, static_in, outs, calls, capture_s, pool_bytes):
        self.graph = graph
        self.static_in = static_in
        self.outs = outs
        self.calls = calls  # per COUNTERS entry: calls one replay makes
        self.capture_s = capture_s    # seconds its capture took, warmup runs included
        self.pool_bytes = pool_bytes  # graph pool bytes its capture added


class WindowGraphs:
    """The runner's captured windows, verify passes and single steps,
    keyed by shape: (B, W, L, K, mode, top_n, lora) for a window,
    ("verify", B, W, S1, mode, top_n, tree, fused, lora, masked) for a
    verify pass, ("step", B, W, L, mode, top_n, lora, masked) for a single
    step; ``lora`` is the variant whose rows carry adapter slots."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: dict[tuple, _Graph] = {}
        self.capture_s = 0.0
        self.replays = 0

    @property
    def captured(self) -> int:
        return len(self._graphs)

    @property
    def shapes(self) -> list[tuple]:
        """Captured shapes (the keys above)."""
        return list(self._graphs)

    def capture_costs(self) -> dict[tuple, tuple[float, int]]:
        """Captured shape → (capture seconds, graph pool bytes it added)."""
        return {k: (g.capture_s, g.pool_bytes) for k, g in self._graphs.items()}

    def run(self, key: tuple, words: np.ndarray,
            make: Callable[[], tuple[Callable, np.ndarray]]) -> tuple[torch.Tensor, ...]:
        """Replay the graph of ``key`` on the packed inputs ``words``,
        capturing it first if needed (``make()`` → the window function of
        its packed inputs and inert inputs for the warmup). → the graph's
        static outputs, overwritten by its next replay."""
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(*make())
        g.static_in.copy_(torch.from_numpy(words).pin_memory(), non_blocking=True)
        g.graph.replay()
        set_counts(a + b for a, b in zip(read_counts(), g.calls))
        self.replays += 1
        return g.outs

    def _capture(self, fn: Callable, inert: np.ndarray) -> _Graph:
        t0, pool0 = time.perf_counter(), self.pool_bytes()
        static_in = torch.from_numpy(inert).to(self.device)
        base = read_counts()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                fn(static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        mark = read_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            outs = tuple(fn(static_in))
        calls = tuple(b - a for a, b in zip(mark, read_counts()))
        set_counts(base)
        dt = time.perf_counter() - t0
        self.capture_s += dt
        return _Graph(graph, static_in, outs, calls, dt, self.pool_bytes() - pool0)

    def pool_bytes(self) -> int:
        """Device bytes reserved by the shared graph pool."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))
