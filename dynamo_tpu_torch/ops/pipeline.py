"""Pipeline parallelism: layer stages over a ring of rank processes (port of
``dynamo_tpu/ops/pipeline.py``).

The stacked layer parameters ``[L, ...]`` split over the n ranks of the
group's "ring" axis (``parallel.comm``): rank s holds layers [s·L/n,
(s+1)·L/n). Activations flow stage → stage by the ring's neighbour
exchange (``TpGroup.ppermute_start``, the JAX ``lax.ppermute``) on a GPipe
microbatch schedule, so the stages work on different microbatches at
once.

Schedule: M microbatches through n stages take M+n−1 steps (bubble
fraction (n−1)/(M+n−1)); microbatch m enters stage 0 at step m and leaves
stage n−1 at step m+n−1. The final sum over the ring gives the last
stage's outputs to every rank (the others hold zeros), as the JAX
package's ``psum`` does.

Serving-side primitive (one forward, no backward); neither engine calls
it. The math is the caller's ``layer_fn`` in plain torch ops, as the
reference's is XLA: this module adds no kernel.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _stage_of(tree: Any, lo: int, hi: int) -> Any:
    """Layers [lo, hi) of a stacked tree: views, no copy."""
    if isinstance(tree, dict):
        return {k: _stage_of(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _layers(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def pipeline_apply_local(group, x_mb: torch.Tensor, local_layers: Any,
                         layer_fn: Callable) -> torch.Tensor:
    """One rank's part of the schedule: ``x_mb`` [M, mb, D] every
    microbatch (the same on every rank), ``local_layers`` this rank's
    stage (a tree with a leading local-layer axis), ``layer_fn(x [mb, D],
    layer) → x``. → [M, mb, D] outputs, the same on every rank.

    A rank runs its stage only at the steps where it holds a microbatch
    (step t, stage s: 0 ≤ t − s < M); at the others the JAX body computes
    on a clipped or zero input whose result is never read. Every step
    still sends the stage's output on, as ``lax.ppermute`` does."""
    n, me = group.axis_size("ring"), group.axis_rank("ring")
    M = x_mb.shape[0]
    n_local = _layers(local_layers)

    def stage(x):
        for i in range(n_local):
            x = layer_fn(x, _layer(local_layers, i))
        return x

    recv = torch.zeros_like(x_mb[0])
    outputs = torch.zeros_like(x_mb)
    for t in range(M + n - 1):
        if 0 <= t - me < M:
            out = stage(x_mb[t] if me == 0 else recv)
            if me == n - 1:
                outputs[t - (n - 1)] = out
        else:
            out = torch.zeros_like(recv)
        recv = group.ppermute_start([out]).wait()[0]
    # Only the last stage holds real outputs; zeros elsewhere → the sum
    # broadcasts them to the whole ring.
    return group.all_reduce_(outputs, "ring")


def pipeline_apply(group, params_stacked: Any, x: torch.Tensor, layer_fn: Callable,
                   num_microbatches: int) -> torch.Tensor:
    """GPipe-microbatched forward of a stacked-layer network with its layer
    axis split over the ring of ``group`` (a ``parallel.comm.TpGroup``).
    ``params_stacked``: the whole tree, leading axis L divisible by the
    ring's size; each rank runs its contiguous stage of it. ``x`` [B, D],
    the same on every rank. → [B, D] on every rank."""
    B, D = x.shape
    M = num_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    n, me = group.axis_size("ring"), group.axis_rank("ring")
    L = _layers(params_stacked)
    if L % n:
        raise ValueError(f"{L} layers not divisible by {n} pipeline stages")
    w = L // n
    local = _stage_of(params_stacked, me * w, (me + 1) * w)
    out = pipeline_apply_local(group, x.reshape(M, B // M, D), local, layer_fn)
    return out.reshape(B, D)
