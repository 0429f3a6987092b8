"""Model sharding rules for tensor parallelism (port of
``dynamo_tpu/parallel/mesh.py``).

The JAX package drives every device from one process: it lays a mesh
over them, gives each parameter a ``NamedSharding`` and lets XLA derive
the collectives. Here one process drives one rank, so the rules become
slices: ``ModelSharding(cfg, tp, rank)`` cuts a full parameter tree into
this rank's contiguous shards, and the forward (engine/model.py) calls the
collectives itself (parallel/comm.py).

Megatron-style column → row, as the JAX rules:

- attention: wq/wk/wv split on their output columns, wo on its input
  rows → one all-reduce after wo. The KV cache keeps the rank's kv heads,
  so paged reads and writes stay local.
- MLP: w_gate/w_up split on columns, w_down on rows → one all-reduce
  after w_down. MoE: every expert's ie columns of moe_gate/moe_up, its ie
  rows of moe_down; the router is replicated.
- embed and lm_head split on the vocabulary over the whole tp group when
  it divides (replicated otherwise); norms replicated.

**TP beyond num_kv_heads**: tp splits into ``tp_kv × tp_rep`` (``split_tp``).
KV projections and the cache split over tp_kv only and are replicated over
tp_rep; query heads and the MLP split over all tp ranks. Rank r sits at
(i, j) = divmod(r, tp_rep) of the JAX package's row-major device grid: kv
head group i and query subgroup j, so with head index h = kvh·G + g the
rank holds exactly the query heads that read its kv heads.

**Expert parallelism** (``ep`` > 1): ranks lie as the JAX grid ``(dp, ep,
tp_kv, tp_rep)`` row-major (``build_mesh``), so global rank r is tp rank
r mod tp of ep block r // tp. The MoE expert stacks split their expert
axis over ep and keep ``ie`` over tp (each rank holds E/ep experts × ie/tp
of each); everything else (attention, the KV lanes, the router, the
vocabulary splits) is the tp rank's, replicated over ep. Attention, the
embedding and the logits reduce over the tp block; the MoE combine over
all ep × tp ranks (``parallel.comm``'s "tp" and "ep_tp" axes).

Multi-LoRA under tp: an adapter's factor pages are cut as the rank's
projections are (engine/runner.py ``shard_adapter_pages``, by this
module's rules for wq/wk/wv/wo): B of q over tp and B of k/v
over tp_kv on their columns, A of o over tp on its rows, the other
factors whole. The o delta joins the rank's wo partial before the
all-reduce, which sums ``o @ oa @ ob`` over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def split_tp(tp: int, cfg) -> tuple[int, int]:
    """tp → (tp_kv, tp_rep): shard kv heads as far as they divide, then
    replicate. Raises if the residue cannot split the query groups."""
    tp_kv = 1
    for cand in range(min(tp, cfg.num_kv_heads), 0, -1):
        if tp % cand == 0 and cfg.num_kv_heads % cand == 0:
            tp_kv = cand
            break
    tp_rep = tp // tp_kv
    G = cfg.num_heads // cfg.num_kv_heads
    if G % tp_rep:
        raise ValueError(
            f"tp={tp} needs query-group replication {tp_rep} but "
            f"G={G} query heads per kv head is not divisible by it"
        )
    return tp_kv, tp_rep


def rank_coords(rank: int, tp_rep: int) -> tuple[int, int]:
    """Rank → (kv head group i, query subgroup j): the rank's place in the
    JAX package's row-major (tp_kv, tp_rep) device grid."""
    return divmod(rank, tp_rep)


# Leaf rules of ``param_shardings``: (axis of the stacked leaf, over which
# ranks) — "tp" splits over all tp ranks (block r), "kv" over tp_kv (block
# i, the same on every query subgroup), "ep" over the ep blocks. Layer
# leaves carry the layer axis first, so [L, in, out] columns are axis 2
# and rows axis 1; expert stacks [L, E, d, ie] / [L, E, ie, d] split E
# (axis 1) over ep and ie over tp.
_LAYER_RULES = {
    "wq": ((2, "tp"),), "wk": ((2, "kv"),), "wv": ((2, "kv"),), "wo": ((1, "tp"),),
    "w_gate": ((2, "tp"),), "w_up": ((2, "tp"),), "w_down": ((1, "tp"),),
    "bq": ((1, "tp"),), "bk": ((1, "kv"),), "bv": ((1, "kv"),),
    # int8 scales [L, out] follow their weight's output dimension; the
    # row-split weights' outputs are whole, so their scales are replicated.
    "wq_scale": ((1, "tp"),), "wk_scale": ((1, "kv"),), "wv_scale": ((1, "kv"),),
    "w_gate_scale": ((1, "tp"),), "w_up_scale": ((1, "tp"),),
    "moe_gate": ((1, "ep"), (3, "tp")), "moe_up": ((1, "ep"), (3, "tp")),
    "moe_down": ((1, "ep"), (2, "tp")),
}

class ModelSharding:
    """The shard rules of one model at tensor parallelism ``tp`` for one
    ``rank``; ``group`` is the rank's ``parallel.comm.TpGroup`` (None for
    shard bookkeeping alone, as the loader and the tests use it)."""

    def __init__(self, cfg, tp: int, rank: int, group=None, ep: int = 1):
        if cfg.num_experts and cfg.num_experts % ep:
            raise ValueError(f"num_experts={cfg.num_experts} not divisible by ep={ep}")
        if not 0 <= rank < ep * tp:
            raise ValueError(f"rank {rank} outside tp={tp}" + (f" x ep={ep}" if ep > 1 else ""))
        self.cfg = cfg
        self.tp, self.ep, self.rank, self.group = tp, ep, rank, group
        # The rank's place in the (ep, tp) grid: its ep block and tp rank.
        self.e, self.tp_rank = divmod(rank, tp)
        self.tp_kv, self.tp_rep = split_tp(tp, cfg)
        if cfg.num_kv_heads % self.tp_kv:
            raise ValueError(f"num_kv_heads={cfg.num_kv_heads} not divisible by tp_kv={self.tp_kv}")
        if cfg.num_heads % tp:
            raise ValueError(f"num_heads={cfg.num_heads} not divisible by tp={tp}")
        if (cfg.num_heads // cfg.num_kv_heads) % self.tp_rep:
            raise ValueError(f"query groups not divisible by tp_rep={self.tp_rep}")
        if cfg.intermediate_size % tp:
            raise ValueError(f"intermediate_size={cfg.intermediate_size} not divisible by tp={tp}")
        ie = cfg.moe_intermediate_size or cfg.intermediate_size
        if cfg.num_experts and ie % tp:
            raise ValueError(f"moe_intermediate_size={ie} not divisible by tp={tp}")
        self.i, self.j = rank_coords(self.tp_rank, self.tp_rep)
        # Vocabulary sharding falls back to replication on awkward sizes.
        self.vocab_sharded = tp > 1 and cfg.vocab_size % tp == 0
        w = cfg.vocab_size // tp
        self.vocab_lo = self.tp_rank * w if self.vocab_sharded else 0
        self.vocab_hi = (self.tp_rank + 1) * w if self.vocab_sharded else cfg.vocab_size
        self.kv_heads = cfg.num_kv_heads // self.tp_kv
        # The rank's experts [lo, hi) (all of them at ep = 1).
        ne = cfg.num_experts // ep
        self.experts = (self.e * ne, (self.e + 1) * ne)

    @property
    def local(self):
        """The rank's view of the model: its query and kv heads and its FFN
        width (every other field, the vocabulary included, as the model's)."""
        cfg = self.cfg
        moe = cfg.moe_intermediate_size
        return dataclasses.replace(
            cfg, num_heads=cfg.num_heads // self.tp, num_kv_heads=self.kv_heads,
            intermediate_size=cfg.intermediate_size // self.tp,
            moe_intermediate_size=None if moe is None else moe // self.tp)

    # -- parameters ---------------------------------------------------------

    def leaf_rules(self, path: tuple[str, ...]) -> list[tuple[int, int, int]]:
        """[(axis, parts, block)] of the leaf at ``path`` (``("layers",
        "wq")``, ``("embed",)``, …), one per split axis: none for a
        replicated leaf."""
        name = path[-1]
        if path[0] == "layers":
            parts = {"tp": (self.tp, self.tp_rank), "kv": (self.tp_kv, self.i),
                     "ep": (self.ep, self.e)}
            rules = [(axis, *parts[over]) for axis, over in _LAYER_RULES.get(name, ())]
        elif not self.vocab_sharded:
            rules = []
        else:
            axis = {"embed": 0, "embed_scale": 0, "lm_head": 1, "lm_head_scale": 0}.get(name)
            rules = [] if axis is None else [(axis, self.tp, self.tp_rank)]
        return [r for r in rules if r[1] > 1]

    def shard_leaf(self, path: tuple[str, ...], a):
        """The rank's contiguous shard of the leaf at ``path`` (a numpy array
        or a tensor). A leaf already of the shard's size on a split axis is
        this rank's shard on that axis and is left as it is there."""
        cut = False
        for axis, parts, block in self.leaf_rules(path):
            n, full = a.shape[axis], self._full_dim(path, axis)
            w = full // parts
            if n == w:
                continue
            if n != full:
                raise ValueError(f"{'/'.join(path)}: dimension {axis} is {n}, neither the "
                                 f"model's {full} nor its 1/{parts}")
            cut = True
            if isinstance(a, torch.Tensor):
                a = a.narrow(axis, block * w, w)
            else:
                idx = [slice(None)] * a.ndim
                idx[axis] = slice(block * w, (block + 1) * w)
                a = np.asarray(a)[tuple(idx)]
        if not cut:
            return a
        return a.contiguous() if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)

    def _full_dim(self, path: tuple[str, ...], axis: int) -> int:
        """The model's size of the leaf's split axis."""
        cfg = self.cfg
        name = path[-1].removesuffix("_scale")
        if name in ("embed", "lm_head"):
            return cfg.vocab_size
        if name.startswith("moe_") and axis == 1:
            return cfg.num_experts
        ie = cfg.moe_intermediate_size or cfg.intermediate_size
        return {"wq": cfg.q_size, "wo": cfg.q_size, "bq": cfg.q_size,
                "wk": cfg.kv_size, "wv": cfg.kv_size, "bk": cfg.kv_size, "bv": cfg.kv_size,
                "w_gate": cfg.intermediate_size, "w_up": cfg.intermediate_size,
                "w_down": cfg.intermediate_size,
                "moe_gate": ie, "moe_up": ie, "moe_down": ie}[name]

    def shard_params(self, params: Any) -> Any:
        """A full parameter tree (numpy arrays or tensors) → this rank's
        tree of contiguous shards; leaves that are already shards pass."""

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            return self.shard_leaf(path, tree)

        return walk(params, ())

    # -- KV cache lanes -----------------------------------------------------

    def lanes(self, head_dim: int) -> tuple[int, int]:
        """The rank's [lo, hi) of a page's merged KVH·hd axis: its kv heads,
        grouped as the attention reads them (``cache_spec``)."""
        w = self.kv_heads * head_dim
        return self.i * w, (self.i + 1) * w

    def shard_pages(self, pages: tuple) -> tuple:
        """Full host pages (k, v[, k_scale, v_scale]) in the JAX layout
        ``[L, n, bs, KVH·hd]`` (scales ``[L, n, bs, KVH]``) → the rank's
        lanes of each, contiguous."""
        hd = self.cfg.head_dim
        out = []
        for p in pages:
            per_head = hd if p.shape[-1] == self.cfg.num_kv_heads * hd else 1
            lo, hi = self.lanes(per_head)
            out.append(np.ascontiguousarray(p[..., lo:hi]))
        return tuple(out)

    def merge_lanes(self, gathered: torch.Tensor) -> torch.Tensor:
        """Every rank's lanes concatenated in rank order on the last axis →
        the JAX layout: kv group i's lanes taken from its first rank
        (i·tp_rep), as its query subgroups hold the same ones."""
        if self.tp_rep == 1:
            return gathered
        *lead, n = gathered.shape
        w = n // self.tp
        return gathered.reshape(*lead, self.tp_kv, self.tp_rep, w)[..., 0, :].reshape(
            *lead, self.tp_kv * w)
