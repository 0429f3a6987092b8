"""LoRA adapters for the TPU engine: host-side weight generation and the
page format adapters travel in.

Serving model (Punica arXiv 2310.18547 + S-LoRA arXiv 2311.03285 mapped
onto this engine): hundreds of per-customer low-rank fine-tunes of ONE
base model share one engine. Each batch row carries an ``adapter_slot``
index into a device-resident adapter bank and the q/k/v/o projections add
``(h @ A[slot]) @ B[slot]`` via a batched gathered matmul (BGMV) — mixed
batches pay one gather + two skinny matmuls per projection, so adapter
traffic rides the SAME prefill/decode/spec-verify dispatches at near-base
throughput instead of forking per-adapter batches.

The bank holds ``lora_slots`` resident adapters (G1, HBM); the full
adapter population lives as *paged objects* in the block-manager tier
economy (S-LoRA's unified paging): an adapter's weights pack into one
page tuple (``adapter_pages``) keyed by a synthetic sequence hash
(``adapter_tier_hash``) and stored in the SAME G2 host / G3 disk pools as
KV blocks, competing under the same second-chance eviction credits.
Cold-adapter admission pages in from the tiers (or regenerates /
reloads from source), uploads into a slot chosen by the slot pool's
second-chance policy (block_manager/adapters.py), and pays nothing on the
running batch — eviction is free because registration wrote the pages
through to the tiers up front.

Rank is static per bank (``EngineArgs.lora_rank``): adapters declaring a
smaller rank zero-pad their A/B factors, so every dispatch shape stays in
the compiled lattice. The per-adapter scaling (alpha / rank) is folded
into B at registration time — the device math carries no per-adapter
scalars.

Base rows: ``adapter_slot = -1``. The model applies the delta under a
``jnp.where`` row mask (never an add-of-zero, which could flip a -0.0),
so base rows in an adapter-mixed batch are bit-identical to a no-LoRA
engine — the byte-identity contract tests/test_engine_lora.py pins.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.tokens import HASH_SEED, xxh3_64

# Projection targets a LoRA adapter may attach to, in bank order. The
# bank always carries all four (absent targets are zero factors) so the
# dispatch shape is target-independent.
LORA_TARGETS = ("q", "k", "v", "o")

# Bank array names in page order: (A, B) per target. adapter_pages()
# and AdapterBank uploads rely on this exact ordering.
LORA_PAGE_KEYS = tuple(
    f"{t}{ab}" for t in LORA_TARGETS for ab in ("a", "b")
)


class LoraError(Exception):
    """Typed adapter-registry failure (unknown adapter, rank overflow)."""


@dataclass(frozen=True)
class LoraAdapterSpec:
    """One registered adapter: identity + how to (re)materialize it.

    ``seed``-based adapters generate deterministic random factors (the
    bench/test source; real checkpoints plug in through ``pages`` at
    registration). ``scaling`` is the classic alpha/rank multiplier,
    folded into B before upload."""

    name: str
    rank: int
    seed: int = 0
    scaling: float = 1.0
    targets: str = "qkvo"


def adapter_tier_hash(name: str) -> int:
    """Synthetic sequence hash an adapter's page tuple is keyed by in the
    G2/G3 tiers. Domain-separated from token-block hashes (which hash
    packed u32 token ids) by the ``lora:`` prefix over raw bytes."""
    return xxh3_64(b"lora:" + name.encode(), HASH_SEED)


def _target_dims(cfg: ModelConfig, target: str) -> tuple[int, int]:
    """(fan_in, fan_out) of one projection target."""
    d = cfg.hidden_size
    return {
        "q": (d, cfg.q_size),
        "k": (d, cfg.kv_size),
        "v": (d, cfg.kv_size),
        "o": (cfg.q_size, d),
    }[target]


def make_adapter_pages(
    cfg: ModelConfig, spec: LoraAdapterSpec, max_rank: int, dtype=np.float32,
) -> tuple[np.ndarray, ...]:
    """Materialize one adapter as its page tuple: per LORA_TARGETS order,
    (A [L, in, max_rank], B [L, max_rank, out]) float arrays. Factors are
    deterministic in (name, seed); ranks below ``max_rank`` zero-pad (a
    zero A/B column pair contributes exactly nothing), absent targets are
    all-zero. Scaling is folded into B here. Classic LoRA initializes B
    to zero (identity at step 0); these generated adapters draw BOTH
    factors so tests/benches observe distinct per-adapter outputs —
    checkpoint loaders hand real factors to the same page layout."""
    if spec.rank > max_rank:
        raise LoraError(
            f"adapter {spec.name!r} rank {spec.rank} exceeds the bank's "
            f"lora_rank={max_rank}"
        )
    L = cfg.num_layers
    r = spec.rank
    root = np.random.default_rng(
        xxh3_64(spec.name.encode(), spec.seed & 0x7FFFFFFF)
    )
    pages: list[np.ndarray] = []
    for t in LORA_TARGETS:
        fan_in, fan_out = _target_dims(cfg, t)
        A = np.zeros((L, fan_in, max_rank), dtype)
        B = np.zeros((L, max_rank, fan_out), dtype)
        if t in spec.targets:
            A[:, :, :r] = (root.standard_normal((L, fan_in, r)) * fan_in ** -0.5).astype(dtype)
            B[:, :r, :] = (
                root.standard_normal((L, r, fan_out)) * (0.5 * r ** -0.5) * spec.scaling
            ).astype(dtype)
        pages.append(A)
        pages.append(B)
    return tuple(pages)


def bank_shapes(cfg: ModelConfig, slots: int, max_rank: int) -> dict[str, tuple]:
    """Device adapter-bank array shapes, keyed like LORA_PAGE_KEYS:
    A factors [L, slots, in, rank], B factors [L, slots, rank, out].
    Layer-leading so the model's lax.scan splits the bank per layer."""
    shapes: dict[str, tuple] = {}
    for t in LORA_TARGETS:
        fan_in, fan_out = _target_dims(cfg, t)
        shapes[f"{t}a"] = (cfg.num_layers, slots, fan_in, max_rank)
        shapes[f"{t}b"] = (cfg.num_layers, slots, max_rank, fan_out)
    return shapes


def adapter_bank_bytes(cfg: ModelConfig, slots: int, max_rank: int,
                       itemsize: int = 2) -> int:
    """HBM bytes of the device adapter bank (all targets, both factors) —
    the G1 footprint the slot count buys."""
    per_slot = 0
    for t in LORA_TARGETS:
        fan_in, fan_out = _target_dims(cfg, t)
        per_slot += cfg.num_layers * max_rank * (fan_in + fan_out)
    return slots * per_slot * itemsize
