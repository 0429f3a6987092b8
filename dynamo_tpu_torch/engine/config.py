"""Engine + model configuration (port of ``dynamo_tpu/engine/config.py``).

``ModelConfig`` and every preset are copied as they are, so one preset
name means the same geometry in both packages. ``EngineArgs`` keeps only
the knobs this port honours, plus ``device``; the speculative-decoding
knobs carry the JAX package's names and defaults.

Every ladder of the JAX package is here with its defaults: each prefill
shape (rows, T bucket, table bucket) and each decode window shape is one
CUDA graph (engine/graphs.py), as each is one jitted program there, so
shapes must come from short lists. The prefill ladder (``prefill_buckets``,
``plan_prefill_chunks``, ``bucket_prefill_rows``) is copied as it is, so
both engines cut and pad a prompt alike. The decode batch ladder also
gives every decode matmul the same shape whatever the batch holds, so a
row's result does not depend on how many other rows run beside it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

ATTN_IMPLS = ("auto", "cuda", "torch")


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family architecture hyperparameters."""

    name: str = "test-tiny"
    vocab_size: int = 512
    hidden_size: int = 128
    intermediate_size: int = 256
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 32
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position: int = 8192
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # QKV projection bias (Qwen2-family). o_proj stays bias-free.
    attn_bias: bool = False
    # Mixture-of-experts (0 = dense FFN): top-k routed experts (model._moe),
    # on one device or split over ep ranks (parallel/mesh.py).
    num_experts: int = 0
    num_experts_per_token: int = 2
    moe_intermediate_size: int | None = None  # per-expert FFN width (default: intermediate_size)

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        d, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        if self.num_experts:
            ie = self.moe_intermediate_size or i
            ffn = self.num_experts * 3 * d * ie + d * self.num_experts  # experts + router
        else:
            ffn = 3 * d * i
        per_layer = (
            d * self.q_size + 2 * d * self.kv_size + self.q_size * d  # attn
            + ffn
            + 2 * d                                                   # norms
        )
        if self.attn_bias:
            per_layer += self.q_size + 2 * self.kv_size
        head = 0 if self.tie_embeddings else d * v
        return v * d + self.num_layers * per_layer + d + head

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        d, v = self.hidden_size, self.vocab_size
        ie = self.moe_intermediate_size or self.intermediate_size
        per_layer = (
            d * self.q_size + 2 * d * self.kv_size + self.q_size * d
            + self.num_experts_per_token * 3 * d * ie + d * self.num_experts
            + 2 * d
        )
        head = 0 if self.tie_embeddings else d * v
        return v * d + self.num_layers * per_layer + d + head

    @staticmethod
    def preset(name: str) -> "ModelConfig":
        presets = {
            "test-tiny": ModelConfig(),
            "llama-1b": ModelConfig(
                name="llama-1b", vocab_size=32000, hidden_size=2048,
                intermediate_size=5632, num_layers=22, num_heads=32,
                num_kv_heads=4, head_dim=64, rope_theta=500000.0,
                max_position=131072, tie_embeddings=True,
            ),
            "llama-3b": ModelConfig(
                name="llama-3b", vocab_size=128256, hidden_size=3072,
                intermediate_size=8192, num_layers=28, num_heads=24,
                num_kv_heads=8, head_dim=128, rope_theta=500000.0,
                max_position=131072, tie_embeddings=True,
            ),
            # Llama-3.1-8B geometry.
            "llama-8b": ModelConfig(
                name="llama-8b", vocab_size=128256, hidden_size=4096,
                intermediate_size=14336, num_layers=32, num_heads=32,
                num_kv_heads=8, head_dim=128, rope_theta=500000.0,
                max_position=131072, tie_embeddings=False,
            ),
            "qwen2-7b": ModelConfig(
                name="qwen2-7b", vocab_size=152064, hidden_size=3584,
                intermediate_size=18944, num_layers=28, num_heads=28,
                num_kv_heads=4, head_dim=128, rope_theta=1000000.0,
                max_position=32768, tie_embeddings=False, attn_bias=True,
            ),
            "moe-tiny": ModelConfig(
                name="moe-tiny", vocab_size=512, hidden_size=128,
                intermediate_size=256, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=32, num_experts=4,
                num_experts_per_token=2,
            ),
            "moe-wide": ModelConfig(
                name="moe-wide", vocab_size=32000, hidden_size=2048,
                intermediate_size=8192, num_layers=12, num_heads=16,
                num_kv_heads=4, head_dim=128, num_experts=64,
                num_experts_per_token=8, moe_intermediate_size=1024,
            ),
            "llama-70b": ModelConfig(
                name="llama-70b", vocab_size=128256, hidden_size=8192,
                intermediate_size=28672, num_layers=80, num_heads=64,
                num_kv_heads=8, head_dim=128, rope_theta=500000.0,
                max_position=131072, tie_embeddings=False,
            ),
        }
        if name not in presets:
            raise ValueError(f"unknown model preset {name!r}; have {sorted(presets)}")
        return presets[name]


@dataclass
class EngineArgs:
    """Capacity and behaviour knobs of the port's engine."""

    model: ModelConfig = field(default_factory=ModelConfig)
    block_size: int = 16                 # KV page size (tokens)
    num_kv_blocks: int = 256             # device pool size (block 0 is the garbage sink)
    max_num_seqs: int = 8                # max concurrent sequences in decode
    max_model_len: int = 2048            # max prompt+gen tokens per sequence
    max_prefill_tokens: int = 2048       # longest single prefill chunk
    dtype: str = "bfloat16"              # weights/activations; sampling in fp32
    prefix_caching: bool = True
    # Weight format: "none" = weights in ``dtype``; "int8" = weight-only
    # int8 with per-output-channel scales (engine/quant.py). Decode streams
    # the weights once per substep, so int8 halves its bytes; the products
    # run in ops/int8_matmul.py's kernel, which reads each weight once.
    quant: str = "none"
    # KV page storage: "none" = pages in ``dtype``; "int8" = int8 pages
    # with per-position-per-head fp32 scales (model.KVCache).
    kv_quant: str = "none"
    # "auto" → the CUDA kernel on a CUDA device, the plain PyTorch version
    # on the CPU; "cuda" / "torch" force one (ops/paged_attention.py).
    attn_impl: str = "auto"
    # Fused decode substeps per host fetch (model.multi_decode).
    decode_steps: int = 8
    # Emit coalescing: when a stream's consumer lags, decode-window deltas
    # already queued merge into one frame up to this many tokens (0 = one
    # frame per delta). Only the backlog merges: no added latency.
    delta_max_tokens: int = 64
    # Optional bounded wait (ms) to gather more deltas per frame after the
    # first (adds up to this much inter-token latency; 0 never waits).
    delta_max_ms: float = 0.0
    # Multi-tenant QoS (runtime/qos.py): admission and preemption ordered
    # by (priority class, age). Requests without a priority are one class,
    # which is exactly FIFO admission and newest-first preemption. False
    # pins every request to one class whatever its wire priority.
    qos_scheduling: bool = True
    # Keep decode windows in flight: window w+1 is dispatched, chaining its
    # input tokens from w's on-device outputs, before w is fetched. Stops
    # are then discovered up to pipeline_depth windows late (at most depth
    # x decode_steps wasted tokens per finished sequence). Full-sampler
    # batches and K=1 tail steps always run unpipelined.
    pipeline_windows: bool = True
    # Max decode windows dispatched but not yet fetched (0 = drain each
    # window before dispatching the next). Fetches start at dispatch and
    # are harvested when ready, so the host blocks only when the pipeline
    # is full.
    pipeline_depth: int = 2
    # Max prompt tokens admitted per scheduler step (0 = until slots are full).
    admission_budget_tokens: int = 8192
    # Run every dispatch op by op: no CUDA graph is captured for a window,
    # a single step, a verify pass or a prefill (the JAX package's "skip
    # jit"); eager dispatches on the card count in the runner's eager_*.
    enforce_eager: bool = False
    # Prefill T-bucket ladder: "fine" (default) inserts 1.5x midpoints into
    # the pow2 ladder through the common range (<= 512), halving the worst
    # pad; "coarse" is the 2x/4x ladder (fewest graphs); a comma list
    # ("64,128,384") pins an explicit schedule (values round up to
    # block_size multiples; max_prefill_tokens is always appended). Each
    # bucket x table-width x row-count triple is one CUDA graph
    # (LocalRunner.warm_prefills captures the lattice).
    prefill_buckets_spec: str = "fine"
    # Split a suffix whose bucket pad is large into [bucket-sized chunk,
    # re-bucketed tail] chunked-prefill dispatches: a 600-token suffix runs
    # as 512 + (88 -> 96) instead of padding a whole 1024 row. Exact
    # (chunked prefill is exact); costs one extra dispatch, so only splits
    # that save >= 2 blocks of padding are taken.
    prefill_tail_split: bool = True
    # Max sequences packed into one prefill dispatch (model.prefill_batch).
    # 1 (singles), as in the JAX package: each extra row bucket multiplies
    # the graph lattice that warm-up captures.
    prefill_batch_max: int = 1
    # Ranked alternatives returned to requests asking for top_logprobs.
    top_logprobs_max: int = 8
    # KV tier stack (block_manager/tiers.py): G2 host-RAM blocks (0 = off)
    # and optional G3 disk spill directory.
    host_kv_blocks: int = 0
    disk_kv_dir: str | None = None
    disk_kv_blocks: int = 4096
    # G4 fleet-SHARED pool: a directory mounted by EVERY engine (NFS,
    # multi-engine-host tmpfs, fused object store). Blocks spill here
    # from G3 keyed by the salted hash chain, so identical prefixes
    # produced by different engines dedup to one file and any engine can
    # onboard a peer's cold prefix without recompute or a live holder.
    fleet_kv_dir: str | None = None
    fleet_kv_blocks: int = 16384
    # Where params and the KV cache live: "cuda" unless the caller asks
    # for "cpu" (device.resolve_device; no silent fallback).
    device: str = "cuda"
    # Tensor parallelism: ranks, one process each (parallel/; the runner
    # holds the rank's shards and its TpGroup). 1 = one card.
    tp: int = 1
    # Speculative decoding (engine/drafter.py + model.spec_verify), the
    # JAX package's knobs and defaults: max draft tokens verified per pass
    # (0 = off). One verify pass streams the weights once for up to
    # spec_tokens+1 tokens per sequence; drafts come from host-side n-gram
    # prompt lookup; greedy rows accept by exact match, sampled rows by
    # rejection sampling.
    spec_tokens: int = 0
    # n-gram match length of the prompt-lookup drafter.
    spec_ngram: int = 3
    # Per-sequence acceptance EMA: update weight, the EMA below which a row
    # stops proposing, and the decode iterations a disabled row waits
    # before it probes again with an EMA-shortened draft.
    spec_ema_alpha: float = 0.3
    spec_ema_disable: float = 0.2
    spec_probe_every: int = 16
    # Draft trees (SpecInfer): max branching factor per node (1 = linear
    # drafts) and max path depth (0 = spec_tokens). The whole tree verifies
    # in one pass through the attention kernel's tree mode.
    spec_tree_width: int = 1
    spec_tree_depth: int = 0
    # Verify forward: True = one forward over all draft slots (one weight
    # stream, the multi-query attention kernel); False = a teacher-forced
    # loop of the dense decode step, bitwise identical to the dense path.
    spec_fused: bool = True
    # Batch dispatch gate: speculate only when mean(1 + ema_i * potential_i)
    # over the batch reaches it (0 = whenever any row drafts).
    spec_gate: float = 1.5
    # Batch-level draft budgets: hot rows may draft up to 2 x spec_tokens
    # under the fixed batch total rows x spec_tokens (False = uniform).
    spec_budget_adaptive: bool = True
    # Streaming KV export flow control: max host bytes of published but
    # unacked chunks one export may buffer. A consumer that stops pulling
    # aborts the stream at this budget (the decode side falls back to a
    # local prefill) instead of growing the prefill worker's heap.
    transfer_buffer_bytes: int = 256 << 20
    # Proactive defrag: at this KV pool usage fraction the engine fires its
    # migration-offer hook for the CHEAPEST running sequence, relocating it
    # to a pool peer BEFORE allocation failure forces a recompute-
    # preemption (the hook the preemption boundary already uses, fired
    # ahead of pressure). 0 = off (the offer still fires at the preemption
    # boundary).
    kv_pressure_offer: float = 0.0
    # Tokenizer spec dict ({"type": "byte"} / {"type": "hf", ...}) the
    # engine compiles grammar token-mask FSMs over (engine/grammar.py).
    # None = byte tokenizer. Must match the serving tokenizer or masks
    # would legalize undecodable ids; the worker wires its own spec.
    grammar_tokenizer: dict | None = None
    # Multi-LoRA (engine/lora.py, block_manager/adapters.py), the JAX
    # package's knobs and defaults: device-resident adapter slots in the
    # bank (0 = off: no bank, every dispatch the pre-LoRA one) and the
    # bank's static rank (smaller adapters zero-pad). More adapters than
    # slots may be registered; they page in through the KV tiers.
    lora_slots: int = 0
    lora_rank: int = 8

    def __post_init__(self):
        # Fail fast on a mistyped ladder spec: anything that is not a named
        # schedule must parse as a comma list of ints, or the error would
        # surface as a bare int() ValueError inside the first bucket_prefill.
        if self.prefill_buckets_spec not in ("fine", "coarse"):
            self._parse_bucket_list(self.prefill_buckets_spec)
        if self.quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8'; got {self.quant!r}")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8'; got {self.kv_quant!r}")
        if self.spec_tree_width < 1:
            raise ValueError(f"spec_tree_width must be >= 1; got {self.spec_tree_width}")
        if self.spec_tree_depth < 0:
            raise ValueError(
                f"spec_tree_depth must be >= 0 (0 = spec_tokens); got {self.spec_tree_depth}"
            )
        # A verify pass holds up to 2 x spec_tokens + 1 slots per row (S + 1
        # when budgets are uniform); the attention kernel takes 64.
        slots = (2 if self.spec_budget_adaptive else 1) * self.spec_tokens + 1
        if self.spec_tokens < 0 or slots > 64:
            raise ValueError(
                f"spec_tokens must be in [0, {63 // (2 if self.spec_budget_adaptive else 1)}] "
                f"(at most 64 verify slots per row); got {self.spec_tokens}"
            )
        if self.lora_slots < 0:
            raise ValueError(f"lora_slots must be >= 0; got {self.lora_slots}")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1; got {self.tp}")
        if not 0.0 <= self.kv_pressure_offer <= 1.0:
            raise ValueError(
                f"kv_pressure_offer must be in [0, 1]; got {self.kv_pressure_offer}"
            )
        if self.lora_slots > 0 and self.lora_rank <= 0:
            raise ValueError(
                f"lora_rank must be positive when lora_slots > 0; got {self.lora_rank}"
            )
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}; got {self.attn_impl!r}")
        if self.max_model_len % self.block_size:
            self.max_model_len = ((self.max_model_len // self.block_size) + 1) * self.block_size
        if self.max_prefill_tokens % self.block_size:
            # prefill chunks must be block-aligned (model.py scatter contract)
            self.max_prefill_tokens = (
                (self.max_prefill_tokens // self.block_size) + 1
            ) * self.block_size

    def kv_bytes_per_block(self) -> int:
        """Device bytes one block costs across all layers, k+v, from the KV
        storage dtype: int8 pages carry a per-position-per-head fp32 scale
        (as the JAX package's ``EngineArgs.kv_bytes_per_block``)."""
        m = self.model
        elems = self.block_size * m.num_kv_heads * m.head_dim
        if self.kv_quant == "int8":
            per_layer = elems + self.block_size * m.num_kv_heads * 4
        else:
            per_layer = elems * (2 if self.dtype == "bfloat16" else 4)
        return 2 * m.num_layers * per_layer

    @property
    def decode_buckets(self) -> tuple[int, ...]:
        # Floor of 8 (or max_num_seqs if smaller), 4x stride: the JAX
        # package's ladder, kept so that decode matmul shapes are fixed.
        lo, hi = min(8, self.max_num_seqs), self.max_num_seqs
        out, b = [], lo
        while b < hi:
            out.append(b)
            b *= 4
        out.append(hi)
        return tuple(dict.fromkeys(out))

    def bucket_decode(self, n: int) -> int:
        for b in self.decode_buckets:
            if n <= b:
                return b
        raise ValueError(f"decode batch {n} exceeds max_num_seqs={self.max_num_seqs}")

    @property
    def blocks_per_seq(self) -> int:
        return self.max_model_len // self.block_size

    @property
    def table_buckets(self) -> tuple[int, ...]:
        """Decode block-table widths: the smallest covering the longest row
        of the batch is used. Two buckets, as in the JAX package: the
        attention kernel's work follows true lengths, so a wide table costs
        little, and the small one keeps short batches and the CPU tests
        cheap."""
        return tuple(dict.fromkeys((min(8, self.blocks_per_seq), self.blocks_per_seq)))

    def bucket_table(self, n_blocks: int) -> int:
        for b in self.table_buckets:
            if n_blocks <= b:
                return b
        raise ValueError(
            f"sequence of {n_blocks} blocks exceeds blocks_per_seq={self.blocks_per_seq}"
        )

    # The prefill ladders are cached: bucket_prefill runs on the scheduler
    # thread (plan_prefill_chunks probes the ladder per admitted suffix).
    # The fields they read (block_size, max_prefill_tokens,
    # prefill_buckets_spec) are not changed after construction.
    @functools.cached_property
    def prefill_buckets(self) -> tuple[int, ...]:
        """The prefill T ladder (the JAX package's, value for value): every
        padded token runs the whole model, so the ladder's stride is the
        pad waste; "fine" adds 1.5x midpoints to the pow2 ladder up to 512
        and stays 2x beyond, where the tail split covers the long range.
        Values stay block_size-aligned (the page-scatter contract)."""
        spec = self.prefill_buckets_spec
        bs = self.block_size
        if spec not in ("fine", "coarse"):
            vals = sorted({
                min(-(-x // bs) * bs, self.max_prefill_tokens)
                for x in self._parse_bucket_list(spec)
            })
            return tuple(dict.fromkeys(vals + [self.max_prefill_tokens]))
        lo = min(max(bs * 2, 32), self.max_prefill_tokens)
        out = []
        b = lo
        while b < self.max_prefill_tokens:
            out.append(b)
            if spec == "fine":
                mid = -(-(b * 3 // 2) // bs) * bs  # 1.5x, block-aligned
                if b < 512 and mid < self.max_prefill_tokens and mid > b:
                    out.append(mid)
                b *= 2
            else:
                b *= 2 if b < 512 else 4
        out.append(self.max_prefill_tokens)
        return tuple(dict.fromkeys(sorted(out)))

    def bucket_prefill(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prefill of {n} tokens exceeds max_prefill_tokens={self.max_prefill_tokens}")

    @staticmethod
    def _parse_bucket_list(spec: str) -> list[int]:
        """Parse an explicit comma-list bucket spec: the one parse shared by
        __post_init__ (fail fast at construction) and the ladder."""
        try:
            vals = [int(x) for x in spec.split(",") if x.strip()]
        except ValueError:
            vals = []
        if not vals or any(v <= 0 for v in vals):
            raise ValueError(
                f"prefill_buckets_spec must be 'fine', 'coarse' or a comma "
                f"list of positive ints; got {spec!r}"
            )
        return vals

    def plan_prefill_chunks(self, sfx: int) -> list[int]:
        """Chunk plan for one suffix of ``sfx`` tokens (<= max_prefill_tokens):
        ``[sfx]``, one dispatch padded to its bucket, or ``[c1, sfx - c1]``
        when splitting the tail into a smaller bucket saves >= 2 blocks of
        padding. ``c1`` is a bucket value, hence block-aligned, so the
        second chunk starts on a block boundary. Chunked prefill is exact:
        the split changes only the padded work, never the tokens."""
        direct = self.bucket_prefill(sfx)
        if not self.prefill_tail_split or direct == sfx:
            return [sfx]
        best, best_cost = [sfx], direct
        for c1 in self.prefill_buckets:
            if c1 >= sfx:
                break
            cost = c1 + self.bucket_prefill(sfx - c1)
            # <= : on cost ties the largest first chunk wins (600 -> [512,
            # 88 -> 96], not [96, 504]).
            if cost <= best_cost:
                best, best_cost = [c1, sfx - c1], cost
        if direct - best_cost >= 2 * self.block_size:
            return best
        return [sfx]

    def bucket_prefill_rows(self, n: int) -> int:
        """Pow2 row ladder of a packed prefill, capped at prefill_batch_max."""
        b = 1
        while b < min(n, self.prefill_batch_max):
            b *= 2
        return min(b, self.prefill_batch_max)

    @property
    def effective_pipeline_depth(self) -> int:
        """pipeline_windows is the master enable; depth 0 = unpipelined."""
        return max(0, self.pipeline_depth) if self.pipeline_windows else 0


def spec_engine_args(ns) -> dict:
    """The worker's and ``run``'s speculative-decoding flags (an argparse
    namespace) as EngineArgs fields."""
    return dict(
        spec_tokens=ns.spec_tokens,
        spec_ngram=ns.spec_ngram,
        spec_fused=not ns.spec_stepwise,
        spec_tree_width=ns.spec_tree_width,
        spec_tree_depth=ns.spec_tree_depth,
        spec_budget_adaptive=ns.spec_budget == "adaptive",
    )
