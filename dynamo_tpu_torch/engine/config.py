"""Engine + model configuration (port of ``dynamo_tpu/engine/config.py``).

``ModelConfig`` and every preset are copied as they are, so one preset
name means the same geometry in both packages. ``EngineArgs`` keeps only
the knobs this port honours, plus ``device``; the speculative-decoding
knobs carry the JAX package's names and defaults.

What went: the prefill token ladder existed so that each jitted shape
compiled once; prefill runs eagerly here, so prefill chunks are padded
only to a block multiple (the page-scatter contract). The decode batch
ladder stays: a fixed row count gives every decode matmul the same shape
whatever the batch holds, so a row's result does not depend on how many
other rows run beside it. The table-width ladder stays too (two buckets,
as in the JAX package): each decode window shape is one CUDA graph
(engine/graphs.py), so widths must come from a short list.
"""

from __future__ import annotations

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
    # Mixture-of-experts (0 = dense FFN): top-k routed experts on one
    # device (model._moe); expert parallelism is not ported.
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
