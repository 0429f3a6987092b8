"""TorchEngine: continuous-batching inference engine over the port's model
(port of ``dynamo_tpu/engine/engine.py`` ``TpuEngine``).

Same contract: ``start`` / ``stop`` / ``generate(request, context)``,
yielding ``LLMEngineOutput`` dicts (token deltas; text is the Backend's
job). The scheduler loop runs in its own thread; asyncio callers submit
through a lock-guarded queue and receive deltas on per-request asyncio
queues via ``loop.call_soon_threadsafe``.

Kept from TpuEngine: (class, age)-ordered admission (FIFO for traffic of
one QoS class) with block allocation and prefix-cache hits; single-row
prefill chunked at ``max_prefill_tokens``; first tokens sampled on the
device per admission wave and folded into each
sequence's chain slot, their fetch queued (async admission); fused K-step
decode windows (``decode_steps``) over the running set in the sampler
mode the batch needs ("greedy", "simple", "full"), with up to
``pipeline_depth`` windows in flight, chained on the device and fetched
asynchronously (the decode window pipeline below); stops on max_tokens /
EOS (``ignore_eos``, ``min_tokens``) / max_model_len; cancellation
through ``Context``; recompute preemption under KV pressure, of the lowest
QoS class first and the newest within it; per-stream delta coalescing
(``delta_max_tokens`` / ``delta_max_ms``).

For a worker it has the TpuEngine surface: ``metrics()`` (the load the KV
router reads), ``pool.set_event_sink`` (KV events) and ``bind_metrics``
(the engine series of the JAX package whose quantity the port computes).

Speculative decoding is the JAX engine's (``_try_speculative`` and its
helpers, the same names): n-gram or tree drafts verified in one pass
(``runner.spec_verify``, a CUDA graph per verify shape), on-device
acceptance, an acceptance EMA with probe cooldowns, adaptive batch node
budgets, and the ``engine_spec_*`` series.

Disaggregated prefill/decode is the JAX engine's too (the same names): a
request with ``kv_transfer_params.do_remote_decode`` prefills only and
exports its full prompt blocks, streamed chunk by chunk while the prefill
runs when it carries a ``stream_handle`` (``get_stream_export``), else as
one payload (``take_export``); a request with ``kv_transfer_params.inject``
(pages a prefill worker exported) admits them as a prefix hit, written
into the cache in place by ``runner.inject_pages``.

Grammar-constrained decoding (``response_format``) is the JAX engine's
too (the same names): the request's schema compiles once per engine into
a token-mask FSM (``engine/grammar.py``) off the scheduler thread; a
batch with a constrained row decodes in single steps (``decode_step``
then masked sampling, one CUDA graph per shape, ``runner.decode_sample``,
the path of every K=1 plan) because the next mask needs the last token on
the host; the FSM advances
per emitted token; drafts are pruned to legal continuations and every
constrained verify pass is a tree pass with per-node masks.
``embed`` serves /v1/embeddings: mean-pooled final hidden states, one
eager forward per ``max_prefill_tokens`` chunk on the scheduler thread.

The KV tiers are the JAX engine's too (the same names,
``block_manager/tiers.py``): sealed blocks write through to G2 host RAM
(spilling to a G3 disk directory and a G4 fleet-shared one), at most
``MAX_OFFLOAD_PER_STEP`` per flush after each decode iteration and before
each allocation, and a prefix that G1 lost is onboarded from the tiers at
admission instead of recomputed (before a disagg or peer inject, which may
start past the tiers' coverage). The JAX flush extracts synchronously; here
a flush enqueues the page gather and its device→host copy and puts the
blocks into the tiers once the copy has landed, so no flush waits for the
windows in flight (on the CPU the copy has landed at once, and the tiers
see every put where the JAX engine's do).

Live migration is the JAX engine's too (the same names, the protocol
comment above ``migration_begin``): ``worker/migrate.py`` streams a
running decode's sealed KV blocks to a peer while it keeps decoding, then
freezes it for a bounded cutover, ships the block delta and the resume
identity (tokens, sampler seed and step, spec EMA, grammar state,
``next_write_pos``), and hands the client stream off with a
``{"migration": marker}`` frame; a resumed leg continues sampling at the
source's (seed, step). Each pump's page gather and its device→host copy
are enqueued on the compute stream behind the windows in flight and
published once landed, strictly in dispatch order, so a pump never waits
for a window. QoS preemption and ``kv_pressure_offer`` first offer the
victim for migration (``migration_offer``, wired by ``worker/roles.py``).

Multi-LoRA is the JAX engine's too (the same names, ``engine/lora.py``
and ``block_manager/adapters.py``): ``register_adapter`` writes an
adapter's factor pages through to the tiers under ``adapter_tier_hash``;
admission pins the request's adapter into a bank slot
(``_acquire_adapter``), paging it in from G2/G3/G4 (or regenerating it
from its seed) on a cold miss, and releases the pin on finish, preempt,
abort and migration. Every dispatch whose batch has an adapter row
carries the rows' slots (-1 = base) and replays the LoRA variant of its
shape; a base-only batch runs the pre-LoRA one. An adapter request's KV
is hashed in its own domain (``adapter_hash_seed``): prefix cache, KV
events, tier keys, ``prefix_hit_length`` and the migration identity all
carry it. A request that names an adapter this engine cannot serve ends
its own stream with the JAX engine's typed error.

Tracing is the JAX engine's too: a traced request (one whose ``Context``
carries a trace) records ``engine.queue`` (submission to admission) and
``engine.prefill`` (admission to the first delta, with ``prompt_tokens``
and ``cached_blocks``) at its first delta and keeps ``engine.decode``
open until its stream ends (with ``tokens``; status ``cancelled`` on a
cancelled stream). The spans are per request: the scheduler thread only
stamps ``t_admit`` and ``prefix_hit_blocks``, and the request's coroutine
records them. ``trace_s`` (wall seconds on the event loop, a wait for
the interpreter lock included) and ``traced_requests`` count what
recording them cost.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import random
import threading
import time
from typing import Any, AsyncIterator

import numpy as np

from dynamo_tpu_torch.block_manager.adapters import AdapterSlotPool, NoFreeAdapterSlotsError
from dynamo_tpu_torch.block_manager.pool import BlockPool, NoFreeBlocksError
from dynamo_tpu_torch.block_manager.tiers import (
    DiskBlockPool,
    FleetBlockPool,
    HostBlockPool,
    TierStack,
)
from dynamo_tpu_torch.engine import kv_transfer
from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.drafter import (
    DraftConstraint,
    TreeDraft,
    build_drafter,
    constrain_chain,
)
from dynamo_tpu_torch.engine.grammar import (
    GrammarError,
    build_compiler,
    mask_words,
    pack_token_ids,
)
from dynamo_tpu_torch.engine.lora import LoraAdapterSpec, adapter_tier_hash, make_adapter_pages
from dynamo_tpu_torch.engine.runner import HostFetch, LocalRunner, host_ready, start_host_fetch
from dynamo_tpu_torch.engine.sampler import GREEDY_EPS, row_needs_full
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics, KvStats, WorkerStats
from dynamo_tpu_torch.llm.protocols import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    coalesce_delta,
)
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.logging import TraceContext
from dynamo_tpu_torch.runtime.qos import DEFAULT_CLASS, QOS_CLASSES, qos_rank
from dynamo_tpu_torch.tokens import TokenBlockSequence, adapter_hash_seed, compute_block_hashes
from dynamo_tpu_torch.transfer.stream import KvChunk, KvStreamExport

log = logging.getLogger("dynamo_tpu_torch.engine")

_SENTINEL_DONE = object()

# Streaming disaggregated export (transfer/stream.py): host bytes of
# published-but-unacked chunks one export may buffer (the JAX package's
# default). A consumer that stops pulling aborts the stream at this budget
# (the decode side falls back to local prefill) instead of growing the
# prefill worker's heap without bound.
TRANSFER_BUFFER_BYTES = 256 << 20

# Adaptive tree budgets: the per-row draft-node cap, as a multiple of
# spec_tokens. Bounding hot rows at 2x keeps the verify-shape lattice at
# two S1 values (S+1 and 2S+1).
SPEC_BUDGET_MAX_MULT = 2


def trim_spec_budgets(rows: list[tuple[float, int]], S: int) -> list[int]:
    """Batch-level draft-node reallocation (the JAX package's, as it is):
    rows drafted optimistically (each up to min(cap, 2S) nodes), and this
    decides how many nodes each row KEEPS so the batch stays under the
    uniform budget ``len(rows) * S``. ``rows`` = per-row (spec_ema,
    drafted_len). Over budget, EMA-cold rows are trimmed back toward the
    uniform path's EMA shrink (S * ema / 0.5, floor 1), coldest first.

    Invariants: sum(keep) <= len(rows) * S; keep_i >= min(drafted_i, 1);
    keep_i >= min(drafted_i, desired_i); keep_i <= drafted_i."""
    n = len(rows)
    keep = [d for _, d in rows]
    if n == 0 or S <= 0:
        return [0] * n
    total = sum(keep)
    limit = n * S
    if total <= limit:
        return keep
    order = sorted(range(n), key=lambda i: (rows[i][0], i))  # coldest first
    for i in order:
        if total <= limit:
            break
        desired = max(1, round(S * min(1.0, rows[i][0] / 0.5)))
        cut = min(keep[i] - min(keep[i], desired), total - limit)
        keep[i] -= cut
        total -= cut
    return keep


def register_engine_metrics(registry):
    """Register the engine series on a MetricsRegistry → (inflight
    windows, pending first fetches, prefill pad ratio, KV cache bytes, KV
    quant flag, preemptions, spec proposed, spec accepted, spec accept
    rate, tokens per weight pass, spec tree passes, spec tree accept
    depth, spec budget reallocs, grammar active seqs, grammar mask
    seconds, LoRA resident adapters, LoRA swaps, LoRA gather seconds, tier
    protected evictions, tier hit rate, G4 hits, G4 evictions, G4 dedup
    blocks). Names and help texts are the JAX package's
    (``register_engine_metrics`` there)."""
    return (
        registry.gauge(
            "engine_inflight_windows",
            "Decode windows dispatched on device but not yet drained",
        ),
        registry.gauge(
            "engine_pending_first_fetches",
            "Admission first-token sample fetches in flight",
        ),
        registry.gauge(
            "engine_prefill_pad_ratio",
            "Cumulative dispatched/true prefill token ratio (bucket padding waste)",
        ),
        registry.gauge(
            "engine_kv_cache_bytes",
            "HBM bytes of the G1 paged KV pool (pages + quantization "
            "scales, num_kv_blocks x kv_bytes_per_block)",
        ),
        registry.gauge(
            "engine_kv_quant_enabled",
            "1 when the paged KV cache stores int8 pages (kv_quant), "
            "0 for full-precision storage",
        ),
        registry.counter(
            "engine_preemptions_total",
            "Recompute-preemptions under KV pressure by victim QoS "
            "class (victims are lowest-class/newest-first; a preempted "
            "request requeues and re-prefills, so its stream stays "
            "byte-identical under greedy sampling)",
        ),
        registry.counter(
            "engine_spec_proposed_total",
            "Draft tokens proposed to speculative verify passes",
        ),
        registry.counter(
            "engine_spec_accepted_total",
            "Proposed draft tokens accepted by speculative verification",
        ),
        registry.gauge(
            "engine_spec_accept_rate",
            "Cumulative accepted/proposed draft-token ratio",
        ),
        registry.gauge(
            "engine_tokens_per_weight_pass",
            "Decode tokens sampled per per-sequence weight stream "
            "(1.0 = dense; >1.0 = speculation paying off)",
        ),
        registry.counter(
            "engine_spec_tree_passes_total",
            "Speculative verify passes dispatched with a branched "
            "(non-chain) draft tree",
        ),
        registry.gauge(
            "engine_spec_tree_accept_depth",
            "Cumulative mean accepted root-path depth of tree verify "
            "passes (0 = every tree pass rejected at the root)",
        ),
        registry.counter(
            "engine_spec_budget_reallocs_total",
            "Speculative verify passes whose batch-level draft-node "
            "budget was reallocated away from the uniform per-row split "
            "(EMA-hot rows drafting past spec_tokens)",
        ),
        registry.gauge(
            "engine_grammar_active_seqs",
            "Running sequences decoding under a grammar constraint "
            "(response_format token-mask FSMs)",
        ),
        registry.gauge(
            "engine_grammar_mask_seconds",
            "Cumulative host seconds spent building/packing grammar "
            "token masks (FSM walks + bitset gathers per verify slot)",
        ),
        registry.gauge(
            "engine_lora_resident_adapters",
            "LoRA adapters currently resident in the device (G1) bank "
            "slots (engine/lora.py; 0 when lora_slots is 0)",
        ),
        registry.counter(
            "engine_lora_swap_total",
            "LoRA adapter page-ins: uploads of adapter factor pages into "
            "a device bank slot (cold fetch through the G2/G3 tier "
            "economy; when slots are full each one evicts a colder "
            "resident)",
        ),
        registry.gauge(
            "engine_lora_gather_seconds",
            "Cumulative host seconds spent on LoRA multiplexing — "
            "resolving adapter slots at admission, uploading factor "
            "pages, and building per-dispatch adapter_slot operands",
        ),
        registry.counter(
            "tier_protected_evictions_total",
            "Host/disk KV tier eviction scans that SPARED a protected "
            "block (high prefix fan-out or recent hits) and evicted a "
            "colder one instead",
        ),
        registry.gauge(
            "tier_hit_rate",
            "Cumulative G2+G3 tier lookup hit rate (hits / (hits + "
            "misses)) — the churn-resistance signal for the "
            "frequency-aware eviction policy",
        ),
        registry.counter(
            "tier_g4_hits_total",
            "G4 fleet-shared pool lookups that found the block file "
            "(possibly written by a PEER engine — the cross-engine "
            "dedup payoff)",
        ),
        registry.counter(
            "tier_g4_evictions_total",
            "G4 fleet-pool files pruned by this engine's oldest-mtime "
            "capacity sweep of the SHARED directory",
        ),
        registry.counter(
            "tier_g4_dedup_blocks_total",
            "G4 puts/spill-adoptions skipped because a peer engine "
            "already wrote the identical salted-hash block file",
        ),
    )


class RequestValidationError(Exception):
    """Client error (clean rejection, no stack trace)."""


class _Seq:
    __slots__ = (
        "request_id", "tokens", "prompt_len", "sampling", "stop", "eos_ids",
        "block_ids", "block_seq", "registered_blocks", "queue", "emitted",
        "cancelled", "sample_seed", "kv_written", "dead", "slot", "first_pend",
        "spec_ema", "spec_cool", "draft_state", "qos", "qos_rank", "arrival",
        "export", "export_meta", "inject", "export_handle", "export_stream",
        "export_pub_blocks", "grammar", "grammar_state", "grammar_eos_bits",
        "adapter_id", "adapter_slot", "hash_seed", "adapter_wait_t0",
        "step_base", "mig", "offer_deadline", "traceparent", "t_admit",
        "prefix_hit_blocks",
    )

    def __init__(self, request_id: str, req: PreprocessedRequest, queue: asyncio.Queue):
        self.request_id = request_id
        self.tokens: list[int] = list(req.token_ids)
        # The original prompt boundary: penalties count tokens[prompt_len:],
        # and it survives preemption (which re-prefills every token).
        self.prompt_len = len(req.token_ids)
        self.sampling = req.sampling
        self.stop = req.stop
        self.eos_ids = set(req.eos_token_ids) | set(req.stop.stop_token_ids)
        self.block_ids: list[int] = []
        self.block_seq: TokenBlockSequence | None = None
        self.registered_blocks = 0
        self.queue = queue
        self.emitted = 0
        self.cancelled = False
        # Seeded requests are reproducible; others get a per-request seed.
        self.sample_seed = (
            req.sampling.seed if req.sampling.seed is not None else random.getrandbits(31)
        ) & 0x7FFFFFFF
        # Positions whose KV is in the cache. A block is registered for
        # prefix reuse only once fully written: a just-sampled token's KV
        # lands on the NEXT step (it is that step's input).
        self.kv_written = 0
        # Finished or cancelled (set by _finish). In-flight windows drain
        # after the fact; dead rows' outputs are discarded.
        self.dead = False
        # Stable chain slot (the runner's last_toks index) while running;
        # first_pend = first token sampled on the device, not yet emitted.
        self.slot: int | None = None
        self.first_pend = False
        # Speculative decoding: acceptance-rate EMA (starts optimistic, so
        # new sequences get full drafts), cooldown of decode iterations
        # before a disabled row proposes again, and the drafter's
        # incremental n-gram index (built on the first draft). All three
        # ride the sequence object, so they survive preemption.
        self.spec_ema = 1.0
        self.spec_cool = 0
        self.draft_state = None
        # Multi-tenant QoS: the request's class name (metrics label;
        # unknown wire values fall back to the default class), its
        # scheduling rank (generate() zeroes it when qos_scheduling is
        # off) and the engine-assigned arrival number: the (class, age)
        # key of admission order and preemption victim selection.
        priority = getattr(req, "priority", None)
        self.qos = priority if priority in QOS_CLASSES else DEFAULT_CLASS
        self.qos_rank = qos_rank(priority)
        self.arrival = 0
        # Disaggregation (the engine side of llm/disagg.py): prefill only
        # and export the KV, or pre-load exported pages (a KvPagePayload
        # dict, or {"chunks": [...]} from a stream). With a decode-worker-
        # minted stream_handle, chunks publish DURING prefill;
        # export_pub_blocks is the contiguous published coverage.
        ktp = req.kv_transfer_params or {}
        self.export = bool(ktp.get("do_remote_decode"))
        self.export_meta: dict | None = None
        self.inject = ktp.get("inject")
        self.export_handle = ktp.get("stream_handle") if self.export else None
        self.export_stream: KvStreamExport | None = None
        self.export_pub_blocks = 0
        # Grammar-constrained decoding: the compiled FSM (shared across
        # requests of one schema), this sequence's state in it (host-side,
        # advanced per emitted token) and the packed EOS bits OR-ed into
        # terminal-state masks. Attached by generate().
        self.grammar = None
        self.grammar_state = 0
        self.grammar_eos_bits = None
        # Multi-LoRA: the request's adapter (None = base), its pinned bank
        # slot while admitted (-1 = none; released at finish, preempt and
        # migration) and the adapter-salted hash seed of its KV identity:
        # block hashes, tier keys, KV events and router stickiness all
        # derive from it, so an adapter's KV never prefix-hits another
        # identity's.
        self.adapter_id = getattr(req, "adapter_id", None)
        self.adapter_slot = -1
        self.hash_seed = adapter_hash_seed(self.adapter_id)
        self.adapter_wait_t0 = 0.0  # when admission first found every slot pinned
        # Live migration: the sampler step offset (a resumed sequence keeps
        # drawing the SOURCE's noise: same seed, steps continue at
        # step_base + emitted) and the outbound migration state while this
        # sequence is being relocated (scheduler-thread owned, via
        # _migrations).
        self.step_base = 0
        self.mig = None
        # W3C traceparent of the client request (stamped by generate() from
        # the wire context); it rides the migration protocol so a resumed
        # leg joins the original trace.
        self.traceparent: str | None = None
        # Tracing: when admission last succeeded (perf_counter, stamped by
        # the scheduler thread) and the prompt blocks it found cached (G1
        # hit, tier onboard or inject); engine.queue/engine.prefill read both.
        self.t_admit: float | None = None
        self.prefix_hit_blocks = 0
        # Preemption-offer grace: once the offer hook fired for this
        # sequence as a preemption victim, the kill waits until this
        # deadline for the relocation to free its blocks.
        self.offer_deadline = 0.0
        # A resumed leg (migration re-dispatch) carries its original prompt
        # boundary (penalties and the grammar replay key off it) and the
        # source's seed, sampler step and spec EMA.
        resume = ktp.get("resume")
        if isinstance(resume, dict):
            pl = resume.get("prompt_len")
            if isinstance(pl, int) and 1 <= pl <= len(self.tokens):
                self.prompt_len = pl
            if resume.get("sample_seed") is not None:
                self.sample_seed = int(resume["sample_seed"]) & 0x7FFFFFFF
            self.step_base = int(resume.get("sample_step") or 0)
            if resume.get("spec_ema") is not None:
                self.spec_ema = float(resume["spec_ema"])

    @property
    def next_write_pos(self) -> int:
        return len(self.tokens) - 1


class _MigSt:
    """Scheduler-thread state of one outbound live migration: the sequence
    keeps decoding while its sealed KV blocks publish as stream chunks
    (``_pump_migration``), until the coordinator freezes it for the bounded
    cutover window. ``fetches`` are this migration's page extracts in
    flight (lo, hi, HostFetch, n), harvested strictly in dispatch order so
    the consumer's chunk coverage stays contiguous."""

    __slots__ = ("seq", "handle", "stream", "pub_blocks", "frozen",
                 "freeze_deadline", "fetches")

    def __init__(self, seq: _Seq, handle: str, stream: KvStreamExport):
        self.seq = seq
        self.handle = handle
        self.stream = stream
        self.pub_blocks = 0
        self.frozen = False
        self.freeze_deadline = 0.0
        self.fetches: list = []


class _Window:
    """One dispatched K-step decode window (results not yet fetched)."""

    __slots__ = ("rows", "pos0", "K", "row_of", "top_n", "fetch")

    def __init__(self, rows: list[_Seq], pos0: list[int], K: int, top_n: int,
                 fetch: HostFetch):
        self.rows = rows
        self.pos0 = pos0
        self.K = K
        self.row_of = {s: i for i, s in enumerate(rows)}
        self.top_n = top_n
        # toks [K, B], logps [K, B] (+ top_vals, top_ids [K, B, top_n])
        self.fetch = fetch


class _First:
    """One admission wave's first-token samples (not yet fetched).
    Entries: (seq, row) into the wave's padded sample batch."""

    __slots__ = ("entries", "fetch")

    def __init__(self, entries: list[tuple[_Seq, int]], fetch: HostFetch):
        self.entries = entries
        # toks [B], logps [B] (+ top_vals, top_ids [B, top_n])
        self.fetch = fetch


class _Spec:
    """One dispatched speculative verify pass (results not yet fetched).
    Unlike a _Window, the tokens a row will emit (1 + accepted drafts) are
    unknown until the fetch lands, so no decode work is planned for these
    rows while a _Spec is queued: _decode_iteration drains it first.

    ``draft_lens`` counts proposed draft nodes per row; ``potentials`` the
    longest accepted run each proposal could yield (the deepest path of a
    tree), the EMA's denominator; ``node_tokens``/``node_parents`` the
    host-side tree views, which feed the drafter's Jacobi pool."""

    __slots__ = ("rows", "pos0", "draft_lens", "potentials", "top_n", "tree",
                 "node_tokens", "node_parents", "fetch")

    def __init__(self, rows: list[_Seq], pos0: list[int], draft_lens: list[int], top_n: int,
                 potentials: list[int], tree: bool, node_tokens: list[list[int]],
                 node_parents: list[list[int]], fetch: HostFetch):
        self.rows = rows
        self.pos0 = pos0
        self.draft_lens = draft_lens
        self.potentials = potentials
        self.top_n = top_n
        self.tree = tree
        self.node_tokens = node_tokens
        self.node_parents = node_parents
        # out [B, S1], n_emit [B], logps [B, S1], cand [B, S1]
        # (+ top_vals, top_ids [B, S1, top_n])
        self.fetch = fetch


class TorchEngine:
    def __init__(self, args: EngineArgs, params: Any | None = None, seed: int = 0,
                 event_sink=None, runner: LocalRunner | None = None):
        self.args = args
        self.cfg = args.model
        # ``runner``: a LeaderRunner when the model spans tp rank processes
        # (its followers replay this engine's dispatches); the scheduler
        # runs here alone.
        self._runner = runner or LocalRunner(args, params=params, seed=seed)
        self.pool = BlockPool(
            args.num_kv_blocks, args.block_size, event_sink=event_sink,
            enable_prefix_caching=args.prefix_caching,
        )
        # G2/G3/G4 KV tiers: sealed blocks write through to host (batched
        # per flush); prefix misses in G1 onboard from the tiers instead of
        # recomputing (block_manager/tiers.py). Queued (block_id, seq_hash)
        # pairs, the flushes whose page copy is in flight (hashes, radix
        # protection hints, HostFetch, n) and the hashes they carry.
        self.tiers = self._build_tiers(args)
        self._offload_pending: list[tuple[int, int]] = []
        self._offload_fetches: collections.deque = collections.deque()
        self._offload_inflight: set[int] = set()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._mutex = threading.Lock()
        self._wakeup = threading.Condition(self._mutex)
        self._submissions: collections.deque[_Seq] = collections.deque()
        self._waiting: collections.deque[_Seq] = collections.deque()
        self._running: list[_Seq] = []
        # Dispatched work whose results are not yet on the host, in
        # dispatch order: admission samples and decode windows.
        self._fetchq: collections.deque[_First | _Window | _Spec] = collections.deque()
        # (fn, future, loop) host jobs run on the engine thread between
        # steps (run_on_engine_thread).
        self._host_jobs: collections.deque = collections.deque()
        self._free_slots: list[int] = list(range(args.max_num_seqs))
        self._stopping = False
        # Monotonic counters, read racily by callers (stale reads harmless).
        self.total_generated = 0
        self.total_prefilled = 0
        self.total_prefill_padded = 0  # prefill tokens dispatched, block padding included
        self.total_decode_steps = 0   # device substeps dispatched, padded rows included
        # The same by decode batch bucket (rows per substep: what picks the
        # int8 product's route).
        self.decode_steps_by_bucket: collections.Counter = collections.Counter()
        self.total_preemptions_by: collections.Counter = collections.Counter()  # victim class
        self._arrival_no = 0
        # Host seconds per phase: admission, prefill, first_dispatch,
        # decode_dispatch, drain_sync (waiting on a window's fetch),
        # drain_ready (a window already on the host), first_sample (waiting
        # on an admission sample), emit.
        self.phase_s: dict[str, float] = collections.defaultdict(float)
        # Registry series (bind_metrics), updated once per scheduler step;
        # preemptions already added to the counter, by class, and what the
        # spec counters (proposed, accepted, tree passes, budget reallocs)
        # already fed theirs.
        self._gauges = None
        self._preempt_pushed: dict[str, int] = {}
        self._spec_pushed = [0, 0, 0, 0]
        self._lora_pushed = 0  # LoRA page-ins already added to the swap counter
        self._tier_pushed = [0, 0, 0, 0]  # protected evictions, G4 hits/evictions/dedup
        # Speculative decoding: the host-side drafter and a draft length
        # that, like spec_budget_adaptive, may be changed on an idle engine
        # (read once per scheduler iteration).
        self._drafter = build_drafter(args)
        self.spec_tokens = args.spec_tokens
        self.spec_budget_adaptive = args.spec_budget_adaptive
        # Scheduler-step counter and last-ticked stamp: probe cooldowns
        # tick once per step, though a drain can re-enter
        # _try_speculative within one.
        self._step_no = 0
        self._spec_ticked = -1
        # Spec counters: proposed/accepted draft tokens, verify passes,
        # live row-passes and the tokens they emitted; branched passes,
        # accepted root-path depth sum and rows (mean accept depth), a
        # histogram {depth: rows}; passes dispatched with a non-uniform
        # node split.
        self.total_spec_proposed = 0
        self.total_spec_accepted = 0
        self.total_spec_passes = 0
        self.total_spec_rows = 0
        self.total_spec_emitted = 0
        self.total_spec_tree_passes = 0
        self.total_spec_tree_rows = 0
        self.total_spec_tree_depth = 0
        self.spec_depth_hist: collections.Counter = collections.Counter()
        self.total_spec_budget_reallocs = 0
        # Tokens per weight pass: each (row, substep) of a drained window
        # is one per-sequence weight pass yielding one token; a spec
        # row-pass is one weight pass yielding n_emit tokens.
        self.total_row_passes = 0
        self.total_row_tokens = 0
        # Disagg exports: handle → (KvPagePayload | KvStreamExport,
        # deadline). Host copies, reaped after export_ttl_s since the
        # consumer last pulled (unsealed streams abort at reap time).
        self._exports: dict[str, tuple[Any, float]] = {}
        self.export_ttl_s = 60.0
        # Streaming-export page fetches in flight: (seq, lo, hi, HostFetch,
        # n), dispatched per prefill chunk and harvested once landed.
        self._export_fetches: list = []
        # Host seconds the scheduler spent injecting pages (inject_s) and
        # gathering and publishing exports (export_s), and the bytes.
        self.inject_s = 0.0
        self.inject_bytes = 0
        self.export_s = 0.0
        # Host seconds in _flush_offloads, the flushes that enqueued a page
        # copy, and the page bytes put into the tiers; host seconds and
        # bytes of the tier onboards at admission.
        self.offload_s = 0.0
        self.offload_flushes = 0
        self.offload_bytes = 0
        self.onboard_s = 0.0
        self.onboard_bytes = 0
        # Grammar: the compiler over the serving tokenizer's vocabulary,
        # built once (under its lock, off the scheduler thread) and caching
        # compiled schemas; host seconds building masks, and the number of
        # constrained requests.
        self._grammar_compiler = None
        self._grammar_lock = threading.Lock()
        self.total_grammar_mask_s = 0.0
        self.total_grammar_seqs = 0
        # Wall seconds the event loop spent recording the per-request spans,
        # and the requests that recorded them (the worker's counters line).
        self.trace_s = 0.0
        self.traced_requests = 0
        # (token_ids, future, loop) embedding jobs, served on the
        # scheduler thread between steps.
        self._embed_jobs: collections.deque = collections.deque()
        # Outbound live migrations: request_id → _MigSt. The scheduler pumps
        # each unfrozen migration's KV delta once per step; a frozen one is
        # unfrozen (and the migration aborted) when the coordinator misses
        # the cutover deadline, so a dead coordinator never wedges a stream.
        self._migrations: dict[str, _MigSt] = {}
        self.migration_freeze_ttl_s = 10.0
        # QoS defrag: when set (worker/roles.py wires it to the migration
        # coordinator), preemption under KV pressure OFFERS the victim a
        # relocation first (called on the scheduler thread with the
        # victim's request id; must be thread-safe) and the kill waits a
        # bounded grace for the offer to land.
        self.migration_offer = None
        self.preempt_offer_grace_s = 0.75
        # Proactive defrag (args.kv_pressure_offer): past that pool usage
        # the offer hook fires for the cheapest running sequence AHEAD of
        # the preemption boundary, at most once per window.
        self.kv_pressure_offer = args.kv_pressure_offer
        self.kv_pressure_offer_window_s = 2.0
        self._pressure_offer_next = 0.0
        self.pressure_offers = 0  # proactive offers fired
        # Host seconds the scheduler spent in _pump_migration and the pumps.
        self.migration_pump_s = 0.0
        self.migration_pumps = 0
        # Multi-LoRA: the bank's slot pool (acquire/release on the scheduler
        # thread), the adapter registry (name → (spec, pinned pages); written
        # under _lora_lock from any thread, read at admission), the host
        # seconds of the adapter work (engine_lora_gather_seconds) and of
        # its page-ins (tier read and upload), and the admissions that
        # waited for a slot and their seconds.
        self._lora_pool = AdapterSlotPool(args.lora_slots) if args.lora_slots > 0 else None
        self._lora_registry: dict[str, tuple[LoraAdapterSpec, tuple | None]] = {}
        self._lora_lock = threading.Lock()
        self.total_lora_s = 0.0
        self.lora_pagein_s = 0.0
        self.lora_slot_waits = 0
        self.lora_slot_wait_s = 0.0

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> "TorchEngine":
        self._loop = asyncio.get_running_loop()
        await asyncio.to_thread(self._runner.start)
        self._thread = threading.Thread(target=self._run, name="torch-engine", daemon=True)
        self._thread.start()
        return self

    async def stop(self) -> None:
        with self._wakeup:
            self._stopping = True
            self._wakeup.notify()
        if self._thread is not None:
            await asyncio.to_thread(self._thread.join, 10.0)
        self._runner.stop()

    def bind_metrics(self, registry) -> None:
        """Attach the engine series to a MetricsRegistry; updated once per
        scheduler step (never per token)."""
        self._gauges = register_engine_metrics(registry)

    def _update_gauges(self) -> None:
        if self._gauges is None:
            return
        (g_win, g_first, g_pad, g_kvb, g_kvq, c_preempt, c_prop, c_acc, g_rate, g_tpp,
         c_tree, g_tree_depth, c_budget, g_gram_seqs, g_gram_mask,
         g_lora_res, c_lora_swap, g_lora_s,
         c_tier_prot, g_tier_hit, c_g4_hit, c_g4_evict, c_g4_dedup) = self._gauges
        g_win.set(sum(1 for it in self._fetchq if isinstance(it, _Window)))
        g_first.set(sum(1 for it in self._fetchq if isinstance(it, _First)))
        g_pad.set(self.total_prefill_padded / max(1, self.total_prefilled))
        g_kvb.set(self.args.kv_bytes_per_block() * self.args.num_kv_blocks)
        g_kvq.set(1 if self.args.kv_quant == "int8" else 0)
        for cls, n in self.total_preemptions_by.items():
            pushed = self._preempt_pushed.get(cls, 0)
            if n > pushed:
                c_preempt.inc(n - pushed, **{"class": cls})
                self._preempt_pushed[cls] = n
        for i, (ctr, total) in enumerate((
                (c_prop, self.total_spec_proposed), (c_acc, self.total_spec_accepted),
                (c_tree, self.total_spec_tree_passes), (c_budget, self.total_spec_budget_reallocs))):
            if total > self._spec_pushed[i]:
                ctr.inc(total - self._spec_pushed[i])
                self._spec_pushed[i] = total
        g_rate.set(self.total_spec_accepted / max(1, self.total_spec_proposed))
        g_tpp.set(self.total_row_tokens / max(1, self.total_row_passes))
        g_tree_depth.set(self.total_spec_tree_depth / max(1, self.total_spec_tree_rows))
        g_gram_seqs.set(sum(1 for s in self._running if s.grammar is not None))
        g_gram_mask.set(self.total_grammar_mask_s)
        if self._lora_pool is not None:
            g_lora_res.set(self._lora_pool.resident)
            if self._lora_pool.pageins > self._lora_pushed:
                c_lora_swap.inc(self._lora_pool.pageins - self._lora_pushed)
                self._lora_pushed = self._lora_pool.pageins
        g_lora_s.set(self.total_lora_s)
        g_tier_hit.set(self.tiers.hit_rate)
        fl = self.tiers.fleet
        for i, (ctr, total) in enumerate((
                (c_tier_prot, self.tiers.protected_evictions),
                (c_g4_hit, fl.hits if fl else 0), (c_g4_evict, fl.evictions if fl else 0),
                (c_g4_dedup, fl.dedup_blocks if fl else 0))):
            if total > self._tier_pushed[i]:
                ctr.inc(total - self._tier_pushed[i])
                self._tier_pushed[i] = total

    @staticmethod
    def _build_tiers(args: EngineArgs) -> TierStack:
        host = HostBlockPool(args.host_kv_blocks) if args.host_kv_blocks > 0 else None
        disk = DiskBlockPool(args.disk_kv_dir, args.disk_kv_blocks) if args.disk_kv_dir else None
        fleet = (FleetBlockPool(args.fleet_kv_dir, args.fleet_kv_blocks)
                 if args.fleet_kv_dir else None)
        return TierStack(host, disk, fleet, unit_bytes=args.kv_bytes_per_block())

    @property
    def total_preemptions(self) -> int:
        return sum(self.total_preemptions_by.values())

    def metrics(self) -> ForwardPassMetrics:
        """Load snapshot for the KV router (the worker's load_metrics
        endpoint)."""
        with self._mutex:
            running, waiting = len(self._running), len(self._waiting) + len(self._submissions)
        return ForwardPassMetrics(
            worker=WorkerStats(
                request_active_slots=running,
                request_total_slots=self.args.max_num_seqs,
                num_requests_waiting=waiting,
            ),
            kv=KvStats(
                kv_active_blocks=self.pool.num_active,
                kv_total_blocks=self.pool.num_blocks - 1,
                gpu_cache_usage_perc=self.pool.usage,
                gpu_prefix_cache_hit_rate=self.pool.hit_rate,
            ),
        )

    def clear_kv_blocks(self) -> int:
        """Drop every idle cached block (admin clear-KV) → count."""
        return self.pool.clear()

    def _flush_offloads(self) -> None:
        """Write queued sealed blocks through to the tiers: one batched page
        gather per call (at most MAX_OFFLOAD_PER_STEP blocks) and its
        device→host copy, started without waiting. The gather is enqueued
        before any later dispatch, so it reads a block before a later
        allocation can rewrite it. The blocks enter the tiers once their
        copy has landed (``_drain_offload_fetches``, here and at later
        flushes): at once on the CPU, where the tiers see each put at the
        point where the JAX engine's synchronous flush makes it."""
        if not self._offload_pending and not self._offload_fetches:
            return
        t0 = time.perf_counter()
        self._drain_offload_fetches()
        if self._offload_pending:
            batch = self._offload_pending[: self.tiers.MAX_OFFLOAD_PER_STEP]
            del self._offload_pending[: len(batch)]
            arrs, n = self._runner.start_extract_pages([b for b, _ in batch])
            hashes = [h for _, h in batch]
            # Radix protection hint: branch points / live-shared blocks get
            # eviction credit in the tiers so one-off prompt bursts can't
            # flush the hot shared system-prefix blocks.
            protected = [self.pool.hash_protected(h) for h in hashes]
            self._offload_fetches.append((hashes, protected, start_host_fetch(arrs), n))
            self._offload_inflight.update(hashes)
            self.offload_flushes += 1
            self._drain_offload_fetches()
        self.offload_s += time.perf_counter() - t0

    def _drain_offload_fetches(self, force: bool = False) -> None:
        """Put the flushed blocks whose page copy has landed into the tiers,
        in flush order (``force``: wait for every copy). HostBlockPool.put
        copies each block's slice, so no tier keeps the pinned staging
        buffer."""
        while self._offload_fetches:
            hashes, protected, fetch, n = self._offload_fetches[0]
            if not force and not host_ready(fetch):
                return
            self._offload_fetches.popleft()
            pages = self._runner.finish_extract_pages(fetch, n)
            self.tiers.offload(
                [(h, *(a[:, i : i + 1] for a in pages)) for i, h in enumerate(hashes)],
                protected=protected,
            )
            self._offload_inflight.difference_update(hashes)
            self.offload_bytes += sum(int(a.nbytes) for a in pages)

    @property
    def runner(self) -> LocalRunner:
        return self._runner

    def set_spec(self, **fields) -> None:
        """Change speculative-decoding knobs (``EngineArgs`` spec_* fields)
        of an idle engine, so that one warmed engine can serve the same
        requests in several modes (dense, fused, stepwise, tree), as the
        JAX engine's ``spec_tokens`` toggle does. Rebuilds the drafter;
        new verify shapes are captured by ``runner.warm_spec`` or at first
        use."""
        if self.busy():
            raise RuntimeError("set_spec needs an idle engine")
        for name, value in fields.items():
            if not name.startswith("spec_") or not hasattr(self.args, name):
                raise ValueError(f"not a speculative-decoding knob: {name!r}")
            setattr(self.args, name, value)
        self.args.__post_init__()
        self._drafter = build_drafter(self.args)
        self.spec_tokens = self.args.spec_tokens
        self.spec_budget_adaptive = self.args.spec_budget_adaptive

    async def run_on_engine_thread(self, fn):
        """Run ``fn()`` on the scheduler thread between steps and await its
        result (the JAX engine's seam for work that must not interleave with
        dispatch, such as holding the scheduler while a batch of requests
        is submitted). Not a serving-path API."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        with self._wakeup:
            if self._stopping:
                raise RuntimeError("engine is stopping")
            self._host_jobs.append((fn, fut, loop))
            self._wakeup.notify()
        return await fut

    @staticmethod
    def _serve_host_job(fn, fut, loop) -> None:
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 — surface to the caller
            err = e
            loop.call_soon_threadsafe(
                lambda: fut.set_exception(err) if not fut.cancelled() else None)
            return
        loop.call_soon_threadsafe(lambda: fut.set_result(result) if not fut.cancelled() else None)

    def busy(self) -> bool:
        """Anything submitted, running or still in flight (a racy read)."""
        return bool(self._submissions or self._waiting or self._running or self._fetchq)

    # -- grammar-constrained decoding -------------------------------------

    def _compile_grammar(self, rf: dict):
        """response_format dict → CompiledGrammar (None = unconstrained).
        Called through to_thread from generate(); the compiler is built
        once per engine over the serving tokenizer's vocabulary and caches
        by schema hash, so requests sharing a schema pay its DFA once."""
        comp = self._grammar_compiler
        if comp is None:
            with self._grammar_lock:
                comp = self._grammar_compiler
                if comp is None:
                    comp = build_compiler(self.args.grammar_tokenizer, self.cfg.vocab_size)
                    self._grammar_compiler = comp
        return comp.compile(rf)

    def _grammar_row_masks(self, seqs: list[_Seq], B: int) -> np.ndarray | None:
        """Per-row packed grammar masks of a dense sampling dispatch
        (admission first tokens, single steps) → [B, W32] uint32, or None
        when no row is constrained (the unmasked dispatch: unconstrained
        traffic never pays for the mask). Unconstrained rows of a mixed
        batch ride all-ones masks, under which sampling is unchanged."""
        if not any(s.grammar is not None for s in seqs):
            return None
        t0 = time.perf_counter()
        masks = np.full((B, mask_words(self.cfg.vocab_size)), 0xFFFFFFFF, np.uint32)
        for i, s in enumerate(seqs):
            if s.grammar is not None:
                masks[i] = s.grammar.mask(s.grammar_state, s.grammar_eos_bits)
        self.total_grammar_mask_s += time.perf_counter() - t0
        return masks

    def _build_tree_masks(self, batch: list[_Seq], B: int, S1: int,
                          node_tokens: list[list[int]], node_parents: list[list[int]]
                          ) -> np.ndarray:
        """Per-(row, node) packed grammar masks of one tree verify pass →
        [B, S1, W32] uint32. Node j masks by its own FSM state, reached by
        walking the draft tokens from the row's state down the parent
        chain: node j's logits are what its children are checked against
        and what its correction or bonus token samples from. Unconstrained
        rows and dead slots ride all-ones masks; an illegal draft node
        (which pruned drafting never makes) keeps its parent's state and
        is never accepted, its own edge probability being masked to 0."""
        t0 = time.perf_counter()
        masks = np.full((B, S1, mask_words(self.cfg.vocab_size)), 0xFFFFFFFF, np.uint32)
        for i, seq in enumerate(batch):
            g = seq.grammar
            if g is None:
                continue
            states = [seq.grammar_state]
            masks[i, 0] = g.mask(states[0], seq.grammar_eos_bits)
            toks_i, pars_i = node_tokens[i], node_parents[i]
            for j in range(1, len(toks_i)):
                st = g.advance(states[pars_i[j]], toks_i[j])
                states.append(st if st is not None else states[pars_i[j]])
                masks[i, j] = g.mask(states[j], seq.grammar_eos_bits)
        self.total_grammar_mask_s += time.perf_counter() - t0
        return masks

    # -- embeddings --------------------------------------------------------

    async def embed(self, token_ids: list[int]) -> list[float]:
        """Mean-pooled final hidden state of ``token_ids`` (/v1/embeddings),
        computed on the scheduler thread between steps (device dispatch
        affinity)."""
        if not token_ids:
            raise RequestValidationError("empty input")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        with self._wakeup:
            if self._stopping:
                raise RuntimeError("engine is stopping")
            self._embed_jobs.append((list(token_ids), fut, loop))
            self._wakeup.notify()
        return await fut

    def _serve_embed(self, token_ids: list[int], fut, loop) -> None:
        """One embedding job. Inputs longer than ``max_prefill_tokens``
        chunk-pool as in the JAX engine: each chunk embeds on its own and
        the chunk vectors average weighted by their token counts. Each
        chunk is padded to a block multiple, as a prefill chunk is (the
        port has no prefill bucket ladder); padded positions are masked
        out of attention and of the mean."""
        try:
            if len(token_ids) > self.args.max_model_len:
                raise RequestValidationError(
                    f"input of {len(token_ids)} tokens exceeds max_model_len "
                    f"of {self.args.max_model_len}"
                )
            n, bs = self.args.max_prefill_tokens, self.args.block_size
            chunks = [token_ids[i : i + n] for i in range(0, len(token_ids), n)]
            vecs = []
            for chunk in chunks:
                toks = np.zeros((-(-len(chunk) // bs) * bs,), np.int32)
                toks[: len(chunk)] = chunk
                vecs.append(self._runner.embed(toks, len(chunk)))
            acc = None
            for chunk, v in zip(chunks, vecs):
                v = v.cpu().numpy().astype(np.float64) * len(chunk)
                acc = v if acc is None else acc + v
            vec = [float(x) for x in acc / len(token_ids)]
        except Exception as e:  # noqa: BLE001 — surface to the caller
            err = e
            loop.call_soon_threadsafe(
                lambda: fut.set_exception(err) if not fut.cancelled() else None)
            return
        loop.call_soon_threadsafe(lambda: fut.set_result(vec) if not fut.cancelled() else None)

    # -- multi-LoRA adapter multiplexing ------------------------------------
    #
    # The JAX engine's serving shape (Punica BGMV + S-LoRA unified paging,
    # engine/lora.py): the bank holds args.lora_slots resident adapters and
    # the registry may hold many more. A cold adapter pages in at admission
    # (only that request's admission waits; the upload is ordered on the
    # compute stream behind the windows in flight), its factor pages living
    # in the same G2/G3/G4 pools as KV blocks under adapter_tier_hash keys,
    # and a cold resident pages out under the slot pool's second-chance
    # pressure. Rows carry adapter_slot (-1 = base) into every dispatch;
    # base-only batches pass None and replay the pre-LoRA graphs.

    def register_adapter(self, name: str, rank: int | None = None, seed: int = 0,
                         scaling: float = 1.0, targets: str = "qkvo",
                         pages: tuple | None = None) -> None:
        """Register one servable adapter. ``pages``: its factor pages
        (checkpoint loaders), else deterministic factors from (name, seed).
        Write-through: the pages land in the tiers now, so a later slot
        eviction is free and a cold page-in is a tier read. Thread-safe;
        callable while serving."""
        if self._lora_pool is None:
            raise RequestValidationError("engine has no adapter bank (lora_slots=0)")
        spec = LoraAdapterSpec(name=name, rank=rank if rank is not None else self.args.lora_rank,
                               seed=seed, scaling=scaling, targets=targets)
        if spec.rank > self.args.lora_rank:
            raise RequestValidationError(
                f"adapter {name!r} rank {spec.rank} exceeds lora_rank={self.args.lora_rank}")
        if self.tiers.enabled:
            tier_pages = (pages if pages is not None
                          else make_adapter_pages(self.cfg, spec, self.args.lora_rank))
            self.tiers.put_object(adapter_tier_hash(name), *tier_pages)
        # Caller-provided pages cannot be made again from the spec, so they
        # stay pinned in the registry: the tiers are a cache (adapter
        # objects compete with KV blocks and can be evicted end to end),
        # never the only copy. Seed-made adapters pin nothing.
        with self._lora_lock:
            self._lora_registry[name] = (spec, pages)

    def adapters(self) -> list[str]:
        """Registered adapter names (thread-safe)."""
        with self._lora_lock:
            return sorted(self._lora_registry)

    def lora_stats(self) -> dict:
        """Slot-pool residency and swap counters (a racy snapshot)."""
        if self._lora_pool is None:
            return {}
        return self._lora_pool.stats()

    def _adapter_pages(self, spec: LoraAdapterSpec, pinned: tuple | None) -> tuple:
        """One adapter's factor pages: a tier hit (G2, or G3/G4 promoted to
        G2), the registry's pinned pages (written back to the tiers), or
        made again from the spec's seed and written back. Tier hits and
        misses feed tier_hit_rate, as KV blocks do."""
        h = adapter_tier_hash(spec.name)
        if self.tiers.enabled:
            pages = self.tiers.get_object(h)
            if pages is not None:
                return pages
        if pinned is not None:
            if self.tiers.enabled:
                self.tiers.put_object(h, *pinned)
            return pinned
        pages = make_adapter_pages(self.cfg, spec, self.args.lora_rank)
        if self.tiers.enabled:
            self.tiers.put_object(h, *pages)
        return pages

    def _acquire_adapter(self, seq: _Seq) -> None:
        """seq.adapter_id → a pinned bank slot, uploading on a cold miss.
        Raises RequestValidationError (no bank, unknown adapter) or
        NoFreeAdapterSlotsError (every slot pinned: admission requeues the
        request and retries once running sequences release pins)."""
        if self._lora_pool is None:
            raise RequestValidationError(
                f"request names adapter {seq.adapter_id!r} but this engine has no adapter "
                "bank (lora_slots=0)")
        with self._lora_lock:
            entry = self._lora_registry.get(seq.adapter_id)
        if entry is None:
            raise RequestValidationError(f"unknown adapter {seq.adapter_id!r}")
        spec, pinned = entry
        t0 = time.perf_counter()
        slot, needs_upload, _evicted = self._lora_pool.acquire(seq.adapter_id)
        if needs_upload:
            try:
                self._runner.upload_adapter(slot, self._adapter_pages(spec, pinned))
            except BaseException:
                # The upload never landed: drop the residency, not just the
                # pin, or the next acquire would skip the upload.
                self._lora_pool.drop(seq.adapter_id)
                raise
            self.lora_pagein_s += time.perf_counter() - t0
        seq.adapter_slot = slot
        self.total_lora_s += time.perf_counter() - t0

    def _release_adapter(self, seq: _Seq) -> None:
        if seq.adapter_slot >= 0 and self._lora_pool is not None:
            self._lora_pool.release(seq.adapter_id)
        seq.adapter_slot = -1

    def _adapter_row_slots(self, seqs: list[_Seq], B: int) -> np.ndarray | None:
        """The per-row adapter slots of one dispatch → [B] int32 (-1 =
        base), or None when no row carries an adapter: the pre-LoRA
        variant, so base-only traffic pays nothing and matches a no-LoRA
        engine byte for byte."""
        if not any(s.adapter_slot >= 0 for s in seqs):
            return None
        t0 = time.perf_counter()
        slots = np.full((B,), -1, np.int32)
        for i, s in enumerate(seqs):
            slots[i] = s.adapter_slot
        self.total_lora_s += time.perf_counter() - t0
        return slots

    # -- async API --------------------------------------------------------

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        """PreprocessedRequest (or its dict) in → LLMEngineOutput dicts out."""
        req = request if isinstance(request, PreprocessedRequest) else PreprocessedRequest.from_dict(request)
        if not req.token_ids:
            yield LLMEngineOutput(finish_reason=FinishReason.ERROR, error="empty prompt").to_dict()
            return
        vocab = self.cfg.vocab_size
        if any(not (0 <= int(t) < vocab) for t in req.token_ids):
            yield LLMEngineOutput(
                finish_reason=FinishReason.ERROR, error=f"token id out of range [0, {vocab})",
            ).to_dict()
            return
        s = req.sampling
        if s.top_logprobs:
            s.top_logprobs = min(s.top_logprobs, self.args.top_logprobs_max) if s.logprobs else 0
        # Grammar-constrained decoding: compile (or hit the cache for) the
        # token-mask FSM of this request's response_format off the event
        # loop and the scheduler thread. A malformed spec errors this
        # stream only (the frontend already answers it with a 400).
        grammar = None
        if req.response_format:
            try:
                grammar = await asyncio.to_thread(self._compile_grammar, req.response_format)
            except GrammarError as e:
                yield LLMEngineOutput(finish_reason=FinishReason.ERROR,
                                      error=f"invalid response_format: {e}").to_dict()
                return
        queue: asyncio.Queue = asyncio.Queue()
        t_submit = time.perf_counter()
        seq = _Seq(context.id, req, queue)
        # Span lineage across relocation: a resumed leg that arrives without
        # a trace re-anchors on the traceparent its cutover identity carried.
        resume_tp = ((req.kv_transfer_params or {}).get("resume") or {}).get("traceparent")
        if context.trace is None and resume_tp:
            try:
                context.trace = TraceContext.parse(str(resume_tp))
            except Exception:  # noqa: BLE001 — a malformed carried traceparent must never fail the resumed leg
                pass
        seq.traceparent = context.trace.traceparent() if context.trace is not None else None
        if grammar is not None:
            seq.grammar = grammar
            seq.grammar_state = grammar.start
            seq.grammar_eos_bits = pack_token_ids(seq.eos_ids, self.cfg.vocab_size)
            self.total_grammar_seqs += 1
            if seq.prompt_len < len(seq.tokens):
                # A resumed leg: the tokens past the original prompt were
                # generated under this grammar on an earlier leg, so the FSM
                # replays them and masking continues from the state reached.
                st = grammar.start
                for t in seq.tokens[seq.prompt_len:]:
                    if t in seq.eos_ids:
                        break
                    ns = grammar.advance(st, t)
                    if ns is None:
                        break
                    st = ns
                seq.grammar_state = st
        if not self.args.qos_scheduling:
            seq.qos_rank = 0  # one class: FIFO admission, newest-first preempt
        with self._wakeup:
            if self._stopping:
                raise RuntimeError("engine is stopping")
            self._arrival_no += 1
            seq.arrival = self._arrival_no
            self._submissions.append(seq)
            self._wakeup.notify()

        async def watch_cancel():
            await context.wait_cancelled()
            with self._wakeup:
                seq.cancelled = True
                self._wakeup.notify()

        watcher = asyncio.get_running_loop().create_task(watch_cancel())
        dspan = tracing.NOOP_SPAN
        first = True
        # Emit coalescing: merge the backlog of deltas already sitting in the
        # queue into one frame (bounded by delta_max_tokens; optional
        # delta_max_ms gather wait after the first delta). The first delta is
        # never held (TTFT), and a finish delta ends the merge so it rides
        # the same frame as its tokens.
        cap = self.args.delta_max_tokens
        gather_s = self.args.delta_max_ms / 1000.0
        pending: Any = None
        try:
            while True:
                item = pending if pending is not None else await queue.get()
                pending = None
                if cap > 0 and isinstance(item, dict) and not item.get("finish_reason"):
                    deadline = (time.monotonic() + gather_s
                                if gather_s > 0.0 and not first else None)
                    while (pending is None and len(item.get("token_ids") or ()) < cap
                           and not item.get("finish_reason")):
                        if not queue.empty():
                            nxt = queue.get_nowait()
                        elif deadline is not None:
                            wait = deadline - time.monotonic()
                            if wait <= 0:
                                break
                            try:
                                nxt = await asyncio.wait_for(queue.get(), wait)
                            except asyncio.TimeoutError:
                                break
                        else:
                            break
                        if not isinstance(nxt, dict):
                            pending = nxt  # _SENTINEL_DONE: deliver after item
                            break
                        if (len(item.get("token_ids") or ())
                                + len(nxt.get("token_ids") or ())) > cap:
                            pending = nxt  # merging would exceed the cap
                            break
                        merged = coalesce_delta(item, nxt)
                        if merged is None:
                            pending = nxt
                            break
                        item = merged
                if item is _SENTINEL_DONE:
                    return
                if first and tracing.enabled() and context.trace is not None:
                    # Queue and prefill from the scheduler thread's admission
                    # stamp, recorded at the first delta; decode is live from
                    # here.
                    t0 = now = time.perf_counter()
                    t_admit = seq.t_admit or now
                    tracing.record_interval("engine.queue", context.trace,
                                            start=t_submit, end=t_admit)
                    tracing.record_interval("engine.prefill", context.trace,
                                            start=t_admit, end=now,
                                            prompt_tokens=seq.prompt_len,
                                            cached_blocks=seq.prefix_hit_blocks)
                    dspan = tracing.start_span("engine.decode", parent=context.trace)
                    self.traced_requests += 1
                    self.trace_s += time.perf_counter() - t0
                first = False
                yield item
                if item.get("finish_reason"):
                    return
        finally:
            if dspan.recording:
                t0 = time.perf_counter()
                dspan.set_attrs(tokens=seq.emitted)
                dspan.end(status="cancelled" if seq.cancelled else None)
                self.trace_s += time.perf_counter() - t0
            watcher.cancel()
            with self._wakeup:
                seq.cancelled = True  # no-op if already finished

    # -- scheduler loop (engine thread) -----------------------------------

    def _run(self) -> None:
        crashed = False
        try:
            while True:
                with self._wakeup:
                    while (not self._stopping and not self._submissions
                           and not self._waiting and not self._running
                           and not self._embed_jobs and not self._host_jobs):
                        if self._migrations:
                            # A frozen cutover must still see its deadline
                            # on an otherwise idle engine: a bounded sleep,
                            # then a (cheap) step.
                            self._wakeup.wait(timeout=0.02)
                            break
                        self._wakeup.wait()
                    if self._stopping:
                        break
                    while self._submissions:
                        self._waiting.append(self._submissions.popleft())
                self._step()
        except Exception:  # noqa: BLE001 — engine death must not be silent
            crashed = True
            log.exception("engine loop crashed")
        finally:
            self._export_fetches.clear()
            with self._mutex:
                exports = [item for item, _dl in self._exports.values()]
            for item in exports:
                if isinstance(item, KvStreamExport):
                    item.abort("engine_stopped")  # no-op when sealed
            with self._wakeup:
                self._stopping = True
                leftovers = list(self._running) + list(self._waiting) + list(self._submissions)
                # Frozen mid-cutover sequences live in no queue: without a
                # terminal post their client streams would hang.
                leftovers += [m.seq for m in self._migrations.values()
                              if m.frozen and not m.seq.dead]
                for m in self._migrations.values():
                    m.stream.abort("engine_stopped")
                    m.seq.mig = None
                self._migrations.clear()
                self._running.clear()
                self._waiting.clear()
                self._submissions.clear()
                jobs = list(self._host_jobs) + list(self._embed_jobs)
                self._host_jobs.clear()
                self._embed_jobs.clear()
            # Pending host-job and embedding futures resolve too, or their
            # awaiters would hang.
            for _fn, fut, loop in jobs:
                exc = RuntimeError("engine loop crashed" if crashed else "engine stopped")
                loop.call_soon_threadsafe(
                    lambda f=fut, e=exc: f.set_exception(e) if not f.cancelled() else None)
            reason = FinishReason.ERROR if crashed else FinishReason.CANCELLED
            err = "engine loop crashed" if crashed else None
            for seq in leftovers:
                self._post(seq, LLMEngineOutput(finish_reason=reason, error=err).to_dict())
                self._post_done(seq)

    def _phase(self, key: str, t0: float) -> float:
        """Add perf_counter() - t0 to phase ``key``; → the new t0."""
        t1 = time.perf_counter()
        self.phase_s[key] += t1 - t0
        return t1

    def _step(self) -> None:
        self._step_no += 1
        # Harvest whatever fetches completed while the host was away: frees
        # slots and blocks and finds stops early, and costs nothing when
        # the head of the queue is still in flight.
        self._drain_completed()
        if self._export_fetches:
            self._drain_export_fetches()
        self._reap_cancelled()
        while self._embed_jobs:
            self._serve_embed(*self._embed_jobs.popleft())
        while self._host_jobs:
            self._serve_host_job(*self._host_jobs.popleft())
        if self._exports:
            self._reap_exports()
        if self._migrations:
            self._service_migrations()
        if self.kv_pressure_offer > 0.0:
            self._maybe_pressure_offer()
        t0 = time.perf_counter()
        allocated: list[tuple[_Seq, int]] = []  # (seq, suffix start)
        budget = self.args.admission_budget_tokens or (1 << 62)
        # Frozen mid-cutover sequences are out of _running but keep their
        # chain slot (and KV) until the handoff resolves: admission must not
        # oversubscribe the slots past them.
        frozen = sum(1 for m in self._migrations.values() if m.frozen)
        while (
            self._waiting
            and len(self._running) + len(allocated) + frozen < self.args.max_num_seqs
            and (budget > 0 or not allocated)
        ):
            seq = self._pop_next_waiting()
            if seq.cancelled:
                self._post_done(seq)
                continue
            budget -= len(seq.tokens)
            try:
                start = self._admit_alloc(seq)
            except NoFreeBlocksError:
                self._waiting.appendleft(seq)  # try again when blocks free up
                if not self._running and not allocated and not self._migrations:
                    # Nothing will ever free: fail it. (A frozen migration
                    # frees its blocks within the cutover window either way.)
                    self._waiting.remove(seq)
                    self._finish(seq, FinishReason.ERROR, error="prompt does not fit in KV cache")
                break
            except RequestValidationError as e:
                self._finish(seq, FinishReason.ERROR, error=str(e))
                continue
            seq.t_admit = time.perf_counter()
            allocated.append((seq, start))
        t0 = self._phase("admission", t0)
        if allocated:
            self._admit(allocated)
        if self._running:
            self._decode_iteration()
            self._flush_offloads()
        elif self._fetchq:
            # Every owner of the queued fetches died during a drain: release
            # them (the idle wait in _run ignores _fetchq).
            self._drain_completed(force=True)
        if self._offload_fetches and not self._running:
            # Going idle: land the page copies still in flight, so the
            # tiers hold every flushed block while nothing runs (the idle
            # wait in _run ignores them too).
            self._drain_offload_fetches(force=True)
        self._update_gauges()

    def _admit(self, allocated: list[tuple[_Seq, int]]) -> None:
        """Prefill an admission wave and sample its first tokens on the
        device, folded into each sequence's chain slot; the wave's fetch
        joins the queue (async admission), so the next window can chain
        from the samples while they travel to the host."""
        seqs = [s for s, _ in allocated]
        t0 = time.perf_counter()
        try:
            logits = [self._prefill(seq, start) for seq, start in allocated]
            t0 = self._phase("prefill", t0)
            B = self.args.bucket_decode(len(seqs))
            for s in seqs:
                s.slot = self._free_slots.pop()
            slots = np.full((B,), self.args.max_num_seqs, np.int32)
            slots[: len(seqs)] = [s.slot for s in seqs]
            top_n = self._top_n(seqs)
            ref = self._sample_rows_device(logits + [logits[0]] * (B - len(seqs)), seqs, slots,
                                           top_n)
        except Exception as e:  # noqa: BLE001 — contain wave faults to the wave
            log.exception("prefill failed")
            for seq in seqs:
                self._finish(seq, FinishReason.ERROR, error=f"prefill failed: {e}")
            return
        first = _First([(s, i) for i, s in enumerate(seqs)],
                       start_host_fetch(self._fetch_arrays(ref, top_n)))
        self._phase("first_dispatch", t0)
        for seq in seqs:
            seq.first_pend = True
            self._running.append(seq)
        self._fetchq.append(first)
        # Prefill-only requests (max_tokens=1) finish at the first token:
        # resolve just this wave now (its rows ride no earlier queued item,
        # so draining it out of order is safe), so they never ride a
        # decode window as instant zombies.
        if any(s.stop.max_tokens == 1 for s in seqs):
            self._fetchq.pop()
            self._drain_one(first)

    def _reap_cancelled(self) -> None:
        for seq in [s for s in self._running if s.cancelled]:
            self._finish(seq, FinishReason.CANCELLED)
        for seq in [s for s in self._waiting if s.cancelled]:
            self._waiting.remove(seq)
            self._post_done(seq)

    # -- admission / prefill ----------------------------------------------

    def _pop_next_waiting(self) -> _Seq:
        """(class, age)-ordered admission: the highest-rank class first,
        oldest arrival within it — a waiting interactive request admits
        ahead of queued batch work, including into blocks a batch
        preemption just freed. Uniform-rank traffic (no-QoS, or
        qos_scheduling off) reduces to EXACT FIFO: _waiting is
        arrival-ordered (appendleft re-queues — preempted or
        blocks-starved seqs — are always the oldest arrivals, since
        admission itself drains oldest-first), so min arrival IS the
        leftmost element and this selection is byte-identical to a
        popleft."""
        best = max(self._waiting, key=lambda s: (s.qos_rank, -s.arrival))
        self._waiting.remove(best)
        return best

    def _admit_alloc(self, seq: _Seq) -> int:
        """Allocate KV blocks and resolve prefix hits (local cache, tier
        onboard, disagg or peer inject) → suffix start."""
        # Flush queued offloads BEFORE allocating: allocation may evict and
        # recycle exactly the pages still waiting to be copied out.
        self._flush_offloads()
        # Adapter residency first (before any block allocation, so a failure
        # here has nothing to unwind): pin the request's adapter into a bank
        # slot, paging it in on a cold miss. A request that finds every slot
        # pinned requeues (NoFreeAdapterSlotsError is a NoFreeBlocksError);
        # its wait for a slot is timed.
        acquired = False
        if seq.adapter_id is not None and seq.adapter_slot < 0:
            try:
                self._acquire_adapter(seq)
            except NoFreeAdapterSlotsError:
                seq.adapter_wait_t0 = seq.adapter_wait_t0 or time.perf_counter()
                raise
            if seq.adapter_wait_t0:
                self.lora_slot_waits += 1
                self.lora_slot_wait_s += time.perf_counter() - seq.adapter_wait_t0
                seq.adapter_wait_t0 = 0.0
            acquired = True
        try:
            return self._admit_alloc_blocks(seq)
        except BaseException:
            if acquired:
                self._release_adapter(seq)
            raise

    def _admit_alloc_blocks(self, seq: _Seq) -> int:
        bs = self.args.block_size
        prompt = seq.tokens
        plen = len(prompt)
        if plen > self.args.max_model_len - 1:
            raise RequestValidationError("prompt exceeds max_model_len")
        # KV identity is (tokens, adapter): the hash seed is salted by the
        # adapter id, so adapter KV never prefix-hits another identity's
        # blocks, in G1, the tiers, KV events and peer fetches alike.
        hashes = compute_block_hashes(prompt, bs, seq.hash_seed)
        # Never reuse the entire prompt: at least one token must be
        # computed to produce logits.
        max_hit = (plen - 1) // bs
        total_blocks = (plen + bs - 1) // bs
        block_ids, n_hit = self.pool.allocate_sequence(hashes[:max_hit], total_blocks)
        seq.block_ids = block_ids
        seq.prefix_hit_blocks = n_hit
        seq.block_seq = TokenBlockSequence(prompt, bs, seq.hash_seed)
        start = n_hit * bs
        # G2/G3/G4 onboard: blocks evicted from G1 but still in a tier
        # re-enter as a prefix hit instead of being recomputed, written in
        # place like an inject. Runs BEFORE a remote inject: a peer payload
        # may start past the tiers' coverage (llm/peer_kv.py delta fetch).
        if self.tiers.enabled and n_hit < max_hit:
            t0 = time.perf_counter()
            run = self.tiers.lookup_run(hashes[n_hit:max_hit])
            if run:
                # Per-block page tuples → one batched inject; blocks a
                # persistent tier directory stored in the other page format
                # are bridged to this cache's.
                pages = kv_transfer.concat_page_run(
                    run, quantized=self.args.kv_quant == "int8",
                    num_kv_heads=self.cfg.num_kv_heads, dtype=self.args.dtype)
                n_onb = n_hit + len(run)
                self._runner.inject_pages(seq.block_ids[n_hit:n_onb], *pages)
                self.onboard_bytes += sum(int(a.nbytes) for a in pages)
                n_hit = n_onb
                start = n_hit * bs
                seq.prefix_hit_blocks = n_hit
            self.onboard_s += time.perf_counter() - t0
        # Disagg: pre-load remotely prefilled pages as a materialized
        # prefix hit; the suffix (at least one token) is recomputed here,
        # which also gives the first token's logits.
        if seq.inject is not None:
            start, n_hit = self._inject_kv(seq, n_hit, max_hit)
            seq.prefix_hit_blocks = n_hit
        # Streaming export: register the stream at admission, so the
        # decode worker's kv_fetch can pull while the prefill runs; blocks
        # already in the cache (a prefix hit) publish as chunk 0 now.
        if seq.export and seq.export_handle:
            exp = KvStreamExport(seq.export_handle, max_buffer_bytes=TRANSFER_BUFFER_BYTES)
            seq.export_stream = exp
            with self._mutex:
                self._exports[seq.export_handle] = (exp, time.monotonic() + self.export_ttl_s)
            hit = min(start // bs, (plen - 1) // bs)  # full blocks only, like _export_kv
            if hit > 0:
                self._start_export_extract(seq, 0, hit)
        return start

    def _prefill(self, seq: _Seq, start: int):
        """Single-row prefill of positions [start, len) in chunks of at most
        max_prefill_tokens (each padded to a block multiple; chunks start
        on block boundaries) → last-token logits [V] on the device."""
        bs = self.args.block_size
        prompt = seq.tokens
        plen = len(prompt)
        table = np.asarray(seq.block_ids, np.int32)
        logits = None
        pos = start
        while pos < plen:
            n = min(self.args.max_prefill_tokens, plen - pos)
            toks = np.zeros((-(-n // bs) * bs,), np.int32)
            toks[:n] = prompt[pos : pos + n]
            logits = self._runner.prefill_chunk(
                toks, table, pos, pos + n, seq.adapter_slot if seq.adapter_slot >= 0 else None)
            self.total_prefill_padded += len(toks)
            pos += n
            # Streaming export: the blocks this chunk completed ship while
            # the next chunks compute (their gather is enqueued after this
            # chunk), and gathers that already landed publish now.
            if seq.export_stream is not None and seq.export_stream.abort_reason is None:
                done = min(pos // bs, (plen - 1) // bs)
                if done > seq.export_pub_blocks:
                    self._start_export_extract(seq, seq.export_pub_blocks, done)
                self._drain_export_fetches()
        self.total_prefilled += plen - start
        seq.kv_written = plen
        self._register_written_blocks(seq)
        if seq.export:
            self._export_kv(seq, plen)
        return logits

    def _register_written_blocks(self, seq: _Seq) -> None:
        """Register sealed blocks whose KV is fully written."""
        if seq.block_seq is None:
            return
        bs = self.args.block_size
        while (
            seq.registered_blocks < len(seq.block_seq.blocks)
            and (seq.registered_blocks + 1) * bs <= seq.kv_written
        ):
            blk = seq.block_seq.blocks[seq.registered_blocks]
            bid = seq.block_ids[seq.registered_blocks]
            self.pool.register_block(bid, blk.sequence_hash, blk.parent_sequence_hash)
            # Write-through offload: queue the sealed block for the next
            # flush (bounded; blocks G2 holds, or whose copy is in flight,
            # are skipped).
            if (
                self.tiers.enabled
                and len(self._offload_pending) < 256
                and not (self.tiers.host and self.tiers.host.contains(blk.sequence_hash))
                and blk.sequence_hash not in self._offload_inflight
            ):
                self._offload_pending.append((bid, blk.sequence_hash))
            seq.registered_blocks += 1

    # -- disaggregated export / inject -------------------------------------

    def _inject_kv(self, seq: _Seq, n_hit: int, max_hit: int) -> tuple[int, int]:
        """Write fetched pages into this sequence's blocks past the locally
        hit prefix. The payload's first page is prompt block
        ``block_offset`` (0 for disagg exports). → (new start position,
        new hit count)."""
        payload = seq.inject
        if isinstance(payload, dict) and payload.get("chunks") is not None:
            return self._inject_kv_chunks(seq, payload["chunks"], n_hit, max_hit)
        off = 0
        if isinstance(payload, dict):
            off = int(payload.get("block_offset") or 0)
            payload = kv_transfer.KvPagePayload.from_dict(payload)
        bs = self.args.block_size
        n_inj = min(off + payload.num_tokens // bs, max_hit, off + payload.k.shape[1])
        if n_inj <= n_hit or off > n_hit:
            # Already covered locally, or the payload starts past what the
            # cache holds: injecting would leave a KV gap, so recompute.
            return n_hit * bs, n_hit
        self._inject_run(seq.block_ids[n_hit:n_inj],
                         [a[:, n_hit - off : n_inj - off] for a in payload.pages()])
        seq.inject = None  # free host pages promptly
        return n_inj * bs, n_inj

    def _inject_kv_chunks(self, seq: _Seq, chunks: list, n_hit: int,
                          max_hit: int) -> tuple[int, int]:
        """Inject a streamed chunk list run by run (format bridging per
        chunk). Coverage must stay contiguous from the local hit
        boundary; a gap stops injection and the rest is recomputed."""
        bs = self.args.block_size
        n_cur = n_hit
        for ch in chunks:
            off = int(ch.get("block_offset") or 0)
            payload = kv_transfer.KvPagePayload.from_dict(ch)
            end = min(off + payload.k.shape[1], max_hit)
            if end <= n_cur:
                continue  # fully covered locally already
            if off > n_cur:
                break  # gap: injecting past it would leave a KV hole
            self._inject_run(seq.block_ids[n_cur:end],
                             [a[:, n_cur - off : end - off] for a in payload.pages()])
            n_cur = end
        seq.inject = None  # free host chunk buffers promptly
        return n_cur * bs, n_cur

    def _inject_run(self, block_ids: list[int], pages: list) -> None:
        t0 = time.perf_counter()
        self._runner.inject_pages(block_ids, *pages)
        self.inject_bytes += sum(int(a.nbytes) for a in pages)
        self.inject_s += time.perf_counter() - t0

    def _export_kv(self, seq: _Seq, plen: int) -> None:
        bs = self.args.block_size
        n_exp = (plen - 1) // bs  # full blocks only; the suffix is recomputed remotely
        if seq.export_stream is not None:
            # Streaming export: publish the remainder, drain this stream's
            # page fetches (blocking is fine: the prefill is done) and seal.
            meta = {"remote_handle": seq.export_handle, "stream": True,
                    "num_tokens": n_exp * bs, "num_blocks": n_exp}
            if n_exp > seq.export_pub_blocks and seq.export_stream.abort_reason is None:
                self._start_export_extract(seq, seq.export_pub_blocks, n_exp)
            self._drain_export_fetches(force_seq=seq)
            seq.export_stream.seal(num_blocks=n_exp, num_tokens=n_exp * bs)
            seq.export_meta = meta
            return
        meta = {"remote_handle": seq.request_id, "num_tokens": n_exp * bs, "num_blocks": n_exp}
        if n_exp > 0:
            t0 = time.perf_counter()
            pages = self._runner.extract_pages(seq.block_ids[:n_exp])
            payload = kv_transfer.KvPagePayload.from_pages(pages, n_exp * bs)
            self.export_s += time.perf_counter() - t0
            with self._mutex:
                self._exports[seq.request_id] = (payload, time.monotonic() + self.export_ttl_s)
        seq.export_meta = meta

    def _start_export_extract(self, seq: _Seq, lo: int, hi: int) -> None:
        """Enqueue the gather of blocks [lo, hi) of a streaming export and
        its device→host copy; harvested by _drain_export_fetches."""
        t0 = time.perf_counter()
        arrs, n = self._runner.start_extract_pages(seq.block_ids[lo:hi])
        self._export_fetches.append((seq, lo, hi, start_host_fetch(arrs), n))
        seq.export_pub_blocks = hi
        self.export_s += time.perf_counter() - t0

    def _drain_export_fetches(self, force_seq: _Seq | None = None) -> None:
        """Publish, as one chunk each, the streaming-export fetches whose
        copy has landed (never waiting); ``force_seq`` additionally waits
        for THAT sequence's fetches (seal time). Fetches whose stream died
        are dropped."""
        t0 = time.perf_counter()
        keep: list = []
        blocked: set[int] = set()
        bs = self.args.block_size
        for item in self._export_fetches:
            seq, lo, hi, fetch, n = item
            exp = seq.export_stream
            if exp is None or exp.abort_reason is not None:
                continue  # stream gone: release the buffers
            # Publish strictly in dispatch order per sequence: a later run
            # landing first would punch a gap in the consumer's contiguous
            # chunk stream.
            if id(seq) in blocked or (seq is not force_seq and not host_ready(fetch)):
                keep.append(item)
                blocked.add(id(seq))
                continue
            pages = self._runner.finish_extract_pages(fetch, n)
            exp.publish(KvChunk(block_offset=lo, pages=pages, num_tokens=(hi - lo) * bs))
        self._export_fetches = keep
        self.export_s += time.perf_counter() - t0

    def prefix_hit_length(self, token_ids: list[int], adapter_id: str | None = None) -> int:
        """Tokens of this prompt already resident in the local prefix cache
        (whole blocks), probed in the request's (model, adapter) identity
        domain: a locally cached prompt is not prefilled remotely.
        Thread-safe."""
        bs = self.args.block_size
        max_hit = (len(token_ids) - 1) // bs
        hashes = compute_block_hashes(token_ids, bs, adapter_hash_seed(adapter_id))[:max_hit]
        return len(self.pool.match_prefix(hashes)) * bs

    def take_export(self, handle: str):
        """→ KvPagePayload | None. One-shot: the caller owns the pages.
        Streaming exports are not served here (get_stream_export)."""
        with self._mutex:
            item = self._exports.get(handle)
            if item is not None and isinstance(item[0], KvStreamExport):
                return None
            item = self._exports.pop(handle, None)
        return item[0] if item else None

    def get_stream_export(self, handle: str) -> KvStreamExport | None:
        """→ the live streaming export for ``handle`` (not popped: the
        consumer pulls windows against it), or None. Each lookup refreshes
        the reap deadline, so the TTL bounds the time since the consumer
        last pulled, not the whole transfer. Thread-safe."""
        with self._mutex:
            item = self._exports.get(handle)
            if item is not None and isinstance(item[0], KvStreamExport):
                exp = item[0]
                self._exports[handle] = (exp, time.monotonic() + self.export_ttl_s)
                return exp
        return None

    def release_stream_export(self, handle: str) -> None:
        """Drop a fully delivered streaming export (the consumer saw
        kv_eos) and free its remaining host pages. Thread-safe."""
        with self._mutex:
            item = self._exports.pop(handle, None)
        if item is not None and isinstance(item[0], KvStreamExport):
            item[0].ack(item[0].chunk_count())

    def _reap_exports(self) -> None:
        now = time.monotonic()
        with self._mutex:
            dead = [h for h, (_, dl) in self._exports.items() if dl < now]
            reaped = [self._exports.pop(h) for h in dead]
        for item, _dl in reaped:
            if isinstance(item, KvStreamExport):
                # The consumer never finished pulling: tell a late puller
                # it is gone and free the buffered pages.
                item.abort("expired")
                item.ack(item.chunk_count())

    # -- live migration (engine side) --------------------------------------
    #
    # Protocol (worker/migrate.py drives it; every entry point below runs on
    # the scheduler thread via run_on_engine_thread), as in the JAX engine:
    #   begin    — register a KvStreamExport for a RUNNING decode; it keeps
    #              decoding while each step's newly sealed full blocks
    #              publish as chunks (the disagg credit-flow plane serves
    #              them to the destination, int8 scales riding along).
    #   cutover  — drain every pending device token, FREEZE the sequence
    #              (out of _running; slot and KV kept), publish the block
    #              delta since the stream cursor, seal, and return the
    #              resume identity (tokens, seed, sampler step, spec EMA,
    #              grammar state, next_write_pos).
    #   finish   — the destination committed: release this side's resources
    #              and post a {"migration": marker} frame; the Migration
    #              operator consumes it and re-dispatches the SAME client
    #              stream pinned to the destination. After the drain
    #              kv_written == len(tokens) - 1 (zombie substeps are never
    #              counted), so the sealed full blocks equal the
    #              destination's admission hit ceiling: it recomputes only
    #              the < block_size suffix and samples on at (seed,
    #              step_base).
    #   abort    — any failure (or the freeze deadline passing with no
    #              coordinator): unfreeze, re-enter _running where it left
    #              off, and decode on locally. The client never notices.

    def migration_begin(self, request_id: str) -> dict:
        """Start streaming a running decode's KV. → {"ok", "handle",
        "published"} or {"error"}. Scheduler thread only."""
        seq = next((s for s in self._running if s.request_id == request_id), None)
        if seq is None or seq.dead or seq.cancelled:
            return {"error": "not_running"}
        if seq.mig is not None:
            return {"error": "already_migrating"}
        if seq.export or seq.export_stream is not None:
            return {"error": "exporting"}  # disagg export seqs finish at token 1
        handle = f"mig-{request_id}-{self._step_no}"
        stream = KvStreamExport(handle)
        with self._mutex:
            self._exports[handle] = (stream, time.monotonic() + self.export_ttl_s)
        mig = _MigSt(seq, handle, stream)
        seq.mig = mig
        self._migrations[request_id] = mig
        self._pump_migration(mig)
        return {"ok": True, "handle": handle, "published": mig.pub_blocks,
                "traceparent": seq.traceparent}

    def migration_status(self, request_id: str) -> dict:
        """Cutover-lag probe: how far the stream cursor trails the KV
        actually written. Scheduler thread only."""
        mig = self._migrations.get(request_id)
        if mig is None:
            return {"error": "no_migration"}
        return {
            "ok": True,
            "published": mig.pub_blocks,
            "written": mig.seq.kv_written // self.args.block_size,
            "frozen": mig.frozen,
            "sealed": mig.stream.sealed,
            "aborted": mig.stream.abort_reason,
        }

    def migration_cutover(self, request_id: str) -> dict:
        """Freeze the sequence, ship the delta, seal the stream, and return
        the resume identity. Scheduler thread only."""
        mig = self._migrations.get(request_id)
        if mig is None:
            return {"error": "no_migration"}
        seq = mig.seq
        if mig.stream.abort_reason is not None:
            reason = mig.stream.abort_reason
            self._abort_migration(mig, reason)
            return {"error": f"stream_aborted:{reason}"}
        # Every device-pending token must be host-visible before the
        # identity is taken: the handoff carries exactly the tokens the
        # client will have seen. The drain may FINISH the sequence (a stop
        # in flight), or a preemption may have raced it: both tear the
        # migration down through the _finish/_preempt hooks.
        self._drain_completed(force=True)
        if self._migrations.get(request_id) is not mig:
            return {"error": "done" if seq.dead else "preempted"}
        if seq.dead or seq not in self._running:
            self._abort_migration(mig, "finished")
            return {"error": "done"}
        self._running.remove(seq)
        mig.frozen = True
        mig.freeze_deadline = time.monotonic() + self.migration_freeze_ttl_s
        self._pump_migration(mig, force=True)
        if mig.stream.abort_reason is not None:
            reason = mig.stream.abort_reason
            self._abort_migration(mig, reason)
            return {"error": f"stream_aborted:{reason}"}
        bs = self.args.block_size
        mig.stream.seal(num_blocks=mig.pub_blocks, num_tokens=mig.pub_blocks * bs)
        return {
            "ok": True,
            "handle": mig.handle,
            "kv_blocks": mig.pub_blocks,
            "emitted": seq.emitted,
            "adapter_id": seq.adapter_id,
            "request": {
                "token_ids": list(seq.tokens),
                "resume": {
                    "prompt_len": seq.prompt_len,
                    "sample_seed": seq.sample_seed,
                    "sample_step": seq.step_base + seq.emitted,
                    "spec_ema": seq.spec_ema,
                    "grammar_state": seq.grammar_state,
                    "next_write_pos": seq.next_write_pos,
                    "traceparent": seq.traceparent,
                },
            },
        }

    def migration_finish(self, request_id: str, marker: dict) -> dict:
        """Destination committed: hand the client stream off by posting the
        migration marker, then release this side's resources. The KV
        already lives in the sealed stream's host pages (and the
        destination's staged inject), so freeing the blocks is safe.
        Scheduler thread only."""
        mig = self._migrations.get(request_id)
        if mig is None or not mig.frozen:
            return {"error": "not_frozen"}
        seq = mig.seq
        self._migrations.pop(request_id, None)
        seq.mig = None
        seq.dead = True
        if seq.slot is not None:
            self._free_slots.append(seq.slot)
            seq.slot = None
        self._release_adapter(seq)
        self._purge_offloads(seq.block_ids)
        self.pool.free_sequence(seq.block_ids)
        seq.block_ids = []
        self._post(seq, {"token_ids": [], "migration": marker})
        self._post_done(seq)
        return {"ok": True}

    def migration_abort(self, request_id: str, reason: str) -> dict:
        """Coordinator-initiated teardown: the sequence resumes decoding
        locally (if frozen) and the stream aborts. Scheduler thread only."""
        mig = self._migrations.get(request_id)
        if mig is None:
            return {"error": "no_migration"}
        self._abort_migration(mig, reason)
        return {"ok": True}

    def _abort_migration(self, mig: _MigSt, reason: str) -> None:
        seq = mig.seq
        self._migrations.pop(seq.request_id, None)
        seq.mig = None
        mig.fetches = []  # drop the extracts in flight (their buffers are released)
        mig.stream.abort(reason)  # no-op when sealed
        mig.stream.ack(mig.stream.chunk_count())  # free buffered host pages
        with self._mutex:
            self._exports.pop(mig.handle, None)
        if mig.frozen and not seq.dead:
            # Unfreeze: re-enter the running batch where it left off (slot
            # and KV were kept, nothing is device-pending, so the next
            # window feeds its last token from the host).
            mig.frozen = False
            self._running.append(seq)

    def _service_migrations(self) -> None:
        """Once per step: pump streaming migrations, reap finished ones and
        hold the cutover freeze deadline (a dead coordinator must never
        wedge a frozen stream)."""
        now = time.monotonic()
        for rid in list(self._migrations):
            mig = self._migrations.get(rid)
            if mig is None:
                continue
            seq = mig.seq
            if seq.dead or seq.cancelled:
                self._abort_migration(mig, "finished")
                continue
            if mig.stream.abort_reason is not None:
                # Overrun (slow consumer) or TTL reap ("expired": the
                # consumer or the store died): the source keeps the stream,
                # unfreezes if needed and decodes on.
                self._abort_migration(mig, mig.stream.abort_reason)
                continue
            if mig.frozen:
                if now >= mig.freeze_deadline:
                    log.warning("migration %s cutover deadline exceeded; resuming locally", rid)
                    self._abort_migration(mig, "cutover_deadline")
                continue
            self._pump_migration(mig)

    def _pump_migration(self, mig: _MigSt, force: bool = False) -> None:
        """Publish the KV block delta written since the stream cursor. The
        page gather and its device→host copy are enqueued on the compute
        stream behind the windows in flight (never waiting for them) and
        published once landed, strictly in dispatch order; ``force`` waits
        for every one (the cutover's final delta, after its drain)."""
        if mig.stream.abort_reason is not None:
            return
        t0 = time.perf_counter()
        seq = mig.seq
        bs = self.args.block_size
        lo, hi = kv_transfer.delta_blocks(seq.kv_written, bs, mig.pub_blocks,
                                          len(seq.block_ids))
        if hi > lo:
            arrs, n = self._runner.start_extract_pages(seq.block_ids[lo:hi])
            mig.fetches.append((lo, hi, start_host_fetch(arrs), n))
            mig.pub_blocks = hi
        keep: list = []
        for item in mig.fetches:
            flo, fhi, fetch, n = item
            if keep or (not force and not host_ready(fetch)):
                keep.append(item)
                continue
            pages = self._runner.finish_extract_pages(fetch, n)
            if not mig.stream.publish(KvChunk(block_offset=flo, pages=pages,
                                              num_tokens=(fhi - flo) * bs)):
                break  # overrun: the stream aborted; _service_migrations tears it down
        mig.fetches = keep
        self.migration_pumps += 1
        self.migration_pump_s += time.perf_counter() - t0

    def list_running(self) -> list[str]:
        """Request ids in the running batch: the relocation candidates of
        pool moves and retirement. Thread-safe snapshot."""
        with self._wakeup:
            return [s.request_id for s in self._running if not s.dead]

    def _maybe_pressure_offer(self) -> None:
        """Proactive defrag: when KV pool usage crosses
        ``kv_pressure_offer``, fire the migration-offer hook for the
        CHEAPEST victim (fewest resident blocks, so the relocation streams
        the least KV) before allocation failure forces a recompute-
        preemption. Advisory: the relocation either frees the blocks
        (migration_finish) or nothing changes and the preemption boundary
        still owns correctness. Scheduler thread only; at most one offer
        per pressure window."""
        cb = self.migration_offer
        if cb is None or not self._running:
            return
        now = time.monotonic()
        if now < self._pressure_offer_next:
            return
        if self.pool.usage < self.kv_pressure_offer:
            return
        victim: _Seq | None = None
        for s in self._running:
            if s.dead or s.mig is not None or s.export:
                continue
            if victim is None or len(s.block_ids) < len(victim.block_ids):
                victim = s
        if victim is None:
            return
        self._pressure_offer_next = now + self.kv_pressure_offer_window_s
        self.pressure_offers += 1
        # The preemption-offer grace stamp too: if pressure keeps climbing
        # and this victim IS chosen for preemption inside the grace, the
        # kill waits for the relocation already running.
        victim.offer_deadline = now + self.preempt_offer_grace_s
        try:
            cb(victim.request_id)
        except Exception:  # noqa: BLE001 — the proactive offer is advisory; a broken hook must never stall the scheduler
            log.exception("kv-pressure migration offer hook failed")

    def _offer_migration_grace(self, victim: _Seq) -> bool:
        """QoS preemption offers migration before killing: with an offer
        hook wired, fire it once for the chosen victim and grant a bounded
        grace for the relocation to free its blocks. False (kill now) when
        unwired, when the hook fails, or when the victim's grace expired.
        Scheduler thread only."""
        cb = self.migration_offer
        if cb is None:
            return False
        now = time.monotonic()
        if victim.offer_deadline == 0.0:
            victim.offer_deadline = now + self.preempt_offer_grace_s
            try:
                cb(victim.request_id)
            except Exception:  # noqa: BLE001 — a broken offer hook must never block the preemption fallback
                log.exception("migration offer hook failed")
                return False
            return True
        return now < victim.offer_deadline

    # -- decode ------------------------------------------------------------

    def _ensure_block(self, seq: _Seq, lookahead: int) -> bool:
        """Cover write positions [next_write_pos, next_write_pos+lookahead)."""
        last_pos = seq.next_write_pos + lookahead - 1
        while len(seq.block_ids) * self.args.block_size <= last_pos:
            try:
                seq.block_ids.append(self.pool.allocate_block())
            except NoFreeBlocksError:
                return False
        return True

    def _preempt_victim(self) -> _Seq:
        """Class-aware victim selection: evict the LOWEST class first,
        newest admission within it — the newest victim has the least
        sunk prefill work, and a preempted batch request's freed blocks
        admit the waiting interactive request on the next step. Uniform
        ranks (no-QoS) select exactly ``self._running[-1]``, the
        newest-first rule."""
        best = self._running[-1]
        for s in self._running:  # later index = newer admission event
            if s.qos_rank <= best.qos_rank:
                best = s
        return best

    def _preempt(self, seq: _Seq) -> None:
        """Recompute-preemption: free blocks, requeue with all tokens as the
        new prompt (vLLM's recompute mode)."""
        self._drain_completed(force=True)  # pending tokens must be host-visible
        if seq.dead or seq not in self._running:
            return  # the drain finished it
        # An outbound migration of the victim tears down first: its KV is
        # about to be freed, so the stream can never complete. (Frozen
        # sequences are not in _running, so the bounded cutover window is
        # never preempted.)
        if seq.mig is not None:
            self._abort_migration(seq.mig, "preempted")
        log.warning("preempting request %s (KV pressure, class=%s)", seq.request_id, seq.qos)
        self.total_preemptions_by[seq.qos] += 1
        seq.offer_deadline = 0.0  # a later re-admission can be offered again
        self._running.remove(seq)
        self._free_slots.append(seq.slot)
        seq.slot = None
        # Unpin the adapter: re-admission acquires it again (a resident
        # adapter is a free hit, an evicted one pages back in); the compute
        # stream orders any later upload into the slot after this
        # sequence's dispatched work.
        self._release_adapter(seq)
        # A preempted streaming export aborts (the decode worker falls back
        # to local prefill) and the re-admission exports nothing: its
        # handle is dropped with the stream.
        if seq.export_stream is not None:
            seq.export_stream.abort("preempted")
            seq.export_stream = None
            seq.export_handle = None
            seq.export_pub_blocks = 0
            seq.export = False
        self._purge_offloads(seq.block_ids)
        self.pool.free_sequence(seq.block_ids)
        seq.block_ids = []
        seq.registered_blocks = 0
        seq.kv_written = 0
        seq.block_seq = None
        self._waiting.appendleft(seq)

    # -- decode window pipeline -------------------------------------------
    #
    # The engine keeps up to ``pipeline_depth`` decode windows in flight:
    # window w+1 is dispatched (chaining its input tokens from w's
    # on-device outputs through the per-slot fold buffer) BEFORE w's
    # results are fetched, and every fetch starts at dispatch, so the host
    # prepares the next window while the card runs this one. Consequences:
    # - stops are discovered up to depth windows late; a stopped sequence
    #   rides the remaining in-flight windows as a zombie row whose output
    #   is discarded (waste bounded by depth × K tokens);
    # - zombie rows only write KV at positions beyond the drained
    #   boundary, and block registration is gated by complete kept-token
    #   blocks, so prefix reuse never sees junk;
    # - the device stream is serial and a sequence's blocks and slot are
    #   freed only after every window containing it has been DISPATCHED, so
    #   later prefills and samples reusing them are ordered after all
    #   zombie writes and folds;
    # - the full sampler needs host-visible penalty windows, so batches
    #   with a full-sampler row drain everything first and run unpipelined.

    def _pend(self, seq: _Seq) -> int:
        """Tokens sampled on the device for this sequence but not yet
        emitted: K per in-flight window it rides, plus an unfetched
        admission sample. A queued _Spec is invisible here by invariant:
        its count is data-dependent, so _decode_iteration drains it before
        any planning that reads this."""
        p = 1 if seq.first_pend else 0
        for item in self._fetchq:
            if isinstance(item, _Window) and seq in item.row_of:
                p += item.K
        return p

    def _inflight_windows(self) -> int:
        return sum(1 for it in self._fetchq if isinstance(it, _Window))

    def _drain_completed(self, force: bool = False) -> None:
        """Harvest the queue from the front, strictly FIFO. Not forced:
        only items whose fetch already landed (the host never waits).
        Forced: wait for everything."""
        while self._fetchq:
            if not force and not host_ready(self._fetchq[0].fetch):
                break
            self._drain_one(self._fetchq.popleft())

    def _drain_one(self, item: _First | _Window | _Spec) -> None:
        """Fetch and emit one queue item, its fetch time attributed by
        whether the host actually had to wait."""
        blocked = not host_ready(item.fetch)
        if isinstance(item, _First):
            self._drain_first(item, blocked)
        elif isinstance(item, _Spec):
            self._drain_spec(item, blocked)
        else:
            self._drain_window(item, blocked)

    @staticmethod
    def _fetch_arrays(ref, top_n: int) -> tuple:
        """What a dispatch's fetch brings back: tokens and logprobs, and
        the ranked alternatives only when asked for."""
        return ref.arrs if top_n else ref.arrs[:2]

    def _drain_first(self, f: _First, blocked: bool) -> None:
        t0 = time.perf_counter()
        arrs = f.fetch.wait()
        t0 = self._phase("first_sample" if blocked else "drain_ready", t0)
        toks_l, lps_l = arrs[0].tolist(), arrs[1].tolist()
        tvals_l = arrs[2].tolist() if len(arrs) > 2 else None
        tids_l = arrs[3].tolist() if len(arrs) > 2 else None
        for seq, row in f.entries:
            seq.first_pend = False
            if seq.dead:
                continue  # cancelled while the sample was in flight
            tops = None
            if tids_l is not None and seq.sampling.top_logprobs:
                n = seq.sampling.top_logprobs
                tops = [[list(p) for p in zip(tids_l[row][:n], tvals_l[row][:n])]]
            self._emit_tokens(seq, [toks_l[row]], [lps_l[row]], tops)
        self._phase("emit", t0)

    def _plan_window(self) -> tuple[int, int]:
        """→ (K, depth). K=1 is the end-of-life tail near max_model_len;
        pipelining (depth > 0) needs K > 1 and no full-sampler rows.
        Grammar rows force K=1 too: their FSM advances on the host per
        emitted token and the next token's mask depends on it (a fused
        window could mask only its first substep)."""
        K = max(1, self.args.decode_steps)
        if K > 1 and any(len(s.tokens) + self._pend(s) + K > self.args.max_model_len
                         for s in self._running):
            K = 1
        if K > 1 and any(s.grammar is not None for s in self._running):
            K = 1
        depth = self.args.effective_pipeline_depth
        if K == 1 or any(self._needs_full_sampler(s) for s in self._running):
            depth = 0
        return K, depth

    def _decode_iteration(self) -> None:
        # A queued _Spec hides an unknown number of pending tokens per row,
        # so no decode work may be planned past it; its fetch has been in
        # flight since dispatch (overlapping this step's admission).
        if any(isinstance(it, _Spec) for it in self._fetchq):
            self._drain_completed(force=True)
        if not self._running:
            self._drain_completed(force=True)
            return
        if self._try_speculative():
            return
        K, depth = self._plan_window()
        if depth == 0 and self._fetchq:
            # Unpipelined plan (full sampler, K=1 tail): host-visible tokens
            # are needed, so everything pending drains first, then re-plan.
            self._drain_completed(force=True)
            if self._running:
                self._decode_iteration()
            return
        # Grow block tables to cover pend + K; under KV pressure drain the
        # in-flight windows first (their tokens must land before a
        # preempted sequence re-queues), then preempt the lowest class,
        # newest first. A lone sequence that cannot grow is finished.
        while self._running:
            blocked = next((s for s in self._running
                            if not self._ensure_block(s, K + self._pend(s))), None)
            if blocked is None:
                break
            if self._fetchq:
                self._drain_completed(force=True)
                if self._running:
                    self._decode_iteration()
                return
            if len(self._running) == 1:
                self._finish(blocked, FinishReason.LENGTH)
            else:
                victim = self._preempt_victim()
                if self._offer_migration_grace(victim):
                    # Bounded grace: plan nothing this step. Either the
                    # offered relocation frees the victim's blocks
                    # (migration_finish) or the deadline passes and a later
                    # pass preempts for real.
                    self._drain_completed(force=True)
                    time.sleep(0.002)
                    return
                self._preempt(victim)
        if not self._running:
            self._drain_completed(force=True)
            return
        if K == 1:
            self._decode_single_step()
            return
        self._fetchq.append(self._dispatch_window(K))
        # Free harvest first, then hold the depth bound: waiting on the
        # OLDEST window while the newest runs is where the fetch hides.
        self._drain_completed()
        while self._inflight_windows() > depth and self._fetchq:
            self._drain_one(self._fetchq.popleft())
        if not self._running:
            # Every sequence finished during the drains: the queued windows
            # hold only zombie rows and nothing would wake the loop to
            # fetch them.
            self._drain_completed(force=True)

    def _dispatch_window(self, K: int) -> _Window:
        """Enqueue one fused K-step window over the running set. Rows with
        device-pending tokens (an in-flight window or an unfetched
        admission sample) chain their input from their slot (no host
        sync)."""
        t0 = time.perf_counter()
        batch = list(self._running)
        B = self.args.bucket_decode(len(batch))
        W = self.args.bucket_table(max(len(s.block_ids) for s in batch))
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.zeros((B, W), np.int32)
        active = np.zeros((B,), bool)
        fold_slots = np.full((B,), self.args.max_num_seqs, np.int32)
        temps = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        steps0 = np.zeros((B,), np.int32)
        tks = np.zeros((B,), np.int32)
        tps = np.ones((B,), np.float32)
        freqs = np.zeros((B,), np.float32)
        press = np.zeros((B,), np.float32)
        pos0: list[int] = []
        dst: list[int] = []
        src: list[int] = []
        for i, seq in enumerate(batch):
            pend = self._pend(seq)
            p0 = seq.next_write_pos + pend
            pos0.append(p0)
            positions[i] = p0
            tables[i, : len(seq.block_ids)] = seq.block_ids
            active[i] = True
            fold_slots[i] = seq.slot
            if pend:
                dst.append(i)
                src.append(seq.slot)
            else:
                tokens[i] = seq.tokens[-1]
            s = seq.sampling
            temps[i] = s.temperature
            seeds[i] = seq.sample_seed
            steps0[i] = seq.step_base + seq.emitted + pend
            tks[i] = s.top_k or 0
            tps[i] = s.top_p if s.top_p is not None else 1.0
            freqs[i] = s.frequency_penalty
            press[i] = s.presence_penalty
        mode = self._mode(batch)
        pen = self._penalty_window(batch, B) if mode == "full" else np.full((B, 1), -1, np.int32)
        top_n = self._top_n(batch)
        ref = self._runner.multi_decode(
            K, mode, tokens, (dst, src) if dst else None, positions, tables, active,
            temps, seeds, steps0, tks, tps, freqs, press, pen, fold_slots, top_n,
            self._adapter_row_slots(batch, B),
        )
        self.total_decode_steps += K
        self.decode_steps_by_bucket[B] += K
        w = _Window(batch, pos0, K, top_n, start_host_fetch(self._fetch_arrays(ref, top_n)))
        self._phase("decode_dispatch", t0)
        return w

    def _decode_single_step(self) -> None:
        """One decode step over the running set, fetched at once: every
        K=1 plan (the end-of-life tail, ``decode_steps`` 1, and every batch
        with a grammar row, whose next masks need this step's tokens on the
        host), as in the JAX engine. Grammar rows sample under their masks;
        a batch without one passes no mask. Nothing is device-pending here
        (a K=1 plan drains the fetch queue first), so every input comes
        from the host. One dispatch: ``runner.decode_sample``."""
        t0 = time.perf_counter()
        batch = list(self._running)
        B = self.args.bucket_decode(len(batch))
        W = self.args.bucket_table(max(len(s.block_ids) for s in batch))
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.zeros((B, W), np.int32)
        active = np.zeros((B,), bool)
        for i, seq in enumerate(batch):
            tokens[i] = seq.tokens[-1]
            positions[i] = seq.next_write_pos
            tables[i, : len(seq.block_ids)] = seq.block_ids
            active[i] = True
        fold_slots = np.full((B,), self.args.max_num_seqs, np.int32)
        fold_slots[: len(batch)] = [s.slot for s in batch]
        mode, temps, tks, tps, freqs, press, seeds, steps, pen = self._sampling_arrays(batch, B)
        top_n = self._top_n(batch)
        ref = self._runner.decode_sample(
            mode, tokens, positions, tables, active, temps, seeds, steps, tks, tps, freqs,
            press, pen, fold_slots, top_n, self._grammar_row_masks(batch, B),
            self._adapter_row_slots(batch, B))
        self.total_decode_steps += 1
        self.decode_steps_by_bucket[B] += 1
        self.total_row_passes += len(batch)
        self.total_row_tokens += len(batch)
        fetch = start_host_fetch(self._fetch_arrays(ref, top_n))
        t0 = self._phase("decode_dispatch", t0)
        arrs = fetch.wait()
        t0 = self._phase("drain_sync", t0)
        toks_l, lps_l = arrs[0].tolist(), arrs[1].tolist()
        tvals_l = arrs[2].tolist() if top_n else None
        tids_l = arrs[3].tolist() if top_n else None
        for i, seq in enumerate(batch):
            # The step wrote each sequence's KV at its position.
            seq.kv_written = int(positions[i]) + 1
            self._register_written_blocks(seq)
            tops = None
            if tids_l is not None and seq.sampling.top_logprobs:
                n = seq.sampling.top_logprobs
                tops = [[list(p) for p in zip(tids_l[i][:n], tvals_l[i][:n])]]
            self._emit_tokens(seq, [toks_l[i]], [lps_l[i]], tops)
        self._phase("emit", t0)

    def _drain_window(self, w: _Window, blocked: bool) -> None:
        t0 = time.perf_counter()
        arrs = w.fetch.wait()  # the window's one host fetch
        t0 = self._phase("drain_sync" if blocked else "drain_ready", t0)
        toks_l = arrs[0].T.tolist()    # [B][K]
        logps_l = arrs[1].T.tolist()
        tvals_l = tids_l = None
        if w.top_n:
            tvals_l = arrs[2].transpose(1, 0, 2).tolist()  # [B][K][top_n]
            tids_l = arrs[3].transpose(1, 0, 2).tolist()
        for i, seq in enumerate(w.rows):
            if seq.dead:
                continue  # finished or cancelled while this window was in flight
            self.total_row_passes += w.K
            self.total_row_tokens += w.K
            seq.kv_written = w.pos0[i] + w.K
            self._register_written_blocks(seq)
            tops = None
            if tids_l is not None and seq.sampling.top_logprobs:
                n = seq.sampling.top_logprobs
                tops = [[list(p) for p in zip(tids_l[i][j][:n], tvals_l[i][j][:n])]
                        for j in range(w.K)]
            self._emit_tokens(seq, toks_l[i], logps_l[i], tops)
        self._phase("emit", t0)

    # -- speculative decoding ---------------------------------------------
    #
    # A dense substep streams the weights for one token per sequence; a
    # verify pass streams them once for up to spec_tokens+1 tokens per
    # sequence. The host drafts each row's likely continuation by n-gram
    # prompt lookup (engine/drafter.py), the device scores draft_len+1
    # positions in one forward (model.spec_verify) and keeps the longest
    # prefix the model agrees with plus one corrected or bonus token. Greedy
    # rows are the dense path's tokens; sampled rows use rejection sampling.
    #
    # Scheduling contract (the JAX engine's): drafting needs the full
    # host-visible history and the drain reveals how far each row advanced,
    # so a verify pass is a pipeline barrier: everything pending drains
    # before dispatch, and the pass drains before the next decode plan.
    # Rows whose drafts keep being rejected decay an acceptance EMA and
    # enter a probe cooldown, so incompressible traffic falls back to the
    # dense window pipeline.

    def _row_draft(self, seq: _Seq, budget: int):
        """A draft for one row (a token list, or a TreeDraft from the tree
        drafter) under its node allowance ``budget``, shrunk by the row's
        EMA; empty when the row is cooling down or near the model length."""
        args = self.args
        # Never draft past the model length: the pass emits up to
        # potential+1 tokens and writes slots up to positions0 + nodes.
        cap = min(budget, args.max_model_len - len(seq.tokens) - 1)
        if cap <= 0 or seq.spec_cool > 0:
            return []
        # Full drafts at ema >= 0.5, linearly shorter below, floor 1.
        eff = min(cap, max(1, round(budget * min(1.0, seq.spec_ema / 0.5))))
        if seq.draft_state is None:
            seq.draft_state = self._drafter.new_state()
        constraint = None
        if seq.grammar is not None:
            # Grammar-pruned drafting: candidates filtered to FSM-legal
            # continuations, and a forced state drafts its one legal token.
            constraint = DraftConstraint(seq.grammar_state, seq.grammar.advance,
                                         seq.grammar.forced)
        if hasattr(self._drafter, "draft_tree"):
            return self._drafter.draft_tree(seq.tokens, seq.draft_state, eff,
                                            constraint=constraint)
        d = self._drafter.draft(seq.tokens, seq.draft_state, eff)
        if constraint is not None:
            d = constrain_chain(d, constraint, eff)
        return d

    @staticmethod
    def _draft_potential(d) -> int:
        """Best-case accepted run of one proposal: the whole chain, or the
        deepest root path of a tree."""
        return d.max_depth if isinstance(d, TreeDraft) else len(d)

    def _spec_gate_passes(self, drafts: dict) -> bool:
        """Dispatch when some row drafted and the EMA-weighted expected
        tokens per row-pass, mean(1 + ema_i * potential_i), reach
        spec_gate."""
        if not drafts or not any(len(d) for d in drafts.values()):
            return False
        expected = sum(1.0 + s.spec_ema * self._draft_potential(d)
                       for s, d in drafts.items()) / len(drafts)
        return expected >= self.args.spec_gate

    def _try_speculative(self) -> bool:
        """Dispatch one verify pass over the running set when it is
        eligible and some row has a draft → True when a pass went out (the
        decode iteration is done). A first draft over the host-visible
        history decides whether draining the pipeline can pay at all; only
        then does everything drain and every row re-draft on its complete
        history."""
        S = self.spec_tokens
        if S <= 0:
            return False
        # Full-sampler rows need host-visible penalty windows.
        if any(self._needs_full_sampler(s) for s in self._running):
            return False
        if self._spec_ticked != self._step_no:
            self._spec_ticked = self._step_no
            for s in self._running:
                if s.spec_cool > 0:
                    s.spec_cool -= 1
        t0 = time.perf_counter()
        drafts = self._draft_all(S)
        if not self._spec_gate_passes(drafts):
            self._phase("draft", t0)
            return False
        if self._fetchq:
            self._phase("draft", t0)
            self._drain_completed(force=True)
            if not self._running:
                return True
            t0 = time.perf_counter()
            drafts = self._draft_all(S)
        t0 = self._phase("draft", t0)
        if not self._spec_gate_passes(drafts):
            return False
        batch = list(self._running)
        # Cover writes at positions0 + draft nodes; a row that cannot grow
        # leaves the pass to the dense path's pressure handling.
        for seq in batch:
            if not self._ensure_block(seq, len(drafts[seq]) + 1):
                return False
        B = self.args.bucket_decode(len(batch))
        # Verify-shape bucket: S+1, or 2S+1 when an adaptive reallocation
        # let a hot row draft past S.
        max_nodes = max(len(d) for d in drafts.values())
        S1 = S + 1 if max_nodes <= S else SPEC_BUDGET_MAX_MULT * S + 1
        if max_nodes > S:
            self.total_spec_budget_reallocs += 1
        W = self.args.bucket_table(max(len(s.block_ids) for s in batch))
        tokens = np.zeros((B, S1), np.int32)
        pos0_arr = np.zeros((B,), np.int32)
        dlen = np.zeros((B,), np.int32)
        tables = np.zeros((B, W), np.int32)
        active = np.zeros((B,), bool)
        fold_slots = np.full((B,), self.args.max_num_seqs, np.int32)
        temps = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        steps0 = np.zeros((B,), np.int32)
        pos0: list[int] = []
        draft_lens: list[int] = []
        potentials: list[int] = []
        node_tokens: list[list[int]] = []
        node_parents: list[list[int]] = []
        # All-chain proposals dispatch through the linear op (stepwise
        # parity included); any branched one upgrades the whole batch to
        # the topology-masked tree op (chains are trees too). Grammar rows
        # force the tree op as well: per-node masks ride only the tree
        # acceptance (a draft-less constrained row needs its root mask for
        # the bonus sample).
        any_gram = any(s.grammar is not None for s in batch)
        any_tree = any_gram or any(isinstance(d, TreeDraft) and not d.is_chain()
                                   for d in drafts.values())
        for i, seq in enumerate(batch):
            d = drafts[seq]
            if isinstance(d, TreeDraft):
                toks, pars = d.tokens, d.parents
            else:
                toks, pars = list(d), list(range(len(d)))
            tokens[i, 0] = seq.tokens[-1]
            tokens[i, 1 : 1 + len(toks)] = toks
            p0 = seq.next_write_pos
            pos0.append(p0)
            pos0_arr[i] = p0
            dlen[i] = len(toks)
            draft_lens.append(len(toks))
            potentials.append(self._draft_potential(d))
            node_tokens.append([seq.tokens[-1]] + list(toks))
            node_parents.append([0] + list(pars))
            tables[i, : len(seq.block_ids)] = seq.block_ids
            active[i] = True
            fold_slots[i] = seq.slot
            temps[i] = seq.sampling.temperature
            seeds[i] = seq.sample_seed
            steps0[i] = seq.step_base + seq.emitted
        mode = "greedy" if all(t < GREEDY_EPS for t in temps[: len(batch)]) else "simple"
        top_n = self._top_n(batch)
        tree = self._build_tree_args(B, S1, node_parents) if any_tree else None
        masks = (self._build_tree_masks(batch, B, S1, node_tokens, node_parents)
                 if any_gram else None)
        ref = self._runner.spec_verify(S1, mode, tokens, pos0_arr, dlen, tables, active, temps,
                                       seeds, steps0, fold_slots, top_n, tree, masks,
                                       self._adapter_row_slots(batch, B))
        arrs = ref.arrs if top_n else ref.arrs[:4]
        self._fetchq.append(_Spec(batch, pos0, draft_lens, top_n, potentials, any_tree,
                                  node_tokens, node_parents, start_host_fetch(arrs)))
        self._phase("spec_dispatch", t0)
        return True

    def _draft_all(self, S: int) -> dict:
        """Draft every running row under the batch node budget. Uniform:
        each row up to S (EMA-shrunk). Adaptive (spec_budget_adaptive):
        each row drafts up to 2S, then trim_spec_budgets holds the batch
        to rows x S, trimming EMA-cold rows first."""
        if not self.spec_budget_adaptive:
            return {s: self._row_draft(s, S) for s in self._running}
        rows = list(self._running)
        drafts = {s: self._row_draft(s, SPEC_BUDGET_MAX_MULT * S) for s in rows}
        keep = trim_spec_budgets([(s.spec_ema, len(drafts[s])) for s in rows], S)
        for s, k in zip(rows, keep):
            d = drafts[s]
            if len(d) <= k:
                continue
            if isinstance(d, TreeDraft):
                d.truncate(k)
            else:
                drafts[s] = d[:k]
        return drafts

    @staticmethod
    def _build_tree_args(B: int, S1: int, node_parents: list[list[int]]
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Tree topology of one verify dispatch → (parents [B, S1],
        ancestor-or-self bits [B, S1, S1] int8, depth [B, S1]). Rows past
        the live batch stay all-zero (inactive)."""
        parents = np.zeros((B, S1), np.int32)
        anc = np.zeros((B, S1, S1), np.int8)
        depth = np.zeros((B, S1), np.int32)
        for i, pars in enumerate(node_parents):
            anc[i, 0, 0] = 1
            for j in range(1, len(pars)):
                p = pars[j]
                parents[i, j] = p
                anc[i, j] = anc[i, p]
                anc[i, j, j] = 1
                depth[i, j] = depth[i, p] + 1
        return parents, anc, depth

    def _drain_spec(self, sp: _Spec, blocked: bool) -> None:
        self.total_spec_passes += 1
        if sp.tree:
            self.total_spec_tree_passes += 1
        t0 = time.perf_counter()
        arrs = sp.fetch.wait()
        t0 = self._phase("drain_sync" if blocked else "drain_ready", t0)
        out_l, n_emit_l, logps_l, cand_l = (a.tolist() for a in arrs[:4])
        tvals_l = tids_l = None
        if sp.top_n:
            tvals_l, tids_l = arrs[4].tolist(), arrs[5].tolist()  # [B][S1][n]
        alpha = self.args.spec_ema_alpha
        for i, seq in enumerate(sp.rows):
            if seq.dead:
                continue  # finished or cancelled while the pass was in flight
            n = int(n_emit_l[i])
            a = n - 1
            S_i = sp.draft_lens[i]
            self.total_spec_rows += 1
            self.total_spec_emitted += n
            self.total_row_passes += 1
            self.total_row_tokens += n
            if S_i > 0:
                self.total_spec_proposed += S_i
                self.total_spec_accepted += a
                # EMA over achievable acceptance: a tree can only accept
                # down its deepest path.
                pot = max(1, sp.potentials[i])
                seq.spec_ema = (1 - alpha) * seq.spec_ema + alpha * (a / pot)
                if seq.spec_ema < self.args.spec_ema_disable:
                    seq.spec_cool = self.args.spec_probe_every
                if sp.tree:
                    self.total_spec_tree_rows += 1
                    self.total_spec_tree_depth += a
                    self.spec_depth_hist[a] += 1
            # Every node's (context → argmax) pair feeds the drafter's
            # Jacobi pool, rejected branches included; seq.tokens still
            # ends at this pass's root.
            if seq.draft_state is not None:
                self._drafter.observe(seq.draft_state, seq.tokens, sp.node_tokens[i],
                                      sp.node_parents[i], S_i + 1, cand_l[i])
            # Positions p0..p0+a hold the right KV ([last, accepted
            # drafts]); the emitted run's last token is written by the next
            # dispatch, as a window's last sample is.
            seq.kv_written = sp.pos0[i] + n
            self._register_written_blocks(seq)
            tops = None
            if tids_l is not None and seq.sampling.top_logprobs:
                tn = seq.sampling.top_logprobs
                tops = [[list(p) for p in zip(tids_l[i][j][:tn], tvals_l[i][j][:tn])]
                        for j in range(n)]
            self._emit_tokens(seq, out_l[i][:n], logps_l[i][:n], tops)
        self._phase("emit", t0)

    # -- sampling ----------------------------------------------------------

    @staticmethod
    def _needs_full_sampler(seq: _Seq) -> bool:
        s = seq.sampling
        return row_needs_full(s.top_k, s.top_p, s.frequency_penalty, s.presence_penalty)

    def _mode(self, seqs: list[_Seq]) -> str:
        if any(self._needs_full_sampler(s) for s in seqs):
            return "full"
        return "greedy" if all(s.sampling.temperature < GREEDY_EPS for s in seqs) else "simple"

    def _penalty_window(self, seqs: list[_Seq], B: int) -> np.ndarray:
        """[B, max_model_len] generated-so-far ids, -1 pad. One width for
        every batch, so the "full" window has one shape (one CUDA graph)
        per table bucket."""
        pen = np.full((B, self.args.max_model_len), -1, np.int32)
        for i, s in enumerate(seqs):
            gen = s.tokens[s.prompt_len:]
            pen[i, : len(gen)] = gen
        return pen

    def _sample_rows_device(self, logits: list, seqs: list[_Seq], fold_slots: np.ndarray,
                            top_n: int):
        """First tokens of an admission wave (``logits`` padded to the
        batch bucket), sampled and folded on the device → StepRef. Grammar
        rows sample from their FSM state's legal vocabulary."""
        B = len(logits)
        mode, temps, tks, tps, freqs, press, seeds, steps, pen = self._sampling_arrays(seqs, B)
        return self._runner.sample_rows(logits, mode, temps, tks, tps, pen, freqs, press,
                                        seeds, steps, fold_slots, top_n,
                                        self._grammar_row_masks(seqs, B))

    def _sampling_arrays(self, seqs: list[_Seq], B: int) -> tuple:
        """The sampler mode and per-row sampling operands of ``seqs``
        padded to B rows → (mode, temps, top_k, top_p, freqs, press,
        seeds, steps, penalty window)."""
        temps = np.ones((B,), np.float32)
        tks = np.zeros((B,), np.int32)
        tps = np.ones((B,), np.float32)
        freqs = np.zeros((B,), np.float32)
        press = np.zeros((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        steps = np.zeros((B,), np.int32)
        for i, s in enumerate(seqs):
            temps[i] = s.sampling.temperature
            tks[i] = s.sampling.top_k or 0
            tps[i] = s.sampling.top_p if s.sampling.top_p is not None else 1.0
            freqs[i] = s.sampling.frequency_penalty
            press[i] = s.sampling.presence_penalty
            seeds[i] = s.sample_seed
            steps[i] = s.step_base + s.emitted
        mode = self._mode(seqs)
        pen = self._penalty_window(seqs, B) if mode == "full" else np.full((B, 1), -1, np.int32)
        return mode, temps, tks, tps, freqs, press, seeds, steps, pen

    def _top_n(self, seqs: list[_Seq]) -> int:
        return self.args.top_logprobs_max if any(s.sampling.top_logprobs for s in seqs) else 0

    # -- token emission / finish ------------------------------------------

    def _emit_tokens(self, seq: _Seq, toks: list[int], logps: list[float] | None = None,
                     tops: list | None = None) -> None:
        """Append sampled tokens, truncating at the first stop condition,
        and post ONE delta with the kept tokens."""
        kept: list[int] = []
        finish: FinishReason | None = None
        for token in toks:
            token = int(token)
            seq.tokens.append(token)
            seq.emitted += 1
            self.total_generated += 1
            kept.append(token)
            # Advance the grammar FSM per emitted token (EOS ends the match
            # and is not part of it). Masked sampling makes every token
            # legal; an illegal one (a desync) leaves the state as it was.
            if seq.grammar is not None and token not in seq.eos_ids:
                ns = seq.grammar.advance(seq.grammar_state, token)
                if ns is not None:
                    seq.grammar_state = ns
            if seq.block_seq is not None:
                seq.block_seq.append(token)
            if (
                token in seq.eos_ids
                and not seq.stop.ignore_eos
                and seq.emitted >= seq.stop.min_tokens  # eos counts toward min (vLLM)
            ):
                finish = FinishReason.STOP
            elif seq.stop.max_tokens is not None and seq.emitted >= seq.stop.max_tokens:
                finish = FinishReason.LENGTH
            elif len(seq.tokens) >= self.args.max_model_len:
                finish = FinishReason.LENGTH
            if finish is not None:
                break
        self._post(seq, LLMEngineOutput(
            token_ids=kept,
            finish_reason=finish,
            log_probs=logps[: len(kept)] if logps and seq.sampling.logprobs else None,
            top_log_probs=(
                tops[: len(kept)]
                if tops and seq.sampling.logprobs and seq.sampling.top_logprobs else None
            ),
            kv_transfer_params=seq.export_meta if finish is not None else None,
        ).to_dict())
        if finish is not None:
            self._finish(seq, finish, already_posted=True)

    def _finish(self, seq: _Seq, reason: FinishReason, error: str | None = None,
                already_posted: bool = False) -> None:
        if seq.mig is not None:
            # Finished (stop, cancel, error) while migrating out: the
            # destination's pull sees the abort and the coordinator's
            # cutover gets a typed "done" (the stream completed in place).
            self._abort_migration(seq.mig, "finished")
        seq.dead = True
        if seq.export_stream is not None and not seq.export_stream.sealed:
            # Error or cancel before the prefill sealed the stream: the
            # puller must not wait out its deadline on a dead export.
            seq.export_stream.abort("prefill_failed")
        if seq in self._running:
            self._running.remove(seq)
        if seq.slot is not None:
            self._free_slots.append(seq.slot)
            seq.slot = None
        self._release_adapter(seq)
        self._purge_offloads(seq.block_ids)
        self.pool.free_sequence(seq.block_ids)
        seq.block_ids = []
        if not already_posted:
            self._post(seq, LLMEngineOutput(finish_reason=reason, error=error).to_dict())
        self._post_done(seq)

    def _purge_offloads(self, block_ids: list[int]) -> None:
        """Drop queued offloads of blocks about to be freed: once freed they
        can be recycled by any allocation before the next flush, and a late
        gather would snapshot the NEW occupant's KV under the OLD sequence
        hash, poisoning the tier. Flushed blocks need nothing: their gather
        is already enqueued ahead of any rewrite."""
        if self._offload_pending:
            freed = set(block_ids)
            self._offload_pending = [(b, h) for b, h in self._offload_pending if b not in freed]

    def _post(self, seq: _Seq, item: Any) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(seq.queue.put_nowait, item)

    def _post_done(self, seq: _Seq) -> None:
        self._post(seq, _SENTINEL_DONE)
