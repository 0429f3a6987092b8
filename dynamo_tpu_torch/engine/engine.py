"""TorchEngine: continuous-batching inference engine over the port's model
(port of ``dynamo_tpu/engine/engine.py`` ``TpuEngine``).

Same contract: ``start`` / ``stop`` / ``generate(request, context)``,
yielding ``LLMEngineOutput`` dicts (token deltas; text is the Backend's
job). Device calls block, so the scheduler loop runs in its own thread;
asyncio callers submit through a lock-guarded queue and receive deltas on
per-request asyncio queues via ``loop.call_soon_threadsafe``.

Kept from TpuEngine: FIFO admission with block allocation and prefix-
cache hits; single-row prefill chunked at ``max_prefill_tokens``; the
first token sampled per admission wave; fused K-step decode windows
(``decode_steps``) over the running set, one host fetch per window;
stops on max_tokens / EOS (``ignore_eos``, ``min_tokens``) /
max_model_len; cancellation through ``Context``; recompute preemption of
the newest sequence under KV pressure.

Omitted for now, each a ROADMAP item: window pipelining and async
fetches (every window is fetched before the next is planned), the full
sampler (requests with penalties / top-k / top-p get an EngineError),
speculative decoding, LoRA, grammar-constrained decoding, KV tiers and
offload, QoS classes, live migration, disaggregated export/inject,
embeddings, delta coalescing, tracing and metrics registries.
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
import torch

from dynamo_tpu_torch.block_manager.pool import BlockPool, NoFreeBlocksError
from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.engine.sampler import GREEDY_EPS, row_needs_full
from dynamo_tpu_torch.llm.protocols import (
    EngineError,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tokens import TokenBlockSequence, compute_block_hashes

log = logging.getLogger("dynamo_tpu_torch.engine")

_SENTINEL_DONE = object()


class RequestValidationError(Exception):
    """Client error (clean rejection, no stack trace)."""


class _Seq:
    __slots__ = (
        "request_id", "tokens", "sampling", "stop", "eos_ids", "block_ids",
        "block_seq", "registered_blocks", "queue", "emitted", "cancelled",
        "sample_seed", "kv_written", "dead",
    )

    def __init__(self, request_id: str, req: PreprocessedRequest, queue: asyncio.Queue):
        self.request_id = request_id
        self.tokens: list[int] = list(req.token_ids)
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
        self.dead = False  # finished or cancelled (set by _finish)

    @property
    def next_write_pos(self) -> int:
        return len(self.tokens) - 1


class TorchEngine:
    def __init__(self, args: EngineArgs, params: Any | None = None, seed: int = 0,
                 event_sink=None):
        self.args = args
        self.cfg = args.model
        self._runner = LocalRunner(args, params=params, seed=seed)
        self.pool = BlockPool(
            args.num_kv_blocks, args.block_size, event_sink=event_sink,
            enable_prefix_caching=args.prefix_caching,
        )
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._mutex = threading.Lock()
        self._wakeup = threading.Condition(self._mutex)
        self._submissions: collections.deque[_Seq] = collections.deque()
        self._waiting: collections.deque[_Seq] = collections.deque()
        self._running: list[_Seq] = []
        self._stopping = False
        # Monotonic counters, read racily by callers (stale reads harmless).
        self.total_generated = 0
        self.total_prefilled = 0
        self.total_decode_steps = 0   # device substeps, padded rows included
        self.total_preemptions = 0
        # Host seconds per phase; "decode" ends in the window's fetch, so
        # it is device time plus launch overhead.
        self.phase_s: dict[str, float] = collections.defaultdict(float)

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

    def clear_kv_blocks(self) -> int:
        """Drop every idle cached block (admin clear-KV) → count."""
        return self.pool.clear()

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
        if row_needs_full(s.top_k, s.top_p, s.frequency_penalty, s.presence_penalty):
            raise EngineError(
                "top_k, top_p < 1 and frequency/presence penalties need the full "
                "sampler, which this port does not have yet"
            )
        if s.top_logprobs:
            s.top_logprobs = min(s.top_logprobs, self.args.top_logprobs_max) if s.logprobs else 0
        queue: asyncio.Queue = asyncio.Queue()
        seq = _Seq(context.id, req, queue)
        with self._wakeup:
            if self._stopping:
                raise RuntimeError("engine is stopping")
            self._submissions.append(seq)
            self._wakeup.notify()

        async def watch_cancel():
            await context.wait_cancelled()
            with self._wakeup:
                seq.cancelled = True
                self._wakeup.notify()

        watcher = asyncio.get_running_loop().create_task(watch_cancel())
        try:
            while True:
                item = await queue.get()
                if item is _SENTINEL_DONE:
                    return
                yield item
                if item.get("finish_reason"):
                    return
        finally:
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
                           and not self._waiting and not self._running):
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
            with self._wakeup:
                self._stopping = True
                leftovers = list(self._running) + list(self._waiting) + list(self._submissions)
                self._running.clear()
                self._waiting.clear()
                self._submissions.clear()
            reason = FinishReason.ERROR if crashed else FinishReason.CANCELLED
            err = "engine loop crashed" if crashed else None
            for seq in leftovers:
                self._post(seq, LLMEngineOutput(finish_reason=reason, error=err).to_dict())
                self._post_done(seq)

    def _step(self) -> None:
        self._reap_cancelled()
        allocated: list[tuple[_Seq, int]] = []  # (seq, suffix start)
        budget = self.args.admission_budget_tokens or (1 << 62)
        while (
            self._waiting
            and len(self._running) + len(allocated) < self.args.max_num_seqs
            and (budget > 0 or not allocated)
        ):
            seq = self._waiting.popleft()
            if seq.cancelled:
                self._post_done(seq)
                continue
            budget -= len(seq.tokens)
            try:
                start = self._admit_alloc(seq)
            except NoFreeBlocksError:
                self._waiting.appendleft(seq)  # try again when blocks free up
                if not self._running and not allocated:
                    self._waiting.remove(seq)  # nothing will ever free: fail it
                    self._finish(seq, FinishReason.ERROR, error="prompt does not fit in KV cache")
                break
            except RequestValidationError as e:
                self._finish(seq, FinishReason.ERROR, error=str(e))
                continue
            allocated.append((seq, start))
        if allocated:
            self._admit(allocated)
        if self._running:
            self._decode_iteration()

    def _admit(self, allocated: list[tuple[_Seq, int]]) -> None:
        """Prefill an admission wave and sample its first tokens (one
        host fetch for the wave)."""
        seqs = [s for s, _ in allocated]
        t0 = time.perf_counter()
        try:
            logits = [self._prefill(seq, start) for seq, start in allocated]
            toks, logps, tvals, tids = self._runner.sample_rows(
                torch.stack(logits),
                [s.sampling.temperature for s in seqs],
                [s.sample_seed for s in seqs],
                [s.emitted for s in seqs],
                self._top_n(seqs),
            )
        except Exception as e:  # noqa: BLE001 — contain wave faults to the wave
            log.exception("prefill failed")
            for seq in seqs:
                self._finish(seq, FinishReason.ERROR, error=f"prefill failed: {e}")
            return
        self.phase_s["prefill"] += time.perf_counter() - t0
        for i, seq in enumerate(seqs):
            self._running.append(seq)
            tops = self._tops(seq, tvals[i : i + 1], tids[i : i + 1])
            self._emit_tokens(seq, [int(toks[i])], [float(logps[i])], tops)

    def _reap_cancelled(self) -> None:
        for seq in [s for s in self._running if s.cancelled]:
            self._finish(seq, FinishReason.CANCELLED)
        for seq in [s for s in self._waiting if s.cancelled]:
            self._waiting.remove(seq)
            self._post_done(seq)

    # -- admission / prefill ----------------------------------------------

    def _admit_alloc(self, seq: _Seq) -> int:
        """Allocate KV blocks and resolve prefix hits → suffix start."""
        bs = self.args.block_size
        prompt = seq.tokens
        plen = len(prompt)
        if plen > self.args.max_model_len - 1:
            raise RequestValidationError("prompt exceeds max_model_len")
        hashes = compute_block_hashes(prompt, bs)
        # Never reuse the entire prompt: at least one token must be
        # computed to produce logits.
        max_hit = (plen - 1) // bs
        total_blocks = (plen + bs - 1) // bs
        block_ids, n_hit = self.pool.allocate_sequence(hashes[:max_hit], total_blocks)
        seq.block_ids = block_ids
        seq.block_seq = TokenBlockSequence(prompt, bs)
        return n_hit * bs

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
            logits = self._runner.prefill_chunk(toks, table, pos, pos + n)
            pos += n
        self.total_prefilled += plen - start
        seq.kv_written = plen
        self._register_written_blocks(seq)
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
            self.pool.register_block(
                seq.block_ids[seq.registered_blocks], blk.sequence_hash, blk.parent_sequence_hash
            )
            seq.registered_blocks += 1

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

    def _preempt(self, seq: _Seq) -> None:
        """Recompute-preemption: free blocks, requeue with all tokens as the
        new prompt (vLLM's recompute mode)."""
        log.warning("preempting request %s (KV pressure)", seq.request_id)
        self.total_preemptions += 1
        self._running.remove(seq)
        self.pool.free_sequence(seq.block_ids)
        seq.block_ids = []
        seq.registered_blocks = 0
        seq.kv_written = 0
        seq.block_seq = None
        self._waiting.appendleft(seq)

    def _decode_iteration(self) -> None:
        K = max(1, self.args.decode_steps)
        if any(len(s.tokens) + K > self.args.max_model_len for s in self._running):
            K = 1  # end-of-life tail: one token at a time
        # Grow block tables K ahead; under KV pressure preempt the newest
        # sequence. A lone sequence that cannot grow is finished.
        while self._running:
            blocked = next((s for s in self._running if not self._ensure_block(s, K)), None)
            if blocked is None:
                break
            if len(self._running) == 1:
                self._finish(blocked, FinishReason.LENGTH)
            else:
                self._preempt(self._running[-1])
        if self._running:
            self._decode_window(K)

    def _decode_window(self, K: int) -> None:
        """One fused K-step window over the running set, fetched at its end."""
        batch = list(self._running)
        B = self.args.bucket_decode(len(batch))
        W = max(len(s.block_ids) for s in batch)
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.zeros((B, W), np.int32)
        active = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        seeds = [0] * B
        steps0 = [0] * B
        pos0: list[int] = []
        for i, seq in enumerate(batch):
            p0 = seq.next_write_pos
            pos0.append(p0)
            positions[i] = p0
            tokens[i] = seq.tokens[-1]
            tables[i, : len(seq.block_ids)] = seq.block_ids
            active[i] = True
            temps[i] = seq.sampling.temperature
            seeds[i] = seq.sample_seed
            steps0[i] = seq.emitted
        mode = "greedy" if all(t < GREEDY_EPS for t in temps) else "simple"
        t0 = time.perf_counter()
        toks, logps, tvals, tids = self._runner.multi_decode(
            K, mode, tokens, positions, tables, active, temps, seeds, steps0,
            self._top_n(batch),
        )
        self.phase_s["decode"] += time.perf_counter() - t0
        self.total_decode_steps += K
        for i, seq in enumerate(batch):
            if seq.dead:
                continue
            seq.kv_written = pos0[i] + K
            self._register_written_blocks(seq)
            tops = self._tops(seq, tvals[:, i], tids[:, i])
            self._emit_tokens(seq, toks[:, i].tolist(), logps[:, i].tolist(), tops)

    def _top_n(self, seqs: list[_Seq]) -> int:
        return self.args.top_logprobs_max if any(s.sampling.top_logprobs for s in seqs) else 0

    @staticmethod
    def _tops(seq: _Seq, tvals: np.ndarray, tids: np.ndarray) -> list | None:
        """Per-token [[id, logprob], ...] alternatives (tvals/tids [n_tok, top_n])."""
        n = seq.sampling.top_logprobs
        if not n or tvals.shape[-1] == 0:
            return None
        return [[[int(t), float(v)] for t, v in zip(ti[:n], tv[:n])]
                for tv, ti in zip(tvals, tids)]

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
        ).to_dict())
        if finish is not None:
            self._finish(seq, finish, already_posted=True)

    def _finish(self, seq: _Seq, reason: FinishReason, error: str | None = None,
                already_posted: bool = False) -> None:
        seq.dead = True
        if seq in self._running:
            self._running.remove(seq)
        self.pool.free_sequence(seq.block_ids)
        seq.block_ids = []
        if not already_posted:
            self._post(seq, LLMEngineOutput(finish_reason=reason, error=error).to_dict())
        self._post_done(seq)

    def _post(self, seq: _Seq, item: Any) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(seq.queue.put_nowait, item)

    def _post_done(self, seq: _Seq) -> None:
        self._post(seq, _SENTINEL_DONE)
