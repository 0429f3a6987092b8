"""TorchEngine: continuous-batching inference engine over the port's model
(port of ``dynamo_tpu/engine/engine.py`` ``TpuEngine``).

Same contract: ``start`` / ``stop`` / ``generate(request, context)``,
yielding ``LLMEngineOutput`` dicts (token deltas; text is the Backend's
job). The scheduler loop runs in its own thread; asyncio callers submit
through a lock-guarded queue and receive deltas on per-request asyncio
queues via ``loop.call_soon_threadsafe``.

Kept from TpuEngine: FIFO admission with block allocation and prefix-
cache hits; single-row prefill chunked at ``max_prefill_tokens``; first
tokens sampled on the device per admission wave and folded into each
sequence's chain slot, their fetch queued (async admission); fused K-step
decode windows (``decode_steps``) over the running set in the sampler
mode the batch needs ("greedy", "simple", "full"), with up to
``pipeline_depth`` windows in flight, chained on the device and fetched
asynchronously (the decode window pipeline below); stops on max_tokens /
EOS (``ignore_eos``, ``min_tokens``) / max_model_len; cancellation
through ``Context``; recompute preemption of the newest sequence under KV
pressure.

Omitted for now, each a ROADMAP item: speculative decoding, LoRA,
grammar-constrained decoding, KV tiers and offload, QoS classes, live
migration, disaggregated export/inject, embeddings, delta coalescing,
tracing and metrics registries.
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

from dynamo_tpu_torch.block_manager.pool import BlockPool, NoFreeBlocksError
from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.runner import HostFetch, LocalRunner, host_ready, start_host_fetch
from dynamo_tpu_torch.engine.sampler import GREEDY_EPS, row_needs_full
from dynamo_tpu_torch.llm.protocols import (
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
        "request_id", "tokens", "prompt_len", "sampling", "stop", "eos_ids",
        "block_ids", "block_seq", "registered_blocks", "queue", "emitted",
        "cancelled", "sample_seed", "kv_written", "dead", "slot", "first_pend",
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

    @property
    def next_write_pos(self) -> int:
        return len(self.tokens) - 1


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
        # Dispatched work whose results are not yet on the host, in
        # dispatch order: admission samples and decode windows.
        self._fetchq: collections.deque[_First | _Window] = collections.deque()
        self._free_slots: list[int] = list(range(args.max_num_seqs))
        self._stopping = False
        # Monotonic counters, read racily by callers (stale reads harmless).
        self.total_generated = 0
        self.total_prefilled = 0
        self.total_decode_steps = 0   # device substeps dispatched, padded rows included
        self.total_preemptions = 0
        # Host seconds per phase: admission, prefill, first_dispatch,
        # decode_dispatch, drain_sync (waiting on a window's fetch),
        # drain_ready (a window already on the host), first_sample (waiting
        # on an admission sample), emit.
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

    @property
    def runner(self) -> LocalRunner:
        return self._runner

    def busy(self) -> bool:
        """Anything submitted, running or still in flight (a racy read)."""
        return bool(self._submissions or self._waiting or self._running or self._fetchq)

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

    def _phase(self, key: str, t0: float) -> float:
        """Add perf_counter() - t0 to phase ``key``; → the new t0."""
        t1 = time.perf_counter()
        self.phase_s[key] += t1 - t0
        return t1

    def _step(self) -> None:
        # Harvest whatever fetches completed while the host was away: frees
        # slots and blocks and finds stops early, and costs nothing when
        # the head of the queue is still in flight.
        self._drain_completed()
        self._reap_cancelled()
        t0 = time.perf_counter()
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
        t0 = self._phase("admission", t0)
        if allocated:
            self._admit(allocated)
        if self._running:
            self._decode_iteration()
        elif self._fetchq:
            # Every owner of the queued fetches died during a drain: release
            # them (the idle wait in _run ignores _fetchq).
            self._drain_completed(force=True)

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
        self._drain_completed(force=True)  # pending tokens must be host-visible
        if seq.dead or seq not in self._running:
            return  # the drain finished it
        log.warning("preempting request %s (KV pressure)", seq.request_id)
        self.total_preemptions += 1
        self._running.remove(seq)
        self._free_slots.append(seq.slot)
        seq.slot = None
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
        admission sample."""
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

    def _drain_one(self, item: _First | _Window) -> None:
        """Fetch and emit one queue item, its fetch time attributed by
        whether the host actually had to wait."""
        blocked = not host_ready(item.fetch)
        if isinstance(item, _First):
            self._drain_first(item, blocked)
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
        pipelining (depth > 0) needs K > 1 and no full-sampler rows."""
        K = max(1, self.args.decode_steps)
        if K > 1 and any(len(s.tokens) + self._pend(s) + K > self.args.max_model_len
                         for s in self._running):
            K = 1
        depth = self.args.effective_pipeline_depth
        if K == 1 or any(self._needs_full_sampler(s) for s in self._running):
            depth = 0
        return K, depth

    def _decode_iteration(self) -> None:
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
        # preempted sequence re-queues), then preempt newest-first. A lone
        # sequence that cannot grow is finished.
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
                self._preempt(self._running[-1])
        if not self._running:
            self._drain_completed(force=True)
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
            steps0[i] = seq.emitted + pend
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
        )
        self.total_decode_steps += K
        w = _Window(batch, pos0, K, top_n, start_host_fetch(self._fetch_arrays(ref, top_n)))
        self._phase("decode_dispatch", t0)
        return w

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
            seq.kv_written = w.pos0[i] + w.K
            self._register_written_blocks(seq)
            tops = None
            if tids_l is not None and seq.sampling.top_logprobs:
                n = seq.sampling.top_logprobs
                tops = [[list(p) for p in zip(tids_l[i][j][:n], tvals_l[i][j][:n])]
                        for j in range(w.K)]
            self._emit_tokens(seq, toks_l[i], logps_l[i], tops)
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
        batch bucket), sampled and folded on the device → StepRef."""
        B = len(logits)
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
            steps[i] = s.emitted
        mode = self._mode(seqs)
        pen = self._penalty_window(seqs, B) if mode == "full" else np.full((B, 1), -1, np.int32)
        return self._runner.sample_rows(logits, mode, temps, tks, tps, pen, freqs, press,
                                        seeds, steps, fold_slots, top_n)

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
        if seq.slot is not None:
            self._free_slots.append(seq.slot)
            seq.slot = None
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
