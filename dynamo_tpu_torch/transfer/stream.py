"""Streaming KV data plane: the chunked wire protocol and its two ends.

Reference analogue: the NIXL KV data plane (reference: lib/llm/src/
block_manager/storage/nixl.rs, docs/architecture/kvbm_architecture.md)
moves cache blocks with block-granular RDMA ops *while* prefill is still
running. On TPU the equivalents are host DMA for HBM→host (already
started asynchronously by the engine, engine/kv_transfer.py) and the
runtime's TCP response plane for host→host; this module is the host→host
half plus the shared chunk bookkeeping.

Protocol (all frames msgpack-safe dicts, ordered within one stream):

- ``kv_chunk`` header — one contiguous run of prompt blocks: ``idx``
  (chunk sequence number), ``block_offset`` (first prompt block the run
  covers), plus the KvPagePayload header fields (shape/dtype/byte counts,
  int8 scale sidecar sizes when the publisher stores quantized pages).
- ``k`` / ``v`` / ``k_scale`` / ``v_scale`` data frames — ≤ frame_bytes
  each, same framing as the legacy one-shot payload.
- ``kv_more`` — window over (credit exhausted or nothing new within the
  wait); the consumer pulls again from ``cursor``.
- ``kv_eos`` — stream sealed and fully delivered (carries the totals).
- ``kv_abort`` — publisher aborted (prefill death/preemption, or the
  consumer fell behind the flow-control budget).

Flow control is credit-based and receiver-driven: each pull names a
``cursor`` (acks everything before it — the publisher frees those host
pages) and a ``credit_bytes`` window, so unacked bytes in flight are
bounded by construction. A consumer that stops pulling cannot grow the
publisher's heap past ``max_buffer_bytes``: the stream aborts instead
(disagg is an optimization — the decode side falls back to local
prefill, never to an OOM'd prefill worker).

Failures are typed (:class:`TransferError` tree) so ``llm/disagg.py``
can catch exactly the data plane's failure domain and fall back.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from typing import AsyncIterator

from dynamo_tpu_torch.engine.kv_transfer import KvPagePayload
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("transfer")

DEFAULT_CREDIT_BYTES = 32 << 20
DEFAULT_FRAME_BYTES = 16 << 20
_DATA_KINDS = ("k", "v", "k_scale", "v_scale")
# Floor for a de-prioritized pull's window: even a fully contended
# budget lets a background stream advance one modest window per turn,
# so pacing slows migrations but can never wedge them.
MIN_WINDOW_BYTES = 1 << 20


class CreditBudget:
    """Shared credit accounting across one process's concurrent KV pulls.

    The credit-flow protocol already bounds each STREAM's in-flight
    bytes; this bounds their SUM, with a priority tier. Disagg prefill
    pulls are on the request critical path (TTFT) and always get their
    full ask; background pulls — balancer/planner migrations — get
    whatever of ``total_bytes`` the outstanding windows have left,
    floored at :data:`MIN_WINDOW_BYTES`. Rebalancing therefore shapes
    its own bandwidth around the disagg plane instead of competing with
    it (docs/performance.md has the budget math).

    Thread-safe; windows are short-lived (acquire → one pull window →
    release), so a busy disagg plane throttles migrations within one
    window turn.
    """

    def __init__(self, total_bytes: int = 2 * DEFAULT_CREDIT_BYTES,
                 priority_kinds: tuple = ("disagg",)):
        self.total_bytes = total_bytes
        self.priority_kinds = frozenset(priority_kinds)
        self._lock = threading.Lock()
        self._outstanding: dict[str, int] = {}
        self.charged_bytes: dict[str, int] = {}  # per-kind delivered bytes

    def acquire(self, kind: str, want: int) -> int:
        """Reserve credit for one pull window. → granted bytes (== want
        for priority kinds; bounded by the budget's headroom otherwise)."""
        with self._lock:
            if kind in self.priority_kinds:
                grant = want
            else:
                used = sum(self._outstanding.values())
                grant = max(MIN_WINDOW_BYTES, min(want, self.total_bytes - used))
            self._outstanding[kind] = self._outstanding.get(kind, 0) + grant
            return grant

    def release(self, kind: str, granted: int, delivered: int = 0) -> None:
        with self._lock:
            left = self._outstanding.get(kind, 0) - granted
            if left > 0:
                self._outstanding[kind] = left
            else:
                self._outstanding.pop(kind, None)
            if delivered:
                self.charged_bytes[kind] = self.charged_bytes.get(kind, 0) + delivered

    def outstanding(self, kind: str | None = None) -> int:
        with self._lock:
            if kind is not None:
                return self._outstanding.get(kind, 0)
            return sum(self._outstanding.values())


_process_budget: CreditBudget | None = None


def process_credit_budget() -> CreditBudget:
    """The per-process shared budget (worker processes host both the
    disagg decode handler and the migration receiver, so one instance
    arbitrates between them)."""
    global _process_budget
    if _process_budget is None:
        _process_budget = CreditBudget()
    return _process_budget


class TransferError(Exception):
    """Base class for KV data-plane failures — the whole plane's failure
    domain, so consumers can catch it precisely and fall back to local
    prefill (disagg is never a correctness dependency)."""


class TransferAbortedError(TransferError):
    """The publisher aborted the stream: prefill died or was preempted,
    or the consumer fell behind the flow-control budget (overrun)."""


class TransferTimeoutError(TransferError):
    """The stream stalled: the export never appeared, or no new chunk
    arrived within the pull deadline."""


@dataclass
class KvChunk:
    """One streamed unit: the KV pages of a contiguous run of prompt
    blocks, in extract_pages wire order — (k, v) or
    (k, v, k_scale, v_scale) for int8 storage."""

    block_offset: int  # first prompt block this run covers
    pages: tuple       # np arrays, each [L, n, bs, ...]
    num_tokens: int    # prompt positions covered (n * block_size)

    @property
    def num_blocks(self) -> int:
        return int(self.pages[0].shape[1])

    @property
    def nbytes(self) -> int:
        return sum(int(p.nbytes) for p in self.pages)

    def to_wire(self) -> dict:
        """→ msgpack-safe dict (KvPagePayload wire form + block_offset);
        the engine's inject path consumes a list of these."""
        d = KvPagePayload.from_pages(self.pages, self.num_tokens).to_dict()
        d["block_offset"] = self.block_offset
        return d


# ---------------------------------------------------------------------------
# Publisher side
# ---------------------------------------------------------------------------


class KvStreamExport:
    """Publisher end of one streaming KV export.

    Written by the prefill engine's scheduler thread (``publish`` /
    ``seal`` / ``abort`` — all non-blocking: the scheduler must never
    wait on a consumer), drained by the async ``kv_fetch`` endpoint on
    the worker's event loop (``chunks_since`` / ``ack`` /
    ``wait_change``). ``max_buffer_bytes`` bounds unacked host bytes: a
    consumer that stops acking aborts the stream instead of growing the
    prefill worker's heap without bound.
    """

    def __init__(self, handle: str, *, max_buffer_bytes: int = 256 << 20):
        self.handle = handle
        self.max_buffer_bytes = max_buffer_bytes
        self._lock = threading.Lock()
        self._chunks: list[KvChunk | None] = []  # acked entries dropped to None
        self._buffered_bytes = 0
        self.total_bytes = 0
        self.sealed = False
        self.num_tokens = 0
        self.num_blocks = 0
        self.abort_reason: str | None = None
        self._waiter_loop: asyncio.AbstractEventLoop | None = None
        self._waiter_event: asyncio.Event | None = None

    # -- publisher (engine scheduler thread) ------------------------------

    def publish(self, chunk: KvChunk) -> bool:
        """Append one chunk. → False when the stream is (now) aborted —
        the caller should stop extracting for it. Never blocks."""
        with self._lock:
            if self.abort_reason is not None:
                return False
            if self._buffered_bytes + chunk.nbytes > self.max_buffer_bytes:
                # Flow-control overrun: the consumer is too slow or gone.
                # Free the buffered pages NOW — holding them until the
                # export TTL reap is exactly the heap pressure the
                # budget exists to prevent.
                self.abort_reason = "overrun"
                self._chunks = [None] * len(self._chunks)
                self._buffered_bytes = 0
            else:
                self._chunks.append(chunk)
                self._buffered_bytes += chunk.nbytes
                self.total_bytes += chunk.nbytes
        self._notify()
        return self.abort_reason is None

    def seal(self, *, num_blocks: int, num_tokens: int) -> None:
        """Prefill done, all chunks published; totals become final."""
        with self._lock:
            if self.abort_reason is None:
                self.sealed = True
                self.num_blocks = num_blocks
                self.num_tokens = num_tokens
        self._notify()

    def abort(self, reason: str) -> None:
        with self._lock:
            if self.sealed or self.abort_reason is not None:
                return
            self.abort_reason = reason
            # Free buffered pages promptly — nobody will pull them.
            self._chunks = [None] * len(self._chunks)
            self._buffered_bytes = 0
        self._notify()

    def _notify(self) -> None:
        ev, loop = self._waiter_event, self._waiter_loop
        if ev is not None and loop is not None:
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                # Consumer loop already closed — nothing left to wake.
                pass

    # -- consumer (event loop) --------------------------------------------

    def chunk_count(self) -> int:
        with self._lock:
            return len(self._chunks)

    def state(self) -> tuple[int, bool, str | None]:
        """→ (published chunk count, sealed, abort reason)."""
        with self._lock:
            return len(self._chunks), self.sealed, self.abort_reason

    def ack(self, cursor: int) -> None:
        """The consumer has durably received chunks [0, cursor): release
        their host pages (the flow-control credit return path)."""
        with self._lock:
            for i in range(min(cursor, len(self._chunks))):
                c = self._chunks[i]
                if c is not None:
                    self._buffered_bytes -= c.nbytes
                    self._chunks[i] = None

    def chunks_since(self, cursor: int, credit_bytes: int) -> list[tuple[int, KvChunk]]:
        """→ [(idx, chunk)] from ``cursor``, bounded by ``credit_bytes``
        (always at least one chunk when any is available, so a chunk
        larger than the credit window still makes progress)."""
        out: list[tuple[int, KvChunk]] = []
        budget = credit_bytes
        with self._lock:
            if self.abort_reason is not None:
                # Aborting nulls every buffered entry; an empty window
                # sends the caller back to state(), which reports the
                # abort as a clean kv_abort frame instead of a spurious
                # cursor-went-backwards protocol error.
                return out
            for i in range(cursor, len(self._chunks)):
                c = self._chunks[i]
                if c is None:
                    raise TransferError(
                        f"chunk {i} re-requested after ack (cursor went backwards)"
                    )
                if out and c.nbytes > budget:
                    break
                out.append((i, c))
                budget -= c.nbytes
        return out

    async def wait_change(self, cursor: int, timeout: float) -> None:
        """Wait (bounded) until a chunk past ``cursor`` exists or the
        stream sealed/aborted."""
        loop = asyncio.get_running_loop()
        with self._lock:
            if self._waiter_event is None or self._waiter_loop is not loop:
                self._waiter_event = asyncio.Event()
                self._waiter_loop = loop
            ev = self._waiter_event
            if len(self._chunks) > cursor or self.sealed or self.abort_reason:
                return
            ev.clear()
        try:
            await asyncio.wait_for(ev.wait(), max(timeout, 0.0))
        except asyncio.TimeoutError:
            pass


# ---------------------------------------------------------------------------
# Wire framing
# ---------------------------------------------------------------------------


def chunk_to_frames(idx: int, chunk: KvChunk, max_bytes: int = DEFAULT_FRAME_BYTES):
    """Yield one chunk's wire frames: a ``kv_chunk`` header (the legacy
    payload header plus idx/block_offset — int8 scale sidecars ride the
    same fields) followed by ≤ ``max_bytes`` data frames."""
    payload = KvPagePayload.from_pages(chunk.pages, chunk.num_tokens)
    frames = payload.to_frames(max_bytes)
    header = dict(next(frames))
    header["kind"] = "kv_chunk"
    header["idx"] = idx
    header["block_offset"] = chunk.block_offset
    yield header
    yield from frames


class KvChunkAssembler:
    """Incremental reader: feed wire frames in order, get completed
    :class:`KvChunk` objects out. Understands both ``kv_chunk`` stream
    headers and legacy one-shot ``kv_header`` payloads, so the disagg
    pull loop and the peer-KV fetcher share one reader."""

    def __init__(self):
        self._header: dict | None = None
        self._data: list[dict] = []
        self._want = 0
        self._got = 0

    def feed(self, frame: dict) -> KvChunk | None:
        """→ a completed chunk, or None while one is still assembling.
        Raises :class:`TransferError` on malformed/out-of-order frames
        (truncation inside a chunk is caught by the byte-count check)."""
        kind = frame.get("kind")
        if kind in ("kv_chunk", "kv_header"):
            if self._header is not None:
                raise TransferError("chunk header before previous chunk completed")
            self._header = frame
            self._want = (
                frame.get("k_bytes", 0) + frame.get("v_bytes", 0)
                + frame.get("k_scale_bytes", 0) + frame.get("v_scale_bytes", 0)
            )
            self._got = 0
            self._data = []
            return self._complete() if self._want == 0 else None
        if kind in _DATA_KINDS:
            if self._header is None:
                raise TransferError(f"{kind} data frame before any chunk header")
            self._data.append(frame)
            self._got += len(frame.get("data") or b"")
            return self._complete() if self._got >= self._want else None
        raise TransferError(f"unexpected frame kind {kind!r} in kv stream")

    @property
    def mid_chunk(self) -> bool:
        return self._header is not None

    def _complete(self) -> KvChunk:
        header = dict(self._header)
        block_offset = int(header.pop("block_offset", 0) or 0)
        header["kind"] = "kv_header"
        try:
            payload = KvPagePayload.from_frames([header, *self._data])
        except ValueError as e:
            # Per-kind byte-count mismatch (one kind over, another short).
            # Stay inside the plane's typed failure domain.
            raise TransferError(f"malformed kv chunk: {e}") from e
        self._header = None
        self._data = []
        return KvChunk(
            block_offset=block_offset,
            pages=payload.pages(),
            num_tokens=payload.num_tokens,
        )


async def read_kv_payload_frames(frames: AsyncIterator[dict]) -> KvPagePayload:
    """Assemble a legacy single-payload stream (one ``kv_header`` + data
    frames) through the shared assembler. Raises :class:`TransferError`
    on a declined stream ({"error": ...} first frame), an empty stream,
    or truncation."""
    asm = KvChunkAssembler()
    chunk: KvChunk | None = None
    got_any = False
    async for frame in frames:
        if not got_any and frame.get("error"):
            raise TransferError(str(frame["error"]))
        got_any = True
        done = asm.feed(frame)
        if done is not None:
            chunk = done
    if chunk is None:
        raise TransferError("empty or truncated kv payload stream")
    return KvPagePayload.from_pages(chunk.pages, chunk.num_tokens)


# ---------------------------------------------------------------------------
# Server pump (prefill worker's kv_fetch endpoint)
# ---------------------------------------------------------------------------


async def serve_kv_window(
    export: KvStreamExport,
    cursor: int,
    credit_bytes: int,
    wait_s: float,
    frame_bytes: int = DEFAULT_FRAME_BYTES,
    chaos=None,
):
    """Serve one pull window: frames for chunks [cursor, m) bounded by
    ``credit_bytes``, then a terminal marker — ``kv_eos`` when the
    stream is sealed and fully delivered, ``kv_more`` when the credit
    window filled or nothing new arrived within ``wait_s``, ``kv_abort``
    on publisher abort. ``cursor`` acks (frees) everything before it.

    ``chaos`` (runtime/chaos.py) is consulted AFTER each chunk's frames:
    a kill-mid-transfer draw raises ChaosKillError between chunks, which
    the endpoint server turns into a transport cut — exactly what a
    prefill worker dying mid-stream looks like on the wire."""
    export.ack(cursor)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + max(wait_s, 0.0)
    sent = cursor
    budget = credit_bytes
    while True:
        _count, sealed, abort = export.state()
        if abort is not None:
            yield {"kind": "kv_abort", "reason": abort}
            return
        window = export.chunks_since(sent, budget)
        for idx, chunk in window:
            for frame in chunk_to_frames(idx, chunk, frame_bytes):
                yield frame
            sent = idx + 1
            budget -= chunk.nbytes
            if chaos is not None:
                chaos.maybe_cut_transfer()
        _count, sealed, abort = export.state()
        if abort is not None:
            yield {"kind": "kv_abort", "reason": abort}
            return
        if sealed and sent >= export.chunk_count():
            yield {
                "kind": "kv_eos",
                "total_chunks": sent,
                "num_blocks": export.num_blocks,
                "num_tokens": export.num_tokens,
            }
            return
        remaining = deadline - loop.time()
        if budget <= 0 or remaining <= 0:
            yield {"kind": "kv_more", "cursor": sent}
            return
        await export.wait_change(sent, remaining)


# ---------------------------------------------------------------------------
# Client pump (decode worker's pull loop)
# ---------------------------------------------------------------------------


@dataclass
class PulledKvStream:
    """Everything one completed pull produced, plus the overlap
    accounting the bench/metrics report."""

    chunks: list
    num_tokens: int
    num_blocks: int
    total_bytes: int
    overlapped_bytes: int  # received while remote prefill was still running

    @property
    def overlap_frac(self) -> float:
        return self.overlapped_bytes / self.total_bytes if self.total_bytes else 0.0


async def pull_kv_stream(
    window_call,
    *,
    credit_bytes: int = DEFAULT_CREDIT_BYTES,
    stall_timeout_s: float = 20.0,
    window_wait_s: float = 2.0,
    prefill_done=None,
    failed=None,
    on_inflight=None,
    budget: CreditBudget | None = None,
    budget_kind: str = "disagg",
) -> PulledKvStream:
    """Drive the windowed pull until ``kv_eos``.

    ``window_call(cursor, credit_bytes, wait_s)`` → async iterator of one
    window's frames (a fresh kv_fetch RPC per window; the cursor acks the
    previous window, returning its flow-control credit).

    ``stall_timeout_s`` bounds time WITHOUT progress, not the whole
    transfer — a healthy many-GB stream may take longer than any fixed
    total. ``prefill_done`` (nullary → bool) classifies each chunk as
    overlapped (arrived while the remote prefill still ran) or not;
    ``failed`` (nullary → bool) reports that the remote prefill FAILED —
    a prefill that died before registering its export never produces
    kv_abort on the wire (the server just keeps answering ``kv_more``),
    so without this signal the pull would wait out the full stall budget;
    ``on_inflight(bytes)`` reports assembled-but-uninjected bytes for the
    inflight gauge.

    ``budget`` (a :class:`CreditBudget`) arbitrates the credit window
    PER PULL WINDOW across the process's concurrent streams: each
    window's advertised credit is what the budget grants ``budget_kind``
    at that moment, and delivered bytes are charged back on release —
    a background (non-priority) kind pulls smaller windows while the
    disagg plane is busy instead of doubling in-flight bytes.

    Raises TransferAbortedError / TransferTimeoutError / TransferError.
    """
    asm = KvChunkAssembler()
    chunks: list[KvChunk] = []
    total_bytes = 0
    overlapped = 0
    cursor = 0
    deadline = time.monotonic() + stall_timeout_s
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TransferTimeoutError(
                f"kv stream stalled at chunk {cursor} ({total_bytes} bytes in)"
            )
        eos: dict | None = None
        progressed = False
        granted = credit_bytes
        if budget is not None:
            granted = budget.acquire(budget_kind, credit_bytes)
        window_bytes = 0
        window = window_call(cursor, granted, min(window_wait_s, remaining))
        try:
            async for frame in window:
                if frame.get("error"):
                    raise TransferError(str(frame["error"]))
                kind = frame.get("kind")
                if kind == "kv_abort":
                    raise TransferAbortedError(str(frame.get("reason") or "aborted"))
                if kind == "kv_eos":
                    eos = frame
                    break
                if kind == "kv_more":
                    break
                chunk = asm.feed(frame)
                if chunk is not None:
                    chunks.append(chunk)
                    cursor += 1
                    progressed = True
                    total_bytes += chunk.nbytes
                    window_bytes += chunk.nbytes
                    if prefill_done is not None and not prefill_done():
                        overlapped += chunk.nbytes
                    if on_inflight is not None:
                        on_inflight(total_bytes)
        finally:
            aclose = getattr(window, "aclose", None)
            if aclose is not None:
                await aclose()
            if budget is not None:
                budget.release(budget_kind, granted, delivered=window_bytes)
        if asm.mid_chunk:
            raise TransferError("kv stream cut mid-chunk")
        if eos is None and not progressed and failed is not None and failed():
            raise TransferAbortedError("remote prefill failed before sealing the stream")
        if eos is not None:
            if cursor != int(eos.get("total_chunks") or cursor):
                raise TransferError(
                    f"kv stream ended at chunk {cursor}, "
                    f"publisher sealed {eos.get('total_chunks')}"
                )
            return PulledKvStream(
                chunks=chunks,
                num_tokens=int(eos.get("num_tokens") or 0),
                num_blocks=int(eos.get("num_blocks") or 0),
                total_bytes=total_bytes,
                overlapped_bytes=overlapped,
            )
        if progressed:
            deadline = time.monotonic() + stall_timeout_s


def inject_payload_from_chunks(pulled: PulledKvStream) -> dict:
    """→ the ``kv_transfer_params.inject`` dict the engine consumes:
    chunk-granular, so admission scatters each run separately instead of
    concatenating one giant host payload."""
    return {
        "chunks": [c.to_wire() for c in pulled.chunks],
        "num_tokens": pulled.num_tokens,
        "num_blocks": pulled.num_blocks,
    }
