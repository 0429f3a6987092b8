"""Cross-worker KV prefix reuse — the G4 remote tier, TPU-style.

Reference analogue: the KVBM's remote blockset tier over NIXL
(reference: lib/llm/src/block_manager.rs:68-81,120-146,
block_manager/storage/nixl.rs) — an evicted-or-never-local prefix is
fetched from a peer instead of recomputed. GPUs do this with RDMA
against registered remote blocks; here the peer's *host tier* (G2/G3,
block_manager/tiers.py) is the remote blockset, pages move over the
runtime's response plane in bounded frames (engine/kv_transfer.py), and
the router's index is the directory of who holds what.

Flow:
1. The KV router places a request on worker B but sees worker A holding
   more prefix blocks (kv_router/router.py ``peer_prefix`` hint).
2. B's ingress wrapper (``PeerPrefixFetcher``) hashes the prompt, skips
   the fetch when its own cache already covers the hint, otherwise calls
   A's ``kv_prefix`` endpoint with the block hashes.
3. A answers from its tiers (``serve_kv_prefix``) with the longest
   leading run it holds, streamed as KvPagePayload frames.
4. B attaches the payload as ``kv_transfer_params.inject`` — the same
   materialized-prefix-hit path the disagg handoff uses
   (engine/engine.py:_inject_kv), so token parity is inherited.

Best-effort end to end: any failure falls back to local prefill.
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from dynamo_tpu_torch.engine.kv_transfer import KvPagePayload, concat_page_run
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.tokens import adapter_hash_seed, compute_block_hashes
from dynamo_tpu_torch.transfer.stream import TransferError, read_kv_payload_frames

log = get_logger("peer_kv")

KV_PREFIX_ENDPOINT = "kv_prefix"


def make_kv_prefix_handler(engine, frame_bytes: int = KvPagePayload.DEFAULT_FRAME_BYTES):
    """Serving side: {"hashes": [...]} → KvPagePayload frames for the
    longest leading run of those blocks present in this worker's tiers.
    Thread-safe against the engine loop (tier pools lock internally)."""

    async def kv_prefix(payload: Any, ctx: Context) -> AsyncIterator[dict]:
        hashes = list((payload or {}).get("hashes") or [])
        tiers = getattr(engine, "tiers", None)
        if tiers is None or not tiers.enabled or not hashes:
            yield {"error": "no kv tiers on this worker"}
            return
        run = tiers.read_run(hashes)
        if not run:
            yield {"error": "prefix not resident"}
            return
        bs = engine.args.block_size
        # Normalize to this worker's storage format before shipping —
        # a run can mix arities when a persistent disk dir predates the
        # current kv_quant setting; int8 scales ride the same stream.
        pages = concat_page_run(
            run,
            quantized=engine.args.kv_quant == "int8",
            num_kv_heads=engine.args.model.num_kv_heads,
            dtype=engine.args.dtype,
        )
        for frame in KvPagePayload.from_pages(
            pages, len(run) * bs
        ).to_frames(frame_bytes):
            yield frame

    return kv_prefix


class PeerPrefixFetcher:
    """Ingress wrapper around an engine's ``generate``: resolves a
    router ``peer_prefix`` hint into an inject payload before admission.

    ``fetch_router`` is a DIRECT PushRouter on the worker component's
    ``kv_prefix`` endpoint (peers are same-component instances).
    ``inner`` is the downstream generate target when the engine is
    already wrapped (e.g. the disagg decode handler) — the fetcher still
    needs the raw engine for block size / local-hit queries."""

    def __init__(self, engine, fetch_router, inner=None):
        self.engine = engine
        self.fetch_router = fetch_router
        self.inner = inner or engine
        # Observability (exposed for tests/metrics).
        self.peer_fetches = 0
        self.peer_fetch_failures = 0

    async def generate(self, payload: Any, ctx: Context) -> AsyncIterator[dict]:
        req = payload
        hint = None
        if isinstance(req, dict):
            hint = (req.get("kv_transfer_params") or {}).get("peer_prefix")
        if hint is not None:
            inject = await self._fetch(req, hint, ctx)
            req = dict(req)
            ktp = dict(req.get("kv_transfer_params") or {})
            ktp.pop("peer_prefix", None)
            if inject is not None:
                ktp["inject"] = inject
            req["kv_transfer_params"] = ktp or None
        async for item in self.inner.generate(req, ctx):
            yield item

    async def _fetch(self, req: dict, hint: dict, ctx: Context) -> dict | None:
        """→ wire KvPagePayload dict (with ``block_offset``) | None
        (local prefill fallback).

        Multi-holder failover: a directory-built hint carries a
        ``holders`` list deepest-first; each is tried in turn on a
        declined/failed stream (a holder can evict or die between the
        frontend's pricing and this fetch). A legacy single-holder hint
        is the one-element case."""
        try:
            tokens = list(req.get("token_ids") or [])
            adapter_id = req.get("adapter_id")
            bs = self.engine.args.block_size
            max_hit = (len(tokens) - 1) // bs
            holders = hint.get("holders") or [
                {"instance_id": hint.get("instance_id"),
                 "num_blocks": hint.get("num_blocks")}
            ]
            want = min(
                max(int(h.get("num_blocks") or 0) for h in holders), max_hit
            )
            # Adapter-salted like every other KV identity consumer: the
            # peer's tiers key adapter KV under the same salted hashes.
            hashes = compute_block_hashes(
                tokens, bs, adapter_hash_seed(adapter_id)
            )[:want]
            # Local coverage may already match (or beat) what the peer
            # holds — the router's index lags reality by an event
            # round-trip, and HBM-evicted blocks still count: the
            # admission-time tier onboard serves them from host RAM.
            covered = self.engine.prefix_hit_length(tokens, adapter_id) // bs
            tiers = getattr(self.engine, "tiers", None)
            if tiers is not None and tiers.enabled and covered < want:
                covered += tiers.peek_run_len(hashes[covered:])
            if want <= covered:
                return None
            # Delta only: blocks [covered, want) — the engine injects them
            # after its local hits (block_offset keeps the alignment).
            # Frames assemble through the shared data-plane chunk reader
            # (dynamo_tpu/transfer), the same one the streaming disagg
            # pull uses; a declined stream raises the typed TransferError.
            payload = None
            for holder in holders:
                source = int(holder.get("instance_id") or 0)
                run = min(int(holder.get("num_blocks") or 0), max_hit)
                if run <= covered or not source:
                    continue
                try:
                    payload = await read_kv_payload_frames(
                        self.fetch_router.generate(
                            {"hashes": hashes[covered:run]},
                            Context(trace=ctx.trace),
                            instance_id=source,
                        )
                    )
                except TransferError as e:
                    self.peer_fetch_failures += 1
                    log.debug("peer prefix fetch from %x declined: %s", source, e)
                    continue
                except Exception as e:  # noqa: BLE001 — failover: the holder died mid-stream; the next may still serve
                    self.peer_fetch_failures += 1
                    log.debug("peer prefix fetch from %x failed: %s", source, e)
                    continue
                if payload.num_tokens > 0:
                    break
                payload = None
            if payload is None:
                return None
            self.peer_fetches += 1
            log.info(
                "peer prefix: fetched %d blocks from %x (offset %d)",
                payload.k.shape[1], source, covered,
            )
            out = payload.to_dict()
            out["block_offset"] = covered
            return out
        except Exception as e:  # noqa: BLE001 — reuse is an optimization
            self.peer_fetch_failures += 1
            log.warning("peer prefix fetch failed (%s); prefilling locally", e)
            return None
