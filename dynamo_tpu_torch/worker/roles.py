"""WorkerRoleManager: live prefill↔decode pool membership for one worker.

Disaggregated prefill/decode is the default serving shape and the fleet
drains with zero failures; this module composes the two so
the autoscaler can MOVE an engine between the pools at runtime without
restarting the process (and without losing its warm KV tiers — the
engine object survives every transition):

- **decode role** — the worker serves ``<component>/generate`` behind
  the conditional-disagg decode handler, publishes its model card(s),
  and answers KV events/load metrics, exactly like a ``--disagg auto``
  worker today.
- **prefill role** — the worker serves ``<prefill_component>/generate``
  + ``kv_fetch`` and pulls queued prefill jobs, exactly like an
  ``--is-prefill-worker`` today (no model card: frontends must route
  only to decode workers).

A transition is drain-ordered so no stream can fail: the old role's
instances DEREGISTER first (the router stops picking this worker
within one discovery event), in-flight streams then drain to
completion (``ServeHandle.close``), the prefill puller finishes its
current job, and only then do the new role's endpoints register. The
lease-backed registration key ``autoscaler/<ns>/workers/<lease>``
always names the worker's CURRENT role — the level-converging operator
reads it as ground truth, and it dies with the process, so a killed
worker can never leak a stale pool entry.

The manager also serves the ``workerctl/admin`` endpoint (DIRECT
instance routing): ``{"cmd": "set_role"|"retire"|"status"}`` — the
autoscaler's actuation RPC surface.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Any

from dynamo_tpu_torch.kv_router.publisher import serve_kv_endpoints
from dynamo_tpu_torch.llm.model_card import register_model
from dynamo_tpu_torch.planner.actions import POOL_DECODE, POOL_PREFILL
from dynamo_tpu_torch.planner.actuate import worker_key
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("worker.roles")

ADMIN_COMPONENT = "workerctl"
ADMIN_ENDPOINT = "admin"


class WorkerRoleError(Exception):
    """Typed failure of a role transition (bad role name, transition
    already in flight at shutdown, …) — surfaced to the operator as the
    admin RPC's error frame."""


class WorkerRoleManager:
    """Owns which pool this worker serves and performs the zero-failure
    transitions between them. ``args`` is the parsed worker CLI
    namespace (component names + disagg knobs); ``cards`` is the model
    card list the decode role publishes (base card first)."""

    #: Max blocks a retiring replica pushes to survivors (drain-on-retire,
    #: docs/performance.md "Fleet KV economy"). Bounds the retirement
    #: latency the autoscaler observes: the drain is an optimization, not
    #: a durability guarantee — anything past the budget re-enters the
    #: fleet through G4 or recompute.
    DRAIN_BUDGET_BLOCKS = 256

    def __init__(self, rt, engine, cards, args, broadcaster, chaos=None):
        self.rt = rt
        self.engine = engine
        self.cards = list(cards)
        self.args = args
        self.broadcaster = broadcaster
        self.chaos = chaos
        self.namespace = args.namespace
        self.role: str | None = None
        self.retired = asyncio.Event()
        self._lock = asyncio.Lock()
        self._handles: list = []          # current role's ServeHandles
        self._card_keys: list[str] = []   # published model-card store keys
        self._puller = None
        self._admin_handle = None
        self._peer_handle = None
        # Live migration (worker/migrate.py): outbound coordinator +
        # inbound receiver, wired in start() when the engine has the
        # migration surface. None on control-plane-only engines.
        self.migrator = None
        self.receiver = None
        self._peer_rr = 0

    # -- lifecycle ----------------------------------------------------------

    async def start(self, role: str) -> "WorkerRoleManager":
        if role not in (POOL_DECODE, POOL_PREFILL):
            raise WorkerRoleError(f"unknown role {role!r}")
        comp = self.rt.namespace(self.namespace).component(ADMIN_COMPONENT)
        self._admin_handle = await comp.endpoint(ADMIN_ENDPOINT).serve(self._admin)
        if hasattr(self.engine, "migration_begin"):
            from dynamo_tpu_torch.runtime.push_router import RouterMode
            from dynamo_tpu_torch.worker.migrate import (
                MigrationCoordinator,
                MigrationReceiver,
                register_migration_metrics,
            )

            metrics = register_migration_metrics(self.rt.metrics)
            self.receiver = MigrationReceiver(
                self.rt, self.namespace, chaos=self.chaos, metrics=metrics
            )
            self.migrator = MigrationCoordinator(
                self.engine,
                await comp.endpoint(ADMIN_ENDPOINT).router(RouterMode.DIRECT),
                self.args.component,
                await self.rt.primary_lease(),
                chaos=self.chaos,
                metrics=metrics,
            )
            # QoS defrag: the engine offers a relocation before killing
            # a preemption victim. Called from the scheduler thread →
            # bounce onto the event loop.
            loop = asyncio.get_running_loop()
            self.engine.migration_offer = lambda rid: loop.call_soon_threadsafe(
                lambda: loop.create_task(self._offer_migration(rid))
            )
        # G4 peer prefix serving is role-agnostic (host-tier reads):
        # registered once, survives every transition.
        if self.args.engine == "tpu":
            from dynamo_tpu_torch.llm.peer_kv import KV_PREFIX_ENDPOINT, make_kv_prefix_handler

            wcomp = self.rt.namespace(self.namespace).component(self.args.component)
            self._peer_handle = await wcomp.endpoint(KV_PREFIX_ENDPOINT).serve(
                make_kv_prefix_handler(self.engine)
            )
        async with self._lock:
            await self._activate(role)
        return self

    async def set_role(self, role: str, relocate: bool = True) -> dict:
        if role not in (POOL_DECODE, POOL_PREFILL):
            raise WorkerRoleError(f"unknown role {role!r}")
        async with self._lock:
            if self.retired.is_set():
                raise WorkerRoleError("worker is retiring")
            if role == self.role:
                return self.status()
            log.info("pool move: %s → %s", self.role, role)
            if relocate:
                await self._relocate_running()
            await self._deactivate()
            await self._activate(role)
            return self.status()

    async def retire(self, relocate: bool = True) -> None:
        """Drain + deregister everything and signal the process to
        exit — the scale-down half of zero-downtime replica scaling.
        New work stops the moment the instances deregister; in-flight
        streams complete inside the drain (running decodes RELOCATE to
        peers first when possible, so retirement usually drains an
        already-empty batch)."""
        async with self._lock:
            if self.retired.is_set():
                return
            log.info("retiring (%s)", self.role)
            if relocate:
                await self._relocate_running()
            await self._drain_hot_kv()
            await self._deactivate()
            try:
                await self.rt.store.delete(
                    worker_key(self.namespace, await self.rt.primary_lease())
                )
            except Exception:  # noqa: BLE001 — the lease reaps the key anyway; retire must not fail on a flaky store
                pass
            self.retired.set()

    async def close(self) -> None:
        await self.retire()
        if self.receiver is not None:
            await self.receiver.close()
        for h in (self._peer_handle, self._admin_handle):
            if h is not None:
                await h.close()
        self._peer_handle = self._admin_handle = None

    # -- live migration -----------------------------------------------------

    async def _peers(self) -> list[int]:
        """Live decode-pool peer instance ids (relocation targets),
        excluding this worker."""
        from dynamo_tpu_torch.planner.actuate import read_pools

        me = await self.rt.primary_lease()
        pools = await read_pools(self.rt.store, self.namespace)
        return [
            w.instance_id for w in pools.get(POOL_DECODE, [])
            if w.instance_id != me
        ]

    async def _relocate_running(self) -> dict:
        """Best-effort relocation of every running decode to peer decode
        workers — pool moves and retirement RELOCATE instead of drain.
        Any failure just leaves that sequence to the drain (the
        fallback); this must never raise."""
        if self.migrator is None or self.role != POOL_DECODE:
            return {}
        if not hasattr(self.engine, "list_running"):
            return {}
        try:
            peers = await self._peers()
        except Exception as e:  # noqa: BLE001 — a degraded store only disables relocation; the drain still runs
            log.warning("relocation peer discovery failed (%s); draining", e)
            return {}
        if not peers:
            return {}
        moved = kept = 0
        for i, rid in enumerate(self.engine.list_running()):
            res = await self.migrator.migrate_out(rid, peers[i % len(peers)])
            if res.get("ok"):
                moved += 1
            else:
                kept += 1
        if moved or kept:
            log.info("relocation: %d moved, %d left to drain", moved, kept)
        return {"relocated": moved, "kept": kept}

    # -- drain-on-retire KV handoff -----------------------------------------

    def _hot_chains(self) -> list[list[int]]:
        """Root→leaf block-hash chains from the radix pool snapshot,
        deepest first, each truncated to its tier-resident leading run
        (``kv_prefix`` serves from the tiers, not HBM — but write-through
        offload keeps the tiers current for sealed blocks)."""
        snap = self.engine.pool.snapshot()
        parent = {h: p for h, p in snap}
        inner = {p for _, p in snap if p is not None}
        chains: list[list[int]] = []
        for leaf in (h for h in parent if h not in inner):
            chain: list[int] = []
            h: int | None = leaf
            while h is not None and h in parent:
                chain.append(h)
                h = parent[h]
            chain.reverse()
            run = self.engine.tiers.peek_run_len(chain)
            if run:
                chains.append(chain[:run])
        chains.sort(key=len, reverse=True)
        return chains

    async def _drain_hot_kv(self) -> dict:
        """Push this worker's warm prefixes to surviving decode peers
        before the endpoints deregister — the retirement half of the
        fleet KV economy: a scale-down must not cold-start the very
        prefixes that made this replica the victim's *survivors* hot.

        Each survivor PULLS the pages itself (``kv_adopt`` admin RPC →
        our still-registered ``kv_prefix`` endpoint), so the transfer
        rides the same bounded-frame data plane as routed peer fetches,
        and the survivor's tier puts republish directory residency.
        Best-effort throughout: any failure (peer gone, RPC timeout,
        this process dying mid-drain) degrades to a plain retire."""
        try:
            tiers = getattr(self.engine, "tiers", None)
            pool = getattr(self.engine, "pool", None)
            if (tiers is None or not getattr(tiers, "enabled", False)
                    or pool is None or not hasattr(pool, "snapshot")):
                return {}
            peers = await self._peers()
            if not peers:
                return {}
            from dynamo_tpu_torch.runtime.engine import Context
            from dynamo_tpu_torch.runtime.push_router import RouterMode

            admin = await (
                self.rt.namespace(self.namespace).component(ADMIN_COMPONENT)
                .endpoint(ADMIN_ENDPOINT).router(RouterMode.DIRECT)
            )
            me = await self.rt.primary_lease()
            budget = self.DRAIN_BUDGET_BLOCKS
            sent: set[int] = set()
            drained = 0
            for i, chain in enumerate(self._hot_chains()):
                if budget <= 0:
                    break
                hashes = [h for h in chain if h not in sent][:budget]
                if not hashes:
                    continue
                peer = peers[i % len(peers)]
                res: dict = {}
                try:
                    async for item in admin.generate(
                        {"cmd": "kv_adopt", "hashes": hashes,
                         "source_component": self.args.component,
                         "source_instance": me},
                        Context(), instance_id=peer,
                    ):
                        res = item or {}
                except Exception as e:  # noqa: BLE001 — a dead survivor just forfeits its share of the drain
                    log.debug("kv drain to %x failed: %s", peer, e)
                    continue
                n = int(res.get("adopted") or 0)
                if n:
                    sent.update(hashes[:n])
                    budget -= n
                    drained += n
            if drained:
                log.info(
                    "hot-KV drain: %d blocks adopted by %d survivor(s)",
                    drained, len(peers),
                )
            return {"drained": drained}
        except Exception as e:  # noqa: BLE001 — the drain is an optimization; retirement must proceed
            log.warning("hot-KV drain failed (%s); retiring without it", e)
            return {}

    async def _kv_adopt_cmd(self, payload: dict) -> dict:
        """``{"cmd": "kv_adopt", "hashes", "source_component",
        "source_instance"}`` — adopt a retiring peer's warm prefix run:
        pull the pages from its ``kv_prefix`` endpoint and store them in
        our own tiers (protected, so the adopted prefix survives the
        next one-off-prompt burst). → {"ok", "adopted": n}."""
        tiers = getattr(self.engine, "tiers", None)
        if tiers is None or not getattr(tiers, "enabled", False):
            return {"error": "no kv tiers on this worker"}
        hashes = [int(h) for h in payload.get("hashes") or []]
        source = int(payload.get("source_instance") or 0)
        component = payload.get("source_component") or self.args.component
        if not hashes or not source:
            return {"ok": True, "adopted": 0}
        from dynamo_tpu_torch.engine.kv_transfer import split_page_run
        from dynamo_tpu_torch.llm.peer_kv import KV_PREFIX_ENDPOINT
        from dynamo_tpu_torch.runtime.engine import Context
        from dynamo_tpu_torch.runtime.push_router import RouterMode
        from dynamo_tpu_torch.transfer.stream import TransferError, read_kv_payload_frames

        router = await (
            self.rt.namespace(self.namespace).component(component)
            .endpoint(KV_PREFIX_ENDPOINT).router(RouterMode.DIRECT)
        )
        try:
            kv = await read_kv_payload_frames(
                router.generate({"hashes": hashes}, Context(), instance_id=source)
            )
        except TransferError as e:
            return {"ok": False, "reason": str(e)}
        if kv.num_tokens <= 0:
            return {"ok": True, "adopted": 0}
        pages = kv.pages()
        blocks = split_page_run(pages, pages[0].shape[1])
        pairs = [(h, *blk) for h, blk in zip(hashes, blocks)]
        step = tiers.MAX_OFFLOAD_PER_STEP
        adopted = 0
        for i in range(0, len(pairs), step):
            chunk = pairs[i : i + step]
            adopted += tiers.offload(chunk, protected=[True] * len(chunk))
        return {"ok": True, "adopted": adopted}

    async def _offer_migration(self, request_id: str) -> None:
        """Engine preemption-offer hook target: try to relocate the
        would-be preemption victim to a peer. Failure is fine — the
        engine's grace deadline expires and it preempts as before."""
        if self.migrator is None:
            return
        try:
            peers = await self._peers()
            if not peers:
                return
            self._peer_rr += 1
            await self.migrator.migrate_out(
                request_id, peers[self._peer_rr % len(peers)]
            )
        except Exception:  # noqa: BLE001 — the offer is advisory; the engine's preemption fallback owns correctness
            log.exception("preemption-relief migration of %s failed", request_id)

    # -- role wiring --------------------------------------------------------

    async def _publish_registration(self) -> None:
        lease = await self.rt.primary_lease()
        await self.rt.store.put(
            worker_key(self.namespace, lease),
            json.dumps({
                "role": self.role,
                "pid": os.getpid(),
                "instance_id": lease,
                "model": self.cards[0].name if self.cards else "",
            }).encode(),
            lease_id=lease,
        )

    async def _activate(self, role: str) -> None:
        if role == POOL_DECODE:
            await self._activate_decode()
        else:
            await self._activate_prefill()
        self.role = role
        await self._publish_registration()

    async def _deactivate(self) -> None:
        """Drain-ordered teardown of the current role. Model cards are
        deleted FIRST (frontends stop listing the model through this
        instance), then each ServeHandle deregisters its instance and
        drains its in-flight streams, then the prefill puller finishes
        its current job."""
        for key in self._card_keys:
            try:
                await self.rt.store.delete(key)
            except Exception:  # noqa: BLE001 — lease-backed; at worst the card lingers until TTL
                pass
        self._card_keys = []
        if self._puller is not None:
            await self._puller.drain()
            self._puller = None
        for h in self._handles:
            await h.close()
        self._handles = []
        self.role = None

    async def _activate_decode(self) -> None:
        args = self.args
        comp = self.rt.namespace(self.namespace).component(args.component)
        handler: Any = self.engine
        if args.engine == "tpu" and args.disagg != "off":
            from dynamo_tpu_torch.llm.disagg import DisaggConfig, DisaggDecodeHandler
            from dynamo_tpu_torch.llm.peer_kv import KV_PREFIX_ENDPOINT, PeerPrefixFetcher
            from dynamo_tpu_torch.runtime.push_router import RouterMode
            from dynamo_tpu_torch.runtime.queue import WorkQueue

            pcomp = self.rt.namespace(self.namespace).component(args.prefill_component)
            cfg = DisaggConfig(
                max_local_prefill_length=args.max_local_prefill_length,
                prefill_component=args.prefill_component,
                stream=not args.no_disagg_stream,
            )
            handler = DisaggDecodeHandler(
                self.engine,
                await pcomp.endpoint(cfg.prefill_endpoint).router(RouterMode.ROUND_ROBIN),
                await pcomp.endpoint(cfg.fetch_endpoint).router(RouterMode.DIRECT),
                cfg,
                queue=(
                    None if args.prefill_dispatch == "push"
                    else WorkQueue(self.rt.store, cfg.queue_name)
                ),
                store=self.rt.store,
            )
            handler.bind_metrics(self.rt.metrics)
            handler = PeerPrefixFetcher(
                self.engine,
                await comp.endpoint(KV_PREFIX_ENDPOINT).router(RouterMode.DIRECT),
                inner=handler,
            )
        gen = handler
        receiver = self.receiver

        async def gen_handler(payload, ctx):
            if receiver is not None and isinstance(payload, dict):
                # Migration resume leg: claim the staged KV inject for
                # this handle, if we are the destination that pulled it.
                # A miss (wrong worker after a pin fallback, expired
                # stage) is fine — the identity rides the request and
                # admission just re-prefills from the carried tokens.
                mr = (payload.get("kv_transfer_params") or {}).get("migration_resume")
                if isinstance(mr, dict) and mr.get("handle"):
                    staged = receiver.take(mr["handle"])
                    if staged is not None:
                        payload = dict(payload)
                        ktp = dict(payload.get("kv_transfer_params") or {})
                        ktp["inject"] = staged
                        payload["kv_transfer_params"] = ktp
            async for item in gen.generate(payload, ctx):
                yield item

        self._handles.append(await comp.endpoint(args.endpoint).serve(gen_handler))
        if hasattr(self.engine, "get_stream_export"):
            # Decode workers serve the same windowed kv_fetch surface as
            # prefill workers: a migration DESTINATION pulls the source's
            # chunk stream from here (PrefillHandler.kv_fetch is
            # handle-generic — any registered KvStreamExport serves).
            from dynamo_tpu_torch.llm.disagg import DisaggConfig, PrefillHandler

            dcfg = DisaggConfig()
            fetch = PrefillHandler(
                self.engine, frame_bytes=dcfg.frame_bytes, chaos=self.chaos
            )
            self._handles.append(
                await comp.endpoint(dcfg.fetch_endpoint).serve(fetch.kv_fetch)
            )
        self._handles.extend(
            await serve_kv_endpoints(comp, self.broadcaster, self.engine.metrics)
        )
        if hasattr(self.engine, "embed"):
            engine = self.engine

            async def embed_handler(payload, ctx):
                try:
                    vec = await engine.embed((payload or {}).get("token_ids") or [])
                    yield {"embedding": vec}
                except Exception as e:  # noqa: BLE001 — per-request failure
                    yield {"error": str(e)}

            self._handles.append(await comp.endpoint("embed").serve(embed_handler))
        if hasattr(self.engine, "clear_kv_blocks"):
            engine = self.engine

            async def clear_handler(payload, ctx):
                yield {"cleared": engine.clear_kv_blocks()}

            self._handles.append(await comp.endpoint("clear_kv").serve(clear_handler))
        for card in self.cards:
            self._card_keys.append(
                await register_model(self.rt, self.namespace, card)
            )

    async def _activate_prefill(self) -> None:
        from dynamo_tpu_torch.llm.disagg import DisaggConfig, PrefillHandler, PrefillPuller
        from dynamo_tpu_torch.runtime.queue import WorkQueue

        args = self.args
        comp = self.rt.namespace(self.namespace).component(args.prefill_component)
        dcfg = DisaggConfig(prefill_component=args.prefill_component)
        handler = PrefillHandler(
            self.engine, frame_bytes=dcfg.frame_bytes, chaos=self.chaos
        )
        gen_handle = await comp.endpoint(args.endpoint).serve(handler.generate)
        self._handles.append(gen_handle)
        self._handles.append(
            await comp.endpoint(dcfg.fetch_endpoint).serve(handler.kv_fetch)
        )
        self._handles.extend(
            await serve_kv_endpoints(comp, self.broadcaster, self.engine.metrics)
        )
        self._puller = PrefillPuller(
            self.engine,
            WorkQueue(self.rt.store, dcfg.queue_name),
            self.rt.store,
            gen_handle.instance.instance_id,
        ).start()

    # -- admin RPC ----------------------------------------------------------

    def status(self) -> dict:
        return {
            "ok": True,
            "role": self.role,
            "pid": os.getpid(),
            "retiring": self.retired.is_set(),
        }

    async def _migrate_out_cmd(self, payload: dict) -> dict:
        """``{"cmd": "migrate_out", "request_id"?, "dest_instance"?}`` —
        the planner/operator + fleet-balancer verb. Without a
        destination, round-robins the live decode peers. Without a
        request_id (the balancer's shape — it reasons about ENGINES, not
        sequences), the worker auto-picks the cheapest victim: the
        newest running sequence, which has accumulated the least KV and
        therefore streams fastest."""
        if self.migrator is None:
            return {"error": "migration unsupported on this engine"}
        request_id = payload.get("request_id", "")
        if not request_id:
            running = (
                list(self.engine.list_running())
                if hasattr(self.engine, "list_running") else []
            )
            if not running:
                return {"ok": False, "reason": "no_running"}
            request_id = running[-1]
        dest = payload.get("dest_instance")
        if dest is None:
            peers = await self._peers()
            if not peers:
                return {"ok": False, "reason": "no_peer"}
            self._peer_rr += 1
            dest = peers[self._peer_rr % len(peers)]
        return await self.migrator.migrate_out(request_id, int(dest))

    async def _admin(self, payload: Any, ctx):
        payload = payload or {}
        cmd = payload.get("cmd")
        relocate = payload.get("relocate") is not False
        try:
            if cmd == "status":
                yield self.status()
            elif cmd == "set_role":
                yield await self.set_role(payload.get("role", ""), relocate=relocate)
            elif cmd == "retire":
                # Ack first, retire in the background: the drain may
                # outlive the RPC's own deadline, and the operator
                # converges on the registration key vanishing anyway.
                yield {"ok": True, "retiring": True}
                asyncio.get_running_loop().create_task(self.retire(relocate=relocate))
            elif cmd == "migrate_out":
                yield await self._migrate_out_cmd(payload)
            elif cmd == "kv_adopt":
                yield await self._kv_adopt_cmd(payload)
            elif cmd == "migrate_in_start":
                if self.receiver is None:
                    yield {"error": "no migration receiver"}
                else:
                    yield await self.receiver.start_pull(
                        payload.get("handle", ""),
                        payload.get("source_component", ""),
                        int(payload.get("source_instance") or 0),
                        traceparent=payload.get("traceparent"),
                    )
            elif cmd == "migrate_in_commit":
                if self.receiver is None:
                    yield {"error": "no migration receiver"}
                else:
                    yield await self.receiver.commit(
                        payload.get("handle", ""),
                        int(payload.get("kv_blocks") or 0),
                    )
            elif cmd == "migrate_in_abort":
                if self.receiver is None:
                    yield {"error": "no migration receiver"}
                else:
                    yield await self.receiver.abort(payload.get("handle", ""))
            else:
                yield {"error": f"unknown admin cmd {cmd!r}"}
        except WorkerRoleError as e:
            yield {"error": str(e)}
        except Exception as e:  # noqa: BLE001 — an admin RPC must answer typed, never hang the operator on an unexpected transition failure
            log.exception("admin cmd %s failed", cmd)
            yield {"error": f"{type(e).__name__}: {e}"}
