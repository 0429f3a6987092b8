"""TCP transport for the control-plane store.

``StoreServer`` hosts a :class:`~dynamo_tpu_torch.runtime.store.MemoryStore` behind
a msgpack/TCP protocol; ``TcpStoreClient`` implements the
:class:`~dynamo_tpu_torch.runtime.store.KeyValueStore` interface against it.
One connection per client, request-id multiplexed; watch events are pushed
server→client tagged with the watch id. Run standalone via
``python -m dynamo_tpu_torch.runtime.store_server``.

This plus the messaging plane replaces the reference's etcd+NATS external
infra (reference: SURVEY.md §1 layer 0).
"""

from __future__ import annotations

import asyncio
import itertools

from dynamo_tpu_torch.runtime import framing
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.store import (
    EventKind,
    KeyExistsError,
    KeyValueStore,
    KvEntry,
    LeaseNotFoundError,
    MemoryStore,
    PutMode,
    StoreError,
    Watch,
    WatchEvent,
)

log = get_logger("store_net")


def _entry_to_wire(e: KvEntry) -> dict:
    return {
        "key": e.key,
        "value": e.value,
        "lease_id": e.lease_id,
        "create_revision": e.create_revision,
        "mod_revision": e.mod_revision,
    }


def _entry_from_wire(d: dict) -> KvEntry:
    return KvEntry(
        key=d["key"],
        value=d["value"],
        lease_id=d["lease_id"],
        create_revision=d["create_revision"],
        mod_revision=d["mod_revision"],
    )


class StoreServer:
    """Serves a MemoryStore over TCP."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, store: MemoryStore | None = None):
        self.host = host
        self.port = port
        self.store = store or MemoryStore()
        self._server: asyncio.Server | None = None
        # leases/watches owned per connection so a dropped client cleans up.

    async def start(self) -> "StoreServer":
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("store server listening on %s:%d", self.host, self.port)
        return self

    @property
    def url(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self.store.close()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        framing.set_nodelay(writer)
        conn_leases: set[int] = set()
        conn_watches: dict[int, tuple[Watch, asyncio.Task]] = {}
        write_lock = asyncio.Lock()

        async def send(obj) -> None:
            async with write_lock:
                await framing.write_frame(writer, obj)

        async def pump_watch(watch_id: int, watch: Watch) -> None:
            try:
                async for ev in watch:
                    await send(
                        {
                            "watch_id": watch_id,
                            "event": {
                                "kind": ev.kind.value,
                                "key": ev.key,
                                "value": ev.value,
                                "revision": ev.revision,
                            },
                        }
                    )
            except (ConnectionResetError, BrokenPipeError):
                pass

        # The event loop holds tasks only weakly: retain dispatch tasks so they
        # can't be garbage-collected mid-execution, and cancel any still pending
        # on disconnect so they don't write to a closed writer.
        dispatch_tasks: set[asyncio.Task] = set()
        try:
            while True:
                msg = await framing.read_frame(reader)
                if msg is None:
                    break
                task = asyncio.get_running_loop().create_task(
                    self._dispatch(msg, send, conn_leases, conn_watches, pump_watch)
                )
                dispatch_tasks.add(task)
                task.add_done_callback(dispatch_tasks.discard)
        finally:
            for task in list(dispatch_tasks):
                task.cancel()
            for watch, task in conn_watches.values():
                task.cancel()
                await watch.cancel()
            for lease_id in conn_leases:
                await self.store.revoke_lease(lease_id)
            writer.close()

    async def _dispatch(self, msg, send, conn_leases, conn_watches, pump_watch) -> None:
        op = msg["op"]
        rid = msg["id"]
        try:
            store = self.store
            if op == "put":
                rev = await store.put(
                    msg["key"], msg["value"], msg.get("lease_id"), PutMode(msg.get("mode", "overwrite"))
                )
                await send({"id": rid, "ok": True, "revision": rev})
            elif op == "get":
                e = await store.get(msg["key"])
                await send({"id": rid, "ok": True, "entry": _entry_to_wire(e) if e else None})
            elif op == "get_prefix":
                es = await store.get_prefix(msg["prefix"])
                await send({"id": rid, "ok": True, "entries": [_entry_to_wire(e) for e in es]})
            elif op == "delete":
                found = await store.delete(msg["key"])
                await send({"id": rid, "ok": True, "found": found})
            elif op == "delete_prefix":
                n = await store.delete_prefix(msg["prefix"])
                await send({"id": rid, "ok": True, "count": n})
            elif op == "lease_grant":
                lease_id = await store.grant_lease(msg["ttl"])
                conn_leases.add(lease_id)
                await send({"id": rid, "ok": True, "lease_id": lease_id})
            elif op == "lease_keepalive":
                await store.keep_alive(msg["lease_id"])
                await send({"id": rid, "ok": True})
            elif op == "lease_revoke":
                await store.revoke_lease(msg["lease_id"])
                conn_leases.discard(msg["lease_id"])
                await send({"id": rid, "ok": True})
            elif op == "watch":
                watch = await store.watch_prefix(msg["prefix"])
                watch_id = msg["watch_id"]
                task = asyncio.get_running_loop().create_task(pump_watch(watch_id, watch))
                conn_watches[watch_id] = (watch, task)
                await send(
                    {"id": rid, "ok": True, "snapshot": [_entry_to_wire(e) for e in watch.snapshot]}
                )
            elif op == "watch_cancel":
                pair = conn_watches.pop(msg["watch_id"], None)
                if pair:
                    pair[1].cancel()
                    await pair[0].cancel()
                await send({"id": rid, "ok": True})
            else:
                await send({"id": rid, "ok": False, "error": f"unknown op {op}"})
        except KeyExistsError as e:
            await send({"id": rid, "ok": False, "error": str(e), "kind": "key_exists"})
        except LeaseNotFoundError as e:
            await send({"id": rid, "ok": False, "error": str(e), "kind": "lease_not_found"})
        except Exception as e:  # noqa: BLE001 — protocol boundary
            log.exception("store op %s failed", op)
            await send({"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}"})


class TcpStoreClient(KeyValueStore):
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._ids = itertools.count(1)
        self._watch_ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._watch_queues: dict[int, asyncio.Queue] = {}
        self._pump: asyncio.Task | None = None
        self._write_lock = asyncio.Lock()
        self._closed = False

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        framing.set_nodelay(self._writer)
        self._pump = asyncio.get_running_loop().create_task(self._pump_loop())

    async def _pump_loop(self) -> None:
        assert self._reader is not None
        while True:
            msg = await framing.read_frame(self._reader)
            if msg is None:
                break
            if "watch_id" in msg and "event" in msg:
                queue = self._watch_queues.get(msg["watch_id"])
                if queue is not None:
                    ev = msg["event"]
                    queue.put_nowait(
                        WatchEvent(EventKind(ev["kind"]), ev["key"], ev["value"], ev["revision"])
                    )
                continue
            fut = self._pending.pop(msg["id"], None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
        # connection lost: fail pending requests, end watches
        self._closed = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("store connection lost"))
        self._pending.clear()
        for queue in self._watch_queues.values():
            queue.put_nowait(None)

    async def _call(self, msg: dict) -> dict:
        if self._closed:
            raise ConnectionError("store client closed")
        rid = next(self._ids)
        msg["id"] = rid
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        async with self._write_lock:
            await framing.write_frame(self._writer, msg)
        resp = await fut
        if not resp.get("ok"):
            kind = resp.get("kind")
            if kind == "key_exists":
                raise KeyExistsError(resp.get("error", ""))
            if kind == "lease_not_found":
                raise LeaseNotFoundError(resp.get("error", ""))
            raise StoreError(resp.get("error", "store error"))
        return resp

    async def put(self, key, value, lease_id=None, mode=PutMode.OVERWRITE) -> int:
        resp = await self._call(
            {"op": "put", "key": key, "value": value, "lease_id": lease_id, "mode": mode.value}
        )
        return resp["revision"]

    async def get(self, key):
        resp = await self._call({"op": "get", "key": key})
        return _entry_from_wire(resp["entry"]) if resp["entry"] else None

    async def get_prefix(self, prefix):
        resp = await self._call({"op": "get_prefix", "prefix": prefix})
        return [_entry_from_wire(e) for e in resp["entries"]]

    async def delete(self, key) -> bool:
        return (await self._call({"op": "delete", "key": key}))["found"]

    async def delete_prefix(self, prefix) -> int:
        return (await self._call({"op": "delete_prefix", "prefix": prefix}))["count"]

    async def grant_lease(self, ttl: float) -> int:
        return (await self._call({"op": "lease_grant", "ttl": ttl}))["lease_id"]

    async def keep_alive(self, lease_id: int) -> None:
        await self._call({"op": "lease_keepalive", "lease_id": lease_id})

    async def revoke_lease(self, lease_id: int) -> None:
        await self._call({"op": "lease_revoke", "lease_id": lease_id})

    async def watch_prefix(self, prefix: str) -> Watch:
        watch_id = next(self._watch_ids)
        queue: asyncio.Queue = asyncio.Queue()
        self._watch_queues[watch_id] = queue
        resp = await self._call({"op": "watch", "prefix": prefix, "watch_id": watch_id})
        snapshot = [_entry_from_wire(e) for e in resp["snapshot"]]

        async def cancel():
            self._watch_queues.pop(watch_id, None)
            if not self._closed:
                try:
                    await self._call({"op": "watch_cancel", "watch_id": watch_id})
                except (ConnectionError, RuntimeError, StoreError):
                    pass

        return Watch(snapshot, queue, cancel)

    async def close(self) -> None:
        self._closed = True
        if self._pump is not None:
            self._pump.cancel()
        if self._writer is not None:
            self._writer.close()
