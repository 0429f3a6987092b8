"""Leader/worker startup barrier over the KV store.

Reference analogue: ``leader_worker_barrier`` (reference: lib/runtime/
src/utils/leader_worker_barrier.rs) — a leader publishes barrier data,
N workers check in, everyone releases together. Used for multi-host
engine boot (all hosts must construct the same mesh before the first
collective) and disagg fleet rollouts.

Protocol (store keys under ``barrier/<name>/``):
  leader:  put ``data`` (with its lease) → watch ``workers/`` until N
           check-ins → put ``go``.
  worker:  put ``workers/<id>`` (with its lease) → watch for ``go`` →
           read ``data``.

Lease-attached keys make the barrier self-cleaning: a crashed
participant's keys vanish with its lease, and the waiters time out
rather than hang forever.
"""

from __future__ import annotations

import asyncio
import time

from dynamo_tpu_torch.runtime.store import EventKind, KeyValueStore


class BarrierTimeout(Exception):
    pass


def _prefix(name: str) -> str:
    return f"barrier/{name}/"


async def leader_barrier(
    store: KeyValueStore,
    name: str,
    num_workers: int,
    data: bytes = b"",
    lease_id: int | None = None,
    timeout: float = 60.0,
) -> None:
    """Publish ``data``, wait for ``num_workers`` check-ins, release."""
    deadline = time.monotonic() + timeout
    prefix = _prefix(name)
    # Clear remnants of any previous run under the same name: without a
    # lease the old ``go``/``workers/`` keys persist, and a reused barrier
    # would release instantly with stale data.
    await store.delete_prefix(prefix)
    await store.put(prefix + "data", data, lease_id=lease_id)
    workers_prefix = prefix + "workers/"
    watch = await store.watch_prefix(workers_prefix)
    try:
        seen = {e.key for e in watch.snapshot}
        while len(seen) < num_workers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise BarrierTimeout(
                    f"barrier {name!r}: {len(seen)}/{num_workers} workers checked in"
                )
            try:
                ev = await asyncio.wait_for(watch.__anext__(), remaining)
            except (asyncio.TimeoutError, StopAsyncIteration):
                raise BarrierTimeout(
                    f"barrier {name!r}: {len(seen)}/{num_workers} workers checked in"
                ) from None
            if ev.kind == EventKind.PUT:
                seen.add(ev.key)
            elif ev.kind == EventKind.DELETE:
                seen.discard(ev.key)  # a worker died pre-release
    finally:
        await watch.cancel()
    await store.put(prefix + "go", b"1", lease_id=lease_id)


async def worker_barrier(
    store: KeyValueStore,
    name: str,
    worker_id: str,
    lease_id: int | None = None,
    timeout: float = 60.0,
) -> bytes:
    """Check in, wait for the leader's release. → the leader's data.

    Ordering-safe against the leader's stale-key cleanup: the watch is
    established BEFORE checking in, the check-in is re-put if the leader's
    ``delete_prefix`` wipes it (worker arrived first), and only ``go``
    PUT *events* release — a stale ``go`` in the snapshot (previous run,
    leader not yet arrived) is ignored. One-shot per run: a worker that
    joins after release times out (same as the reference's boot barrier).
    """
    deadline = time.monotonic() + timeout
    prefix = _prefix(name)
    my_key = prefix + f"workers/{worker_id}"
    go_key = prefix + "go"
    watch = await store.watch_prefix(prefix)
    try:
        await store.put(my_key, b"1", lease_id=lease_id)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise BarrierTimeout(f"timed out waiting for {go_key}")
            try:
                ev = await asyncio.wait_for(watch.__anext__(), remaining)
            except (asyncio.TimeoutError, StopAsyncIteration):
                raise BarrierTimeout(f"timed out waiting for {go_key}") from None
            if ev.kind == EventKind.PUT and ev.key == go_key:
                break
            if ev.kind == EventKind.DELETE and ev.key == my_key:
                # Leader cleanup raced our early check-in; check in again.
                await store.put(my_key, b"1", lease_id=lease_id)
    finally:
        await watch.cancel()
    entry = await store.get(prefix + "data")
    if entry is None:
        raise BarrierTimeout(f"barrier {name!r}: released but data missing (leader died?)")
    return entry.value
