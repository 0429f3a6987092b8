"""Disaggregated prefill/decode on the port, on the CPU (mirrors
tests/test_disagg.py, which holds the JAX package).

TorchEngine at test-tiny in float32 (random weights from seed 0, the same
in every engine). Covers: the engine's export then inject against an
aggregated run, export TTL reaping and its refresh on pull, the streaming
data plane's flow control, stall timeout and fast abort, streamed parity
across prefill chunk sizes and kv_quant pairs, push and queue dispatch
(with the early claim), the queue timeout and no-workers fallbacks, a
chaos cut mid-transfer falling back byte-identical, the WorkQueue
primitive, and an end-to-end run through the port's store server with a
prefill worker and a decode worker CLI behind the frontend; the worker's
disagg flags parse as the JAX worker's.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import sys
import time

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.disagg import (
    DisaggConfig,
    DisaggDecodeHandler,
    PrefillHandler,
    PrefillPuller,
    should_prefill_remote,
)
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.chaos import ChaosInjector
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import RouterMode
from dynamo_tpu_torch.runtime.queue import WorkQueue
from dynamo_tpu_torch.runtime.store import connect_store
from dynamo_tpu_torch.tokens import compute_block_hashes
from dynamo_tpu_torch.transfer.stream import (
    KvChunk,
    KvChunkAssembler,
    KvStreamExport,
    TransferAbortedError,
    TransferError,
    TransferTimeoutError,
    chunk_to_frames,
    pull_kv_stream,
)

sys.path.insert(0, os.path.dirname(__file__))
from procutil import ManagedProcess  # noqa: E402

CFG = ModelConfig()  # test-tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_args(**kw) -> EngineArgs:
    d = dict(model=CFG, block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
             max_prefill_tokens=64, dtype="float32", decode_steps=4, device="cpu")
    d.update(kw)
    return EngineArgs(**d)


def greedy_request(prompt, max_tokens=8, **ktp) -> PreprocessedRequest:
    req = PreprocessedRequest(model="t", token_ids=list(prompt))
    req.sampling.temperature = 0.0
    req.sampling.seed = 0
    req.stop.max_tokens = max_tokens
    req.stop.ignore_eos = True
    if ktp:
        req.kv_transfer_params = ktp
    return req


async def collect(engine_like, req, ctx=None):
    out, final = [], None
    async for item in engine_like.generate(req.to_dict() if hasattr(req, "to_dict") else req,
                                           ctx or Context()):
        out.extend(item.get("token_ids") or [])
        if item.get("finish_reason"):
            final = item
    return out, final


def prompt_of(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(1, CFG.vocab_size - 1, size=n).tolist()


async def aggregated(args, prompt, n):
    e = await TorchEngine(args).start()
    try:
        return (await collect(e, greedy_request(prompt, n)))[0]
    finally:
        await e.stop()


def test_should_prefill_remote():
    assert should_prefill_remote(1000, 0, 512)
    assert not should_prefill_remote(400, 0, 512)
    assert not should_prefill_remote(1000, 600, 512)
    assert not should_prefill_remote(512, 0, 512)  # the threshold itself stays local


DISAGG_FLAGS = ("is_prefill_worker", "disagg", "remote_prefill", "no_disagg_stream",
                "prefill_component", "max_local_prefill_length", "prefill_dispatch")


@pytest.mark.parametrize("argv", [[], ["--remote-prefill"], ["--disagg", "off"],
                                  ["--is-prefill-worker", "--component", "prefill"],
                                  ["--no-disagg-stream", "--prefill-dispatch", "push",
                                   "--max-local-prefill-length", "32",
                                   "--prefill-component", "pf"]])
def test_worker_disagg_flags_parse_as_the_jax_workers(argv):
    """The port worker's disagg flags, their defaults and the
    --remote-prefill alias are the JAX worker's."""
    from dynamo_tpu.worker.__main__ import parse_args as jax_parse
    from dynamo_tpu_torch.worker.__main__ import parse_args as port_parse

    port, ref = port_parse(argv), jax_parse(argv)
    assert {f: getattr(port, f) for f in DISAGG_FLAGS} == {f: getattr(ref, f) for f in DISAGG_FLAGS}


# ---------------------------------------------------------------------------
# Engine-level export / inject
# ---------------------------------------------------------------------------


def test_engine_export_then_inject_parity():
    async def go():
        prompt = prompt_of(3, 22)
        ref = await aggregated(make_args(), prompt, 10)
        ea = await TorchEngine(make_args()).start()
        toks_a, final_a = await collect(ea, greedy_request(prompt, 1, do_remote_decode=True))
        meta = final_a.get("kv_transfer_params")
        assert meta and meta["num_blocks"] == (len(prompt) - 1) // 4
        assert toks_a[0] == ref[0]
        export = ea.take_export(meta["remote_handle"])
        assert export is not None and ea.take_export(meta["remote_handle"]) is None
        await ea.stop()
        eb = await TorchEngine(make_args()).start()
        got, _ = await collect(eb, greedy_request(prompt, 10, inject=export.to_dict()))
        # the injected blocks were registered: a repeat prefix-hits them
        assert eb.prefix_hit_length(prompt) == meta["num_blocks"] * 4
        await eb.stop()
        assert eb.inject_bytes == sum(a.nbytes for a in export.pages())
        return got, ref

    got, ref = asyncio.run(go())
    assert got == ref


def test_engine_export_ttl_reaped():
    async def go():
        prompt = prompt_of(4, 14)
        e = await TorchEngine(make_args()).start()
        e.export_ttl_s = 0.0
        _, final = await collect(e, greedy_request(prompt, 1, do_remote_decode=True))
        handle = final["kv_transfer_params"]["remote_handle"]
        await collect(e, greedy_request(prompt[:6], 2))  # a step reaps
        gone = e.take_export(handle)
        await e.stop()
        return gone

    assert asyncio.run(go()) is None


def test_stream_export_ttl_refreshes_on_pull():
    async def go():
        e = await TorchEngine(make_args()).start()
        try:
            exp = KvStreamExport("h-refresh")
            with e._mutex:
                e._exports["h-refresh"] = (exp, time.monotonic() + e.export_ttl_s)
                _, dl0 = e._exports["h-refresh"]
            time.sleep(0.01)
            assert e.get_stream_export("h-refresh") is exp
            with e._mutex:
                _, dl1 = e._exports["h-refresh"]
            assert dl1 > dl0
            e.export_ttl_s = 0.0
            e.get_stream_export("h-refresh")
            await collect(e, greedy_request(list(range(1, 7)), 2))
            return e.get_stream_export("h-refresh") is None and exp.abort_reason == "expired"
        finally:
            await e.stop()

    assert asyncio.run(go())


def test_stream_export_publishes_per_prefill_chunk():
    """A 40-token prompt prefilled in 16-token chunks publishes its full
    blocks as the chunks complete (0-4, 4-8, then 8-9 at seal), and the
    published pages are the cache's."""
    async def go():
        prompt = prompt_of(5, 40)
        e = await TorchEngine(make_args(max_prefill_tokens=16)).start()
        try:
            _, final = await collect(e, greedy_request(prompt, 1, do_remote_decode=True,
                                                       stream_handle="h-chunks"))
            exp = e.get_stream_export("h-chunks")
            assert final["kv_transfer_params"]["stream"] and exp.sealed
            chunks = [c for _, c in exp.chunks_since(0, 1 << 30)]
            cached = e.runner.extract_pages(
                e.pool.match_prefix(compute_block_hashes(prompt, 4)[:9]))
            return chunks, cached, exp
        finally:
            await e.stop()

    chunks, cached, exp = asyncio.run(go())
    assert [(c.block_offset, c.num_blocks) for c in chunks] == [(0, 4), (4, 4), (8, 1)]
    assert exp.num_blocks == 9 and exp.num_tokens == 36
    for i, p in enumerate(cached):
        np.testing.assert_array_equal(np.concatenate([c.pages[i] for c in chunks], axis=1), p)


# ---------------------------------------------------------------------------
# Streaming data plane
# ---------------------------------------------------------------------------


def test_chunk_frame_roundtrip_and_protocol_errors():
    rng = np.random.default_rng(13)
    pages = tuple(rng.standard_normal((2, 3, 4, 8)).astype(np.float32) for _ in range(2))
    chunk = KvChunk(block_offset=5, pages=pages, num_tokens=12)
    frames = list(chunk_to_frames(7, chunk, max_bytes=64))
    assert frames[0]["kind"] == "kv_chunk" and frames[0]["idx"] == 7
    assert all(len(f["data"]) <= 64 for f in frames[1:])
    asm = KvChunkAssembler()
    out = [c for c in (asm.feed(f) for f in frames) if c is not None]
    assert len(out) == 1 and out[0].block_offset == 5 and out[0].num_tokens == 12
    np.testing.assert_array_equal(out[0].pages[1], pages[1])
    asm2 = KvChunkAssembler()
    asm2.feed(frames[0])
    with pytest.raises(TransferError):
        asm2.feed(frames[0])
    with pytest.raises(TransferError):
        KvChunkAssembler().feed(frames[1])


def test_stream_export_flow_control():
    def chunk(off):
        z = np.zeros((1, 1, 4, 8), np.float32)
        return KvChunk(block_offset=off, pages=(z, z), num_tokens=4)

    exp = KvStreamExport("h", max_buffer_bytes=3 * 256)
    assert exp.publish(chunk(0)) and exp.publish(chunk(1)) and exp.publish(chunk(2))
    assert not exp.publish(chunk(3))
    assert exp.abort_reason == "overrun" and exp._buffered_bytes == 0
    exp2 = KvStreamExport("h2", max_buffer_bytes=3 * 256)
    for i in range(3):
        assert exp2.publish(chunk(i))
    exp2.ack(2)
    assert exp2.publish(chunk(3)) and exp2.abort_reason is None
    assert [i for i, _ in exp2.chunks_since(2, 10 << 20)] == [2, 3]
    exp2.seal(num_blocks=4, num_tokens=16)
    assert exp2.state() == (4, True, None)
    with pytest.raises(TransferError):
        exp2.chunks_since(0, 10 << 20)


def _more_window(cursor, credit, wait_s):
    async def gen():
        yield {"kind": "kv_more", "cursor": cursor}
    return gen()


def test_pull_kv_stream_stall_times_out():
    async def go():
        with pytest.raises(TransferTimeoutError):
            await pull_kv_stream(_more_window, stall_timeout_s=0.3, window_wait_s=0.05)
        return True

    assert asyncio.run(go())


def test_pull_kv_stream_failed_signal_aborts_fast():
    async def go():
        t0 = time.monotonic()
        with pytest.raises(TransferAbortedError):
            await pull_kv_stream(_more_window, stall_timeout_s=30.0, window_wait_s=0.05,
                                 failed=lambda: True)
        return time.monotonic() - t0

    assert asyncio.run(go()) < 5.0


# ---------------------------------------------------------------------------
# Prefill worker + decode worker over the runtime (in process)
# ---------------------------------------------------------------------------


async def _prefill_side(url, args, *, frame_bytes=16 << 20, chaos=None, puller=False):
    prt = await DistributedRuntime.create(store_url=url)
    pengine = await TorchEngine(args).start()
    ph = PrefillHandler(pengine, frame_bytes=frame_bytes, chaos=chaos)
    pcomp = prt.namespace("dg").component("prefill")
    gen = await pcomp.endpoint("generate").serve(ph.generate)
    await pcomp.endpoint("kv_fetch").serve(ph.kv_fetch)
    pull = None
    if puller:
        pull = PrefillPuller(pengine, WorkQueue(prt.store, "prefill"), prt.store,
                             gen.instance.instance_id).start()
    return prt, pengine, pull


async def _decode_side(url, args, cfg, queue=False):
    drt = await DistributedRuntime.create(store_url=url)
    dengine = await TorchEngine(args).start()
    pclient = drt.namespace("dg").component("prefill")
    handler = DisaggDecodeHandler(
        dengine,
        await pclient.endpoint("generate").router(RouterMode.ROUND_ROBIN),
        await pclient.endpoint("kv_fetch").router(RouterMode.DIRECT),
        cfg, queue=WorkQueue(drt.store, "prefill") if queue else None,
        store=drt.store if queue else None)
    return drt, dengine, handler


async def _teardown(*items):
    for it in items:
        if it is None:
            continue
        if isinstance(it, PrefillPuller):
            await it.stop()
        elif isinstance(it, TorchEngine):
            await it.stop()
        else:
            await it.shutdown()


def test_disagg_e2e_matches_aggregated():
    """Push dispatch, streamed: the long prompt goes remote once, a short
    one stays local, and a repeat of the long one hits the injected
    (registered) blocks locally."""
    async def go():
        prompt = prompt_of(5, 30)
        ref = await aggregated(make_args(), prompt, 12)
        url = "memory://tdisagg1"
        prt, pengine, _ = await _prefill_side(url, make_args())
        drt, dengine, handler = await _decode_side(url, make_args(),
                                                   DisaggConfig(max_local_prefill_length=8))
        try:
            got, _ = await collect(handler, greedy_request(prompt, 12))
            assert handler.remote_prefills == 1
            await collect(handler, greedy_request(prompt_of(6, 6), 3))
            assert handler.remote_prefills == 1
            got2, _ = await collect(handler, greedy_request(prompt, 12))
            assert handler.remote_prefills == 1 and got2 == ref
            return got, ref
        finally:
            await _teardown(pengine, dengine, drt, prt)

    got, ref = asyncio.run(go())
    assert got == ref


def test_disagg_falls_back_when_no_prefill_workers():
    """The default wiring with no prefill fleet: one discovery lookup, the
    no_workers reason, served locally and quickly."""
    async def go():
        drt, dengine, handler = await _decode_side("memory://tdisagg2", make_args(),
                                                   DisaggConfig(max_local_prefill_length=8))
        try:
            t0 = time.monotonic()
            got, final = await collect(handler, greedy_request(prompt_of(6, 26), 6))
            return got, final, dict(handler.fallback_reasons), time.monotonic() - t0
        finally:
            await _teardown(dengine, drt)

    got, final, reasons, dt = asyncio.run(go())
    assert len(got) == 6 and final["finish_reason"] == "length"
    assert reasons == {"no_workers": 1} and dt < 5.0


def test_disagg_queue_timeout_falls_back_local():
    async def go():
        drt, dengine, handler = await _decode_side(
            "memory://tdisagg4", make_args(),
            DisaggConfig(max_local_prefill_length=8, queue_timeout_s=0.5), queue=True)
        # a prefill instance exists (so the lookup passes) but nothing pulls
        prt = await DistributedRuntime.create(store_url="memory://tdisagg4")

        async def never(payload, ctx):
            yield {}

        await prt.namespace("dg").component("prefill").endpoint("generate").serve(never)
        for _ in range(100):
            if list(handler.prefill_router.discovery.available()):
                break
            await asyncio.sleep(0.01)
        try:
            got, final = await collect(handler, greedy_request(prompt_of(12, 26), 5))
            return got, final, dict(handler.fallback_reasons)
        finally:
            await _teardown(dengine, drt, prt)

    got, final, reasons = asyncio.run(go())
    assert len(got) == 5 and final["finish_reason"] == "length"
    assert reasons == {"queue_timeout": 1}


def test_disagg_queue_dispatch_with_claim():
    """Queue mode: the puller's early claim lets the decode worker pull
    chunks while the queued prefill runs; several chunks, one job, parity."""
    async def go():
        prompt = prompt_of(25, 50)
        args = make_args(max_prefill_tokens=16)
        ref = await aggregated(args, prompt, 8)
        url = "memory://tdisagg_queue"
        prt, pengine, puller = await _prefill_side(url, args, frame_bytes=512, puller=True)
        drt, dengine, handler = await _decode_side(
            url, args, DisaggConfig(max_local_prefill_length=8, queue_timeout_s=30), queue=True)
        try:
            got, _ = await collect(handler, greedy_request(prompt, 8))
            return got, ref, handler.remote_prefills, puller.jobs_done, dict(handler.last_transfer)
        finally:
            await _teardown(puller, pengine, dengine, drt, prt)

    got, ref, remote, jobs, last = asyncio.run(go())
    assert got == ref and remote == 1 and jobs == 1 and last["chunks"] >= 2


def test_disagg_oneshot_queue_dispatch_matches_aggregated():
    """The legacy one-shot pull (``stream=False``) through the queue, in
    many small frames."""
    async def go():
        prompt = prompt_of(11, 30)
        ref = await aggregated(make_args(), prompt, 10)
        url = "memory://tdisagg3"
        prt, pengine, puller = await _prefill_side(url, make_args(), frame_bytes=256,
                                                   puller=True)
        drt, dengine, handler = await _decode_side(
            url, make_args(),
            DisaggConfig(max_local_prefill_length=8, queue_timeout_s=30, stream=False),
            queue=True)
        try:
            got, _ = await collect(handler, greedy_request(prompt, 10))
            return got, ref, handler.remote_prefills, puller.jobs_done
        finally:
            await _teardown(puller, pengine, dengine, drt, prt)

    got, ref, remote, jobs = asyncio.run(go())
    assert got == ref and remote == 1 and jobs == 1


def _streamed(url, p_args, d_args, prompt, n, *, chaos=None, frame_bytes=16 << 20):
    async def go():
        prt, pengine, _ = await _prefill_side(url, p_args, frame_bytes=frame_bytes, chaos=chaos)
        drt, dengine, handler = await _decode_side(
            url, d_args, DisaggConfig(max_local_prefill_length=8, pull_stall_timeout_s=10.0))
        try:
            got, _ = await collect(handler, greedy_request(prompt, n))
            return got, dict(remote=handler.remote_prefills, fallbacks=handler.local_fallbacks,
                             reasons=dict(handler.fallback_reasons),
                             last=dict(handler.last_transfer),
                             bytes=handler.transfer_bytes_total,
                             inject_bytes=dengine.inject_bytes)
        finally:
            await _teardown(pengine, dengine, drt, prt)

    return asyncio.run(go())


@pytest.mark.parametrize("max_prefill", [16, 32])
def test_streamed_disagg_parity_across_chunk_sizes(max_prefill):
    prompt = prompt_of(21, 60)
    ref = asyncio.run(aggregated(make_args(), prompt, 10))
    got, st = _streamed(f"memory://tsdg_{max_prefill}", make_args(max_prefill_tokens=max_prefill),
                        make_args(max_prefill_tokens=max_prefill), prompt, 10)
    assert got == ref
    assert st["remote"] == 1 and st["fallbacks"] == 0
    assert st["last"]["chunks"] >= 2 and st["bytes"] == st["inject_bytes"] > 0


async def oneshot(p_args, d_args, prompt, n):
    """The prompt prefilled and exported in one piece by an engine of
    ``p_args``, injected into a fresh engine of ``d_args`` → its tokens."""
    ea = await TorchEngine(p_args).start()
    try:
        _, final = await collect(ea, greedy_request(prompt, 1, do_remote_decode=True))
        payload = ea.take_export(final["kv_transfer_params"]["remote_handle"])
    finally:
        await ea.stop()
    eb = await TorchEngine(d_args).start()
    try:
        return (await collect(eb, greedy_request(prompt, n, inject=payload.to_dict())))[0]
    finally:
        await eb.stop()


@pytest.mark.parametrize("p_quant,d_quant", [("int8", "int8"), ("none", "int8"),
                                             ("int8", "none")])
def test_streamed_disagg_kv_quant_parity(p_quant, d_quant):
    """Chunks in the publisher's storage format are bridged per chunk to
    the decode engine's (adapt_pages): the stream equals the same pages
    exported and injected in one piece. Between two int8 engines no bridge
    runs and it equals the decode engine's own run; across formats the
    bridge is lossy (int8 rounding, or a prefill whose later layers read
    float pages), so the one-piece move is the exact reference there."""
    prompt = prompt_of(22, 44)
    p_args = make_args(kv_quant=p_quant, max_prefill_tokens=16)
    d_args = make_args(kv_quant=d_quant, max_prefill_tokens=16)
    ref = asyncio.run(oneshot(p_args, d_args, prompt, 8))
    got, st = _streamed(f"memory://tsdgq_{p_quant}_{d_quant}", p_args, d_args, prompt, 8)
    assert got == ref
    assert st["remote"] == 1 and st["fallbacks"] == 0
    if p_quant == d_quant:
        assert got == asyncio.run(aggregated(make_args(kv_quant=d_quant), prompt, 8))


def test_chaos_kill_mid_transfer_falls_back_byte_identical():
    prompt = prompt_of(23, 52)
    ref = asyncio.run(aggregated(make_args(), prompt, 8))
    chaos = ChaosInjector(transfer_cut_p=1.0, seed=3)
    got, st = _streamed("memory://tsdg_chaos", make_args(max_prefill_tokens=16),
                        make_args(max_prefill_tokens=16), prompt, 8, chaos=chaos)
    assert got == ref
    assert st["remote"] == 0 and st["fallbacks"] == 1 and st["reasons"] == {"transfer": 1}
    assert chaos.stats.transfer_cuts >= 1


# ---------------------------------------------------------------------------
# WorkQueue
# ---------------------------------------------------------------------------


def test_work_queue_fifo_and_claim():
    async def go():
        q = WorkQueue(await connect_store("memory://tq1"), "prefill")
        for i in (1, 2, 3):
            await q.enqueue({"i": i})
        assert await q.depth() == 3
        got = [await q.dequeue(timeout=1) for _ in range(3)]
        assert [g["i"] for g in got] == [1, 2, 3]
        return await q.dequeue(timeout=0.05)

    assert asyncio.run(go()) is None


def test_work_queue_blocks_until_enqueue():
    async def go():
        q = WorkQueue(await connect_store("memory://tq2"), "jobs")

        async def producer():
            await asyncio.sleep(0.05)
            await q.enqueue("late")

        task = asyncio.get_running_loop().create_task(producer())
        item = await q.dequeue(timeout=2)
        await task
        return item

    assert asyncio.run(go()) == "late"


def test_work_queue_competing_consumers():
    async def go():
        store = await connect_store("memory://tq3")
        q1, q2 = WorkQueue(store, "jobs"), WorkQueue(store, "jobs")
        for i in range(20):
            await q1.enqueue(i)

        async def drain(q):
            out = []
            while (item := await q.dequeue(timeout=0.1)) is not None:
                out.append(item)
            return out

        a, b = await asyncio.gather(drain(q1), drain(q2))
        return sorted(a + b)

    assert asyncio.run(go()) == list(range(20))


# ---------------------------------------------------------------------------
# Spawned: store server, prefill worker CLI, decode worker CLI, frontend
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.e2e
@pytest.mark.parametrize("dispatch", ["queue", "push"])
def test_cli_prefill_and_decode_workers(dispatch):
    """A long completion through the frontend is prefilled by the prefill
    worker CLI (queue or push dispatch) and decoded by the default worker
    CLI; its tokens equal an in-process aggregated engine's; the decode
    worker's /metrics and counters line count one remote prefill."""
    import httpx

    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    store_port, sys_port = _free_port(), _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    env = {"OMP_NUM_THREADS": "1", "DYNTPU_STORE_LEASE_TTL": "2"}
    engine = ["--device", "cpu", "--preset", "test-tiny", "--dtype", "float32",
              "--block-size", "4", "--num-kv-blocks", "128", "--max-num-seqs", "4",
              "--max-model-len", "256", "--decode-steps", "4"]
    prompt = "disaggregated prefill, decoded elsewhere: " * 4
    with ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                         "--port", str(store_port)], name="store", env=env) as store:
        store.wait_for(r"store server: tcp://")
        with ManagedProcess(["-m", "dynamo_tpu_torch.worker", "--store-url", store_url,
                             "--is-prefill-worker", "--component", "prefill", *engine],
                            name="prefill", env=env) as prefill, \
                ManagedProcess(["-m", "dynamo_tpu_torch.worker", "--store-url", store_url,
                                "--max-local-prefill-length", "32", "--prefill-dispatch",
                                dispatch, "--model-name", "dg", *engine], name="decode",
                               env={**env, "DYNTPU_SYSTEM_ENABLED": "1",
                                    "DYNTPU_SYSTEM_PORT": str(sys_port)}) as decode:
            prefill.wait_for(r"prefill worker: serving", timeout=90)
            decode.wait_for(r"worker: serving dg", timeout=90)
            with ManagedProcess(["-m", "dynamo_tpu_torch.frontend", "--store-url", store_url,
                                 "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"],
                                name="frontend", env=env) as fe:
                port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 90).group(1))

                async def drive():
                    async with httpx.AsyncClient(timeout=60) as client:
                        for _ in range(300):
                            r = await client.get(f"http://127.0.0.1:{port}/v1/models")
                            if [m["id"] for m in r.json()["data"]] == ["dg"]:
                                break
                            await asyncio.sleep(0.1)
                        r = await client.post(f"http://127.0.0.1:{port}/v1/completions", json={
                            "model": "dg", "prompt": prompt, "max_tokens": 12,
                            "temperature": 0, "seed": 0, "ignore_eos": True, "logprobs": 0})
                        assert r.status_code == 200, r.text
                        m = await client.get(f"http://127.0.0.1:{sys_port}/metrics")
                        return r.json(), m.text

                resp, metrics = asyncio.run(drive())
                assert "dynamo_tpu_disagg_remote_prefill_total 1" in metrics
                decode.proc.send_signal(signal.SIGTERM)
                assert decode.proc.wait(timeout=30) == 0
                tail = decode.proc.stdout.read().splitlines()
                counters = next(json.loads(line) for line in reversed(tail)
                                if line.startswith('{"event": "engine_counters"'))
                assert counters["disagg"]["remote_prefills"] == 1
                assert counters["disagg"]["transfers"][0]["outcome"] == "remote"
                prefill.proc.send_signal(signal.SIGTERM)
                assert prefill.proc.wait(timeout=30) == 0
        store.proc.send_signal(signal.SIGTERM)
        assert store.proc.wait(timeout=30) == 0

    async def reference():
        e = await TorchEngine(make_args(num_kv_blocks=128, max_model_len=256,
                                        max_prefill_tokens=2048)).start()
        try:
            return (await collect(e, greedy_request(ByteTokenizer().encode(prompt), 12)))[0]
        finally:
            await e.stop()

    ref = asyncio.run(reference())
    lp_tokens = resp["choices"][0]["logprobs"]["tokens"]
    assert resp["usage"]["completion_tokens"] == 12 and len(lp_tokens) == 12
    assert resp["choices"][0]["text"] == ByteTokenizer().decode(ref)
