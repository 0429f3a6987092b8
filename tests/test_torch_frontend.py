"""The port's distributed serving stack on a TCP store, on the CPU.

- Port frontend + two port workers (``TorchEngine``): in kv mode a prompt
  repeated with a shared prefix lands on the worker holding the prefix
  (mirrors tests/test_frontend_e2e.py's kv test), and a model leaves
  ``/v1/models`` when its worker goes (its lifecycle test).
- Mixed stacks on one store: a JAX worker (``TpuEngine``) and a port
  worker serve the same weights under two model names; the JAX frontend
  and the port frontend each serve both. A JAX frontend with the port
  worker, and the port frontend with the JAX worker, give the same greedy
  and seeded streams as the all-JAX stack (SSE events and aggregate
  bodies, ids dropped, logprobs to 1e-4), both engines coalescing deltas
  at the JAX defaults behind ``settle`` workers (tests/test_torch_http.py).
- The three port CLIs spawned with ``--device cpu`` (store server,
  worker, kv-mode frontend) serve a chat; SIGTERM ends each with exit
  code 0 (the worker after draining, reporting its engine counters); the
  model vanishes when the worker goes.

test-tiny, float32, every request seeded.
"""

from __future__ import annotations

import asyncio
import json
import signal
import socket
import threading

import httpx
import pytest

from procutil import ManagedProcess
from test_torch_http import (
    assert_close,
    call,
    chat,
    completion,
    jax_engine,
    np_weights,
    port_engine,
    start_frontend,
    start_store,
    start_worker,
    stop_frontend,
    stop_runtime,
    wait_for_models,
)


def test_kv_mode_routes_a_repeated_prefix_to_its_worker():
    async def go():
        store = await start_store("dynamo_tpu_torch")
        params = np_weights()
        engines = [await port_engine(params).start() for _ in range(2)]
        workers = [await start_worker("dynamo_tpu_torch", store.url, e) for e in engines]
        fe = await start_frontend("dynamo_tpu_torch", store.url, mode="kv")
        try:
            await wait_for_models(fe.base, ["tiny"])
            shared = "repeat this very long shared prefix " * 3
            for i in range(6):
                status, _, body = await call(fe.base, "/v1/chat/completions",
                                             chat(shared + str(i), max_tokens=6, seed=i,
                                                  ignore_eos=True), False)
                assert status == 200 and body["usage"]["completion_tokens"] == 6
                await asyncio.sleep(0.05)  # KV events reach the router's index
            generated = [e.total_generated for e in engines]
            # All traffic concentrated on one worker (prefix affinity).
            assert (generated[0] == 0) != (generated[1] == 0), generated

            # The worker holding nothing leaves: the model stays (the other
            # serves it); then the last one leaves and the model is gone.
            idle = generated.index(0)
            await stop_runtime(workers[idle])
            await asyncio.sleep(0.2)
            await wait_for_models(fe.base, ["tiny"])
            await stop_runtime(workers[1 - idle])
            await wait_for_models(fe.base, [])
            status, _, _ = await call(fe.base, "/v1/chat/completions", chat("x", max_tokens=2),
                                      False)
            assert status == 404
        finally:
            await stop_frontend(fe)
            for w in workers:
                await stop_runtime(w)
            for e in engines:
                await e.stop()
            await store.close()

    asyncio.run(go())


REQUESTS = [
    ("/v1/chat/completions", chat("mixed stacks, greedy", max_tokens=10, temperature=0, seed=1,
                                  ignore_eos=True, stream=True)),
    ("/v1/chat/completions", chat("mixed stacks, sampled", max_tokens=10, temperature=0.8,
                                  seed=21, ignore_eos=True, logprobs=True, top_logprobs=2)),
    ("/v1/completions", completion("seeded stream", max_tokens=9, temperature=1.0, seed=77,
                                   ignore_eos=True, stream=True, logprobs=1)),
    ("/v1/completions", completion("greedy aggregate", max_tokens=8, temperature=0, seed=5,
                                   ignore_eos=True)),
]


def test_mixed_stacks_match_the_all_jax_stack():
    async def go():
        store = await start_store("dynamo_tpu")  # the JAX package's store server
        params = np_weights()
        jeng = await jax_engine(params).start()
        teng = await port_engine(params).start()
        settle = threading.Event()
        settle.set()
        jw = await start_worker("dynamo_tpu", store.url, jeng, name="jw", settle=settle)
        tw = await start_worker("dynamo_tpu_torch", store.url, teng, name="tw", settle=settle)
        jfe = await start_frontend("dynamo_tpu", store.url)
        tfe = await start_frontend("dynamo_tpu_torch", store.url)
        try:
            for fe in (jfe, tfe):
                await wait_for_models(fe.base, ["jw", "tw"])
            out = []
            for path, body in REQUESTS:
                row = {}
                for label, fe, model in (("jax/jax", jfe, "jw"), ("jax/port", jfe, "tw"),
                                         ("port/jax", tfe, "jw"), ("port/port", tfe, "tw")):
                    status, _, res = await call(fe.base, path, dict(body, model=model),
                                                body.get("stream", False))
                    assert status == 200, (label, res)
                    row[label] = res
                out.append(row)
            return out
        finally:
            await stop_frontend(jfe)
            await stop_frontend(tfe)
            await stop_runtime(jw)
            await stop_runtime(tw)
            await jeng.stop()
            await teng.stop()
            await store.close()

    for (path, body), row in zip(REQUESTS, asyncio.run(go())):
        ref = row.pop("jax/jax")
        for label, res in row.items():
            # the served model's name is the only difference in the bodies
            assert_close(json.loads(json.dumps(res).replace('"tw"', '"jw"')), ref)
        if body.get("stream"):
            assert ref[-1] == "[DONE]"
            assert ref[-2]["usage"]["completion_tokens"] == body["max_tokens"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.e2e
def test_cli_serving_slice_spawned_processes():
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    env = {"OMP_NUM_THREADS": "1", "DYNTPU_STORE_LEASE_TTL": "2"}
    with ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                         "--port", str(store_port)], name="store", env=env) as store:
        store.wait_for(r"store server: tcp://")
        with ManagedProcess(
            ["-m", "dynamo_tpu_torch.worker", "--store-url", store_url, "--device", "cpu",
             "--preset", "test-tiny", "--dtype", "float32", "--block-size", "4",
             "--num-kv-blocks", "128", "--max-num-seqs", "4", "--max-model-len", "128",
             "--decode-steps", "4", "--model-name", "cli-model"],
            name="worker", env=env,
        ) as worker:
            worker.wait_for(r"serving cli-model", timeout=90)
            with ManagedProcess(
                ["-m", "dynamo_tpu_torch.frontend", "--store-url", store_url,
                 "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"],
                name="frontend", env=env,
            ) as frontend:
                port = int(frontend.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)",
                                             timeout=90).group(1))
                base = f"http://127.0.0.1:{port}"

                async def drive():
                    await wait_for_models(base, ["cli-model"], timeout=30)
                    async with httpx.AsyncClient(timeout=30) as client:
                        r = await client.post(f"{base}/v1/chat/completions", json={
                            "model": "cli-model", "max_tokens": 6, "seed": 3,
                            "ignore_eos": True,
                            "messages": [{"role": "user", "content": "spawned hello"}]})
                        assert r.status_code == 200
                        assert r.json()["usage"]["completion_tokens"] == 6

                asyncio.run(drive())
                # SIGTERM drains the worker: exit 0, counters on its last line.
                worker.proc.send_signal(signal.SIGTERM)
                assert worker.proc.wait(timeout=30) == 0
                tail = worker.proc.stdout.read().strip().splitlines()
                counters = next(json.loads(line) for line in reversed(tail)
                                if line.startswith('{"event": "engine_counters"'))
                assert counters["event"] == "engine_counters"
                assert counters["generated_tokens"] == 6 and counters["decode_substeps"] > 0
                asyncio.run(wait_for_models(base, [], timeout=30))
                frontend.proc.send_signal(signal.SIGTERM)
                assert frontend.proc.wait(timeout=30) == 0
        store.proc.send_signal(signal.SIGTERM)
        assert store.proc.wait(timeout=30) == 0
