"""Speculating workers behind the port's frontend, spawned, on the CPU.

The store server, three ``python -m dynamo_tpu_torch.worker --device
cpu`` processes on the same seeded test-tiny weights (float32) under three
model names and components (so each model routes to its own worker),
unpipelined, and a kv-mode ``python -m dynamo_tpu_torch.frontend``:

- ``dense``: no speculation;
- ``stepwise``: ``--spec-tokens 3 --spec-stepwise``;
- ``tree``: ``--spec-tokens 3 --spec-tree-width 2`` (fused tree passes).

Greedy completions of looping prompts must carry the dense worker's text
and token count, and each speculating worker's ``/metrics`` must show
``engine_spec_proposed_total`` and ``engine_spec_accepted_total`` moving
across the requests. Every process exits 0 on SIGTERM; a worker's last
line reports its verify passes and that none ran eagerly.
"""

from __future__ import annotations

import asyncio
import json
import re
import signal
import socket

import httpx
import pytest

from procutil import ManagedProcess
from test_torch_http import wait_for_models

WORKERS = {"dense": [], "stepwise": ["--spec-tokens", "3", "--spec-stepwise"],
           "tree": ["--spec-tokens", "3", "--spec-tree-width", "2"]}
PROMPTS = ["abcabcabcabcabcabc", "the cat sat on the mat; the cat sat on the", "0101010101"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metric(text: str, name: str) -> float:
    m = re.search(rf"^{re.escape(name)}(?:{{[^}}]*}})? ([0-9.eE+-]+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


@pytest.mark.e2e
def test_speculating_workers_match_dense_worker():
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    env = {"OMP_NUM_THREADS": "1", "DYNTPU_STORE_LEASE_TTL": "2"}
    common = ["--store-url", store_url, "--device", "cpu", "--preset", "test-tiny",
              "--dtype", "float32", "--block-size", "4", "--num-kv-blocks", "128",
              "--max-num-seqs", "4", "--max-model-len", "128", "--decode-steps", "4",
              # Unpipelined, a row drafts on its whole history, so what each
              # worker proposes and accepts does not depend on host timing.
              "--pipeline-depth", "0"]
    sys_ports = {name: _free_port() for name in WORKERS}
    with ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                         "--port", str(store_port)], name="store", env=env) as store:
        store.wait_for(r"store server: tcp://")
        workers = {
            name: ManagedProcess(
                ["-m", "dynamo_tpu_torch.worker", *common, "--model-name", name,
                 "--component", name, *flags],
                name=name, env={**env, "DYNTPU_SYSTEM_ENABLED": "1",
                                "DYNTPU_SYSTEM_PORT": str(sys_ports[name])})
            for name, flags in WORKERS.items()
        }
        try:
            for name, w in workers.items():
                w.wait_for(rf"serving {name} ", timeout=120)
            with ManagedProcess(
                ["-m", "dynamo_tpu_torch.frontend", "--store-url", store_url,
                 "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"],
                name="frontend", env=env,
            ) as frontend:
                port = int(frontend.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)",
                                             timeout=90).group(1))
                base = f"http://127.0.0.1:{port}"

                async def scrape(client, name):
                    r = await client.get(f"http://127.0.0.1:{sys_ports[name]}/metrics")
                    assert r.status_code == 200
                    return {k: _metric(r.text, f"dynamo_tpu_engine_spec_{k}_total")
                            for k in ("proposed", "accepted")}

                async def drive():
                    await wait_for_models(base, list(WORKERS), timeout=60)
                    async with httpx.AsyncClient(timeout=60) as client:
                        before = {n: await scrape(client, n) for n in ("stepwise", "tree")}
                        texts = {}
                        for name in WORKERS:
                            for prompt in PROMPTS:
                                r = await client.post(f"{base}/v1/completions", json={
                                    "model": name, "prompt": prompt, "max_tokens": 24,
                                    "temperature": 0.0, "seed": 1, "ignore_eos": True})
                                assert r.status_code == 200, r.text
                                body = r.json()
                                assert body["usage"]["completion_tokens"] == 24
                                texts[name, prompt] = body["choices"][0]["text"]
                        for prompt in PROMPTS:
                            for name in ("stepwise", "tree"):
                                assert texts[name, prompt] == texts["dense", prompt], (name, prompt)
                        # The series update once per scheduler step.
                        for name in ("stepwise", "tree"):
                            for _ in range(100):
                                after = await scrape(client, name)
                                if after["accepted"] > before[name]["accepted"]:
                                    break
                                await asyncio.sleep(0.05)
                            assert after["proposed"] > before[name]["proposed"], name
                            assert after["accepted"] > before[name]["accepted"], name

                asyncio.run(drive())
                for name, w in workers.items():
                    w.proc.send_signal(signal.SIGTERM)
                    assert w.proc.wait(timeout=30) == 0, name
                    tail = w.proc.stdout.read().strip().splitlines()
                    counters = next(json.loads(line) for line in reversed(tail)
                                    if line.startswith('{"event": "engine_counters"'))
                    assert counters["eager_verifies"] == 0
                    assert (counters["spec_passes"] > 0) == (name != "dense"), name
                    if name == "stepwise":
                        assert counters["spec_forwards"] > counters["spec_passes"]
                frontend.proc.send_signal(signal.SIGTERM)
                assert frontend.proc.wait(timeout=30) == 0
        finally:
            for w in workers.values():
                w.terminate()
        store.proc.send_signal(signal.SIGTERM)
        assert store.proc.wait(timeout=30) == 0
