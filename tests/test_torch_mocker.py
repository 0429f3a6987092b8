"""The port's mocker (``dynamo_tpu_torch/mocker``) against the JAX package's.

Both mockers get the same requests, one at a time, with one frame per
token (``delta_max_tokens=0``: the framing does not depend on host timing)
and a pool small enough to evict: their streams, KV events (hashes,
parents, evictions), the pools' block hashes and the ``ForwardPassMetrics``
after each request must be equal, and under the same chaos seed the kill
draws must land on the same token of the same request. Then the CLIs: a
``--engine mocker`` port worker (and ``python -m dynamo_tpu_torch.mocker``)
behind the port's frontend serves the mocker's echo, and ``python -m
dynamo_tpu_torch.run --engine mocker`` prints what the JAX launcher prints.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import signal
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from dynamo_tpu.mocker.engine import MockerArgs as JArgs
from dynamo_tpu.mocker.engine import MockerEngine as JMocker
from dynamo_tpu.runtime.chaos import ChaosConfig as JChaosConfig
from dynamo_tpu.runtime.chaos import ChaosInjector as JChaos
from dynamo_tpu.runtime.chaos import ChaosKillError as JKill
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.llm.client import OpenAIClient
from dynamo_tpu_torch.mocker import MockerArgs as TArgs
from dynamo_tpu_torch.mocker import MockerEngine as TMocker
from dynamo_tpu_torch.runtime.chaos import ChaosConfig as TChaosConfig
from dynamo_tpu_torch.runtime.chaos import ChaosInjector as TChaos
from dynamo_tpu_torch.runtime.chaos import ChaosKillError as TKill
from dynamo_tpu_torch.runtime.engine import Context as TContext
from procutil import ManagedProcess

REPO = Path(__file__).resolve().parents[1]
MOCK = dict(block_size=4, num_kv_blocks=24, max_num_seqs=4, speedup=1e6, delta_max_tokens=0)
PROMPTS = [list(range(10, 31)), list(range(10, 31)) + [7, 7, 7], [5, 6, 7], list(range(40, 80)),
           list(range(10, 23)), [9] * 11]


def request(i: int, prompt: list[int]) -> dict:
    sampling = {"temperature": 0.0, "seed": i}
    if i % 2:
        sampling.update(logprobs=True, top_logprobs=2)
    stop = {"max_tokens": 6 + i}
    if i == 2:
        stop["stop_token_ids"] = [6]  # the echo's second token: a STOP finish
    return {"model": "mock-model", "token_ids": prompt, "sampling": sampling, "stop": stop,
            "eos_token_ids": [0]}


def drive(mocker_cls, args_cls, ctx_cls, kill_cls=None, chaos=None) -> dict:
    events: list[dict] = []
    engine = mocker_cls(args_cls(**MOCK, chaos=chaos),
                        event_sink=lambda ev: events.append(dataclasses.asdict(ev)))

    async def go():
        out = []
        for i, p in enumerate(PROMPTS):
            frames, killed = [], None
            try:
                async for item in engine.generate(request(i, p), ctx_cls()):
                    frames.append(item)
            except Exception as e:  # noqa: BLE001 — only the chaos kill is expected
                if kill_cls is None or not isinstance(e, kill_cls):
                    raise
                killed = sum(len(f.get("token_ids") or ()) for f in frames)
            out.append({"frames": frames, "killed": killed,
                        "metrics": engine.metrics().to_dict(),
                        "hashes": sorted(engine.pool._cached)})
        return out

    return {"requests": asyncio.run(asyncio.wait_for(go(), 60)), "events": events,
            "generated": engine.total_generated}


def test_streams_events_hashes_and_metrics_equal_the_jax_mockers():
    j = drive(JMocker, JArgs, JContext)
    t = drive(TMocker, TArgs, TContext)
    assert j["requests"] == t["requests"]
    assert j["events"] == t["events"]
    assert j["generated"] == t["generated"] > 0
    assert t["requests"][-1]["hashes"]  # the registered blocks' hashes, compared above
    kinds = {e["kind"] for e in t["events"]}
    assert {"stored", "removed"} <= kinds  # the small pool evicted
    finishes = [r["frames"][-1]["finish_reason"] for r in t["requests"]]
    assert "stop" in finishes and "length" in finishes
    assert any(r["frames"][0].get("log_probs") for r in t["requests"])


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_kill_draws_equal_the_jax_mockers(seed):
    j = drive(JMocker, JArgs, JContext, JKill,
              JChaos(JChaosConfig(enabled=True, seed=seed, kill_p=0.08)))
    t = drive(TMocker, TArgs, TContext, TKill,
              TChaos(TChaosConfig(enabled=True, seed=seed, kill_p=0.08)))
    assert [r["killed"] for r in j["requests"]] == [r["killed"] for r in t["requests"]]
    assert any(r["killed"] is not None for r in t["requests"])
    assert j["requests"] == t["requests"] and j["events"] == t["events"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("entry", [["dynamo_tpu_torch.worker", "--engine", "mocker"],
                                   ["dynamo_tpu_torch.mocker"]])
def test_mocker_worker_serves_behind_the_port_frontend(entry):
    sp = _free_port()
    url = f"tcp://127.0.0.1:{sp}"
    env = {"DYNTPU_RUNTIME_GRACEFUL_SHUTDOWN_TIMEOUT": "10"}
    procs = []
    try:
        store = ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host",
                                "127.0.0.1", "--port", str(sp)], name="store", env=env)
        procs.append(store)
        store.wait_for(r"store server: tcp://")
        # No --device: a mocker worker touches none.
        worker = ManagedProcess(["-m", *entry, "--store-url", url, "--mocker-ttft-ms", "1",
                                 "--mocker-itl-ms", "1", "--block-size", "4"],
                                name="worker", env=env)
        procs.append(worker)
        worker.wait_for(r"serving mock-model .* on no device \(mocker\)", 60)
        fe = ManagedProcess(["-m", "dynamo_tpu_torch.frontend", "--store-url", url, "--host",
                             "127.0.0.1", "--port", "0", "--router-mode", "kv"],
                            name="frontend", env=env)
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 60).group(1))

        async def go():
            async with OpenAIClient(f"http://127.0.0.1:{port}", default_model="mock-model") as c:
                for _ in range(200):
                    if await c.models() == ["mock-model"]:
                        break
                    await asyncio.sleep(0.05)
                return await c.completion("hello mocker", max_tokens=5)

        out = asyncio.run(asyncio.wait_for(go(), 60))
        assert out["choices"][0]["text"] == "hello" and out["usage"]["completion_tokens"] == 5
        for p in (fe, worker):
            p.proc.send_signal(signal.SIGTERM)
            assert p.proc.wait(30) == 0
        last = [ln for ln in worker.proc.stdout.read().splitlines() if ln.startswith("{")][-1]
        assert json.loads(last) == {"event": "engine_counters", "engine": "mocker",
                                    "generated_tokens": 5,
                                    "trace": {"requests": 0, "span_s": 0.0}}
    finally:
        for p in reversed(procs):
            p.terminate()


def test_mocker_cli_rejects_what_it_cannot_serve():
    from dynamo_tpu_torch.worker.__main__ import parse_args

    for argv in (["--engine", "mocker", "--disagg", "on"],
                 ["--engine", "mocker", "--is-prefill-worker"],
                 ["--engine", "mocker", "--lora-slots", "2", "--lora", "a"]):
        with pytest.raises(SystemExit):
            parse_args(argv)


def test_run_with_the_mocker_prints_what_the_jax_launcher_prints(tmp_path):
    path = tmp_path / "p.jsonl"
    path.write_text('{"prompt": "hello mocker", "max_tokens": 5}\n{"prompt": "second"}\n'
                    "raw line\n")

    def run(pkg: str) -> list[dict]:
        out = subprocess.run([sys.executable, "-m", f"{pkg}.run", "--engine", "mocker", "--in",
                              f"batch:{path}", "--max-tokens", "4"], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                                  "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)})
        assert out.returncode == 0, out.stderr[-2000:]
        return [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]

    port = run("dynamo_tpu_torch")
    assert port == run("dynamo_tpu")
    assert [r["text"] for r in port] == ["hello", "seco", "raw "]
