"""The port's logprob analysis (``llm/logprobs.py``) against the JAX one,
over a capture the port's frontend wrote.

A port store, a ``--engine mocker`` port worker (its fake logprobs are a
pure function of the token) and a port frontend started with
``--record-dir`` serve chats and completions with logprobs, aggregated and
streamed, with and without top alternatives. The frontend's recorder
writes one JSONL capture; both packages' ``analyze_recording`` must give
the same summary over it, whole and per request id, both packages'
``analyze_logprob_sensitivity`` the same over the responses, and both CLIs
(``python -m <pkg>.llm.logprobs capture.jsonl [--rid R]``) the same line.
"""

from __future__ import annotations

import asyncio
import json
import signal
import socket
import subprocess
import sys
from pathlib import Path

from dynamo_tpu.llm import logprobs as jlp
from dynamo_tpu_torch.llm import logprobs as tlp
from dynamo_tpu_torch.llm.client import OpenAIClient
from procutil import ManagedProcess

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def traffic(base: str) -> list[dict]:
    """Chats and completions with logprobs → the aggregate responses and
    the streamed chunks, in order."""
    out = []
    async with OpenAIClient(base, default_model="mock-model") as c:
        for _ in range(200):
            if await c.models() == ["mock-model"]:
                break
            await asyncio.sleep(0.05)
        msgs = [{"role": "user", "content": "why is the sky blue"}]
        out.append(await c.chat(msgs, max_tokens=9, logprobs=True, top_logprobs=3))
        out.append(await c.chat(msgs, max_tokens=7, logprobs=True))
        out.append(await c.completion("logprob me please", max_tokens=8, logprobs=2))
        out += [ch async for ch in c.chat_stream(msgs, max_tokens=6, logprobs=True,
                                                 top_logprobs=2)]
    return out


def test_analyses_and_cli_equal_over_a_port_capture(tmp_path):
    sp = _free_port()
    url = f"tcp://127.0.0.1:{sp}"
    record = tmp_path / "rec"
    procs = []
    try:
        store = ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host",
                                "127.0.0.1", "--port", str(sp)], name="store")
        procs.append(store)
        store.wait_for(r"store server: tcp://")
        worker = ManagedProcess(["-m", "dynamo_tpu_torch.worker", "--store-url", url,
                                 "--engine", "mocker", "--mocker-ttft-ms", "1",
                                 "--mocker-itl-ms", "1", "--block-size", "4"], name="worker")
        procs.append(worker)
        worker.wait_for(r"serving mock-model", 60)
        fe = ManagedProcess(["-m", "dynamo_tpu_torch.frontend", "--store-url", url, "--host",
                             "127.0.0.1", "--port", "0", "--record-dir", str(record)],
                            name="frontend")
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 60).group(1))
        responses = asyncio.run(asyncio.wait_for(traffic(f"http://127.0.0.1:{port}"), 60))
        fe.proc.send_signal(signal.SIGTERM)  # the recorder's file is closed on the way out
        assert fe.proc.wait(30) == 0
    finally:
        for p in reversed(procs):
            p.terminate()

    capture = record / "mock-model.jsonl"
    lines = [json.loads(ln) for ln in capture.read_text().splitlines()]
    rids = sorted({r["rid"] for r in lines if r.get("kind") == "delta"})
    assert len(rids) == 4
    whole = tlp.analyze_recording(str(capture)).summary()
    assert whole == jlp.analyze_recording(str(capture)).summary()
    assert whole["responses_analyzed"] > 0 and whole["choices"]["0"]["positions"] > 0
    for rid in rids:
        assert (tlp.analyze_recording(str(capture), rid).summary()
                == jlp.analyze_recording(str(capture), rid).summary())
    live = tlp.analyze_logprob_sensitivity(responses).summary()
    assert live == jlp.analyze_logprob_sensitivity(responses).summary()
    assert live["choices"]["0"]["positions"] == 9 + 7 + 8 + 6
    assert tlp.extract_logprobs(responses[0]) and any(
        p.alternatives for p in tlp.extract_logprobs(responses[0])[0])

    def cli(pkg: str, *extra: str) -> str:
        out = subprocess.run([sys.executable, "-m", f"{pkg}.llm.logprobs", str(capture), *extra],
                             cwd=REPO, capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                                  "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)})
        assert out.returncode == 0, out.stderr[-2000:]
        return out.stdout

    for extra in ((), ("--rid", rids[0])):
        port_line = cli("dynamo_tpu_torch", *extra)
        assert port_line == cli("dynamo_tpu", *extra)
        assert json.loads(port_line)["responses_analyzed"] > 0
