"""A checkpoint served int8 by the port's worker CLI, against the JAX
engine on the same checkpoint, on the CPU.

A test-tiny checkpoint (HF layout, two safetensors shards, float32 from
the JAX package's seeded random weights) is served by a spawned
``python -m dynamo_tpu_torch.worker --model-path <dir> --quant int8
--tokenizer byte`` behind the port's store server and kv-mode frontend.
Greedy and seeded sampled completions over HTTP must carry the same
tokens as an in-process ``TpuEngine`` built from the JAX package's
``load_model(<dir>, quant="int8")`` with the same engine arguments, given
the same byte tokens: the text equal, and every token's logprob to 1e-4
(float32; the two int8 trees are bit-equal, tests/test_torch_loader.py,
and the frameworks differ only in summation order).

The checkpoint also holds a llama-3-shaped ``tokenizer.json`` and a
``generation_config.json`` (tests/tokenizer_families.py, 12 specials so
every id fits test-tiny's 512). Without ``--tokenizer``, the port's
``worker`` and ``run`` tokenize by that file, as the JAX worker does. And
a port worker built from its CLI arguments with no ``--tokenizer`` serves
the same streams (SSE events, token texts and logprobs to 1e-4) as a JAX
worker built from the JAX CLI's arguments on the same checkpoint, through
a port frontend and through a JAX frontend.
"""

from __future__ import annotations

import asyncio
import json
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.loader import load_model as jax_load_model
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.loader import save_checkpoint
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
from procutil import REPO_ROOT, ManagedProcess
from tokenizer_families import LLAMA3_SPECIALS, build

ENGINE = dict(block_size=4, num_kv_blocks=128, max_num_seqs=4, max_model_len=128,
              decode_steps=4)
REQUESTS = [("int8 weights, greedy", 0.0, 1), ("a seeded sampled one", 0.8, 7),
            ("bytes é and more", 1.1, 1000)]
MAX_TOKENS = 10
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = JCfg()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(11), jnp.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny-int8")
    save_checkpoint(path, ModelConfig(), params_from_numpy(tree, "cpu", torch.float32), shards=2)
    build("llama3", Path(path), vocab_size=490, specials=LLAMA3_SPECIALS[:12])
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _jax_reference(path: str) -> list[tuple[list[int], list[float]]]:
    cfg, params = jax_load_model(path, dtype=jnp.float32, quant="int8")
    eng = await TpuEngine(JArgs(model=cfg, dtype="float32", quant="int8", **ENGINE),
                          params=params).start()
    out = []
    try:
        for prompt, temp, seed in REQUESTS:
            req = {"model": cfg.name, "token_ids": list(prompt.encode()),
                   "sampling": {"temperature": temp, "seed": seed, "logprobs": True},
                   "stop": {"max_tokens": MAX_TOKENS, "ignore_eos": True}}
            toks, lps = [], []
            async for item in eng.generate(req, JContext()):
                toks.extend(item.get("token_ids") or [])
                lps.extend(item.get("log_probs") or [])
            out.append((toks, lps))
    finally:
        await eng.stop()
    return out


@pytest.mark.e2e
def test_worker_serves_an_int8_checkpoint_like_the_jax_engine(checkpoint):
    ref = asyncio.run(_jax_reference(checkpoint))
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    env = {"OMP_NUM_THREADS": "1", "DYNTPU_STORE_LEASE_TTL": "2"}
    argv = ["--block-size", "4", "--num-kv-blocks", "128", "--max-num-seqs", "4",
            "--max-model-len", "128", "--decode-steps", "4"]
    with ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                         "--port", str(store_port)], name="store", env=env) as store:
        store.wait_for(r"store server: tcp://")
        with ManagedProcess(
            ["-m", "dynamo_tpu_torch.worker", "--store-url", store_url, "--device", "cpu",
             "--model-path", checkpoint, "--quant", "int8", "--tokenizer", "byte",
             "--dtype", "float32", *argv], name="worker", env=env,
        ) as worker:
            worker.wait_for(r"loaded .* \(quant int8\) in", timeout=90)
            worker.wait_for(r"serving tiny-int8", timeout=90)
            with ManagedProcess(
                ["-m", "dynamo_tpu_torch.frontend", "--store-url", store_url,
                 "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"],
                name="frontend", env=env,
            ) as frontend:
                port = int(frontend.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)",
                                             timeout=90).group(1))
                base = f"http://127.0.0.1:{port}"

                async def drive():
                    from test_torch_http import wait_for_models

                    await wait_for_models(base, ["tiny-int8"], timeout=30)
                    got = []
                    async with httpx.AsyncClient(timeout=60) as client:
                        for prompt, temp, seed in REQUESTS:
                            r = await client.post(f"{base}/v1/completions", json={
                                "model": "tiny-int8", "prompt": prompt, "max_tokens": MAX_TOKENS,
                                "temperature": temp, "seed": seed, "ignore_eos": True,
                                "logprobs": 0})
                            assert r.status_code == 200, r.text
                            got.append(r.json()["choices"][0])
                    return got

                got = asyncio.run(drive())
                worker.proc.send_signal(signal.SIGTERM)
                assert worker.proc.wait(timeout=30) == 0
                tail = worker.proc.stdout.read().strip().splitlines()
                counters = next(json.loads(line) for line in reversed(tail)
                                if line.startswith('{"event": "engine_counters"'))
                # On the CPU the plain versions run: no kernel launches.
                assert counters["int8_matmul_launches"] == 0
                assert counters["generated_tokens"] == MAX_TOKENS * len(REQUESTS)
                frontend.proc.send_signal(signal.SIGTERM)
                assert frontend.proc.wait(timeout=30) == 0
        store.proc.send_signal(signal.SIGTERM)
        assert store.proc.wait(timeout=30) == 0
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    for choice, (toks, lps) in zip(got, ref):
        assert len(toks) == MAX_TOKENS
        assert choice["text"] == ByteTokenizer().decode(toks)
        np.testing.assert_allclose(choice["logprobs"]["token_logprobs"], lps, **TOL)
    assert len({tuple(t) for t, _ in ref}) == len(REQUESTS)


def test_run_serves_a_checkpoint_in_batch_mode(checkpoint, tmp_path):
    """``python -m dynamo_tpu_torch.run --model-path`` loads the checkpoint
    as stored (float32 here; the launcher has no --quant, as the JAX one)."""
    prompts = tmp_path / "p.jsonl"
    prompts.write_text('{"prompt": "int8 weights, greedy", "max_tokens": 6}\n')
    out = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.run", "--in", f"batch:{prompts}",
                          "--device", "cpu", "--model-path", checkpoint, "--tokenizer", "byte",
                          "--block-size", "4", "--num-kv-blocks", "64", "--max-model-len", "128"],
                         cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
                         env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["completion_tokens"] == 6 and line["prompt"] == "int8 weights, greedy"


def test_checkpoint_without_tokenizer_flag_serves_its_tokenizer_json(checkpoint):
    """No --tokenizer: ``worker`` and ``run`` tokenize by the checkpoint's
    tokenizer.json (prompt tokens as HFTokenizer counts them)."""
    tok = HFTokenizer(checkpoint)
    prompt = "<|begin_of_text|>The checkpoint's own tokenizer, café ✓"
    env = {**__import__("os").environ, "OMP_NUM_THREADS": "1"}
    argv = ["--device", "cpu", "--model-path", checkpoint, "--dtype", "float32",
            "--block-size", "4", "--num-kv-blocks", "64", "--max-model-len", "128"]
    prompts = Path(checkpoint).parent / "own.jsonl"
    prompts.write_text(json.dumps({"prompt": prompt, "max_tokens": 6}) + "\n")
    out = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.run", "--in",
                          f"batch:{prompts}", *argv], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["completion_tokens"] == 6

    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    penv = {"OMP_NUM_THREADS": "1", "DYNTPU_STORE_LEASE_TTL": "2"}
    with ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                         "--port", str(store_port)], name="store", env=penv) as store:
        store.wait_for(r"store server: tcp://")
        with ManagedProcess(["-m", "dynamo_tpu_torch.worker", "--store-url", store_url, *argv],
                            name="worker", env=penv) as worker:
            worker.wait_for(r"serving tiny-int8", timeout=90)
            with ManagedProcess(
                ["-m", "dynamo_tpu_torch.frontend", "--store-url", store_url,
                 "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"],
                name="frontend", env=penv,
            ) as frontend:
                port = int(frontend.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)",
                                             timeout=90).group(1))
                base = f"http://127.0.0.1:{port}"

                async def drive():
                    from test_torch_http import wait_for_models

                    await wait_for_models(base, ["tiny-int8"], timeout=30)
                    async with httpx.AsyncClient(timeout=60) as client:
                        r = await client.post(f"{base}/v1/completions", json={
                            "model": "tiny-int8", "prompt": prompt, "max_tokens": 6,
                            "temperature": 0, "seed": 1, "ignore_eos": True, "logprobs": 0})
                        assert r.status_code == 200, r.text
                        return r.json()

                body = asyncio.run(drive())
                frontend.proc.send_signal(signal.SIGTERM)
                assert frontend.proc.wait(timeout=30) == 0
            worker.proc.send_signal(signal.SIGTERM)
            assert worker.proc.wait(timeout=30) == 0
        store.proc.send_signal(signal.SIGTERM)
        assert store.proc.wait(timeout=30) == 0
    assert body["usage"]["prompt_tokens"] == len(tok.encode(prompt))
    choice = body["choices"][0]
    assert choice["text"] == "".join(choice["logprobs"]["tokens"])
    assert choice["text"] == line["text"]  # run and worker: the same greedy text


def test_checkpoint_tokenizer_streams_match_a_jax_worker(checkpoint):
    """Both workers from their CLIs' arguments, no --tokenizer on the
    port's (the JAX CLI's default "byte" means the checkpoint's own), the
    same checkpoint in float32: through either frontend, the port worker's
    responses equal the JAX worker's."""
    from dynamo_tpu.worker import __main__ as jworker
    from dynamo_tpu_torch.worker import __main__ as tworker
    from test_torch_http import (assert_close, call, chat, completion, start_frontend,
                                 start_store, start_worker, stop_frontend, stop_runtime,
                                 wait_for_models)

    argv = ["--model-path", checkpoint, "--dtype", "float32", "--block-size", "4",
            "--num-kv-blocks", "128", "--max-num-seqs", "4", "--max-model-len", "128",
            "--decode-steps", "4"]
    requests = [
        ("/v1/chat/completions", chat("Hello, checkpoint tokenizer! ✓", max_tokens=12,
                                      temperature=0, seed=1, ignore_eos=True, stream=True)),
        ("/v1/completions", completion("<|begin_of_text|>café, naïve — 12345", max_tokens=10,
                                       temperature=0.8, seed=7, ignore_eos=True, logprobs=1)),
        ("/v1/completions", completion("A seeded stream of README words", max_tokens=11,
                                       temperature=1.0, seed=1000, ignore_eos=True,
                                       stream=True)),
    ]

    async def go():
        settle = threading.Event()
        settle.set()
        store = await start_store("dynamo_tpu_torch")
        jeng, jcard = await jworker.build_engine(jworker.parse_args(
            argv + ["--model-name", "jw", "--attn-impl", "xla"]))
        teng, tcard = await tworker.build_engine(tworker.parse_args(
            argv + ["--model-name", "tw", "--device", "cpu"]))
        assert jcard.tokenizer == tcard.tokenizer == {"type": "hf", "path": checkpoint}
        assert jcard.eos_token_ids == tcard.eos_token_ids == HFTokenizer(checkpoint).eos_token_ids
        jw = await start_worker("dynamo_tpu", store.url, jeng, settle=settle, card=jcard)
        tw = await start_worker("dynamo_tpu_torch", store.url, teng, settle=settle, card=tcard)
        jfe = await start_frontend("dynamo_tpu", store.url)
        tfe = await start_frontend("dynamo_tpu_torch", store.url)
        try:
            out = []
            for fe in (jfe, tfe):
                await wait_for_models(fe.base, ["jw", "tw"])
                for path, body in requests:
                    row = [await call(fe.base, path, dict(body, model=m), bool(body.get("stream")))
                           for m in ("jw", "tw")]
                    out.append((body, row))
            return out
        finally:
            await stop_frontend(jfe)
            await stop_frontend(tfe)
            await stop_runtime(jw)
            await stop_runtime(tw)
            await jeng.stop()
            await teng.stop()
            await store.close()

    for body, ((js, _, jres), (ts, _, tres)) in asyncio.run(go()):
        assert js == ts == 200, (jres, tres)
        assert_close(json.loads(json.dumps(tres).replace('"tw"', '"jw"')), jres)
        usage = (jres[-2] if body.get("stream") else jres)["usage"]
        assert usage["completion_tokens"] == body["max_tokens"]
