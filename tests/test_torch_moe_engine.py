"""``TorchEngine`` against ``TpuEngine`` on ``moe-tiny`` (4 experts, top
2), float32, on the CPU: the same numpy weights (the JAX package's
init, carried across with ``params_from_numpy``) and the same seeded
requests, every one submitted before its engine's scheduler starts.
Tokens equal, logprobs and top-logprob values within ``TOL`` (1e-4, the
forward's float32 tolerance; ``TOL_INT8`` after int8 KV pages).

- a mixed burst: greedy rows with logprobs and ranked alternatives,
  seeded rows at temperature 0.7, full-sampler rows (top-k, top-p, both
  penalties), a prefill-only row and one LoRA adapter row beside base
  rows, through the port at pipeline depths 0, 1 and 2 against one JAX
  run (streams do not depend on the depth);
- ``engine.embed`` on the same engines;
- ``--spec-tokens 3``: n-gram drafts verified in fused linear passes and
  width-2 draft trees, unpipelined, streams and spec counters;
- int8 KV pages;
- the ``run`` entry point's batch output, in process on the shared
  weights against the JAX launcher's, and as a subprocess on
  ``--preset moe-tiny``'s own random weights;
- a spawned worker on ``--preset moe-tiny --kv-quant int8 --spec-tokens
  3`` behind the port's frontend.

One JAX engine run per configuration, shared through module fixtures.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context

REPO = Path(__file__).resolve().parents[1]
PRESET = "moe-tiny"
BASE = dict(block_size=4, num_kv_blocks=256, max_num_seqs=8, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4)
LORA = dict(lora_slots=2, lora_rank=4)
ADAPTER = ("tenant-a", 4, 7)  # (name, rank, seed)
TOL = dict(atol=1e-4, rtol=1e-4)
TOL_INT8 = dict(atol=2e-3, rtol=2e-3)
# Unpipelined: at depth > 0 the drafts, and so a sampled row's acceptance
# draws, depend on which windows the host has drained when it drafts.
UNPIPELINED = dict(pipeline_depth=0, pipeline_windows=False)
SPEC = {"linear": dict(spec_tokens=3, spec_gate=0.0, spec_ngram=1, **UNPIPELINED),
        "tree": dict(spec_tokens=3, spec_gate=0.0, spec_ngram=1, spec_tree_width=2,
                     spec_tree_depth=3, **UNPIPELINED)}
SPEC_STATS = ("rows", "proposed", "accepted", "emitted", "tree_passes")
LOOPY = ([1, 2, 3] * 6, [7, 8, 9, 4] * 4, [5, 6] * 8)
EMBED_IDS = ([1, 2, 3], [(7 * i) % 500 + 1 for i in range(40)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg.preset(PRESET), jax.random.PRNGKey(0),
                                                   jnp.float32))


def port_engine(np_params, **kw) -> TorchEngine:
    return TorchEngine(EngineArgs(model=ModelConfig.preset(PRESET), device="cpu",
                                  **{**BASE, **kw}),
                       params=params_from_numpy(np_params, "cpu", torch.float32))


def jax_engine(np_params, **kw) -> TpuEngine:
    return TpuEngine(JArgs(model=JCfg.preset(PRESET), attn_impl="xla", **{**BASE, **kw}),
                     params=np_params)


def request(prompt, max_tokens, temperature=0.0, seed=0, top_logprobs=0, adapter=None,
            **sampling) -> dict:
    return {"model": PRESET, "token_ids": list(prompt), "adapter_id": adapter,
            "sampling": {"temperature": temperature, "seed": seed, "logprobs": True,
                         "top_logprobs": top_logprobs, **sampling},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


def mixed() -> list[dict]:
    return [
        request([3, 1, 4, 1, 5], 13, top_logprobs=3),                   # greedy
        request(list(range(10, 47)), 11),                               # 37-token prompt
        request([9, 2, 6], 12, temperature=0.7, seed=11),               # sampled
        request([2, 7, 1, 8], 12, temperature=0.7, seed=12),
        request([4, 4, 2], 10, temperature=0.9, seed=5, top_k=5, top_p=0.8,
                frequency_penalty=0.5, presence_penalty=0.25),          # full sampler
        request([6, 6, 1, 3], 10, seed=6, frequency_penalty=1.0),
        request([5, 5, 5], 1),                                          # prefill only
        request([8, 3, 8, 3, 9], 12, adapter=ADAPTER[0]),               # adapter row
    ]


def spec_workload() -> list[dict]:
    return [request(LOOPY[0], 24), request(LOOPY[1], 17, top_logprobs=2),
            request(LOOPY[2], 21, temperature=0.7, seed=3), request(list(range(40, 70)), 9)]


async def _stream(eng, req):
    toks, lps, tops, finish = [], [], [], None
    async for item in eng.generate(req, JContext() if isinstance(eng, TpuEngine) else Context()):
        toks.extend(item.get("token_ids") or [])
        lps.extend(item.get("log_probs") or [])
        tops.extend(item.get("top_log_probs") or [])
        finish = item.get("finish_reason") or finish
    return toks, lps, tops, finish


async def _serve(eng, reqs, adapter=False, embed=False):
    """Register the adapter (``adapter``), submit every request, then start
    the engine and collect the streams (and embeddings of ``EMBED_IDS``
    after them with ``embed``) → (streams, spec counters, embeddings)."""
    if adapter:
        name, rank, seed = ADAPTER
        eng.register_adapter(name, rank=rank, seed=seed)
    tasks = [asyncio.ensure_future(_stream(eng, r)) for r in reqs]
    await asyncio.sleep(0)
    await eng.start()
    try:
        streams = await asyncio.gather(*tasks)
        vecs = [np.asarray(await eng.embed(ids)) for ids in EMBED_IDS] if embed else []
    finally:
        await eng.stop()
    return streams, {k: getattr(eng, f"total_spec_{k}") for k in SPEC_STATS}, vecs


def serve(eng, reqs, **kw):
    return asyncio.run(_serve(eng, reqs, **kw))


def assert_streams_close(port, ref, tol=TOL):
    assert len(port) == len(ref)
    for (pt, pl, ptop, pf), (jt, jl, jtop, jf) in zip(port, ref):
        assert pt == jt and pf == jf
        np.testing.assert_allclose(pl, jl, **tol)
        assert [[a for a, _ in alts] for alts in ptop] == [[a for a, _ in alts] for alts in jtop]
        np.testing.assert_allclose([[v for _, v in alts] for alts in ptop] or [[]],
                                   [[v for _, v in alts] for alts in jtop] or [[]], **tol)


@pytest.fixture(scope="module")
def jax_mixed(np_params):
    return serve(jax_engine(np_params, **LORA), mixed(), adapter=True, embed=True)


@pytest.fixture(scope="module")
def port_mixed(np_params):
    """The port's mixed burst at a pipeline depth, served once per depth."""
    runs = {}

    def at(depth):
        if depth not in runs:
            runs[depth] = serve(port_engine(np_params, pipeline_depth=depth,
                                            pipeline_windows=depth > 0, **LORA),
                                mixed(), adapter=True, embed=depth == 0)
        return runs[depth]

    return at


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_mixed_burst_matches_tpu_engine(port_mixed, jax_mixed, depth):
    port, _, vecs = port_mixed(depth)
    ref, _, ref_vecs = jax_mixed
    assert_streams_close(port, ref)
    assert [len(s[0]) for s in port] == [r["stop"]["max_tokens"] for r in mixed()]
    assert all(s[3] == "length" for s in port)
    # the seeds and the adapter really steer the streams
    assert port[2][0] != port[3][0] and port[7][0] != port[0][0]
    for got, want in zip(vecs, ref_vecs):
        assert got.shape == (ModelConfig.preset(PRESET).hidden_size,)
        np.testing.assert_allclose(got, want, **TOL)


def test_adapter_row_leaves_base_rows_alone(np_params, port_mixed):
    """The base rows of the port's mixed burst are the streams of a port
    engine with no adapter bank at all, byte for byte."""
    base = [r for r in mixed() if r["adapter_id"] is None]
    alone, _, _ = serve(port_engine(np_params), base)
    assert alone == [s for s, r in zip(port_mixed(0)[0], mixed()) if r["adapter_id"] is None]


@pytest.mark.parametrize("kind", ["linear", "tree"])
def test_spec_streams_match_tpu_engine(np_params, kind):
    """``--spec-tokens 3`` on moe-tiny, unpipelined: the JAX engine's
    streams and spec counters, and the port's own dense streams."""
    port, ps, _ = serve(port_engine(np_params, **SPEC[kind]), spec_workload())
    ref, js, _ = serve(jax_engine(np_params, **SPEC[kind]), spec_workload())
    dense, _, _ = serve(port_engine(np_params, **UNPIPELINED), spec_workload())
    greedy = [i for i, r in enumerate(spec_workload()) if r["sampling"]["temperature"] == 0.0]
    assert_streams_close(port, ref)
    # a sampled row's tokens come from the acceptance draws, not the dense noise
    assert_streams_close([port[i] for i in greedy], [dense[i] for i in greedy])
    assert ps == js and ps["rows"] > 0 and ps["accepted"] > 0
    assert (ps["tree_passes"] > 0) == (kind == "tree")


def test_int8_kv_pages_match_tpu_engine(np_params):
    reqs = [r for r in mixed() if r["adapter_id"] is None]
    kw = dict(kv_quant="int8", pipeline_depth=2, pipeline_windows=True)
    port, _, _ = serve(port_engine(np_params, **kw), reqs)
    ref, _, _ = serve(jax_engine(np_params, **kw), reqs)
    assert_streams_close(port, ref, TOL_INT8)


def test_run_batch_matches_jax_launcher(np_params, tmp_path, capsys):
    """``run --in batch:`` in process on both packages' launchers with the
    same weights and a byte tokenizer: the same JSON lines."""
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
    from dynamo_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
    from dynamo_tpu.run.__main__ import LocalPipeline as JPipeline
    from dynamo_tpu.run.__main__ import parse_args as jparse
    from dynamo_tpu.run.__main__ import run_batch as jrun_batch
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.run.__main__ import LocalPipeline, parse_args, run_batch

    path = tmp_path / "prompts.jsonl"
    path.write_text('{"prompt": "mixture of experts", "seed": 0}\n'
                    '{"prompt": "sampled", "temperature": 0.7, "seed": 3, "max_tokens": 6}\n'
                    '{"prompt": "' + "the quick brown fox " * 3 + '", "seed": 1}\n')
    argv = ["--in", f"batch:{path}", "--preset", PRESET, "--max-tokens", "10"]
    shape = dict(block_size=16, num_kv_blocks=64, max_num_seqs=4, max_model_len=256,
                 dtype="float32")

    async def go(which):
        if which == "port":
            eng = await TorchEngine(EngineArgs(model=ModelConfig.preset(PRESET), device="cpu",
                                               **shape),
                                    params=params_from_numpy(np_params, "cpu",
                                                             torch.float32)).start()
            pipe = LocalPipeline(TCard(name=PRESET, context_length=256,
                                       eos_token_ids=[ByteTokenizer.EOS]), eng, ByteTokenizer())
            args, batch = parse_args([*argv, "--device", "cpu"]), run_batch
        else:
            eng = await TpuEngine(JArgs(model=JCfg.preset(PRESET), attn_impl="xla", **shape),
                                  params=np_params).start()
            pipe = JPipeline(JCard(name=PRESET, context_length=256,
                                   eos_token_ids=[JByteTokenizer.EOS]), eng, JByteTokenizer())
            args, batch = jparse(argv), jrun_batch
        try:
            await batch(args, pipe, str(path))
        finally:
            await eng.stop()
        return [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]

    port, ref = asyncio.run(go("port")), asyncio.run(go("jax"))
    assert port == ref
    assert [ln["completion_tokens"] for ln in port] == [10, 6, 10]


def test_run_entry_point_serves_the_preset(tmp_path):
    """``python -m dynamo_tpu_torch.run --preset moe-tiny`` (its own random
    weights from ``--seed``) speculating: one JSON line per prompt."""
    prompts = tmp_path / "prompts.jsonl"
    prompts.write_text('{"prompt": "abcabcabcabc", "seed": 0}\n'
                       '{"prompt": "sampled", "temperature": 0.7, "seed": 3, "max_tokens": 5}\n')
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run", "--device", "cpu", "--in",
         f"batch:{prompts}", "--preset", PRESET, "--dtype", "float32", "--max-tokens", "12",
         "--spec-tokens", "3"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    assert [ln["completion_tokens"] for ln in lines] == [12, 5]
    assert all(ln["finish_reason"] == "length" for ln in lines)
    assert "batch done (2 prompts)" in out.stderr


@pytest.mark.e2e
def test_worker_serves_the_preset_speculating_on_int8_pages():
    """``python -m dynamo_tpu_torch.worker --preset moe-tiny --kv-quant int8
    --spec-tokens 3`` behind the port's frontend: completions of the
    requested length, verify passes on the worker's counters, every
    process exiting 0 on SIGTERM."""
    import signal
    import socket

    import httpx

    from procutil import ManagedProcess
    from test_torch_http import wait_for_models

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    store_port = free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    env = {"OMP_NUM_THREADS": "1", "DYNTPU_STORE_LEASE_TTL": "2"}
    with ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                         "--port", str(store_port)], name="store", env=env) as store:
        store.wait_for(r"store server: tcp://")
        with ManagedProcess(
                ["-m", "dynamo_tpu_torch.worker", "--store-url", store_url, "--device", "cpu",
                 "--preset", PRESET, "--dtype", "float32", "--block-size", "4",
                 "--num-kv-blocks", "128", "--max-num-seqs", "4", "--max-model-len", "128",
                 "--decode-steps", "4", "--pipeline-depth", "0", "--kv-quant", "int8",
                 "--spec-tokens", "3"], name="worker", env=env) as worker:
            worker.wait_for(rf"serving {PRESET} ", timeout=120)
            with ManagedProcess(
                    ["-m", "dynamo_tpu_torch.frontend", "--store-url", store_url, "--host",
                     "127.0.0.1", "--port", "0", "--router-mode", "kv"],
                    name="frontend", env=env) as frontend:
                port = int(frontend.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)",
                                             timeout=90).group(1))
                base = f"http://127.0.0.1:{port}"

                async def drive():
                    await wait_for_models(base, [PRESET], timeout=60)
                    async with httpx.AsyncClient(timeout=60) as client:
                        for prompt, n in (("abcabcabcabcabcabc", 24), ("mixture", 9)):
                            r = await client.post(f"{base}/v1/completions", json={
                                "model": PRESET, "prompt": prompt, "max_tokens": n,
                                "temperature": 0.0, "seed": 1, "ignore_eos": True})
                            assert r.status_code == 200, r.text
                            assert r.json()["usage"]["completion_tokens"] == n

                asyncio.run(drive())
                worker.proc.send_signal(signal.SIGTERM)
                assert worker.proc.wait(timeout=30) == 0
                tail = worker.proc.stdout.read().strip().splitlines()
                counters = next(json.loads(line) for line in reversed(tail)
                                if line.startswith('{"event": "engine_counters"'))
                assert counters["spec_passes"] > 0
                frontend.proc.send_signal(signal.SIGTERM)
                assert frontend.proc.wait(timeout=30) == 0
        store.proc.send_signal(signal.SIGTERM)
        assert store.proc.wait(timeout=30) == 0
