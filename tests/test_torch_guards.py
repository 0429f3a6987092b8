"""Guards on the port's boundaries.

- Importing every dynamo_tpu_torch module pulls in neither jax nor any
  dynamo_tpu module, nor a package the card's machine lacks.
- The default device is the card: without CUDA the entry points raise
  instead of running on the CPU, and chip_smoke.py fails without a result.
- A CUDA tensor goes to the kernel or raises; it never falls back to the
  plain version.
- Block hashing stays the framework's: the pure-Python XXH3-64 is
  bit-exact with xxhash, and the port's block pool behaves as the JAX
  package's.
"""

from __future__ import annotations

import os
import random
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import xxhash

from dynamo_tpu import tokens as jtokens
from dynamo_tpu.block_manager.pool import BlockPool as JPool
from dynamo_tpu_torch import tokens as ttokens
from dynamo_tpu_torch.block_manager.pool import BlockPool as TPool
from dynamo_tpu_torch.block_manager.pool import NoFreeBlocksError
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import paged_attention as pa

REPO = Path(__file__).resolve().parents[1]
ABSENT_ON_CARD = ("xxhash", "msgpack", "jinja2", "aiohttp", "httpx", "tokenizers",
                  "transformers", "safetensors", "ml_dtypes", "huggingface_hub", "regex",
                  "sentencepiece", "yaml")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import dynamo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__, "dynamo_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "dynamo_tpu" or m.startswith("dynamo_tpu.")
             or m.split(".")[0] in %r or m.split(".")[0] == "triton")
print(json.dumps({"modules": names, "bad": bad}))
""" % (ABSENT_ON_CARD,)


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def test_port_imports_no_jax_and_no_reference_modules():
    import json

    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dynamo_tpu_torch.engine.engine" in res["modules"]
    assert "dynamo_tpu_torch.run.__main__" in res["modules"]
    for cli in ("worker.__main__", "frontend.__main__", "runtime.store_server",
                "llm.http_service", "runtime.http_server", "runtime.msgpack_lite", "llm.template",
                "engine.loader", "engine.safetensors_io", "engine.gguf", "engine.hub",
                "engine.quant", "ops.int8_matmul", "llm.tokenizer_json", "llm.unicode_classes",
                "engine.drafter", "engine.sampler", "engine.graphs", "engine.kv_transfer",
                "transfer", "transfer.stream", "runtime.queue", "llm.disagg",
                "engine.grammar", "llm.preprocessor", "block_manager.tiers", "llm.peer_kv",
                "worker.migrate", "worker.roles", "planner", "planner.actions",
                "planner.actuate", "engine.lora", "block_manager.adapters",
                "runtime.barrier", "runtime.trace_export", "llm.logprobs", "llm.client",
                "mocker", "mocker.engine", "mocker.__main__", "fleet", "fleet.__main__",
                "fleet.backoff", "fleet.aggregate", "fleet.decisions", "fleet.directory",
                "fleet.budget", "fleet.supervisor", "planner.predictors",
                "planner.interpolate", "planner.profile_sweep", "planner.core",
                "planner.connector", "planner.operator", "planner.balancer",
                "planner.__main__", "router.__main__", "metrics_exporter",
                "metrics_exporter.__main__", "operator.yaml_lite", "operator.graph",
                "operator.kube", "operator.controller", "operator.__main__",
                "runtime.urlfetch"):
        assert f"dynamo_tpu_torch.{cli}" in res["modules"]
    assert res["bad"] == []


def test_no_source_imports_a_missing_package():
    """Imports inside functions run only when called: scan the port's
    sources and chip_smoke.py for any import of jax, the JAX package or a
    package the card's machine lacks."""
    import re

    bad = re.compile(r"(?m)^\s*(?:import|from)\s+(%s|jax|dynamo_tpu)\b(?!_)"
                     % "|".join(ABSENT_ON_CARD))
    files = sorted((REPO / "dynamo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files
            for m in bad.finditer(f.read_text(encoding="utf-8"))]
    # The hub copy's optional downloader: an ImportError there is the
    # offline error the JAX package gives too.
    allowed = ["dynamo_tpu_torch/engine/hub.py: from huggingface_hub"]
    assert len(files) > 50 and hits == allowed


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalRunner(EngineArgs()).start()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_launcher_and_chip_smoke_fail_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    prompts = tmp_path / "p.jsonl"
    prompts.write_text('{"prompt": "hi"}\n')
    run = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run", "--in", f"batch:{prompts}",
         "--preset", "test-tiny"], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "CUDA is not available" in run.stderr
    assert run.stdout.strip() == ""
    worker = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.worker", "--store-url", "memory://guard",
         "--preset", "test-tiny"], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=120)
    assert worker.returncode != 0 and "CUDA is not available" in worker.stderr
    assert "serving" not in worker.stdout
    smoke = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=_env(),
                           capture_output=True, text=True, timeout=120)
    assert smoke.returncode != 0 and '"ok"' not in smoke.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    smoke = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=120)
    assert smoke.returncode != 0 and '"ok"' not in smoke.stdout


def test_cuda_tensors_never_fall_back(monkeypatch):
    """Fake CUDA tensors reach the kernel path; with the kernel library
    absent the wrapper raises, and the plain version is never called."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def absent(name):
        raise RuntimeError("kernel library absent")

    plain_calls = []
    monkeypatch.setattr(_build, "library", absent)
    monkeypatch.setattr(pa, "paged_spec_attention_ref", lambda *a, **k: plain_calls.append(a))
    before = pa.launches
    with FakeTensorMode():
        q = torch.empty((2, 1, 2, 2, 64), device="cuda")
        kc = torch.empty((1, 8, 4, 128), device="cuda")
        tables = torch.zeros((2, 3), dtype=torch.int32, device="cuda")
        lengths = torch.ones((2, 1), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="kernel library absent"):
            pa.paged_spec_attention(q, kc, kc, 0, tables, lengths)
        q_dec = torch.empty((2, 2, 2, 64), device="cuda")
        len_dec = torch.ones((2,), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="kernel library absent"):
            pa.paged_decode_attention(q_dec, kc, kc, 0, tables, len_dec)
        with pytest.raises(ValueError):  # wrong table dtype is refused before any launch
            pa.paged_spec_attention(q, kc, kc, 0, tables.long(), lengths)
    assert plain_calls == [] and pa.launches == before


@pytest.mark.parametrize("T,tree", [(4, False), (7, True), (64, True)])
def test_spec_cuda_tensors_never_fall_back(monkeypatch, T, tree):
    """The verify shapes (linear and tree, up to MAX_T slots, with KVH·T·G
    well past the 128 lanes at which the JAX package leaves its Pallas
    kernel for the XLA gather) reach the kernel path for CUDA tensors and
    never the plain version; a row of more than MAX_T slots is refused."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def absent(name):
        raise RuntimeError("kernel library absent")

    plain_calls = []
    monkeypatch.setattr(_build, "library", absent)
    monkeypatch.setattr(pa, "paged_spec_attention_ref", lambda *a, **k: plain_calls.append(a))
    before = pa.launches
    with FakeTensorMode():
        B, KVH, G, hd = 8, 8, 4, 128
        kc = torch.empty((2, 16, 16, KVH * hd), dtype=torch.bfloat16, device="cuda")
        tables = torch.zeros((B, 4), dtype=torch.int32, device="cuda")
        for t in (T, pa.MAX_T + 1):
            q = torch.empty((B, t, KVH, G, hd), dtype=torch.bfloat16, device="cuda")
            lengths = torch.ones((B, t), dtype=torch.int32, device="cuda")
            anc = torch.ones((B, t, t), dtype=torch.int8, device="cuda") if tree else None
            if t > pa.MAX_T:
                with pytest.raises(ValueError, match="at most"):
                    pa.paged_spec_attention(q, kc, kc, 1, tables, lengths, anc=anc)
            else:
                assert KVH * t * G > 128 or not tree
                with pytest.raises(RuntimeError, match="kernel library absent"):
                    pa.paged_spec_attention(q, kc, kc, 1, tables, lengths, anc=anc)
    assert plain_calls == [] and pa.launches == before


def test_int8_cuda_tensors_never_fall_back(monkeypatch):
    """Fake CUDA tensors reach the int8 kernel (decode rows) or the prefill
    route (more rows); with the kernel library absent the kernel route
    raises, and the plain version is never called."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from dynamo_tpu_torch.ops import int8_matmul as im

    def absent(name):
        raise RuntimeError("kernel library absent")

    plain_calls = []
    monkeypatch.setattr(_build, "library", absent)
    monkeypatch.setattr(im, "int8_matmul_ref", lambda *a, **k: plain_calls.append(a))
    before = (im.launches, im.prefill_launches)
    with FakeTensorMode():
        w = torch.empty((256, 128), dtype=torch.int8, device="cuda")
        s = torch.empty((128,), device="cuda")
        with pytest.raises(RuntimeError, match="kernel library absent"):
            im.int8_matmul(torch.empty((8, 256), device="cuda"), w, s)
        assert im.int8_matmul(torch.empty((65, 256), device="cuda"), w, s).shape == (65, 128)
        with pytest.raises(ValueError):  # a float w is refused before any launch
            im.int8_matmul(torch.empty((8, 256), device="cuda"), w.float(), s)
    assert plain_calls == []
    assert (im.launches, im.prefill_launches) == (before[0], before[1] + 1)


def test_build_reports_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "CUDA_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


@pytest.mark.parametrize("seed", [0, ttokens.HASH_SEED, (1 << 64) - 12345])
def test_xxh3_bit_exact(seed):
    rng = random.Random(seed)
    data = bytes(rng.getrandbits(8) for _ in range(1024))
    for n in range(0, 1025):
        assert ttokens.xxh3_64(data[:n], seed) == xxhash.xxh3_64_intdigest(data[:n], seed=seed), n


def test_block_hashes_match_reference():
    rng = random.Random(5)
    toks = [rng.randrange(0, 130_000) for _ in range(203)]
    for bs in (1, 4, 16, 64):
        assert ttokens.compute_block_hashes(toks, bs) == jtokens.compute_block_hashes(toks, bs)
    a, b = ttokens.TokenBlockSequence(toks, 16), jtokens.TokenBlockSequence(toks, 16)
    assert [x.sequence_hash for x in a.blocks] == b.sequence_hashes()
    assert [x.parent_sequence_hash for x in a.blocks] == [x.parent_sequence_hash for x in b.blocks]


def test_block_pool_matches_reference():
    """The same allocation / registration / free sequence on both pools
    gives the same block ids, hits and KV events."""
    events = {"t": [], "j": []}
    t = TPool(12, 4, event_sink=lambda e: events["t"].append(e.to_dict()))
    j = JPool(12, 4, event_sink=lambda e: events["j"].append(e.to_dict()))
    hashes = jtokens.compute_block_hashes(list(range(40)), 4)
    for pool in (t, j):
        ids, hit = pool.allocate_sequence(hashes[:3], 4)
        for k, h in enumerate(hashes[:3]):
            pool.register_block(ids[k], h, hashes[k - 1] if k else None)
        pool.free_sequence(ids)
        again, hit2 = pool.allocate_sequence(hashes[:3], 5)
        pool.free_sequence(again)
        pool.allocate_sequence([], 11)  # evicts every cached block
        with pytest.raises(Exception):
            pool.allocate_block()
        pool.results = (ids, hit, again, hit2)
    assert t.results == j.results and t.results[3] == 3
    assert events["t"] == events["j"]
    assert issubclass(NoFreeBlocksError, Exception)
