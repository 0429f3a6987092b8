"""Tier files moved between the two packages, on the CPU.

G3 and G4 files are keyed by the same salted hash chain in both packages
(the port's ``tokens.py`` is a bit-exact XXH3-64), and the port's npz codec
writes what the JAX package's writes. So:

- the same page tuples (float32; bf16, as uint16 bit patterns in the port
  and ``ml_dtypes.bfloat16`` in JAX; int8 with f32 scales), written by each
  package's ``_write_npz``, give archives with equal members, and each
  package reads the other's;
- a G3 directory filled by a ``TpuEngine`` is opened by a fresh
  ``TorchEngine``, which onboards every full prompt block with no G1 hit;
  its greedy tokens equal a fresh ``TpuEngine``'s onboarded run on the same
  directory (hit against hit), and the reverse;
- a G4 directory shared by a ``TpuEngine`` and a ``TorchEngine``: the
  second engine's puts of the same blocks count as dedup, its admission
  onboards the first engine's files, and its tokens equal the first
  engine's prefix-hit run; pools of both packages dedup against each other,
  sweep the shared directory by age, and bridge int8 and float blocks in
  one run alike.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.block_manager import tiers as jtiers
from dynamo_tpu.engine import kv_transfer as jkv
from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.block_manager import tiers as ttiers
from dynamo_tpu_torch.engine import kv_transfer as tkv
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=64,
            max_prefill_tokens=32, dtype="float32", decode_steps=2, pipeline_depth=0,
            pipeline_windows=False)


def pages(kind: str, seed: int = 0) -> tuple[tuple, tuple]:
    """One block's page tuple in the kind's host format → (port's, JAX's)."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((2, 1, 4, 16)).astype(np.float32) for _ in range(2))
    if kind == "float32":
        return (k, v), (k, v)
    if kind == "bfloat16":
        tk, tv = tkv.f32_to_bf16_bits(k), tkv.f32_to_bf16_bits(v)
        return (tk, tv), (tk.view(ml_dtypes.bfloat16), tv.view(ml_dtypes.bfloat16))
    q = tkv.quantize_pages_np(k, v, 2)
    return q, q


def members(path) -> dict:
    with np.load(path) as z:
        return {n: (z[n].dtype.str, z[n].shape, z[n].tobytes()) for n in z.files}


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_npz_files_are_the_same_in_both_packages(tmp_path, kind):
    tp, jp = pages(kind)
    ttiers._write_npz(str(tmp_path / "port.npz"), tp)
    jtiers._write_npz(str(tmp_path / "jax.npz"), jp)
    assert members(tmp_path / "port.npz") == members(tmp_path / "jax.npz")
    from_jax = ttiers._read_npz(str(tmp_path / "jax.npz"))
    from_port = jtiers._read_npz(str(tmp_path / "port.npz"))
    assert len(from_jax) == len(from_port) == len(tp)
    for a, b in zip(from_jax, tp):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(from_port, jp):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- engines on one directory ------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


PROMPTS = [np.random.default_rng(s).integers(1, 500, size=n).tolist()
           for s, n in ((10, 25), (11, 18), (12, 31))]


def request(prompt, max_tokens=6) -> dict:
    return {"model": "test-tiny", "token_ids": list(prompt),
            "sampling": {"temperature": 0.0, "seed": 0},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


def make(pkg: str, np_params, **kw):
    if pkg == "jax":
        return TpuEngine(JArgs(model=JCfg(), attn_impl="xla", **{**ARGS, **kw}), params=np_params)
    return TorchEngine(EngineArgs(model=ModelConfig(), device="cpu", **{**ARGS, **kw}),
                       params=params_from_numpy(np_params, "cpu", torch.float32))


async def serve(eng, reqs) -> dict:
    """One request at a time on a started engine → tokens per request,
    prompt tokens prefilled, tier stats."""
    await eng.start()
    try:
        toks = []
        for r in reqs:
            ctx = JContext() if isinstance(eng, TpuEngine) else Context()
            out = []
            async for item in eng.generate(r, ctx):
                out.extend(item.get("token_ids") or [])
            toks.append(out)
        return {"tokens": toks, "prefilled": eng.total_prefilled, "stats": eng.tiers.stats()}
    finally:
        await eng.stop()


def full_blocks(prompts) -> int:
    return sum((len(p) - 1) // 4 for p in prompts)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_g3_directory_written_by_one_package_onboards_in_the_other(
        tmp_path, np_params, writer, reader, kv_quant):
    """G3 only (no G2): every sealed block goes straight to disk. The
    writer fills the directory; a fresh engine of each package then
    serves the same prompts from a copy of it, onboarding every full
    prompt block (no G1 hit exists in a fresh engine)."""
    src = tmp_path / "written"
    reqs = [request(p) for p in PROMPTS]
    written = asyncio.run(serve(make(writer, np_params, disk_kv_dir=str(src),
                                     kv_quant=kv_quant), reqs))
    assert written["stats"]["g3_blocks"] >= full_blocks(PROMPTS)
    runs = {}
    for pkg in (reader, writer):
        d = tmp_path / f"copy_{pkg}"
        shutil.copytree(src, d)
        runs[pkg] = asyncio.run(serve(make(pkg, np_params, disk_kv_dir=str(d),
                                           kv_quant=kv_quant), reqs))
    got, ref = runs[reader], runs[writer]
    assert got["tokens"] == ref["tokens"]
    assert got["stats"]["onboarded_blocks"] == ref["stats"]["onboarded_blocks"] == \
        full_blocks(PROMPTS)
    assert got["prefilled"] == ref["prefilled"] == sum(len(p) - (len(p) - 1) // 4 * 4
                                                       for p in PROMPTS)
    assert got["stats"] == ref["stats"]


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_g4_shared_between_packages_dedups_and_onboards(tmp_path, np_params, first, second):
    """G4 only: both engines' sealed blocks go straight to the shared
    directory. The second engine's admission onboards the first one's
    files; its own puts of the same blocks are dedups, not rewrites."""
    fleet = str(tmp_path / "g4")
    reqs = [request(p) for p in PROMPTS]
    a = asyncio.run(serve(make(first, np_params, fleet_kv_dir=fleet), reqs + reqs))
    files = {f: os.path.getmtime(os.path.join(fleet, f)) for f in os.listdir(fleet)}
    b = asyncio.run(serve(make(second, np_params, fleet_kv_dir=fleet), reqs))
    # Hit against hit: the second engine's onboarded run equals the first
    # engine's G1 prefix-hit run of the same requests.
    assert b["tokens"] == a["tokens"][len(reqs):]
    sb = b["stats"]
    assert sb["g4_hits"] == sb["onboarded_blocks"] == full_blocks(PROMPTS)
    assert sb["g4_dedup_blocks"] >= full_blocks(PROMPTS)
    for f, mtime in files.items():  # no file of the first engine was rewritten
        assert os.path.getmtime(os.path.join(fleet, f)) == mtime


def _page(seed, heads=2, hd=4):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, 1, 4, heads * hd)).astype(np.float32) for _ in range(2))


def test_g4_pools_of_both_packages_dedup_and_sweep(tmp_path):
    """tests/test_fleet_kv_economy.py's dedup and sweep case, one pool of
    each package on the shared directory."""
    shared = str(tmp_path / "g4")
    a = jtiers.FleetBlockPool(shared, capacity_blocks=8)
    b = ttiers.FleetBlockPool(shared, capacity_blocks=8)
    events = []
    b.event_sink = lambda kind, tier, hashes: events.append((kind, tier, list(hashes)))
    k, v = _page(0)
    a.put(101, k, v)
    b.put(101, *_page(0))
    assert b.dedup_blocks == 1 and a.dedup_blocks == 0 and events == []
    got = b.get(101)
    assert got is not None and np.array_equal(got[0], k) and b.hits == 1
    b.put(102, *_page(1))
    assert ("stored", 4, [102]) in events and a.get(102) is not None

    small = ttiers.FleetBlockPool(str(tmp_path / "small"), capacity_blocks=2)
    now = time.time()
    for i, h in enumerate((1, 2, 3)):
        small.put(h, *_page(h))
        os.utime(small._path(h), (now + i, now + i))
    small._sweep()
    assert small.evictions >= 1 and small.get(1) is None and small.get(3) is not None


def test_g4_mixed_int8_float_run_bridges_alike(tmp_path):
    """One shared run of a dense block (written by the JAX pool) and an
    int8 block (written by the port's pool): each package's
    concat_page_run bridges it to either format with the same bytes."""
    jpool = jtiers.FleetBlockPool(str(tmp_path / "g4"), capacity_blocks=8)
    tpool = ttiers.FleetBlockPool(str(tmp_path / "g4"), capacity_blocks=8)
    jpool.put(201, *_page(1))
    tpool.put(202, *tkv.quantize_pages_np(*_page(2), 2))
    trun, jrun = [tpool.get(201), tpool.get(202)], [jpool.get(201), jpool.get(202)]
    assert [len(p) for p in trun] == [len(p) for p in jrun] == [2, 4]
    for quantized in (False, True):
        t = tkv.concat_page_run(trun, quantized=quantized, num_kv_heads=2, dtype="float32")
        j = jkv.concat_page_run(jrun, quantized=quantized, num_kv_heads=2, dtype="float32")
        assert len(t) == len(j) == (4 if quantized else 2)
        for x, y in zip(t, j):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    blocks = tkv.split_page_run(tkv.concat_page_run(trun, quantized=False, num_kv_heads=2,
                                                    dtype="float32"), 2)
    assert len(blocks) == 2 and np.array_equal(blocks[0][0], _page(1)[0])
