"""The engine side of live migration, held against the JAX engine (CPU).

The same script runs on a ``TorchEngine`` and on a ``TpuEngine`` with the
same weights (JAX ``init_params`` exported to numpy, test-tiny in float32)
and seeded requests:

- the protocol's error dicts on unknown and repeated calls;
- begin → status → cutover → finish on a running decode beside a short
  request that ends mid-window (a zombie row at depth 2), at pipeline
  depths 0, 1 and 2: after the cutover ``kv_written == len(tokens) - 1``,
  the stream's published blocks are ``kv_written // block_size`` and
  their pages equal the cache's, the resume identity carries exactly the
  tokens the client saw, and the client stream ends with the
  ``{"migration": marker}`` frame;
- a frozen cutover whose coordinator never returns: on an idle engine the
  freeze deadline unfreezes it and the stream completes as if unmigrated;
- stopping an engine that holds a frozen row posts its terminal frame;
- ``kv_pressure_offer``: the offer hook fires for the cheapest running
  sequence, as many times, as on the JAX engine.
"""

from __future__ import annotations

import asyncio
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine.weights import params_from_numpy

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            max_prefill_tokens=64, dtype="float32", decode_steps=4)
PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
BS = ARGS["block_size"]


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mods(pkg: str) -> SimpleNamespace:
    eng = importlib.import_module(f"{pkg}.engine.engine")
    return SimpleNamespace(pkg=pkg, config=importlib.import_module(f"{pkg}.engine.config"),
                           Engine=getattr(eng, "TorchEngine", None) or eng.TpuEngine,
                           Context=importlib.import_module(f"{pkg}.runtime.engine").Context)


def make_engine(M, params, **kw):
    cfg = M.config
    if M.pkg == "dynamo_tpu":
        return M.Engine(cfg.EngineArgs(model=cfg.ModelConfig(), attn_impl="xla",
                                       **{**ARGS, **kw}), params=params)
    return M.Engine(cfg.EngineArgs(model=cfg.ModelConfig(), device="cpu", **{**ARGS, **kw}),
                    params=params_from_numpy(params, "cpu", torch.float32))


def request(prompt, max_tokens, temperature=0.0, seed=0) -> dict:
    return {"model": "t", "token_ids": list(prompt),
            "sampling": {"temperature": temperature, "seed": seed},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


def prompt_of(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(1, JCfg().vocab_size - 1, size=n).tolist()


def both(fn):
    return {pkg: asyncio.run(fn(mods(pkg))) for pkg in PKGS}


class Stream:
    """One request's items, collected by a task."""

    def __init__(self, e, M, req, rid):
        self.items: list[dict] = []
        self.task = asyncio.get_running_loop().create_task(self._run(e, M, req, rid))

    async def _run(self, e, M, req, rid):
        async for item in e.generate(dict(req), M.Context(rid)):
            self.items.append(item)

    @property
    def tokens(self) -> list[int]:
        return [t for it in self.items for t in it.get("token_ids") or []]

    async def until(self, n: int) -> None:
        for _ in range(20000):
            if len(self.tokens) >= n or self.task.done():
                return
            await asyncio.sleep(0.0005)


async def solo(e, M, req) -> list[int]:
    """The unmigrated stream; the engine's cache is empty again after it (a
    client can see its finish frame before the scheduler frees the
    blocks, which would then stay cached)."""
    s = Stream(e, M, req, None)
    await s.task
    while e.pool.num_active:
        await asyncio.sleep(0.001)
    e.clear_kv_blocks()
    return s.tokens


def concat_chunks(stream) -> tuple:
    chunks = [c for _, c in stream.chunks_since(0, 1 << 40)]
    return tuple(np.concatenate([np.asarray(c.pages[i]) for c in chunks], axis=1)
                 for i in range(len(chunks[0].pages)))


def test_error_dicts_equal(params):
    async def go(M):
        e = await make_engine(M, params).start()
        out = await e.run_on_engine_thread(lambda: [
            e.migration_begin("nope"), e.migration_status("nope"),
            e.migration_cutover("nope"), e.migration_finish("nope", {}),
            e.migration_abort("nope", "x"), e.list_running()])
        await e.stop()
        return out

    res = both(go)
    assert res["dynamo_tpu_torch"] == res["dynamo_tpu"]
    assert res["dynamo_tpu_torch"][:5] == [
        {"error": "not_running"}, {"error": "no_migration"}, {"error": "no_migration"},
        {"error": "not_frozen"}, {"error": "no_migration"}]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_cutover_identity_and_pages_at_depth(params, depth):
    long_req = request(prompt_of(21, 22), 40)
    short_req = request(prompt_of(22, 9), 6, temperature=0.7, seed=5)

    async def go(M):
        e = await make_engine(M, params, pipeline_depth=depth,
                              pipeline_windows=depth > 0).start()
        ref = await solo(e, M, long_req)
        a = Stream(e, M, long_req, "mig-a")
        b = Stream(e, M, short_req, "mig-b")
        await a.until(10)

        def script():
            begin = e.migration_begin("mig-a")
            again = e.migration_begin("mig-a")
            status = e.migration_status("mig-a")
            cut = e.migration_cutover("mig-a")
            seq = e._migrations["mig-a"].seq
            written = (seq.kv_written, len(seq.tokens))
            held = e._runner.extract_pages(seq.block_ids[: cut["kv_blocks"]])
            sent = concat_chunks(e.get_stream_export(cut["handle"]))
            pages_equal = (len(held) == len(sent)
                           and all(np.array_equal(np.asarray(x), y) for x, y in zip(held, sent)))
            other = e.migration_finish("mig-b", {})
            fin = e.migration_finish("mig-a", {"handle": cut["handle"], "dest_instance": 7})
            return begin, again, status, cut, written, pages_equal, other, fin

        begin, again, status, cut, written, pages_equal, other, fin = \
            await e.run_on_engine_thread(script)
        await asyncio.wait_for(asyncio.gather(a.task, b.task), 60)
        await e.stop()
        return {"ref": ref, "a": a.items, "b_len": len(b.tokens), "begin": begin,
                "again": again, "status": status, "cut": cut, "written": written,
                "pages_equal": pages_equal, "other": other, "fin": fin}

    res = both(go)
    for pkg, r in res.items():
        cut, (kv_written, ntok) = r["cut"], r["written"]
        assert cut["ok"] and kv_written == ntok - 1, pkg
        assert cut["kv_blocks"] == kv_written // BS and r["pages_equal"], pkg
        emitted = cut["emitted"]
        seen = [t for it in r["a"] for t in it.get("token_ids") or []]
        assert seen == r["ref"][:emitted], pkg  # the client saw exactly the identity's tokens
        assert cut["request"]["token_ids"] == long_req["token_ids"] + r["ref"][:emitted]
        assert cut["request"]["resume"] == {
            "prompt_len": 22, "sample_seed": 0, "sample_step": emitted, "spec_ema": 1.0,
            "grammar_state": 0, "next_write_pos": kv_written, "traceparent": None}
        assert r["a"][-1] == {"token_ids": [], "migration": {"handle": cut["handle"],
                                                              "dest_instance": 7}}
        assert not any(it.get("finish_reason") for it in r["a"])
        assert r["begin"]["ok"] and r["begin"]["handle"] == cut["handle"]
        assert r["again"] == {"error": "already_migrating"}
        assert r["status"]["ok"] and not r["status"]["frozen"]
        assert r["other"] == {"error": "not_frozen"} and r["fin"] == {"ok": True}
        assert r["b_len"] == 6
    j, t = res["dynamo_tpu"], res["dynamo_tpu_torch"]
    assert t["ref"] == j["ref"]
    assert set(t["cut"]) == set(j["cut"]) and set(t["begin"]) == set(j["begin"])
    assert set(t["status"]) == set(j["status"])


def test_freeze_deadline_unfreezes_on_an_idle_engine(params):
    """A frozen row whose coordinator never returns resumes locally once the
    freeze deadline passes, though nothing else runs."""
    req = request(prompt_of(31, 14), 24, temperature=0.7, seed=3)

    async def go(M):
        e = await make_engine(M, params).start()
        ref = await solo(e, M, req)
        e.migration_freeze_ttl_s = 0.05
        s = Stream(e, M, req, "frozen")
        await s.until(4)
        cut = await e.run_on_engine_thread(
            lambda: (e.migration_begin("frozen"), e.migration_cutover("frozen"))[1])
        await asyncio.wait_for(s.task, 60)
        st = await e.run_on_engine_thread(lambda: e.migration_status("frozen"))
        await e.stop()
        return {"ok": cut["ok"], "got": s.tokens, "ref": ref, "status": st,
                "finish": s.items[-1].get("finish_reason")}

    res = both(go)
    assert res["dynamo_tpu_torch"] == res["dynamo_tpu"]
    t = res["dynamo_tpu_torch"]
    assert t["ok"] and t["got"] == t["ref"] and len(t["got"]) == 24
    assert t["status"] == {"error": "no_migration"} and t["finish"] == "length"


def test_stop_posts_terminal_frames_for_frozen_rows(params):
    req = request(prompt_of(41, 14), 64)

    async def go(M):
        e = await make_engine(M, params).start()
        s = Stream(e, M, req, "held")
        await s.until(4)
        cut = await e.run_on_engine_thread(
            lambda: (e.migration_begin("held"), e.migration_cutover("held"))[1])
        await e.stop()
        await asyncio.wait_for(s.task, 30)
        return {"ok": cut["ok"], "last": s.items[-1], "n": len(s.tokens) == cut["emitted"]}

    res = both(go)
    assert res["dynamo_tpu_torch"] == res["dynamo_tpu"]
    t = res["dynamo_tpu_torch"]
    assert t["ok"] and t["n"] and t["last"]["finish_reason"] == "cancelled"


def test_kv_pressure_offer_picks_the_cheapest_victim(params):
    """Past the usage threshold the hook fires for the running sequence with
    the fewest blocks, at most once per window; unserved, the streams
    complete. Same victims and counts as the JAX engine."""
    reqs = [request(prompt_of(51 + i, n), 20, seed=i) for i, n in enumerate((30, 10, 20))]

    async def go(M):
        e = await make_engine(M, params, num_kv_blocks=40, kv_pressure_offer=0.4).start()
        e.kv_pressure_offer_window_s = 60.0
        offered: list[str] = []
        e.migration_offer = offered.append
        streams = [Stream(e, M, r, f"p{i}") for i, r in enumerate(reqs)]
        await asyncio.wait_for(asyncio.gather(*(s.task for s in streams)), 60)
        out = {"offered": offered, "pressure_offers": e.pressure_offers,
               "tokens": [s.tokens for s in streams]}
        await e.stop()
        return out

    res = both(go)
    assert res["dynamo_tpu_torch"] == res["dynamo_tpu"]
    t = res["dynamo_tpu_torch"]
    assert t["offered"] == ["p1"] and t["pressure_offers"] == 1
    assert all(len(x) == 20 for x in t["tokens"])


def test_kv_pressure_offer_is_bounded():
    from dynamo_tpu_torch.engine.config import EngineArgs

    with pytest.raises(ValueError, match="kv_pressure_offer"):
        EngineArgs(kv_pressure_offer=1.5)
    assert EngineArgs().kv_pressure_offer == 0.0


@pytest.mark.parametrize("depth", [1, 2])
def test_cutover_drains_windows_in_flight(params, monkeypatch, depth):
    """On the card a window's fetch lands later than its dispatch; on the
    CPU at once. With every fetch reported in flight until forced (as the
    card reports a window still running), the cutover finds ``depth``
    windows holding the row, drains them, and only then takes the identity:
    kv_written == len(tokens) - 1, the published blocks' pages equal the
    cache's, and the client sees exactly the identity's tokens and no
    token after the marker."""
    from dynamo_tpu_torch.engine import engine as teng

    monkeypatch.setattr(teng, "host_ready", lambda fetch: False)
    M = mods("dynamo_tpu_torch")
    req = request(prompt_of(61, 22), 48)

    async def go():
        e = await make_engine(M, params, pipeline_depth=depth, pipeline_windows=True).start()
        ref = await solo(e, M, req)
        a = Stream(e, M, req, "held")
        await a.until(12)

        def script():
            inflight = e._inflight_windows()
            s = next(x for x in e._running if x.request_id == "held")
            pending = (s.emitted, e._pend(s))
            e.migration_begin("held")
            cut = e.migration_cutover("held")
            seq = e._migrations["held"].seq
            held = e._runner.extract_pages(seq.block_ids[: cut["kv_blocks"]])
            sent = concat_chunks(e.get_stream_export(cut["handle"]))
            same = all(np.array_equal(np.asarray(x), y) for x, y in zip(held, sent))
            written = (seq.kv_written, len(seq.tokens))
            e.migration_finish("held", {"handle": cut["handle"]})
            return inflight, pending, cut, written, same

        inflight, pending, cut, (kv_written, ntok), same = await e.run_on_engine_thread(script)
        await asyncio.wait_for(a.task, 30)
        await e.stop()
        return ref, a, inflight, pending, cut, kv_written, ntok, same

    ref, a, inflight, (emitted, pend), cut, kv_written, ntok, same = asyncio.run(go())
    # Every token the card computed for the row is in the identity.
    assert inflight == depth and pend == depth * ARGS["decode_steps"]
    assert cut["emitted"] == emitted + pend
    assert kv_written == ntok - 1 and cut["kv_blocks"] == kv_written // BS and same
    assert a.tokens == ref[: cut["emitted"]] == cut["request"]["token_ids"][22:]
    assert a.items[-1] == {"token_ids": [], "migration": {"handle": cut["handle"]}}
