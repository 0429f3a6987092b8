"""The SLA profile a port worker ships in its model card, and who reads it.

- ``--sla-profile`` embeds the npz in the card (mocker and engine
  workers), with the JAX worker's dict; the JAX and the port frontend's
  discovery hand it to ``on_card``, and both planners'
  ``discover_card_profile`` find the same arrays.
- Spawned: a port mocker worker with ``--sla-profile`` (a JAX-written
  file); a port ``--qos`` frontend adopts the card's profile (its log line
  says so), one with ``--qos-profile`` (a port-written file) loads that
  instead and adopts nothing; ``python -m dynamo_tpu_torch.planner
  --operate --profile-from-discovery`` finds both curves.
"""

from __future__ import annotations

import asyncio
import socket

import numpy as np
from procutil import ManagedProcess

from dynamo_tpu.planner import interpolate as jint
from dynamo_tpu_torch.planner import interpolate as tint


def write_profile(pkg, path: str, scale: float = 1.0) -> None:
    pkg.save_profile(
        path,
        decode=pkg.DecodeInterpolator(np.array([1.0, 4.0, 8.0]),
                                      scale * np.array([9.0, 11.0, 16.0]),
                                      np.array([110.0, 360.0, 500.0])),
        prefill=pkg.PrefillInterpolator(np.array([64.0, 512.0]), scale * np.array([60.0, 400.0]),
                                        np.array([1066.0, 1280.0])),
        meta={"device": "cuda"})


def test_card_profile_reaches_both_frontends_and_planners(tmp_path):
    from dynamo_tpu.llm.discovery import ModelManager as JManager
    from dynamo_tpu.llm.discovery import ModelWatcher as JWatcher
    from dynamo_tpu.planner.__main__ import discover_card_profile as jdiscover
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
    from dynamo_tpu.worker.__main__ import build_engine as jbuild
    from dynamo_tpu.worker.__main__ import parse_args as jparse
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm.model_card import register_model
    from dynamo_tpu_torch.planner.__main__ import discover_card_profile
    from dynamo_tpu_torch.runtime.config import Config
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.worker.__main__ import build_mocker, parse_args

    path = str(tmp_path / "prof.npz")
    write_profile(jint, path)
    argv = ["--engine", "mocker", "--sla-profile", path, "--model-name", "profiled-model"]

    async def go():
        _, card = build_mocker(parse_args(argv), Config.from_env())
        _, jcard = await jbuild(jparse(argv))
        assert card.sla_profile == jcard.sla_profile and "d_batch" in card.sla_profile
        from dynamo_tpu_torch.runtime.store_net import StoreServer

        server = await StoreServer().start()  # TCP: both packages' runtimes reach it
        url = server.url
        wrt = await DistributedRuntime.create(store_url=url)
        await register_model(wrt, "dynamo", card)
        seen = {}
        for name, rt_cls, mgr_cls, watch_cls in (
                ("port", DistributedRuntime, ModelManager, ModelWatcher),
                ("jax", JRuntime, JManager, JWatcher)):
            frt = await rt_cls.create(store_url=url)
            manager = mgr_cls(frt, on_card=lambda c, n=name: seen.setdefault(n, c.sla_profile))
            watcher = await watch_cls(frt, manager, namespace="dynamo").start()
            for _ in range(200):
                if name in seen:
                    break
                await asyncio.sleep(0.02)
            await watcher.close()
            await manager.close()
            await frt.shutdown()
            await frt.store.close()
        assert seen["port"] == seen["jax"] == card.sla_profile
        found = [await discover(wrt.store, "dynamo") for discover in (discover_card_profile,
                                                                       jdiscover)]
        want_d, want_p = tint.load_profile(path)
        for d, p in found:
            assert np.array_equal(d.itl_ms, want_d.itl_ms) and np.array_equal(
                p.ttft_ms, want_p.ttft_ms)
        await wrt.shutdown()
        await wrt.store.close()
        await server.close()

    asyncio.run(go())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_spawned_frontends_and_planner_read_the_card_profile(tmp_path):
    card_path, flag_path = str(tmp_path / "card.npz"), str(tmp_path / "flag.npz")
    write_profile(jint, card_path)
    write_profile(tint, flag_path, scale=2.0)
    port = _free_port()
    url = f"tcp://127.0.0.1:{port}"
    procs = []
    try:
        store = ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host",
                                "127.0.0.1", "--port", str(port)], name="store")
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        worker = ManagedProcess(["-m", "dynamo_tpu_torch.worker", "--store-url", url,
                                 "--engine", "mocker", "--sla-profile", card_path,
                                 "--block-size", "4"], name="worker")
        procs.append(worker)
        worker.wait_for(r"serving mock-model", 60)
        fe = ManagedProcess(["-m", "dynamo_tpu_torch.frontend", "--store-url", url, "--host",
                             "127.0.0.1", "--port", "0", "--qos"], name="frontend")
        procs.append(fe)
        fe.wait_for(r"qos: SLA profile adopted from model card mock-model", 60)
        fe2 = ManagedProcess(["-m", "dynamo_tpu_torch.frontend", "--store-url", url, "--host",
                              "127.0.0.1", "--port", "0", "--qos", "--qos-profile", flag_path],
                             name="frontend2")
        procs.append(fe2)
        fe2.wait_for(r"qos: loaded SLA profile .*flag\.npz \(prefill=True decode=True\)", 60)
        fe2.wait_for(r"frontend: http://", 60)
        planner = ManagedProcess(["-m", "dynamo_tpu_torch.planner", "--operate",
                                  "--profile-from-discovery", "--store-url", url,
                                  "--metrics-url", "http://127.0.0.1:9/metrics",
                                  "--adjustment-interval", "60"], name="planner")
        procs.append(planner)
        planner.wait_for(r"card profile discovered \(decode=True prefill=True\)", 60)
        planner.wait_for(r"planner \(closed loop\): watching", 60)
        # The flag's profile wins: nothing adopted from the card.
        assert not any("adopted" in line for line in fe2.lines)
    finally:
        for p in procs:
            p.kill()


def test_sweep_cli_writes_a_profile_the_jax_package_reads(tmp_path):
    """``python -m dynamo_tpu_torch.planner.profile_sweep`` on the CPU: its
    own test-tiny engine (float32, seed 0), the npz the JAX ``load_profile``
    reads with the arrays the port's reads, every sample finite and
    positive, ``meta`` naming the device and dtype."""
    import ast

    from dynamo_tpu_torch.planner import profile_sweep

    out = str(tmp_path / "profile.npz")
    assert profile_sweep.main(["--preset", "test-tiny", "--device", "cpu", "--batches", "1,2",
                               "--prompt-lens", "16,48", "--gen-len", "8",
                               "--decode-steps", "4", "--out", out]) == 0
    (jd, jp), (td, tp) = jint.load_profile(out), tint.load_profile(out)
    assert jd.batch.tolist() == [1, 2] and jp.prompt_len.tolist() == [16, 48]
    for a, b in ((jd.batch, td.batch), (jd.itl_ms, td.itl_ms), (jd.tok_s, td.tok_s),
                 (jp.prompt_len, tp.prompt_len), (jp.ttft_ms, tp.ttft_ms),
                 (jp.tok_s, tp.tok_s)):
        assert np.array_equal(a, b)
        assert np.all(np.isfinite(a)) and np.all(a > 0)
    with np.load(out) as z:
        meta = ast.literal_eval(z["meta"].item().decode())
    assert (meta["model"], meta["device"], meta["dtype"]) == ("test-tiny", "cpu", "float32")
