"""The port's planner (predictors, interpolators, profile files, the
planner core, the control law, the balancer law, the cycle record) held
against the JAX package's on the same seeded inputs.

Both packages run the same numpy code, so forecasts, interpolated values
and every decision are compared with ``==``, not within a tolerance.
"""

from __future__ import annotations

import asyncio
import json
import math
from dataclasses import asdict

import numpy as np
import pytest

from dynamo_tpu.planner import balancer as jbal
from dynamo_tpu.planner import connector as jconn
from dynamo_tpu.planner import core as jcore
from dynamo_tpu.planner import interpolate as jint
from dynamo_tpu.planner import operator as jop
from dynamo_tpu.planner import predictors as jpred
from dynamo_tpu_torch.planner import balancer as tbal
from dynamo_tpu_torch.planner import connector as tconn
from dynamo_tpu_torch.planner import core as tcore
from dynamo_tpu_torch.planner import interpolate as tint
from dynamo_tpu_torch.planner import operator as top
from dynamo_tpu_torch.planner import predictors as tpred


def series(kind: str, n: int, seed: int) -> np.ndarray:
    """Seeded load series: noisy level, trend, a diurnal-like season."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    base = {"flat": 5.0 + 0 * t, "trend": 2.0 + 0.3 * t,
            "season": 10.0 + 6.0 * np.sin(2 * np.pi * t / 12.0),
            "spiky": 3.0 + 20.0 * (rng.random(n) < 0.1)}[kind]
    return np.maximum(0.0, base + rng.normal(0.0, 0.8, n))


@pytest.mark.parametrize("kind", ["constant", "moving-average", "ar", "seasonal"])
@pytest.mark.parametrize("shape", ["flat", "trend", "season", "spiky"])
def test_predictors_forecast_bit_identical(kind, shape):
    seed = 10 * ["constant", "moving-average", "ar", "seasonal"].index(kind) + len(shape)
    vals = series(shape, 120, seed)
    kw = {} if kind == "constant" else {"window": 24}
    jp, tp = jpred.make_predictor(kind, **kw), tpred.make_predictor(kind, **kw)
    for v in vals:
        jp.observe(v)
        tp.observe(v)
        assert tp.predict() == jp.predict()
    if kind == "seasonal":
        # The fitted season is the same too, and the forecast uses it.
        assert tp._fitted_m == jp._fitted_m and jp._fitted_m > 0 or shape != "season"


def test_seasonal_fixed_season_and_autocorr_equal():
    vals = series("season", 200, 7)
    m = tpred.SeasonalPredictor._autocorr_season(vals)
    assert m == jpred.SeasonalPredictor._autocorr_season(vals) and m % 12 == 0
    jp = jpred.make_predictor("seasonal", window=24, season=12)
    tp = tpred.make_predictor("seasonal", window=24, season=12)
    for v in vals:
        jp.observe(v)
        tp.observe(v)
        assert tp.predict() == jp.predict()
    with pytest.raises(ValueError):
        tpred.make_predictor("prophet")


def profile(seed: int = 3):
    rng = np.random.default_rng(seed)
    batch = np.array([1.0, 2.0, 4.0, 8.0, 16.0])
    itl = np.sort(rng.uniform(8.0, 40.0, 5))
    tok = batch * 1000.0 / itl
    plen = np.array([64.0, 128.0, 256.0, 512.0, 1024.0])
    ttft = np.sort(rng.uniform(40.0, 900.0, 5))
    return (batch, itl, tok), (plen, ttft, plen / ttft * 1000.0)


def interps(pkg, seed: int = 3):
    d, p = profile(seed)
    return pkg.DecodeInterpolator(*d), pkg.PrefillInterpolator(*p)


def test_interpolators_bit_identical():
    jd, jp = interps(jint)
    td, tp = interps(tint)
    for b in np.linspace(0.0, 20.0, 81):
        assert td.itl_at(b) == jd.itl_at(b) and td.throughput_at(b) == jd.throughput_at(b)
        assert td.in_range(b) == jd.in_range(b)
    for sla in (5.0, 9.0, 15.0, 25.0, 50.0):
        assert td.max_batch_under_itl(sla) == jd.max_batch_under_itl(sla)
        assert td.best_throughput_under_itl(sla) == jd.best_throughput_under_itl(sla)
    for n in np.linspace(0.0, 2000.0, 41):
        assert tp.ttft_at(n) == jp.ttft_at(n) and tp.throughput_at(n) == jp.throughput_at(n)
    for total in (2, 3, 5, 8):
        kw = dict(prompt_len=300.0, gen_len=128.0, itl_sla_ms=20.0, ttft_sla_ms=250.0)
        assert tint.plan_disagg_pools(total, td, tp, **kw) == jint.plan_disagg_pools(
            total, jd, jp, **kw)
    with pytest.raises(ValueError):
        tint.DecodeInterpolator(np.array([1.0, 2.0]), np.array([1.0, np.nan]),
                                np.array([1.0, 2.0]))


@pytest.mark.parametrize("writer,reader", [(tint, jint), (jint, tint)])
def test_profile_files_interchange(tmp_path, writer, reader):
    """A profile written by either package loads in the other, arrays equal."""
    d, p = interps(writer)
    path = str(tmp_path / "prof.npz")
    writer.save_profile(path, decode=d, prefill=p, meta={"device": "cuda", "card": "x"})
    d2, p2 = reader.load_profile(path)
    for a, b in ((d.batch, d2.batch), (d.itl_ms, d2.itl_ms), (d.tok_s, d2.tok_s),
                 (p.prompt_len, p2.prompt_len), (p.ttft_ms, p2.ttft_ms),
                 (p.tok_s, p2.tok_s)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with np.load(path) as z:
        assert sorted(z.files) == ["d_batch", "d_itl", "d_tok", "meta", "p_len", "p_tok",
                                   "p_ttft"]


@pytest.mark.parametrize("card_pkg", ["dynamo_tpu", "dynamo_tpu_torch"])
def test_card_profile_survives_both_model_cards(card_pkg):
    """profile_as_card_dict rides either package's model-card bytes; both
    packages' interpolators_from_card_dict read it back to equal lookups."""
    import importlib

    mc = importlib.import_module(f"{card_pkg}.llm.model_card")
    td, tp = interps(tint)
    d = tint.profile_as_card_dict(decode=td, prefill=tp)
    assert d == jint.profile_as_card_dict(*interps(jint))
    card = mc.ModelDeploymentCard(name="m", sla_profile=d)
    back = mc.ModelDeploymentCard.from_bytes(card.to_bytes()).sla_profile
    assert back == d
    for pkg in (tint, jint):
        d2, p2 = pkg.interpolators_from_card_dict(back)
        assert np.array_equal(d2.itl_ms, td.itl_ms) and np.array_equal(p2.ttft_ms, tp.ttft_ms)
    for bad in (None, {"d_batch": [1], "d_itl": "junk"},
                {"d_batch": [1.0, 2.0], "d_itl": [1.0, float("nan")], "d_tok": [1.0, 2.0]}):
        assert tint.interpolators_from_card_dict(bad) == (None, None)


# -- the planner core ----------------------------------------------------------


def observations(n: int, seed: int):
    """Seeded observation stream: bursts, idle stretches, empty windows,
    NaN/negative junk, TTFT/ITL breaches, queue pressure."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.08:
            out.append(dict(empty_window=True))
            continue
        if r < 0.2:
            out.append(dict())  # idle
            continue
        rate = float(rng.choice([0.5, 2.0, 6.0, 15.0, 40.0]) * rng.uniform(0.7, 1.3))
        o = dict(request_rate=rate, output_token_rate=rate * rng.uniform(50, 300),
                 input_token_rate=rate * rng.uniform(100, 1500),
                 ttft_ms=float(rng.uniform(50, 900)) if rng.random() < 0.8 else None,
                 itl_ms=float(rng.uniform(5, 60)) if rng.random() < 0.8 else None,
                 queue_depth=float(rng.integers(0, 20)) if rng.random() < 0.3 else 0.0,
                 drain_interval_s=float(rng.uniform(0.0, 0.2)))
        if r > 0.95:
            o[rng.choice(["request_rate", "ttft_ms", "itl_ms", "queue_depth"])] = (
                float("nan") if rng.random() < 0.5 else -1.0)
        out.append(o)
    return out


@pytest.mark.parametrize("disagg", [False, True])
def test_planner_targets_equal(disagg):
    kw = dict(predictor="ar", min_replicas=1, max_replicas=6, replica_tok_s=900.0,
              itl_sla_ms=25.0, ttft_sla_ms=400.0, mean_output_tokens=150.0)
    if disagg:
        kw.update(prefill_component="prefill", mean_input_tokens=700.0, prefill_tok_s=5000.0)
    planners = []
    for pkg_core, pkg_conn, pkg_int in ((jcore, jconn, jint), (tcore, tconn, tint)):
        d, p = interps(pkg_int, seed=11)
        conn = pkg_conn.RecordingConnector({"backend": 2, "prefill": 1})
        planners.append((pkg_core.Planner(pkg_core.PlannerConfig(**kw), conn, None,
                                          decode_interp=d, prefill_interp=p), conn, pkg_core))
    got = {0: [], 1: []}
    for o in observations(200, seed=5 + disagg):
        for k, (pl, conn, pkg_core) in enumerate(planners):
            obs = pkg_core.PlannerObservation(**o).sanitize()
            if obs.empty_window:
                got[k].append(("empty",))
                continue
            got[k].append(pl._step_sync(obs))
            got[k].append(pl.target_prefill_replicas(obs) if disagg else None)
            got[k].append(dict(conn.replicas))
    assert got[0] == got[1]
    assert planners[0][1].calls == planners[1][1].calls and planners[1][1].calls


def test_initial_pool_split_equal():
    res = []
    for pkg_core, pkg_conn, pkg_int in ((jcore, jconn, jint), (tcore, tconn, tint)):
        d, p = interps(pkg_int)
        pl = pkg_core.Planner(pkg_core.PlannerConfig(itl_sla_ms=20.0, ttft_sla_ms=300.0),
                              pkg_conn.RecordingConnector(), None, d, p)
        res.append([pl.initial_pool_split(n) for n in (2, 4, 7)])
    assert res[0] == res[1]


FRONTEND_METRICS = """\
# HELP dynamo_tpu_http_requests_total HTTP requests
# TYPE dynamo_tpu_http_requests_total counter
dynamo_tpu_http_requests_total{endpoint="completions",model="m",status="200"} 7
dynamo_tpu_http_requests_total{endpoint="chat",model="m",status="200"} 3
dynamo_tpu_http_output_tokens_total{model="m"} 640
dynamo_tpu_http_time_to_first_token_seconds_sum{model="m"} 1.25
dynamo_tpu_http_time_to_first_token_seconds_count{model="m"} 10
junk line without value
dynamo_tpu_http_inter_token_latency_seconds_sum{model="m"} nan
"""


def test_metrics_parse_equal_on_frontend_text():
    t, j = (pkg.HttpMetricsSource._parse(FRONTEND_METRICS) for pkg in (tcore, jcore))
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert t["dynamo_tpu_http_requests_total"] == 10.0


def test_metrics_source_equal_on_live_frontends():
    """A JAX and a port frontend on one store serve the same requests from
    one port worker: both packages' ``HttpMetricsSource._parse`` read each
    frontend's /metrics text to equal dicts, and the series the planner
    reads (requests, tokens, TTFT and ITL counts) are equal across the two
    frontends. Both sources then read the same rates off the port one."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_torch_http import (call, completion, np_weights, port_engine, start_frontend,
                                 start_store, start_worker, stop_frontend, stop_runtime,
                                 wait_for_models)

    planner_keys = ("requests_total", "output_tokens_total", "input_tokens_total",
                    "time_to_first_token_seconds_count", "inter_token_latency_seconds_count")

    async def go():
        store = await start_store("dynamo_tpu_torch")
        engine = await port_engine(np_weights()).start()
        wrt = await start_worker("dynamo_tpu_torch", store.url, engine)
        fes = [await start_frontend(pkg, store.url) for pkg in ("dynamo_tpu", "dynamo_tpu_torch")]
        try:
            srcs = [pkg.HttpMetricsSource(f"{fes[1].base}/metrics") for pkg in (jcore, tcore)]
            assert all(o.empty_window for o in [await s() for s in srcs])
            parsed = []
            for fe in fes:
                await wait_for_models(fe.base, ["tiny"])
                for i in range(3):
                    status, _, _ = await call(fe.base, "/v1/completions", completion(
                        f"planner metrics {i}", max_tokens=6, temperature=0, seed=i,
                        ignore_eos=True), stream=bool(i % 2))
                    assert status == 200
                text = await asyncio.to_thread(fetch, f"{fe.base}/metrics")
                j, t = jcore.HttpMetricsSource._parse(text), tcore.HttpMetricsSource._parse(text)
                assert t == j and j["dynamo_tpu_http_requests_total"] == 3
                parsed.append(t)
            for k in planner_keys:
                assert parsed[0][f"dynamo_tpu_http_{k}"] == parsed[1][f"dynamo_tpu_http_{k}"]
            jo, to = [await s() for s in srcs]
            assert not jo.empty_window and not to.empty_window
            assert to.itl_ms == jo.itl_ms and to.ttft_ms == jo.ttft_ms and to.itl_ms > 0
        finally:
            for fe in fes:
                await stop_frontend(fe)
            await stop_runtime(wrt)
            await engine.stop()
            await store.close()

    asyncio.run(go())


def fetch(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


# -- the control law -----------------------------------------------------------


def law_pair(replica_scaling: bool, fleet: bool, seed: int):
    cfg = dict(interval_s=1.0, ttft_sla_ms=300.0, itl_sla_ms=25.0, predictor="ar",
               max_engines=6, hysteresis_cycles=2, cooldown_s=7.0,
               fleet_child_rps=(5.0 if fleet else 0.0), replica_scaling=replica_scaling)
    laws = []
    for pkg_op, pkg_int in ((jop, jint), (top, tint)):
        d, p = interps(pkg_int, seed=seed)
        laws.append(pkg_op.ControlLaw(pkg_op.OperatorConfig(**cfg), d, p))
    return laws


def decision_view(d) -> dict:
    return {"kind": d.kind, "describe": d.describe(), **asdict(d)}


@pytest.mark.parametrize("replica_scaling", [False, True])
@pytest.mark.parametrize("fleet", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_control_law_decisions_equal(replica_scaling, fleet, seed):
    """Seeded observation streams under an injected clock: hysteresis,
    cooldown, empty windows, idle settling, NaN sanitising, pool moves and
    replica/fleet scaling — every action equal, field for field."""
    from dynamo_tpu.planner.core import PlannerObservation as JObs
    from dynamo_tpu_torch.planner.core import PlannerObservation as TObs

    jl, tl = law_pair(replica_scaling, fleet, seed)
    rng = np.random.default_rng(100 + seed)
    pools = {"p": 1, "d": 3, "f": 2}
    now = 0.0
    kinds = set()
    for o in observations(300, seed=seed):
        now += float(rng.choice([0.5, 1.0, 2.0]))
        jd = jl.decide(JObs(**o), pools["p"], pools["d"], pools["f"], now=now)
        td = tl.decide(TObs(**o), pools["p"], pools["d"], pools["f"], now=now)
        assert [decision_view(d) for d in td] == [decision_view(d) for d in jd]
        assert asdict(tl.state) == asdict(jl.state)
        for d in td:
            kinds.add(d.kind if d.kind != "hold" else d.reason)
            if d.kind == "hold":
                continue
            for law in (jl, tl):
                law.notify_actuated(d.kind, now)
            if d.kind == "pool_move":
                src, dst = ("p", "d") if d.src == "prefill" else ("d", "p")
                pools[src] -= 1
                pools[dst] += 1
            elif d.kind == "replica_scale":
                pools["p" if d.pool == "prefill" else "d"] = d.target
            elif d.kind == "fleet_resize":
                pools["f"] = d.target
    assert {"empty_window", "hysteresis"} <= kinds
    assert kinds & {"pool_move", "replica_scale", "fleet_resize"}


def test_control_law_targets_and_capacities_equal():
    from dynamo_tpu.planner.core import PlannerObservation as JObs
    from dynamo_tpu_torch.planner.core import PlannerObservation as TObs

    jl, tl = law_pair(True, False, 4)
    for o in observations(80, seed=9):
        jo, to = JObs(**o).sanitize(), TObs(**o).sanitize()
        assert asdict(to) == asdict(jo) or any(
            isinstance(v, float) and math.isnan(v) for v in asdict(jo).values())
        if jo.empty_window:
            continue
        for p, d in ((0, 0), (1, 1), (2, 3), (5, 1)):
            assert tl.targets(to, p, d) == jl.targets(jo, p, d)
        assert tl.decode_capacity_tok_s() == jl.decode_capacity_tok_s()
        assert tl.prefill_capacity_tok_s(333.0) == jl.prefill_capacity_tok_s(333.0)


def test_replay_law_reproduces_a_recorded_autoscaler_run():
    """The port's cycle record: an SlaAutoscaler over a recording actuator
    and a seeded observation stream; a fresh law fed the records returns
    the same decisions, every field."""
    from dynamo_tpu_torch.planner.actuate import RecordingActuator
    from dynamo_tpu_torch.planner.core import PlannerObservation

    stream = iter(observations(60, seed=21))
    clock = {"t": 0.0}

    def tick():
        clock["t"] += 0.5
        return clock["t"]

    async def observe():
        return PlannerObservation(**next(stream))

    records = []

    async def go():
        act = RecordingActuator(prefill=1, decode=2)
        d, p = interps(tint, seed=2)
        cfg = top.OperatorConfig(ttft_sla_ms=300.0, itl_sla_ms=25.0, hysteresis_cycles=2,
                                 cooldown_s=3.0, max_engines=5)
        auto = top.SlaAutoscaler(top.ControlLaw(cfg, d, p), observe, pool_actuator=act,
                                 clock=tick, recorder=records.append)
        for _ in range(60):
            await auto.step()
        return cfg, d, p, auto

    cfg, d, p, auto = asyncio.run(go())
    assert len(records) == 60 and any(r["actuated"] for r in records)
    # JSON round trip: what the CLI's --decision-log writes and reads back.
    records = [json.loads(json.dumps(r)) for r in records]
    replayed = top.replay_law(top.ControlLaw(cfg, d, p), records)
    assert replayed == [r["decisions"] for r in records]
    assert sum(len(r["actuated"]) for r in records) == len(auto.actions_done)


def test_planner_cli_flags_match_the_reference():
    """Every flag of the JAX planner CLI, with the same dest and default."""
    from dynamo_tpu.planner import __main__ as jm
    from dynamo_tpu_torch.planner import __main__ as tm

    argv = ["--metrics-url", "http://x/metrics"]
    ja, ta = vars(jm.parse_args(argv)), vars(tm.parse_args(argv))
    assert ta.pop("decision_log") is None
    assert ta == ja


# -- the balancer law ----------------------------------------------------------


def loads(pkg, rng, ids):
    return [pkg.EngineLoad(instance_id=i, active=int(rng.integers(0, 9)), slots=8,
                           waiting=int(rng.integers(0, 4)) if rng.random() < 0.3 else 0,
                           kv_usage=float(rng.uniform(0.0, 1.0)))
            for i in ids if rng.random() > 0.1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_balancer_law_moves_equal(seed):
    cfg = dict(saturation=0.55, idle=0.35, min_gap=0.2, kv_pressure=0.85,
               hysteresis_cycles=2, pair_cooldown_s=4.0, settle_s=3.0,
               max_moves_per_cycle=2)
    jl = jbal.BalancerLaw(jbal.BalancerConfig(**cfg))
    tl = tbal.BalancerLaw(tbal.BalancerConfig(**cfg))
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    pick = np.random.default_rng(50 + seed)
    now = 0.0
    reasons = set()
    for _ in range(400):
        now += 0.5
        ids = [0x10, 0x20, 0x30, 0x40, 0x50]
        jm = jl.decide(loads(jbal, rng_j, ids), now=now)
        tm = tl.decide(loads(tbal, rng_t, ids), now=now)
        assert [(asdict(m), m.describe()) for m in tm] == [(asdict(m), m.describe()) for m in jm]
        for jmove, tmove in zip(jm, tm):
            reasons.add(tmove.reason)
            r = pick.random()
            if r < 0.7:
                jl.notify_actuated(jmove, now)
                tl.notify_actuated(tmove, now)
            elif r < 0.9:
                jl.notify_failed(jmove)
                tl.notify_failed(tmove)
            else:
                jl.forget(jmove.dst)
                tl.forget(tmove.dst)
        assert asdict(tl.state) == asdict(jl.state)
    assert reasons == {"hot_spot", "kv_pressure"}
    assert tl.state.pingpong_suppressed > 0 and tl.state.holds.get("cooldown")


def test_balancer_shell_equal_over_fakes():
    """FleetBalancer.step over the same fake pools, loads and mover, in
    both packages: the same moves, outcomes and status."""
    from types import SimpleNamespace

    def run(pkg):
        rng = np.random.default_rng(8)
        members = [SimpleNamespace(instance_id=i) for i in (1, 2, 3)]
        replies = iter([{"ok": True}, {"ok": False, "reason": "paced"}, {"ok": True}] * 50)

        async def pools():
            return {"decode": members}

        async def load_source(iid):
            active = int(rng.integers(0, 9))
            return SimpleNamespace(
                worker=SimpleNamespace(request_active_slots=active, request_total_slots=8,
                                       num_requests_waiting=0),
                kv=SimpleNamespace(gpu_cache_usage_perc=float(rng.uniform(0, 1))))

        async def mover(src, dst):
            return next(replies)

        t = {"now": 0.0}

        def clock():
            t["now"] += 1.0
            return t["now"]

        fb = pkg.FleetBalancer(pkg.BalancerLaw(pkg.BalancerConfig(
            saturation=0.5, idle=0.3, pair_cooldown_s=2.0, settle_s=2.0)),
            pools, load_source, mover, clock=clock)

        async def go():
            for _ in range(40):
                await fb.step()
            return [(m.describe(), o) for m, o in fb.moves_done], fb.status()

        return asyncio.run(go())

    assert run(tbal) == run(jbal)
