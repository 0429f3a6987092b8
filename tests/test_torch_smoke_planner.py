"""chip_smoke.py's phases 4s (the SLA profile sweep) and 7c (the control
plane), rehearsed on the CPU at test-tiny in float32.

- 4s: ``sweep_phase`` over the main path's engine (``run``'s pipeline
  with chip_smoke's engine arguments) at the card's batches, prompt
  lengths and ``gen_len``: finite positive samples, tokens/s at B=8 above
  B=1, no eager window, the npz readable by the JAX package's
  ``load_profile`` with the same arrays.
- 7c: ``http_phase`` with that profile and ``control``: phase 7 over two
  ``--autoscaler on --sla-profile`` workers, then ``control_phase`` runs
  every check it runs on the card — the profile adopted by a ``--qos``
  frontend and discovered, the router service's route/generate, the
  exporter's totals, the planner's pool move (journal, pools, relocated
  streams under the gap rule, the rest bit for bit), the balancer's move,
  the decision log replayed, every exit code 0. On the CPU the plain
  attention runs, so the launch counts are 0. One intra-op thread in
  this process and in every process the phase spawns.
"""

from __future__ import annotations

import asyncio
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke as C
from dynamo_tpu.planner.interpolate import load_profile as jax_load_profile
from dynamo_tpu_torch.run.__main__ import parse_args
from test_torch_smoke_http import in_process_burst


@pytest.fixture(autouse=True, scope="module")
def _one_thread_everywhere():
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def sweep_on_the_cpu() -> dict:
    async def go():
        args = parse_args(["--in", "batch:-", "--preset", "test-tiny", "--dtype", "float32",
                           "--device", "cpu", *C.ENGINE_ARGV])
        pipe = await C.local_pipeline(args)
        try:
            return await C.sweep_phase(pipe.engine, "CPU", device="cpu")
        finally:
            await pipe.engine.stop()

    return asyncio.run(go())


def test_sweep_phase_on_the_cpu():
    res = sweep_on_the_cpu()
    try:
        assert res["batch"] == list(map(float, C.SWEEP_BATCHES))
        assert res["prompt_len"] == list(map(float, C.SWEEP_PROMPT_LENS))
        assert res["gen_len"] == 96 and res["launches"] == 0 and res["substeps"] > 0
        assert res["tok_s"][-1] > res["tok_s"][0]
        d, p = jax_load_profile(res["path"])
        assert np.array_equal(d.tok_s, res["tok_s"]) and np.array_equal(p.ttft_ms,
                                                                        res["ttft_ms"])
        with np.load(res["path"]) as z:
            meta = str(z["meta"])
        assert "'device': 'cpu'" in meta and "'model': 'test-tiny'" in meta
    finally:
        shutil.rmtree(os.path.dirname(res["path"]), ignore_errors=True)


def test_control_phase_on_the_cpu():
    sweep = sweep_on_the_cpu()
    try:
        reference = asyncio.run(in_process_burst())
        res = C.http_phase("CPU", reference, 1.0, preset="test-tiny", device="cpu",
                           dtype="float32", sla_profile=sweep["path"],
                           control={"interval": 0.25, "plan_tokens": 600, "bal_tokens": 500})
    finally:
        shutil.rmtree(os.path.dirname(sweep["path"]), ignore_errors=True)
    ctl = res["control"]
    assert set(res["exit_codes"].values()) == {0}
    assert {"control-frontend", "control-exporter", "control-router",
            "control-planner"} <= set(res["exit_codes"])
    assert res["launches"] == 0 and ctl["launches"] == 0
    assert ctl["route"]["overlap_blocks"] > 0
    assert ctl["planner"]["relocated"] and ctl["planner"]["decision_lag_s"] > 0
    assert ctl["balancer"]["moves"] >= 1 and ctl["balancer"]["moved_rows"]
    assert ctl["balancer"]["busy_active_slots_peak"] > 0 and ctl["cycles"] > 3
