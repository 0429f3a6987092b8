"""chip_smoke.py's phase 4e (``moe_phase``) rehearsed on the CPU at
moe-tiny (4 experts, top 2) in float32, 16 tokens a request (64 on the
card): ``run``'s pipeline with the main path's engine arguments serves
the burst at depth 2, then its greedy requests at depth 0 (the same
streams); every launch count is 0 here (the plain versions run on the
CPU). On a runner of its own, a bucket-8 window op by op records each
layer's MoE input, and one layer's goes through ``_moe`` against the
float64 loop under the gap rule. The card's checks (graph == eager, no
stack copy, replay and MoE times) need the card.

Also ``moe_against_reference`` on rows built to straddle the gap rule,
and ``moe_bounds`` against the issue's arithmetic for moe-wide."""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

import chip_smoke as C
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import ModelConfig


def _one_thread(fn):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


def test_moe_phase_on_the_cpu():
    res = _one_thread(lambda: asyncio.run(C.moe_phase("CPU", preset="moe-tiny", device="cpu",
                                                      dtype="float32", max_tokens=16)))
    cfg = ModelConfig.preset("moe-tiny")
    assert res["model"] == "moe-tiny" and res["layers"] == cfg.num_layers
    assert res["launches"] == (0, 0, 0, 0, 0) and res["depth0"]["launches"] == (0, 0, 0, 0, 0)
    assert res["substeps"] > 0 and res["depth0"]["substeps"] > 0
    assert res["depth0"]["requests"] == C.BURST_TEMPS.count(0.0)
    assert res["tokens_per_s"] > 0 and res["host_ms_per_substep"] > 0
    chk = res["check"]
    assert chk["rows_checked"] + chk["rows_left_out"] == 8 and chk["rows_checked"] > 0
    assert chk["max_abs_err"] <= 1e-4
    assert len(res["routed_experts_per_layer"]) == cfg.num_layers
    assert all(cfg.num_experts_per_token <= n <= cfg.num_experts
               for n in res["routed_experts_per_layer"])
    assert res["one_row_bound_ms"] <= res["routed_bound_ms"] <= res["dense_bound_ms"]


def test_moe_bounds_of_moe_wide():
    """moe-wide in bf16: every weight 10.05 GB (3.00 ms at 3.35 TB/s), one
    row's experts 1.59 GB (0.48 ms), 42 experts a layer 6.73 GB (2.01
    ms); the expert products 9.66 GFLOP a token dense, 1.21 routed."""
    cfg = ModelConfig.preset("moe-wide")
    b = C.moe_bounds(cfg, [42] * cfg.num_layers, 8, 2)
    assert round(b["dense_bytes"] / 1e9, 2) == 10.05 and round(b["dense_bound_ms"], 2) == 3.00
    assert round(b["one_row_bound_ms"], 2) == 0.48
    assert round(b["routed_bytes"] / 1e9, 2) == 6.73 and round(b["routed_bound_ms"], 2) == 2.01
    assert round(b["expert_gflop_per_token_dense"], 2) == 9.66
    assert round(b["expert_gflop_per_token_routed"], 2) == 1.21
    one = C.moe_bounds(cfg, [cfg.num_experts_per_token] * cfg.num_layers, 1, 2)
    assert one["routed_bytes"] == cfg.active_param_count() * 2


def _layer(D, E, ie, seed):
    g = torch.Generator().manual_seed(seed)
    return {"w_router": torch.randn((D, E), generator=g) * D ** -0.5,
            "moe_gate": torch.randn((E, D, ie), generator=g) * D ** -0.5,
            "moe_up": torch.randn((E, D, ie), generator=g) * D ** -0.5,
            "moe_down": torch.randn((E, ie, D), generator=g) * ie ** -0.5}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_against_reference_gap_rule(dtype):
    """Rows whose k-th and (k+1)-th logits are within ``MOE_GAP`` are left
    out, the others checked (and pass); a row whose k-th and (k+1)-th
    experts share a router column ties exactly and is left out."""
    D, E, ie = 32, 16, 8
    cfg = ModelConfig(num_experts=E, num_experts_per_token=4)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    lp = {n: v.to(tdt) for n, v in _layer(D, E, ie, 3).items()}
    x = torch.randn((16, D), generator=torch.Generator().manual_seed(4)).to(tdt)
    res = C.moe_against_reference(x, lp, cfg, dtype)
    assert res["rows_checked"] + res["rows_left_out"] == 16 and res["rows_checked"] > 8
    logits = (x[:1].double() @ lp["w_router"].double()).numpy()[0]
    order = np.argsort(-logits, kind="stable")
    r = lp["w_router"].clone()
    r[:, order[4]] = r[:, order[3]]  # row 0's 4th and 5th experts tie
    tied = dict(lp, w_router=r)
    res = C.moe_against_reference(x[:1], tied, cfg, dtype)
    assert res == {"rows_checked": 0, "rows_left_out": 1, "max_abs_err": 0.0}


def test_moe_against_reference_catches_a_wrong_expert(monkeypatch):
    """A router that takes the lower-probability expert at the k-th place
    fails the check: the expert sets differ."""
    D, E, ie = 32, 16, 8
    cfg = ModelConfig(num_experts=E, num_experts_per_token=4)
    lp = _layer(D, E, ie, 5)
    x = torch.randn((6, D), generator=torch.Generator().manual_seed(6))
    real = TM._moe_route

    def off_by_one(xt, w, k):
        probs, topv, topi = real(xt, w, k + 1)
        return probs, topv[:, [0, 1, 2, 4]], topi[:, [0, 1, 2, 4]]

    monkeypatch.setattr(TM, "_moe_route", off_by_one)
    with pytest.raises(RuntimeError, match="routed to experts"):
        C.moe_against_reference(x, lp, cfg, "float32")
