"""chip_smoke.py's tier phase (phase 13), rehearsed on the CPU.

The phase's own code runs at test-tiny in float32 with ``--device cpu``:

- 13a (``chip_smoke.tiers_phase``): one ``TorchEngine`` with a G2 of 512
  blocks and a G3 directory serves the burst with its tiers off, cold with
  them on, on its G1 hit, with them off again and, after clear_kv_blocks,
  onboarded from G2; then engines on the same weights with a 32-block G2:
  onboarded from G3, and from G3 after a restart. Every onboarded pass
  must onboard every full prompt block (346 at the burst's lengths), the
  coverage the tiers held before it, and give the G1-hit pass's streams
  bit for bit; the onboarded pages read back bit-equal to the stored ones.
- 13b (``chip_smoke.tiers_worker_phase``): the store and two worker CLIs
  with one shared ``--fleet-kv-dir``; worker B fetches all 8 prompts from
  A's tiers on ``peer_prefix`` hints, then serves them from G2 + G4
  (``tier_g4_hits_total`` > 0, dedup counted); every stream equals 13a's
  G1-hit pass; every process exits 0 on SIGTERM.

On the CPU the plain versions run, so every launch count is 0.
"""

from __future__ import annotations

import os

import pytest
import torch

import chip_smoke as C


@pytest.fixture(autouse=True, scope="module")
def _one_thread_everywhere():
    """One intra-op thread here and in every spawned process, so float32
    sums round alike in the in-process reference and in the workers."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def test_burst_blocks():
    reqs = C.tier_requests("m")
    assert sum((len(r["token_ids"]) - 1) // 16 for r in reqs) == 346
    assert [len(C.prompt_hashes(r, 16)) for r in reqs] == [(n - 1) // 16 for n in C.BURST_LENS]


def test_tier_phases_on_the_cpu():
    res = C.tiers_phase("CPU", preset="test-tiny", device="cpu", dtype="float32")
    assert res["blocks"] == res["pages_compared"] == 346
    assert res["hits"]["g2"]["g2_hits"] == 346
    assert res["hits"]["g3"]["g3_hits"] > 0 and res["hits"]["restart"]["g3_hits"] == 346
    assert all(v == (0, 0, 0, 0) for v in res["launches"].values())
    assert res["offload_bytes"] > 0 and res["g2_bytes"] > 0 and res["g3_bytes"] > 0
    assert res["flushes_cold"] > 0 and res["d2h_mb_per_s"] > 0 and res["g3_read_mb_per_s"] > 0
    assert not os.path.exists(os.path.join(C.TIER_DIR, "tiers-workers"))
    w = C.tiers_worker_phase("CPU", res["hit_reference"], preset="test-tiny", device="cpu",
                             dtype="float32")
    assert w["peer_fetches"] == 8 and w["peer_inject_bytes"] > 0
    assert w["b_tiers"]["g4_hits"] > 0 and w["b_tiers"]["g4_dedup_blocks"] > 0
    assert w["b_tiers"]["onboarded_blocks"] == 346
    assert w["exit_codes"] == {"a": 0, "b": 0, "store": 0}
    assert w["peer_fetch_mb_per_s"] > 0 and w["g4_files"] > 0
