"""chip_smoke.py's phase 15 (multi-LoRA) and its cut-depth checkpoint,
rehearsed on the CPU at test-tiny in float32.

- ``chip_smoke.lora_phase``: the six adapters over four slots, the mixed
  burst at depths 2 and 0 (identical streams), base-only (base rows
  bit-identical), tree speculation and an adapter chat under the schema,
  the teacher-forced references against merged weights, every launch
  count 0 here (the plain versions run on the CPU).
- ``chip_smoke.lora_worker_phase``: a ``--lora`` worker on a checkpoint
  behind a kv frontend, /v1/models listing the adapters, the adapter and
  the base request aggregate and SSE equal to the in-process engine.
- ``chip_smoke.disagg_phase`` on a checkpoint (``model_source``) against
  ``checkpoint_reference``, made while the workers start: the path phases
  11-14 take at the cut depth.
"""

from __future__ import annotations

import asyncio
import os
import shutil

import pytest
import torch

import chip_smoke as C


@pytest.fixture(autouse=True, scope="module")
def _one_thread_everywhere():
    """One intra-op thread here and in every spawned process (they inherit
    the environment): float32 sums round alike in the reference and the
    workers whatever else the host runs."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def checkpoint():
    path, name, _host, size, _s = C.write_checkpoint("test-tiny", 2, device="cpu",
                                                     dtype="float32")
    assert name == C.cut_config("test-tiny", 2).name == os.path.basename(path) and size > 0
    yield path
    shutil.rmtree(path, ignore_errors=True)


def test_lora_phase_on_the_cpu():
    res = asyncio.run(C.lora_phase("CPU", preset="test-tiny", device="cpu", dtype="float32"))
    for name in ("mixed", "mixed_depth0", "base_only", "tree", "grammar"):
        assert res[name]["launches"] == (0, 0, 0)
    assert res["mixed"]["pageins"] >= len(C.LORA_ADAPTERS) and res["mixed"]["evictions"] >= 1
    assert res["mixed"]["slot_waits"] >= 1 and res["mixed"]["slot_wait_s"] > 0
    assert res["mixed"]["g2_hits"] >= len(C.LORA_ADAPTERS)
    assert res["base_only"]["pageins"] == 0 and res["tree"]["tree_passes"] > 0
    assert set(res["reference"]) == {*C.LORA_CHECK_ROWS, 0}
    assert all(r["max_logprob_delta"] <= C.LORA_LP_TOL["float32"]
               for r in res["reference"].values())
    assert len(res["reference_controls"]) == 2
    assert all(r["max_logprob_delta"] > C.LORA_LP_TOL["float32"]
               for r in res["reference_controls"].values())
    # 4 slots x 2 layers x rank 16 x (q 128+128, k 128+64, v 128+64, o 128+128) x f32
    assert res["bank_bytes"] == 4 * 2 * 16 * 896 * 4


def test_lora_worker_phase_on_the_cpu(checkpoint):
    res = C.lora_worker_phase("CPU", checkpoint, device="cpu", dtype="float32")
    assert res["models"] == sorted([os.path.basename(checkpoint),
                                    *(n for n, _r, _s in C.LORA_ADAPTERS)])
    assert res["launches"] == 0 and res["counters_lora"]["pageins"] >= 1
    assert set(res["exit_codes"].values()) == {0}


def test_disagg_phase_on_a_checkpoint(checkpoint):
    """As main() runs it: the reference made by a function, while the
    workers start."""
    made = []

    def reference():
        made.append(asyncio.run(C.checkpoint_reference(checkpoint, device="cpu",
                                                       dtype="float32")))
        return made[-1]

    res = C.disagg_phase("CPU", reference, device="cpu", dtype="float32",
                         model_path=checkpoint)
    assert sorted(made[0]["repeats"]) == C.REMOTE and len(made[0]["burst"]) == 8
    assert res["launches"] == (0, 0, 0)
    assert [t["prompt_tokens"] for t in res["transfers"]] == [768, 1024, 1280, 1536]
    assert set(res["exit_codes"].values()) == {0}
