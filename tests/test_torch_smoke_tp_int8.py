"""chip_smoke.py's phase 4t int8 leg rehearsed on the CPU: int8 weights and
pages from a test-tiny checkpoint both ranks of a ``--tp 2`` worker load
(2 layers here, ``CUT_LAYERS`` of llama-8b on the card), held as
tests/test_torch_smoke_tp.py holds the bf16 leg, against the burst in
process at tp 1 on the same checkpoint (``burst_reference``, run while the
worker starts)."""

from __future__ import annotations

import asyncio

import chip_smoke as C

from test_torch_smoke_tp import _check


def test_tp_phase_int8_on_the_cpu(tmp_path):
    path, *_ = C.write_checkpoint("test-tiny", 2, device="cpu", dtype="float32",
                                  root=str(tmp_path))
    weights = ["--model-path", path, "--tokenizer", "byte"]
    st = C.tp_phase("CPU", lambda: asyncio.run(C.burst_reference(
        weights, device="cpu", dtype="float32", quant="int8", kv_quant="int8")),
        device="cpu", dtype="float32", quant="int8", kv_quant="int8", model_path=path)
    _check(st, 2)
