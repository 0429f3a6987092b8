"""chip_smoke.py's phase 4t int8 leg rehearsed on the CPU: int8 weights and
pages from a test-tiny checkpoint both ranks of a ``--tp 2`` worker load
(2 layers here, ``CUT_LAYERS`` of llama-8b on the card), with an adapter
bank and two adapters (``TP_ADAPTERS``), held as
tests/test_torch_smoke_tp.py holds the bf16 leg, against the burst in
process at tp 1 on the same checkpoint with the same adapters
(``burst_reference``, run while the worker starts): the burst as it is,
then with half its rows under an adapter, whose base rows equal the first
burst's bit for bit, both ranks counting the same LoRA-variant windows."""

from __future__ import annotations

import asyncio

import chip_smoke as C

from test_torch_smoke_tp import _check


def test_tp_phase_int8_on_the_cpu(tmp_path):
    path, *_ = C.write_checkpoint("test-tiny", 2, device="cpu", dtype="float32",
                                  root=str(tmp_path))
    weights = ["--model-path", path, "--tokenizer", "byte"]
    st = C.tp_phase("CPU", lambda: asyncio.run(C.burst_reference(
        weights, device="cpu", dtype="float32", quant="int8", kv_quant="int8", lora=True)),
        device="cpu", dtype="float32", quant="int8", kv_quant="int8", model_path=path,
        lora=True)
    _check(st, 2)
    lora = st["lora"]
    greedy = [i for i, t in enumerate(C.BURST_TEMPS) if t == 0.0]
    assert len(lora["greedy_equal"]) + len(lora["gaps"]) == len(greedy)
    assert lora["base_rows_equal_plain"] == [0, 2, 4, 6]
    assert lora["adapter_rows_differ"] == [1, 3, 5, 7]
    assert lora["launches"] == [0, 0] and lora["substeps"] > 0
    assert lora["lora_windows"][0] == lora["lora_windows"][1] > 0
    assert lora["uploads"] == len(C.TP_ADAPTERS)
