"""The port's prefill ladder and its worker flags against the JAX package's.

``EngineArgs.prefill_buckets``, ``bucket_prefill``, ``plan_prefill_chunks``
and ``bucket_prefill_rows`` are copies of the JAX package's: for every
swept spec ("fine", "coarse", comma lists), block size, tail-split setting
and suffix length up to ``max_prefill_tokens`` the two give the same
values and refuse the same inputs. ``LocalRunner.prefill_shapes`` (what
``warm_prefills`` captures) covers every (rows, T, W) the engine's
dispatch can make. The worker's ``--prefill-buckets`` and
``--no-prefill-tail-split`` parse into ``EngineArgs`` as the JAX worker's
do, and a bad spec stops the worker at start-up.
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys

import pytest

from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.worker import __main__ as JW
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.runner import LocalRunner
from dynamo_tpu_torch.worker import __main__ as TW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ("fine", "coarse", "64,128,384", "8,16,32", "5,17,33", "1000", " 48 , 24,,")
BAD_SPECS = ("", "abc", "0,16", "-8", "16,x", ",")


def _call(fn, *a):
    try:
        return ("ok", fn(*a))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec,bs,max_prefill,split,rows", [
    (spec, bs, mp, split, rows)
    for spec, bs, mp, split, rows in itertools.product(
        SPECS, (4, 16), (64, 2048), (True, False), (1, 3, 8))
    if not (mp == 2048 and rows == 3)
])
def test_ladder_equals_the_jax_package(spec, bs, max_prefill, split, rows):
    kw = dict(block_size=bs, max_prefill_tokens=max_prefill, max_model_len=4096,
              prefill_buckets_spec=spec, prefill_tail_split=split, prefill_batch_max=rows)
    port, ref = EngineArgs(**kw), JArgs(**kw)
    assert port.prefill_buckets == ref.prefill_buckets
    assert all(b % bs == 0 for b in port.prefill_buckets)
    for n in range(1, max_prefill + 2):
        assert _call(port.bucket_prefill, n) == _call(ref.bucket_prefill, n), n
    for n in range(1, max_prefill + 1):
        assert port.plan_prefill_chunks(n) == ref.plan_prefill_chunks(n), n
    for n in range(1, 2 * rows + 2):
        assert port.bucket_prefill_rows(n) == ref.bucket_prefill_rows(n), n


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_fail_at_construction_in_both(spec):
    with pytest.raises(ValueError) as port:
        EngineArgs(prefill_buckets_spec=spec)
    with pytest.raises(ValueError) as ref:
        JArgs(prefill_buckets_spec=spec)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("spec,bs,rows", [("fine", 4, 1), ("coarse", 16, 8), ("8,16,32", 4, 4),
                                          ("fine", 16, 2)])
def test_prefill_shapes_cover_every_dispatch(spec, bs, rows):
    """Every (rows, T, W) a packed dispatch or a chunk of the engine can
    take is in ``prefill_shapes``: rows the powers of two up to
    prefill_batch_max, a suffix of n tokens at T = bucket_prefill(n) in a
    table of any bucket that holds it."""
    args = EngineArgs(model=ModelConfig(), device="cpu", block_size=bs, max_model_len=256,
                      max_prefill_tokens=128, prefill_buckets_spec=spec, prefill_batch_max=rows)
    shapes = set(LocalRunner(args).prefill_shapes())
    want = set()
    for n in range(1, args.max_prefill_tokens + 1):
        for blocks in range(-(-n // bs), args.blocks_per_seq + 1):
            for b in (1, 2, 4, 8):
                if b <= rows:
                    want.add((b, args.bucket_prefill(n), args.bucket_table(blocks)))
    assert shapes == want


def _worker_args(argv):
    return TW.parse_args(["--device", "cpu", *argv])


@pytest.mark.parametrize("argv", [[], ["--prefill-buckets", "coarse"],
                                  ["--prefill-buckets", "64,128", "--no-prefill-tail-split"]])
def test_worker_flags_parse_into_engine_args(argv):
    tw = _worker_args(argv)
    jw = JW.parse_args(argv)
    port = TW.engine_args(tw, ModelConfig(), None)
    ref = JW._engine_args(jw, JArgs().model)
    assert (port.prefill_buckets_spec, port.prefill_tail_split) == (
        ref.prefill_buckets_spec, ref.prefill_tail_split)
    assert port.prefill_buckets == ref.prefill_buckets
    assert port.prefill_batch_max == ref.prefill_batch_max == 1
    assert port.transfer_buffer_bytes == ref.transfer_buffer_bytes
    assert port.enforce_eager is ref.enforce_eager is False


def test_bad_spec_stops_the_worker_at_start_up():
    with pytest.raises(SystemExit):
        _worker_args(["--prefill-buckets", "16,x"])
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.worker", "--device", "cpu", "--preset",
         "test-tiny", "--store-url", "tcp://127.0.0.1:1", "--prefill-buckets", "0,16"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "--prefill-buckets" in proc.stderr and "comma list of positive ints" in proc.stderr
