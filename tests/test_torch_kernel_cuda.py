"""CUDA paged-attention kernel vs its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file
imports neither jax nor dynamo_tpu, so on the machine with the card it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Cases and tolerances are chip_smoke.py's (``make_case``, ``plain_f32``,
``TOL``): unit-scale normals from a seeded numpy generator, NaN in every
position past a row's walk and in every page no row owns, and the plain
version evaluated in float32 on the kernel's input values.
"""

from __future__ import annotations

import pytest
import torch

from chip_smoke import TOL, make_case, plain_f32
from dynamo_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CASES = [
    ("decode", "float32", False),
    ("decode", "bfloat16", False),
    ("decode", "bfloat16", True),
    ("decode", "float32", True),
    ("linear", "bfloat16", False),
    ("linear", "float32", False),
    ("tree", "bfloat16", False),
    ("tree", "bfloat16", True),
    ("tree", "float32", False),
]


@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("mode,qdt,quant", CASES)
def test_kernel_matches_plain(dev, mode, qdt, quant, hd):
    args = make_case(mode, qdt, quant, 7, dev, [0, 1, 15, 16, 17, 45], KVH=2, hd=hd)["args"]
    before = pa.launches
    out = pa.paged_spec_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    ref = plain_f32(args)
    assert out.dtype == getattr(torch, qdt) and out.shape == ref.shape
    assert torch.isfinite(out).all() and torch.isfinite(ref).all()
    assert float(out[0].abs().max()) == 0.0  # dead row
    atol, rtol = TOL[qdt]
    excess = (out.float() - ref).abs() - rtol * ref.abs()
    assert float(excess.max()) <= atol, (mode, qdt, quant, hd, float(excess.max()))


def _check(args, qdt, dead_row=None):
    before = pa.launches
    out = pa.paged_spec_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1  # split kernel + merge count as one
    ref = plain_f32(args)
    assert out.dtype == getattr(torch, qdt) and out.shape == ref.shape
    assert torch.isfinite(out).all() and torch.isfinite(ref).all()
    if dead_row is not None:
        assert float(out[dead_row].abs().max()) == 0.0
    atol, rtol = TOL[qdt]
    excess = (out.float() - ref).abs() - rtol * ref.abs()
    assert float(excess.max()) <= atol, float(excess.max())
    return out


CHUNK = pa.split_plan(1, 1, 1, 128, 1024, 16).chunk  # positions per split block at bs 16


@pytest.mark.parametrize("mode,qdt,quant", CASES)
def test_kernel_chunk_edges(dev, mode, qdt, quant):
    """Rows whose walk is exactly one chunk, exactly two, and one chunk
    plus one position (linear and tree rows walk hist + T)."""
    extra = 0 if mode == "decode" else 5
    hist = [CHUNK - extra, 2 * CHUNK - extra, CHUNK + 1 - extra, 0]
    args = make_case(mode, qdt, quant, 21, dev, hist, KVH=2)["args"]
    _check(args, qdt, dead_row=3)


@pytest.mark.parametrize("mode,qdt,quant", CASES)
def test_kernel_wide_table_short_rows(dev, mode, qdt, quant):
    """A 4096-position table (256 pages) holding only short rows: most
    splits are empty, and the table's unused entries name NaN pages."""
    args = make_case(mode, qdt, quant, 22, dev, [3, 0, 17, 40], KVH=2, width=4096 // 16)["args"]
    assert pa.split_plan(4, 2, 5, 128, 4096 // 16, 16).splits == 4096 // CHUNK
    _check(args, qdt, dead_row=1)


@pytest.mark.parametrize("qdt,quant", [("bfloat16", False), ("bfloat16", True), ("float32", False)])
def test_kernel_tree_slots_straddle_chunks(dev, qdt, quant):
    """Tree rows whose five in-flight slots cross a chunk boundary."""
    hist = [CHUNK - 2, 2 * CHUNK - 4, CHUNK - 5, CHUNK - 1]
    args = make_case("tree", qdt, quant, 23, dev, hist, KVH=2)["args"]
    _check(args, qdt)


@pytest.mark.parametrize("mode,qdt,quant,T,G", [
    ("linear", "bfloat16", False, 5, 8), ("tree", "bfloat16", False, 5, 8),
    ("tree", "bfloat16", True, 5, 8), ("linear", "float32", False, 5, 8),
    ("tree", "float32", True, 5, 8), ("linear", "bfloat16", False, 64, 2),
    ("linear", "float32", False, 64, 2), ("decode", "bfloat16", False, 1, 8),
])
def test_kernel_many_query_columns(dev, mode, qdt, quant, T, G):
    """G = 8 (llama-70b's grouping) and T*G > 16: several m-tiles and
    several query passes per KV head."""
    args = make_case(mode, qdt, quant, 24, dev, [0, 30, CHUNK + 9, 600], T=T, G=G, KVH=2)["args"]
    _check(args, qdt, dead_row=0)


@pytest.mark.parametrize("mode,qdt,quant", CASES)
def test_kernel_repeat_calls_bit_identical(dev, mode, qdt, quant):
    """The merge adds in a fixed order: two calls give the same bits."""
    args = make_case(mode, qdt, quant, 25, dev, [0, 7, 300, 1024, 2047], KVH=2)["args"]
    a = pa.paged_spec_attention(*args)
    b = pa.paged_spec_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_main_path_shape_decode(dev):
    """llama-8b decode geometry: B=8, KVH=8, G=4, hd=128, bs=16."""
    args = make_case("decode", "bfloat16", False, 11, dev, [0, 1, 15, 16, 17, 300, 1024, 2047])["args"]
    q = args[0][:, 0]
    out = pa.paged_decode_attention(q, *args[1:4], args[4], args[5][:, 0])
    ref = plain_f32(args)[:, 0]
    torch.cuda.synchronize()
    atol, rtol = TOL["bfloat16"]
    assert float(((out.float() - ref).abs() - rtol * ref.abs()).max()) <= atol


def test_wrapper_rejects_bad_operands(dev):
    args = make_case("decode", "float32", False, 3, dev, [0, 5], KVH=2, G=2, hd=64)["args"]
    q, kc, vc, layer, tables, lengths = args[:6]
    with pytest.raises(ValueError):
        pa.paged_spec_attention(q.to(torch.float16), kc, vc, layer, tables, lengths)
    with pytest.raises(ValueError):
        pa.paged_spec_attention(q, kc, vc, layer, tables.long(), lengths)
    with pytest.raises(ValueError):
        pa.paged_spec_attention(q, kc.bfloat16(), vc.bfloat16(), layer, tables, lengths)
    with pytest.raises(ValueError):
        pa.paged_spec_attention(q, kc, vc, 5, tables, lengths)
