"""CUDA int8-weight product vs its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file
imports neither jax nor dynamo_tpu, so on the machine with the card it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int8_matmul_cuda.py

Inputs and tolerances are chip_smoke.py's (``int8_case``, ``int8_check``,
``TOL_INT8``): unit normals for x, uniform int8 weights, positive scales,
the plain version evaluated in float32 on the same values. bf16 x of more
than 8 rows (aligned shapes) takes the wide entry, the rest the decode
kernel (``route``); a tied ``emb.T`` of bf16 x takes the tied wgmma entry
at every row count; each test counts the launches of the route it expects.
"""

from __future__ import annotations

import pytest
import torch

from chip_smoke import INT8_SHAPES, TIED_HEADS, int8_case, int8_check, int8_tied_case
from dynamo_tpu_torch.ops import int8_matmul as im

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


ODD = [(128, 512), (256, 128), (1000, 200), (64, 48), (136, 40), (4096, 1008)]
# bf16 at every llama-8b shape and the odd ones; f32 (test-tiny on the card)
# at the odd ones and wk/wv.
CASES = ([(K, N, "bfloat16") for K, N, _ in INT8_SHAPES.values()]
         + [(K, N, dt) for K, N in ODD + [(4096, 1024)] for dt in ("bfloat16", "float32")])


def _counts():
    return im.launches, im.wide_launches, im.prefill_launches, im.tied_launches


def _want(before, which, calls=2):
    i = {"kernel": 0, "wide": 1, "prefill": 2, "tied": 3}[which]
    return tuple(b + (calls if j == i else 0) for j, b in enumerate(before))


@pytest.mark.parametrize("K,N,xdt", CASES)
def test_kernel_matches_plain_over_m(dev, K, N, xdt):
    for M in (1, 2, 7, 8, 9, 16, 31, 33, 64):
        x, w, s = int8_case(M, K, N, xdt, M, dev)
        which = im.route(x, w)
        assert which == ("wide" if M > 8 and xdt == "bfloat16" and K % 8 == 0 and N % 16 == 0
                         else "kernel")
        before = _counts()
        int8_check(x, w, s, False, f"{K}x{N} M={M} {xdt}")
        assert _counts() == _want(before, which)  # int8_check calls the wrapper twice


WIDE = [(K, N) for K, N, _ in INT8_SHAPES.values()] + [(128, 512), (256, 128), (64, 48),
                                                        (4096, 1008), (136, 16)]


@pytest.mark.parametrize("K,N", WIDE)
def test_wide_entry_matches_plain_over_m(dev, K, N):
    """Every row tile, the edges between them, and rows past 256 (grid z
    walks several tiles), layer and logits epilogues."""
    for M in (9, 64, 128, 255, 256, 257, 300, 513):
        if N > 100_000 and M > 300:
            continue
        x, w, s = int8_case(M, K, N, "bfloat16", M, dev)
        assert im.route(x, w) == "wide"
        for out_f32 in (False, True) if N in (128256, 1008) else (False,):
            before = _counts()
            int8_check(x, w, s, out_f32, f"wide {K}x{N} M={M} f32 out {out_f32}")
            assert _counts() == _want(before, "wide")


def test_wide_blocks_per_sm_are_the_plans(dev):
    for tile in im.WIDE_ROW_TILES:
        assert im.wide_blocks_per_sm(tile) == im.WIDE_BLOCKS_PER_SM


@pytest.mark.parametrize("M", [32, 300])
def test_wide_graph_replay_equals_eager_and_leading_dims(dev, M):
    x, w, s = int8_case(M, 4096, 1024, "bfloat16", 16, dev, "bfloat16")
    eager = im.int8_matmul(x, w, s)
    for _ in range(2):
        assert torch.equal(im.int8_matmul(x, w, s), eager)
    b = im.int8_matmul(x.reshape(M // 4, 4, 4096), w, s)
    assert b.shape == (M // 4, 4, 1024) and torch.equal(b.reshape(M, 1024), eager)
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        im.int8_matmul(static_x, w, s)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = im.int8_matmul(static_x, w, s)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2, _, _ = int8_case(M, 4096, 1024, "bfloat16", 17, dev)
    static_x.copy_(x2)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, im.int8_matmul(x2, w, s))


@pytest.mark.parametrize("scale_dt", ["float32", "bfloat16"])
def test_logits_epilogue(dev, scale_dt):
    for xdt in ("bfloat16", "float32"):
        x, w, s = int8_case(8, 512, 1000, xdt, 3, dev, scale_dt)
        int8_check(x, w, s, True, f"logits {xdt} scale {scale_dt}")


def test_layer_epilogue_rounds_as_the_plain_version(dev):
    """bf16 x: the kernel's output is the plain version's rounding of an
    f32 sum; with small K (exact f32 sums) the two agree bit for bit."""
    x, w, s = int8_case(8, 64, 256, "bfloat16", 4, dev, "bfloat16")
    x = torch.randint(-8, 9, x.shape, device=dev).to(torch.bfloat16)  # exact f32 sums
    out = im.int8_matmul(x, w, s)
    ref = ((x.float() @ w.float()).to(torch.bfloat16).float()
           * s.float()).to(torch.bfloat16)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("scale_dt", ["float32", "bfloat16"])
def test_wide_epilogues_round_as_the_plain_version(dev, scale_dt):
    """The wide entry with exact f32 sums (small K, small integers): layer
    outputs and logits bit-equal to the plain version's rounding points."""
    x, w, s = int8_case(40, 64, 256, "bfloat16", 14, dev, scale_dt)
    x = torch.randint(-8, 9, x.shape, device=dev).to(torch.bfloat16)
    acc = (x.float() @ w.float()).to(torch.bfloat16).float()
    assert torch.equal(im.int8_matmul(x, w, s),
                       (acc * s.to(torch.bfloat16).float()).to(torch.bfloat16))
    assert torch.equal(im.int8_matmul(x, w, s, out_f32=True), acc * s.float())


def test_repeats_and_leading_dims(dev):
    x, w, s = int8_case(12, 4096, 1024, "bfloat16", 5, dev)
    a = im.int8_matmul(x, w, s)
    for _ in range(3):
        assert torch.equal(im.int8_matmul(x, w, s), a)
    b = im.int8_matmul(x.reshape(3, 4, 4096), w, s)
    assert b.shape == (3, 4, 1024) and torch.equal(b.reshape(12, 1024), a)


def test_graph_replay_equals_eager(dev):
    x, w, s = int8_case(8, 4096, 4096, "bfloat16", 6, dev)
    eager = im.int8_matmul(x, w, s)
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        im.int8_matmul(static_x, w, s)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = im.int8_matmul(static_x, w, s)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2, _, _ = int8_case(8, 4096, 4096, "bfloat16", 7, dev)
    static_x.copy_(x2)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, im.int8_matmul(x2, w, s))


def test_cuda_tensors_never_reach_the_plain_version(dev, monkeypatch):
    calls = []
    monkeypatch.setattr(im, "int8_matmul_ref", lambda *a, **k: calls.append(a))
    c0 = _counts()
    x, w, s = int8_case(8, 512, 256, "bfloat16", 8, dev)
    im.int8_matmul(x, w, s)  # 8 rows: the decode kernel
    assert _counts() == _want(c0, "kernel", 1)
    c0 = _counts()
    for M in (9, 64, 65, 2048):  # more rows of bf16 x: the wide entry, at any count
        big, _, _ = int8_case(M, 512, 256, "bfloat16", 9, dev)
        assert im.int8_matmul(big, w, s).shape == (M, 256)
    assert _counts() == _want(c0, "wide", 4)
    c0 = _counts()
    xf, _, _ = int8_case(64, 512, 256, "float32", 10, dev)
    im.int8_matmul(xf, w, s)  # f32 x: the decode kernel up to 64 rows
    bigf, _, _ = int8_case(65, 512, 256, "float32", 11, dev)
    assert im.int8_matmul(bigf, w, s).shape == (65, 256)  # then the prefill route
    assert _counts() == (c0[0] + 1, c0[1], c0[2] + 1, c0[3])
    c0 = _counts()
    emb = torch.randint(-127, 128, (256, 512), device=dev, dtype=torch.int8)
    x64, _, _ = int8_case(64, 512, 256, "bfloat16", 12, dev)
    im.int8_matmul(x64, emb.T, s, out_f32=True)  # the tied [V, D] layout: its own entry
    assert _counts() == _want(c0, "tied", 1)
    big, _, _ = int8_case(65, 512, 256, "bfloat16", 13, dev)
    im.int8_matmul(big, emb.T, s, out_f32=True)  # more than 64 rows: the tied wgmma entry
    assert im.route(big, emb.T) == "tied_wide"
    assert _counts() == _want(c0, "tied", 2)
    assert calls == []
    with pytest.raises(ValueError):
        im.int8_matmul(x, w.float(), s)


# The tied head: w = emb.T of an [N, K] int8 embedding (llama-1b's and
# llama-3b's heads, and odd shapes that break 16-byte rows and the 256-row
# blocks), every decode row count, f32 logits and bf16 layer outputs.
TIED = [(K, N) for K, N in TIED_HEADS.values()] + [(1000, 200), (64, 48), (4096, 1000)]


@pytest.mark.parametrize("K,N", TIED)
@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
def test_tied_head_matches_plain_over_m(dev, K, N, xdt):
    for M in (1, 2, 7, 8, 9, 16, 33, 64):
        x, wt, s = int8_tied_case(M, K, N, xdt, M, dev)
        before = _counts()
        int8_check(x, wt, s, True, f"tied {K}x{N} M={M} {xdt}")
        assert _counts() == _want(before, "tied")


def test_tied_head_layer_epilogue_and_bf16_scale(dev):
    x, wt, s = int8_tied_case(8, 512, 1000, "bfloat16", 11, dev, "bfloat16")
    int8_check(x, wt, s, False, "tied layer epilogue, bf16 scale")
    x = torch.randint(-8, 9, x.shape, device=dev).to(torch.bfloat16)  # exact f32 sums
    ref = ((x.float() @ wt.float()).to(torch.bfloat16).float() * s.float()).to(torch.bfloat16)
    assert torch.equal(im.int8_matmul(x, wt, s), ref)


def test_tied_head_graph_replay_equals_eager(dev):
    K, N = TIED_HEADS["llama-3b"]
    x, wt, s = int8_tied_case(8, K, N, "bfloat16", 12, dev)
    eager = im.int8_matmul(x, wt, s, out_f32=True)
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        im.int8_matmul(static_x, wt, s, out_f32=True)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = im.int8_matmul(static_x, wt, s, out_f32=True)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# The tied wgmma entry: llama-3b's and llama-1b's heads and an embedding
# whose rows end mid-tile, every row tile and the edges between them, rows
# past 256 (several row tiles of 128 or 256 per column tile) and 513.
TIED_WIDE = [TIED_HEADS["llama-3b"], TIED_HEADS["llama-1b"], (4096, 1000)]
TIED_WIDE_M = (1, 8, 9, 16, 17, 63, 64, 65, 128, 129, 256, 257, 512, 513)


@pytest.mark.parametrize("K,N", TIED_WIDE)
def test_tied_wide_entry_matches_plain_over_m(dev, K, N):
    for M in TIED_WIDE_M:
        x, wt, s = int8_tied_case(M, K, N, "bfloat16", M, dev)
        assert im.route(x, wt) == "tied_wide"
        for out_f32 in (True, False) if N < 100_000 or M in (8, 128) else (True,):
            before = _counts()
            int8_check(x, wt, s, out_f32, f"tied wgmma {K}x{N} M={M} f32 out {out_f32}")
            assert _counts() == _want(before, "tied")  # twice, bit-identical


@pytest.mark.parametrize("scale_dt", ["float32", "bfloat16"])
def test_tied_wide_epilogues_and_scales(dev, scale_dt):
    """Both epilogues with an f32 and a bf16 scale; with exact f32 sums
    (small K, small integers) bit-equal to the plain version's rounding
    points."""
    for M in (5, 40, 300):
        x, wt, s = int8_tied_case(M, 2048, 1000, "bfloat16", 20 + M, dev, scale_dt)
        for out_f32 in (True, False):
            int8_check(x, wt, s, out_f32, f"tied wgmma M={M} scale {scale_dt} f32 out {out_f32}")
        x, wt, s = int8_tied_case(M, 64, 200, "bfloat16", 30 + M, dev, scale_dt)
        x = torch.randint(-8, 9, x.shape, device=dev).to(torch.bfloat16)
        acc = (x.float() @ wt.float()).to(torch.bfloat16).float()
        assert torch.equal(im.int8_matmul(x, wt, s),
                           (acc * s.to(torch.bfloat16).float()).to(torch.bfloat16))
        assert torch.equal(im.int8_matmul(x, wt, s, out_f32=True), acc * s.float())


def test_tied_blocks_per_sm_are_the_plans(dev):
    for tile in im.TIED_ROW_TILES:
        assert im.tied_blocks_per_sm(tile) == im.TIED_BLOCKS_PER_SM


@pytest.mark.parametrize("M", [8, 128, 257])
def test_tied_wide_graph_replay_equals_eager(dev, M):
    K, N = TIED_HEADS["llama-3b"]
    x, wt, s = int8_tied_case(M, K, N, "bfloat16", 40 + M, dev)
    eager = im.int8_matmul(x, wt, s, out_f32=True)
    for _ in range(2):
        assert torch.equal(im.int8_matmul(x, wt, s, out_f32=True), eager)
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        im.int8_matmul(static_x, wt, s, out_f32=True)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = im.int8_matmul(static_x, wt, s, out_f32=True)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2, _, _ = int8_tied_case(M, K, N, "bfloat16", 50 + M, dev)
    static_x.copy_(x2)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, im.int8_matmul(x2, wt, s, out_f32=True))
