"""CUDA int8-weight product vs its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file
imports neither jax nor dynamo_tpu, so on the machine with the card it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int8_matmul_cuda.py

Inputs and tolerances are chip_smoke.py's (``int8_case``, ``int8_check``,
``TOL_INT8``): unit normals for x, uniform int8 weights, positive scales,
the plain version evaluated in float32 on the same values.
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


@pytest.mark.parametrize("K,N,xdt", CASES)
def test_kernel_matches_plain_over_m(dev, K, N, xdt):
    for M in (1, 2, 7, 8, 9, 16, 31, 33, 64):
        x, w, s = int8_case(M, K, N, xdt, M, dev)
        before = im.launches
        int8_check(x, w, s, False, f"{K}x{N} M={M} {xdt}")
        assert im.launches == before + 2  # int8_check calls the kernel twice


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
    k0, p0 = im.launches, im.prefill_launches
    x, w, s = int8_case(64, 512, 256, "bfloat16", 8, dev)
    im.int8_matmul(x, w, s)
    assert (im.launches, im.prefill_launches) == (k0 + 1, p0)
    big, _, _ = int8_case(65, 512, 256, "bfloat16", 9, dev)
    y = im.int8_matmul(big, w, s)
    assert (im.launches, im.prefill_launches) == (k0 + 1, p0 + 1)
    assert y.shape == (65, 256)
    t0 = im.tied_launches
    emb = torch.randint(-127, 128, (256, 512), device=dev, dtype=torch.int8)
    im.int8_matmul(x, emb.T, s, out_f32=True)  # the tied [V, D] layout: its own entry
    assert (im.launches, im.prefill_launches, im.tied_launches) == (k0 + 1, p0 + 1, t0 + 1)
    im.int8_matmul(big, emb.T, s, out_f32=True)  # more than 64 rows: the prefill route
    assert (im.prefill_launches, im.tied_launches) == (p0 + 2, t0 + 1)
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
        before = (im.launches, im.prefill_launches, im.tied_launches)
        int8_check(x, wt, s, True, f"tied {K}x{N} M={M} {xdt}")
        assert (im.launches, im.prefill_launches, im.tied_launches) == (
            before[0], before[1], before[2] + 2)


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
