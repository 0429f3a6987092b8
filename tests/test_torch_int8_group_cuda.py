"""The int8 decode entry and its group call against the plain version, on
the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file
imports neither jax nor dynamo_tpu, so on the machine with the card it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int8_group_cuda.py

Inputs and tolerances are chip_smoke.py's (``int8_case``, ``int8_check``,
``TOL_INT8``). Aligned bf16 x of 1-8 rows takes the decode entry: one
kernel a product or a group of products that share x, its split of K
reduced inside a thread-block cluster (``cluster_plan``). Each test counts
the products (``launches``) and the kernels (``decode_launches``) it
expects.
"""

from __future__ import annotations

import pytest
import torch

from chip_smoke import INT8_SHAPES, INT8_TP_SHAPES, TOL_INT8, int8_case, int8_check
from dynamo_tpu_torch.ops import int8_matmul as im

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# Every llama-8b decode product, a tp=2 rank's shards, and odd widths: N a
# multiple of 16 but not of 128 (a partial column block), K not a multiple
# of 128 (a partial k tile) and K short of one tile.
SHAPES = ([(name, K, N) for name, (K, N, _) in {**INT8_SHAPES, **INT8_TP_SHAPES}.items()]
          + [("odd_n", 4096, 1008), ("odd_k", 1000, 256), ("short_k", 64, 48)])


def _counts():
    return im.launches, im.decode_launches


@pytest.mark.parametrize("name,K,N", SHAPES)
def test_decode_entry_matches_plain_over_m(dev, name, K, N):
    for M in range(1, 9):
        x, w, s = int8_case(M, K, N, "bfloat16", M, dev)
        assert im.route(x, w) == "kernel" and im.decode_entry(x, w)
        before = _counts()
        int8_check(x, w, s, name.endswith("lm_head"), f"{name} M={M}")
        assert _counts() == (before[0] + 2, before[1] + 2)  # int8_check calls twice


def _group(dev, M, dims, seed, scale_dt=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, dims[0][0]), generator=g, device=dev).to(torch.bfloat16)
    return x, [(torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
                (torch.rand((N,), generator=g, device=dev) * 0.02 + 1e-3).to(scale_dt))
               for K, N in dims]


def _within_tol(out, x, w, s):
    rtol, c = TOL_INT8["bfloat16"]
    ref = im.int8_matmul_ref(x.float(), w, s.float(), out_f32=True)
    absref = (x.float().abs() @ w.float().abs()) * s.float().abs()
    return float(((out.float() - ref).abs() - rtol * ref.abs() - c * absref).max()) <= 0


S, T = INT8_SHAPES, INT8_TP_SHAPES
GROUPS = {
    "qkv": [S["wq_wo"][:2], S["wk_wv"][:2], S["wk_wv"][:2]],
    "gate_up": [S["w_gate_up"][:2]] * 2,
    "tp2_qkv": [T["tp2_wq"][:2], T["tp2_wk_wv"][:2], T["tp2_wk_wv"][:2]],
    "tp2_gate_up": [T["tp2_w_gate_up"][:2]] * 2,
    "five_odd": [(1000, 1008), (1000, 16), (1000, 256), (1000, 48), (1000, 128)],
}


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_group_matches_plain_and_repeats_bit_for_bit(dev, name):
    dims = GROUPS[name]
    for M in range(1, 9):
        x, ws = _group(dev, M, dims, 10 + M, torch.bfloat16 if M == 3 else torch.float32)
        before = _counts()
        outs = im.int8_matmul_group(x, ws)
        again = im.int8_matmul_group(x, ws)
        torch.cuda.synchronize()
        kernels = 2 * -(-len(ws) // im.DECODE_MAX_GROUP)
        assert _counts() == (before[0] + 2 * len(ws), before[1] + kernels)
        for o, a, (w, s) in zip(outs, again, ws):
            assert o.shape == (M, w.shape[1]) and o.dtype == torch.bfloat16
            assert torch.equal(o, a)
            assert _within_tol(o, x, w, s), f"{name} M={M} {tuple(w.shape)}"


def test_logits_epilogue_and_leading_dims(dev):
    x, ws = _group(dev, 6, [S["lm_head"][:2]], 3)
    w, s = ws[0]
    out = im.int8_matmul(x.reshape(2, 3, -1), w, s, out_f32=True)
    assert out.shape == (2, 3, w.shape[1]) and out.dtype == torch.float32
    assert _within_tol(out.reshape(6, -1), x, w, s)
    assert torch.equal(out.reshape(6, -1), im.int8_matmul(x, w, s, out_f32=True))


@pytest.mark.parametrize("scale_dt", ["float32", "bfloat16"])
def test_epilogues_round_as_the_plain_version(dev, scale_dt):
    """Exact f32 sums (small integers; K over several ranks): layer outputs
    and logits bit-equal to the plain version's rounding points."""
    for K in (64, 1024):
        x, w, s = int8_case(8, K, 256, "bfloat16", K, dev, scale_dt)
        x = torch.randint(-8, 9, x.shape, device=dev).to(torch.bfloat16)
        acc = (x.float() @ w.float()).to(torch.bfloat16).float()
        assert torch.equal(im.int8_matmul(x, w, s),
                           (acc * s.to(torch.bfloat16).float()).to(torch.bfloat16))
        assert torch.equal(im.int8_matmul(x, w, s, out_f32=True), acc * s.float())


@pytest.mark.parametrize("name", ["qkv", "gate_up"])
def test_group_graph_replay_equals_eager(dev, name):
    x, ws = _group(dev, 8, GROUPS[name], 21)
    eager = im.int8_matmul_group(x, ws)
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        im.int8_matmul_group(static_x, ws)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = im.int8_matmul_group(static_x, ws)
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, eager))
    x2, _ = _group(dev, 8, GROUPS[name], 22)
    static_x.copy_(x2)
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, im.int8_matmul_group(x2, ws)))


def test_aligned_small_rows_never_reach_the_split_k_kernel_or_plain(dev, monkeypatch):
    def refused(*a, **k):
        raise AssertionError("reached")

    monkeypatch.setattr(im, "int8_matmul_ref", refused)
    monkeypatch.setattr(im, "_launch", refused)
    for M in range(1, 9):
        for K, N, _ in INT8_SHAPES.values():
            x, w, s = int8_case(M, K, N, "bfloat16", M, dev)
            im.int8_matmul(x, w, s, out_f32=N > 100_000)
        x, ws = _group(dev, M, GROUPS["qkv"], M)
        im.int8_matmul_group(x, ws)
    torch.cuda.synchronize()
    # f32 x, and a shape TMA refuses, do take the split-K kernel.
    for x, w, s in (int8_case(8, 512, 256, "float32", 1, dev),
                    int8_case(8, 1000, 200, "bfloat16", 2, dev)):
        assert not im.decode_entry(x, w)
        with pytest.raises(AssertionError, match="reached"):
            im.int8_matmul(x, w, s)


def test_decode_blocks_per_sm_are_the_plans(dev):
    assert im.decode_blocks_per_sm() == im.DECODE_BLOCKS_PER_SM
