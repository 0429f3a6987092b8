"""The int8 product's routes and plans, and its plain version against the
JAX package, on the CPU.

- ``route``: M <= 8 rows take the decode kernel; 9 or more rows of bf16 x
  with w contiguous, K % 8 == 0, N % 16 == 0 and w 16-byte aligned take
  the wide entry, at any row count; f32 x and shapes the wide entry
  refuses take the decode kernel up to 64 rows and the prefill route
  above; the tied ``emb.T`` layout of bf16 x takes the tied wgmma entry at
  any row count (K % 16 == 0, a 16-byte aligned embedding), f32 x and the
  shapes it refuses the first tied entry up to 64 rows.
- ``tied_plan`` is a pure function of the shapes: the row tile is the
  smallest that holds M (past 256, 128 or 256, whichever pads fewer
  rows), the tiles cover the embedding's
  rows and x's rows exactly, one persistent block per SM at most walks
  them, and the tiles and blocks per SM are the source's ``TiedCfg``.
- ``wide_plan`` is a pure function of the shapes: the row tile is the
  smallest that holds M (256 past that), the row tiles cover M exactly,
  no split is empty, a split plan stays within one wave of the SMs at the
  tile's blocks per SM, and those blocks per SM are the source's
  ``WideCfg`` (the card tests read the built kernel's occupancy back).
- ``chip_smoke.int8_expected`` against the calls a bf16 ``TorchEngine``
  really makes, route by route, for three prompt sets, decode buckets 8
  and 32 included.
- ``int8_matmul_ref`` (what a CPU tensor takes) against JAX ``_dot_q``
  and the int8 ``_logits`` head at M = 9, 64, 128 and 300 rows. float32:
  1e-5 (absolute and relative; the summation order of one product
  differs). bfloat16: both round ``x @ w`` to bfloat16 before the scale,
  and the two sums, taken in different orders, may round one bfloat16
  step apart, so 2^-7 relative plus 1e-6 absolute.
"""

from __future__ import annotations

import asyncio
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as C
from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine import quant as JQ
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.ops import int8_matmul as im

CPU = torch.device("cpu")
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}
LLAMA_8B = [(K, N) for K, N, _ in C.INT8_SHAPES.values()]
PLAN_M = [9, 63, 64, 65, 255, 256, 257, 2048]


def _w(K, N, misalign=0):
    buf = torch.zeros(K * N + misalign, dtype=torch.int8)
    return buf[misalign:].view(K, N)


# -- the route rule ---------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 5, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_up_to_eight_rows_take_the_decode_kernel(M, dtype):
    for K, N, mis in ((4096, 4096, 0), (1000, 200, 0), (4096, 1024, 1)):
        assert im.route(torch.zeros((M, K), dtype=dtype), _w(K, N, mis)) == "kernel"


@pytest.mark.parametrize("M", [9, 16, 33, 64, 65, 128, 255, 256, 257, 2048])
def test_more_rows_of_aligned_bf16_take_the_wide_entry(M):
    for K, N in LLAMA_8B + [(128, 48), (4096, 1008)]:
        x = torch.zeros((M, K), dtype=torch.bfloat16)
        assert im.route(x, _w(K, N)) == "wide"
    # leading dimensions count as rows
    assert im.route(torch.zeros((M, 1, 128), dtype=torch.bfloat16), _w(128, 64)) == "wide"


@pytest.mark.parametrize("M", [9, 64, 65, 300])
def test_f32_and_unaligned_shapes_keep_todays_routes(M):
    want = "kernel" if M <= im.MAX_M else "prefill"
    assert im.route(torch.zeros((M, 4096)), _w(4096, 1024)) == want  # f32 x
    bf = lambda K: torch.zeros((M, K), dtype=torch.bfloat16)  # noqa: E731
    assert im.route(bf(1004), _w(1004, 1024)) == want  # K % 8
    assert im.route(bf(4096), _w(4096, 200)) == want  # N % 16
    assert im.route(bf(4096), _w(4096, 1024, misalign=1)) == want  # w's address


@pytest.mark.parametrize("M", [8, 9, 64, 65, 128, 257])
def test_tied_head_and_other_layouts(M):
    emb = torch.zeros((1000, 256), dtype=torch.int8)
    x = torch.zeros((M, 256), dtype=torch.bfloat16)
    assert im.route(x, emb.T) == "tied_wide"
    # f32 x, K % 16, a misaligned embedding: the first tied entry up to 64 rows
    small = "tied" if M <= im.MAX_M else "prefill"
    assert im.route(x.float(), emb.T) == small
    assert im.route(torch.zeros((M, 200), dtype=torch.bfloat16),
                    torch.zeros((1000, 200), dtype=torch.int8).T) == small  # K % 16
    misaligned = torch.zeros(1000 * 256 + 1, dtype=torch.int8)[1:].view(1000, 256)
    assert im.route(x, misaligned.T) == small
    # any other layout: the prefill route at every row count
    assert im.route(x, torch.zeros((256, 64), dtype=torch.int8)[:, ::2]) == "prefill"


TIED_SHAPES = [tuple(C.TIED_HEADS[h]) for h in sorted(C.TIED_HEADS)] + [(4096, 1000), (64, 48)]


@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 63, 64, 65, 128, 129, 256, 257, 513, 2048])
@pytest.mark.parametrize("K,N", TIED_SHAPES)
def test_tied_plan_covers_the_rows_and_the_embedding(M, K, N):
    tile, row_tiles, blocks, per_block = im.tied_plan(M, N)
    assert tile in im.TIED_ROW_TILES
    if M <= im.TIED_ROW_TILES[-1]:
        assert tile == min(t for t in im.TIED_ROW_TILES if t >= M) and row_tiles == 1
    else:  # 256 or 128 past 256 rows, whichever pads fewer
        pad = {t: -(-M // t) * t - M for t in (128, 256)}
        assert tile == (128 if pad[128] < pad[256] else 256)
    assert (row_tiles - 1) * tile < M <= row_tiles * tile
    tiles = -(-N // im.TIED_BN) * row_tiles
    assert 1 <= blocks <= min(tiles, im.SMS * im.TIED_BLOCKS_PER_SM)
    assert (per_block - 1) * blocks < tiles <= per_block * blocks  # every tile walked once
    assert im.tied_plan(M, N) == (tile, row_tiles, blocks, per_block)


def test_tied_plan_follows_the_source():
    src = (Path(im.__file__).parent / "csrc" / "int8_matmul.cu").read_text()
    tiles = tuple(sorted(int(nr) for nr in re.findall(
        r"struct TiedCfg<(\d+)> \{ static constexpr int STAGES = \d+; \};", src)))
    assert tiles == im.TIED_ROW_TILES
    consts = dict(re.findall(r"constexpr int (TW_BN|TW_BK|TW_BLOCKS_PER_SM) = (\d+);", src))
    assert (int(consts["TW_BN"]), int(consts["TW_BK"]), int(consts["TW_BLOCKS_PER_SM"])) == (
        im.TIED_BN, im.TIED_BK, im.TIED_BLOCKS_PER_SM)
    # llama-3b's head: 1,002 tiles of 128 rows on 132 persistent blocks
    assert im.tied_plan(8, 128256) == (8, 1, 132, 8)
    assert im.tied_plan(128, 128256) == (128, 1, 132, 8)
    assert im.tied_plan(257, 128256) == (128, 3, 132, 23)
    assert im.tied_plan(384, 128256) == (128, 3, 132, 23)
    assert im.tied_plan(512, 128256) == (256, 2, 132, 16)
    assert im.tied_plan(8, 32000) == (8, 1, 132, 2)
    assert im.tied_plan(1, 48) == (8, 1, 1, 1)


# -- the wide entry's plan ----------------------------------------------------------


@pytest.mark.parametrize("M", PLAN_M)
def test_wide_plan_covers_the_rows_and_splits_k(M):
    for K, N in LLAMA_8B + [(128, 48), (14336, 16), (64, 4096)]:
        tile, row_tiles, splits = im.wide_plan(M, K, N)
        assert tile in im.WIDE_ROW_TILES
        if M <= im.WIDE_ROW_TILES[-1]:
            assert tile == min(t for t in im.WIDE_ROW_TILES if t >= M) and row_tiles == 1
        else:
            assert tile == im.WIDE_ROW_TILES[-1]
        assert (row_tiles - 1) * tile < M <= row_tiles * tile
        tiles = -(-K // im.WIDE_BK)
        per = -(-tiles // splits)
        assert 1 <= splits <= tiles and (splits - 1) * per < tiles  # no empty split
        blocks = -(-N // im.WIDE_BN) * row_tiles
        if splits > 1:
            assert blocks * splits <= im.SMS * im.WIDE_BLOCKS_PER_SM
        assert im.wide_plan(M, K, N) == (tile, row_tiles, splits)


def test_wide_plan_follows_the_sources_blocks_per_sm():
    src = (Path(im.__file__).parent / "csrc" / "int8_matmul.cu").read_text()
    tiles = tuple(sorted(int(nr) for nr in re.findall(
        r"struct WideCfg<(\d+)> \{ static constexpr int STAGES = \d+; \};", src)))
    assert tiles == im.WIDE_ROW_TILES
    consts = dict(re.findall(r"constexpr int (W_BN|W_BK|W_BLOCKS_PER_SM) = (\d+);", src))
    assert (int(consts["W_BN"]), int(consts["W_BK"]), int(consts["W_BLOCKS_PER_SM"])) == (
        im.WIDE_BN, im.WIDE_BK, im.WIDE_BLOCKS_PER_SM)
    # llama-8b decode products at bucket 32: one wave of one block per SM
    assert im.wide_plan(32, 4096, 14336) == (32, 1, 1)
    assert im.wide_plan(32, 4096, 1024) == (32, 1, 16)
    assert im.wide_plan(32, 14336, 4096) == (32, 1, 4)
    assert im.wide_plan(2048, 4096, 14336) == (256, 8, 1)


# -- chip_smoke's launch counts against the engine's calls --------------------------


PROMPT_SETS = {
    "burst": list(C.BURST_LENS),
    "short_and_long": [3, 7, 9, 16, 17, 40, 100, 250, 5, 64, 65, 31, 12, 1, 80, 33],
    "wide_batch": [int(n) for n in np.random.default_rng(3).integers(8, 160, 40)],
}


@pytest.mark.parametrize("name", sorted(PROMPT_SETS))
def test_int8_expected_counts_the_engines_calls_by_bucket(monkeypatch, name):
    lens = PROMPT_SETS[name]
    routes = {"kernel": 0, "prefill": 0, "wide": 0}
    real = im.int8_matmul

    def counting(x, w, scale, out_f32=False):
        routes[im.route(x, w)] += 1
        return real(x, w, scale, out_f32)

    monkeypatch.setattr(TM.im, "int8_matmul", counting)
    cfg = ModelConfig(tie_embeddings=False)
    eng = TorchEngine(EngineArgs(model=cfg, device="cpu", quant="int8", dtype="bfloat16",
                                 block_size=16, num_kv_blocks=1024, max_num_seqs=32,
                                 max_model_len=2048, decode_steps=4))
    rng = np.random.default_rng(7)

    async def go():
        from test_torch_pipeline import run_stream

        await eng.start()
        try:
            await asyncio.gather(*(run_stream(eng, {
                "model": "t", "token_ids": [int(t) for t in rng.integers(1, 500, n)],
                "sampling": {"temperature": 0.0 if i % 3 else 0.7, "seed": 50 + i},
                "stop": {"max_tokens": 6 + i % 5, "ignore_eos": True}})
                for i, n in enumerate(lens)))
        finally:
            await eng.stop()

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        asyncio.run(go())
    finally:
        torch.set_num_threads(n)
    by_bucket = dict(eng.decode_steps_by_bucket)
    assert sum(by_bucket.values()) == eng.total_decode_steps
    want = C.int8_expected(cfg, lens, eng.total_decode_steps, buckets=by_bucket)
    assert (routes["kernel"], routes["prefill"], routes["wide"]) == want
    if len(lens) > 8:
        assert 32 in by_bucket  # decode products of 32 rows: the wide entry


def test_verify_forwards_count_by_kind():
    assert C.verify_per_forward(32, True, True) == (32, 0, 0, 0, 225, 0)
    assert C.verify_per_forward(32, True, True, stepwise=True) == (32, 225, 0, 0, 0, 129)
    assert C.verify_per_forward(32, True, False) == (32, 0, 0, 0, 0, 0)
    assert C.verify_per_forward(32, False, True) == (0, 0, 0, 0, 0, 0)


# -- the plain version against the JAX package ---------------------------------------


@pytest.fixture(scope="module")
def int8_tree():
    jcfg = JCfg(tie_embeddings=False)
    tree = jax.tree.map(np.array, JM.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32))
    return jcfg, ModelConfig(tie_embeddings=False), JQ.quantize_params_np(tree)


@pytest.mark.parametrize("M", [9, 64, 128, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_dot_q_and_the_int8_head(int8_tree, M, dtype):
    jcfg, tcfg, q = int8_tree
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(M)
    jlp = {k: jnp.asarray(v[0]) for k, v in q["layers"].items()}
    for name in ("wq", "wk", "w_gate", "w_down"):
        K = q["layers"][name].shape[1]
        x = rng.standard_normal((M, K)).astype(np.float32)
        want = np.asarray(JM._dot_q(jnp.asarray(x, jdt), jlp, name).astype(jnp.float32))
        w = torch.from_numpy(np.ascontiguousarray(q["layers"][name][0]))
        s = torch.from_numpy(np.ascontiguousarray(q["layers"][name + "_scale"][0]))
        got = im.int8_matmul_ref(torch.from_numpy(x).to(tdt), w, s)
        assert got.dtype == tdt and got.shape == (M, w.shape[1])
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    x = rng.standard_normal((M, tcfg.hidden_size)).astype(np.float32)
    jpar = jax.tree.map(jnp.asarray, q)
    jpar = dict(jpar, final_norm=jpar["final_norm"].astype(jdt))
    tpar = params_from_numpy(q, CPU, torch.float32)
    tpar = dict(tpar, final_norm=tpar["final_norm"].to(tdt))
    want = np.asarray(JM._logits(jcfg, jpar, jnp.asarray(x, jdt)))
    got = TM._logits(tcfg, tpar, torch.from_numpy(x).to(tdt))  # int8_matmul_ref on the CPU
    assert got.dtype == torch.float32 and got.shape == (M, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
