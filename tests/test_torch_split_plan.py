"""The CUDA paged-attention kernel's split plan, on the CPU.

``split_plan`` is pure Python: it decides how many blocks walk each row
(one per chunk of whole pages) and how large the partials' scratch is,
from host-known shapes only. The kernel itself runs on the card
(tests/test_torch_kernel_cuda.py).
"""

from __future__ import annotations

import inspect

import pytest

from dynamo_tpu_torch.ops import paged_attention as pa


@pytest.mark.parametrize("W,bs,chunk_pages,splits", [
    (128, 16, 8, 16),     # llama-8b decode at max_model_len 2048
    (100, 16, 8, 13),     # a burst window's table
    (8, 16, 8, 1),        # the table fits one chunk: no merge
    (1, 16, 8, 1),
    (9, 16, 8, 2),        # one page past a chunk
    (256, 16, 8, 32),     # W*bs = 4096
    (32, 4, 32, 1),       # test-tiny block size
    (33, 4, 32, 2),
    (9, 48, 2, 5),        # a block size that does not divide the chunk
    (3, 512, 1, 3),       # pages longer than the chunk: one page per split
    (300, 1, 128, 3),     # one-position pages
])
def test_split_plan_counts(W, bs, chunk_pages, splits):
    plan = pa.split_plan(8, 8, 4, 128, W, bs)
    assert (plan.chunk_pages, plan.splits) == (chunk_pages, splits)
    assert plan.chunk == chunk_pages * bs
    # The chunks tile the table: the last one starts inside it.
    assert (plan.splits - 1) * plan.chunk < W * bs <= plan.splits * plan.chunk
    assert 1 <= plan.chunk_pages <= pa.MAX_CHUNK_PAGES


@pytest.mark.parametrize("B,KVH,nq,hd", [(8, 8, 4, 128), (3, 2, 20, 64), (1, 1, 128, 256)])
def test_split_plan_scratch_shapes(B, KVH, nq, hd):
    plan = pa.split_plan(B, KVH, nq, hd, 128, 16)
    assert plan.acc_shape == (B, KVH, plan.splits, nq, hd)
    assert plan.ml_shape == (B, KVH, plan.splits, nq, 2)
    one = pa.split_plan(B, KVH, nq, hd, 8, 16)
    assert one.splits == 1 and one.acc_shape is None and one.ml_shape is None


def test_split_plan_takes_no_lengths():
    """The grid comes from shapes alone (no host sync on device lengths)."""
    assert list(inspect.signature(pa.split_plan).parameters) == ["B", "KVH", "nq", "hd", "W", "bs"]


@pytest.mark.parametrize("rowlen", [0, 1, 255, 256, 257, 512, 2047, 2048])
def test_split_plan_live_chunks_cover_row(rowlen):
    """Every position of a row's walk falls in exactly one live split, and
    a walk of at most one chunk needs no merge."""
    plan = pa.split_plan(1, 1, 1, 128, 128, 16)
    live = [s for s in range(plan.splits) if s * plan.chunk < rowlen]
    covered = [p for s in live for p in range(s * plan.chunk, min((s + 1) * plan.chunk, rowlen))]
    assert covered == list(range(rowlen))
    assert len(live) == -(-rowlen // plan.chunk)
    assert (len(live) <= 1) == (rowlen <= plan.chunk)
