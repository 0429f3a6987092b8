"""The port's tensor-parallel forwards against the JAX package's with int8
weights (``quantize_params_np``) and int8 KV pages: tests/test_torch_tp_forward.py's
scenario, ranks and references. The bound is ``TOL_INT8`` = 2e-3 + 2e-3·|x|,
the bound tests/test_torch_model.py holds the one-process int8 forward to
(a value within float error of a rounding midpoint may quantize one step
apart), and int8 pages agree to one step.
"""

from __future__ import annotations

import numpy as np
import pytest

from dynamo_tpu_torch.engine.config import ModelConfig as TCfg

from test_torch_tp_forward import _compare, references_for
from torch_tp_ranks import port_forward_rank, run_ranks


@pytest.fixture(scope="module")
def references():
    return references_for("int8")


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_int8_forwards_match_jax(references, tp):
    quant, np_params, inp, refs = references
    outs = run_ranks(port_forward_rank, tp, np_params, TCfg(), tp, quant, inp)
    for k in ("prefill", "window_0", "linear_0", "tree_0", "embed"):
        for other in outs[1:]:
            np.testing.assert_array_equal(outs[0][k], other[k], err_msg=k)
    _compare(outs[0], refs[1], quant)
    _compare(outs[0], refs[tp], quant)
