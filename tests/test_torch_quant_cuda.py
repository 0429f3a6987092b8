"""The loader's int8 quantization on the card against the host quantizer.

Needs an NVIDIA GPU and skips elsewhere; imports neither jax nor
dynamo_tpu, so on the machine with the card it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quant_cuda.py

``finalize_params(quant="int8")`` on the card quantizes one layer slice at
a time there (``quantize_params_device``); every leaf must equal
``quantize_params_np`` of the same float32 values bit for bit, half-way
ties and all-zero channels included, with the same placement (int8
weights, scales and norms in the serving dtype).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.loader import finalize_params
from dynamo_tpu_torch.engine.quant import quantize_params_np

pytestmark = pytest.mark.cuda


def _awkward(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0
    w[..., 1] = 0.0
    w[..., 1].flat[0] = 127.0
    w[..., 1].flat[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    return w


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_card_quantizer_equals_the_host(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    L, D, I, V = 3, 256, 512, 20000
    tree = {"embed": _awkward(rng, (D, V)).T.copy(), "lm_head": _awkward(rng, (D, V)),
            "final_norm": np.ones((D,), np.float32),
            "layers": {"wq": _awkward(rng, (L, D, D)), "wk": _awkward(rng, (L, D, 128)),
                       "wv": _awkward(rng, (L, D, 128)), "wo": _awkward(rng, (L, D, D)),
                       "w_gate": _awkward(rng, (L, D, I)), "w_up": _awkward(rng, (L, D, I)),
                       "w_down": _awkward(rng, (L, I, D)),
                       "attn_norm": np.ones((L, D), np.float32),
                       "mlp_norm": np.ones((L, D), np.float32)}}
    host = {k: ({kk: torch.from_numpy(vv).to(getattr(torch, dtype)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v).to(getattr(torch, dtype)))
            for k, v in tree.items()}
    want = quantize_params_np({k: ({kk: vv.float().numpy() for kk, vv in v.items()}
                                   if isinstance(v, dict) else v.float().numpy())
                               for k, v in host.items()})
    got = finalize_params(host, dtype=dtype, quant="int8", device="cuda")
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for key, leaf in g.items():
        assert leaf.device.type == "cuda"
        exp = torch.from_numpy(np.ascontiguousarray(w[key]))
        if leaf.dtype != torch.int8:
            exp = exp.to(leaf.dtype)
            assert leaf.dtype == getattr(torch, dtype), key
        assert torch.equal(leaf.cpu(), exp), key
