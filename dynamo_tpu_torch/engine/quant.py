"""Weight-only int8 quantization (port of ``dynamo_tpu/engine/quant.py``).

Decode streams every matmul weight once per substep, so storing them as
int8 with per-output-channel scales halves its bytes. The format is the
JAX package's: ``w_int8 [in, out]`` plus ``<name>_scale [out]`` leaves in
the same tree; the embedding table carries a scale per vocabulary row
(``embed_scale [V]``), the untied head one per output (``lm_head_scale
[V]``). Norms and biases stay in the compute dtype, and so do a MoE
model's router and expert stacks, as in the JAX package (its random int8
init refuses MoE, as the JAX ones do).

The host functions are numpy and bit-exact with the JAX package's (round
half to even, all-zero channels get scale 1.0, clip to ±127). The
products run in ``ops/int8_matmul.py``: on the card a kernel that reads
each int8 weight once, never a bf16 copy of it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# Leaves quantized along their OUTPUT channel (last axis).
_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_np(w: np.ndarray, axis: int = -1) -> tuple[np.ndarray, np.ndarray]:
    """→ (int8 weights, float32 per-channel scales) with symmetric
    absmax scaling along ``axis``'s complement (scale per output slice)."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    absmax = np.max(np.abs(w), axis=reduce_axes)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    shape = [1] * w.ndim
    shape[axis % w.ndim] = -1
    q = np.clip(np.rint(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale


def quantize_layer_stacks_np(layers: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Quantize the stacked [L, in, out] layer weights: a new dict with
    int8 leaves + ``<name>_scale`` [L, out]."""
    out = dict(layers)
    for name in _LAYER_WEIGHTS:
        if name not in layers:
            continue
        w = np.asarray(layers[name], np.float32)  # [L, in, out]
        absmax = np.max(np.abs(w), axis=1)        # [L, out]
        scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        out[name] = np.clip(np.rint(w / scale[:, None, :]), -127, 127).astype(np.int8)
        out[name + "_scale"] = scale
    return out


def quantize_params_np(params: dict[str, Any]) -> dict[str, Any]:
    """Host-side quantization of a full (numpy) params tree."""
    out = dict(params)
    out["layers"] = quantize_layer_stacks_np(
        {k: np.asarray(v) for k, v in params["layers"].items()}
    )
    emb_q, emb_s = quantize_np(np.asarray(params["embed"]), axis=0)  # scale per vocab row
    out["embed"] = emb_q
    out["embed_scale"] = emb_s
    if "lm_head" in params:
        q, s = quantize_np(np.asarray(params["lm_head"]), axis=-1)   # [D, V] → scale per V
        out["lm_head"] = q
        out["lm_head_scale"] = s
    return out


def quantize_to_device(w, reduce_dim: int, device: torch.device, slice_dim: int,
                       rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_np``'s int8 weights and float32 scales of a host tensor
    (scale per slice along every dim but ``reduce_dim``), computed on
    ``device`` ``rows`` indices of ``slice_dim`` at a time: only one
    slice's full-precision copy is ever there. Bit-equal to the host
    function: float32 absmax, IEEE division, round half to even."""
    w = torch.as_tensor(w)
    q = torch.empty(w.shape, dtype=torch.int8, device=device)
    scale = torch.empty([n for i, n in enumerate(w.shape) if i != reduce_dim],
                        dtype=torch.float32, device=device)
    scale_dim = slice_dim - (reduce_dim < slice_dim)
    for a in range(0, w.shape[slice_dim], rows):
        m = min(rows, w.shape[slice_dim] - a)
        x = w.narrow(slice_dim, a, m).to(device).float()
        absmax = x.abs().amax(dim=reduce_dim, keepdim=True)
        # A tensor divisor: CUDA divides by a Python scalar as a product
        # with its reciprocal, which is not IEEE division.
        s = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
        q.narrow(slice_dim, a, m).copy_(torch.round(x / s).clamp_(-127, 127))
        scale.narrow(scale_dim, a, m).copy_(s.squeeze(reduce_dim))
    return q, scale


def quantize_params_device(params: dict[str, Any], device: torch.device) -> dict[str, Any]:
    """``quantize_params_np`` of a host params tree, computed on ``device``
    (layer by layer, the embedding and head in row chunks) → the tree with
    int8 weights and float32 scales on ``device``, every other leaf as it
    was. Quantizing on the card saves the host its passes over a float32
    copy of the model."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_WEIGHTS:
        if name in layers:
            layers[name], layers[name + "_scale"] = quantize_to_device(layers[name], 1, device,
                                                                       0, 1)
    out["layers"] = layers
    out["embed"], out["embed_scale"] = quantize_to_device(params["embed"], 1, device, 0, 8192)
    if "lm_head" in params:
        out["lm_head"], out["lm_head_scale"] = quantize_to_device(params["lm_head"], 0, device,
                                                                  1, 8192)
    return out


def _int8_layer_specs(cfg) -> dict[str, tuple[tuple, int]]:
    """name → (stacked shape, fan_in) for the quantized layer matmuls."""
    d, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    return {
        "wq": ((L, d, cfg.q_size), d), "wk": ((L, d, cfg.kv_size), d),
        "wv": ((L, d, cfg.kv_size), d), "wo": ((L, cfg.q_size, d), cfg.q_size),
        "w_gate": ((L, d, i), d), "w_up": ((L, d, i), d), "w_down": ((L, i, d), i),
    }


def random_int8_params_device(cfg, device: torch.device, seed: int = 0,
                              dtype: torch.dtype = torch.bfloat16, shard=None) -> dict[str, Any]:
    """Random int8 params made on ``device`` (no host upload), from a
    ``torch.Generator`` there seeded with ``seed``. The tree has the JAX
    package's ``random_int8_params_device`` leaves, shapes and dtypes:
    int8 weights, f32 scales ``[L, out]``, f32 ``embed_scale [V]`` and
    ``lm_head_scale [V]``, norms (and biases) in ``dtype``, which makes it
    the forward's compute dtype. The values are torch's draws, not jax's
    threefry bits: nothing compares them across packages, and decode time
    does not depend on weight values. With ``shard`` (a
    ``parallel.mesh.ModelSharding``) each leaf is drawn whole, in the same
    order, and only the rank's shard is kept: tp ranks hold tp=1's
    weights."""
    if getattr(cfg, "num_experts", 0):
        raise NotImplementedError("int8 random init not wired for MoE configs")
    g = torch.Generator(device=device).manual_seed(seed)
    d, L = cfg.hidden_size, cfg.num_layers

    def keep(path, a):
        return a if shard is None else shard.shard_leaf(path, a)

    def q(shape, fan_in):
        w = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
        s = torch.full((shape[-1],), (fan_in ** -0.5) / 64.0, dtype=torch.float32, device=device)
        return w, s

    layers: dict[str, torch.Tensor] = {}
    for name, (shape, fan) in _int8_layer_specs(cfg).items():
        w, s = q(shape, fan)
        layers[name] = keep(("layers", name), w)
        layers[name + "_scale"] = keep(("layers", name + "_scale"),
                                       s.expand(L, shape[-1]).contiguous())
        del w
    layers["attn_norm"] = torch.ones((L, d), dtype=dtype, device=device)
    layers["mlp_norm"] = torch.ones((L, d), dtype=dtype, device=device)
    if cfg.attn_bias:
        for name, width in (("bq", cfg.q_size), ("bk", cfg.kv_size), ("bv", cfg.kv_size)):
            b = torch.randn((L, width), generator=g, device=device, dtype=torch.float32)
            layers[name] = keep(("layers", name), (b * 0.02).to(dtype))
    params: dict[str, Any] = {
        "embed": keep(("embed",), torch.randint(-127, 128, (cfg.vocab_size, d), generator=g,
                                                device=device, dtype=torch.int8)),
        "embed_scale": keep(("embed_scale",), torch.full(
            (cfg.vocab_size,), (d ** -0.5) / 64.0, dtype=torch.float32, device=device)),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        w, s = q((d, cfg.vocab_size), d)
        params["lm_head"] = keep(("lm_head",), w)
        params["lm_head_scale"] = keep(("lm_head_scale",), s)
    return params
