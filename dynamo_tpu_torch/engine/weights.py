"""Carry parameters between the JAX package's pytree and the port.

Both packages use the same nested-dict layout (``embed``, ``layers``
{``wq`` [L, d, q], …}, ``final_norm``, ``lm_head``), so a param tree
exported to numpy loads as it is. numpy has no bfloat16 of its own: an
array whose dtype is named "bfloat16" (as jax exports them) is carried
bit for bit through an int16 view.

Casting follows the tree's own compute dtype, the dtype of
``layers.attn_norm`` (the forward computes in it, as in the JAX package):
only floating leaves of that dtype are cast to the requested dtype. Every
other leaf keeps the dtype the tree gives it, so an int8 tree's int8
weights stay int8 and its f32 ``*_scale`` leaves stay f32 beside bf16
norms, as the JAX package's int8 trees hold them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(a: np.ndarray, device: torch.device, dtype: torch.dtype,
               cast_from: np.dtype | None) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy (jax exports are read-only)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if a.dtype == cast_from if cast_from is not None else t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _map(tree: Any, device: torch.device, dtype: torch.dtype, cast_from) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, device, dtype, cast_from) for k, v in tree.items()}
    return _to_tensor(np.asarray(tree), device, dtype, cast_from)


def params_from_numpy(tree: Any, device: torch.device | str, dtype: torch.dtype) -> Any:
    """Nested dict of numpy arrays → the same tree of tensors on ``device``;
    leaves of the tree's compute dtype (``layers.attn_norm``'s) cast to
    ``dtype``, every other leaf kept as it is. A tree without that leaf
    casts every floating leaf."""
    norm = tree.get("layers", {}).get("attn_norm") if isinstance(tree, dict) else None
    cast_from = np.asarray(norm).dtype if norm is not None else None
    return _map(tree, torch.device(device), dtype, cast_from)


def params_to_numpy(params: Any) -> Any:
    """Inverse of ``params_from_numpy`` (bfloat16 widens exactly to f32)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
