"""Carry parameters between the JAX package's pytree and the port.

Both packages use the same nested-dict layout (``embed``, ``layers``
{``wq`` [L, d, q], …}, ``final_norm``, ``lm_head``), so a param tree
exported to numpy loads as it is. numpy has no bfloat16 of its own: an
array whose dtype is named "bfloat16" (as jax exports them) is carried
bit for bit through an int16 view.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(a: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy (jax exports are read-only)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device: torch.device | str, dtype: torch.dtype) -> Any:
    """Nested dict of numpy arrays → the same tree of tensors on ``device``;
    floating arrays cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _to_tensor(np.asarray(tree), torch.device(device), dtype)


def params_to_numpy(params: Any) -> Any:
    """Inverse of ``params_from_numpy`` (bfloat16 widens exactly to f32)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
