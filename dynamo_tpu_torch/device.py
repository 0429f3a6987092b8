"""Device selection for the port: CUDA by default, the CPU only on request.

There is no silent fallback anywhere in the port: a caller that does not
ask for the CPU gets the card or a clear error.
"""

from __future__ import annotations

import torch


def resolve_device(requested: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) → that CUDA device, raising when no
    card is visible; ``"cpu"`` → the CPU (tests, debugging)."""
    dev = torch.device(requested)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {requested!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {requested!r} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev
