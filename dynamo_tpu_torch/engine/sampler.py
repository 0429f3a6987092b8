"""On-device sampling (port of the "greedy"/"simple" half of
``dynamo_tpu/engine/sampler.py``).

``sample_simple`` is greedy / temperature sampling by the Gumbel-max
trick. It takes its noise as an argument, so tests can feed the port and
the JAX package the same numbers. ``row_gumbel`` draws each row's noise
from a Philox ``torch.Generator`` (on CUDA; the CPU generator is
Mersenne Twister) seeded by (request seed, emission index), so a seeded
request is reproducible whatever batch it rides in. It does not
reproduce jax's threefry bits: seeded sampled streams differ between the
two packages until that generator is ported.

Temperature <= 0 means greedy (argmax) for that row. Requests that need
the full sampler (penalties, exact top-k/top-p) are refused by the
engine for now (``row_needs_full``).
"""

from __future__ import annotations

import torch

GREEDY_EPS = 1e-5


def _mix64(x: int) -> int:
    """splitmix64 finalizer, kept to 63 bits: every input bit reaches the
    low bits (the CPU generator keeps only the low 32 bits of its seed)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & 0x7FFFFFFFFFFFFFFF


def row_gumbel(seeds, steps, V: int, device: torch.device) -> torch.Tensor:
    """Per-row Gumbel noise [B, V] f32 from (seed, step) host ints."""
    out = torch.empty((len(seeds), V), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for b, (seed, step) in enumerate(zip(seeds, steps)):
        g = torch.Generator(device=device).manual_seed(
            _mix64(((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
        )
        u = torch.rand((V,), generator=g, device=device, dtype=torch.float32)
        out[b] = -torch.log(-torch.log(u.clamp_min(tiny)))
    return out


def sample_simple(
    logits: torch.Tensor,       # [B, V] f32
    temperature: torch.Tensor,  # [B] f32
    gumbel: torch.Tensor,       # [B, V] f32 noise
) -> torch.Tensor:
    greedy = temperature < GREEDY_EPS
    temp = torch.where(greedy, torch.ones_like(temperature), temperature)
    noisy = torch.where(greedy[:, None], logits, logits / temp[:, None] + gumbel)
    return torch.argmax(noisy, dim=-1).to(torch.int32)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-probability of each row's chosen token: [B, V], [B] → [B]."""
    logz = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    return chosen - logz


def top_k_logprobs(logits: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-n alternative logprobs of the raw model distribution:
    [B, V] → (logprobs [B, n], token ids [B, n] int32), most likely first."""
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    vals, ids = torch.topk(logits, n, dim=-1)
    return vals - logz, ids.to(torch.int32)


def row_needs_full(top_k, top_p, freq_penalty, pres_penalty) -> bool:
    """Does one request's sampling config need the full sampler?"""
    return bool(
        (top_k and top_k > 0)
        or (top_p is not None and top_p < 1.0)
        or freq_penalty
        or pres_penalty
    )
