"""On-device sampling (port of ``dynamo_tpu/engine/sampler.py``).

Three modes, chosen host-side per batch as the JAX engine does:

- "greedy": argmax, no noise;
- "simple": greedy / temperature via the Gumbel-max trick
  (``sample_simple``); no sort;
- "full": frequency/presence penalties over the generated tokens plus
  exact top-k and top-p (nucleus) over a full descending sort
  (``token_counts``, ``apply_penalties``, ``sample_step``).

The noise is jax's: ``row_gumbel`` draws ``gumbel(fold_in(PRNGKey(seed),
step))`` per row with the port's threefry (``engine/threefry.py``) from
device tensors, so a seeded request samples the same tokens as in the
JAX package whatever batch it rides in, and the draw needs no host call
(a CUDA graph captures it). ``sample_simple`` and ``sample_step`` take the
noise as an argument, so tests can feed both packages the same numbers.

Temperature <= 0 means greedy (argmax) for that row in every mode.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.engine import threefry

GREEDY_EPS = 1e-5


def row_gumbel(seeds: torch.Tensor, steps: torch.Tensor, V: int) -> torch.Tensor:
    """Per-row Gumbel noise [B, V] float32 from (seed, emission index)
    integer tensors [B] on the device that the noise is wanted on."""
    return threefry.gumbel(threefry.fold_in(threefry.prng_key(seeds), steps), V)


def sample_simple(
    logits: torch.Tensor,       # [B, V] f32
    temperature: torch.Tensor,  # [B] f32
    gumbel: torch.Tensor,       # [B, V] f32 noise
) -> torch.Tensor:
    greedy = temperature < GREEDY_EPS
    temp = torch.where(greedy, torch.ones_like(temperature), temperature)
    noisy = torch.where(greedy[:, None], logits, logits / temp[:, None] + gumbel)
    return torch.argmax(noisy, dim=-1).to(torch.int32)


def token_counts(penalty_tokens: torch.Tensor, V: int) -> torch.Tensor:
    """[B, L] generated ids (-1 pad) → [B, V] f32 occurrence counts."""
    valid = penalty_tokens >= 0
    safe = torch.where(valid, penalty_tokens, 0).long()
    counts = torch.zeros((penalty_tokens.shape[0], V), dtype=torch.float32,
                         device=penalty_tokens.device)
    return counts.scatter_add_(1, safe, valid.float())


def apply_penalties(
    logits: torch.Tensor,        # [B, V] f32
    counts: torch.Tensor,        # [B, V] f32 occurrence counts of generated ids
    freq_penalty: torch.Tensor,  # [B] f32
    pres_penalty: torch.Tensor,  # [B] f32
) -> torch.Tensor:
    """OpenAI frequency/presence penalties over generated tokens."""
    logits = logits - freq_penalty[:, None] * counts
    return logits - pres_penalty[:, None] * (counts > 0).float()


def sample_step(
    logits: torch.Tensor,       # [B, V] f32 (penalties already applied)
    temperature: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,        # [B] int, 0 = off
    top_p: torch.Tensor,        # [B] f32, 1.0 = off
    gumbel: torch.Tensor,       # [B, V] f32 noise
) -> torch.Tensor:
    """Exact top-k + top-p (nucleus) + temperature + Gumbel-max: the core
    of the full sampler and of the fused window's "full" mode. The sort is
    stable, so equal values keep index order as ``lax.top_k`` does."""
    greedy = temperature < GREEDY_EPS
    temp = torch.where(greedy, torch.ones_like(temperature), temperature)
    scaled = logits / temp[:, None]
    V = logits.shape[1]
    svals, sidx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    ranks = torch.arange(V, dtype=torch.int64, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, V, top_k.long())[:, None]
    keep_k = ranks < k
    probs = torch.softmax(svals, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    # nucleus: keep tokens whose preceding cumulative mass < top_p
    keep_p = cum_before < top_p[:, None]
    keep = keep_k & keep_p
    keep[:, 0] = True  # never mask the argmax
    masked = torch.where(keep, svals, torch.full_like(svals, float("-inf")))
    noise = torch.gather(gumbel, 1, sidx)
    pick = torch.argmax(torch.where(greedy[:, None], masked, masked + noise), dim=-1)
    return torch.gather(sidx, 1, pick[:, None])[:, 0].to(torch.int32)


def sample_full(
    logits: torch.Tensor,          # [B, V] f32
    temperature: torch.Tensor,     # [B] f32
    top_k: torch.Tensor,           # [B] int, 0 = off
    top_p: torch.Tensor,           # [B] f32, 1.0 = off
    penalty_tokens: torch.Tensor,  # [B, L] int previously generated ids, -1 pad
    freq_penalty: torch.Tensor,    # [B] f32
    pres_penalty: torch.Tensor,    # [B] f32
    gumbel: torch.Tensor,          # [B, V] f32 noise
) -> torch.Tensor:
    counts = token_counts(penalty_tokens, logits.shape[1])
    logits = apply_penalties(logits, counts, freq_penalty, pres_penalty)
    return sample_step(logits, temperature, top_k, top_p, gumbel)


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
