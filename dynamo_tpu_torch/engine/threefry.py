"""Threefry-2x32 random numbers, bit-exact with ``jax.random``: the pieces
of it that the sampler's noise uses (``dynamo_tpu/engine/sampler.py``
``_row_gumbel``, ``model.py`` ``multi_decode_impl``:
``gumbel(fold_in(PRNGKey(seed), step), (V,))``).

Everything is tensor ops on the caller's device, with no host call and no
generator object, so a CUDA graph can capture it and a seeded request draws
the same noise on the card, on the CPU and in the JAX package.

The bit layout is jax 0.9's with ``jax_threefry_partitionable`` True (its
default) in 32-bit mode (also its default):

- ``PRNGKey(s)`` for a 32-bit seed is the key pair ``(0, s)``;
- ``fold_in(key, e)`` hashes the count pair ``(0, e)`` under ``key``; the
  two output words are the new key;
- ``random_bits(key, (V,))`` hashes the count pair ``(0, i)`` for each
  element ``i`` (the high and low words of a 64-bit iota) and XORs the two
  output words;
- ``uniform(minval=tiny, maxval=1)`` puts the top 23 bits in the mantissa
  of a float in [1, 2), subtracts 1, adds ``tiny`` and clamps at ``tiny``
  (speculative acceptance draws with ``minval=1e-12`` the same way);
- ``gumbel`` is ``-log(-log(u))`` of that uniform.

The bits are exact. The Gumbel values agree with jax's to one ulp of
max(|g|, 1): the two frameworks' float32 ``log`` differ in the last bit.

A key is a pair of tensors of 32-bit words. torch's ``uint32`` has few
operators on CUDA, so the words ride in ``int64`` tensors and every add
and shift is masked back to 32 bits.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000  # float32 1.0
_TINY = torch.finfo(torch.float32).tiny

Key = tuple[torch.Tensor, torch.Tensor]


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count pair (x0, x1) under
    ``key``. Key and counts are int64 tensors of 32-bit words, broadcast
    against each other; → the two output words, int64."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seeds: torch.Tensor) -> Key:
    """``PRNGKey(seed)`` per element of an integer tensor (32-bit seeds)."""
    seeds = seeds.long() & M32
    return torch.zeros_like(seeds), seeds


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``fold_in(key, data)``, elementwise over the key's shape."""
    data = data.long() & M32
    return threefry2x32(key, torch.zeros_like(data), data)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``random_bits(key, 32, (n,))`` for each key of a [B] batch →
    [B, n] int64 words."""
    idx = torch.arange(n, dtype=torch.int64, device=key[0].device)[None, :]
    b0, b1 = threefry2x32((key[0][:, None], key[1][:, None]), torch.zeros_like(idx), idx)
    return b0 ^ b1


def uniform(key: Key, n: int, minval: float = _TINY) -> torch.Tensor:
    """``uniform(key, (n,), float32, minval=minval, maxval=1.0)`` for each
    key of a [B] batch → [B, n] float32. For any ``minval`` below half a
    float32 ulp of 1 (the sampler's tiny and 1e-12), jax's scale
    ``maxval - minval`` rounds to 1, so the value is ``floats + minval``
    clamped at ``minval``."""
    fbits = ((random_bits(key, n) >> 9) | _ONE_BITS).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    return (floats + minval).clamp_min(minval)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``gumbel(key, (n,), float32)`` for each key of a [B] batch →
    [B, n] float32."""
    return -torch.log(-torch.log(uniform(key, n)))
