"""Ring attention: attention with the sequence split over a ring of rank
processes, the long-context prefill primitive (port of
``dynamo_tpu/ops/ring_attention.py``).

Each of the n ranks of the group's "ring" axis (``parallel.comm``) keeps
its query chunk and passes (k, v) chunks around the ring with the
neighbour exchange (``TpGroup.ppermute_start``, the JAX ``lax.ppermute``),
accumulating online-softmax partials in f32. The exchange of the next
chunk starts before the step's math and is waited for after it, so the
transfer overlaps the math (under NCCL on the communication stream; under
gloo on the host's transfer threads).

Causality over the ring: the rank holding query chunk i takes kv chunks
j < i whole, chunk j = i under the local causal mask, and chunks j > i
fully masked; the ``NEG_INF``/``m_safe``/``corr`` guards keep a fully
masked step from adding anything to the accumulators.

Memory: each rank holds T/n of q, k, v and one chunk in flight. Neither
engine calls it. The math is plain torch einsums, as the reference's is
XLA: this module adds no kernel.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ring_attention_local(group, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """One rank's chunk: q [Tc, H, hd] (roped), k, v [Tc, KVH, hd] (roped
    k), the rank's place on the ring fixing their global positions. GQA (H
    a multiple of KVH). → [Tc, H, hd] in q's dtype."""
    Tc, H, hd = q.shape
    KVH = k.shape[1]
    G = H // KVH
    n, me = group.axis_size("ring"), group.axis_rank("ring")
    scale = hd ** -0.5
    qg = q.reshape(Tc, KVH, G, hd)
    local = torch.arange(Tc, device=q.device)
    q_pos = me * Tc + local  # global positions of this rank's queries
    m = torch.full((Tc, KVH, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((Tc, KVH, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((Tc, KVH, G, hd), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        # The next chunk's exchange, in flight during this step's math; the
        # last step's would bring back the rank's own chunk, unread.
        nxt = group.ppermute_start([k_cur, v_cur]) if i < n - 1 else None
        src = (me - i) % n  # the rank whose kv chunk is in hand
        kv_pos = src * Tc + local
        s = torch.einsum("tkgh,skh->tkgs", qg, k_cur).float() * scale
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]  # [Tc, Tc]
            s = torch.where(mask[:, None, None, :], s, NEG_INF)
        m_cur = s.amax(dim=-1)                         # [Tc, KVH, G]
        m_new = torch.maximum(m, m_cur)
        # A fully masked step contributes nothing; keep m finite so the
        # correction exp() stays well defined.
        m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(s == NEG_INF, 0.0, p)
        corr = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - m_safe))
        l = corr * l + p.sum(dim=-1)
        pv = torch.einsum("tkgs,skh->tkgh", p.to(v_cur.dtype), v_cur)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
        if nxt is not None:
            k_cur, v_cur = nxt.wait()
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(Tc, H, hd).to(q.dtype)


def ring_prefill(group, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True) -> torch.Tensor:
    """Attention of a long sequence split over the ring of ``group`` (a
    ``parallel.comm.TpGroup``): q [T, H, hd], k, v [T, KVH, hd], the whole
    sequence on every rank; each rank attends its contiguous chunk and the
    chunks are gathered in rank order. → [T, H, hd] on every rank, as the
    JAX global array reads. T must divide evenly by the ring's size."""
    n, me = group.axis_size("ring"), group.axis_rank("ring")
    T = q.shape[0]
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by {n} ring ranks")
    Tc = T // n
    chunk = slice(me * Tc, (me + 1) * Tc)
    out = ring_attention_local(group, q[chunk], k[chunk], v[chunk], causal=causal)
    return group.all_gather(out, "ring", dim=0)
