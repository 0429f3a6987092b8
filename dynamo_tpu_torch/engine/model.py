"""Llama-family forward with a paged KV cache, in PyTorch (port of
``dynamo_tpu/engine/model.py``).

Weights keep the JAX package's layout (``x @ w``; per-layer tensors
stacked on a leading layer axis: ``wq [L, d, q]``, ``w_down [L, i, d]``,
…), so carrying weights across is a plain copy (engine/weights.py).
Norms, rope, softmax and logits run in f32; activations and matmuls in
the compute dtype, which is the norms' dtype (``layers.attn_norm``), as in
the JAX package. With ``quant="int8"`` the matmul weights are int8 with
per-output-channel ``<name>_scale`` leaves (engine/quant.py); every product
goes through ``_dot_q`` → ``ops.int8_matmul``, q/k/v and gate/up as one
``ops.int8_matmul_group`` call each (``_dot_q_group``).

Cache layout: k, v each ``[L, num_blocks, block_size, KVH*head_dim]``;
with ``kv_quant="int8"`` the pages are int8 and per-position-per-head f32
scales ride ``[L, num_blocks, block_size, KVH]``. Block 0 is the garbage
sink — padded positions and inactive rows write there.

The JAX functions return an updated cache (the caller donates the old
one); here every write updates the cache tensors in place and the
functions return only the logits.

Multi-LoRA (the JAX package's Punica BGMV): with an adapter bank ``lora``
(``{qa..ob: [L, slots, ...]}``, engine/lora.py) and per-row
``adapter_slots`` (-1 = base), the q/k/v/o projections add each row's
low-rank delta (``_lora_apply``: a gather of the row's factors and two
batched products in the activation dtype, as plain tensor ops). Base rows
keep their projection values through a ``where``, never an add of zero,
so a base row in a mixed batch is bit-identical to the no-LoRA forward.

Mixture of experts (``cfg.num_experts`` > 0): every forward's FFN is
``_moe``, the JAX package's dense formulation (every expert for every
token, Mixtral's renormalised top-k weights in the combine) as plain
tensor products, the reference's being XLA einsums, not a Pallas kernel.
Expert stacks stay in the compute dtype under ``quant="int8"``, as in the
JAX package.

Tensor and expert parallelism: every forward takes ``tp``, the rank's
``parallel.mesh.ModelSharding`` (None on one device, where no collective
is called and the code path is unchanged). The rank computes with its
local view of the model (its query and kv heads, its FFN width, its
experts) on its shards; the partial sums of wo and of w_down are summed
over the tp ranks (``_reduce``), the MoE combine over the ep × tp ranks,
a vocabulary-split embedding is a masked lookup then a sum, and
vocabulary-split logits are gathered, so every rank holds the full logits
and samples the same token from the same bits. An adapter bank under tp
holds the rank's shard of each factor (``runner.shard_adapter_pages``):
the q/k/v deltas come out as the rank's columns, and the o delta joins
the rank's wo partial before the sum. The XLA reference derives the same
collectives from its shardings.

``embed`` is the JAX package's ``embed_impl`` (/v1/embeddings): a
cache-free causal forward, mean-pooled. Its attention, like prefill
attention, is plain tensor code (XLA in the JAX package); decode
and speculative-verify attention go through ``ops.paged_attention`` — the
CUDA kernel on the card (its decode, linear multi-query and tree modes),
the plain version on the CPU.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.sampler import (
    apply_penalties,
    row_gumbel,
    sample_simple,
    sample_step,
    spec_acceptance,
    spec_tree_acceptance,
    token_counts,
    token_logprobs,
    top_k_logprobs,
)
from dynamo_tpu_torch.ops import int8_matmul as im
from dynamo_tpu_torch.ops import paged_attention as pa

Params = dict[str, Any]


class KVCache(NamedTuple):
    """Paged KV storage; ``k_scale``/``v_scale`` only for int8 pages."""

    k: torch.Tensor  # [L, N, bs, KVH*hd]
    v: torch.Tensor
    k_scale: torch.Tensor | None = None  # [L, N, bs, KVH] f32
    v_scale: torch.Tensor | None = None


def init_kv_cache(
    cfg: ModelConfig, num_blocks: int, block_size: int, dtype: torch.dtype,
    device: torch.device, kv_quant: str = "none",
) -> KVCache:
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads * cfg.head_dim)
    if kv_quant == "int8":
        sshape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads)
        return KVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
        )
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization along the head dim: x [..., KVH,
    hd] → (int8 [..., KVH, hd], f32 scale [..., KVH]). Round half to even;
    all-zero rows get scale 1.0 so dequant is exactly zero."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax, torch.full_like(absmax, 127.0)) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def init_params(cfg: ModelConfig, device: torch.device, dtype: torch.dtype = torch.bfloat16,
                seed: int = 0, shard=None) -> Params:
    """Random-init params on ``device`` from a seeded ``torch.Generator``
    there: normal(0, 1/fan_in) weights, unit norms, 0.02-scale biases —
    the JAX package's leaves, shapes and distribution (not its random
    bits). A MoE config has the router ``w_router [L, d, E]`` and the
    expert stacks ``moe_gate``/``moe_up [L, E, d, ie]``, ``moe_down [L, E,
    ie, d]`` in place of the dense FFN. Each layer's tensors are drawn in
    f32 and cast one at a time, so the f32 temporaries stay one layer's
    tensor large. With ``shard`` (a ``parallel.mesh.ModelSharding``) every
    leaf is drawn whole, in the same order, and only the rank's shard is
    kept: the ranks of a tensor-parallel group hold the tp=1 weights."""
    g = torch.Generator(device=device).manual_seed(seed)
    d, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def normal(shape, fan_in, std=None, path=None):
        w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        w = (w * (std if std is not None else fan_in ** -0.5)).to(dtype)
        if shard is None or path is None:
            return w
        if path[0] == "layers":  # one layer's slice: the rules count the layer axis
            return shard.shard_leaf(path, w[None])[0]
        return shard.shard_leaf(path, w)

    shapes = {
        "wq": ((d, cfg.q_size), d), "wk": ((d, cfg.kv_size), d),
        "wv": ((d, cfg.kv_size), d), "wo": ((cfg.q_size, d), cfg.q_size),
    }
    if cfg.num_experts:
        E, ie = cfg.num_experts, cfg.moe_intermediate_size or i
        shapes.update({"w_router": ((d, E), d), "moe_gate": ((E, d, ie), d),
                       "moe_up": ((E, d, ie), d), "moe_down": ((E, ie, d), ie)})
    else:
        shapes.update({"w_gate": ((d, i), d), "w_up": ((d, i), d), "w_down": ((i, d), i)})
    if cfg.attn_bias:
        shapes.update({"bq": ((cfg.q_size,), None), "bk": ((cfg.kv_size,), None),
                       "bv": ((cfg.kv_size,), None)})
    layers: dict[str, torch.Tensor] = {}
    for layer in range(L):
        for name, (shape, fan_in) in shapes.items():
            w = normal(shape, fan_in, None if fan_in else 0.02, ("layers", name))
            if name not in layers:
                layers[name] = torch.empty((L, *w.shape), dtype=dtype, device=device)
            layers[name][layer] = w
    layers["attn_norm"] = torch.ones((L, d), dtype=dtype, device=device)
    layers["mlp_norm"] = torch.ones((L, d), dtype=dtype, device=device)
    params: Params = {
        "embed": normal((cfg.vocab_size, d), d, path=("embed",)),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d, path=("lm_head",))
    return params


def _layer(params: Params, i: int) -> dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * w.float()).to(x.dtype)


def _rope_table(positions: torch.Tensor, hd: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary cos/sin for ``positions`` (f32, [..., 1, hd/2], broadcast over
    heads), computed once per forward pass and shared by every layer."""
    half = hd // 2
    freq = torch.arange(half, dtype=torch.float32, device=positions.device)
    # A Python-number base: no host-to-device copy (a CUDA graph captures this).
    inv_freq = torch.pow(float(theta), -freq / half)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def _rope(x: torch.Tensor, table: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Rotary embedding, rotate-half layout, in f32. x: [..., heads, hd];
    ``table`` from ``_rope_table`` for x's leading dims."""
    cos, sin = table
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _compute_dtype(params: Params) -> torch.dtype:
    return params["layers"]["attn_norm"].dtype


def _dot_q(x: torch.Tensor, lp: dict, name: str) -> torch.Tensor:
    """x @ lp[name]; an int8 weight goes through the int8 product with its
    ``<name>_scale``, applied after the matmul (the JAX package's rounding)."""
    w = lp[name]
    if w.dtype == torch.int8:
        return im.int8_matmul(x, w, lp[name + "_scale"])
    return x @ w


def _local(cfg: ModelConfig, tp) -> ModelConfig:
    """The model as one tensor-parallel rank holds it (its heads and FFN
    width; ``parallel.mesh.ModelSharding.local``), or ``cfg`` at tp=1."""
    return cfg if tp is None else tp.local


def _reduce(y: torch.Tensor, tp, axis: str = "tp") -> torch.Tensor:
    """Sum a row-split product's partial ``y`` over the ranks of ``axis``
    (``parallel.comm``: the tp ranks, or "ep_tp" for the MoE combine;
    nothing on one device)."""
    return y if tp is None else tp.group.all_reduce_(y, axis)


def _embed_rows(params: Params, tokens: torch.Tensor, dtype: torch.dtype,
                tp=None) -> torch.Tensor:
    """Embedding rows of ``tokens``. With a vocabulary-split table each rank
    looks up the rows it holds, zeroes the rest, and the sum over the ranks
    is the full lookup (exact: one term per row is nonzero)."""
    idx = tokens.long()
    own = None
    if tp is not None and tp.vocab_sharded:
        local = idx - tp.vocab_lo
        own = (local >= 0) & (local < tp.vocab_hi - tp.vocab_lo)
        idx = torch.where(own, local, 0)
    e = params["embed"][idx]
    if e.dtype == torch.int8:
        scale = params["embed_scale"][idx].to(dtype)
        e = e.to(dtype) * scale[..., None]
    if own is not None:
        e = tp.group.all_reduce_(torch.where(own[..., None], e, torch.zeros_like(e)))
    return e


def _dot_q_group(x: torch.Tensor, lp: dict, names: tuple) -> list:
    """``_dot_q`` of each weight in ``names``, all of which read x: int8
    weights as one ``int8_matmul_group`` call (one launch on the decode
    entry), float ones each on its own."""
    if all(lp[n].dtype == torch.int8 for n in names):
        return im.int8_matmul_group(x, [(lp[n], lp[n + "_scale"]) for n in names])
    return [_dot_q(x, lp, n) for n in names]


def _qkv(h: torch.Tensor, lp: dict, cfg: ModelConfig):
    """q/k/v projections with optional Qwen2-style bias."""
    q, k, v = _dot_q_group(h, lp, ("wq", "wk", "wv"))
    if cfg.attn_bias:
        q = q + lp["bq"].to(q.dtype)
        k = k + lp["bk"].to(k.dtype)
        v = v + lp["bv"].to(v.dtype)
    return q, k, v


def _lora_rows(lora: dict | None, adapter_slots: torch.Tensor | None):
    """Each row's bank index and live mask, made once per forward and
    shared by every projection of every layer (None: the exact base
    path). ``adapter_slots`` [B] names each row's slot, -1 = base."""
    if (lora is None) != (adapter_slots is None):
        raise ValueError("an adapter bank and adapter_slots ride a dispatch together")
    if adapter_slots is None:
        return None
    return adapter_slots.clamp(min=0).long(), adapter_slots >= 0


def _lora_apply(y: torch.Tensor, h: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
                rows: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Batched gathered LoRA product (Punica's BGMV): per row b,
    ``y[b] + (h[b] @ A[slot[b]]) @ B_[slot[b]]``. ``A`` [S, in, r] and
    ``B_`` [S, r, out] are one layer's slice of the bank; ``rows`` is
    ``_lora_rows``' (index, live). ``h`` is [B, in] (decode) or [B, T,
    in] (prefill, verify). The products run in the activation dtype, as
    the JAX einsums do. Base rows take a ``where`` on the original ``y``
    (an add of zero could flip a -0.0), so they are bit-identical to the
    no-LoRA projection; alpha/rank scaling is folded into B at upload."""
    idx, live = rows
    Ag = A.index_select(0, idx).to(h.dtype)                               # [B, in, r]
    Bg = B_.index_select(0, idx).to(h.dtype)                              # [B, r, out]
    h3 = h if h.dim() == 3 else h[:, None, :]
    delta = torch.bmm(torch.bmm(h3, Ag), Bg).view(y.shape)                # [B, (T,) out]
    mask = live.view(-1, *[1] * (y.dim() - 1))
    return torch.where(mask, y + delta.to(y.dtype), y)


def _lora_layer(lora: dict | None, layer: int) -> dict | None:
    """One layer's slice of the adapter bank (None: the exact base path)."""
    return None if lora is None else {k: v[layer] for k, v in lora.items()}


def _qkv_lora(h: torch.Tensor, lp: dict, cfg: ModelConfig, ll: dict | None, rows):
    """``_qkv`` plus the per-row adapter deltas when a bank layer slice
    ``ll`` rides the dispatch."""
    q, k, v = _qkv(h, lp, cfg)
    if ll is not None:
        q = _lora_apply(q, h, ll["qa"], ll["qb"], rows)
        k = _lora_apply(k, h, ll["ka"], ll["kb"], rows)
        v = _lora_apply(v, h, ll["va"], ll["vb"], rows)
    return q, k, v


def _wo_lora(o: torch.Tensor, lp: dict, ll: dict | None, rows) -> torch.Tensor:
    """The o-projection with the optional per-row adapter delta. Under tp
    ``o`` and the bank's ``oa`` are the rank's rows, so the delta is the
    rank's partial of ``o @ oa @ ob``, added to wo's before the caller's
    all-reduce sums both."""
    y = _dot_q(o, lp, "wo")
    if ll is not None:
        y = _lora_apply(y, o, ll["oa"], ll["ob"], rows)
    return y


def _mlp(x: torch.Tensor, lp: dict) -> torch.Tensor:
    g, u = _dot_q_group(x, lp, ("w_gate", "w_up"))
    return _dot_q(torch.nn.functional.silu(g.float()).to(x.dtype) * u, lp, "w_down")


def _moe_route(xt: torch.Tensor, w_router: torch.Tensor, k: int):
    """The router of ``_moe``: xt [T, D] → (probs [T, E] f32, the top-k
    weights renormalised to sum 1 [T, k] f32, their experts [T, k]), in
    ``lax.top_k``'s order (descending, lower index first among ties)."""
    probs = torch.softmax((xt @ w_router).float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    return probs, topv / topv.sum(dim=-1, keepdim=True), topi


def _moe(x: torch.Tensor, lp: dict, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Top-k routed mixture of experts over the FFN (Mixtral's
    renormalised top-k), computed as the JAX package's ``_moe`` computes
    it: every expert's FFN for every token, the products in the activation
    dtype, then one weighted combine. x: [..., D].

    - The router product runs in the activation dtype and only its result
      goes to f32 (bf16-valued logits, then an f32 softmax).
    - Top-k by a stable descending sort: among equal probabilities the
      lower expert index comes first, as ``lax.top_k`` takes it (bf16
      logits tie often among many experts).
    - The gate and up products read each expert's [d, ie] slice as stored
      (``x @ moe_gate`` broadcasts x over the expert axis: no copy of a
      stack); the combine is one product over the flattened (expert, ie)
      axis against ``moe_down`` viewed as [E·ie, d], so it accumulates as
      the reference's single einsum does.

    Under expert parallelism (``tp`` with ep > 1) the router is replicated
    and every rank takes the same top-k; the rank's stacks hold its E/ep
    experts, which it applies to every token and combines with its slice
    of the renormalised [T, E] weights. The caller sums the partial over
    the ep × tp ranks (``_ffn``).

    No host synchronisation and no data-dependent shape: a decode window
    with MoE layers is captured as one CUDA graph like any other."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])                                          # [T, D]
    T = xt.shape[0]
    probs, topv, topi = _moe_route(xt, lp["w_router"], cfg.num_experts_per_token)
    weights = torch.zeros_like(probs).scatter_(1, topi, topv).to(xt.dtype)  # [T, E]
    if tp is not None:
        weights = weights[:, tp.experts[0]:tp.experts[1]]                  # [T, E/ep]
    g = torch.matmul(xt, lp["moe_gate"])                                   # [E, T, ie]
    u = torch.matmul(xt, lp["moe_up"])
    h = torch.nn.functional.silu(g.float()).to(xt.dtype) * u
    hw = (h * weights.T[:, :, None]).transpose(0, 1).reshape(T, -1)        # [T, E·ie]
    down = lp["moe_down"]
    y = hw @ down.reshape(down.shape[0] * down.shape[1], down.shape[2])    # [T, D]
    return y.reshape(shape)


def _ffn(x: torch.Tensor, lp: dict, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """The layer's FFN, summed over the ranks that split it: routed experts
    over the ep × tp ranks for a MoE config, else the MLP over the tp
    ranks."""
    if cfg.num_experts:
        return _reduce(_moe(x, lp, cfg, tp), tp, "ep_tp")
    return _reduce(_mlp(x, lp), tp)


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """→ f32 logits. int8 heads: ``x @ w`` rounded to x's dtype, then f32
    times the scale leaf as it is (the JAX package's ``_logits``). A tied
    int8 embedding goes as ``emb.T``, a view: the kernel's tied-head entry
    reads it as stored, and no transposed copy is made. A vocabulary-split
    head computes the rank's slice, then gathers every rank's: each rank
    holds the same full logits, so each samples the same token."""
    x = _rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_embeddings:
        emb = params["embed"]
        if emb.dtype == torch.int8:
            out = im.int8_matmul(x, emb.T, params["embed_scale"], out_f32=True)
        else:
            out = (x @ emb.T).float()
    else:
        head = params["lm_head"]
        if head.dtype == torch.int8:
            out = im.int8_matmul(x, head, params["lm_head_scale"], out_f32=True)
        else:
            out = (x @ head).float()
    if tp is not None and tp.vocab_sharded:
        out = tp.group.all_gather(out)
    return out


def _write_pages(cache: KVCache, layer: int, idx: tuple, k: torch.Tensor, v: torch.Tensor,
                 shape: tuple) -> None:
    """Write fresh K/V rows (``[..., KVH, hd]``) at ``cache.*[layer][idx]``
    (quantizing for int8 pages). ``shape`` is the target view of the
    written values."""
    if cache.k_scale is not None:
        kq, ksc = kv_quantize(k)
        vq, vsc = kv_quantize(v)
        cache.k[layer][idx] = kq.reshape(shape)
        cache.v[layer][idx] = vq.reshape(shape)
        cache.k_scale[layer][idx] = ksc.reshape(*shape[:-1], -1)
        cache.v_scale[layer][idx] = vsc.reshape(*shape[:-1], -1)
    else:
        cache.k[layer][idx] = k.reshape(shape)
        cache.v[layer][idx] = v.reshape(shape)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_batch(
    cfg: ModelConfig,
    params: Params,
    cache: KVCache,
    tokens: torch.Tensor,        # [Bp, T] suffix token ids per row (T a block multiple)
    block_tables: torch.Tensor,  # [Bp, W] int32 — blocks for each FULL sequence
    start_pos: torch.Tensor,     # [Bp] int32 — first suffix position (block-aligned)
    true_len: torch.Tensor,      # [Bp] int32 — true total length (0 = inactive row)
    lora: dict | None = None,    # adapter bank {qa..ob: [L, S, ...]}
    adapter_slots: torch.Tensor | None = None,  # [Bp] int32, -1 = base row
    tp=None,                     # parallel.mesh.ModelSharding of this rank (None: tp=1)
) -> torch.Tensor:
    """Prefill Bp sequences' suffixes, each attending its own cached
    prefix pages; writes the suffix KV into the cache and returns
    last-token logits [Bp, V] (f32).

    Prefix caching contract per row: positions [0, start_pos) are already
    in the blocks ``block_tables`` names (whole blocks); suffix positions
    [start_pos, true_len) are computed here."""
    cfg = _local(cfg, tp)
    lrows = _lora_rows(lora, adapter_slots)
    Bp, T = tokens.shape
    W = block_tables.shape[1]
    bs = cache.k.shape[2]
    KVH, hd = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KVH
    dev = tokens.device
    start = start_pos.long()
    tlen = true_len.long()
    sfx = torch.arange(T, device=dev)
    suffix_positions = start[:, None] + sfx[None, :]                       # [Bp, T]

    x = _embed_rows(params, tokens, _compute_dtype(params), tp)            # [Bp, T, D]

    # Additive f32 masks, fixed for all layers.
    neg = -1e9
    causal = (sfx[None, :] <= sfx[:, None]).float()                        # [T, T]
    valid_sfx = (suffix_positions < tlen[:, None]).float()
    mask_ss = (1.0 - causal[None] * valid_sfx[:, None, :]) * neg           # [Bp, T, T]
    ctx = torch.arange(W * bs, device=dev)
    mask_sp = torch.where(ctx[None, :] < start[:, None], 0.0, neg)         # [Bp, W*bs]

    # Suffix block scatter targets: suffix-local block j → table slot
    # start_pos//bs + j; padded blocks (beyond true_len) → garbage block 0.
    nb = T // bs
    jb = torch.arange(nb, device=dev)
    slot = start[:, None] // bs + jb[None, :]
    padded = torch.cat([block_tables.long(),
                        torch.zeros((Bp, nb), dtype=torch.long, device=dev)], dim=1)
    sfx_ids = torch.gather(padded, 1, slot)
    sfx_ids = torch.where(start[:, None] + jb[None, :] * bs < tlen[:, None], sfx_ids, 0)
    flat_ids = sfx_ids.reshape(Bp * nb)
    scale = hd ** -0.5
    rope = _rope_table(suffix_positions, hd, cfg.rope_theta)

    for layer in range(cfg.num_layers):
        lp = _layer(params, layer)
        ll = _lora_layer(lora, layer)
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv_lora(h, lp, cfg, ll, lrows)
        q = _rope(q.reshape(Bp, T, cfg.num_heads, hd), rope)
        k = _rope(k.reshape(Bp, T, KVH, hd), rope)
        v = v.reshape(Bp, T, KVH, hd)
        # The suffix self-attends its exact values below; only later
        # readers see the (possibly int8-rounded) stored pages.
        _write_pages(cache, layer, (flat_ids,), k, v, (Bp * nb, bs, KVH * hd))

        sk = sv = None
        if cache.k_scale is not None:
            sk, sv = cache.k_scale[layer], cache.v_scale[layer]
        pk = pa.gather_dequant_pages(cache.k[layer], sk, block_tables, KVH, hd, x.dtype)
        pv = pa.gather_dequant_pages(cache.v[layer], sv, block_tables, KVH, hd, x.dtype)

        # The f32 scores are the forward's largest buffers ([Bp, T, H, W·bs
        # + T]): scaled and masked in place, and each dropped as soon as it
        # is consumed, so that at most two are alive at once (what a
        # captured prefill's share of the graph pool holds).
        qg = q.reshape(Bp, T, KVH, G, hd)
        s_p = torch.einsum("btkgh,bckh->btkgc", qg, pk).float().mul_(scale)
        s_p.add_(mask_sp[:, None, None, None, :])
        s_s = torch.einsum("btkgh,bskh->btkgs", qg, k).float().mul_(scale)
        s_s.add_(mask_ss[:, :, None, None, :])
        s = torch.cat([s_p, s_s], dim=-1)
        del s_p, s_s, pk
        p = torch.softmax(s, dim=-1)
        del s
        p = p.to(x.dtype)
        o = (torch.einsum("btkgc,bckh->btkgh", p[..., : W * bs], pv)
             + torch.einsum("btkgs,bskh->btkgh", p[..., W * bs :], v))
        del p, pv
        x = x + _reduce(_wo_lora(o.reshape(Bp, T, cfg.q_size), lp, ll, lrows), tp)
        x = x + _ffn(_rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), lp, cfg, tp)

    last = torch.clamp(tlen - start - 1, 0, T - 1)
    x_last = x[torch.arange(Bp, device=dev), last]                         # [Bp, D]
    return _logits(cfg, params, x_last, tp)


def prefill(cfg: ModelConfig, params: Params, cache: KVCache, tokens: torch.Tensor,
            block_table: torch.Tensor, start_pos: int, true_len: int,
            lora: dict | None = None, adapter_slot: int | None = None,
            tp=None) -> torch.Tensor:
    """Single-sequence prefill (the chunked-prefill entry point): the
    Bp=1 case of ``prefill_batch`` → logits [V]; ``adapter_slot`` is the
    row's bank slot (-1 = base) when ``lora`` rides."""
    dev = tokens.device
    return prefill_batch(
        cfg, params, cache, tokens[None, :], block_table[None, :],
        torch.tensor([start_pos], dtype=torch.int32, device=dev),
        torch.tensor([true_len], dtype=torch.int32, device=dev),
        lora, None if adapter_slot is None
        else torch.tensor([adapter_slot], dtype=torch.int32, device=dev), tp,
    )[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: KVCache,
    tokens: torch.Tensor,        # [B] int32 — current token per sequence
    positions: torch.Tensor,     # [B] int32 — position of that token
    block_tables: torch.Tensor,  # [B, W] int32
    active: torch.Tensor,        # [B] bool — padding rows are False
    attn_impl: str = "auto",
    lora: dict | None = None,    # adapter bank {qa..ob: [L, S, ...]}
    adapter_slots: torch.Tensor | None = None,  # [B] int32, -1 = base row
    tp=None,                     # parallel.mesh.ModelSharding of this rank (None: tp=1)
) -> torch.Tensor:
    """One decode step: write each sequence's new KV at its position, then
    attend over its pages ([0, position]) → logits [B, V] (f32). Under tp
    the attention kernel runs on the rank's kv heads and their query
    heads."""
    cfg = _local(cfg, tp)
    lrows = _lora_rows(lora, adapter_slots)
    impl = pa.resolve_attn_impl(attn_impl, tokens.device)
    attend = pa.paged_decode_attention if impl == "cuda" else pa.paged_decode_attention_ref
    B = tokens.shape[0]
    bs = cache.k.shape[2]
    KVH, hd = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KVH
    pos = positions.long()
    rows = torch.arange(B, device=tokens.device)
    blk = torch.where(active, block_tables.long()[rows, pos // bs], 0)
    off = torch.where(active, pos % bs, 0)
    # token at `positions` attends [0, positions]; inactive rows attend nothing
    lengths = torch.where(active, pos + 1, 0).to(torch.int32)

    x = _embed_rows(params, tokens, _compute_dtype(params), tp)            # [B, D]
    rope = _rope_table(pos, hd, cfg.rope_theta)
    for layer in range(cfg.num_layers):
        lp = _layer(params, layer)
        ll = _lora_layer(lora, layer)
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv_lora(h, lp, cfg, ll, lrows)
        q = _rope(q.reshape(B, cfg.num_heads, hd), rope)
        k = _rope(k.reshape(B, KVH, hd), rope)
        v = v.reshape(B, KVH, hd)
        # Write, then attend: this step's own token is read back from the
        # cache (int8-rounded under kv_quant), as every later step reads it.
        _write_pages(cache, layer, (blk, off), k, v, (B, KVH * hd))
        o = attend(q.reshape(B, KVH, G, hd), cache.k, cache.v, layer, block_tables,
                   lengths, cache.k_scale, cache.v_scale)
        x = x + _reduce(_wo_lora(o.reshape(B, cfg.q_size), lp, ll, lrows), tp)
        x = x + _ffn(_rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), lp, cfg, tp)
    return _logits(cfg, params, x, tp)


def multi_decode(
    cfg: ModelConfig,
    num_steps: int,
    mode: str,                   # "greedy" | "simple" | "full"
    top_n: int,                  # top-n alternative logprobs (0 = off)
    params: Params,
    cache: KVCache,
    tokens: torch.Tensor,        # [B] int32
    positions: torch.Tensor,     # [B] int32
    block_tables: torch.Tensor,  # [B, W] int32 (must cover positions+num_steps)
    active: torch.Tensor,        # [B] bool
    temperature: torch.Tensor,   # [B] f32 (<= 0 → greedy row)
    seeds: torch.Tensor,         # [B] int per-row sample seed ("simple"/"full")
    steps0: torch.Tensor,        # [B] int per-row emission index of the first substep
    top_k: torch.Tensor | None = None,           # [B] int ("full"; 0 = off)
    top_p: torch.Tensor | None = None,           # [B] f32 ("full"; 1.0 = off)
    freq_penalty: torch.Tensor | None = None,    # [B] f32 ("full")
    pres_penalty: torch.Tensor | None = None,    # [B] f32 ("full")
    penalty_tokens: torch.Tensor | None = None,  # [B, L] int generated ids, -1 pad ("full")
    chain_mask: torch.Tensor | None = None,      # [B] bool — row chains from last_toks
    chain_src: torch.Tensor | None = None,       # [B] int — its SLOT in last_toks
    last_toks: torch.Tensor | None = None,       # [slots+1] int32 per-slot latest token
    lora: dict | None = None,                    # adapter bank {qa..ob: [L, S, ...]}
    adapter_slots: torch.Tensor | None = None,   # [B] int32, -1 = base row
    *,
    attn_impl: str = "auto",
    tp=None,                                     # parallel.mesh.ModelSharding (None: tp=1)
):
    """``num_steps`` fused decode+sample substeps: sampled tokens feed back
    on the device, so the caller fetches once per window. → (tokens
    [K, B] int32, logprobs [K, B] f32, top_vals [K, B, top_n], top_ids
    [K, B, top_n]), all on the device. Logprobs are of the raw model
    distribution (before penalties).

    Sampler modes: "greedy" (argmax, no noise), "simple" (temperature by
    Gumbel-max), "full" (frequency/presence penalties plus exact top-k and
    top-p; the penalty counts start from ``penalty_tokens`` and are updated
    on the device with each sampled token, so the window stays fused).

    Window pipeline: rows with ``chain_mask`` set take their input token
    from ``last_toks[chain_src]``, the newest on-device sample of their
    slot (the previous window's fold or the admission sample), so a window
    can be dispatched before the one it follows is fetched. Every operand
    is a tensor, so nothing host-side varies inside a window and a CUDA
    graph can capture it whole."""
    if mode not in ("greedy", "simple", "full"):
        raise ValueError(f"unknown sampler mode {mode!r}")
    B = tokens.shape[0]
    V = cfg.vocab_size
    dev = tokens.device
    if chain_mask is not None:
        tokens = torch.where(chain_mask, last_toks[chain_src.long()], tokens)
    if mode == "full":
        counts = token_counts(penalty_tokens, V)
        one = torch.ones((B, 1), dtype=torch.float32, device=dev)
    toks, logps, tvals, tids = [], [], [], []
    tok, pos = tokens, positions
    for i in range(num_steps):
        logits = decode_step(cfg, params, cache, tok, pos, block_tables, active, attn_impl,
                             lora, adapter_slots, tp)
        if mode == "greedy":
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        elif mode == "simple":
            nxt = sample_simple(logits, temperature, row_gumbel(seeds, steps0 + i, V))
        else:
            penalized = apply_penalties(logits, counts, freq_penalty, pres_penalty)
            nxt = sample_step(penalized, temperature, top_k, top_p,
                              row_gumbel(seeds, steps0 + i, V))
            counts.scatter_add_(1, nxt.long()[:, None], one)
        toks.append(nxt)
        logps.append(token_logprobs(logits, nxt))
        if top_n > 0:
            v_, i_ = top_k_logprobs(logits, top_n)
        else:
            v_ = torch.zeros((B, 0), dtype=torch.float32, device=dev)
            i_ = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        tvals.append(v_)
        tids.append(i_)
        tok, pos = nxt, pos + 1
    return torch.stack(toks), torch.stack(logps), torch.stack(tvals), torch.stack(tids)


# ---------------------------------------------------------------------------
# Speculative verify
# ---------------------------------------------------------------------------


def spec_verify(
    cfg: ModelConfig,
    S1: int,                     # draft slots + 1 ([last, d1..dS])
    mode: str,                   # "greedy" | "simple"
    top_n: int,                  # top-n alternative logprobs (0 = off)
    params: Params,
    cache: KVCache,
    tokens: torch.Tensor,        # [B, S1] int32 — [last_token, draft_1..draft_S]
    positions0: torch.Tensor,    # [B] int32 — position of last_token
    draft_len: torch.Tensor,     # [B] int32 — true draft length per row (<= S1-1)
    block_tables: torch.Tensor,  # [B, W] int32 (must cover positions0+draft_len)
    active: torch.Tensor,        # [B] bool
    temperature: torch.Tensor,   # [B] f32 (<= 0 → greedy row)
    seeds: torch.Tensor,         # [B] int per-row sample seed
    steps0: torch.Tensor,        # [B] int per-row emission index of the first token
    tree_parents: torch.Tensor | None = None,  # [B, S1] int — tree mode (below)
    tree_anc: torch.Tensor | None = None,      # [B, S1, S1] ancestor-or-self bits
    tree_depth: torch.Tensor | None = None,    # [B, S1] int per-node depth
    mask_bits: torch.Tensor | None = None,     # [B, S1, W32] int32 per-node grammar masks
    lora: dict | None = None,                  # adapter bank {qa..ob: [L, S, ...]}
    adapter_slots: torch.Tensor | None = None,  # [B] int32, -1 = base row
    *,
    fused: bool = True,
    attn_impl: str = "auto",
    tp=None,                                   # parallel.mesh.ModelSharding (None: tp=1)
) -> tuple[torch.Tensor, ...]:
    """Speculative verify (the JAX package's ``spec_verify_impl``): score S1
    consecutive positions per row in one dispatch. Input j writes its KV at
    positions0+j and position j's logits score the token after input j,
    exactly as the j-th sequential ``decode_step`` would.

    - ``fused=True``: one forward over all B·S1 rows (one weight stream).
      Every layer writes the S1 new K/V rows to the pages first, then the
      multi-query attention kernel (linear mode: per-query horizon
      positions0+j+1) reads them back with the history, as the dense step
      does.
    - ``fused=False``: a teacher-forced loop of ``decode_step``, bitwise
      identical to the dense path (S1 weight streams; the parity anchor).
    - Tree mode (``tree_parents`` given, always fused): node j writes at
      slot position positions0+j, rotates at positions0+depth[j] and
      attends the history plus its ancestor-or-self slots (the kernel's
      tree mode, ``anc`` masked by the live slots). Acceptance walks the
      root path, and the accepted path's KV is compacted on the device
      into positions0+1..positions0+a, every other depth written to block 0,
      int8 scales included, so the engine rolls back as for a chain.

    Grammar masks (``mask_bits``) ride the tree mode only, as in the JAX
    package, whose engine upgrades every constrained batch to the tree op:
    acceptance and the correction/bonus samples renormalize over each
    node's legal vocabulary, while the reported logprobs stay the raw
    model's. Linear and stepwise passes refuse masks.

    Dead slots (j > draft_len) and inactive rows write to block 0, the
    garbage sink. The KV of drafts past the accepted run is junk that the
    next dispatch rewrites.

    Returns (out [B, S1] emitted tokens, n_emit [B], logps [B, S1] raw
    logprobs of the emitted tokens, cand [B, S1] per-node argmax, top_vals
    [B, S1, top_n], top_ids [B, S1, top_n], last_tok [B] = out[b,
    n_emit-1]), all on the device; the cache is updated in place."""
    if mask_bits is not None and tree_parents is None:
        raise ValueError("grammar masks ride tree verify passes only")
    cfg = _local(cfg, tp)
    lrows = _lora_rows(lora, adapter_slots)
    if mode not in ("greedy", "simple"):
        raise ValueError(f"unknown verify sampler mode {mode!r}")
    B, T = tokens.shape
    if T != S1:
        raise ValueError(f"tokens carry {T} slots, S1 is {S1}")
    dev = tokens.device
    bs = cache.k.shape[2]
    KVH, hd = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KVH
    tree = tree_parents is not None
    slot = torch.arange(T, device=dev)[None, :]
    use = active[:, None] & (slot <= draft_len[:, None])                  # [B, T]
    # Write position per slot (slot-ordered: distinct cache slots for any
    # tree shape) and RoPE position per node (its sequence depth).
    p0 = positions0.long()
    wpos = p0[:, None] + slot                                             # [B, T]
    pos = wpos if not tree else p0[:, None] + tree_depth.long()
    tables = block_tables.long()
    last_col = tables.shape[1] - 1

    def table_at(p: torch.Tensor) -> torch.Tensor:
        """Block of each position; positions past the table (dead slots)
        read its last column and are masked by the caller, as the JAX
        gather clamps."""
        return torch.gather(tables, 1, (p // bs).clamp(max=last_col))

    if fused or tree:
        impl = pa.resolve_attn_impl(attn_impl, dev)
        attend = pa.paged_spec_attention if impl == "cuda" else pa.paged_spec_attention_ref
        x = _embed_rows(params, tokens, _compute_dtype(params), tp)       # [B, T, D]
        blk = torch.where(use, table_at(wpos), 0)
        off = torch.where(use, wpos % bs, 0)
        if tree:
            # Per-query history horizon; the slot window rides on top of
            # it under the topology mask, dead slots masked out of it.
            lengths = torch.where(use, p0[:, None], 0).to(torch.int32)
            anc = ((tree_anc != 0) & use[:, :, None] & use[:, None, :]).to(torch.int8)
        else:
            lengths = torch.where(use, pos + 1, 0).to(torch.int32)       # query j: [0, pos_j]
            anc = None
        rope = _rope_table(pos, hd, cfg.rope_theta)
        for layer in range(cfg.num_layers):
            lp = _layer(params, layer)
            ll = _lora_layer(lora, layer)
            h = _rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
            q, k, v = _qkv_lora(h, lp, cfg, ll, lrows)
            q = _rope(q.reshape(B, T, cfg.num_heads, hd), rope)
            k = _rope(k.reshape(B, T, KVH, hd), rope)
            v = v.reshape(B, T, KVH, hd)
            # Write all T new rows, then attend: in-pass keys come back out
            # of the pages, as the dense step reads its own (int8-rounded
            # under kv_quant).
            _write_pages(cache, layer, (blk, off), k, v, (B, T, KVH * hd))
            o = attend(q.reshape(B, T, KVH, G, hd), cache.k, cache.v, layer, block_tables,
                       lengths, cache.k_scale, cache.v_scale, anc)
            x = x + _reduce(_wo_lora(o.reshape(B, T, cfg.q_size), lp, ll, lrows), tp)
            x = x + _ffn(_rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), lp, cfg, tp)
        logits = _logits(cfg, params, x, tp)                              # [B, T, V]
    else:
        # Dead slots step at position 0 (their rows are inactive there).
        tok32, pos32 = tokens.to(torch.int32), torch.where(use, pos, 0).to(torch.int32)
        step_logits = [
            decode_step(cfg, params, cache, tok32[:, j], pos32[:, j], block_tables, use[:, j],
                        attn_impl, lora, adapter_slots, tp)
            for j in range(T)
        ]
        logits = torch.stack(step_logits, dim=1)

    if tree:
        out, n_emit, path, cand = spec_tree_acceptance(
            logits, tokens, tree_parents, draft_len, temperature, seeds, steps0, mode, mask_bits)
        # Downstream reads path-aligned logits: emitted token k came from
        # node path[k]'s distribution.
        V = logits.shape[-1]
        logits_out = torch.gather(logits, 1, path.long()[:, :, None].expand(B, T, V))
        # KV compaction: the accepted depth-k node moves from its slot to
        # positions0+k; depths past the accepted run go to block 0. The
        # gather completes before the scatter, so a node already in place
        # (a chain prefix) is rewritten with its own value.
        kdepth = torch.arange(1, T, device=dev)[None, :]
        src_pos = p0[:, None] + path.long()[:, 1:]
        dst_pos = p0[:, None] + kdepth
        keep = active[:, None] & (kdepth < n_emit[:, None])
        src_blk, src_off = table_at(src_pos), src_pos % bs
        dst_blk = torch.where(keep, table_at(dst_pos), 0)
        dst_off = torch.where(keep, dst_pos % bs, 0)
        for t in cache:
            if t is not None:
                t[:, dst_blk, dst_off] = t[:, src_blk, src_off]
    else:
        out, n_emit = spec_acceptance(logits, tokens[:, 1:], draft_len, temperature, seeds,
                                      steps0, mode)
        cand = torch.argmax(logits, dim=-1).to(torch.int32)
        logits_out = logits
    # Raw-distribution logprobs of the emitted tokens (as the dense path).
    # Stepwise, each slot's come from its own [B, V] logits through the
    # dense path's functions, so that the reductions (and their rounding)
    # are the dense substep's too.
    if fused or tree:
        slots = [logits_out.reshape(B * T, -1)]
        emitted = [out.reshape(B * T)]
    else:
        slots, emitted = step_logits, [out[:, j] for j in range(T)]
    logps = torch.stack([token_logprobs(lg, o) for lg, o in zip(slots, emitted)],
                        dim=-1).reshape(B, T)
    if top_n > 0:
        tops = [top_k_logprobs(lg, top_n) for lg in slots]
        top_vals = torch.stack([v for v, _ in tops], dim=-2).reshape(B, T, top_n)
        top_ids = torch.stack([i for _, i in tops], dim=-2).reshape(B, T, top_n)
    else:
        top_vals = torch.zeros((B, T, 0), dtype=torch.float32, device=dev)
        top_ids = torch.zeros((B, T, 0), dtype=torch.int32, device=dev)
    last_tok = torch.gather(out, 1, (n_emit.long() - 1)[:, None])[:, 0]
    return out, n_emit, logps, cand, top_vals, top_ids, last_tok


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def embed(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [T_pad] int32
    true_len: int,         # tokens that count; the rest is padding
    tp=None,               # parallel.mesh.ModelSharding of this rank (None: tp=1)
) -> torch.Tensor:
    """Mean-pooled final-norm hidden state over the true tokens → [D] f32
    (the JAX package's ``embed_impl``; serves /v1/embeddings). A cache-free
    causal forward with the JAX function's dense attention: einsum scores
    in f32, a -1e9 additive mask over future and padded keys, softmax in
    f32. Padded positions attend the true ones but are left out of the
    mean, so the vector does not depend on the padding beyond rounding."""
    cfg = _local(cfg, tp)
    T = tokens.shape[0]
    KVH, hd = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KVH
    dev = tokens.device
    x = _embed_rows(params, tokens, _compute_dtype(params), tp)           # [T, D]
    pos = torch.arange(T, device=dev)
    valid = pos < true_len
    allowed = (pos[None, :] <= pos[:, None]) & valid[None, :]
    mask = torch.where(allowed, 0.0, -1e9)                                # [T, T] f32
    scale = hd ** -0.5
    rope = _rope_table(pos, hd, cfg.rope_theta)
    for layer in range(cfg.num_layers):
        lp = _layer(params, layer)
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg)
        q = _rope(q.reshape(T, cfg.num_heads, hd), rope)
        k = _rope(k.reshape(T, KVH, hd), rope)
        v = v.reshape(T, KVH, hd)
        qg = q.reshape(T, KVH, G, hd)
        s = torch.einsum("tkgh,skh->tkgs", qg, k).float() * scale
        s = s + mask[:, None, None, :]
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("tkgs,skh->tkgh", p, v).reshape(T, cfg.q_size)
        x = x + _reduce(_dot_q(o, lp, "wo"), tp)
        x = x + _ffn(_rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), lp, cfg, tp)
    x = _rms_norm(x, params["final_norm"], cfg.rms_norm_eps).float()
    w = valid.float()[:, None]
    return (x * w).sum(dim=0) / max(float(true_len), 1.0)
