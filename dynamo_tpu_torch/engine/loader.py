"""Checkpoint loading: HF model directory or GGUF file → (ModelConfig, params)
(port of ``dynamo_tpu/engine/loader.py``).

The same names, transposes, bias policy, leftover warning and shape
checks as the JAX loader, into the same params tree (one ``[L, ...]``
leaf per projection). What differs:

- Files are read by ``engine/safetensors_io.py`` (mmap, no safetensors
  package), into CPU tensors: torch has bfloat16, so no ml_dtypes.
- ``finalize_params`` quantizes before placement (int8 kept, every other
  leaf, scales included, converted to the serving dtype, as the JAX
  loader does) and moves each leaf to the device with one copy. It
  quantizes on the device, one layer at a time, bit-equal to the host
  quantizer.

Weight-name mapping (HF → ours):
  model.embed_tokens.weight                  embed            [V, D]
  model.layers.{i}.self_attn.q_proj.weight   layers.wq[i]     ([qs, D] → T)
  model.layers.{i}.self_attn.k_proj.weight   layers.wk[i]     ([kvs, D] → T)
  model.layers.{i}.self_attn.v_proj.weight   layers.wv[i]     ([kvs, D] → T)
  model.layers.{i}.self_attn.o_proj.weight   layers.wo[i]     ([D, qs] → T)
  model.layers.{i}.mlp.gate_proj.weight      layers.w_gate[i] ([I, D] → T)
  model.layers.{i}.mlp.up_proj.weight        layers.w_up[i]   ([I, D] → T)
  model.layers.{i}.mlp.down_proj.weight      layers.w_down[i] ([D, I] → T)
  model.layers.{i}.input_layernorm.weight    layers.attn_norm[i]
  model.layers.{i}.post_attention_layernorm. layers.mlp_norm[i]
  model.norm.weight                          final_norm
  lm_head.weight (absent when tied)          lm_head          ([V, D] → T)

RoPE convention: HF checkpoints store q/k projections pre-permuted for
the ``rotate_half`` formulation that model._rope computes — no fix-up.

``save_checkpoint`` writes a params tree back as such a directory (the
tests' and chip_smoke.py's checkpoints, made from seeded random weights).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.quant import quantize_params_device
from dynamo_tpu_torch.engine.safetensors_io import SafeTensorsFile, save_file
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("loader")

_LAYER_NAMES = {
    # ours → (HF name under model.layers.{i}, stored transposed)
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
    "attn_norm": ("input_layernorm.weight", False),
    "mlp_norm": ("post_attention_layernorm.weight", False),
}
_BIAS_NAMES = {"bq": "self_attn.q_proj.bias", "bk": "self_attn.k_proj.bias",
               "bv": "self_attn.v_proj.bias"}


def _torch_dtype(dtype: Any) -> torch.dtype:
    """None → bfloat16 (the serving dtype); a name or a torch dtype."""
    if dtype is None:
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).replace("torch.", ""))


def config_from_hf(model_path: str) -> ModelConfig:
    """Parse ``config.json`` into a ModelConfig. Llama-family only
    (LlamaForCausalLM & friends: same tensor layout)."""
    with open(os.path.join(model_path, "config.json")) as f:
        hf = json.load(f)
    archs = hf.get("architectures") or []
    known = {"LlamaForCausalLM", "MistralForCausalLM", "Qwen2ForCausalLM"}
    if archs and not (set(archs) & known):
        log.warning("untested architecture %s — loading with llama layout", archs)
    # Qwen2 hardcodes QKV bias (no config field); llama's attention_bias
    # also puts a bias on o_proj, which the model does not implement, so
    # such checkpoints fail in load_params instead of half-loading.
    attn_bias = "Qwen2ForCausalLM" in archs
    hidden = int(hf["hidden_size"])
    heads = int(hf["num_attention_heads"])
    head_dim = int(hf.get("head_dim") or hidden // heads)
    return ModelConfig(
        name=os.path.basename(os.path.normpath(model_path)) or hf.get("model_type", "hf-model"),
        vocab_size=int(hf["vocab_size"]),
        hidden_size=hidden,
        intermediate_size=int(hf["intermediate_size"]),
        num_layers=int(hf["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(hf.get("num_key_value_heads") or heads),
        head_dim=head_dim,
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        max_position=int(hf.get("max_position_embeddings", 8192)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        attn_bias=attn_bias,
        dtype=str(hf.get("torch_dtype", "bfloat16")).replace("torch.", ""),
    )


def _safetensor_files(model_path: str) -> list[str]:
    index = os.path.join(model_path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({os.path.join(model_path, v) for v in weight_map.values()})
    single = os.path.join(model_path, "model.safetensors")
    if os.path.exists(single):
        return [single]
    found = sorted(
        os.path.join(model_path, f)
        for f in os.listdir(model_path)
        if f.endswith(".safetensors")
    )
    if not found:
        raise FileNotFoundError(f"no *.safetensors under {model_path}")
    return found


def _read_all_tensors(model_path: str) -> dict[str, torch.Tensor]:
    """Every tensor as a CPU tensor viewing its mapped file."""
    out: dict[str, torch.Tensor] = {}
    for path in _safetensor_files(model_path):
        f = SafeTensorsFile(path)
        for name in f.keys():
            out[name] = f.tensor(name)
    return out


def load_params(model_path: str, cfg: ModelConfig, dtype: Any = None, quant: str = "none",
                device: str | torch.device = "cuda"):
    """safetensors → the engine params tree on ``device``: per-layer
    tensors stacked into [L, ...] leaves, then ``finalize_params``."""
    device = resolve_device(device)
    raw = _read_all_tensors(model_path)

    def take(name: str) -> torch.Tensor:
        try:
            return raw.pop(name)
        except KeyError:
            raise KeyError(f"checkpoint {model_path} missing tensor {name!r}") from None

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        per = [take(fmt.format(i=i)) for i in range(cfg.num_layers)]
        return torch.stack([p.T if transpose else p for p in per])

    L = "model.layers.{i}"
    params: dict[str, Any] = {
        "embed": take("model.embed_tokens.weight"),
        "layers": {ours: stack(f"{L}.{hf}", tr) for ours, (hf, tr) in _LAYER_NAMES.items()},
        "final_norm": take("model.norm.weight"),
    }
    if cfg.attn_bias:
        for ours, hf in _BIAS_NAMES.items():
            params["layers"][ours] = stack(f"{L}.{hf}", False)
    if not cfg.tie_embeddings:
        params["lm_head"] = take("lm_head.weight").T
    else:
        raw.pop("lm_head.weight", None)  # some tied checkpoints still store it
    leftovers = [k for k in raw if not k.endswith("rotary_emb.inv_freq")]
    biases = [k for k in leftovers if k.endswith(".bias")]
    if biases:
        # Same policy as the GGUF loader: silently dropping projection
        # biases serves wrong logits with no diagnostic.
        raise NotImplementedError(
            f"checkpoint has {len(biases)} unsupported bias tensors (e.g. "
            f"{biases[0]}) — only QKV bias (attn_bias architectures) is wired"
        )
    if leftovers:
        log.warning("ignoring %d unexpected tensors (e.g. %s)", len(leftovers), leftovers[:3])

    # Shape validation before any device transfer.
    expect = {
        "embed": (cfg.vocab_size, cfg.hidden_size),
        ("layers", "wq"): (cfg.num_layers, cfg.hidden_size, cfg.q_size),
        ("layers", "wk"): (cfg.num_layers, cfg.hidden_size, cfg.kv_size),
        ("layers", "wv"): (cfg.num_layers, cfg.hidden_size, cfg.kv_size),
        ("layers", "wo"): (cfg.num_layers, cfg.q_size, cfg.hidden_size),
        ("layers", "w_gate"): (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size),
        ("layers", "w_up"): (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size),
        ("layers", "w_down"): (cfg.num_layers, cfg.intermediate_size, cfg.hidden_size),
    }
    for key, shape in expect.items():
        leaf = params[key] if isinstance(key, str) else params[key[0]][key[1]]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {tuple(leaf.shape)} != expected {shape}")

    return finalize_params(params, dtype=dtype, quant=quant, device=device)


def finalize_params(params: dict, dtype: Any = None, quant: str = "none",
                    device: str | torch.device = "cuda"):
    """Shared checkpoint tail (safetensors + GGUF): optional int8
    quantization, then each leaf converted and placed on ``device`` with
    one copy. int8 weights keep their dtype; every other leaf goes to the
    serving dtype, scales included, as the JAX loader does.

    A bf16 staging copy of an 8B model on the device is what int8 exists
    to avoid, so the device quantizes one layer slice at a time
    (``quantize_params_device``, bit-equal to the host quantizer)."""
    dtype = _torch_dtype(dtype)
    device = resolve_device(device)
    if quant == "int8":
        params = quantize_params_device(params, device)

    def place(leaf: Any) -> Any:
        if isinstance(leaf, dict):
            return {k: place(v) for k, v in leaf.items()}
        t = torch.from_numpy(leaf) if isinstance(leaf, np.ndarray) else leaf
        if t.dtype != torch.int8 and t.dtype != dtype:
            t = t.to(dtype)
        return t.contiguous().to(device)

    return place(params)


def load_config(name_or_path: str) -> ModelConfig:
    """Config only (no weights): local HF dir, .gguf file, or hub name."""
    from dynamo_tpu_torch.engine.hub import is_gguf, resolve_model

    path = resolve_model(name_or_path)
    if is_gguf(path):
        from dynamo_tpu_torch.engine.gguf import GGUFFile

        return GGUFFile(path).model_config()
    return config_from_hf(path)


def load_model(name_or_path: str, dtype: Any = None, quant: str = "none",
               device: str | torch.device = "cuda"):
    """→ (ModelConfig, params on ``device``). Accepts a local HF checkpoint
    directory, a .gguf file, or an `org/repo` hub name resolved through the
    HF hub cache (engine/hub.py)."""
    from dynamo_tpu_torch.engine.hub import is_gguf, resolve_model

    model_path = resolve_model(name_or_path)
    if is_gguf(model_path):
        from dynamo_tpu_torch.engine.gguf import load_gguf_model

        return load_gguf_model(model_path, dtype=dtype, quant=quant, device=device)
    cfg = config_from_hf(model_path)
    params = load_params(model_path, cfg, dtype=dtype, quant=quant, device=device)
    log.info("loaded %s: %.2f GB of weights from %s", cfg.name, _nbytes(params) / 1e9, model_path)
    return cfg, params


def _nbytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _hf_tensors(cfg: ModelConfig, params: dict) -> dict[str, torch.Tensor]:
    """A float params tree (CPU tensors) → HF tensor names, the inverse of
    ``load_params``'s mapping."""
    out = {"model.embed_tokens.weight": params["embed"]}
    names = dict(_LAYER_NAMES)
    if cfg.attn_bias:
        names.update({k: (v, False) for k, v in _BIAS_NAMES.items()})
    for i in range(cfg.num_layers):
        for ours, (hf, tr) in names.items():
            t = params["layers"][ours][i]
            out[f"model.layers.{i}.{hf}"] = t.T.contiguous() if tr else t.contiguous()
    out["model.norm.weight"] = params["final_norm"]
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = params["lm_head"].T.contiguous()
    return out


def save_checkpoint(path: str, cfg: ModelConfig, params: dict, shards: int = 1) -> None:
    """Write ``params`` (a float tree of CPU tensors) as an HF Llama-family
    directory: ``config.json`` and ``model.safetensors``, or ``shards``
    files with a ``model.safetensors.index.json``."""
    os.makedirs(path, exist_ok=True)
    tensors = _hf_tensors(cfg, params)
    dtype = next(iter(tensors.values())).dtype
    hf = {
        "architectures": ["Qwen2ForCausalLM" if cfg.attn_bias else "LlamaForCausalLM"],
        "model_type": "qwen2" if cfg.attn_bias else "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps, "max_position_embeddings": cfg.max_position,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": str(dtype).replace("torch.", ""),
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    if shards <= 1:
        save_file(tensors, os.path.join(path, "model.safetensors"), {"format": "pt"})
        return
    names = list(tensors)
    per = -(-len(names) // shards)
    weight_map, total = {}, 0
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[s * per:(s + 1) * per]}
        save_file(part, os.path.join(path, fname), {"format": "pt"})
        weight_map.update({n: fname for n in part})
        total += sum(t.numel() * t.element_size() for t in part.values())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
