"""GGUF checkpoint ingestion: metadata and tensors (port of
``dynamo_tpu/engine/gguf.py``).

GGUF feeds the same params tree as safetensors (engine/loader.py): a
llama-family GGUF file becomes (ModelConfig, params), so `--model-path
model.gguf` serves like an HF directory. Tensors come back as CPU torch
tensors: BF16 through an int16 view (torch has bfloat16; no ml_dtypes).
The GGUF vocabulary (``tokenizer_from_gguf``) waits for the port's
tokenizer slice.

Format (GGUF v2/v3, little-endian):
  magic "GGUF" | u32 version | u64 n_tensors | u64 n_kv
  n_kv x (string key | u32 type | value)       -- metadata
  n_tensors x (string name | u32 n_dims | u64 dims[] | u32 ggml_type
               | u64 offset)                   -- tensor directory
  padding to `general.alignment` (default 32)  -- then tensor data

ggml dims are fastest-axis-first; reading row-major therefore yields the
REVERSED numpy shape, which for weight matrices is (out, in) — the same
orientation as HF *.weight tensors, so the loader transposes identically.

Quantized tensors: Q8_0 (32-element blocks: f16 scale + 32xi8) is
dequantized on the host; F16/BF16/F32 load directly. Other ggml quants
are rejected with a clear error (serve those via --quant int8 on a
F16/F32 export instead).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("gguf")

GGUF_MAGIC = b"GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = range(8, 13)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<B",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor types (ggml.h)
GGML_F32, GGML_F16 = 0, 1
GGML_Q8_0 = 8
GGML_BF16 = 30
_TYPE_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_Q8_0: "Q8_0", GGML_BF16: "BF16"}


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype == _T_STRING:
        return _read_str(f)
    if vtype == _T_ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        if etype == _T_STRING:
            return [_read_str(f) for _ in range(count)]
        fmt = _SCALAR_FMT[etype]
        size = struct.calcsize(fmt)
        raw = f.read(size * count)
        vals = [struct.unpack_from(fmt, raw, i * size)[0] for i in range(count)]
        if etype == _T_BOOL:
            vals = [bool(v) for v in vals]
        return vals
    fmt = _SCALAR_FMT[vtype]
    (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
    return bool(v) if vtype == _T_BOOL else v


class GGUFTensorInfo:
    __slots__ = ("name", "shape", "ggml_type", "offset")

    def __init__(self, name: str, shape: tuple[int, ...], ggml_type: int, offset: int):
        self.name = name
        self.shape = shape          # numpy shape (ggml dims reversed)
        self.ggml_type = ggml_type
        self.offset = offset        # relative to data-section start


class GGUFFile:
    """Parsed GGUF: metadata dict + tensor directory + lazy tensor reads."""

    def __init__(self, path: str):
        self.path = path
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        with open(path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            (version,) = struct.unpack("<I", f.read(4))
            if version not in (2, 3):
                raise ValueError(f"{path}: unsupported GGUF version {version}")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_str(f)
                (vtype,) = struct.unpack("<I", f.read(4))
                self.metadata[key] = _read_value(f, vtype)
            for _ in range(n_tensors):
                name = _read_str(f)
                (n_dims,) = struct.unpack("<I", f.read(4))
                dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                ggml_type, offset = struct.unpack("<IQ", f.read(4 + 8))
                self.tensors[name] = GGUFTensorInfo(
                    name, tuple(reversed(dims)), ggml_type, offset
                )
            align = int(self.metadata.get("general.alignment", 32))
            pos = f.tell()
            self._data_start = (pos + align - 1) // align * align

    # -- tensor reads ------------------------------------------------------

    def tensor(self, name: str) -> torch.Tensor:
        """Read + dequantize one tensor (a CPU tensor, f32 for quantized)."""
        info = self.tensors.get(name)
        if info is None:
            raise KeyError(f"{self.path}: missing tensor {name!r}")
        n = int(np.prod(info.shape))
        with open(self.path, "rb") as f:
            f.seek(self._data_start + info.offset)
            if info.ggml_type == GGML_F32:
                a = torch.from_numpy(np.frombuffer(bytearray(f.read(4 * n)), np.float32))
            elif info.ggml_type == GGML_F16:
                a = torch.from_numpy(np.frombuffer(bytearray(f.read(2 * n)), np.float16))
            elif info.ggml_type == GGML_BF16:
                a = torch.from_numpy(np.frombuffer(bytearray(f.read(2 * n)), np.int16))
                a = a.view(torch.bfloat16)
            elif info.ggml_type == GGML_Q8_0:
                if n % 32:
                    raise ValueError(f"{name}: Q8_0 tensor size {n} not /32")
                raw = np.frombuffer(f.read(34 * (n // 32)), np.uint8).reshape(-1, 34)
                scale = raw[:, :2].copy().view(np.float16).astype(np.float32)  # [nb, 1]
                qs = raw[:, 2:].view(np.int8).astype(np.float32)               # [nb, 32]
                a = torch.from_numpy((qs * scale).reshape(-1))
            else:
                tname = _TYPE_NAMES.get(info.ggml_type, str(info.ggml_type))
                raise NotImplementedError(
                    f"{name}: ggml type {tname} not supported — re-export as "
                    f"F16/BF16/F32 (serve quantized via --quant int8)"
                )
        return a.reshape(info.shape)

    # -- metadata → ModelConfig -------------------------------------------

    def model_config(self, name: str | None = None) -> ModelConfig:
        md = self.metadata
        arch = md.get("general.architecture", "llama")
        if arch not in ("llama", "mistral", "qwen2"):
            log.warning("untested GGUF architecture %r — loading with llama layout", arch)

        def k(suffix: str, default=None):
            return md.get(f"{arch}.{suffix}", default)

        hidden = int(k("embedding_length"))
        heads = int(k("attention.head_count"))
        head_dim = int(k("attention.key_length") or hidden // heads)
        vocab = md.get(f"{arch}.vocab_size")
        if vocab is None:
            vocab = len(md.get("tokenizer.ggml.tokens", []))
            if not vocab:
                raise ValueError("GGUF missing vocab_size and tokenizer tokens")
        tied = "output.weight" not in self.tensors
        # Qwen2 GGUFs carry QKV bias tensors; detect from the tensor list
        # (no metadata flag exists).
        attn_bias = "blk.0.attn_q.bias" in self.tensors
        return ModelConfig(
            name=name or md.get("general.name") or "gguf-model",
            vocab_size=int(vocab),
            hidden_size=hidden,
            intermediate_size=int(k("feed_forward_length")),
            num_layers=int(k("block_count")),
            num_heads=heads,
            num_kv_heads=int(k("attention.head_count_kv") or heads),
            head_dim=head_dim,
            rope_theta=float(k("rope.freq_base", 10000.0)),
            rms_norm_eps=float(k("attention.layer_norm_rms_epsilon", 1e-5)),
            max_position=int(k("context_length", 8192)),
            tie_embeddings=tied,
            attn_bias=attn_bias,
        )

    def eos_token_ids(self) -> list[int]:
        out = []
        for key in ("tokenizer.ggml.eos_token_id",):
            v = self.metadata.get(key)
            if v is not None:
                out.append(int(v))
        return out


# ---------------------------------------------------------------------------
# params pytree
# ---------------------------------------------------------------------------

_LAYER_MAP = {
    # ours → gguf name fmt (numpy shape (out, in) → transpose, like HF)
    "wq": ("blk.{i}.attn_q.weight", True),
    "wk": ("blk.{i}.attn_k.weight", True),
    "wv": ("blk.{i}.attn_v.weight", True),
    "wo": ("blk.{i}.attn_output.weight", True),
    "w_gate": ("blk.{i}.ffn_gate.weight", True),
    "w_up": ("blk.{i}.ffn_up.weight", True),
    "w_down": ("blk.{i}.ffn_down.weight", True),
    "attn_norm": ("blk.{i}.attn_norm.weight", False),
    "mlp_norm": ("blk.{i}.ffn_norm.weight", False),
}


def load_gguf_params(
    g: GGUFFile,
    cfg: ModelConfig,
    dtype: Any = None,
    quant: str = "none",
    device: str | torch.device = "cuda",
):
    """GGUF tensors → the engine params tree on ``device`` (same contract
    as loader.load_params; placement via loader.finalize_params)."""
    from dynamo_tpu_torch.engine.loader import finalize_params

    consumed: set[str] = set()

    def take(name: str) -> torch.Tensor:
        consumed.add(name)
        return g.tensor(name)

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        per = [take(fmt.format(i=i)) for i in range(cfg.num_layers)]
        return torch.stack([p.T if transpose else p for p in per])

    params: dict[str, Any] = {
        "embed": take("token_embd.weight"),
        "layers": {
            ours: stack(fmt, tr) for ours, (fmt, tr) in _LAYER_MAP.items()
        },
        "final_norm": take("output_norm.weight"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = take("output.weight").T
    if cfg.attn_bias:
        params["layers"]["bq"] = stack("blk.{i}.attn_q.bias", False)
        params["layers"]["bk"] = stack("blk.{i}.attn_k.bias", False)
        params["layers"]["bv"] = stack("blk.{i}.attn_v.bias", False)

    leftovers = sorted(set(g.tensors) - consumed)
    biases = [n for n in leftovers if n.endswith(".bias")]
    if biases:
        # Silently dropping OTHER projection biases would serve garbage
        # logits with no diagnostic (QKV bias is handled above).
        raise NotImplementedError(
            f"GGUF has {len(biases)} unsupported bias tensors (e.g. "
            f"{biases[0]})"
        )
    if leftovers:
        log.warning("ignoring %d unexpected GGUF tensors (e.g. %s)",
                    len(leftovers), leftovers[:3])

    expect = {
        "embed": (cfg.vocab_size, cfg.hidden_size),
        ("layers", "wq"): (cfg.num_layers, cfg.hidden_size, cfg.q_size),
        ("layers", "w_down"): (cfg.num_layers, cfg.intermediate_size, cfg.hidden_size),
    }
    for key, shape in expect.items():
        leaf = params[key] if isinstance(key, str) else params[key[0]][key[1]]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{key}: GGUF shape {tuple(leaf.shape)} != expected {shape}")

    return finalize_params(params, dtype=dtype, quant=quant, device=device)


def load_gguf_model(path: str, dtype: Any = None, quant: str = "none",
                    device: str | torch.device = "cuda"):
    """→ (ModelConfig, params) from a .gguf file."""
    g = GGUFFile(path)
    cfg = g.model_config()
    params = load_gguf_params(g, cfg, dtype=dtype, quant=quant, device=device)
    log.info("loaded %s from GGUF %s", cfg.name, path)
    return cfg, params
