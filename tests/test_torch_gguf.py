"""The port's GGUF ingestion and hub resolution against the JAX package's,
on the CPU (mirrors tests/test_gguf.py).

A GGUF v3 writer lives here: tests/test_gguf.py's, with BF16 tensors
added (ggml type 30). Files are written from the JAX package's test-tiny
params and read by both packages:

- the metadata gives the same ModelConfig and EOS ids;
- F32, F16, BF16 and Q8_0 tensors equal the JAX reads bit for bit
  (Q8_0 dequantizes to the same f32 values);
- ``load_gguf_model`` gives the JAX loader's leaves bit for bit at quant
  none and int8, and its prefill logits equal the JAX prefill's on the
  directly-built params to 1e-4 (float32; the frameworks differ only in
  summation order);
- Qwen2-style QKV bias tensors load;
- unsupported ggml types are rejected with the JAX message;
- an `org/repo` name resolves through the hub cache offline, with the JAX
  package's errors for an unknown pin, an absent repo and a bad path.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import gguf as JG
from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine import gguf as TG
from dynamo_tpu_torch.engine import hub as TH
from dynamo_tpu_torch.engine import loader as TL
from dynamo_tpu_torch.engine import model as TM

CPU = torch.device("cpu")

# -- minimal GGUF v3 writer (tests/test_gguf.py's, plus BF16) ---------------------

_T_U32, _T_F32, _T_STRING, _T_ARRAY, _T_U64 = 4, 6, 8, 9, 10
_ALIGN = 32


def _w_str(out: bytearray, s: str):
    b = s.encode()
    out += struct.pack("<Q", len(b)) + b


def _w_kv(out: bytearray, key: str, vtype: int, value):
    _w_str(out, key)
    out += struct.pack("<I", vtype)
    if vtype == _T_STRING:
        _w_str(out, value)
    elif vtype == _T_U32:
        out += struct.pack("<I", value)
    elif vtype == _T_F32:
        out += struct.pack("<f", value)
    elif vtype == _T_ARRAY:
        etype, vals = value
        out += struct.pack("<IQ", etype, len(vals))
        for v in vals:
            if etype == _T_STRING:
                _w_str(out, v)
            else:
                out += struct.pack("<f", v)
    else:
        raise NotImplementedError


def _q8_0(a: np.ndarray) -> bytes:
    flat = a.astype(np.float32).reshape(-1, 32)
    d = np.abs(flat).max(axis=1) / 127.0
    d = np.where(d == 0, 1.0, d)
    qs = np.clip(np.rint(flat / d[:, None]), -127, 127).astype(np.int8)
    out = bytearray()
    for i in range(flat.shape[0]):
        out += np.float16(d[i]).tobytes() + qs[i].tobytes()
    return bytes(out)


def _bf16(a: np.ndarray) -> bytes:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().tobytes()


def write_gguf(path: str, metadata: list[tuple], tensors: dict[str, tuple]):
    head = bytearray(b"GGUF")
    head += struct.pack("<I", 3)
    head += struct.pack("<QQ", len(tensors), len(metadata))
    for key, vtype, value in metadata:
        _w_kv(head, key, vtype, value)
    blobs, offset = [], 0
    for name, (arr, gtype) in tensors.items():
        blob = {0: lambda a: np.ascontiguousarray(a, np.float32).tobytes(),
                1: lambda a: np.ascontiguousarray(a, np.float16).tobytes(),
                8: lambda a: _q8_0(np.ascontiguousarray(a)), 30: _bf16}[gtype](arr)
        _w_str(head, name)
        dims = tuple(reversed(arr.shape))
        head += struct.pack("<I", len(dims))
        head += struct.pack(f"<{len(dims)}Q", *dims)
        head += struct.pack("<IQ", gtype, offset)
        pad = (-len(blob)) % _ALIGN
        blobs.append(blob + b"\0" * pad)
        offset += len(blob) + pad
    pad = (-len(head)) % _ALIGN
    with open(path, "wb") as f:
        f.write(bytes(head) + b"\0" * pad + b"".join(blobs))


def tiny_gguf(path: str, cfg: JCfg, params_np: dict, quant_map: dict | None = None):
    tokens = ["<unk>", "<s>", "</s>"] + [f"▁w{i}" for i in range(cfg.vocab_size - 3)]
    meta = [
        ("general.architecture", _T_STRING, "llama"),
        ("general.name", _T_STRING, "tiny-gguf"),
        ("llama.context_length", _T_U32, cfg.max_position),
        ("llama.embedding_length", _T_U32, cfg.hidden_size),
        ("llama.block_count", _T_U32, cfg.num_layers),
        ("llama.feed_forward_length", _T_U32, cfg.intermediate_size),
        ("llama.attention.head_count", _T_U32, cfg.num_heads),
        ("llama.attention.head_count_kv", _T_U32, cfg.num_kv_heads),
        ("llama.attention.key_length", _T_U32, cfg.head_dim),
        ("llama.rope.freq_base", _T_F32, cfg.rope_theta),
        ("llama.attention.layer_norm_rms_epsilon", _T_F32, cfg.rms_norm_eps),
        ("llama.vocab_size", _T_U32, cfg.vocab_size),
        ("tokenizer.ggml.model", _T_STRING, "llama"),
        ("tokenizer.ggml.tokens", _T_ARRAY, (_T_STRING, tokens)),
        ("tokenizer.ggml.bos_token_id", _T_U32, 1),
        ("tokenizer.ggml.eos_token_id", _T_U32, 2),
    ]
    qm = quant_map or {}
    tensors = {"token_embd.weight": (params_np["embed"], qm.get("token_embd", 0)),
               "output_norm.weight": (params_np["final_norm"], 0)}
    lmap = {"attn_q": ("wq", True), "attn_k": ("wk", True), "attn_v": ("wv", True),
            "attn_output": ("wo", True), "ffn_gate": ("w_gate", True),
            "ffn_up": ("w_up", True), "ffn_down": ("w_down", True),
            "attn_norm": ("attn_norm", False), "ffn_norm": ("mlp_norm", False)}
    for i in range(cfg.num_layers):
        for gname, (ours, tr) in lmap.items():
            a = params_np["layers"][ours][i]
            tensors[f"blk.{i}.{gname}.weight"] = (a.T if tr else a, qm.get(gname, 0))
    if not cfg.tie_embeddings:
        tensors["output.weight"] = (params_np["lm_head"].T, qm.get("output", 0))
    if cfg.attn_bias:
        for i in range(cfg.num_layers):
            for gname, ours in (("attn_q", "bq"), ("attn_k", "bk"), ("attn_v", "bv")):
                tensors[f"blk.{i}.{gname}.bias"] = (params_np["layers"][ours][i], 0)
    write_gguf(path, meta, tensors)


# Every supported type on some tensor: F32 norms, F16 q, BF16 k/v/down and
# the head, Q8_0 up/gate.
MIXED = {"attn_q": 1, "attn_k": 30, "attn_v": 30, "ffn_down": 30, "output": 30,
         "ffn_up": 8, "ffn_gate": 8}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg = JCfg(tie_embeddings=False)
    params_np = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(3), jnp.float32))
    d = tmp_path_factory.mktemp("gguf")
    plain, mixed = str(d / "tiny.gguf"), str(d / "mixed.gguf")
    tiny_gguf(plain, cfg, params_np)
    tiny_gguf(mixed, cfg, params_np, MIXED)
    return cfg, params_np, plain, mixed


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_metadata_to_model_config(tiny):
    cfg, _, path, _ = tiny
    got, want = TG.GGUFFile(path).model_config(), JG.GGUFFile(path).model_config()
    for field in ("name", "vocab_size", "hidden_size", "intermediate_size", "num_layers",
                  "num_heads", "num_kv_heads", "head_dim", "rope_theta", "rms_norm_eps",
                  "max_position", "tie_embeddings", "attn_bias"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.hidden_size == cfg.hidden_size and not got.tie_embeddings
    assert TG.GGUFFile(path).eos_token_ids() == JG.GGUFFile(path).eos_token_ids() == [2]
    assert TG.GGUFFile(path).metadata == JG.GGUFFile(path).metadata


def test_tensor_reads_equal_jax(tiny):
    _, _, _, mixed = tiny
    t, j = TG.GGUFFile(mixed), JG.GGUFFile(mixed)
    seen = set()
    for name, info in j.tensors.items():
        a, b = j.tensor(name), t.tensor(name)
        seen.add(info.ggml_type)
        assert tuple(b.shape) == a.shape
        if info.ggml_type == JG.GGML_BF16:
            assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32), err_msg=name)
    assert seen == {JG.GGML_F32, JG.GGML_F16, JG.GGML_BF16, JG.GGML_Q8_0}


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_load_gguf_model_bit_equal_to_jax(tiny, quant):
    _, _, _, mixed = tiny
    jcfg, jp = JG.load_gguf_model(mixed, dtype=jnp.float32, quant=quant)
    tcfg, tp = TL.load_model(mixed, dtype="float32", quant=quant, device="cpu")
    assert tcfg.vocab_size == jcfg.vocab_size
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x, tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))[0])
    assert len(flat_j) == len(flat_t)
    for path, a in flat_j:
        b = flat_t[path]
        assert str(np.asarray(a).dtype) == str(b.dtype).removeprefix("torch."), path
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(path))


def test_logit_parity_via_load_model(tiny):
    cfg, params_np, path, _ = tiny
    tcfg, tparams = TL.load_model(path, dtype="float32", device="cpu")
    toks = np.array([5, 9, 17, 3], np.int32)
    want, _ = JM.prefill(cfg, jax.tree.map(jnp.asarray, params_np),
                         JM.init_kv_cache(cfg, 8, 4, jnp.float32), jnp.asarray(toks),
                         jnp.asarray(np.array([1, 2], np.int32)), jnp.int32(0), jnp.int32(4))
    got = TM.prefill(tcfg, tparams, TM.init_kv_cache(tcfg, 8, 4, torch.float32, CPU),
                     torch.from_numpy(toks), torch.tensor([1, 2], dtype=torch.int32), 0, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_gguf_attn_bias_loads(tmp_path):
    cfg = JCfg(name="bias-gguf", vocab_size=64, hidden_size=32, intermediate_size=64,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8, attn_bias=True)
    params_np = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(5), jnp.float32))
    path = str(tmp_path / "bias.gguf")
    tiny_gguf(path, cfg, params_np)
    assert TG.GGUFFile(path).model_config().attn_bias
    _, lp = TG.load_gguf_model(path, dtype="float32", device="cpu")
    np.testing.assert_array_equal(lp["layers"]["bq"].numpy(), params_np["layers"]["bq"])


def test_unsupported_ggml_type_rejected(tiny):
    _, _, path, _ = tiny
    g = TG.GGUFFile(path)
    g.tensors["token_embd.weight"].ggml_type = 2  # Q4_0
    with pytest.raises(NotImplementedError, match="re-export"):
        g.tensor("token_embd.weight")
    with open(path, "rb") as f:
        head = f.read(4)
    assert head == b"GGUF" and TH.is_gguf(path)


def test_hub_cache_resolution(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    assert TH.hub_cache_dir() == str(tmp_path / "hub")
    snap = tmp_path / "hub" / "models--acme--tiny" / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text("{}")
    refs = tmp_path / "hub" / "models--acme--tiny" / "refs"
    refs.mkdir()
    (refs / "main").write_text("abc123")
    assert TH.resolve_model("acme/tiny") == str(snap)
    assert TH.resolve_model("acme/tiny", revision="abc123") == str(snap)
    with pytest.raises(FileNotFoundError, match="abc999"):
        TH.resolve_model("acme/tiny", revision="abc999")
    assert TH.resolve_model(str(snap)) == str(snap)
    with pytest.raises(FileNotFoundError, match="hub cache"):
        TH.resolve_model("acme/absent")
    with pytest.raises(FileNotFoundError, match="org/repo"):
        TH.resolve_model("/no/such/path")
    # Without HF_HUB_OFFLINE and without huggingface_hub (absent on the
    # card's machine), the same remedy.
    monkeypatch.delenv("HF_HUB_OFFLINE")
    monkeypatch.setitem(__import__("sys").modules, "huggingface_hub", None)
    with pytest.raises(FileNotFoundError, match="pre-populate the cache"):
        TH.resolve_model("acme/absent")

