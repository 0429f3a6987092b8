"""The port's checkpoint loader against the JAX package's, on the CPU
(mirrors tests/test_loader.py).

- The port's safetensors reader equals ``safetensors.numpy`` on single and
  sharded checkpoints in F32, F16 and BF16, and its writer's files read
  back through ``safetensors.numpy`` unchanged.
- ``load_model`` gives the JAX ``load_model``'s leaves bit for bit, at
  quant none and int8, serving dtype float32 and bfloat16 (same names,
  transposes, host-side quantization, scales converted to the serving
  dtype), single-file and sharded.
- Logits of the loaded weights: the port's prefill against transformers'
  forward (tied and untied heads, Qwen2's QKV bias) to 2e-4, the JAX
  test's bound (float32, two layers).
- A missing tensor, an unsupported bias and an unsupported dtype raise.
  The first two raise the JAX loader's errors. For dtypes the port's
  reader serves F32/F16/BF16/I8 and names any other, where the JAX loader
  reads whatever ``safetensors.numpy`` can and casts it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from safetensors.numpy import load_file, save_file  # noqa: E402

from dynamo_tpu.engine.loader import load_model as jax_load_model  # noqa: E402
from dynamo_tpu_torch.engine import loader as TL  # noqa: E402
from dynamo_tpu_torch.engine import model as TM  # noqa: E402
from dynamo_tpu_torch.engine import safetensors_io as sio  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_hf_llama(tmp_path, tie: bool, name: str = "tiny-llama", dtype=torch.float32):
    cfg = transformers.LlamaConfig(
        vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=tie, torch_dtype="float32",
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    path = tmp_path / name
    model.to(dtype).save_pretrained(path, safe_serialization=True)
    return model.float(), str(path)


def _shard(path: str, n: int = 2) -> None:
    """Split model.safetensors into n shards plus an index (as HF does)."""
    tensors = load_file(os.path.join(path, "model.safetensors"))
    names = sorted(tensors)
    per = -(-len(names) // n)
    weight_map = {}
    for s in range(n):
        fname = f"model-{s + 1:05d}-of-{n:05d}.safetensors"
        part = {k: tensors[k] for k in names[s * per:(s + 1) * per]}
        save_file(part, os.path.join(path, fname))
        weight_map.update({k: fname for k in part})
    os.remove(os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": weight_map}, f)


def _as_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_reader_matches_safetensors(tmp_path, dtype):
    rng = np.random.default_rng(0)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    tensors = {f"t{i}": rng.standard_normal(shape).astype(np_dt)
               for i, shape in enumerate([(3, 5), (7,), (2, 3, 4), (1, 1), (0, 4)])}
    tensors["i8"] = rng.integers(-128, 128, (4, 9)).astype(np.int8)
    save_file(tensors, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    f = sio.SafeTensorsFile(str(tmp_path / "a.safetensors"))
    assert sorted(f.keys()) == sorted(tensors) and f.metadata == {"format": "np"}
    for name, want in tensors.items():
        got = f.tensor(name)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_as_np(got), want)
    # The port's writer, read back by the safetensors package.
    sio.save_file({k: f.tensor(k) for k in f.keys()}, str(tmp_path / "b.safetensors"))
    back = load_file(str(tmp_path / "b.safetensors"))
    for name, want in tensors.items():
        np.testing.assert_array_equal(back[name], want)
        assert back[name].dtype == want.dtype


def _assert_trees_equal(port_params, jax_params):
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax_params)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, port_params, is_leaf=lambda x: isinstance(x, torch.Tensor)))[0])
    assert sorted(map(str, flat_j)) == sorted(map(str, flat_t))
    for path, a in flat_j.items():
        b = flat_t[path]
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
        assert b.is_contiguous(), path
        np.testing.assert_array_equal(_as_np(b), a, err_msg=str(path))


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_model_bit_equal_to_jax(tmp_path, sharded, quant, dtype):
    _, path = make_hf_llama(tmp_path, tie=False, dtype=torch.bfloat16)
    if sharded:
        _shard(path)
    jcfg, jparams = jax_load_model(path, dtype=jnp.dtype(dtype), quant=quant)
    tcfg, tparams = TL.load_model(path, dtype=dtype, quant=quant, device="cpu")
    assert tcfg.name == jcfg.name and tcfg.vocab_size == jcfg.vocab_size
    assert tcfg.num_kv_heads == jcfg.num_kv_heads and tcfg.max_position == jcfg.max_position
    _assert_trees_equal(tparams, jparams)
    if quant == "int8":
        assert tparams["layers"]["wq"].dtype == torch.int8
        assert tparams["lm_head_scale"].dtype == getattr(torch, dtype)


def _prefill_last(cfg, params, toks):
    bs = 4
    T = len(toks)
    nb = -(-T // bs)
    cache = TM.init_kv_cache(cfg, 16, bs, torch.float32, CPU)
    pad = torch.zeros(nb * bs, dtype=torch.int32)
    pad[:T] = torch.from_numpy(toks)
    table = torch.arange(1, nb + 1, dtype=torch.int32)
    return TM.prefill(cfg, params, cache, pad, table, 0, T).numpy()


@pytest.mark.parametrize("tie", [False, True])
def test_logit_parity_with_transformers(tmp_path, tie):
    hf, path = make_hf_llama(tmp_path, tie)
    cfg, params = TL.load_model(path, dtype="float32", device="cpu")
    assert cfg.tie_embeddings == tie and cfg.num_heads == 4
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size - 1, size=12).astype(np.int32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks[None].astype(np.int64))).logits[0, -1].numpy()
    np.testing.assert_allclose(_prefill_last(cfg, params, toks), ref, rtol=2e-4, atol=2e-4)


def test_qwen2_attn_bias_loaded(tmp_path):
    qcfg = transformers.Qwen2Config(
        vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False, torch_dtype="float32",
    )
    torch.manual_seed(1)
    hf = transformers.Qwen2ForCausalLM(qcfg).eval()
    with torch.no_grad():
        for layer in hf.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj):
                proj.bias.normal_(0.0, 0.5)
    path = tmp_path / "tiny-qwen2"
    hf.save_pretrained(path, safe_serialization=True)
    cfg, params = TL.load_model(str(path), dtype="float32", device="cpu")
    assert cfg.attn_bias and params["layers"]["bq"].shape == (2, 64)
    _, jparams = jax_load_model(str(path), dtype=jnp.float32)
    _assert_trees_equal(params, jparams)
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size - 1, size=10).astype(np.int32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks[None].astype(np.int64))).logits[0, -1].numpy()
    np.testing.assert_allclose(_prefill_last(cfg, params, toks), ref, rtol=2e-4, atol=2e-4)


def test_save_checkpoint_round_trips_through_both_loaders(tmp_path):
    """The writer chip_smoke.py uses: a seeded random tree written as two
    shards loads back bit for bit through the port and the JAX loader."""
    cfg = TL.ModelConfig(vocab_size=96, hidden_size=64, intermediate_size=96, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=16, tie_embeddings=False)
    tree = TM.init_params(cfg, CPU, torch.bfloat16, seed=5)
    path = str(tmp_path / "written")
    TL.save_checkpoint(path, cfg, tree, shards=2)
    assert os.path.exists(os.path.join(path, "model.safetensors.index.json"))
    got_cfg, got = TL.load_model(path, device="cpu")
    assert (got_cfg.hidden_size, got_cfg.num_layers, got_cfg.tie_embeddings) == (64, 2, False)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert torch.equal(a, b)
    _, jparams = jax_load_model(path, quant="int8")
    _, tq = TL.load_model(path, quant="int8", device="cpu")
    _assert_trees_equal(tq, jparams)


def test_missing_tensor_unsupported_bias_and_dtype_raise(tmp_path):
    _, path = make_hf_llama(tmp_path, tie=False)
    st = os.path.join(path, "model.safetensors")
    tensors = load_file(st)
    save_file({k: v for k, v in tensors.items() if k != "model.layers.1.mlp.up_proj.weight"}, st)
    for load in (lambda: TL.load_model(path, dtype="float32", device="cpu"),
                 lambda: jax_load_model(path, dtype=jnp.float32)):
        with pytest.raises(KeyError, match="up_proj"):
            load()
    save_file(dict(tensors, **{"model.layers.0.self_attn.o_proj.bias":
                               np.zeros(64, np.float32)}), st)
    for load in (lambda: TL.load_model(path, dtype="float32", device="cpu"),
                 lambda: jax_load_model(path, dtype=jnp.float32)):
        with pytest.raises(NotImplementedError, match="unsupported bias"):
            load()
    save_file(dict(tensors, **{"model.norm.weight":
                               tensors["model.norm.weight"].astype(np.float64)}), st)
    with pytest.raises(ValueError, match="F64"):
        TL.load_model(path, dtype="float32", device="cpu")


def test_load_model_defaults_to_the_card(tmp_path, monkeypatch):
    _, path = make_hf_llama(tmp_path, tie=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.load_model(path)
