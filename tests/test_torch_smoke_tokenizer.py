"""chip_smoke.py's phase 9 (the checkpoint's own tokenizer), rehearsed on
the CPU.

- ``chip_smoke.write_llama3_tokenizer`` with a reduced vocabulary: the file
  loads in the ``tokenizers`` library (through the JAX package's
  ``load_tokenizer``) and in the port, and README paragraphs encode and
  decode the same in both, which shows the file is valid; its ids, specials,
  EOS and merges are the Llama-3.1 layout.
- The phase's prompt-token counts (the port's preprocessor, chat through the
  template) equal the JAX preprocessor's on the library tokenizer, and its
  launch counts and KV geometry come out as the phase computes them: the
  burst fits, the two batch requests outgrow the pool.
- ``chip_smoke.tokenizer_phase`` end to end at test-tiny widths in float32
  (vocabulary 1,280: 1,024 BPE tokens and the 256 specials) on a phase-8
  checkpoint: the worker with no --tokenizer, 8 requests bit-equal to the
  in-process engine, the mixed-priority preemption, every process exiting 0
  (the plain versions run: no launches).
"""

from __future__ import annotations

import json

import pytest

import chip_smoke as C
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JPre
from dynamo_tpu.llm.protocols import ChatCompletionRequest as JChat
from dynamo_tpu.llm.protocols import CompletionRequest as JCompletion
from dynamo_tpu.llm.tokenizer import load_tokenizer as jax_load
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from tokenizer_families import readme_paragraphs

N_BPE = 6000


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "llama3")
    info = C.write_llama3_tokenizer(path, n_bpe=N_BPE, learned_max=2000)
    spec = {"type": "hf", "path": path}
    return path, info, jax_load(spec), load_tokenizer(spec)


def test_written_tokenizer_is_valid_and_llama3_shaped(written):
    path, info, jtok, ttok = written
    spec = json.loads(open(f"{path}/tokenizer.json", encoding="utf-8").read())
    assert info["ids"] == N_BPE + 256 == ttok.vocab_size == jtok.vocab_size
    assert len(spec["model"]["vocab"]) == N_BPE and spec["model"]["ignore_merges"]
    assert [t["id"] for t in spec["added_tokens"]] == list(range(N_BPE, N_BPE + 256))
    names = {t["content"]: t["id"] - N_BPE for t in spec["added_tokens"]}
    assert (names["<|begin_of_text|>"], names["<|end_of_text|>"], names["<|eot_id|>"]) == (0, 1, 9)
    assert ttok.eos_token_ids == jtok.eos_token_ids == [N_BPE + 1, N_BPE + 8, N_BPE + 9]
    assert 0 < info["learned_tokens"] <= 2000 and info["merges"] >= N_BPE - 256
    chars = tokens = 0
    for text in readme_paragraphs():
        ids = jtok.encode(text)
        assert ttok.encode(text) == ids
        assert ids[0] == N_BPE  # the TemplateProcessing BOS
        assert ttok.decode(ids) == jtok.decode(ids) == text
        chars, tokens = chars + len(text), tokens + len(ids)
    assert chars / tokens > 2.5  # learned merges: several characters per token


def test_phase_prompt_tokens_counts_and_geometry(written):
    path, _, jtok, ttok = written
    bodies = C.tok_bodies("m")
    card = ModelDeploymentCard(name="m", tokenizer={"type": "hf", "path": path},
                               eos_token_ids=ttok.eos_token_ids)
    got = C.tok_prompt_tokens(card, ttok, bodies)
    jpre = JPre(JCard(name="m", tokenizer={"type": "hf", "path": path},
                      eos_token_ids=jtok.eos_token_ids), jtok)
    want = [len((jpre.preprocess_chat(JChat.parse(b)) if "messages" in b
                 else jpre.preprocess_completion(JCompletion.parse(b))).token_ids) for b in bodies]
    assert got == want
    assert [b["prompt"] for b in bodies[1::2]] == C.readme_cuts()[1::2]
    cfg = ModelConfig.preset("llama-8b")
    counts = C._ckpt_counts(cfg, 88, "cuda", got)
    assert counts == (32 * 88, *C.int8_expected(cfg, got, 88))
    assert C._ckpt_counts(cfg, 88, "cpu", got) == (0, 0, 0, 0)
    batch, inter = C.tok_mixed_prompts()
    lens = [len(ttok.encode(p)) for p in batch]
    geo = C.tok_geometry(got, lens)
    usable = (geo["num_kv_blocks"] - 1) * 16
    assert geo["burst_blocks"] + C.TOK_MARGIN_BLOCKS < geo["num_kv_blocks"]
    totals = [n + g for n, g in zip(lens, geo["batch_max_tokens"])]
    assert sum(totals) > usable and max(totals) <= 2040
    assert len(ttok.encode(inter)) + C.BURST_TOKENS <= 128  # one attention chunk


@pytest.mark.e2e
def test_tokenizer_phase_on_the_cpu():
    ckpt = C.checkpoint_phase("CPU", preset="test-tiny", device="cpu", dtype="float32",
                              keep=True, vocab_size=1280)
    res = C.tokenizer_phase("CPU", ckpt["path"], ckpt["cfg"], device="cpu", dtype="float32")
    assert res["ids"] == 1280 and res["launches"] == (0, 0, 0, 0) and res["name"].endswith("-v1280")
    assert res["mixed"]["preempted_batch"] >= 1 and len(res["prompt_tokens"]) == 8
