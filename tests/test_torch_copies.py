"""Drift guard: the port's copied host modules equal their JAX originals.

Each module the port carries as a copy must equal the JAX package's file
after the port's import rewrites, so a change to either side shows up
here. The rewrites are mechanical:

- ``dynamo_tpu.`` → ``dynamo_tpu_torch.``;
- ``import msgpack`` → the port's pure-Python ``msgpack_lite``, at any
  indent (``llm/disagg.py`` imports it inside functions);
- ``from aiohttp import web`` → the port's asyncio ``http_server``;
- ``import jinja2`` → the port's template renderer.

Modules changed on purpose are listed in ``CHANGED`` with the reason;
where the change is one block, the test applies it to the JAX file and
still requires equality.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

COPIED = [
    "runtime/config.py", "runtime/tracing.py", "runtime/metrics.py",
    "runtime/engine.py", "runtime/chaos.py", "runtime/messaging.py", "runtime/store.py",
    "runtime/store_net.py", "runtime/client.py",
    "runtime/push_router.py", "runtime/distributed.py", "runtime/admission.py",
    "runtime/qos.py", "runtime/slo.py", "runtime/component.py",
    "kv_router/protocols.py", "kv_router/indexer.py", "kv_router/sequence.py",
    "kv_router/scheduler.py", "kv_router/approx.py", "kv_router/router.py",
    "kv_router/publisher.py",
    "llm/protocols.py", "llm/backend.py", "llm/model_card.py", "llm/discovery.py",
    "llm/migration.py", "llm/pipeline.py", "llm/http_service.py", "llm/recorder.py",
    "block_manager/pool.py", "engine/hub.py", "engine/drafter.py",
    "runtime/queue.py", "transfer/__init__.py", "llm/disagg.py",
    "engine/grammar.py", "llm/preprocessor.py", "llm/peer_kv.py",
    "planner/actions.py", "block_manager/adapters.py",
    "runtime/barrier.py", "runtime/trace_export.py", "llm/logprobs.py",
    "mocker/__init__.py", "mocker/engine.py", "mocker/__main__.py",
    "fleet/__init__.py", "fleet/__main__.py", "fleet/backoff.py", "fleet/aggregate.py",
    "fleet/decisions.py", "fleet/budget.py",
]

# Changed on purpose, one line each on why.
CHANGED = {
    "runtime/logging.py": "the handler goes on the port's logger namespace (dynamo_tpu_torch), "
                          "which its loggers use; on the JAX one it would double that package's "
                          "lines in a process holding both",
    "runtime/http_server.py": "aiohttp is absent on the card's machine: an asyncio HTTP/1.1 "
                              "server core with aiohttp's web surface, under SystemHttpServer",
    "runtime/store_server.py": "SIGTERM closes the server and exits 0, as the worker and "
                               "frontend CLIs do (the JAX CLI dies by the signal)",
    "llm/tokenizer.py": "the tokenizers package is absent on the card's machine: HFTokenizer "
                        "and RawTokenizer run the port's pure-Python tokenizer.json pipeline "
                        "(llm/tokenizer_json.py); and tokenizer_spec_for states the CLIs' one "
                        "difference: with --model-path, no --tokenizer serves the checkpoint's "
                        "own and an explicit --tokenizer byte serves bytes, which the JAX CLIs "
                        "cannot express (byte is their default and means the checkpoint's own)",
    "tokens.py": "xxhash is absent on the card's machine: a pure-Python XXH3-64, bit-exact "
                 "(tests/test_torch_guards.py)",
    "runtime/framing.py": "pack_prefixed joins msgpack_lite's uncopied parts once: a streamed "
                          "16 MiB KV page frame is copied once when packed, not twice "
                          "(the same bytes on the wire)",
    "transfer/stream.py": "one docstring line drops a pointer into the JAX package's "
                          "planning history",
    "block_manager/tiers.py": "ml_dtypes is absent on the card's machine: host bf16 pages are "
                              "uint16 bit patterns (engine/kv_transfer.py), which the npz codec "
                              "writes as the JAX package writes bf16 (uint16 members, dtype "
                              "\"bfloat16\") and reads back as uint16",
    "worker/migrate.py": "two comment lines drop pointers into the JAX package's planning "
                         "history (LINE_EDITS)",
    "worker/roles.py": "two docstring lines drop pointers into the JAX package's planning "
                       "history (LINE_EDITS)",
    "planner/__init__.py": "re-exports the actions only: the JAX package's imports its "
                           "connector, core, interpolate, operator and predictors modules, "
                           "which are not ported (A19 brings the rest)",
    "engine/lora.py": "xxhash is absent on the card's machine: adapter_tier_hash and the "
                      "seed of make_adapter_pages use the port's pure-Python xxh3_64 "
                      "(tokens.py), bit-exact, so hashes and pages equal the JAX ones byte "
                      "for byte (LINE_EDITS; tests/test_torch_lora.py)",
    "planner/actuate.py": "httpx is absent on the card's machine: FleetHttpActuator's two "
                          "calls go through urllib.request on a worker thread (the same "
                          "requests, JSON bodies and ScaleActionError)",
    "llm/client.py": "httpx is absent on the card's machine: OpenAIClient speaks HTTP/1.1 on "
                     "asyncio streams, one connection a request, with the same methods, retries "
                     "and OpenAIClientError surface, plus a raw request()/get() and optional "
                     "per-client headers (tests/test_torch_client.py)",
    "fleet/supervisor.py": "aiohttp is absent on the card's machine: the admin site runs on "
                           "the port's http_server and scrapes children with the port's client; "
                           "and the aggregated /debug/requests joins each record with the phases "
                           "its trace's exported spans carry (a worker process's engine phases, "
                           "which a child frontend's own ledger cannot see)",
    "fleet/directory.py": "one docstring line drops a pointer into the JAX package's planning "
                          "history (LINE_EDITS)",
}

def rewrite(src: str) -> str:
    src = re.sub(r"(?m)^([ \t]*)import msgpack$",
                 r"\1from dynamo_tpu_torch.runtime import msgpack_lite as msgpack", src)
    src = re.sub(r"(?m)^from aiohttp import web$",
                 "from dynamo_tpu_torch.runtime import http_server as web", src)
    src = re.sub(r"(?m)^import jinja2$",
                 "from dynamo_tpu_torch.llm import template as jinja2", src)
    return re.sub(r"\bdynamo_tpu\.", "dynamo_tpu_torch.", src)


def jax_rewritten(rel: str) -> str:
    return rewrite((REPO / "dynamo_tpu" / rel).read_text())


def port(rel: str) -> str:
    return (REPO / "dynamo_tpu_torch" / rel).read_text()


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_its_jax_file(rel):
    expected = jax_rewritten(rel)
    got = port(rel)
    if got != expected:
        import difflib

        diff = "".join(difflib.unified_diff(expected.splitlines(True), got.splitlines(True),
                                            f"dynamo_tpu/{rel} (rewritten)",
                                            f"dynamo_tpu_torch/{rel}", n=1))
        pytest.fail(f"dynamo_tpu_torch/{rel} drifted from its JAX original:\n{diff[:4000]}")


# The one block framing.py changes: (JAX text, port text) after the rewrites.
FRAMING_BLOCK = (
    '''def pack_prefixed(prefix: bytes, payload) -> bytes:
    """One frame whose msgpack body is ``prefix || packb(payload)``."""
    body = msgpack.packb(payload, use_bin_type=True)
    return _LEN.pack(len(prefix) + len(body)) + prefix + body
''',
    '''def pack_prefixed(prefix: bytes, payload) -> bytes:
    """One frame whose msgpack body is ``prefix || packb(payload)``, its
    bytes copied once (a 16 MiB KV page frame is a view of the pages)."""
    parts = msgpack.pack_parts(payload)
    n = len(prefix) + sum(len(p) for p in parts)
    return b"".join([_LEN.pack(n), prefix, *parts])
''',
)


# The docstring line stream.py changes, as the JAX file has it.
STREAM_JAX_LINE = re.search(r"(?m)^    it \([^;\n]*; docs/performance\.md has the budget math\)\.\n",
                            (REPO / "dynamo_tpu" / "transfer" / "stream.py").read_text()).group(0)


def _fleet_actuator(text: str) -> str:
    """actuate.py's FleetHttpActuator class, up to the next class."""
    return text[text.index("class FleetHttpActuator"):text.index("class RecordingActuator")]


def _npz_codec(text: str) -> str:
    """tiers.py's npz codec: the functions from ``_write_npz`` (the port's
    ``_dtype_name`` before it) up to the first pool class."""
    start = min(i for i in (text.find("def _dtype_name("), text.find("def _write_npz(")) if i >= 0)
    return text[start:text.index("class HostBlockPool")]


# One-block changes: module → (JAX text after the rewrites, port text).
ONE_BLOCK = {
    "block_manager/tiers.py": (_npz_codec((REPO / "dynamo_tpu" / "block_manager" /
                                           "tiers.py").read_text()),
                               _npz_codec((REPO / "dynamo_tpu_torch" / "block_manager" /
                                           "tiers.py").read_text())),
    "runtime/framing.py": FRAMING_BLOCK,
    "planner/actuate.py": (_fleet_actuator(rewrite((REPO / "dynamo_tpu" / "planner" /
                                                    "actuate.py").read_text())),
                           _fleet_actuator((REPO / "dynamo_tpu_torch" / "planner" /
                                            "actuate.py").read_text())),
    "transfer/stream.py": (STREAM_JAX_LINE, "    it (docs/performance.md has the budget math).\n"),
    "runtime/logging.py": ('    root = logging.getLogger("dynamo_tpu")\n',
                           '    root = logging.getLogger("dynamo_tpu_torch")\n'),
}


@pytest.mark.parametrize("rel", sorted(ONE_BLOCK))
def test_one_block_changes_are_the_only_difference(rel):
    jax_block, port_block = ONE_BLOCK[rel]
    expected = jax_rewritten(rel)
    assert expected.count(jax_block) == 1
    assert port(rel) == expected.replace(jax_block, port_block)


# The docstring line directory.py rewords, as the JAX file has it (a
# pointer into the JAX package's planning history).
DIRECTORY_JAX_LINE = re.search(
    r"(?m)^[^\n]*'s decision cache \(fleet/decisions\.py\) remembers \*where a\n",
    (REPO / "dynamo_tpu" / "fleet" / "directory.py").read_text()).group(0)


# Lines reworded in otherwise verbatim copies: module → [(JAX text after the
# rewrites, port text)], each JAX text occurring once.
LINE_EDITS = {
    "worker/migrate.py": [
        ("the PR 8 credit-flow transfer plane (the same ``kv_fetch`` windowed\n",
         "the disagg credit-flow transfer plane (the same ``kv_fetch`` windowed\n"),
        ("# Bandwidth pacing (ISSUE 19 tentpole (c)): at most this many outbound\n",
         "# Bandwidth pacing: at most this many outbound\n"),
    ],
    "engine/lora.py": [
        ("from dynamo_tpu_torch.tokens import HASH_SEED\n\nimport xxhash\n",
         "from dynamo_tpu_torch.tokens import HASH_SEED, xxh3_64\n"),
        ('    return xxhash.xxh3_64_intdigest(b"lora:" + name.encode(), seed=HASH_SEED)\n',
         '    return xxh3_64(b"lora:" + name.encode(), HASH_SEED)\n'),
        ("        xxhash.xxh3_64_intdigest(spec.name.encode(), seed=spec.seed & 0x7FFFFFFF)\n",
         "        xxh3_64(spec.name.encode(), spec.seed & 0x7FFFFFFF)\n"),
    ],
    "fleet/directory.py": [
        (DIRECTORY_JAX_LINE, "The decision cache (fleet/decisions.py) remembers *where a\n"),
    ],
    "worker/roles.py": [
        ("PR 8 made disaggregated prefill/decode the default serving shape and\n"
         "PR 9 taught the fleet zero-failure drains; this module composes them so\n",
         "Disaggregated prefill/decode is the default serving shape and the fleet\n"
         "drains with zero failures; this module composes the two so\n"),
    ],
}


@pytest.mark.parametrize("rel", sorted(LINE_EDITS))
def test_line_edits_are_the_only_difference(rel):
    expected = jax_rewritten(rel)
    for jax_text, port_text in LINE_EDITS[rel]:
        assert expected.count(jax_text) == 1
        expected = expected.replace(jax_text, port_text)
    assert port(rel) == expected


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_changed_modules_exist_beside_their_jax_file(rel):
    assert (REPO / "dynamo_tpu" / rel).exists() and (REPO / "dynamo_tpu_torch" / rel).exists()
    assert rel not in COPIED and CHANGED[rel]


def test_rewrites_leave_no_missing_package_imports():
    """No copy imports a package the card's machine lacks, or the JAX package."""
    bad = re.compile(r"(?m)^\s*(?:import|from)\s+(msgpack|aiohttp|jinja2|xxhash|jax|dynamo_tpu)\b(?!_)")
    for rel in COPIED + sorted(ONE_BLOCK) + sorted(LINE_EDITS):
        assert not bad.search(port(rel)), rel
