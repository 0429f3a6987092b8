"""Drift guard: the port's copied host modules equal their JAX originals.

Each module the port carries as a copy must equal the JAX package's file
after the port's import rewrites, so a change to either side shows up
here. The rewrites are mechanical:

- ``dynamo_tpu.`` → ``dynamo_tpu_torch.``;
- ``import msgpack`` → the port's pure-Python ``msgpack_lite``;
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
    "runtime/qos.py", "runtime/slo.py", "runtime/framing.py", "runtime/component.py",
    "kv_router/protocols.py", "kv_router/indexer.py", "kv_router/sequence.py",
    "kv_router/scheduler.py", "kv_router/approx.py", "kv_router/router.py",
    "kv_router/publisher.py",
    "llm/protocols.py", "llm/backend.py", "llm/model_card.py", "llm/discovery.py",
    "llm/migration.py", "llm/pipeline.py", "llm/http_service.py", "llm/recorder.py",
    "block_manager/pool.py", "engine/hub.py",
]

# Changed on purpose, one line each on why.
CHANGED = {
    "runtime/logging.py": "the handler goes on the port's logger namespace (dynamo_tpu_torch), "
                          "which its loggers use; on the JAX one it would double that package's "
                          "lines in a process holding both",
    "llm/preprocessor.py": "response_format is refused with a typed 400: grammar decoding "
                           "on the device is not ported (ROADMAP A15)",
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
}

# The one block preprocessor.py changes: (JAX text, port text) after the rewrites.
PREPROCESSOR_BLOCK = (
    '''        # Structured output: the wire shape was validated at parse time;
        # deep-validate the schema HERE (compiles the constraint regex,
        # no vocabulary needed) so unsupported constructs 400 at the
        # frontend instead of erroring a worker stream mid-flight.
        response_format = getattr(req, "response_format", None)
        if response_format is not None:
            from dynamo_tpu_torch.engine.grammar import (
                GrammarError,
                compile_response_format_regex,
            )

            try:
                compile_response_format_regex(response_format)
            except GrammarError as e:
                raise OpenAIError(f"invalid response_format: {e}") from e
''',
    '''        # Structured output needs grammar-constrained decoding on the
        # device, which the port's engine does not have yet: refuse it at
        # the frontend with a typed 400 rather than serve unconstrained text.
        response_format = getattr(req, "response_format", None)
        if response_format is not None:
            raise OpenAIError(
                "response_format is not supported by this server yet "
                "(grammar-constrained decoding is not ported)"
            )
''',
)


def rewrite(src: str) -> str:
    src = re.sub(r"(?m)^import msgpack$",
                 "from dynamo_tpu_torch.runtime import msgpack_lite as msgpack", src)
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


# One-block changes: module → (JAX text after the rewrites, port text).
ONE_BLOCK = {
    "llm/preprocessor.py": PREPROCESSOR_BLOCK,
    "runtime/logging.py": ('    root = logging.getLogger("dynamo_tpu")\n',
                           '    root = logging.getLogger("dynamo_tpu_torch")\n'),
}


@pytest.mark.parametrize("rel", sorted(ONE_BLOCK))
def test_one_block_changes_are_the_only_difference(rel):
    jax_block, port_block = ONE_BLOCK[rel]
    expected = jax_rewritten(rel)
    assert expected.count(jax_block) == 1
    assert port(rel) == expected.replace(jax_block, port_block)


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_changed_modules_exist_beside_their_jax_file(rel):
    assert (REPO / "dynamo_tpu" / rel).exists() and (REPO / "dynamo_tpu_torch" / rel).exists()
    assert rel not in COPIED and CHANGED[rel]


def test_rewrites_leave_no_missing_package_imports():
    """No copy imports a package the card's machine lacks, or the JAX package."""
    bad = re.compile(r"(?m)^\s*(?:import|from)\s+(msgpack|aiohttp|jinja2|xxhash|jax|dynamo_tpu)\b(?!_)")
    for rel in COPIED + sorted(ONE_BLOCK):
        assert not bad.search(port(rel)), rel
