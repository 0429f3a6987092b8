"""Mocker: a CPU-only fake engine with a real simulated KV manager.

Reference analogue: the Rust ``MockVllmEngine`` (reference: lib/llm/src/
mocker/engine.rs:49-60, mocker/kv_manager.rs:57-290) — the reference's
key testability trick: every serving/routing behaviour (KV events, load
metrics, prefix caching, continuous-batching timing) is exercised without
accelerator hardware, so router e2e tests run anywhere
(reference: tests/router/test_router_e2e_with_mockers.py:26-80).

This mocker reuses the production BlockPool for its KV simulation, so the
events it publishes are bit-identical in shape and hashing to the real
TPU engine's.
"""

from dynamo_tpu_torch.mocker.engine import MockerArgs, MockerEngine

__all__ = ["MockerArgs", "MockerEngine"]
