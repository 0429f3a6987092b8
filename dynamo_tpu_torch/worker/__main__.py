"""Worker CLI: ``python -m dynamo_tpu_torch.worker`` (port of
``dynamo_tpu/worker/__main__.py``, the aggregated serving path).

Boots a ``TorchEngine`` (on the card unless ``--device cpu``), captures
its decode-window CUDA graphs, the masked single-step graphs of
grammar-constrained traffic (and, with ``--spec-tokens``, one graph per
speculative verify shape, masked tree shapes included), serves the
``generate`` endpoint plus the embed, KV-event, load-metrics and clear-KV
endpoints, and registers the model card: a frontend of either package
discovers the model through the store watch and routes to it over the
runtime's wire. ``response_format`` masks compile over the served
tokenizer's vocabulary.

``--model-path`` serves a checkpoint (an HF directory, a .gguf file or a
hub name in the local hub cache) instead of a preset's random weights;
``--quant int8`` quantizes it on the host before it goes to the card, and
the checkpoint's own tokenizer (its ``tokenizer.json`` or GGUF vocabulary,
in the port's pure-Python pipeline) is served unless ``--tokenizer`` names
another; ``--tokenizer byte`` serves bytes.

Disaggregated prefill/decode, as the JAX worker wires it:
``--is-prefill-worker`` (run with ``--component prefill``) serves
prefill-only requests and the ``kv_fetch`` endpoint that streams their KV
pages, pulls queued prefill jobs, and registers no model card. Every
other worker puts ``DisaggDecodeHandler`` in front of its engine
(``--disagg auto``, the default): a prompt with more than
``--max-local-prefill-length`` uncached tokens is prefilled by the
prefill fleet, its pages streamed here and injected as a prefix hit;
with no prefill fleet that costs one discovery lookup and the worker
serves as an aggregated one. ``--disagg off`` serves the bare engine.

KV tiers and cross-worker prefix reuse, as the JAX worker wires them:
``--host-kv-blocks`` (G2 host RAM), ``--disk-kv-dir`` (G3) and
``--fleet-kv-dir`` (G4, a directory shared by every worker) give the
engine its tier stack. Every worker serves the ``kv_prefix`` endpoint (a
peer's prefix fetch, answered from this worker's tiers), and every
non-prefill worker puts ``PeerPrefixFetcher`` outside the disagg handler:
a router ``peer_prefix`` hint becomes an inject before admission.

``--autoscaler on`` hands the endpoints and the model card to the
``WorkerRoleManager`` (``worker/roles.py``), as the JAX worker does: the
worker registers under ``autoscaler/<ns>/workers/`` in its role
(``--autoscaler-role``, decode by default, prefill with
``--is-prefill-worker``) and serves the ``workerctl/admin`` endpoint:
``set_role`` (a drain-ordered pool move), ``retire``, ``status``,
``kv_adopt`` and live migration (``migrate_out``, ``migrate_in_start``,
``migrate_in_commit``, ``migrate_in_abort``; ``worker/migrate.py``). A
decode-role worker also serves ``kv_fetch``, from which a migration's
destination pulls the source's KV stream. The worker exits once retired.
``--kv-pressure-offer`` offers the cheapest running sequence for
migration once the KV pool fills past that fraction.

``--engine mocker`` serves the mocker (``mocker/engine.py``) in place of
the engine, as the JAX worker does: deterministic echo tokens on a
simulated timing model (``--mocker-ttft-ms``, ``--mocker-itl-ms``,
``--mocker-speedup``, ``--mocker-delta-tokens``) over a real ``BlockPool``,
so KV events, load metrics and prefix hits are the engine's. It touches no
device (``--device`` is ignored) and serves no disagg, peer-fetch, embed or
LoRA path.

``--kv-directory on`` publishes this engine's block residency to the
global prefix directory (``fleet/directory.py``): G1 from the pool's event
stream, beside the KV-event broadcaster, and G2–G4 from the tiers' event
sink. With tracing on, ``DYNTPU_TRACE_EXPORT=1`` exports this process's
spans to the store under ``DYNTPU_FLEET_ID`` (a fleet supervisor stitches
them into one trace per request) and flushes them once more at shutdown.

Multi-LoRA, as the JAX worker wires it: ``--lora-slots`` sizes the
engine's adapter bank, ``--lora-rank`` its static rank, and each ``--lora
NAME[:RANK[:SEED]]`` registers one adapter (factors made from its name
and seed, written through to the tiers), published as a model card of its
own (``adapter_cards``): the frontend lists it in ``/v1/models`` and its
requests carry ``adapter_id`` to this worker. Prefill workers register
the adapters too (a remote prefill names its adapter); ``--autoscaler
on`` hands the adapter cards to the role manager.

SIGTERM drains: the endpoints deregister and finish their in-flight
streams, then the engine stops. The last line the worker logs is one
JSON object with its engine's counters (decode substeps dispatched, the
kernels' launches, tokens generated, host seconds by phase, KV pages
injected and exported, the tiers' stats and the flush and onboard costs,
the peer fetches, the migrations (outcomes, fallback reasons, the host
cost of the KV pump, proactive offers), the adapters (resident, page-ins,
evictions, uploads and their host seconds, the gather seconds and the
admissions' waits for a slot), the graphs captured and their capture
seconds, the peak device memory and the disagg handler's counts); SIGUSR1
logs the same line and serves on. The ``clear_kv`` endpoint drops the idle
cached blocks, and with ``{"zero_counts": true}`` also sets the kernels'
launch counts to 0 on every rank, so a reading after it counts what the
worker launched since.

The counters line also carries ``trace``: the requests that recorded
engine spans, the wall seconds recording them took on the event loop, and
the exporter's sink and flush seconds.

``--sla-profile p.npz`` ships a profiled SLA curve (``python -m
dynamo_tpu_torch.planner.profile_sweep``) inside the model card, so
frontends and the planner discover it.

Tensor parallelism: ``--tp N`` serves the model split over N rank
processes (``parallel/``). The JAX worker drives N local devices from one
process; the port takes N processes, one per rank: ``--tp N`` with
``--dist-num-processes 1`` (the default) makes this process rank 0, the
leader, and spawns N−1 local follower ranks of the same command (rank r
on card r mod the visible cards). Across hosts, start one process per
rank with ``--dist-num-processes N --dist-process-id r`` and the same
``--dist-coordinator`` (the ``torch.distributed`` store rank 0 serves;
``--dist-step-addr``, by default its port + 1, carries the leader's
dispatch stream). Only the leader schedules, registers and serves; a
follower replays every dispatch (``engine/runner.py`` ``follower_loop``)
and at its end prints one ``{"event": "follower_counters", ...}`` line,
its sampled-token digest included (and, where the leader set the counts
to 0, one ``{"event": "follower_counts_zeroed", ...}`` line of the counts
they had). Ranks meet over NCCL when each has a
card of its own and over gloo otherwise (ranks sharing a card, the CPU);
the worker prints which, and under gloo its windows run eagerly. LoRA
(``--lora-slots``/``--lora``) combines with ``--tp``: each rank holds its
shard of the adapter bank, and the leader's adapter uploads reach the
followers with the rest of its dispatch stream.

``--dp-size N`` spawns and supervises N independent worker processes of
the same model, one per dp rank (``--dp-rank r`` marks one; the rank's
system port comes from ``dp_rank_ports``; ``--dp-chips-per-rank k`` gives
rank r the cards [r·k, (r+1)·k) through ``CUDA_VISIBLE_DEVICES``;
``--dp-restart`` respawns a crashed rank after a jittered backoff), as the
JAX worker's spawner does; the router balances across them.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time

import torch

from dynamo_tpu_torch.kv_router.publisher import KvEventBroadcaster, serve_kv_endpoints
from dynamo_tpu_torch.llm.disagg import (
    DisaggConfig,
    DisaggDecodeHandler,
    PrefillHandler,
    PrefillPuller,
)
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, register_model
from dynamo_tpu_torch.llm.peer_kv import (
    KV_PREFIX_ENDPOINT,
    PeerPrefixFetcher,
    make_kv_prefix_handler,
)
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer, tokenizer_spec_for
from dynamo_tpu_torch.ops import int8_matmul as im
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.parallel.comm import TpGroup, rank_device
from dynamo_tpu_torch.runtime.chaos import ChaosInjector
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.push_router import RouterMode
from dynamo_tpu_torch.runtime.queue import WorkQueue
from dynamo_tpu_torch.runtime.trace_export import TraceExporter

log = get_logger("worker")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.worker")
    p.add_argument("--store-url", default=None)
    # The JAX worker's engine choice: "tpu" names the real engine
    # (TorchEngine here), "mocker" the simulated one.
    p.add_argument("--engine", choices=["tpu", "mocker"], default="tpu")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--model-name", default=None, help="served model name (defaults to preset name)")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--preset", default="llama-1b", help="model preset (random weights from --seed)")
    p.add_argument(
        "--model-path", default=None,
        help="HF checkpoint dir (config.json + *.safetensors), .gguf file or cached "
             "org/repo hub name; overrides --preset with real weights",
    )
    p.add_argument("--tokenizer", default=None,
                   help='"byte" | "hf:<path>" | "gguf:<path>" (default: the checkpoint\'s own '
                        "with --model-path, byte without)")
    p.add_argument("--context-length", type=int, default=None)
    p.add_argument("--migration-limit", type=int, default=0)
    # Disaggregated prefill/decode (the JAX worker's flags and defaults).
    p.add_argument("--is-prefill-worker", action="store_true",
                   help="serve prefill-only + kv_fetch; no model card (run with --component prefill)")
    p.add_argument("--disagg", choices=["auto", "on", "off"], default="auto",
                   help="disaggregated prefill/decode as the serving shape: auto (default) "
                        "wires the decode-side disagg handler on every worker; with no "
                        "prefill fleet discovered it costs one lookup per long prompt and "
                        "serves aggregated; off serves the bare engine")
    p.add_argument("--remote-prefill", action="store_true",
                   help="alias for --disagg on (kept for compatibility)")
    p.add_argument("--no-disagg-stream", action="store_true",
                   help="legacy one-shot KV pull after prefill instead of the streaming "
                        "data plane (dynamo_tpu_torch/transfer)")
    p.add_argument("--prefill-component", default="prefill")
    p.add_argument("--max-local-prefill-length", type=int, default=512,
                   help="prompts with more uncached tokens than this prefill remotely")
    p.add_argument("--prefill-dispatch", choices=["queue", "push"], default="queue",
                   help="queue = competing-consumer work queue; push = round-robin RPC to a "
                        "prefill worker")
    # Closed-loop autoscaler: "on" hands endpoint and card wiring to the
    # WorkerRoleManager, so the operator can MOVE this engine between the
    # prefill and decode pools at runtime (admin RPC, drain-ordered),
    # migrate its running decodes and retire it with zero downtime. "off"
    # (default) is the plain wiring.
    p.add_argument("--autoscaler", choices=["on", "off"], default="off",
                   help="register with the closed-loop SLA autoscaler: "
                        "live pool moves + zero-downtime retirement via "
                        "the workerctl admin endpoint")
    p.add_argument("--autoscaler-role", choices=["decode", "prefill"], default=None,
                   help="initial pool under --autoscaler on (default: decode, "
                        "or prefill when --is-prefill-worker is set)")
    p.add_argument("--sla-profile", default=None,
                   help="profiled SLA npz (python -m dynamo_tpu_torch.planner.profile_sweep) "
                        "shipped inside this worker's model card so frontends and "
                        "the planner discover the latency curves instead of "
                        "needing a --qos-profile path")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-kv-blocks", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=16)
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--decode-steps", type=int, default=8)
    # Decode-window pipelining: max windows dispatched-but-unfetched (0 =
    # unpipelined; fetches still start async).
    p.add_argument("--pipeline-depth", type=int, default=2)
    # Prefill T-bucket ladder: "fine" (1.5x midpoints ≤512), "coarse"
    # (2x/4x, fewest graphs) or an explicit comma list.
    p.add_argument("--prefill-buckets", default="fine")
    p.add_argument("--no-prefill-tail-split", action="store_true",
                   help="disable splitting padded prefill tails into smaller buckets")
    # Streaming delta coalescing: cap on tokens merged into one wire frame
    # when a stream's consumer lags (0 = one frame per decode window), and
    # an optional bounded gather wait in ms (adds up to that much ITL).
    p.add_argument("--delta-max-tokens", type=int, default=64)
    p.add_argument("--delta-max-ms", type=float, default=0.0)
    p.add_argument("--qos-sched", choices=["on", "off"], default="on",
                   help="class-aware engine scheduling: admission and "
                        "KV-pressure preemption ordered by (priority "
                        "class, age). No-priority traffic is byte-"
                        "identical either way; off pins one class")
    # Speculative decoding: n-gram prompt-lookup drafts verified in one
    # batched forward per pass (engine/drafter.py + model.spec_verify).
    # 0 = off. Greedy output is the dense path's; sampled requests keep
    # their distribution by rejection sampling. A per-sequence acceptance
    # EMA turns speculation off on incompressible streams.
    p.add_argument("--spec-tokens", type=int, default=0,
                   help="max draft tokens verified per speculative pass (0 = off)")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="n-gram match length for the prompt-lookup drafter")
    p.add_argument("--spec-stepwise", action="store_true",
                   help="verify drafts with a stepwise loop of the dense decode step "
                        "(bitwise parity with the dense path; forfeits the single-weight-"
                        "stream win) instead of the fused single-pass forward")
    p.add_argument("--spec-tree-width", type=int, default=1,
                   help="max draft-tree branching factor (1 = linear drafts; >= 2 enables "
                        "SpecInfer-style tree verification with the topology-masked kernel "
                        "+ Lookahead Jacobi pool)")
    p.add_argument("--spec-tree-depth", type=int, default=0,
                   help="max draft-tree path depth (0 = spec-tokens)")
    p.add_argument("--spec-budget", choices=["adaptive", "uniform"], default="adaptive",
                   help="per-pass draft-node allocation: adaptive moves nodes from "
                        "acceptance-EMA-cold rows to hot ones under the fixed batch budget "
                        "(rows x spec-tokens); uniform = every row gets spec-tokens")
    p.add_argument("--kv-quant", choices=["none", "int8"], default="none",
                   help="paged KV cache storage (int8 = quantized pages + "
                        "per-position-per-head scales)")
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="weight format (int8 = weight-only quantization, engine/quant.py)")
    p.add_argument("--host-kv-blocks", type=int, default=0,
                   help="G2 host-RAM KV tier capacity in blocks (0 = off)")
    p.add_argument("--disk-kv-dir", default=None, help="G3 disk KV tier directory")
    p.add_argument("--disk-kv-blocks", type=int, default=4096)
    p.add_argument("--fleet-kv-dir", default=None,
                   help="G4 fleet-SHARED KV pool directory (mounted by "
                        "every engine; salted-hash-keyed files dedup "
                        "across the fleet, block_manager/tiers.py)")
    p.add_argument("--fleet-kv-blocks", type=int, default=16384)
    p.add_argument("--kv-pressure-offer", type=float, default=0.0,
                   help="pool-usage fraction above which the engine "
                        "proactively OFFERS its cheapest running sequence "
                        "for migration before preemption is forced "
                        "(0 = off; the offer reuses the same "
                        "migration_offer hook as the preemption-boundary "
                        "grace window, docs/autoscaler.md#fleet-balancer)")
    # Multi-LoRA (engine/lora.py): serve many fine-tunes of the base model
    # on this one engine. --lora-slots sizes the device adapter bank (0 =
    # off); --lora registers adapters (repeatable), each served as its own
    # model whose rows share every batch with the base rows. More adapters
    # than slots page through the tiers on demand.
    p.add_argument("--lora-slots", type=int, default=0,
                   help="device-resident LoRA adapter slots (0 = LoRA off)")
    p.add_argument("--lora-rank", type=int, default=8,
                   help="static adapter bank rank (max over registered adapters)")
    p.add_argument("--lora", action="append", default=[], metavar="NAME[:RANK[:SEED]]",
                   help="register one adapter served as model NAME (repeatable)")
    p.add_argument("--kv-directory", choices=["on", "off"], default="off",
                   help="publish this engine's KV block residency to the "
                        "global prefix directory (fleet/directory.py) so "
                        "frontends can price transfer-vs-recompute and "
                        "the autoscaler sees cache heat")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks, one process each (the leader spawns the "
                        "rest unless --dist-num-processes says otherwise)")
    p.add_argument("--seed", type=int, default=0)
    # DP-attention: one worker PROCESS per dp rank, all serving the same model
    # behind the router (the JAX worker's flags and defaults).
    p.add_argument("--dp-size", type=int, default=1)
    p.add_argument("--dp-rank", type=int, default=None)
    p.add_argument("--dp-base-port", type=int, default=29600,
                   help="first port of the per-rank port blocks (dp_rank_ports)")
    p.add_argument("--dp-chips-per-rank", type=int, default=0,
                   help="pin CUDA_VISIBLE_DEVICES=[r*k, (r+1)*k) per rank (0 = no pinning)")
    p.add_argument("--dp-restart", action="store_true",
                   help="restart a crashed dp rank with jittered exponential backoff "
                        "instead of letting the slot stay down until the spawner exits")
    # One tensor-parallel worker spanning several processes (hosts): process 0
    # serves, the rest replay its dispatch stream (engine/runner.py).
    p.add_argument("--dist-num-processes", type=int, default=1)
    p.add_argument("--dist-process-id", type=int, default=0)
    p.add_argument("--dist-coordinator", default="127.0.0.1:29500",
                   help="torch.distributed store host:port (process 0's host)")
    p.add_argument("--dist-step-addr", default=None,
                   help="leader step-stream addr (default: coordinator host, port+1)")
    # Mocker timing (--engine mocker).
    p.add_argument("--mocker-ttft-ms", type=float, default=20.0)
    p.add_argument("--mocker-itl-ms", type=float, default=5.0)
    p.add_argument("--mocker-speedup", type=float, default=1.0)
    p.add_argument("--mocker-delta-tokens", type=int, default=1,
                   help="tokens per simulated decode window (mirror engine decode_steps)")
    args = p.parse_args(argv)
    if args.remote_prefill:
        args.disagg = "on"
    if args.lora and args.lora_slots <= 0:
        p.error("--lora requires --lora-slots > 0")
    if args.lora and args.engine == "mocker":
        p.error("--lora requires --engine tpu (the mocker has no adapter bank)")
    from dynamo_tpu_torch.engine.config import EngineArgs

    try:  # EngineArgs' own check: a mistyped ladder fails before any weights load
        EngineArgs(prefill_buckets_spec=args.prefill_buckets)
    except ValueError as e:
        p.error(f"--prefill-buckets: {e}")
    if args.engine == "mocker" and (args.disagg == "on" or args.is_prefill_worker):
        # The disagg handlers drive the real engine's KV extract/inject
        # surface; the mocker has neither (--disagg auto stays aggregated).
        p.error("--engine mocker cannot combine with --disagg on/--is-prefill-worker")
    try:
        # Parsed once here (argparse's error surface); consumers read
        # args.lora_specs.
        args.lora_specs = parse_lora_specs(args.lora, args.lora_rank)
    except ValueError as e:
        p.error(str(e))
    if (args.dp_rank is not None or args.dp_size > 1) and args.dist_num_processes > 1:
        # A dp rank is a self-contained world; spanning hosts within a rank
        # would need per-rank coordinator port blocks. Checked for the
        # spawner too, so the parent fails fast instead of every child.
        p.error("--dp-size/--dp-rank cannot combine with --dist-num-processes > 1")
    if args.dp_rank is not None and not 0 <= args.dp_rank < args.dp_size:
        p.error("--dp-rank must be in [0, --dp-size)")
    if args.dist_num_processes > 1 and args.dist_num_processes != args.tp:
        p.error("--dist-num-processes must equal --tp: each process is one tensor-parallel "
                "rank")
    return args


def parse_lora_specs(entries: list[str], default_rank: int) -> list[tuple[str, int, int]]:
    """--lora NAME[:RANK[:SEED]] entries → [(name, rank, seed)] (the JAX
    worker's parser and errors)."""
    out = []
    for e in entries:
        parts = e.split(":")
        name = parts[0]
        if not name:
            raise ValueError(f"--lora entry {e!r}: empty adapter name")
        try:
            rank = int(parts[1]) if len(parts) > 1 and parts[1] else default_rank
            seed = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        except ValueError:
            raise ValueError(f"--lora entry {e!r}: RANK and SEED must be integers") from None
        out.append((name, rank, seed))
    return out


def adapter_cards(card, lora_specs) -> list:
    """One ModelDeploymentCard per --lora adapter, derived from the base
    card: the plain serving path and the role manager publish the same
    adapter metadata."""
    import dataclasses

    return [
        dataclasses.replace(card, name=lname,
                            lora={"adapter_id": lname, "base": card.name, "rank": lrank,
                                  "resident_tier": "G2"})
        for lname, lrank, _lseed in lora_specs
    ]


def embed_sla_profile(card, args) -> None:
    """``--sla-profile``: ship the profiled latency curves inside the model
    card, so frontends (admission-time TTFT prediction) and the planner
    pick them up through discovery instead of a --qos-profile path copied
    to every box."""
    if not getattr(args, "sla_profile", None):
        return
    from dynamo_tpu_torch.planner.interpolate import load_profile, profile_as_card_dict

    prof_decode, prof_prefill = load_profile(args.sla_profile)
    card.sla_profile = profile_as_card_dict(decode=prof_decode, prefill=prof_prefill)
    log.info("sla profile %s embedded in model card", args.sla_profile)


def build_mocker(args, config):
    """``--engine mocker`` → (MockerEngine, model_card), the JAX worker's
    mocker and card."""
    from dynamo_tpu_torch.mocker.engine import MockerArgs, MockerEngine

    tok_spec = tokenizer_spec_for(args.model_path, args.tokenizer)
    tokenizer = load_tokenizer(tok_spec)
    engine = MockerEngine(MockerArgs(
        block_size=args.block_size,
        num_kv_blocks=args.num_kv_blocks,
        max_num_seqs=args.max_num_seqs,
        ttft_ms=args.mocker_ttft_ms,
        itl_ms=args.mocker_itl_ms,
        speedup=args.mocker_speedup,
        delta_tokens=args.mocker_delta_tokens,
        delta_max_tokens=args.delta_max_tokens,
        delta_max_ms=args.delta_max_ms,
        # Env-driven fault injection (DYNTPU_CHAOS_*): engine-level kill
        # draws; the messaging layer reads the same section.
        chaos=ChaosInjector.from_config(config.chaos),
    ))
    card = ModelDeploymentCard(
        name=args.model_name or "mock-model",
        tokenizer=tok_spec,
        context_length=args.context_length or args.max_model_len,
        kv_cache_block_size=args.block_size,
        migration_limit=args.migration_limit,
        eos_token_ids=list(tokenizer.eos_token_ids) or [ByteTokenizer.EOS],
        component=args.component,
        endpoint=args.endpoint,
        max_batch_size=args.max_num_seqs,
        total_kv_blocks=args.num_kv_blocks,
    )
    embed_sla_profile(card, args)
    return engine, card


def engine_args(args, model, tok_spec, device: str | None = None):
    """The worker flags → EngineArgs (the leader's and every follower's);
    ``device`` names a tp rank's own card."""
    from dynamo_tpu_torch.engine.config import EngineArgs, spec_engine_args

    return EngineArgs(
        model=model,
        block_size=args.block_size,
        num_kv_blocks=args.num_kv_blocks,
        max_num_seqs=args.max_num_seqs,
        max_model_len=args.max_model_len,
        dtype=args.dtype,
        decode_steps=args.decode_steps,
        pipeline_depth=args.pipeline_depth,
        pipeline_windows=args.pipeline_depth > 0,
        prefill_buckets_spec=args.prefill_buckets,
        prefill_tail_split=not args.no_prefill_tail_split,
        delta_max_tokens=args.delta_max_tokens,
        delta_max_ms=args.delta_max_ms,
        qos_scheduling=args.qos_sched == "on",
        quant=args.quant,
        kv_quant=args.kv_quant,
        host_kv_blocks=args.host_kv_blocks,
        disk_kv_dir=args.disk_kv_dir,
        disk_kv_blocks=args.disk_kv_blocks,
        fleet_kv_dir=args.fleet_kv_dir,
        fleet_kv_blocks=args.fleet_kv_blocks,
        kv_pressure_offer=args.kv_pressure_offer,
        lora_slots=args.lora_slots,
        lora_rank=max([args.lora_rank] + [r for _, r, _ in args.lora_specs]),
        device=device or args.device,
        tp=args.tp,
        # Grammar token-mask FSMs compile over the serving tokenizer's
        # vocabulary: response_format masks must legalize exactly the ids
        # the detokenizer renders.
        grammar_tokenizer=tok_spec,
        **spec_engine_args(args),
    )


def load_weights(args, rank: int = 0):
    """→ (ModelConfig, params or None): ``--model-path``'s checkpoint (this
    rank's shards under ``--tp``), or the preset's config and None (random
    weights from ``--seed``, made by the runner)."""
    from dynamo_tpu_torch.engine.config import ModelConfig

    if not args.model_path:
        return ModelConfig.preset(args.preset), None
    from dynamo_tpu_torch.engine.loader import load_model

    t0 = time.perf_counter()
    device = args.device if args.tp == 1 else str(rank_device(args.device, rank))
    model, params = load_model(args.model_path, args.dtype, args.quant, device,
                               tp=args.tp, rank=rank)
    print(f"dynamo_tpu_torch worker: loaded {args.model_path} (quant {args.quant}"
          f"{f', rank {rank} of tp {args.tp}' if args.tp > 1 else ''}) in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    return model, params


def step_addr(args) -> str:
    """The leader's dispatch-stream address: ``--dist-step-addr``, or the
    coordinator's host at its port + 1."""
    if args.dist_step_addr:
        return args.dist_step_addr
    host, port = args.dist_coordinator.rsplit(":", 1)
    return f"{host}:{int(port) + 1}"


def tp_group(args, rank: int) -> TpGroup:
    """This process's rank of the ``--tp`` group, on its card."""
    group = TpGroup(rank, args.tp, args.dist_coordinator, rank_device(args.device, rank))
    print(f"dynamo_tpu_torch {'worker' if rank == 0 else f'follower {rank}/{args.tp}'}: "
          f"{group.describe()}; decode windows "
          f"{'captured as CUDA graphs' if group.backend == 'nccl' else 'run eagerly'}",
          flush=True)
    return group


async def build_engine(args):
    """→ (engine, model_card). Under ``--tp`` the engine's runner is the
    leader of the tp group."""
    from dynamo_tpu_torch.engine.engine import TorchEngine

    if args.model_path:
        from dynamo_tpu_torch.engine.hub import resolve_model

        args.model_path = resolve_model(args.model_path)
    tok_spec = tokenizer_spec_for(args.model_path, args.tokenizer)
    tokenizer = load_tokenizer(tok_spec)
    runner = group = None
    if args.tp > 1:
        group = await asyncio.to_thread(tp_group, args, 0)
    model, params = await asyncio.to_thread(load_weights, args)
    eargs = engine_args(args, model, tok_spec, None if group is None else str(group.device))
    if group is not None:
        from dynamo_tpu_torch.engine.runner import LeaderRunner

        runner = LeaderRunner(eargs, params=params, seed=args.seed, group=group,
                              listen_addr=f"0.0.0.0:{step_addr(args).rsplit(':', 1)[1]}",
                              num_followers=args.tp - 1)
    engine = await TorchEngine(eargs, params=params, seed=args.seed, runner=runner).start()
    card = ModelDeploymentCard(
        name=args.model_name or model.name,
        tokenizer=tok_spec,
        context_length=args.context_length or min(args.max_model_len, model.max_position),
        kv_cache_block_size=args.block_size,
        migration_limit=args.migration_limit,
        eos_token_ids=list(tokenizer.eos_token_ids) or [ByteTokenizer.EOS],
        component=args.component,
        endpoint=args.endpoint,
        max_batch_size=args.max_num_seqs,
        total_kv_blocks=args.num_kv_blocks,
    )
    embed_sla_profile(card, args)
    return engine, card


class RecordingDecodeHandler(DisaggDecodeHandler):
    """The decode-side disagg handler, keeping one record per streamed
    remote prefill (its outcome, prompt tokens, bytes, chunks, overlap
    fraction, and the seconds from dispatch to the last chunk) for the
    counters line."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.transfers: list[dict] = []

    async def _remote_prefill_stream(self, preq, ctx):
        t0 = time.perf_counter()
        inject, why, attrs = await super()._remote_prefill_stream(preq, ctx)
        self.transfers.append({"prompt_tokens": len(preq.get("token_ids") or ()),
                               "outcome": why or "remote",
                               "seconds": round(time.perf_counter() - t0, 6), **(attrs or {})})
        return inject, why, attrs


class TimedTraceExporter(TraceExporter):
    """Span export that also counts its spans, the wall seconds of its
    recorder sink and of its store flushes (which await the store), for the
    counters line."""

    spans = 0
    sink_s = flush_s = 0.0

    def _on_span(self, span) -> None:
        t0 = time.perf_counter()
        super()._on_span(span)
        self.spans += 1
        self.sink_s += time.perf_counter() - t0

    async def flush(self) -> int:
        t0 = time.perf_counter()
        try:
            return await super().flush()
        finally:
            self.flush_s += time.perf_counter() - t0


def trace_counters(engine, exporter) -> dict:
    """The engine spans' recording cost and the exporter's, by request."""
    out = {"requests": getattr(engine, "traced_requests", 0),
           "span_s": round(getattr(engine, "trace_s", 0.0), 6)}
    if exporter is not None:
        out.update(exported_spans=exporter.spans, export_sink_s=round(exporter.sink_s, 6),
                   export_flush_s=round(exporter.flush_s, 6))
    return out


def prefill_graph_counters(graphs) -> dict:
    """The prefill graphs captured so far: their count, capture seconds and
    the graph-pool bytes their captures added."""
    costs = [c for k, c in graphs.capture_costs().items()
             if k[0] == "prefill"] if graphs is not None else []
    return {"prefill_graphs": len(costs),
            "prefill_capture_s": round(sum(s for s, _ in costs), 6),
            "prefill_pool_bytes": sum(b for _, b in costs)}


def engine_counters(engine, disagg=None, fetcher=None, manager=None, exporter=None) -> dict:
    """The engine's monotonic counters as one JSON-able dict, with the
    disagg decode handler's, the peer prefix fetcher's and the role
    manager's migrations when there are ones, and the tracing costs."""
    if not hasattr(engine, "runner"):  # the mocker: no device, no kernels
        return {"event": "engine_counters", "engine": "mocker",
                "generated_tokens": engine.total_generated,
                "trace": trace_counters(engine, exporter)}
    graphs = engine.runner.graphs
    out = {
        "event": "engine_counters",
        "decode_substeps": engine.total_decode_steps,
        **launch_counts(),
        "num_layers": engine.cfg.num_layers,
        "generated_tokens": engine.total_generated,
        "prefilled_tokens": engine.total_prefilled,
        "preemptions": engine.total_preemptions,
        "eager_windows": engine.runner.eager_windows,
        "spec_passes": engine.runner.verify_passes,
        "spec_forwards": engine.runner.verify_forwards,
        "eager_verifies": engine.runner.eager_verifies,
        "eager_steps": engine.runner.eager_steps,
        "eager_prefills": engine.runner.eager_prefills,
        "grammar_seqs": engine.total_grammar_seqs,
        "grammar_mask_s": round(engine.total_grammar_mask_s, 6),
        "phase_s": {k: round(v, 6) for k, v in engine.phase_s.items()},
        "inject_s": round(engine.inject_s, 6),
        "inject_bytes": engine.inject_bytes,
        "export_s": round(engine.export_s, 6),
        "tiers": engine.tiers.stats(),
        "offload_s": round(engine.offload_s, 6),
        "offload_flushes": engine.offload_flushes,
        "offload_bytes": engine.offload_bytes,
        "onboard_s": round(engine.onboard_s, 6),
        "onboard_bytes": engine.onboard_bytes,
        "graphs_captured": graphs.captured if graphs is not None else 0,
        **prefill_graph_counters(graphs),
        "graph_capture_s": round(graphs.capture_s, 6) if graphs is not None else 0.0,
        "migration_pump_s": round(engine.migration_pump_s, 6),
        "migration_pumps": engine.migration_pumps,
        "pressure_offers": engine.pressure_offers,
        "lora": {**engine.lora_stats(), "gather_s": round(engine.total_lora_s, 6),
                 "pagein_s": round(engine.lora_pagein_s, 6),
                 "uploads": engine.runner.adapter_uploads,
                 "windows": engine.runner.lora_windows,
                 "upload_s": round(engine.runner.adapter_upload_s, 6),
                 "slot_waits": engine.lora_slot_waits,
                 "slot_wait_s": round(engine.lora_slot_wait_s, 6)},
        "peak_device_bytes": (torch.cuda.max_memory_allocated()
                              if engine.runner.device.type == "cuda" else 0),
        "trace": trace_counters(engine, exporter),
    }
    group = engine.runner.group
    if group is not None:
        out["tp"] = {**group.counters(), "token_digest": engine.runner.digest(),
                     "frames": engine.runner.frames, "frame_bytes": engine.runner.frame_bytes}
    migrator = getattr(manager, "migrator", None)
    if migrator is not None:
        out["migration"] = {"outcomes": dict(migrator.outcomes),
                            "fallback_reasons": dict(migrator.fallback_reasons)}
    if fetcher is not None:
        out["peer_fetches"] = fetcher.peer_fetches
        out["peer_fetch_failures"] = fetcher.peer_fetch_failures
    if disagg is not None:
        out["disagg"] = {
            "remote_prefills": disagg.remote_prefills,
            "local_fallbacks": disagg.local_fallbacks,
            "fallback_reasons": dict(disagg.fallback_reasons),
            "transfer_bytes": disagg.transfer_bytes_total,
            "overlapped_bytes": disagg.transfer_overlapped_total,
            "transfers": disagg.transfers,
        }
    return out


async def async_main(args) -> None:
    from dynamo_tpu_torch.runtime import tracing

    lane = os.environ.get("DYNTPU_PROC_LANE")
    if not lane:
        lane = f"worker-{os.getpid()}"
        tracing.set_default_lane(lane)
    t_launch = time.perf_counter()
    rt = await DistributedRuntime.create(store_url=args.store_url, proc_label=lane)
    exporter = None
    if tracing.enabled() and os.environ.get("DYNTPU_TRACE_EXPORT", "") not in ("", "0"):
        exporter = await TimedTraceExporter(
            rt.store, os.environ.get("DYNTPU_FLEET_ID", "default"), lane=lane).start()
    mocker = args.engine == "mocker"
    engine, card = build_mocker(args, rt.config) if mocker else await build_engine(args)
    # Multi-LoRA: register every --lora adapter (written through to the
    # tiers now; bank slots fill on first request). Prefill workers register
    # them too: a remote prefill names its request's adapter.
    for lname, lrank, lseed in args.lora_specs:
        engine.register_adapter(lname, rank=lrank, seed=lseed)
    # Capture the decode-window graphs, the single steps (unmasked for the
    # end-of-life tail, masked for grammar-constrained traffic), with
    # --spec-tokens the verify lattice with its masked tree shapes, and the
    # prefill lattice before registering, so that no request waits for a
    # capture (none on the CPU). Like the JAX worker, this one has no flag
    # that turns grammar on: any request may carry a response_format. A
    # prefill worker never decodes: it captures its prefills only.
    graphs = verify_graphs = step_graphs = prefill_graphs = 0
    warm_s = verify_s = step_s = prefill_s = 0.0
    if not args.is_prefill_worker and not mocker:
        runner = engine.runner
        t0 = time.perf_counter()
        graphs = await asyncio.to_thread(runner.warm_windows, ("greedy", "simple"))
        warm_s = time.perf_counter() - t0
        pool0 = runner.graphs.pool_bytes() if runner.graphs is not None else 0
        step_graphs = await asyncio.to_thread(runner.warm_steps, ("greedy", "simple"))
        step_s = time.perf_counter() - t0 - warm_s
        verify_graphs = await asyncio.to_thread(runner.warm_spec, ("greedy", "simple"), (0,),
                                                True)
        verify_s = time.perf_counter() - t0 - warm_s - step_s
        if runner.graphs is not None:
            print(f"dynamo_tpu_torch worker: {step_graphs} single-step graphs (unmasked and "
                  f"masked) and the masked verify shapes add "
                  f"{(runner.graphs.pool_bytes() - pool0) / 2**20:.1f} MiB to the graph pool",
                  flush=True)
    if not mocker:
        runner = engine.runner
        pool0 = runner.graphs.pool_bytes() if runner.graphs is not None else 0
        t0 = time.perf_counter()
        prefill_graphs = await asyncio.to_thread(runner.warm_prefills)
        prefill_s = time.perf_counter() - t0
        if runner.graphs is not None:
            print(f"dynamo_tpu_torch worker: {prefill_graphs} prefill graphs in "
                  f"{prefill_s:.2f}s add {(runner.graphs.pool_bytes() - pool0) / 2**20:.1f} MiB "
                  f"to the graph pool", flush=True)
    # The warm-up replays served no request: the kernels' launch counts
    # start here, beside the engine's decode substeps (all 0 now).
    pa.launches = im.launches = im.prefill_launches = im.tied_launches = im.wide_launches = 0
    im.decode_launches = 0
    if mocker:
        # The mocker's engine-level chaos draws count on this process's
        # /metrics beside the messaging layer's.
        if engine.args.chaos is not None:
            engine.args.chaos.bind_metrics(rt.metrics)
    else:
        # Engine hot-loop series on this process's /metrics (system server).
        engine.bind_metrics(rt.metrics)
    broadcaster = KvEventBroadcaster(engine.pool)
    publisher = None
    if args.kv_directory == "on":
        # Global prefix directory: mirror this engine's block residency, G1
        # from the pool's event stream beside the broadcaster, G2–G4 from
        # the tiers' sink, so frontends price transfer-vs-recompute and the
        # autoscaler sees cache heat.
        from dynamo_tpu_torch.fleet.directory import DirectoryPublisher

        publisher = await DirectoryPublisher(rt.store, args.namespace,
                                             await rt.primary_lease()).start()
        engine.pool.set_event_sink(lambda ev: (broadcaster.publish(ev), publisher.pool_sink(ev)))
        if not mocker:
            engine.tiers.set_event_sink(publisher.tier_sink)
    else:
        engine.pool.set_event_sink(broadcaster.publish)

    if args.autoscaler == "on":
        await serve_autoscaled(rt, engine, card, args, broadcaster,
                               f"({graphs} window graphs captured in {warm_s:.2f}s, "
                               f"{step_graphs} single-step graphs in {step_s:.2f}s, "
                               f"{verify_graphs} verify graphs in {verify_s:.2f}s, "
                               f"{prefill_graphs} prefill graphs in {prefill_s:.2f}s; registered "
                               f"{time.perf_counter() - t_launch:.2f}s after the runtime "
                               f"started)", publisher, exporter)
        return

    comp = rt.namespace(args.namespace).component(args.component)
    if not mocker:
        # Cross-worker reuse: every engine answers peer prefix fetches from
        # its tiers (llm/peer_kv.py; declined without tiers).
        await comp.endpoint(KV_PREFIX_ENDPOINT).serve(make_kv_prefix_handler(engine))
    disagg = puller = fetcher = None
    if args.is_prefill_worker:
        dcfg = DisaggConfig()
        # Env-driven kill-mid-transfer faults (DYNTPU_CHAOS_TRANSFER_CUT_P)
        # ride the runtime config's [chaos] section.
        handler = PrefillHandler(engine, frame_bytes=dcfg.frame_bytes,
                                 chaos=ChaosInjector.from_config(rt.config.chaos))
        gen_handle = await comp.endpoint(args.endpoint).serve(handler.generate)
        await comp.endpoint("kv_fetch").serve(handler.kv_fetch)
        await serve_kv_endpoints(comp, broadcaster, engine.metrics)
        # Pull queued prefill jobs too (competing consumer across the
        # prefill fleet): push and queue dispatch both work.
        puller = PrefillPuller(engine, WorkQueue(rt.store, dcfg.queue_name), rt.store,
                               gen_handle.instance.instance_id, lane=lane).start()
        # No model card: the frontend routes only to decode workers.
        role = "prefill worker"
    else:
        handler = engine
        if args.disagg != "off" and not mocker:
            pcomp = rt.namespace(args.namespace).component(args.prefill_component)
            dcfg = DisaggConfig(
                max_local_prefill_length=args.max_local_prefill_length,
                prefill_component=args.prefill_component,
                stream=not args.no_disagg_stream,
            )
            handler = disagg = RecordingDecodeHandler(
                engine,
                await pcomp.endpoint(dcfg.prefill_endpoint).router(RouterMode.ROUND_ROBIN),
                await pcomp.endpoint(dcfg.fetch_endpoint).router(RouterMode.DIRECT),
                dcfg,
                queue=(None if args.prefill_dispatch == "push"
                       else WorkQueue(rt.store, dcfg.queue_name)),
                store=rt.store,
            )
            # disagg_remote_prefill_total, disagg_fallback_total{reason} and
            # the transfer series on this process's /metrics.
            disagg.bind_metrics(rt.metrics)
        if not mocker:
            # Resolve router peer_prefix hints ahead of disagg and admission.
            handler = fetcher = PeerPrefixFetcher(
                engine, await comp.endpoint(KV_PREFIX_ENDPOINT).router(RouterMode.DIRECT),
                inner=handler)

        async def gen_handler(payload, ctx):
            async for item in handler.generate(payload, ctx):
                yield item

        await comp.endpoint(args.endpoint).serve(gen_handler)
        await serve_kv_endpoints(comp, broadcaster, engine.metrics)
        if not mocker:
            async def embed_handler(payload, ctx):
                try:
                    vec = await engine.embed((payload or {}).get("token_ids") or [])
                    yield {"embedding": vec}
                except Exception as e:  # noqa: BLE001 — per-request failure
                    yield {"error": str(e)}

            await comp.endpoint("embed").serve(embed_handler)

            async def clear_handler(payload, ctx):
                cleared = engine.clear_kv_blocks()
                if (payload or {}).get("zero_counts"):
                    # Between two steps, so no dispatch straddles the zero.
                    await engine.run_on_engine_thread(engine.runner.zero_counts)
                yield {"cleared": cleared}

            await comp.endpoint("clear_kv").serve(clear_handler)
        await register_model(rt, args.namespace, card)
        # One model card per adapter: the frontend lists each as a served
        # model (/v1/models carries its lora metadata), the preprocessor
        # stamps its adapter_id, and its requests route to this engine.
        for acard in adapter_cards(card, args.lora_specs):
            await register_model(rt, args.namespace, acard)
        role = "worker"
    rank = "" if args.dp_rank is None else f" [dp rank {args.dp_rank}/{args.dp_size}]"
    print(
        f"dynamo_tpu_torch {role}: serving {card.name} as "
        f"{args.namespace}/{args.component}/{args.endpoint}{rank} on "
        f"{'no device (mocker)' if mocker else args.device} "
        f"({graphs} window graphs captured in {warm_s:.2f}s, {step_graphs} single-step "
        f"graphs in {step_s:.2f}s, {verify_graphs} verify graphs in {verify_s:.2f}s, "
        f"{prefill_graphs} prefill graphs in {prefill_s:.2f}s; registered "
        f"{time.perf_counter() - t_launch:.2f}s after the runtime started)",
        flush=True,
    )

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    with contextlib.suppress(NotImplementedError):
        loop.add_signal_handler(signal.SIGUSR1, lambda: print_line(
            engine_counters(engine, disagg, fetcher, exporter=exporter)))
    await stop.wait()
    log.info("worker shutting down")
    if puller is not None:
        # Stop claiming queued jobs while the store is still reachable (its
        # watch is cancelled on the store), then drain as any worker does.
        await puller.stop()
    # Deregister and drain the endpoints first, so in-flight streams
    # finish on the engine (their spans end there); then stop it.
    await rt.shutdown()
    await close_fleet_planes(publisher, exporter)
    await stop_engine(engine)
    print_line(engine_counters(engine, disagg, fetcher, exporter=exporter))
    close_group(engine)


def print_line(record: dict) -> None:
    """``record`` as one JSON line in one write: tp followers share the
    leader's stdout pipe, and a line written in pieces (``print`` writes
    the text and its newline apart on an unbuffered stream) can interleave
    with theirs."""
    sys.stdout.write(json.dumps(record) + "\n")
    sys.stdout.flush()


async def close_fleet_planes(publisher, exporter) -> None:
    """Withdraw the directory entry and flush the spans once more (the
    store client outlives the runtime's shutdown)."""
    if publisher is not None:
        with contextlib.suppress(Exception):
            await publisher.close()
    if exporter is not None:
        with contextlib.suppress(Exception):
            await exporter.close()


async def stop_engine(engine) -> None:
    """Stop the engine (its tp followers with it); the tp group closes
    once the counters line has been printed (``close_group``)."""
    stop = getattr(engine, "stop", None)  # the mocker has no thread to stop
    if stop is not None:
        await stop()


def close_group(engine) -> None:
    group = getattr(getattr(engine, "runner", None), "group", None)
    if group is not None:
        group.close()


async def serve_autoscaled(rt, engine, card, args, broadcaster, warm_note: str,
                           publisher=None, exporter=None) -> None:
    """``--autoscaler on``: the role manager owns the endpoints and the card
    (the JAX worker's wiring); serve until SIGTERM or retirement, then
    retire (relocating running decodes to peers), stop the engine and
    close the runtime."""
    from dynamo_tpu_torch.planner.actions import POOL_DECODE, POOL_PREFILL
    from dynamo_tpu_torch.worker.roles import WorkerRoleManager

    role = (POOL_PREFILL if args.is_prefill_worker or args.autoscaler_role == "prefill"
            else POOL_DECODE)
    manager = await WorkerRoleManager(
        rt, engine, [card] + adapter_cards(card, args.lora_specs), args, broadcaster,
        chaos=ChaosInjector.from_config(rt.config.chaos),
    ).start(role)
    where = "no device (mocker)" if args.engine == "mocker" else args.device
    print(f"dynamo_tpu_torch autoscaled {manager.role} worker: serving {card.name} in "
          f"namespace {args.namespace} (workerctl/admin live) on {where} {warm_note}",
          flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    with contextlib.suppress(NotImplementedError):
        loop.add_signal_handler(signal.SIGUSR1, lambda: print_line(
            engine_counters(engine, manager=manager, exporter=exporter)))
    stop_task = loop.create_task(stop.wait())
    retired_task = loop.create_task(manager.retired.wait())
    await asyncio.wait((stop_task, retired_task), return_when=asyncio.FIRST_COMPLETED)
    for t in (stop_task, retired_task):
        t.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await t
    log.info("worker shutting down")
    await manager.close()
    await close_fleet_planes(publisher, exporter)
    await stop_engine(engine)
    await rt.shutdown()
    print_line(engine_counters(engine, manager=manager, exporter=exporter))
    close_group(engine)


def dp_rank_ports(base_port: int, dp_rank: int, stride: int = 4) -> dict:
    """Deterministic per-rank port block (the JAX worker's): rank r owns
    [base + r*stride, base + (r+1)*stride). Only the ``system`` slot (status
    HTTP when DYNTPU_SYSTEM_ENABLED) is consumed; the rest of the block is
    reserved for rank-local services, so external launchers can rely on
    the stride."""
    b = base_port + dp_rank * stride
    return {"system": b, "reserved": (b + 1, b + stride)}


def launch_counts() -> dict:
    """The kernels' launch counts, as the counters lines name them."""
    return {"paged_attention_launches": pa.launches, "int8_matmul_launches": im.launches,
            "int8_matmul_prefill_launches": im.prefill_launches,
            "int8_matmul_tied_launches": im.tied_launches,
            "int8_matmul_wide_launches": im.wide_launches,
            "int8_matmul_decode_launches": im.decode_launches}


def run_follower(args) -> None:
    """A tensor-parallel follower rank: no store, no endpoint; replays the
    leader's dispatch stream on this rank's shards, then prints its
    counters line (launches, collectives, the sampled-token digest)."""
    from dynamo_tpu_torch.engine.runner import follower_loop

    rank = args.dist_process_id
    group = tp_group(args, rank)
    model, params = load_weights(args, rank)
    eargs = engine_args(args, model, tokenizer_spec_for(args.model_path, args.tokenizer),
                        str(group.device))
    runner = follower_loop(eargs, step_addr(args), params=params, seed=args.seed, group=group,
                           on_zero=lambda _: print_line(
                               {"event": "follower_counts_zeroed", "rank": rank,
                                **launch_counts()}))
    print_line({
        "event": "follower_counters", "rank": rank, "token_digest": runner.digest(),
        **launch_counts(),
        "eager_windows": runner.eager_windows, "eager_steps": runner.eager_steps,
        "lora_windows": runner.lora_windows, "collectives": group.counters(),
        "peak_device_bytes": (torch.cuda.max_memory_allocated()
                              if runner.device.type == "cuda" else 0)})
    runner.stop()
    group.close()


def spawn_tp_followers(args, argv) -> list:
    """``--tp N`` on one host: start ranks 1..N-1 as processes of this same
    command (rank r on card r mod the cards), meeting at a fresh local
    coordinator, and make this process rank 0 → the follower processes."""
    ports = []
    for _ in range(2):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            ports.append(sk.getsockname()[1])
    args.dist_coordinator = f"127.0.0.1:{ports[0]}"
    args.dist_step_addr = f"127.0.0.1:{ports[1]}"
    args.dist_num_processes = args.tp
    base = list(argv if argv is not None else sys.argv[1:])
    return [subprocess.Popen([
        sys.executable, "-m", "dynamo_tpu_torch.worker", *base,
        "--dist-num-processes", str(args.tp), "--dist-process-id", str(r),
        "--dist-coordinator", args.dist_coordinator, "--dist-step-addr", args.dist_step_addr])
        for r in range(1, args.tp)]


def run_dp_spawner(args, argv) -> int:
    """Spawn and supervise one worker process per dp rank (the JAX worker's
    spawner). Ranks are independent replicas of the same model: a dead rank
    loses only its own KV and lease, so the spawner does not gang-kill on a
    single failure; it forwards SIGINT/SIGTERM and exits with the worst
    child code once all ranks are done. With ``--dp-restart`` a crashed
    rank is respawned after jittered exponential backoff (the frontend
    fleet's BackoffPolicy and DYNTPU_FLEET_RESTART_BACKOFF_* knobs)."""
    base = list(argv if argv is not None else sys.argv[1:])
    procs: list[subprocess.Popen] = []
    stopping = False

    def forward(signum, _frame):
        nonlocal stopping
        stopping = True  # mid-launch: abort spawning further ranks too
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    # Installed before spawning: a signal mid-launch must still reach the
    # ranks already running, or they orphan with cards and leases held.
    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)

    def spawn_rank(r: int) -> subprocess.Popen:
        env = dict(os.environ)
        if args.dp_chips_per_rank > 0:
            k = args.dp_chips_per_rank
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(c) for c in range(r * k, (r + 1) * k))
        if env.get("DYNTPU_SYSTEM_ENABLED"):
            env["DYNTPU_SYSTEM_PORT"] = str(dp_rank_ports(args.dp_base_port, r)["system"])
        return subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.worker", *base, "--dp-rank", str(r)],
            env=env)

    try:
        for r in range(args.dp_size):
            if stopping:
                break
            procs.append(spawn_rank(r))
    except Exception:
        # A failed spawn must not leave earlier ranks orphaned.
        for p in procs:
            if p.poll() is None:
                p.terminate()
        raise
    if stopping:
        # A rank spawned while the handler ran may have missed the signal.
        for p in procs:
            if p.poll() is None:
                p.terminate()
    print(f"dynamo_tpu_torch dp spawner: {args.dp_size} ranks launched", flush=True)
    if args.dp_restart and not stopping:
        from dynamo_tpu_torch.fleet.backoff import BackoffPolicy
        from dynamo_tpu_torch.runtime.config import Config

        fcfg = Config.from_env().fleet
        backoff = BackoffPolicy(fcfg.restart_backoff_base, fcfg.restart_backoff_max,
                                fcfg.restart_reset_after)
        failures = [0] * len(procs)
        started = [time.monotonic()] * len(procs)
        restart_at = [0.0] * len(procs)
        while not stopping:
            now = time.monotonic()
            for r, p in enumerate(procs):
                # rc 0 is a deliberate exit: only crashed ranks restart.
                if p.poll() is None or p.returncode == 0:
                    continue
                if restart_at[r] == 0.0:
                    if now - started[r] > backoff.reset_after:
                        failures[r] = 0
                    failures[r] += 1
                    restart_at[r] = now + backoff.delay(failures[r])
                    print(f"dynamo_tpu_torch dp spawner: rank {r} exited rc={p.returncode}, "
                          f"restart in {restart_at[r] - now:.2f}s", flush=True)
                elif now >= restart_at[r] and not stopping:
                    try:
                        procs[r] = spawn_rank(r)
                    except Exception:
                        for q in procs:
                            if q.poll() is None:
                                q.terminate()
                        raise
                    started[r] = now
                    restart_at[r] = 0.0
            if all(p.poll() is not None and p.returncode == 0 for p in procs):
                break  # every rank exited cleanly: nothing left to supervise
            time.sleep(0.25)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
    rcs = [p.wait() for p in procs]
    return max((abs(rc) for rc in rcs), default=0)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dp_size > 1 and args.dp_rank is None:
        return run_dp_spawner(args, argv)
    if args.tp > 1 and args.dist_num_processes > 1 and args.dist_process_id > 0:
        run_follower(args)
        return 0
    followers = spawn_tp_followers(args, argv) if args.tp > 1 and \
        args.dist_num_processes == 1 else []
    try:
        asyncio.run(async_main(args))
    finally:
        # The followers end when the leader's stream does; a leader that
        # failed before connecting them takes them down.
        for p in followers:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
