"""Frontend CLI: ``python -m dynamo_tpu_torch.frontend`` (port of
``dynamo_tpu/frontend/__main__.py``).

One process: the store client, model discovery (``ModelManager`` /
``ModelWatcher``), a pipeline per discovered model (preprocessor →
router → migration → detokenizing backend) and the OpenAI HTTP service.
Flags mirror the JAX frontend's: router mode and the KV router's tuning
(overlap weight, temperature, KV-events toggle, index shards, shortlist),
``--record-dir`` (response streams and routing events as JSONL, which
``python -m dynamo_tpu_torch.llm.logprobs`` reads), admission control and
the QoS classes (``--qos``).

Fleet mode (``--fleet N``) delegates to the fleet supervisor
(``fleet/supervisor.py``): N copies of this process share one listen
port, lease admission slots from a global budget through the store, and
keep KV-router stickiness consistent through the shared decision cache
and the global prefix directory. A fleet child is this CLI with
``--fleet-worker-id`` set. With tracing on and ``DYNTPU_TRACE_EXPORT=1``
the process exports its spans to the store under ``--fleet-id``, where
the supervisor stitches one trace across processes.

SIGTERM drains: new requests get 503 + Retry-After while in-flight
streams run to completion, then the planes are torn down (a fleet child
first leaves the shared port and hands its budget and decision leases
back).

With ``--qos``, the early rejection's TTFT predictor takes its
model-based term from ``--qos-profile p.npz`` or, without it, from the SLA
profile a worker ships in its model card (``--sla-profile``): the first
such card discovered fills whatever the flag left empty, and the frontend
logs ``qos: SLA profile adopted from model card <name>``. Without either
it works from the observed drain rate alone.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import signal
import socket
import sys

from dynamo_tpu_torch.kv_router.router import KvRouterConfig
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.pipeline import RouterSettings
from dynamo_tpu_torch.runtime.admission import AdmissionController
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.push_router import RouterMode

log = get_logger("frontend")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.frontend")
    p.add_argument("--store-url", default=None, help="control-plane store (tcp://host:port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--namespace", default=None, help="only serve models from this namespace")
    p.add_argument(
        "--router-mode", choices=["round-robin", "random", "kv"], default="round-robin"
    )
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    p.add_argument("--no-kv-events", action="store_true",
                   help="KV mode without worker events (TTL-predictive index)")
    p.add_argument("--index-shards", type=int, default=0,
                   help="run the KV index across N shard threads so event floods never "
                        "stall routing (0 = in-loop index)")
    p.add_argument("--shortlist-k", type=int, default=16,
                   help="placement candidate pruning: score only the index's top-k holder "
                        "shortlist + least-loaded workers instead of the whole fleet "
                        "(0 = full scan)")
    p.add_argument("--record-dir", default=None,
                   help="record response streams + routing events to JSONL here "
                        "(replayable offline; llm/recorder.py, llm/logprobs.py)")
    # Admission control (overrides for the [admission]/[runtime] config
    # sections).
    p.add_argument("--max-inflight", type=int, default=None,
                   help="max concurrent inference requests before shedding "
                        "429s (default: DYNTPU_ADMISSION_MAX_INFLIGHT; 0 = unlimited)")
    p.add_argument("--max-queue-depth", type=int, default=None,
                   help="extra requests allowed to wait for a slot before shedding")
    p.add_argument("--request-timeout", type=float, default=None,
                   help="default end-to-end deadline (s) when the client "
                        "sends no X-Request-Timeout (0 = none)")
    # Multi-tenant QoS: priority classes on the admission gate (WDRR fair
    # shares, aging, early rejection) and per-class fleet budget pools.
    p.add_argument("--qos", action="store_true",
                   help="enable priority classes (interactive/standard/batch via body "
                        "'priority' or x-priority header): weighted fair-share admission, "
                        "class-aware fleet budget pools, early rejection from the observed "
                        "drain rate (also DYNTPU_QOS_ENABLED), and a model-based TTFT term "
                        "from an SLA profile (--qos-profile, or one shipped in a model card)")
    p.add_argument("--qos-profile", default=None,
                   help="profiled SLA npz (python -m dynamo_tpu_torch.planner.profile_sweep) "
                        "powering admission-time TTFT prediction; without it early "
                        "rejection falls back to the observed drain rate")
    # Frontend fleet. --fleet N supervises N child copies of this CLI
    # sharing one port; the remaining flags configure fleet-wide behaviour
    # and are inherited by the children.
    p.add_argument("--fleet", type=int, default=0,
                   help="spawn and supervise N frontend processes sharing "
                        "this port (0 = single process)")
    p.add_argument("--fleet-id", default="default",
                   help="store namespace for this fleet's budget leases, "
                        "decision cache, registrations and exported traces")
    p.add_argument("--fleet-admin-port", type=int, default=0,
                   help="supervisor aggregation endpoint port "
                        "(merged /metrics + /debug/requests; 0 = ephemeral)")
    p.add_argument("--global-max-inflight", type=int, default=None,
                   help="fleet-wide concurrent-request budget leased in "
                        "chunks through the store; without --fleet it "
                        "applies as the local admission bound "
                        "(default: DYNTPU_FLEET_GLOBAL_MAX_INFLIGHT; 0 = off)")
    p.add_argument("--budget-chunk", type=int, default=None,
                   help="slots per budget chunk (claim granularity)")
    # Internal (set by the fleet supervisor on child processes).
    p.add_argument("--fleet-worker-id", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--reuse-port", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--inherited-socket-fd", type=int, default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.fleet and args.fleet_worker_id is not None:
        p.error("--fleet and --fleet-worker-id are mutually exclusive")
    return args


async def async_main(args) -> None:
    from dynamo_tpu_torch.runtime import tracing

    fleet_child = args.fleet_worker_id is not None
    # Trace-lane identity: this process's spans render in their own lane
    # of the stitched fleet timeline.
    lane = f"frontend-{args.fleet_worker_id}" if fleet_child else "frontend"
    tracing.set_default_lane(lane)
    rt = await DistributedRuntime.create(store_url=args.store_url, proc_label=lane)
    fcfg = rt.config.fleet
    trace_exporter = None
    if tracing.enabled() and os.environ.get("DYNTPU_TRACE_EXPORT", "") not in ("", "0"):
        from dynamo_tpu_torch.runtime.trace_export import TraceExporter

        trace_exporter = await TraceExporter(rt.store, args.fleet_id, lane=lane).start()

    settings = RouterSettings(mode=RouterMode(args.router_mode), record_dir=args.record_dir)
    if settings.mode == RouterMode.KV:
        settings.kv = KvRouterConfig(
            overlap_score_weight=args.kv_overlap_score_weight,
            router_temperature=args.router_temperature,
            use_kv_events=not args.no_kv_events,
            index_shards=args.index_shards,
            shortlist_k=args.shortlist_k,
        )

    fleet_metrics = budget = decisions = directory = None
    if fleet_child:
        from dynamo_tpu_torch.fleet import register_fleet_child_metrics
        from dynamo_tpu_torch.fleet.decisions import RouterDecisionCache
        from dynamo_tpu_torch.fleet.directory import PrefixDirectory

        fleet_metrics = register_fleet_child_metrics(rt.metrics)
        # Sticky routing across sibling processes: every KV placement is
        # published to (and mirrored from) the store-backed decision cache,
        # so a follow-up turn accepted by a different frontend still lands
        # on the engine holding its prefix.
        decisions = await RouterDecisionCache(
            rt.store, args.fleet_id, ttl=fcfg.decision_ttl,
            metrics={
                "entries": fleet_metrics["decision_entries"],
                "hits": fleet_metrics["decision_hits"],
                "writes": fleet_metrics["decision_writes"],
            },
        ).start()
        # Purge decisions for retired or dead workers as soon as their
        # registration goes (well before decision_ttl expires).
        with contextlib.suppress(Exception):
            await decisions.watch_workers(args.namespace or "dynamo")
        settings.decisions = decisions
        # Global prefix directory: the residency mirror behind
        # transfer-vs-recompute routing (workers publish under
        # --kv-directory on; an empty mirror is inert).
        directory = await PrefixDirectory(
            rt.store, args.namespace or "dynamo",
            metrics={"entries": fleet_metrics["directory_entries"]},
        ).start()
        settings.directory = directory
        settings.fleet_metrics = fleet_metrics

    acfg = rt.config.admission
    qcfg = rt.config.qos
    qos_on = args.qos or qcfg.enabled
    policy = predictor = None
    if qos_on:
        from dynamo_tpu_torch.runtime.qos import QosPolicy, TtftPredictor

        policy = QosPolicy.from_config(qcfg)
        prefill = decode = None
        if args.qos_profile:
            from dynamo_tpu_torch.planner.interpolate import load_profile

            decode, prefill = load_profile(args.qos_profile)
            log.info("qos: loaded SLA profile %s (prefill=%s decode=%s)",
                     args.qos_profile, prefill is not None, decode is not None)
        # Early rejection works from the observed drain rate alone when
        # no profile is loaded; the profile adds the model-based term.
        predictor = TtftPredictor(prefill=prefill, decode=decode)

    def on_card(card) -> None:
        # Card-shipped SLA profile: a worker that was profiled publishes
        # its latency curves in its model card, so the admission-time TTFT
        # predictor self-configures from discovery — an explicit
        # --qos-profile still wins.
        if predictor is None or not card.sla_profile:
            return
        if predictor.prefill is not None and predictor.decode is not None:
            return
        from dynamo_tpu_torch.planner.interpolate import interpolators_from_card_dict

        decode, prefill = interpolators_from_card_dict(card.sla_profile)
        if predictor.prefill is None and prefill is not None:
            predictor.prefill = prefill
        if predictor.decode is None and decode is not None:
            predictor.decode = decode
        if prefill is not None or decode is not None:
            log.info("qos: SLA profile adopted from model card %s", card.name)

    manager = ModelManager(rt, settings, on_card=on_card)
    watcher = await ModelWatcher(rt, manager, namespace=args.namespace).start()
    global_budget = (fcfg.global_max_inflight if args.global_max_inflight is None
                     else args.global_max_inflight)
    chunk_slots = fcfg.budget_chunk_slots if args.budget_chunk is None else args.budget_chunk
    budget_metrics = {
        "slots": fleet_metrics["budget_slots"],
        "chunks": fleet_metrics["budget_chunks"],
        "claims": fleet_metrics["budget_claims"],
    } if fleet_metrics else None
    kw = {"retry_after": acfg.retry_after, "queue_timeout": acfg.queue_timeout}
    qdepth = acfg.max_queue_depth if args.max_queue_depth is None else args.max_queue_depth
    if fleet_child and global_budget > 0 and qos_on:
        from dynamo_tpu_torch.fleet.budget import (
            ClassBudgetSet,
            QosBudgetedAdmissionController,
            split_class_budget,
        )

        # Per-class chunk pools: the fleet-wide budget splits by the
        # configured shares and each class leases its own chunk namespace
        # (one holder per chunk, so the fleet-wide per-class caps hold);
        # lower classes scavenge idle higher-class chunks until a pressure
        # beacon calls them home.
        budget = ClassBudgetSet(
            rt.store, args.fleet_id, await rt.primary_lease(),
            totals=split_class_budget(global_budget, {
                "interactive": qcfg.share_interactive,
                "standard": qcfg.share_standard,
                "batch": qcfg.share_batch,
            }),
            policy=policy,
            chunk_slots=chunk_slots,
            worker_id=args.fleet_worker_id,
            metrics=budget_metrics,
        )
        if qdepth > 0:
            kw["max_queue_depth"] = qdepth
        admission: AdmissionController = QosBudgetedAdmissionController(
            budget, predictor=predictor, **kw
        )
        await budget.start()
    elif fleet_child and global_budget > 0:
        from dynamo_tpu_torch.fleet.budget import BudgetedAdmissionController, GlobalBudget

        # Per-process gate leasing slot chunks from the fleet-wide budget:
        # the store's create-if-absent makes over-admission impossible, and
        # the primary lease's TTL returns this process's chunks if it dies
        # without draining.
        budget = GlobalBudget(
            rt.store, args.fleet_id, await rt.primary_lease(),
            total=global_budget,
            chunk_slots=chunk_slots,
            worker_id=args.fleet_worker_id,
            metrics=budget_metrics,
        )
        if qdepth > 0:  # 0 = keep the controller's budget-aware default
            kw["max_queue_depth"] = qdepth
        admission = BudgetedAdmissionController(budget, **kw)
        await budget.start()
    else:
        max_inflight = acfg.max_inflight if args.max_inflight is None else args.max_inflight
        if global_budget > 0 and args.max_inflight is None:
            # One process: the fleet-wide budget is a plain local bound
            # (ignoring the flag would leave the frontend unbounded while
            # the operator believes a cap is in force).
            max_inflight = global_budget
            log.info("single-process frontend: --global-max-inflight %d applied "
                     "as the local admission bound", global_budget)
        admission = AdmissionController(
            max_inflight=max_inflight,
            max_queue_depth=qdepth,
            retry_after=acfg.retry_after,
            queue_timeout=acfg.queue_timeout,
            qos=policy,
            predictor=predictor,
        )
    default_timeout = (
        rt.config.runtime.default_request_timeout
        if args.request_timeout is None
        else args.request_timeout
    )
    inherited = None
    if args.inherited_socket_fd is not None:
        # Wrapping an inherited, already-listening fd does no I/O.
        inherited = socket.socket(fileno=args.inherited_socket_fd)
    http = await HttpService(
        manager, rt.metrics, health=rt.health, host=args.host, port=args.port,
        admission=admission, default_timeout=default_timeout,
        reuse_port=args.reuse_port, sock=inherited,
        admin_port=0 if fleet_child else None,
        proc_label=lane,
    ).start()

    reg_key = None
    if fleet_child:
        from dynamo_tpu_torch.fleet.supervisor import frontends_prefix

        # Lease-backed registration: the supervisor's aggregator finds this
        # process's admin site here, and the entry vanishes with the lease
        # if the process dies.
        reg_key = frontends_prefix(args.fleet_id) + str(args.fleet_worker_id)
        await rt.store.put(
            reg_key,
            json.dumps({
                "pid": os.getpid(),
                "host": args.host,
                "port": http.port,
                "admin": f"http://127.0.0.1:{http.admin_port}",
            }).encode(),
            lease_id=await rt.primary_lease(),
        )
        print(f"dynamo_tpu_torch frontend [fleet {args.fleet_id}/{args.fleet_worker_id}]: "
              f"http://{args.host}:{http.port} admin http://127.0.0.1:{http.admin_port}",
              flush=True)
    else:
        print(f"dynamo_tpu_torch frontend: http://{args.host}:{http.port}", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()

    def on_signal() -> None:
        if stop.is_set():
            # Second signal: the operator wants out now — skip the drain.
            log.warning("second signal during drain: forcing exit")
            os._exit(130)
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, on_signal)
    await stop.wait()
    # Graceful drain: stop admitting (503 + Retry-After), let in-flight
    # streams run to completion, then tear the planes down. A fleet child
    # also hands its shared state back before it exits: budget chunks are
    # released as streams finish and the decision-cache leases are revoked,
    # else they would linger until their TTLs while a replacement serves.
    log.info("frontend draining (%d in flight)", admission.inflight)
    if fleet_child:
        # Leave the shared-port accept group first: new connections land on
        # siblings; only connections already accepted here can still see the
        # (retryable) drain 503.
        await http.stop_accepting()
    http.start_draining()
    if not await http.wait_drained(rt.config.runtime.graceful_shutdown_timeout):
        log.warning("drain timeout: %d streams still in flight at shutdown", admission.inflight)

    async def teardown() -> None:
        if trace_exporter is not None:
            with contextlib.suppress(Exception):
                await trace_exporter.close()  # final flush before the planes drop
        if reg_key is not None:
            with contextlib.suppress(Exception):
                await rt.store.delete(reg_key)
        # HTTP closes before the budget releases: on a drain timeout the
        # undrained streams are cut here, so every slot handed back below
        # really is free (the fleet-wide admitted ≤ budget invariant).
        await http.close()
        if budget is not None:
            await budget.close()  # return every held chunk now, not at lease TTL
        if decisions is not None:
            await decisions.close(flush=True)  # revoke decision leases now
        if directory is not None:
            await directory.close()
        log.info("frontend shutting down")
        await watcher.close()
        await manager.close()
        await rt.shutdown()

    try:
        # Bounded: clients are served; teardown must not hang the process
        # on a dead control plane (lease-backed keys self-clean via TTL).
        await asyncio.wait_for(teardown(), timeout=15.0)
    except Exception as e:  # noqa: BLE001 — exit anyway (incl. teardown timeout)
        log.warning("teardown incomplete (%s: %s); exiting", type(e).__name__, e)
        os._exit(0)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.fleet > 0:
        from dynamo_tpu_torch.fleet.supervisor import run_fleet

        return run_fleet(args, list(argv if argv is not None else sys.argv[1:]))
    asyncio.run(async_main(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
