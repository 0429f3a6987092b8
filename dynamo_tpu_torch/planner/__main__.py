"""Planner CLI: `python -m dynamo_tpu_torch.planner`.

Load-based autoscaling of local worker replicas against a frontend's
/metrics (reference CLI: python -m dynamo.planner; local connector =
the circus analogue). Worker argv after ``--`` is spawned per replica:

  python -m dynamo_tpu_torch.planner --metrics-url http://127.0.0.1:8080/metrics \
      --min-replicas 1 --max-replicas 4 -- \
      -m dynamo_tpu_torch.worker --engine mocker --store-url tcp://127.0.0.1:4222

``--operate`` runs the CLOSED-LOOP SLA autoscaler instead
(docs/autoscaler.md): observe the frontend, decide through the profiled
interpolators + hysteresis/cooldown control law, and ACTUATE — live
pool moves and replica retirement via each worker's ``workerctl/admin``
endpoint (workers must run ``--autoscaler on``), frontend fleet resizes
via the supervisor's ``POST /fleet/resize``:

  python -m dynamo_tpu_torch.planner --operate \
      --metrics-url http://127.0.0.1:8080/metrics \
      --store-url tcp://127.0.0.1:4222 --namespace dynamo \
      --itl-sla-ms 20 --ttft-sla-ms 300 --profile-from-discovery \
      --fleet-admin http://127.0.0.1:9901

Port of ``dynamo_tpu/planner/__main__.py``, with every flag of it. The
port adds ``--decision-log PATH``: the operate loop appends one JSON line
per cycle (the law's inputs, decisions and actuations;
``operator.cycle_record``), which ``operator.replay_law`` replays. The
profile comes from ``python -m dynamo_tpu_torch.planner.profile_sweep``
(or a JAX ``tools/profile_sweep.py`` file: the npz is the same).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import signal

from dynamo_tpu_torch.planner.connector import LocalProcessConnector
from dynamo_tpu_torch.planner.core import HttpMetricsSource, Planner, PlannerConfig
from dynamo_tpu_torch.planner.interpolate import load_profile


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.planner")
    p.add_argument("--metrics-url", required=True, help="frontend /metrics URL")
    p.add_argument("--component", default="backend")
    p.add_argument("--adjustment-interval", type=float, default=30.0)
    p.add_argument("--predictor", default="ar",
                   choices=["constant", "moving-average", "ar", "seasonal"])
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=8)
    p.add_argument("--replica-tok-s", type=float, default=1000.0)
    p.add_argument("--mean-output-tokens", type=float, default=128.0)
    p.add_argument("--itl-sla-ms", type=float, default=None)
    p.add_argument("--ttft-sla-ms", type=float, default=None)
    p.add_argument("--profile", default=None,
                   help="npz from python -m dynamo_tpu_torch.planner.profile_sweep")
    # Disaggregated deployments scale prefill separately (reference:
    # planner_core.py:241-276).
    p.add_argument("--prefill-component", default=None)
    p.add_argument("--mean-input-tokens", type=float, default=512.0)
    p.add_argument("--prefill-tok-s", type=float, default=8000.0)
    # Closed-loop operate mode (SlaAutoscaler; docs/autoscaler.md).
    p.add_argument("--operate", action="store_true",
                   help="run the closed-loop autoscaler: actuate pool "
                        "moves/replica scaling through worker admin RPCs "
                        "and fleet resizes through the supervisor")
    p.add_argument("--store-url", default=None,
                   help="control-plane store (operate mode)")
    p.add_argument("--namespace", default="dynamo",
                   help="worker namespace to operate (operate mode)")
    p.add_argument("--operator-id", default="default")
    p.add_argument("--fleet-admin", default=None,
                   help="fleet supervisor admin URL for frontend resizes")
    p.add_argument("--fleet-child-rps", type=float, default=0.0,
                   help="profiled per-frontend-child request capacity "
                        "(0 = frontend fleet scaling off)")
    p.add_argument("--hysteresis-cycles", type=int, default=2)
    p.add_argument("--cooldown", type=float, default=30.0)
    # Fleet hot-spot balancer (planner/balancer.py): continuous
    # migration-based rebalancing of the decode pool, stepped inside
    # the operate loop's cadence.
    p.add_argument("--balance", choices=["on", "off"], default="off",
                   help="on = rebalance decode load with live migrations "
                        "(workers need a migratable engine)")
    p.add_argument("--balance-saturation", type=float, default=0.75,
                   help="load score above which an engine sheds")
    p.add_argument("--balance-idle", type=float, default=0.45,
                   help="load score below which an engine absorbs")
    p.add_argument("--balance-cooldown", type=float, default=30.0,
                   help="per-(src,dst)-pair cooldown after an actuated move")
    p.add_argument("--replica-scaling", choices=["on", "off"], default="off",
                   help="on = spawn/retire worker replicas (worker argv "
                        "after --); off = pool moves only (fixed chips)")
    p.add_argument("--profile-from-discovery", action="store_true",
                   help="adopt the SLA profile a worker shipped in its "
                        "model card (--sla-profile) instead of --profile")
    p.add_argument("--connector", choices=["local", "kubernetes"], default="local")
    p.add_argument("--k8s-namespace", default="default")
    p.add_argument("--k8s-deployment", action="append", default=[],
                   help="component=deployment mapping, repeatable "
                        "(default: component name = deployment name)")
    p.add_argument("--decision-log", default=None,
                   help="operate mode: append each cycle's inputs, decisions and "
                        "actuations to this file as JSON lines")
    p.add_argument("worker_args", nargs=argparse.REMAINDER,
                   help="-- followed by the worker argv (after the interpreter; local connector)")
    return p.parse_args(argv)


async def discover_card_profile(store, namespace: str | None):
    """Scan the store's model cards for one that ships an sla_profile
    (worker --sla-profile) → (decode, prefill) interpolators or
    (None, None). The discovery-first half of ROADMAP 2c."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, model_prefix
    from dynamo_tpu_torch.planner.interpolate import interpolators_from_card_dict

    for entry in await store.get_prefix(model_prefix(namespace)):
        try:
            card = ModelDeploymentCard.from_bytes(entry.value)
        except Exception:  # noqa: BLE001 — one malformed card must not stop profile discovery
            continue
        decode, prefill = interpolators_from_card_dict(card.sla_profile)
        if decode is not None or prefill is not None:
            return decode, prefill
    return None, None


def operator_config(args):
    """The operate loop's OperatorConfig from the CLI's arguments."""
    from dynamo_tpu_torch.planner.operator import OperatorConfig

    return OperatorConfig(
        operator_id=args.operator_id,
        interval_s=args.adjustment_interval,
        ttft_sla_ms=args.ttft_sla_ms,
        itl_sla_ms=args.itl_sla_ms,
        mean_input_tokens=args.mean_input_tokens,
        mean_output_tokens=args.mean_output_tokens,
        predictor=args.predictor,
        max_engines=args.max_replicas,
        min_fleet=1,
        fleet_child_rps=args.fleet_child_rps,
        decode_tok_s=args.replica_tok_s,
        prefill_tok_s=args.prefill_tok_s,
        hysteresis_cycles=args.hysteresis_cycles,
        cooldown_s=args.cooldown,
        replica_scaling=args.replica_scaling == "on",
    )


def decision_logger(path: str):
    """→ a recorder appending each cycle record to ``path`` as a JSON line."""
    import json

    def record(rec: dict) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    return record


async def operate_main(args) -> None:
    """The closed-loop autoscaler process (SlaAutoscaler)."""
    from dynamo_tpu_torch.planner.actions import ActionJournal
    from dynamo_tpu_torch.planner.actuate import (
        FleetHttpActuator,
        ProcessReplicaLauncher,
        RuntimeActuator,
    )
    from dynamo_tpu_torch.planner.operator import (
        ControlLaw,
        SlaAutoscaler,
        register_planner_metrics,
    )
    from dynamo_tpu_torch.runtime.chaos import ChaosInjector
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.push_router import RouterMode
    from dynamo_tpu_torch.worker.roles import ADMIN_COMPONENT, ADMIN_ENDPOINT

    rt = await DistributedRuntime.create(store_url=args.store_url)
    decode_interp = prefill_interp = None
    if args.profile:
        decode_interp, prefill_interp = load_profile(args.profile)
    elif args.profile_from_discovery:
        decode_interp, prefill_interp = await discover_card_profile(
            rt.store, args.namespace
        )
        print(
            f"dynamo_tpu planner: card profile discovered "
            f"(decode={decode_interp is not None} prefill={prefill_interp is not None})",
            flush=True,
        )
    cfg = operator_config(args)
    launcher = None
    if cfg.replica_scaling:
        worker_argv = args.worker_args
        if worker_argv and worker_argv[0] == "--":
            worker_argv = worker_argv[1:]
        if not worker_argv:
            raise SystemExit("--replica-scaling on needs worker argv after --")
        launcher = ProcessReplicaLauncher({
            "decode": [*worker_argv, "--autoscaler", "on"],
            "prefill": [*worker_argv, "--autoscaler", "on",
                        "--autoscaler-role", "prefill"],
        })
    admin_router = await (
        rt.namespace(args.namespace).component(ADMIN_COMPONENT)
        .endpoint(ADMIN_ENDPOINT).router(RouterMode.DIRECT)
    )
    # Cache-aware scale-down: when engines publish residency
    # (--kv-directory on) the victim choice consults measured prefix
    # heat; an empty mirror degrades to the age heuristic for free.
    from dynamo_tpu_torch.fleet.directory import PrefixDirectory

    heat_source = await PrefixDirectory(rt.store, args.namespace).start()
    pool_actuator = RuntimeActuator(
        rt.store, args.namespace, admin_router, launcher=launcher,
        heat_source=heat_source,
    )
    fleet_actuator = (
        FleetHttpActuator(args.fleet_admin) if args.fleet_admin else None
    )
    # The admission gate's queue depth + drain EMA ride the same
    # frontend base URL as /metrics.
    admission_url = None
    if args.metrics_url.endswith("/metrics"):
        admission_url = args.metrics_url[: -len("/metrics")] + "/debug/admission"
    balancer = None
    if args.balance == "on":
        from dynamo_tpu_torch.planner.balancer import (
            BalancerConfig,
            BalancerLaw,
            build_fleet_balancer,
            register_balancer_metrics,
        )

        balancer = await build_fleet_balancer(
            rt, args.namespace, args.component,
            law=BalancerLaw(BalancerConfig(
                saturation=args.balance_saturation,
                idle=args.balance_idle,
                pair_cooldown_s=args.balance_cooldown,
                settle_s=args.balance_cooldown,
                hysteresis_cycles=args.hysteresis_cycles,
            )),
            metrics=register_balancer_metrics(rt.metrics),
            operator_id=args.operator_id,
        ).build()
    auto = SlaAutoscaler(
        ControlLaw(cfg, decode_interp, prefill_interp),
        HttpMetricsSource(args.metrics_url, admission_url=admission_url),
        pool_actuator=pool_actuator,
        fleet_actuator=fleet_actuator,
        journal=ActionJournal(rt.store, args.operator_id, await rt.primary_lease()),
        metrics=register_planner_metrics(rt.metrics),
        chaos=ChaosInjector.from_config(rt.config.chaos),
        balancer=balancer,
        recorder=decision_logger(args.decision_log) if args.decision_log else None,
    )
    await auto.start()
    print(
        f"dynamo_tpu planner (closed loop): watching {args.metrics_url}, "
        f"operating namespace {args.namespace}", flush=True,
    )
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await auto.stop()
    await heat_source.close()
    if launcher is not None:
        await launcher.close()
    await rt.shutdown()


async def async_main(args) -> None:
    decode_interp = prefill_interp = None
    if args.profile:
        decode_interp, prefill_interp = load_profile(args.profile)
    if args.connector == "kubernetes":
        from dynamo_tpu_torch.planner.connector import KubernetesConnector

        mapping = dict(kv.split("=", 1) for kv in args.k8s_deployment)
        connector = KubernetesConnector(
            namespace=args.k8s_namespace, deployment_of=mapping
        )
    else:
        worker_argv = args.worker_args
        if worker_argv and worker_argv[0] == "--":
            worker_argv = worker_argv[1:]
        if not worker_argv:
            raise SystemExit("missing worker argv after --")
        connector = LocalProcessConnector({args.component: worker_argv})
    planner = Planner(
        PlannerConfig(
            component=args.component,
            adjustment_interval_s=args.adjustment_interval,
            predictor=args.predictor,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            replica_tok_s=args.replica_tok_s,
            mean_output_tokens=args.mean_output_tokens,
            itl_sla_ms=args.itl_sla_ms,
            ttft_sla_ms=args.ttft_sla_ms,
            prefill_component=args.prefill_component,
            mean_input_tokens=args.mean_input_tokens,
            prefill_tok_s=args.prefill_tok_s,
        ),
        connector,
        HttpMetricsSource(args.metrics_url),
        decode_interp=decode_interp,
        prefill_interp=prefill_interp,
    )
    if args.connector == "local":
        connector.set_replicas(args.component, args.min_replicas)
    await planner.start()
    print(f"dynamo_tpu planner: watching {args.metrics_url}, scaling {args.component}", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await planner.stop()
    if hasattr(connector, "shutdown"):
        connector.shutdown()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.operate:
        asyncio.run(operate_main(args))
        return 0
    asyncio.run(async_main(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
