"""Operator CLI: `python -m dynamo_tpu_torch.operator`.

Reference analogue: the dynamo-operator binary (reference:
deploy/cloud/operator/cmd/main.go) — here a poll-based reconciler with
three sources of truth:

  --graph g.yaml        file mode: reconcile one graph from a YAML file
                        (re-read every interval; ConfigMap-mount friendly)
  --watch               CR mode: poll DynamoGraphDeployment objects in
                        --namespace via the API server (Helm installs the
                        CRD: deploy/helm/dynamo-tpu/crds/)
  --render              print the generated manifests for a graph file
                        and exit (kubectl apply -f - workflow, no
                        operator privileges needed)

--once reconciles a single time and exits (CI / smoke tests).
--delete tears the graph down (objects + store state) and exits.

Port of ``dynamo_tpu/operator/__main__.py``; graph files are read and
manifests rendered with ``operator/yaml_lite.py`` in place of PyYAML.
"""

from __future__ import annotations

import argparse
import sys
import time

from dynamo_tpu_torch.operator.controller import Reconciler
from dynamo_tpu_torch.operator.graph import GraphSpec, load_graph_file
from dynamo_tpu_torch.runtime.logging import get_logger, init_logging

log = get_logger("operator.main")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch.operator")
    p.add_argument("--graph", default=None, help="graph YAML file (file mode)")
    p.add_argument("--watch", action="store_true",
                   help="poll DynamoGraphDeployment CRs in --namespace")
    p.add_argument("--namespace", default="default")
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument("--once", action="store_true")
    p.add_argument("--render", action="store_true",
                   help="print manifests for --graph and exit")
    p.add_argument("--delete", action="store_true",
                   help="tear down --graph (objects + store state) and exit")
    p.add_argument("--api-base", default=None, help="k8s API base URL override")
    p.add_argument("--token", default=None)
    p.add_argument("--no-verify", action="store_true")
    args = p.parse_args(argv)
    if not args.watch and not args.graph:
        p.error("one of --graph or --watch is required")
    if args.render and not args.graph:
        p.error("--render needs --graph")
    if args.delete and not args.graph:
        p.error("--delete needs --graph")
    return args


def render(graph: GraphSpec) -> str:
    from dynamo_tpu_torch.operator import yaml_lite

    return yaml_lite.dump_all(graph.build_manifests())


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    if args.render:
        print(render(load_graph_file(args.graph)))
        return 0

    from dynamo_tpu_torch.operator.kube import KubeApi

    kube = KubeApi(api_base=args.api_base, token=args.token,
                   verify=not args.no_verify)
    rec = Reconciler(kube)

    if args.delete:
        graph = load_graph_file(args.graph)
        counts = rec.teardown(graph)
        log.info("teardown: %s", counts)
        return 0

    known: dict[str, GraphSpec] = {}
    while True:
        try:
            if args.watch:
                known = rec.sync_namespace(args.namespace, known)
            else:
                graph = load_graph_file(args.graph)
                counts = rec.reconcile(graph)
                known = {graph.name: graph}
                log.info("reconciled %s: %s", graph.name, counts)
        except Exception:  # noqa: BLE001 — controller must keep running
            log.exception("reconcile pass failed")
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
