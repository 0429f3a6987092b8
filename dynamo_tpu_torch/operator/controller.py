"""Graph reconciler: converge the cluster onto a DynamoGraphDeployment.

Reference analogue: the kubebuilder controllers (reference:
deploy/cloud/operator/internal/controller/
dynamographdeployment_controller.go:1-325 — graph → per-component
resources — and dynamocomponentdeployment_controller.go — resource
rendering + etcd cleanup on teardown). Redesigned for this stack: one
Python reconciler, spec-hash-annotated Deployments/Services (no
semantic diffing), and store-state cleanup instead of etcd cleanup.

Reconciliation is level-triggered and idempotent:
  desired  = GraphSpec.build_manifests()
  live     = objects labeled dynamo-tpu.dev/graph=<name>
  create what is missing, replace what hash-drifted, delete the rest.
Teardown (graph removed) deletes every labeled object and purges the
graph's runtime state (instances/ + models/ prefixes) from the store so
routers never see ghost workers (reference: operator etcd cleanup,
dynamocomponentdeployment_controller.go).
"""

from __future__ import annotations

from typing import Any

from dynamo_tpu_torch.operator.graph import (
    GRAPH_LABEL,
    SPEC_HASH_ANNOTATION,
    GraphSpec,
    spec_hash,
)
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("operator")

_KINDS = ("Deployment", "Service", "ServiceAccount", "Role", "RoleBinding")


class Reconciler:
    def __init__(self, kube, store_factory=None):
        """kube: KubeApi-like. store_factory(url) → KeyValueStore client
        (defaults to the runtime store client; injectable for tests)."""
        self.kube = kube
        self._store_factory = store_factory

    # -- one graph ---------------------------------------------------------

    def reconcile(self, graph: GraphSpec) -> dict[str, int]:
        """Converge one graph. → action counts {created, updated, deleted,
        unchanged}."""
        desired = graph.build_manifests()
        desired_by_key = {
            (m["kind"], m["metadata"]["name"]): m for m in desired
        }
        counts = {"created": 0, "updated": 0, "deleted": 0, "unchanged": 0}
        live_by_key: dict[tuple[str, str], dict] = {}
        for kind in _KINDS:
            for obj in self.kube.list(kind, graph.namespace,
                                      f"{GRAPH_LABEL}={graph.name}"):
                live_by_key[(kind, obj["metadata"]["name"])] = obj

        for key, manifest in desired_by_key.items():
            live = live_by_key.get(key)
            if live is None:
                self.kube.create(manifest)
                counts["created"] += 1
                log.info("%s: created %s/%s", graph.name, *key)
            else:
                live_hash = (live["metadata"].get("annotations") or {}).get(
                    SPEC_HASH_ANNOTATION
                )
                want = manifest["metadata"]["annotations"][SPEC_HASH_ANNOTATION]
                if live_hash != want:
                    self.kube.replace(manifest)
                    counts["updated"] += 1
                    log.info("%s: updated %s/%s", graph.name, *key)
                else:
                    counts["unchanged"] += 1

        for key, obj in live_by_key.items():
            if key not in desired_by_key:
                self.kube.delete(key[0], graph.namespace, key[1])
                counts["deleted"] += 1
                log.info("%s: deleted stale %s/%s", graph.name, *key)
        return counts

    # -- teardown ----------------------------------------------------------

    def teardown(self, graph: GraphSpec, clean_store: bool = True) -> dict[str, int]:
        """Delete every object of the graph; purge its store state."""
        counts = {"deleted": 0}
        for kind in _KINDS:
            for obj in self.kube.list(kind, graph.namespace,
                                      f"{GRAPH_LABEL}={graph.name}"):
                self.kube.delete(kind, graph.namespace, obj["metadata"]["name"])
                counts["deleted"] += 1
        if clean_store:
            counts["store_keys"] = self._clean_store(graph)
        log.info("%s: teardown removed %d objects", graph.name, counts["deleted"])
        return counts

    def _clean_store(self, graph: GraphSpec) -> int:
        """Purge instances/<ns>/ and models/<ns>/ so discovery forgets the
        graph immediately instead of waiting out lease TTLs."""
        import asyncio

        async def purge() -> int:
            if self._store_factory is not None:
                store = await self._store_factory(graph.resolved_store_url())
            else:
                from dynamo_tpu_torch.runtime.store import connect_store

                store = await connect_store(graph.resolved_store_url())
            n = 0
            try:
                for prefix in (f"instances/{graph.dynamo_namespace}/",
                               f"models/{graph.dynamo_namespace}/"):
                    n += await store.delete_prefix(prefix)
            finally:
                close = getattr(store, "close", None)
                if close is not None:
                    res = close()
                    if asyncio.iscoroutine(res):
                        await res
            return n

        try:
            return asyncio.run(purge())
        except Exception as e:  # noqa: BLE001 — store may already be gone
            log.warning("%s: store cleanup skipped (%s)", graph.name, e)
            return 0

    # -- control loop over CRs --------------------------------------------

    def sync_namespace(self, namespace: str, known: dict[str, GraphSpec]) -> dict[str, GraphSpec]:
        """Poll-based CR sync: reconcile every DynamoGraphDeployment in
        `namespace`; tear down graphs that vanished since the last sync.
        → the new known-graph map."""
        current: dict[str, GraphSpec] = {}
        for doc in self.kube.list_graphs(namespace):
            name = (doc.get("metadata") or {}).get("name", "?")
            try:
                doc.setdefault("metadata", {}).setdefault("namespace", namespace)
                g = GraphSpec.parse(doc)
            except ValueError as e:
                log.error("graph %s invalid: %s", name, e)
                self.kube.patch_graph_status(namespace, name, {"error": str(e)})
                if name in known:
                    # The CR still EXISTS — a spec typo must never read as
                    # "graph vanished" and tear down a live deployment.
                    # Keep the last-good spec until the CR parses again.
                    current[name] = known[name]
                continue
            current[g.name] = g
            counts = self.reconcile(g)
            self.kube.patch_graph_status(namespace, g.name, {
                "observedServices": len(g.services),
                "lastReconcile": counts,
            })
        for name, g in known.items():
            if name not in current:
                self.teardown(g)
        return current
