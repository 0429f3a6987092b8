"""DynamoGraphDeployment: the declarative graph spec + manifest builder.

Reference analogue: the operator CRD types and per-component Deployment
generation (reference: deploy/cloud/operator/api/v1alpha1/
dynamographdeployment_types.go:31-75 — a map of service overrides — and
internal/controller/dynamocomponentdeployment_controller.go which renders
them into Deployments/Services). TPU-first differences: services default
to this framework's own CLIs (frontend/worker/planner/metrics_exporter),
TPU scheduling uses GKE nodeSelector + google.com/tpu resources instead
of nvidia.com/gpu, and the store replaces etcd+NATS.

The spec is a CR-shaped document (kind DynamoGraphDeployment,
apiVersion dynamo-tpu.dev/v1alpha1) usable three ways: as a file fed to
`python -m dynamo_tpu_torch.operator --graph g.yaml`, as a real cluster CR the
operator polls, or rendered by the Helm chart (deploy/helm/dynamo-tpu).

Port of ``dynamo_tpu/operator/graph.py``: the rendered commands name the
port's CLIs (``python -m dynamo_tpu_torch.<cli>``); group, version, kind,
labels and the spec hash are the JAX package's, so both operators
reconcile the same CRs. Graph files are read with ``yaml_lite`` (PyYAML
is absent on the card's machine).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any

GROUP = "dynamo-tpu.dev"
VERSION = "v1alpha1"
KIND = "DynamoGraphDeployment"
PLURAL = "dynamographdeployments"
SPEC_HASH_ANNOTATION = f"{GROUP}/spec-hash"
GRAPH_LABEL = f"{GROUP}/graph"
SERVICE_LABEL = f"{GROUP}/service"

# componentType → (module, default args builder). Workers/frontend take
# the store URL; extraArgs append after.
_KNOWN_TYPES = ("frontend", "worker", "prefill", "planner", "metrics", "custom")


@dataclass
class ServiceSpec:
    name: str                       # key in spec.services
    component_type: str             # one of _KNOWN_TYPES (inferred from name if absent)
    replicas: int = 1
    image: str | None = None        # override graph image
    args: list[str] = field(default_factory=list)   # appended to the base command
    command: list[str] | None = None                # full override (componentType custom)
    port: int | None = None         # containerPort (+ Service when set)
    env: dict[str, str] = field(default_factory=dict)
    resources: dict[str, Any] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def infer_type(name: str) -> str:
        n = name.lower()
        for t in ("frontend", "prefill", "planner", "metrics", "worker"):
            if t in n:
                return t
        return "custom"


@dataclass
class GraphSpec:
    name: str
    namespace: str = "default"      # k8s namespace
    dynamo_namespace: str = "dynamo"  # runtime Namespace (store keys)
    image: str = "dynamo-tpu:latest"
    store_url: str | None = None    # None + manage_store → in-graph store
    manage_store: bool = True
    store_port: int = 4222
    services: dict[str, ServiceSpec] = field(default_factory=dict)
    uid: str | None = None          # CR uid (for ownerReferences)

    # -- parsing -----------------------------------------------------------

    @classmethod
    def parse(cls, doc: dict[str, Any]) -> "GraphSpec":
        if doc.get("kind") != KIND:
            raise ValueError(f"expected kind {KIND}, got {doc.get('kind')!r}")
        meta = doc.get("metadata") or {}
        spec = doc.get("spec") or {}
        if not meta.get("name"):
            raise ValueError("metadata.name is required")
        store = spec.get("store") or {}
        g = cls(
            name=meta["name"],
            namespace=meta.get("namespace", "default"),
            dynamo_namespace=spec.get("dynamoNamespace", "dynamo"),
            image=spec.get("image", "dynamo-tpu:latest"),
            store_url=spec.get("storeUrl"),
            manage_store=bool(store.get("manage", spec.get("storeUrl") is None)),
            store_port=int(store.get("port", 4222)),
            uid=meta.get("uid"),
        )
        services = spec.get("services") or {}
        if not isinstance(services, dict) or not services:
            raise ValueError("spec.services must be a non-empty map")
        for name, s in services.items():
            s = s or {}
            ctype = s.get("componentType") or ServiceSpec.infer_type(name)
            if ctype not in _KNOWN_TYPES:
                raise ValueError(f"service {name}: unknown componentType {ctype!r}")
            if ctype == "custom" and not s.get("command"):
                raise ValueError(f"service {name}: componentType custom needs 'command'")
            replicas = int(s.get("replicas", 1))
            if replicas < 0:
                raise ValueError(f"service {name}: negative replicas")
            g.services[name] = ServiceSpec(
                name=name,
                component_type=ctype,
                replicas=replicas,
                image=s.get("image"),
                args=[str(a) for a in s.get("extraArgs") or s.get("args") or []],
                command=s.get("command"),
                port=s.get("port"),
                env={str(k): str(v) for k, v in (s.get("env") or {}).items()},
                resources=s.get("resources") or {},
                node_selector=s.get("nodeSelector") or {},
            )
        return g

    # -- naming ------------------------------------------------------------

    def obj_name(self, svc: str) -> str:
        return f"{self.name}-{svc.lower()}"

    @property
    def store_name(self) -> str:
        return f"{self.name}-store"

    def resolved_store_url(self) -> str:
        if self.store_url:
            return self.store_url
        return f"tcp://{self.store_name}:{self.store_port}"

    # -- manifest building -------------------------------------------------

    def _base_command(self, s: ServiceSpec) -> list[str]:
        url = self.resolved_store_url()
        if s.component_type == "frontend":
            cmd = ["python", "-m", "dynamo_tpu_torch.frontend", "--store-url", url,
                   "--port", str(s.port or 8000)]
        elif s.component_type == "worker":
            cmd = ["python", "-m", "dynamo_tpu_torch.worker", "--store-url", url]
        elif s.component_type == "prefill":
            cmd = ["python", "-m", "dynamo_tpu_torch.worker", "--store-url", url,
                   "--is-prefill-worker"]
        elif s.component_type == "planner":
            # --store-url wires the closed-loop surface too: add
            # `--operate` (+ SLA flags) via extraArgs and the pod runs
            # the SlaAutoscaler against the in-graph store — worker
            # admin RPCs for pool moves, K8s scale patches for replicas
            # (docs/autoscaler.md).
            cmd = ["python", "-m", "dynamo_tpu_torch.planner",
                   "--connector", "kubernetes", "--store-url", url]
        elif s.component_type == "metrics":
            cmd = ["python", "-m", "dynamo_tpu_torch.metrics_exporter", "--store-url", url,
                   "--port", str(s.port or 9091)]
        else:
            cmd = list(s.command or [])
        return cmd + s.args

    def _labels(self, svc: str) -> dict[str, str]:
        return {
            "app": self.obj_name(svc),
            GRAPH_LABEL: self.name,
            SERVICE_LABEL: svc.lower(),
        }

    def _owner_refs(self) -> list[dict]:
        if not self.uid:
            return []
        return [{
            "apiVersion": f"{GROUP}/{VERSION}", "kind": KIND,
            "name": self.name, "uid": self.uid,
            "controller": True, "blockOwnerDeletion": True,
        }]

    def _deployment(self, svc: str, s: ServiceSpec) -> dict:
        container: dict[str, Any] = {
            "name": svc.lower(),
            "image": s.image or self.image,
            "command": self._base_command(s),
        }
        if s.port:
            container["ports"] = [{"containerPort": s.port}]
            if s.component_type == "frontend":
                container["readinessProbe"] = {
                    "httpGet": {"path": "/health", "port": s.port},
                    "initialDelaySeconds": 3,
                }
        if s.env:
            container["env"] = [{"name": k, "value": v} for k, v in sorted(s.env.items())]
        if s.resources:
            container["resources"] = s.resources
        pod_spec: dict[str, Any] = {"containers": [container]}
        if s.node_selector:
            pod_spec["nodeSelector"] = s.node_selector
        if s.component_type == "planner":
            pod_spec["serviceAccountName"] = f"{self.name}-planner"
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {
                "name": self.obj_name(svc),
                "namespace": self.namespace,
                "labels": self._labels(svc),
                "ownerReferences": self._owner_refs(),
            },
            "spec": {
                "replicas": s.replicas,
                "selector": {"matchLabels": {"app": self.obj_name(svc)}},
                "template": {
                    "metadata": {"labels": self._labels(svc)},
                    "spec": pod_spec,
                },
            },
        }

    def _service(self, svc: str, port: int, target_name: str | None = None) -> dict:
        name = target_name or self.obj_name(svc)
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": name,
                "namespace": self.namespace,
                "labels": self._labels(svc),
                "ownerReferences": self._owner_refs(),
            },
            "spec": {
                "selector": {"app": name},
                "ports": [{"port": port, "targetPort": port}],
            },
        }

    def _store_manifests(self) -> list[dict]:
        dep = {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {
                "name": self.store_name,
                "namespace": self.namespace,
                "labels": self._labels("store"),
                "ownerReferences": self._owner_refs(),
            },
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": self.store_name}},
                "template": {
                    "metadata": {"labels": self._labels("store")},
                    "spec": {"containers": [{
                        "name": "store",
                        "image": self.image,
                        "command": ["python", "-m", "dynamo_tpu_torch.runtime.store_server",
                                    "--host", "0.0.0.0",
                                    "--port", str(self.store_port)],
                        "ports": [{"containerPort": self.store_port}],
                    }]},
                },
            },
        }
        return [dep, self._service("store", self.store_port)]

    def _planner_rbac(self) -> list[dict]:
        """ServiceAccount + Role(+Binding) the planner pod runs as: it
        patches Deployments' scale subresource (planner/connector.py)."""
        name = f"{self.name}-planner"
        meta = {
            "name": name, "namespace": self.namespace,
            "labels": self._labels("planner"),
            "ownerReferences": self._owner_refs(),
        }
        return [
            {"apiVersion": "v1", "kind": "ServiceAccount", "metadata": dict(meta)},
            {
                "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role",
                "metadata": dict(meta),
                "rules": [{
                    "apiGroups": ["apps"],
                    "resources": ["deployments", "deployments/scale"],
                    "verbs": ["get", "patch"],
                }],
            },
            {
                "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "RoleBinding",
                "metadata": dict(meta),
                "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                            "kind": "Role", "name": name},
                "subjects": [{"kind": "ServiceAccount", "name": name,
                              "namespace": self.namespace}],
            },
        ]

    def build_manifests(self) -> list[dict]:
        """→ every k8s object this graph needs, spec-hash annotated."""
        out: list[dict] = []
        if self.manage_store and not self.store_url:
            out.extend(self._store_manifests())
        if any(s.component_type == "planner" for s in self.services.values()):
            out.extend(self._planner_rbac())
        for svc, s in self.services.items():
            out.append(self._deployment(svc, s))
            if s.port:
                out.append(self._service(svc, s.port))
        for m in out:
            ann = m["metadata"].setdefault("annotations", {})
            ann[SPEC_HASH_ANNOTATION] = spec_hash(m)
        return out


def spec_hash(manifest: dict) -> str:
    """Deterministic content hash (annotations excluded) driving the
    reconciler's needs-update decision."""
    def strip(o):
        if isinstance(o, dict):
            return {k: strip(v) for k, v in sorted(o.items()) if k != "annotations"}
        if isinstance(o, list):
            return [strip(v) for v in o]
        return o

    return hashlib.sha256(
        json.dumps(strip(manifest), sort_keys=True).encode()
    ).hexdigest()[:16]


def load_graph_file(path: str) -> GraphSpec:
    from dynamo_tpu_torch.operator import yaml_lite

    with open(path) as f:
        doc = yaml_lite.load(f.read())
    return GraphSpec.parse(doc)
