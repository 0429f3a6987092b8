"""Minimal Kubernetes REST client for the operator (no kubernetes-client
dependency — the same two-call style as the planner's connector,
dynamo_tpu_torch/planner/connector.py:KubernetesConnector), on the
standard library's urllib (``runtime/urlfetch.py``).

Covers exactly what reconciliation needs: get/list/create/replace/delete
for Deployments and Services, list/get for the DynamoGraphDeployment CRs,
and a patch for CR status. In-cluster service-account auth by default.
"""

from __future__ import annotations

import json
import os
from typing import Any

from dynamo_tpu_torch.operator.graph import GROUP, PLURAL, VERSION
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("operator.kube")

_PATHS = {
    "Deployment": "/apis/apps/v1/namespaces/{ns}/deployments",
    "Service": "/api/v1/namespaces/{ns}/services",
    "ServiceAccount": "/api/v1/namespaces/{ns}/serviceaccounts",
    "Role": "/apis/rbac.authorization.k8s.io/v1/namespaces/{ns}/roles",
    "RoleBinding": "/apis/rbac.authorization.k8s.io/v1/namespaces/{ns}/rolebindings",
}


class KubeError(Exception):
    def __init__(self, status: int, body: str):
        super().__init__(f"kube api {status}: {body[:200]}")
        self.status = status


class KubeApi:
    def __init__(self, api_base: str | None = None, token: str | None = None,
                 verify: bool | str = True):
        if api_base is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            api_base = f"https://{host}:{port}"
        self.api_base = api_base
        sa = "/var/run/secrets/kubernetes.io/serviceaccount"
        if token is None and os.path.exists(f"{sa}/token"):
            with open(f"{sa}/token") as f:
                token = f.read().strip()
        self.token = token
        if verify is True and os.path.exists(f"{sa}/ca.crt"):
            verify = f"{sa}/ca.crt"
        self.verify = verify

    def _req(self, method: str, path: str, body: dict | None = None,
             content_type: str = "application/json") -> Any:
        from dynamo_tpu_torch.runtime import urlfetch

        headers = {"Accept": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if body is not None:
            headers["Content-Type"] = content_type
        r = urlfetch.request(
            method, self.api_base + path, headers=headers,
            body=json.dumps(body).encode() if body is not None else None,
            verify=self.verify, timeout=15,
        )
        if r.status_code >= 400:
            raise KubeError(r.status_code, r.text)
        return r.json() if r.content else None

    # -- typed helpers -----------------------------------------------------

    def _col(self, kind: str, ns: str) -> str:
        return _PATHS[kind].format(ns=ns)

    def get(self, kind: str, ns: str, name: str) -> dict | None:
        try:
            return self._req("GET", f"{self._col(kind, ns)}/{name}")
        except KubeError as e:
            if e.status == 404:
                return None
            raise

    def list(self, kind: str, ns: str, label_selector: str | None = None) -> list[dict]:
        path = self._col(kind, ns)
        if label_selector:
            path += f"?labelSelector={label_selector}"
        return (self._req("GET", path) or {}).get("items", [])

    def create(self, manifest: dict) -> dict:
        ns = manifest["metadata"].get("namespace", "default")
        return self._req("POST", self._col(manifest["kind"], ns), manifest)

    def replace(self, manifest: dict) -> dict:
        ns = manifest["metadata"].get("namespace", "default")
        name = manifest["metadata"]["name"]
        live = self.get(manifest["kind"], ns, name)
        if live is not None:  # PUT needs the live resourceVersion
            manifest = dict(manifest)
            manifest["metadata"] = dict(manifest["metadata"])
            manifest["metadata"]["resourceVersion"] = live["metadata"]["resourceVersion"]
            if manifest["kind"] == "Service":
                # clusterIP is immutable; carry it over
                spec = dict(manifest.get("spec") or {})
                spec.setdefault("clusterIP", live.get("spec", {}).get("clusterIP"))
                manifest["spec"] = spec
        return self._req(
            "PUT", f"{self._col(manifest['kind'], ns)}/{name}", manifest
        )

    def delete(self, kind: str, ns: str, name: str) -> None:
        try:
            self._req("DELETE", f"{self._col(kind, ns)}/{name}")
        except KubeError as e:
            if e.status != 404:
                raise

    # -- DynamoGraphDeployment CRs ----------------------------------------

    def _cr_col(self, ns: str) -> str:
        return f"/apis/{GROUP}/{VERSION}/namespaces/{ns}/{PLURAL}"

    def list_graphs(self, ns: str) -> list[dict]:
        return (self._req("GET", self._cr_col(ns)) or {}).get("items", [])

    def patch_graph_status(self, ns: str, name: str, status: dict) -> None:
        try:
            self._req(
                "PATCH", f"{self._cr_col(ns)}/{name}/status",
                {"status": status}, content_type="application/merge-patch+json",
            )
        except KubeError as e:
            log.warning("status patch for %s/%s failed: %s", ns, name, e)


class FakeKubeApi:
    """In-memory KubeApi for tests and `--dry-run`: same surface, dict
    store, records every mutation."""

    def __init__(self):
        self.objects: dict[tuple[str, str, str], dict] = {}
        self.graphs: dict[tuple[str, str], dict] = {}
        self.actions: list[tuple[str, str]] = []  # (verb, kind/name)

    def get(self, kind, ns, name):
        return self.objects.get((kind, ns, name))

    def list(self, kind, ns, label_selector=None):
        sel = {}
        if label_selector:
            for part in label_selector.split(","):
                k, _, v = part.partition("=")
                sel[k] = v
        out = []
        for (k, n, _name), obj in self.objects.items():
            if k != kind or n != ns:
                continue
            labels = obj["metadata"].get("labels", {})
            if all(labels.get(a) == b for a, b in sel.items()):
                out.append(obj)
        return out

    def create(self, manifest):
        key = (manifest["kind"], manifest["metadata"].get("namespace", "default"),
               manifest["metadata"]["name"])
        self.objects[key] = manifest
        self.actions.append(("create", f"{key[0]}/{key[2]}"))
        return manifest

    def replace(self, manifest):
        key = (manifest["kind"], manifest["metadata"].get("namespace", "default"),
               manifest["metadata"]["name"])
        self.objects[key] = manifest
        self.actions.append(("replace", f"{key[0]}/{key[2]}"))
        return manifest

    def delete(self, kind, ns, name):
        self.objects.pop((kind, ns, name), None)
        self.actions.append(("delete", f"{kind}/{name}"))

    def list_graphs(self, ns):
        return [g for (n, _), g in self.graphs.items() if n == ns]

    def patch_graph_status(self, ns, name, status):
        g = self.graphs.get((ns, name))
        if g is not None:
            g.setdefault("status", {}).update(status)
        self.actions.append(("status", f"graph/{name}"))
