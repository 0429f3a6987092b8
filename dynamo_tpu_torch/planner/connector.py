"""Scaling connectors: how the planner actually changes replica counts.

Reference analogue: the Kubernetes connector (patches
DynamoGraphDeployment replicas) and the Circus local process controller
(reference: components/planner/src/dynamo/planner/kubernetes_connector.py,
circusd.py:32-47). Here: a local subprocess connector (spawns/terminates
``python -m dynamo_tpu_torch.worker`` processes) and a recording fake for
tests/dry-runs. A K8s connector belongs with the deploy layer.

Port of ``dynamo_tpu/planner/connector.py``; the Kubernetes connector
talks to the API server through the standard library in place of httpx.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from typing import Protocol

from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.connector")


class Connector(Protocol):
    def get_replicas(self, component: str) -> int: ...

    def set_replicas(self, component: str, n: int) -> None: ...


class RecordingConnector:
    """Test/dry-run connector: applies nothing, records everything."""

    def __init__(self, initial: dict[str, int] | None = None):
        self.replicas: dict[str, int] = dict(initial or {})
        self.calls: list[tuple[str, int]] = []

    def get_replicas(self, component: str) -> int:
        return self.replicas.get(component, 0)

    def set_replicas(self, component: str, n: int) -> None:
        self.calls.append((component, n))
        self.replicas[component] = n


class LocalProcessConnector:
    """Scales worker replicas as local subprocesses — the dev/single-host
    story (circus analogue). ``base_args[component]`` is the worker CLI
    argv (without the interpreter)."""

    def __init__(self, base_args: dict[str, list[str]]):
        self.base_args = base_args
        self._procs: dict[str, list[subprocess.Popen]] = {c: [] for c in base_args}

    def get_replicas(self, component: str) -> int:
        procs = self._procs.setdefault(component, [])
        procs[:] = [p for p in procs if p.poll() is None]
        return len(procs)

    def set_replicas(self, component: str, n: int) -> None:
        procs = self._procs.setdefault(component, [])
        procs[:] = [p for p in procs if p.poll() is None]
        while len(procs) < n:
            argv = [sys.executable, *self.base_args[component]]
            log.info("scaling up %s: spawning replica %d", component, len(procs) + 1)
            procs.append(subprocess.Popen(argv))
        while len(procs) > n:
            proc = procs.pop()  # newest-first teardown
            log.info("scaling down %s: terminating pid %d", component, proc.pid)
            proc.send_signal(signal.SIGTERM)

    def shutdown(self) -> None:
        for procs in self._procs.values():
            for p in procs:
                if p.poll() is None:
                    p.terminate()
        for procs in self._procs.values():
            for p in procs:
                try:
                    p.wait(5)
                except subprocess.TimeoutExpired:
                    p.kill()


class KubernetesConnector:
    """Patches Deployment replica counts through the Kubernetes API
    (reference: components/planner/src/dynamo/planner/kubernetes_connector.py
    + kube.py — there it patches the DynamoGraphDeployment CRD and the
    operator reconciles; here the deploy skeleton ships plain Deployments
    (deploy/k8s/), so the planner scales them directly).

    Talks to the API server over HTTPS with the in-cluster service
    account (no kubernetes client dependency — two REST calls, through
    the standard library's urllib, ``runtime/urlfetch.py``). The
    ``deployment_of`` map routes planner components to Deployment names,
    e.g. {"backend": "dynamo-tpu-worker", "prefill": "dynamo-tpu-prefill"}.
    """

    def __init__(self, namespace: str = "default",
                 deployment_of: dict[str, str] | None = None,
                 api_base: str | None = None, token: str | None = None,
                 verify: bool | str = True):
        self.namespace = namespace
        self.deployment_of = deployment_of or {}
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

    def _url(self, component: str, scale: bool) -> str:
        name = self.deployment_of.get(component, component)
        suffix = "/scale" if scale else ""
        return (f"{self.api_base}/apis/apps/v1/namespaces/{self.namespace}"
                f"/deployments/{name}{suffix}")

    def _headers(self, patch: bool = False) -> dict:
        h = {"Accept": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        if patch:
            h["Content-Type"] = "application/merge-patch+json"
        return h

    def get_replicas(self, component: str) -> int:
        from dynamo_tpu_torch.runtime import urlfetch

        r = urlfetch.request("GET", self._url(component, scale=True),
                             headers=self._headers(), verify=self.verify, timeout=10)
        r.raise_for_status()
        return int(r.json().get("spec", {}).get("replicas", 0))

    def set_replicas(self, component: str, n: int) -> None:
        from dynamo_tpu_torch.runtime import urlfetch

        r = urlfetch.request(
            "PATCH", self._url(component, scale=True),
            headers=self._headers(patch=True),
            body=json.dumps({"spec": {"replicas": int(n)}}).encode(),
            verify=self.verify, timeout=10,
        )
        r.raise_for_status()
        log.info("k8s: scaled %s to %d", component, n)
