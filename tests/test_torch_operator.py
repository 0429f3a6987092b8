"""The port's operator (graph spec, manifests, yaml_lite, the Kubernetes
REST client, the reconciler, the CLI) and the planner's Kubernetes
connector, held against the JAX package's.

- Manifests equal the JAX ones with ``dynamo_tpu.`` replaced by
  ``dynamo_tpu_torch.`` in the container commands and nothing else; the
  spec hash is the same function of the manifest.
- ``yaml_lite.load`` equals ``yaml.safe_load`` on the graph documents,
  on the CRD and on PyYAML's own rendering of the manifests;
  ``yaml.safe_load(yaml_lite.dump(m)) == m`` for every manifest; what
  lies outside the subset raises and names itself.
- Against one fake API server (HTTP on localhost), the port's reconciler
  and connector make the same REST calls, in the same order, with the
  same bodies (up to the module prefix), as the JAX ones.
"""

from __future__ import annotations

import copy
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlsplit

import pytest
import yaml

from dynamo_tpu.operator import graph as jgraph
from dynamo_tpu.operator.controller import Reconciler as JRec
from dynamo_tpu.operator.kube import KubeApi as JKube
from dynamo_tpu.planner.connector import KubernetesConnector as JConn
from dynamo_tpu_torch.operator import graph as tgraph
from dynamo_tpu_torch.operator import yaml_lite
from dynamo_tpu_torch.operator.controller import Reconciler as TRec
from dynamo_tpu_torch.operator.kube import KubeApi as TKube
from dynamo_tpu_torch.operator.kube import KubeError
from dynamo_tpu_torch.planner.connector import KubernetesConnector as TConn
from test_operator import GRAPH_YAML

REPO = Path(__file__).resolve().parents[1]

PLANNER_YAML = """
# A disaggregated graph with the closed-loop planner.
apiVersion: dynamo-tpu.dev/v1alpha1
kind: DynamoGraphDeployment
metadata:
  name: "disagg-g"       # quoted name
  namespace: 'serving'
  uid: 1234-abcd
spec:
  storeUrl: tcp://store.example:4222
  services:
    Frontend:
      port: 8080
      env: {DYNTPU_QOS_ENABLED: "1", DYNTPU_LOG: debug}
    DecodeWorker:
      componentType: worker
      replicas: 2
      extraArgs:
        - --preset
        - llama-8b
        - --sla-profile
        - /profiles/h100.npz
      resources:
        limits: {nvidia.com/gpu: 1}
    PrefillWorker:
      replicas: 1
      extraArgs: [--max-local-prefill-length, 512]
    Planner:
      extraArgs: ["--operate", "--ttft-sla-ms", 300, "--itl-sla-ms", 25.5, '--balance', on]
    Router:
      componentType: custom
      command:
      - python
      - -m
      - dynamo_tpu.router
      replicas: 0
"""

GRAPHS = {"reference": GRAPH_YAML, "planner": PLANNER_YAML}


def port_of(obj):
    """A JAX manifest as the port renders it: the CLI modules renamed."""
    out = copy.deepcopy(obj)
    for m in out:
        for c in _containers(m):
            c["command"] = [a.replace("dynamo_tpu.", "dynamo_tpu_torch.", 1)
                            if a.startswith("dynamo_tpu.") else a for a in c["command"]]
        m["metadata"].get("annotations", {}).pop(jgraph.SPEC_HASH_ANNOTATION, None)
    return out


def _containers(m):
    return (m.get("spec", {}).get("template", {}).get("spec", {}).get("containers") or [])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_yaml_lite_reads_graph_documents_as_pyyaml(name):
    text = GRAPHS[name]
    assert yaml_lite.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_manifests_equal_up_to_the_module_prefix(name):
    doc = yaml.safe_load(GRAPHS[name])
    if name == "planner":
        # The custom service's command is the user's: it stays as written.
        doc["spec"]["services"]["Router"]["command"][2] = "dynamo_tpu_torch.router"
    jm = jgraph.GraphSpec.parse(copy.deepcopy(doc)).build_manifests()
    tm = tgraph.GraphSpec.parse(copy.deepcopy(doc)).build_manifests()
    for m in tm:
        ann = m["metadata"]["annotations"][tgraph.SPEC_HASH_ANNOTATION]
        assert ann == jgraph.spec_hash(m) == tgraph.spec_hash(m)
    stripped = copy.deepcopy(tm)
    for m in stripped:
        m["metadata"]["annotations"].pop(tgraph.SPEC_HASH_ANNOTATION)
    assert stripped == port_of(jm)
    assert (tgraph.GROUP, tgraph.VERSION, tgraph.KIND, tgraph.PLURAL) == (
        jgraph.GROUP, jgraph.VERSION, jgraph.KIND, jgraph.PLURAL)
    # The manifests round-trip through yaml_lite's writer into PyYAML, and
    # PyYAML's rendering reads back through yaml_lite.
    for m in tm:
        assert yaml.safe_load(yaml_lite.dump(m)) == m
    for m in jm:
        assert yaml_lite.load(yaml.safe_dump(m, sort_keys=False)) == m
    rendered = "---\n".join(yaml.safe_dump(m, sort_keys=False) for m in jm)
    assert yaml_lite.load_all(rendered) == jm


def test_yaml_lite_reads_the_crd():
    text = (REPO / "deploy/helm/dynamo-tpu/crds/dynamographdeployments.yaml").read_text()
    assert yaml_lite.load_all(text) == list(yaml.safe_load_all(text))


SCALARS = ["", "true", "True", "yes", "off", "null", "~", "1", "-1", "+1", "017", "0x1f",
           "0b101", "1_000", "1.5", ".5", "1e3", "1.0e+3", ".inf", "-.Inf", ".nan", "3:25",
           "2001-12-14", "a: b", "a:b", "#x", "x #y", "- x", "-x", "--flag", "tcp://h:4222",
           "it's", 'say "hi"', "tab\there", "line\nbreak", "é ü ☃", "[x]", "{y}", "*a", "&b",
           "!t", "|", ">", "%d", "@x", "`x", "? q", "?q", " lead", "trail ", "a,b", "k=v"]


@pytest.mark.parametrize("s", SCALARS)
def test_yaml_lite_dump_reads_back_in_pyyaml(s):
    doc = {"k": s, s or "empty": [s, {"n": s}], "list": [[s, 1], [], {}]}
    text = yaml_lite.dump(doc)
    assert yaml.safe_load(text) == doc
    assert yaml_lite.load(text) == doc


def test_yaml_lite_scalar_types_match_pyyaml():
    values = {"a": 1, "b": -2.5, "c": 1e20, "d": 1e-7, "e": float("inf"), "f": None, "g": True,
              "h": False, "i": 0, "j": 12345678901234567890}
    text = yaml_lite.dump(values)
    back = yaml.safe_load(text)
    assert back == values and all(type(back[k]) is type(v) for k, v in values.items())
    plain = "\n".join(f"k{i}: {s}" for i, s in enumerate(
        ["1", "017", "0x1f", "0b11", "1_0", "1.5", "1.", ".5", "+.inf", ".NaN", "yes", "No",
         "ON", "~", "Null", "1e3", "1.0e-3", "0o7", "0.1.2", "1,2"]))
    got, want = yaml_lite.load(plain), yaml.safe_load(plain)
    assert json.dumps(got) == json.dumps(want)
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("text,construct", [
    ("a: |\n  x\n", "block scalars"),
    ("a: >\n  x\n", "block scalars"),
    ("a: &x 1\nb: *x\n", "anchors"),
    ("b: *x\n", "aliases"),
    ("a: !!str 1\n", "tags"),
    ("%YAML 1.1\n---\na: 1\n", "directives"),
    ("? a\n: b\n", "complex keys"),
    ("<<: {a: 1}\n", "merge keys"),
    ("a: 2001-12-14\n", "timestamps"),
    ("a: 3:25:45\n", "sexagesimal"),
    ("a: [1,\n  2]\n", "flow collections over several lines"),
    ("a: 'x\n  y'\n", "quoted scalars over several lines"),
    ("a: b\n  c\n", "plain scalars over several lines"),
    ("a: 1\n...\n", "document end marker"),
    ("a:\n\t- 1\n", "tab"),
    ("a: {b}\n", "without a value"),
])
def test_yaml_lite_refuses_and_names_what_it_does_not_read(text, construct):
    with pytest.raises(yaml_lite.YamlLiteError, match=construct):
        yaml_lite.load(text)


def test_load_graph_file_and_cli_render(tmp_path, capsys):
    from dynamo_tpu.operator.__main__ import render as jrender
    from dynamo_tpu_torch.operator.__main__ import main

    p = tmp_path / "g.yaml"
    p.write_text(PLANNER_YAML)
    g = tgraph.load_graph_file(str(p))
    assert g.name == "disagg-g" and g.services["Planner"].args[-1] == "True"
    assert g.services["Router"].command[2] == "dynamo_tpu.router"  # the user's, as written
    p.write_text(GRAPH_YAML)
    assert main(["--graph", str(p), "--render"]) == 0
    docs = list(yaml.safe_load_all(capsys.readouterr().out))
    assert docs == tgraph.load_graph_file(str(p)).build_manifests()
    jdocs = list(yaml.safe_load_all(jrender(jgraph.load_graph_file(str(p)))))
    for m in docs:
        m["metadata"]["annotations"].pop(tgraph.SPEC_HASH_ANNOTATION)
    assert docs == port_of(jdocs)


# -- a fake Kubernetes API server --------------------------------------------------


class FakeApiServer:
    """Deployments, Services, RBAC objects, their scale subresource and the
    graph CRs under the REST paths KubeApi and the connector use; every
    request recorded as (method, path, query, body)."""

    def __init__(self):
        self.objects: dict[str, dict] = {}  # collection path + "/" + name → object
        self.calls: list[tuple] = []
        self.rv = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, status, body=None):
                data = b"" if body is None else json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _handle(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                body = json.loads(raw) if raw else None
                url = urlsplit(self.path)
                outer.calls.append((self.command, url.path, url.query, body,
                                    self.headers.get("Content-Type"),
                                    self.headers.get("Authorization")))
                self._reply(*outer.route(self.command, url.path, parse_qs(url.query), body))

            do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = _handle

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def route(self, method, path, query, body):
        parts = path.rstrip("/").split("/")
        if parts[-1] == "scale":
            obj = self.objects.get("/".join(parts[:-1]))
            if obj is None:
                return 404, {"reason": "NotFound"}
            if method == "PATCH":
                obj["spec"]["replicas"] = body["spec"]["replicas"]
            return 200, {"spec": {"replicas": obj["spec"]["replicas"]}}
        if parts[-1] == "status" and method == "PATCH":
            return 200, {}
        coll_len = {"api": 6, "apis": 7}[parts[1]]
        is_item = len(parts) == coll_len + 1
        if method == "POST":
            self.rv += 1
            obj = copy.deepcopy(body)
            obj["metadata"]["resourceVersion"] = str(self.rv)
            self.objects[path + "/" + obj["metadata"]["name"]] = obj
            return 201, obj
        if method == "GET" and not is_item:
            sel = dict(kv.split("=", 1) for kv in query.get("labelSelector", [""])[0].split(",")
                       if kv)
            items = [o for k, o in sorted(self.objects.items())
                     if k.rsplit("/", 1)[0] == path
                     and all(o["metadata"].get("labels", {}).get(a) == b for a, b in sel.items())]
            return 200, {"items": items}
        if method == "GET":
            obj = self.objects.get(path)
            return (200, obj) if obj is not None else (404, {"reason": "NotFound"})
        if method == "PUT":
            if path not in self.objects:
                return 404, {"reason": "NotFound"}
            self.rv += 1
            obj = copy.deepcopy(body)
            obj["metadata"]["resourceVersion"] = str(self.rv)
            self.objects[path] = obj
            return 200, obj
        if method == "DELETE":
            return (200, {}) if self.objects.pop(path, None) is not None else (
                404, {"reason": "NotFound"})
        return 405, {}


def normalized(calls):
    return json.loads(json.dumps(calls).replace("dynamo_tpu_torch.", "dynamo_tpu.")
                      .replace(tgraph.SPEC_HASH_ANNOTATION + '": "', "HASH\": \""))


def _hashless(calls):
    out = []
    for c in normalized(calls):
        body = c[3]
        if isinstance(body, dict):
            body.get("metadata", {}).get("annotations", {}).pop("HASH", None)
        out.append(c)
    return out


def drive(rec_cls, kube_cls, graph_mod, server):
    kube = kube_cls(api_base=server.base, token="tok", verify=False)
    rec = rec_cls(kube)
    g = graph_mod.GraphSpec.parse(yaml.safe_load(GRAPH_YAML))
    counts = [rec.reconcile(g), rec.reconcile(g)]
    g.services["Worker"].replicas = 5
    del g.services["MetricsExporter"]
    counts.append(rec.reconcile(g))
    counts.append(rec.teardown(g, clean_store=False))
    assert kube.get("Deployment", "prod", "no-such") is None
    return counts


def test_reconciler_calls_equal_against_a_fake_api_server():
    out = {}
    for name, (rec_cls, kube_cls, graph_mod) in {
            "jax": (JRec, JKube, jgraph), "port": (TRec, TKube, tgraph)}.items():
        server = FakeApiServer()
        try:
            out[name] = (drive(rec_cls, kube_cls, graph_mod, server), server.calls,
                         server.objects)
        finally:
            server.close()
    (jc, jcalls, jobj), (tc, tcalls, tobj) = out["jax"], out["port"]
    assert tc == jc and tc[0]["created"] == 8 and tc[1]["unchanged"] == 8
    assert tc[2] == {"created": 0, "updated": 1, "deleted": 2, "unchanged": 5}
    assert _hashless(tcalls) == _hashless(jcalls) and len(tcalls) == 39
    assert tobj == jobj == {}


def test_kube_error_statuses_and_connector_calls_equal():
    calls = {}
    for name, conn_cls, kube_cls in (("jax", JConn, JKube), ("port", TConn, TKube)):
        server = FakeApiServer()
        try:
            server.objects["/apis/apps/v1/namespaces/ns/deployments/w"] = {
                "metadata": {"name": "w"}, "spec": {"replicas": 2}}
            conn = conn_cls(namespace="ns", deployment_of={"backend": "w"},
                            api_base=server.base, token="tok", verify=False)
            assert conn.get_replicas("backend") == 2
            conn.set_replicas("backend", 4)
            assert conn.get_replicas("backend") == 4
            with pytest.raises(Exception):
                conn.get_replicas("missing")
            kube = kube_cls(api_base=server.base, token=None, verify=False)
            with pytest.raises(Exception) as e:
                kube.replace({"kind": "Deployment", "metadata": {"name": "x"}, "spec": {}})
            assert getattr(e.value, "status", None) == 404
            calls[name] = server.calls
        finally:
            server.close()
    assert normalized(calls["port"]) == normalized(calls["jax"])
    assert issubclass(KubeError, Exception)
