"""Namespace → Component → Endpoint addressing and instance registry.

Reference analogue: the component model with etcd instance keys
``instances/<ns>/<comp>/<ep>:<lease_hex>`` and name validation
(reference: lib/runtime/src/component.rs:94-136,416-422,521-530).

An *instance* is one live serving of an endpoint by one process: identified
by (namespace, component, endpoint, lease_id) and carrying the TCP address
of that process's :class:`~dynamo_tpu_torch.runtime.messaging.EndpointServer`.
Liveness == lease liveness: if the process dies, keepalives stop, the lease
expires, and the store deletes the instance key, which every discovery
client observes via its prefix watch.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from dynamo_tpu_torch.runtime import msgpack_lite as msgpack

INSTANCE_ROOT = "instances"

_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9-_]*$")


def validate_name(name: str, what: str = "name") -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"invalid {what} {name!r}: must be lowercase alphanumeric with '-'/'_', "
            "starting with an alphanumeric"
        )
    return name


def endpoint_subject(namespace: str, component: str, endpoint: str) -> str:
    return f"{namespace}/{component}/{endpoint}"


def instance_prefix(namespace: str, component: str | None = None, endpoint: str | None = None) -> str:
    parts = [INSTANCE_ROOT, namespace]
    if component is not None:
        parts.append(component)
    prefix = "/".join(parts) + "/"
    if endpoint is not None:
        prefix += f"{endpoint}:"
    return prefix


def instance_key(namespace: str, component: str, endpoint: str, lease_id: int) -> str:
    return f"{INSTANCE_ROOT}/{namespace}/{component}/{endpoint}:{lease_id:x}"


@dataclass(frozen=True)
class Instance:
    """A live endpoint instance (reference: component.rs:94-107)."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int  # == lease id, unique per registration
    host: str
    port: int

    @property
    def subject(self) -> str:
        return endpoint_subject(self.namespace, self.component, self.endpoint)

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    def to_bytes(self) -> bytes:
        return msgpack.packb(
            {
                "namespace": self.namespace,
                "component": self.component,
                "endpoint": self.endpoint,
                "instance_id": self.instance_id,
                "host": self.host,
                "port": self.port,
            },
            use_bin_type=True,
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Instance":
        d = msgpack.unpackb(raw, raw=False)
        return cls(
            namespace=d["namespace"],
            component=d["component"],
            endpoint=d["endpoint"],
            instance_id=d["instance_id"],
            host=d["host"],
            port=d["port"],
        )
