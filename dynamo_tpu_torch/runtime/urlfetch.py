"""One HTTP(S) request through the standard library.

The JAX package's planner and operator talk to the frontend's /metrics,
the Kubernetes API server and the fleet supervisor through ``httpx``,
which the card's machine does not carry. This is the small part of it
they use: one blocking request with a timeout, TLS verification on,
off, or against a CA file, and the status and body handed back as they
came, 4xx/5xx included (``urllib`` raises on those; the callers decide
what an error status means, as they do with ``httpx``).
"""

from __future__ import annotations

import ssl
import urllib.error
import urllib.request


class HttpStatusError(Exception):
    """A 4xx/5xx answer, raised by :meth:`Reply.raise_for_status`."""

    def __init__(self, status: int, url: str, body: bytes):
        super().__init__(f"HTTP {status} from {url}: {body[:200]!r}")
        self.status = status


class Reply:
    def __init__(self, status: int, body: bytes, url: str):
        self.status_code = status
        self.content = body
        self.url = url

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        import json

        return json.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HttpStatusError(self.status_code, self.url, self.content)


def _ssl_context(verify: bool | str) -> ssl.SSLContext | None:
    if verify is True:
        return None  # urllib's default: verify against the system store
    if verify is False:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    return ssl.create_default_context(cafile=verify)


def request(method: str, url: str, *, body: bytes | None = None,
            headers: dict | None = None, timeout: float = 10.0,
            verify: bool | str = True) -> Reply:
    """→ the reply, whatever its status. Connection errors raise."""
    req = urllib.request.Request(url, data=body, method=method, headers=dict(headers or {}))
    ctx = _ssl_context(verify) if url.startswith("https:") else None
    try:
        with urllib.request.urlopen(req, timeout=timeout, context=ctx) as r:
            return Reply(r.status, r.read(), url)
    except urllib.error.HTTPError as e:
        return Reply(e.code, e.read() or b"", url)
