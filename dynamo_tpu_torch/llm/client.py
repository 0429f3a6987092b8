"""Typed OpenAI-compatible HTTP client with retry, on asyncio streams.

Reference analogue: lib/llm/src/http/client.rs:679 — the typed client the
reference's tests and benches drive the frontend with. Retries are for
transient transport errors and 429/5xx, with exponential backoff; 4xx
client errors surface immediately.

The JAX package's client rides httpx, which the machines this port
targets do not carry. This one speaks HTTP/1.1 itself: one connection
per request (``Connection: close``), JSON request bodies by
``Content-Length``, response bodies by ``Content-Length``, chunked
transfer encoding or the end of the connection, and ``timeout`` bounding
the connect and every read, as httpx's per-operation timeouts do.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Any, AsyncIterator
from urllib.parse import urlsplit

_RETRYABLE = {429, 500, 502, 503, 504}
_MAX_LINE = 64 * 1024


class OpenAIClientError(Exception):
    def __init__(self, status: int, body: Any):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


class HttpProtocolError(OSError):
    """The server's response broke HTTP/1.1 framing (a transport error:
    retried like a reset connection)."""


# What a request may raise below the HTTP layer: refused or reset
# connections and timeouts (both OSError), a peer that closed mid-body.
_TRANSPORT_ERRORS = (OSError, asyncio.IncompleteReadError, asyncio.LimitOverrunError)


@dataclass
class HttpResponse:
    status: int
    headers: dict[str, str]
    body: bytes

    def json(self) -> Any:
        return json.loads(self.body)

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")


class _Stream:
    """One open response: status and headers read, the body still on the
    connection (``chunks()`` yields it as it arrives)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 status: int, headers: dict[str, str], timeout: float):
        self.reader = reader
        self.writer = writer
        self.status = status
        self.headers = headers
        self.timeout = timeout

    async def _read(self, coro):
        return await asyncio.wait_for(coro, self.timeout)

    async def chunks(self) -> AsyncIterator[bytes]:
        if self.headers.get("transfer-encoding", "").lower() == "chunked":
            while True:
                line = await self._read(self.reader.readuntil(b"\r\n"))
                try:
                    size = int(line.split(b";", 1)[0].strip(), 16)
                except ValueError:
                    raise HttpProtocolError(f"bad chunk size line {line[:40]!r}") from None
                if size == 0:
                    # Trailers (none expected) end with an empty line.
                    while (await self._read(self.reader.readuntil(b"\r\n"))) != b"\r\n":
                        pass
                    return
                data = await self._read(self.reader.readexactly(size + 2))
                if data[-2:] != b"\r\n":
                    raise HttpProtocolError("chunk not terminated by CRLF")
                yield data[:-2]
        elif "content-length" in self.headers:
            try:
                left = int(self.headers["content-length"])
            except ValueError:
                raise HttpProtocolError("bad Content-Length") from None
            while left > 0:
                data = await self._read(self.reader.read(min(left, 1 << 16)))
                if not data:
                    raise asyncio.IncompleteReadError(b"", left)
                left -= len(data)
                yield data
        else:
            while True:
                data = await self._read(self.reader.read(1 << 16))
                if not data:
                    return
                yield data

    async def read(self) -> bytes:
        return b"".join([c async for c in self.chunks()])

    async def close(self) -> None:
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except OSError:
            pass


@dataclass
class OpenAIClient:
    base_url: str
    timeout: float = 60.0
    max_retries: int = 3
    backoff_s: float = 0.25
    default_model: str | None = None
    # Sent with every request (e.g. a W3C ``traceparent`` that names the
    # trace the frontend records the request under).
    headers: dict[str, str] | None = None
    _entered: bool = field(default=False, repr=False)

    def __post_init__(self) -> None:
        u = urlsplit(self.base_url)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(f"base_url must be http://host[:port][/prefix], got {self.base_url!r}")
        self._host = u.hostname
        self._port = u.port or 80
        self._prefix = u.path.rstrip("/")
        self._host_header = u.netloc

    async def __aenter__(self) -> "OpenAIClient":
        self._entered = True
        return self

    async def __aexit__(self, *exc) -> None:
        self._entered = False

    def _check_entered(self) -> None:
        if not self._entered:
            raise ValueError("use 'async with OpenAIClient(...)'")

    async def _open(self, method: str, path: str, body: dict | None) -> _Stream:
        """Send one request; → the response with its body unread."""
        self._check_entered()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self._host, self._port, limit=_MAX_LINE), self.timeout)
        try:
            head = [f"{method} {self._prefix}{path} HTTP/1.1", f"Host: {self._host_header}",
                    "Accept: */*", "Connection: close"]
            head += [f"{k}: {v}" for k, v in (self.headers or {}).items()]
            payload = b""
            if body is not None:
                payload = json.dumps(body, ensure_ascii=False, separators=(",", ":"),
                                     allow_nan=False).encode()
                head += ["Content-Type: application/json", f"Content-Length: {len(payload)}"]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + payload)
            await asyncio.wait_for(writer.drain(), self.timeout)
            line = await asyncio.wait_for(reader.readuntil(b"\r\n"), self.timeout)
            parts = line.decode("latin-1").split(None, 2)
            if len(parts) < 2 or not parts[0].startswith("HTTP/1.") or not parts[1].isdigit():
                raise HttpProtocolError(f"bad status line {line[:80]!r}")
            status = int(parts[1])
            headers: dict[str, str] = {}
            while True:
                line = await asyncio.wait_for(reader.readuntil(b"\r\n"), self.timeout)
                if line == b"\r\n":
                    break
                name, sep, value = line.decode("latin-1").partition(":")
                if not sep:
                    raise HttpProtocolError(f"bad header line {line[:80]!r}")
                headers[name.strip().lower()] = value.strip()
        except BaseException:
            writer.close()
            raise
        return _Stream(reader, writer, status, headers, self.timeout)

    async def request(self, method: str, path: str, body: dict | None = None) -> HttpResponse:
        """One request, its whole response read (no retry)."""
        stream = await self._open(method, path, body)
        try:
            return HttpResponse(stream.status, stream.headers, await stream.read())
        finally:
            await stream.close()

    async def get(self, path: str) -> HttpResponse:
        return await self.request("GET", path)

    async def _post_json(self, path: str, body: dict) -> dict:
        last: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                r = await self.request("POST", path, body)
            except _TRANSPORT_ERRORS as e:
                last = e
            else:
                if r.status < 400:
                    return r.json()
                payload = _safe_json(r)
                if r.status not in _RETRYABLE:
                    raise OpenAIClientError(r.status, payload)
                last = OpenAIClientError(r.status, payload)
            if attempt < self.max_retries:
                await asyncio.sleep(self.backoff_s * (2 ** attempt))
        assert last is not None
        raise last

    # -- typed surfaces ----------------------------------------------------

    async def chat(self, messages: list[dict], model: str | None = None, **kw) -> dict:
        body = {"model": model or self.default_model, "messages": messages, **kw}
        return await self._post_json("/v1/chat/completions", body)

    async def completion(self, prompt, model: str | None = None, **kw) -> dict:
        body = {"model": model or self.default_model, "prompt": prompt, **kw}
        return await self._post_json("/v1/completions", body)

    async def responses(self, input: Any, model: str | None = None, **kw) -> dict:
        """POST /v1/responses (unary). `input`: string or message list."""
        body = {"model": model or self.default_model, "input": input, **kw}
        return await self._post_json("/v1/responses", body)

    async def embeddings(self, input: Any, model: str | None = None) -> dict:
        body = {"model": model or self.default_model, "input": input}
        return await self._post_json("/v1/embeddings", body)

    async def clear_kv_blocks(self) -> dict:
        return await self._post_json("/clear_kv_blocks", {})

    async def models(self) -> list[str]:
        r = await self.get("/v1/models")
        if r.status >= 400:
            raise OpenAIClientError(r.status, _safe_json(r))
        return [m["id"] for m in r.json().get("data", [])]

    async def health(self) -> dict:
        r = await self.get("/health")
        return r.json()

    async def chat_stream(
        self, messages: list[dict], model: str | None = None, **kw
    ) -> AsyncIterator[dict]:
        """Stream chat chunks (retry applies to connection setup only —
        a broken mid-flight stream is surfaced, not replayed)."""
        body = {"model": model or self.default_model, "messages": messages,
                "stream": True, **kw}
        last: Exception | None = None
        for attempt in range(self.max_retries + 1):
            yielded = False
            try:
                r = await self._open("POST", "/v1/chat/completions", body)
                try:
                    if r.status >= 400:
                        payload = _safe_json_bytes(await r.read())
                        raise OpenAIClientError(r.status, payload)

                    buf = b""
                    async for raw in r.chunks():
                        buf += raw
                        while b"\n\n" in buf:
                            event, buf = buf.split(b"\n\n", 1)
                            for line in event.split(b"\n"):
                                if not line.startswith(b"data:"):
                                    continue
                                data = line.split(b":", 1)[1].strip().decode()
                                if data == "[DONE]":
                                    return
                                yielded = True
                                yield json.loads(data)
                    return
                finally:
                    await r.close()
            except OpenAIClientError as e:
                if yielded or e.status not in _RETRYABLE:
                    raise  # never replay a stream the caller already consumed
                last = e
            except _TRANSPORT_ERRORS as e:
                if yielded:
                    raise
                last = e
            if attempt < self.max_retries:
                await asyncio.sleep(self.backoff_s * (2 ** attempt))
        assert last is not None
        raise last


def _safe_json(r: HttpResponse) -> Any:
    try:
        return r.json()
    except Exception:  # noqa: BLE001 — diagnostic helper: a non-JSON error body is data, not a failure
        return r.text


def _safe_json_bytes(b: bytes) -> Any:
    try:
        return json.loads(b)
    except Exception:  # noqa: BLE001 — diagnostic helper: an unparseable SSE payload is surfaced as text
        return b[:500].decode(errors="replace")
