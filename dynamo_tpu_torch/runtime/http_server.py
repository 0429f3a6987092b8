"""HTTP/1.1 server on asyncio streams, and the per-process system status
server (/health /live /metrics) built on it.

The JAX package serves HTTP with aiohttp, which the machines this port
targets do not carry. This module gives ``llm/http_service.py`` and the
system server the part of aiohttp's ``web`` surface they use, so both
read here as they do there (``from ... import http_server as web``):

- ``Application`` with ``router.add_get`` / ``add_post`` and ``{name}``
  path parameters;
- ``Request``: ``method``, ``path``, ``headers`` (case-insensitive),
  ``query``, ``match_info``, ``await read() / text() / json()``;
- ``Response``, ``json_response``, and ``StreamResponse`` with
  ``prepare``, ``write``, ``write_eof``, ``status`` and ``headers``;
- ``AppRunner``, ``TCPSite`` (port 0 resolved through ``site._server``,
  ``reuse_port``) and ``SockSite``.

Protocol: HTTP/1.1 keep-alive, request bodies by ``Content-Length``
(with ``Expect: 100-continue``, which curl sends for bodies over 1 KiB;
a chunked request body is refused with 501); a response whose
length is not known up front (``StreamResponse``) goes out with chunked
transfer encoding, as aiohttp sends it. Once a client has disconnected,
``StreamResponse.write`` raises ``ConnectionResetError``: the transport
sees the peer's reset at the first or second write after it left, so a
streaming handler learns of it then and can cancel the work behind the
stream. A client that has only half-closed (shut down its write side
after sending the request) is still answered. Handlers are not cancelled
on disconnect (aiohttp's default).

The system server is enabled with ``DYNTPU_SYSTEM_ENABLED=1`` (port via
``DYNTPU_SYSTEM_PORT``): workers and frontends alike expose liveness and
readiness probes and their metrics registry without a store round-trip.
"""

from __future__ import annotations

import asyncio
import contextlib
import http
import json
import re
import socket
from typing import Any, Awaitable, Callable
from urllib.parse import parse_qsl, unquote, urlsplit

from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("system_http")
http_log = get_logger("http_server")

MAX_LINE = 64 * 1024            # request line or one header line
MAX_HEADERS = 128
MAX_BODY = 64 * 1024 * 1024
KEEPALIVE_TIMEOUT = 75.0        # idle keep-alive connection lifetime (aiohttp's default)

Handler = Callable[["Request"], Awaitable["StreamResponse"]]


class HTTPError(Exception):
    """A request the server refuses before any handler runs."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Headers:
    """Case-insensitive header mapping (first value wins on lookup, all
    values kept in order)."""

    __slots__ = ("_items", "_index")

    def __init__(self, items=()):
        self._items: list[tuple[str, str]] = []
        self._index: dict[str, str] = {}
        pairs = items.items() if isinstance(items, dict) else items
        for k, v in pairs:
            self.add(k, v)

    def add(self, name: str, value: str) -> None:
        self._items.append((name, value))
        self._index.setdefault(name.lower(), value)

    def get(self, name: str, default=None):
        return self._index.get(name.lower(), default)

    def __getitem__(self, name: str) -> str:
        return self._index[name.lower()]

    def __contains__(self, name: object) -> bool:
        return isinstance(name, str) and name.lower() in self._index

    def __setitem__(self, name: str, value: str) -> None:
        low = name.lower()
        self._items = [(k, v) for k, v in self._items if k.lower() != low]
        self._items.append((name, value))
        self._index[low] = value

    def items(self):
        return list(self._items)

    def __len__(self) -> int:
        return len(self._items)


class Request:
    def __init__(self, method: str, target: str, version: str, headers: Headers,
                 body: bytes, match_info: dict[str, str] | None = None):
        self.method = method
        self.version = version
        self.headers = headers
        parts = urlsplit(target)
        self.raw_path = target
        self.path = unquote(parts.path)
        self.query_string = parts.query
        query: dict[str, str] = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            query.setdefault(k, v)
        self.query = query
        self.match_info: dict[str, str] = match_info or {}
        self._body = body
        self._conn: _Connection | None = None

    @property
    def keep_alive(self) -> bool:
        conn = (self.headers.get("Connection") or "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    async def read(self) -> bytes:
        return self._body

    async def text(self) -> str:
        charset = "utf-8"
        ctype = self.headers.get("Content-Type") or ""
        m = re.search(r"charset=([\w.-]+)", ctype, re.I)
        if m:
            charset = m.group(1)
        return self._body.decode(charset)

    async def json(self, loads=json.loads) -> Any:
        return loads(await self.text())


def _reason(status: int) -> str:
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


class StreamResponse:
    """A response whose body is written piece by piece after ``prepare``;
    on HTTP/1.1 each ``write`` is one chunk of a chunked body."""

    def __init__(self, status: int = 200, headers=None, reason: str | None = None):
        self.status = status
        self.reason = reason or _reason(status)
        self.headers = Headers(headers or {})
        self._conn: _Connection | None = None
        self._chunked = False
        self._eof = False

    @property
    def prepared(self) -> bool:
        return self._conn is not None

    def _head(self, conn: "_Connection", extra: list[tuple[str, str]]) -> bytes:
        lines = [f"HTTP/1.1 {self.status} {self.reason}"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        lines += [f"{k}: {v}" for k, v in extra]
        if not conn.keep_alive:
            lines.append("Connection: close")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def prepare(self, request: Request) -> "StreamResponse":
        if self._conn is not None:
            return self
        conn = request._conn
        if conn is None:
            raise RuntimeError("request is not bound to a connection")
        self._conn = conn
        extra = []
        if request.version == "HTTP/1.1":
            self._chunked = True
            extra.append(("Transfer-Encoding", "chunked"))
        else:
            conn.keep_alive = False  # the end of the body is the end of the connection
        conn.responded = True
        await conn.send(self._head(conn, extra))
        return self

    async def write(self, data: bytes) -> None:
        if self._conn is None:
            raise RuntimeError("StreamResponse.write before prepare")
        if self._eof:
            raise RuntimeError("StreamResponse.write after write_eof")
        if not data:
            return
        if self._chunked:
            data = b"%x\r\n%s\r\n" % (len(data), bytes(data))
        await self._conn.send(data)

    async def write_eof(self) -> None:
        if self._eof:
            return
        self._eof = True
        if self._chunked and self._conn is not None:
            await self._conn.send(b"0\r\n\r\n")


class Response(StreamResponse):
    """A response with its whole body known up front (Content-Length)."""

    def __init__(self, body: bytes | None = None, status: int = 200, text: str | None = None,
                 content_type: str | None = None, headers=None, reason: str | None = None,
                 charset: str | None = None):
        super().__init__(status=status, headers=headers, reason=reason)
        if text is not None:
            if body is not None:
                raise ValueError("body and text are not allowed together")
            charset = charset or "utf-8"
            body = text.encode(charset)
            if "Content-Type" not in self.headers:
                self.headers["Content-Type"] = f"{content_type or 'text/plain'}; charset={charset}"
        elif content_type is not None:
            self.headers["Content-Type"] = content_type
        elif body is not None and "Content-Type" not in self.headers:
            self.headers["Content-Type"] = "application/octet-stream"
        self.body = body or b""

    async def prepare(self, request: Request) -> "Response":
        if self._conn is not None:
            return self
        conn = request._conn
        if conn is None:
            raise RuntimeError("request is not bound to a connection")
        self._conn = conn
        conn.responded = True
        await conn.send(self._head(conn, [("Content-Length", str(len(self.body)))]) + self.body)
        self._eof = True
        return self

    async def write(self, data: bytes) -> None:
        raise RuntimeError("Response has a fixed body; use StreamResponse to stream")


def json_response(data: Any = None, *, status: int = 200, headers=None,
                  dumps=json.dumps, content_type: str = "application/json") -> Response:
    return Response(text=dumps(data), status=status, headers=headers, content_type=content_type)


# -- routing ------------------------------------------------------------------

_PARAM = re.compile(r"\{([A-Za-z_][A-Za-z0-9_]*)\}")


class _Route:
    __slots__ = ("method", "path", "regex", "handler")

    def __init__(self, method: str, path: str, handler: Handler):
        self.method = method
        self.path = path
        pattern, pos = "", 0
        for m in _PARAM.finditer(path):
            pattern += re.escape(path[pos:m.start()]) + f"(?P<{m.group(1)}>[^{{}}/]+)"
            pos = m.end()
        pattern += re.escape(path[pos:])
        self.regex = re.compile(f"^{pattern}$")
        self.handler = handler


class Router:
    def __init__(self):
        self.routes: list[_Route] = []

    def add_route(self, method: str, path: str, handler: Handler) -> _Route:
        route = _Route(method.upper(), path, handler)
        self.routes.append(route)
        return route

    def add_get(self, path: str, handler: Handler) -> _Route:
        return self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> _Route:
        return self.add_route("POST", path, handler)

    def resolve(self, method: str, path: str) -> tuple[Handler, dict[str, str]]:
        allowed = False
        for r in self.routes:
            m = r.regex.match(path)
            if m is None:
                continue
            if r.method == method:
                return r.handler, m.groupdict()
            allowed = True
        raise HTTPError(405 if allowed else 404, "Method Not Allowed" if allowed else "Not Found")


class Application:
    def __init__(self):
        self.router = Router()


# -- connections ----------------------------------------------------------------


class _Connection:
    """One client connection: reads requests, runs handlers one at a time
    (HTTP/1.1 keep-alive) and writes their responses."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.keep_alive = True
        self.responded = False  # the current request's response head is sent

    def gone(self) -> bool:
        """The transport is closing or lost: a write failed (the peer reset
        the connection) or the server closed it. A client that only shut
        down its write side (read EOF) is still there and gets its response."""
        return self.writer.is_closing()

    async def send(self, data: bytes) -> None:
        if self.gone():
            raise ConnectionResetError("Cannot write to closing transport")
        self.writer.write(data)
        await self.writer.drain()

    async def read_request(self) -> Request | None:
        line = b""
        while line in (b"", b"\r\n", b"\n"):  # tolerate blank lines between requests
            line = await self._readline()
            if not line:
                return None
        try:
            method, target, version = line.decode("latin-1").rstrip("\r\n").split(" ")
        except ValueError:
            raise HTTPError(400, "Bad request line") from None
        if version not in ("HTTP/1.1", "HTTP/1.0"):
            raise HTTPError(505, "HTTP Version Not Supported")
        headers = Headers()
        while True:
            h = await self._readline()
            if h in (b"\r\n", b"\n"):
                break
            if not h:
                raise HTTPError(400, "Incomplete headers")
            if len(headers) >= MAX_HEADERS:
                raise HTTPError(431, "Too many headers")
            name, sep, value = h.decode("latin-1").partition(":")
            if not sep or not name or name != name.strip():
                raise HTTPError(400, "Bad header line")
            headers.add(name, value.strip())
        req = Request(method.upper(), target, version, headers, b"")
        self.keep_alive = req.keep_alive
        req._body = await self._read_body(req)
        req._conn = self
        return req

    async def _readline(self) -> bytes:
        try:
            line = await self.reader.readuntil(b"\n")
        except asyncio.IncompleteReadError as e:
            return e.partial
        except asyncio.LimitOverrunError:
            raise HTTPError(431, "Line too long") from None
        if len(line) > MAX_LINE:
            raise HTTPError(431, "Line too long")
        return line

    async def _read_body(self, req: Request) -> bytes:
        if req.headers.get("Transfer-Encoding"):
            raise HTTPError(501, "chunked request bodies are not supported")
        length = req.headers.get("Content-Length")
        if length is None:
            return b""
        try:
            n = int(length)
        except ValueError:
            raise HTTPError(400, "Bad Content-Length") from None
        if n < 0:
            raise HTTPError(400, "Bad Content-Length")
        if n > MAX_BODY:
            raise HTTPError(413, "Request body too large")
        if (req.headers.get("Expect") or "").lower() == "100-continue":
            await self.send(b"HTTP/1.1 100 Continue\r\n\r\n")
        return await self.reader.readexactly(n)


class AppRunner:
    """Owns the listening sites and every open connection of one app."""

    def __init__(self, app: Application, access_log=None):
        self.app = app
        self.sites: list[BaseSite] = []
        self._conns: set[asyncio.Task] = set()

    async def setup(self) -> None:
        return None

    async def cleanup(self) -> None:
        """Stop every site, then close every connection: idle keep-alive
        connections and any handler still running (callers drain first)."""
        for site in list(self.sites):
            await site.stop()
        tasks = list(self._conns)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = _Connection(reader, writer)
        task = asyncio.current_task()
        self._conns.add(task)
        sock = writer.get_extra_info("socket")
        if sock is not None and sock.family in (socket.AF_INET, socket.AF_INET6):
            with contextlib.suppress(OSError):
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while conn.keep_alive:
                try:
                    async with asyncio.timeout(KEEPALIVE_TIMEOUT):
                        req = await conn.read_request()
                except HTTPError as e:
                    conn.keep_alive = False
                    with contextlib.suppress(ConnectionError):
                        await conn.send(_error_bytes(e.status, str(e)))
                    break
                except TimeoutError:
                    break
                if req is None:
                    break
                conn.responded = False
                await self._dispatch(conn, req)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    async def _dispatch(self, conn: _Connection, req: Request) -> None:
        try:
            handler, req.match_info = self.app.router.resolve(req.method, req.path)
        except HTTPError as e:
            await conn.send(_error_bytes(e.status, str(e), conn.keep_alive))
            return
        try:
            resp = await handler(req)
        except (ConnectionError, asyncio.CancelledError):
            conn.keep_alive = False
            raise
        except Exception:  # noqa: BLE001 — HTTP boundary: a failing handler answers 500
            http_log.exception("error handling %s %s", req.method, req.path)
            conn.keep_alive = False
            if not conn.responded:  # else the head is out: closing ends the response
                with contextlib.suppress(ConnectionError):
                    await conn.send(_error_bytes(500, "Internal Server Error"))
            return
        if not isinstance(resp, StreamResponse):
            http_log.error("handler for %s %s returned %r", req.method, req.path, type(resp))
            conn.keep_alive = False
            await conn.send(_error_bytes(500, "Internal Server Error"))
            return
        if not resp.prepared:
            await resp.prepare(req)
        await resp.write_eof()


def _error_bytes(status: int, message: str, keep_alive: bool = False) -> bytes:
    body = f"{status}: {message}".encode()
    head = [f"HTTP/1.1 {status} {_reason(status)}", "Content-Type: text/plain; charset=utf-8",
            f"Content-Length: {len(body)}"]
    if not keep_alive:
        head.append("Connection: close")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


class BaseSite:
    def __init__(self, runner: AppRunner):
        self._runner = runner
        self._server: asyncio.AbstractServer | None = None

    async def _start_server(self) -> asyncio.AbstractServer:
        raise NotImplementedError

    async def start(self) -> None:
        self._server = await self._start_server()
        self._runner.sites.append(self)

    async def stop(self) -> None:
        """Stop accepting; connections already open keep being served."""
        if self._server is not None:
            self._server.close()
            self._server = None
        if self in self._runner.sites:
            self._runner.sites.remove(self)


class TCPSite(BaseSite):
    def __init__(self, runner: AppRunner, host: str | None = None, port: int | None = None,
                 reuse_port: bool | None = None, backlog: int = 128):
        super().__init__(runner)
        self.host = host or "0.0.0.0"
        self.port = 8080 if port is None else port
        self.reuse_port = reuse_port
        self.backlog = backlog

    async def _start_server(self) -> asyncio.AbstractServer:
        return await asyncio.start_server(
            self._runner._serve, self.host, self.port, reuse_port=self.reuse_port,
            reuse_address=True, backlog=self.backlog, limit=MAX_LINE,
        )


class SockSite(BaseSite):
    def __init__(self, runner: AppRunner, sock: socket.socket, backlog: int = 128):
        super().__init__(runner)
        self.sock = sock
        self.backlog = backlog

    async def _start_server(self) -> asyncio.AbstractServer:
        return await asyncio.start_server(self._runner._serve, sock=self.sock,
                                          backlog=self.backlog, limit=MAX_LINE)


# -- system status server --------------------------------------------------------


class SystemHttpServer:
    def __init__(self, runtime, host: str = "0.0.0.0", port: int = 9090):
        self.runtime = runtime
        self.host = host
        self.port = port
        self._runner: AppRunner | None = None

    async def start(self) -> "SystemHttpServer":
        app = Application()
        app.router.add_get("/health", self._health)
        app.router.add_get("/live", self._live)
        app.router.add_get("/metrics", self._metrics)
        self._runner = AppRunner(app, access_log=None)
        await self._runner.setup()
        site = TCPSite(self._runner, self.host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]  # resolve port 0
        log.info("system server on %s:%d", self.host, self.port)
        return self

    async def close(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    async def _health(self, request: Request) -> Response:
        h = self.runtime.health
        body = {
            "status": "ready" if h.ready else "notready",
            "live": h.live,
            "endpoints": dict(h.endpoint_health),
        }
        return json_response(body, status=200 if h.ready else 503)

    async def _live(self, request: Request) -> Response:
        live = self.runtime.health.live
        return json_response({"live": live}, status=200 if live else 503)

    async def _metrics(self, request: Request) -> Response:
        return Response(text=self.runtime.metrics.render(), content_type="text/plain")
