"""The HTTP/1.1 core of the port's two servers: the model server
(``serving/openai_api.py``) and the RAG API (``api/app.py``).

The JAX package serves both on aiohttp, which the card's machine does not
have, so the port speaks HTTP/1.1 itself over ``asyncio`` streams: a
request line, headers and a body of ``Content-Length`` bytes or in
``Transfer-Encoding: chunked`` chunks (extensions and trailers read and
dropped), as aiohttp reads them.  A body of ``MAX_BODY`` bytes or more
gets 413, as aiohttp's default ``client_max_size`` refuses it; any other
transfer coding, or one beside ``Content-Length``, 400.  On ``Expect:
100-continue`` an HTTP/1.1 request gets ``100 Continue`` before its body
is read, and another ``Expect`` value 417, as aiohttp's default expect
handler answers them (for every path, known or not).  Replies with a
body carry ``Content-Length`` and keep the connection alive; streamed
replies (SSE) go out with ``Transfer-Encoding: chunked``.  Routes are
path patterns whose ``{name}`` segments match one path segment each, as
aiohttp's ``{name}`` resources do; an unknown path gets a JSON 404 and a
known path with another method a JSON 405, in the server's own error
shape.  A server runs on the event loop ``listen()`` ran on.

Both servers serve the observability planes' read-only routes with the
handlers below: ``GET /debug/slo``, ``/debug/fleet``, ``/debug/hbm``
(``debug_plane_routes``) and ``/debug/timeline?window_s=``
(``timeline_window``: the server answers a window that is not a number
with 400 in its own error shape).
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from email.utils import formatdate
from http import HTTPStatus
from typing import Awaitable, Callable
from urllib.parse import parse_qs, unquote

logger = logging.getLogger(__name__)

MAX_BODY = 1024 ** 2  # aiohttp's client_max_size default, which the JAX servers run with
_DRAIN_LIMIT = 4 * MAX_BODY  # chunked bytes read (and dropped) before a 413 at most
_MAX_HEADERS = 100


class HTTPError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


@dataclass
class Request:
    method: str
    path: str
    version: str
    headers: dict[str, str]
    body: bytes
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    started: bool = False  # response head written
    status: int | None = None  # the status of the head written
    route: str | None = None  # the matched pattern, None when unmatched
    params: dict[str, str] = field(default_factory=dict)  # its {name} segments
    query: dict[str, str] = field(default_factory=dict)  # ?name=value (the last one)
    extra_headers: list[tuple[str, str]] = field(default_factory=list)  # on every reply

    @property
    def keep_alive(self) -> bool:
        return (self.version == "HTTP/1.1"
                and self.headers.get("connection", "").lower() != "close")

    def json(self):
        return json.loads(self.body.decode("utf-8"))


Handler = Callable[[Request], Awaitable[bool]]


def error_payload(message: str) -> dict:
    """The body of the core's own error replies (404, 405, 500 and refused
    requests) on both servers: the OpenAI error shape."""
    return {"error": {"message": message, "type": "invalid_request_error"}}


async def read_request(reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> Request | None:
    """The next request on the connection, or None at end of stream."""
    try:
        line = await reader.readline()
    except ValueError as exc:  # longer than the reader's limit
        raise HTTPError(400, f"request line too long: {exc}") from exc
    if not line.endswith(b"\n"):
        return None  # closed, between requests or mid-line
    parts = line.decode("latin-1").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HTTPError(400, f"malformed request line {line[:80]!r}")
    method, target, version = parts
    headers: dict[str, str] = {}
    for _ in range(_MAX_HEADERS):
        try:
            raw = await reader.readline()
        except ValueError as exc:
            raise HTTPError(400, f"header line too long: {exc}") from exc
        if raw in (b"\r\n", b"\n"):
            break
        if not raw.endswith(b"\n"):
            return None
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep or not name.strip():
            raise HTTPError(400, f"malformed header line {raw[:80]!r}")
        headers[name.strip().lower()] = value.strip()
    else:
        raise HTTPError(400, f"more than {_MAX_HEADERS} headers")
    coding = headers.get("transfer-encoding")
    if coding is not None:
        if "content-length" in headers:
            raise HTTPError(400, "Content-Length can't be present with Transfer-Encoding")
        if coding.strip().lower() != "chunked":
            raise HTTPError(400, f"unsupported Transfer-Encoding {coding!r}")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError as exc:
        raise HTTPError(400, f"bad Content-Length {headers['content-length']!r}") from exc
    if length < 0:
        raise HTTPError(400, f"bad Content-Length {length}")
    expect = headers.get("expect")
    if expect and version == "HTTP/1.1":
        if expect.lower() != "100-continue":
            raise HTTPError(417, f"Unknown Expect: {expect}")
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if length >= MAX_BODY:
        raise HTTPError(413, f"request body of {length} bytes; the limit is under {MAX_BODY}")
    if coding is not None:
        body = await _read_chunked(reader)
    else:
        body = await reader.readexactly(length) if length else b""
    path, _, query = target.partition("?")
    return Request(method=method, path=unquote(path), version=version,
                   headers=headers, body=body, reader=reader, writer=writer,
                   query={k: v[-1] for k, v in parse_qs(query).items()})


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    """A ``Transfer-Encoding: chunked`` body: hex sizes (chunk extensions
    dropped), each chunk's data and CRLF, a zero size, then trailer lines
    up to an empty one (dropped).  A body that reaches ``MAX_BODY`` gets
    413 once the rest of it is read and dropped (up to ``_DRAIN_LIMIT``
    bytes in all), so that the client reads the reply, not a reset."""
    body = bytearray()
    seen = 0
    while True:
        line = await _body_line(reader)
        size_text = line.split(b";", 1)[0].strip()
        if not size_text or size_text.strip(b"0123456789abcdefABCDEF"):
            raise HTTPError(400, f"invalid chunk size {line[:80]!r}")
        size = int(size_text, 16)
        if size == 0:
            break
        seen += size
        if seen > _DRAIN_LIMIT:
            raise HTTPError(413, f"request body over {_DRAIN_LIMIT} bytes")
        data = await reader.readexactly(size)
        if len(body) < MAX_BODY:
            body += data
        if await reader.readexactly(2) != b"\r\n":
            raise HTTPError(400, "chunk data not followed by CRLF")
    for _ in range(_MAX_HEADERS):
        if await _body_line(reader) == b"":
            break
    else:
        raise HTTPError(400, f"more than {_MAX_HEADERS} trailer lines")
    if len(body) >= MAX_BODY:
        raise HTTPError(413, f"request body of {seen} bytes; the limit is under {MAX_BODY}")
    return bytes(body)


async def _body_line(reader: asyncio.StreamReader) -> bytes:
    """One CRLF-terminated line of a chunked body, without its ending."""
    try:
        line = await reader.readline()
    except ValueError as exc:
        raise HTTPError(400, f"chunk line too long: {exc}") from exc
    if not line.endswith(b"\n"):
        raise asyncio.IncompleteReadError(line, None)
    return line.rstrip(b"\r\n")


def head(status: int, headers: list[tuple[str, str]]) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}",
             f"Date: {formatdate(usegmt=True)}", "Server: githubrepostorag-tpu-torch"]
    lines += [f"{k}: {v}" for k, v in headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def respond(req: Request, status: int, body: bytes, content_type: str,
                  headers: tuple[tuple[str, str], ...] = (), keep_alive: bool | None = None
                  ) -> bool:
    """Write a whole reply; returns whether the connection stays open."""
    keep_alive = req.keep_alive if keep_alive is None else keep_alive
    all_headers = [("Content-Type", content_type), ("Content-Length", str(len(body))),
                   *headers, *req.extra_headers]
    if not keep_alive:
        all_headers.append(("Connection", "close"))
    req.started, req.status = True, status
    req.writer.write(head(status, all_headers) + body)
    await req.writer.drain()
    return keep_alive


async def write_json(req: Request, status: int, payload, headers: tuple = (),
                     keep_alive: bool | None = None) -> bool:
    return await respond(req, status, json.dumps(payload).encode("utf-8"),
                         "application/json; charset=utf-8", headers, keep_alive)


async def start_stream(req: Request, status: int, headers: list[tuple[str, str]]) -> None:
    """Write the head of a chunked reply; ``write_chunk`` and
    ``end_stream`` send its body."""
    req.started, req.status = True, status
    req.writer.write(head(status, [*headers, *req.extra_headers,
                                   ("Transfer-Encoding", "chunked")]))
    await req.writer.drain()


async def write_chunk(req: Request, data: bytes) -> None:
    req.writer.write(b"%x\r\n%s\r\n" % (len(data), data))
    await req.writer.drain()


async def end_stream(req: Request) -> None:
    req.writer.write(b"0\r\n\r\n")
    await req.writer.drain()


class HTTPServer:
    """Routing and connection handling shared by the port's servers.
    Subclasses fill ``routes`` (pattern -> {method: handler}) and may wrap
    every handler, matched or not, in ``handle``."""

    def __init__(self) -> None:
        self.routes: dict[str, dict[str, Handler]] = {}
        self._server: asyncio.base_events.Server | None = None
        self._connections: set[asyncio.Task] = set()

    def error_payload(self, message: str) -> dict:
        return error_payload(message)

    async def handle(self, req: Request, handler: Handler) -> bool:
        return await handler(req)

    async def listen(self, host: str, port: int) -> int:
        """Serve on the running loop; returns the bound port (pass port=0
        for an ephemeral one)."""
        self._server = await asyncio.start_server(self._connection, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        """Stop listening and end every open connection (a stream in
        flight sees its task cancelled)."""
        # capture-and-clear before awaiting: two concurrent close() calls
        # must not both close the server
        server, self._server = self._server, None
        if server is not None:
            server.close()
            tasks = list(self._connections)
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await server.wait_closed()

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """Serve requests on one connection until it closes or a reply
        ends it."""
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            keep_alive = True
            while keep_alive:
                try:
                    req = await read_request(reader, writer)
                except HTTPError as exc:  # the rest of the request is unread: close after
                    body = json.dumps(self.error_payload(str(exc))).encode("utf-8")
                    writer.write(head(exc.status, [
                        ("Content-Type", "application/json; charset=utf-8"),
                        ("Content-Length", str(len(body))), ("Connection", "close")]) + body)
                    await writer.drain()
                    return
                if req is None:
                    return
                keep_alive = await self._dispatch(req)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            self._connections.discard(task)
            writer.close()

    def resolve(self, path: str) -> tuple[str | None, dict[str, str], dict[str, Handler] | None]:
        """(pattern, path parameters, methods) of the route matching
        ``path``; (None, {}, None) when none does."""
        if path in self.routes:
            return path, {}, self.routes[path]
        parts = path.split("/")
        for pattern, methods in self.routes.items():
            pat = pattern.split("/")
            if len(pat) != len(parts) or "{" not in pattern:
                continue
            params = {}
            for want, got in zip(pat, parts):
                if want.startswith("{") and want.endswith("}"):
                    if not got:
                        break
                    params[want[1:-1]] = got
                elif want != got:
                    break
            else:
                return pattern, params, methods
        return None, {}, None

    async def _dispatch(self, req: Request) -> bool:
        """Route one request; returns whether the connection stays open."""
        req.route, req.params, methods = self.resolve(req.path)
        if methods is None:
            async def handler(req: Request) -> bool:
                return await write_json(req, 404, self.error_payload(f"no route {req.path}"))
        else:
            handler = methods.get(req.method)
            if handler is None:
                async def handler(req: Request) -> bool:
                    return await write_json(
                        req, 405,
                        self.error_payload(f"method {req.method} not allowed on {req.path}"),
                        (("Allow", ", ".join(methods)),))
        try:
            return await self.handle(req, handler)
        except (ConnectionError, asyncio.IncompleteReadError):
            raise
        except Exception as exc:  # noqa: BLE001 - a failed request must not end the server
            logger.exception("%s %s failed", req.method, req.path)
            if not req.started:
                await write_json(req, 500, self.error_payload(f"internal error: {exc!r}"),
                                 keep_alive=False)
            return False


# --------------------------------------------------- observability routes --


async def debug_slo(req: Request) -> bool:
    from githubrepostorag_tpu_torch.obs.slo import get_slo_plane

    return await write_json(req, 200, get_slo_plane().slo_payload())


async def debug_fleet(req: Request) -> bool:
    from githubrepostorag_tpu_torch.obs.slo import get_slo_plane

    return await write_json(req, 200, get_slo_plane().fleet_payload())


async def debug_hbm(req: Request) -> bool:
    from githubrepostorag_tpu_torch.obs.hbm import get_hbm_plane

    return await write_json(req, 200, get_hbm_plane().payload())


def debug_plane_routes() -> dict[str, dict[str, Handler]]:
    return {"/debug/slo": {"GET": debug_slo}, "/debug/fleet": {"GET": debug_fleet},
            "/debug/hbm": {"GET": debug_hbm}}


def timeline_window(req: Request) -> float | None:
    """``?window_s=`` of a timeline request (None when absent); raises
    ValueError when it is not a number."""
    raw = req.query.get("window_s")
    return None if raw is None else float(raw)
