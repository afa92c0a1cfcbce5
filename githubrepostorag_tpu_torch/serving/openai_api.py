"""OpenAI-compatible HTTP front end over the AsyncEngine; port of
``githubrepostorag_tpu/serving/openai_api.py`` on the standard library.

Endpoints: POST /v1/chat/completions (stream and non-stream),
POST /v1/completions, GET /v1/models, GET /health, and GET /debug/index
(the live index's watermarks and compaction, ``live_index_payload``).
Request handling --
sampling defaults, stop strings (cut inside a streamed delta too), finish
reasons, the 400 for malformed bodies and for ``finish_reason == "error"``,
cancellation on a stop string, a client that goes away, or a cancelled
task -- follows the JAX server line for line.  The JAX server's other
/debug/* routes read planes the port does not have yet and are not served.

The JAX server runs on aiohttp, which the card's machine does not have, so
this one speaks HTTP/1.1 itself over ``asyncio`` streams: a request line,
headers and a ``Content-Length`` body (a chunked request body gets 411, a
body of ``MAX_BODY`` bytes or more 413, as aiohttp's default
``client_max_size`` refuses it); JSON replies carry ``Content-Length`` and
keep the connection alive; SSE replies go out with
``Transfer-Encoding: chunked``, one ``data: {json}\\n\\n`` event a chunk,
ending with ``data: [DONE]``.  An unknown path gets a JSON 404 and a known
path with another method a JSON 405.  The server runs on the event loop
``start()`` ran on, the loop the AsyncEngine's driver thread emits to.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from contextlib import aclosing
from dataclasses import dataclass, field
from email.utils import formatdate
from http import HTTPStatus

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.retrieval.live_index import live_index_payload
from githubrepostorag_tpu_torch.serving.async_engine import AsyncEngine
from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams
from githubrepostorag_tpu_torch.serving.tokenizer import StreamingDetokenizer, Tokenizer

logger = logging.getLogger(__name__)

MAX_BODY = 1024 ** 2  # aiohttp's client_max_size default, which the JAX server runs with
_MAX_HEADERS = 100


def _sampling_from_request(body: dict, tokenizer: Tokenizer, default_max: int) -> SamplingParams:
    stop = body.get("stop") or ()
    if isinstance(stop, str):
        stop = (stop,)
    return SamplingParams(
        temperature=float(body.get("temperature", 0.7)),
        top_p=float(body.get("top_p", 0.9)),
        top_k=int(body.get("top_k", 0)),
        max_tokens=int(
            body.get("max_completion_tokens") or body.get("max_tokens") or default_max
        ),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        stop_token_ids=(tokenizer.eos_token_id,) if tokenizer.eos_token_id is not None else (),
        stop=tuple(stop),
    )


class _HTTPError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


@dataclass
class _Request:
    method: str
    path: str
    version: str
    headers: dict[str, str]
    body: bytes
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    started: bool = field(default=False)  # response head written

    @property
    def keep_alive(self) -> bool:
        return (self.version == "HTTP/1.1"
                and self.headers.get("connection", "").lower() != "close")

    def json(self):
        return json.loads(self.body.decode("utf-8"))


async def _read_request(reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> _Request | None:
    """The next request on the connection, or None at end of stream."""
    try:
        line = await reader.readline()
    except ValueError as exc:  # longer than the reader's limit
        raise _HTTPError(400, f"request line too long: {exc}") from exc
    if not line.endswith(b"\n"):
        return None  # closed, between requests or mid-line
    parts = line.decode("latin-1").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _HTTPError(400, f"malformed request line {line[:80]!r}")
    method, target, version = parts
    headers: dict[str, str] = {}
    for _ in range(_MAX_HEADERS):
        try:
            raw = await reader.readline()
        except ValueError as exc:
            raise _HTTPError(400, f"header line too long: {exc}") from exc
        if raw in (b"\r\n", b"\n"):
            break
        if not raw.endswith(b"\n"):
            return None
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep or not name.strip():
            raise _HTTPError(400, f"malformed header line {raw[:80]!r}")
        headers[name.strip().lower()] = value.strip()
    else:
        raise _HTTPError(400, f"more than {_MAX_HEADERS} headers")
    if "transfer-encoding" in headers:
        raise _HTTPError(411, "chunked request bodies are not accepted; send Content-Length")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError as exc:
        raise _HTTPError(400, f"bad Content-Length {headers['content-length']!r}") from exc
    if length < 0:
        raise _HTTPError(400, f"bad Content-Length {length}")
    if length >= MAX_BODY:
        raise _HTTPError(413, f"request body of {length} bytes; the limit is under {MAX_BODY}")
    body = await reader.readexactly(length) if length else b""
    return _Request(method=method, path=target.split("?", 1)[0], version=version,
                    headers=headers, body=body, reader=reader, writer=writer)


def _head(status: int, headers: list[tuple[str, str]]) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}",
             f"Date: {formatdate(usegmt=True)}", "Server: githubrepostorag-tpu-torch"]
    lines += [f"{k}: {v}" for k, v in headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def _write_json(writer: asyncio.StreamWriter, status: int, payload: dict,
                      keep_alive: bool, extra: tuple[tuple[str, str], ...] = ()) -> bool:
    body = json.dumps(payload).encode("utf-8")
    headers = [("Content-Type", "application/json; charset=utf-8"),
               ("Content-Length", str(len(body))), *extra]
    if not keep_alive:
        headers.append(("Connection", "close"))
    writer.write(_head(status, headers) + body)
    await writer.drain()
    return keep_alive


def _error_payload(message: str) -> dict:
    return {"error": {"message": message, "type": "invalid_request_error"}}


class OpenAIServer:
    def __init__(
        self,
        async_engine: AsyncEngine,
        tokenizer: Tokenizer,
        model_name: str = "githubrepostorag-tpu",
        default_max_tokens: int = 1024,
    ) -> None:
        self.engine = async_engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.default_max_tokens = default_max_tokens
        self._server: asyncio.base_events.Server | None = None
        self._connections: set[asyncio.Task] = set()
        self._routes = {
            "/v1/chat/completions": {"POST": self.chat_completions},
            "/v1/completions": {"POST": self.completions},
            "/v1/models": {"GET": self.models},
            "/health": {"GET": self.health},
            "/debug/index": {"GET": self.debug_index},
        }

    # ------------------------------------------------------------- wiring

    async def start(self, host: str = "0.0.0.0", port: int = 8000) -> int:
        """Start serving on the running loop; returns the bound port (pass
        port=0 for an ephemeral one)."""
        await self.engine.start()
        self._server = await asyncio.start_server(self._connection, host, port)
        bound = self._server.sockets[0].getsockname()[1]
        logger.info("OpenAI-compatible server on %s:%d", host, bound)
        return bound

    async def stop(self) -> None:
        """Stop listening, end every open connection (a stream in flight
        cancels its request), then stop the engine's driver off the loop."""
        # capture-and-clear before awaiting: two concurrent stop() calls must
        # not both close the server
        server, self._server = self._server, None
        if server is not None:
            server.close()
            tasks = list(self._connections)
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await server.wait_closed()
        await self.engine.stop()

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
                    req = await _read_request(reader, writer)
                except _HTTPError as exc:  # the rest of the request is unread: close after
                    await _write_json(writer, exc.status, _error_payload(str(exc)), False)
                    return
                if req is None:
                    return
                keep_alive = await self._dispatch(req)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            self._connections.discard(task)
            writer.close()

    async def _dispatch(self, req: _Request) -> bool:
        """Route one request; returns whether the connection stays open."""
        methods = self._routes.get(req.path)
        if methods is None:
            return await _write_json(req.writer, 404, _error_payload(f"no route {req.path}"),
                                     req.keep_alive)
        handler = methods.get(req.method)
        if handler is None:
            return await _write_json(
                req.writer, 405, _error_payload(f"method {req.method} not allowed on {req.path}"),
                req.keep_alive, (("Allow", ", ".join(methods)),))
        try:
            return await handler(req)
        except (ConnectionError, asyncio.IncompleteReadError):
            raise
        except Exception as exc:  # noqa: BLE001 - a failed request must not end the server
            logger.exception("%s %s failed", req.method, req.path)
            if not req.started:
                await _write_json(req.writer, 500, _error_payload(f"internal error: {exc!r}"),
                                  False)
            return False

    def _json(self, req: _Request, payload: dict, status: int = 200):
        req.started = True
        return _write_json(req.writer, status, payload, req.keep_alive)

    # ------------------------------------------------------------ handlers

    async def health(self, req: _Request) -> bool:
        return await self._json(req, {"status": "ok", **self.engine.stats()})

    async def debug_index(self, req: _Request) -> bool:
        return await self._json(req, live_index_payload())

    async def models(self, req: _Request) -> bool:
        return await self._json(req, {
            "object": "list",
            "data": [{"id": self.model_name, "object": "model", "owned_by": "githubrepostorag-tpu"}],
        })

    async def chat_completions(self, req: _Request) -> bool:
        try:
            body = req.json()
            messages = body["messages"]
        except (ValueError, KeyError, TypeError) as exc:
            return await self._json(req, _error_payload(f"invalid request body: {exc}"), 400)
        prompt_ids = self.tokenizer.encode_chat(messages)
        return await self._serve(req, body, prompt_ids, chat=True)

    async def completions(self, req: _Request) -> bool:
        try:
            body = req.json()
            prompt = body["prompt"]
        except (ValueError, KeyError, TypeError) as exc:
            return await self._json(req, _error_payload(f"invalid request body: {exc}"), 400)
        prompt_ids = self.tokenizer.encode(prompt)
        return await self._serve(req, body, prompt_ids, chat=False)

    # ------------------------------------------------------------- core

    async def _serve(self, req: _Request, body: dict, prompt_ids: list[int], chat: bool) -> bool:
        sampling = _sampling_from_request(body, self.tokenizer, self.default_max_tokens)
        rid = f"chatcmpl-{uuid.uuid4().hex}" if chat else f"cmpl-{uuid.uuid4().hex}"
        # SLO priority class; unknown strings are just new classes
        priority = str(body.get("priority") or get_settings().priority_default_class)
        if body.get("stream"):
            return await self._serve_stream(req, sampling, prompt_ids, rid, chat, priority)

        detok = StreamingDetokenizer(self.tokenizer)
        text_parts: list[str] = []
        result = None
        stopped_on_string = False
        async with aclosing(self.engine.stream(prompt_ids, sampling, request_id=rid,
                                               priority=priority)) as events:
            async for event in events:
                if event.type == "token":
                    text_parts.append(detok.push(event.token_id))
                    full = "".join(text_parts)
                    hit = _find_stop(full, sampling.stop)
                    if hit is not None:
                        await self.engine.cancel(rid)
                        text_parts = [full[:hit]]
                        stopped_on_string = True
                elif event.type == "final":
                    result = event.result
        text_parts.append("" if stopped_on_string else detok.flush())
        text = "".join(text_parts)
        finish = "stop" if stopped_on_string else _map_finish(result)
        usage = {
            "prompt_tokens": len(prompt_ids),
            "completion_tokens": len(result.output_tokens) if result else 0,
            "total_tokens": len(prompt_ids) + (len(result.output_tokens) if result else 0),
        }
        if result is not None and result.finish_reason == "error":
            return await self._json(req, _error_payload(result.error or "generation failed"), 400)
        if chat:
            payload = {
                "id": rid,
                "object": "chat.completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": finish,
                    }
                ],
                "usage": usage,
            }
        else:
            payload = {
                "id": rid,
                "object": "text_completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [{"index": 0, "text": text, "finish_reason": finish}],
                "usage": usage,
            }
        return await self._json(req, payload)

    async def _serve_stream(self, req: _Request, sampling: SamplingParams,
                            prompt_ids: list[int], rid: str, chat: bool,
                            priority: str = "interactive") -> bool:
        writer = req.writer
        req.started = True
        writer.write(_head(200, [("Content-Type", "text/event-stream"),
                                 ("Cache-Control", "no-cache"), ("Connection", "keep-alive"),
                                 ("Transfer-Encoding", "chunked")]))

        async def write_chunk(data: bytes) -> None:
            writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await writer.drain()

        async def send(obj: dict) -> None:
            await write_chunk(f"data: {json.dumps(obj, ensure_ascii=False)}\n\n".encode())

        detok = StreamingDetokenizer(self.tokenizer)
        emitted = ""
        finish = None
        try:
            async with aclosing(self.engine.stream(prompt_ids, sampling, request_id=rid,
                                                   priority=priority)) as events:
                async for event in events:
                    if req.reader.at_eof():  # the client closed its end
                        raise ConnectionResetError("client closed the connection")
                    if event.type == "token":
                        delta = detok.push(event.token_id)
                        emitted += delta
                        hit = _find_stop(emitted, sampling.stop)
                        if hit is not None:
                            overshoot = len(emitted) - hit
                            if overshoot < len(delta):
                                delta = delta[: len(delta) - overshoot]
                                if delta:
                                    await send(self._chunk(rid, chat, delta, None))
                            await self.engine.cancel(rid)
                            finish = "stop"
                            continue
                        if delta and finish is None:
                            await send(self._chunk(rid, chat, delta, None))
                    elif event.type == "final":
                        if finish is None:
                            tail = detok.flush()
                            if tail:
                                await send(self._chunk(rid, chat, tail, None))
                            finish = _map_finish(event.result)
            await send(self._chunk(rid, chat, None, finish or "stop"))
            await write_chunk(b"data: [DONE]\n\n")
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except asyncio.CancelledError:
            await self.engine.cancel(rid)
            raise
        except (ConnectionError, OSError):  # client went away mid-stream
            await self.engine.cancel(rid)
            logger.info("client disconnected mid-stream, cancelled %s", rid)
            return False
        return req.keep_alive

    def _chunk(self, rid: str, chat: bool, content: str | None, finish: str | None) -> dict:
        if chat:
            delta = {"content": content} if content is not None else {}
            return {
                "id": rid,
                "object": "chat.completion.chunk",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
            }
        return {
            "id": rid,
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{"index": 0, "text": content or "", "finish_reason": finish}],
        }


def _find_stop(text: str, stops: tuple[str, ...]) -> int | None:
    best = None
    for s in stops:
        if not s:
            continue
        idx = text.find(s)
        if idx != -1 and (best is None or idx < best):
            best = idx
    return best


def _map_finish(result) -> str:
    if result is None:
        return "stop"
    return {"stop": "stop", "length": "length", "cancelled": "stop", "error": "error"}.get(
        result.finish_reason, "stop"
    )
