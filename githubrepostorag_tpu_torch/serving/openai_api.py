"""OpenAI-compatible HTTP front end over the AsyncEngine; port of
``githubrepostorag_tpu/serving/openai_api.py`` on the standard library.

Endpoints: POST /v1/chat/completions (stream and non-stream),
POST /v1/completions, GET /v1/models, GET /health, GET /debug/index
(the live index's watermarks and compaction, ``live_index_payload``), the
observability planes' GET /debug/slo, /debug/fleet, /debug/hbm and
/debug/timeline (``?window_s=``, 400 when not a number), and POST
/debug/fleet/drain and /debug/fleet/activate, which drain and activate a
replica of a ``MultiAsyncEngine`` fleet (``MESH_SHAPE=dp:N``) and which a
single engine answers with the JAX server's 404.  ``/health`` carries
the engine's stats: over a fleet, the merged rows, ``per_replica`` and
the ``router`` payload.  Request handling --
sampling defaults, stop strings (cut inside a streamed delta too), finish
reasons, the 400 for malformed bodies and for ``finish_reason == "error"``,
cancellation on a stop string, a client that goes away, or a cancelled
task -- follows the JAX server line for line.

The JAX server runs on aiohttp, which the card's machine does not have, so
this one runs on the port's HTTP/1.1 core (``serving/http_core.py``,
shared with the RAG API): JSON replies carry ``Content-Length`` and keep
the connection alive; SSE replies go out chunked, one
``data: {json}\n\n`` event a chunk, ending with ``data: [DONE]``.  The
server runs on the event loop ``start()`` ran on, the loop the
AsyncEngine's driver thread emits to.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from contextlib import aclosing

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.retrieval.live_index import live_index_payload
from githubrepostorag_tpu_torch.serving.async_engine import AsyncEngine
from githubrepostorag_tpu_torch.serving.http_core import (
    MAX_BODY,
    HTTPServer,
    Request,
    debug_plane_routes,
    end_stream,
    error_payload,
    start_stream,
    timeline_window,
    write_chunk,
    write_json,
)
from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams
from githubrepostorag_tpu_torch.serving.tokenizer import StreamingDetokenizer, Tokenizer

logger = logging.getLogger(__name__)

__all__ = ["MAX_BODY", "OpenAIServer"]


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


class OpenAIServer(HTTPServer):
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
        super().__init__()
        self.routes = {
            "/v1/chat/completions": {"POST": self.chat_completions},
            "/v1/completions": {"POST": self.completions},
            "/v1/models": {"GET": self.models},
            "/health": {"GET": self.health},
            "/debug/index": {"GET": self.debug_index},
            **debug_plane_routes(),
            "/debug/timeline": {"GET": self.debug_timeline},
            "/debug/fleet/drain": {"POST": self.fleet_drain},
            "/debug/fleet/activate": {"POST": self.fleet_activate},
        }

    # ------------------------------------------------------------- wiring

    async def start(self, host: str = "0.0.0.0", port: int = 8000) -> int:
        """Start serving on the running loop; returns the bound port (pass
        port=0 for an ephemeral one)."""
        await self.engine.start()
        bound = await self.listen(host, port)
        logger.info("OpenAI-compatible server on %s:%d", host, bound)
        return bound

    async def stop(self) -> None:
        """Stop listening, end every open connection (a stream in flight
        cancels its request), then stop the engine's driver off the loop."""
        await self.close()
        await self.engine.stop()

    def _json(self, req: Request, payload: dict, status: int = 200):
        return write_json(req, status, payload)

    # ------------------------------------------------------------ handlers

    async def health(self, req: Request) -> bool:
        return await self._json(req, {"status": "ok", **self.engine.stats()})

    async def debug_index(self, req: Request) -> bool:
        return await self._json(req, live_index_payload())

    async def debug_timeline(self, req: Request) -> bool:
        """One Perfetto trace for the recent past (``?window_s=`` bounds
        it); save the body and open it in ui.perfetto.dev."""
        from githubrepostorag_tpu_torch.obs.timeline import build_timeline

        try:
            window_s = timeline_window(req)
        except ValueError:
            return await self._json(req, error_payload("window_s must be a number"), 400)
        return await self._json(req, build_timeline(window_s=window_s))

    async def _fleet_lifecycle(self, req: Request, verb: str) -> bool:
        """POST /debug/fleet/{drain,activate}: duck-typed on the engine
        being a replica group (a single engine answers 404)."""
        action = getattr(self.engine, verb, None)
        if action is None:
            return await self._json(
                req, error_payload("fleet lifecycle requires replica groups"), 404)
        try:
            replica = req.json()["replica"]
        except (ValueError, KeyError, TypeError) as exc:
            return await self._json(req, error_payload(f"invalid request body: {exc}"), 400)
        try:
            return await self._json(req, await action(replica))
        except KeyError:
            return await self._json(req, error_payload(f"unknown replica {replica!r}"), 404)

    async def fleet_drain(self, req: Request) -> bool:
        return await self._fleet_lifecycle(req, "drain")

    async def fleet_activate(self, req: Request) -> bool:
        return await self._fleet_lifecycle(req, "activate")

    async def models(self, req: Request) -> bool:
        return await self._json(req, {
            "object": "list",
            "data": [{"id": self.model_name, "object": "model", "owned_by": "githubrepostorag-tpu"}],
        })

    async def chat_completions(self, req: Request) -> bool:
        try:
            body = req.json()
            messages = body["messages"]
        except (ValueError, KeyError, TypeError) as exc:
            return await self._json(req, error_payload(f"invalid request body: {exc}"), 400)
        prompt_ids = self.tokenizer.encode_chat(messages)
        return await self._serve(req, body, prompt_ids, chat=True)

    async def completions(self, req: Request) -> bool:
        try:
            body = req.json()
            prompt = body["prompt"]
        except (ValueError, KeyError, TypeError) as exc:
            return await self._json(req, error_payload(f"invalid request body: {exc}"), 400)
        prompt_ids = self.tokenizer.encode(prompt)
        return await self._serve(req, body, prompt_ids, chat=False)

    # ------------------------------------------------------------- core

    async def _serve(self, req: Request, body: dict, prompt_ids: list[int], chat: bool) -> bool:
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
                # "parked" (preempt-to-host) is advisory: the request resumes
                # token for token, so keep waiting
        text_parts.append("" if stopped_on_string else detok.flush())
        text = "".join(text_parts)
        finish = "stop" if stopped_on_string else _map_finish(result)
        usage = {
            "prompt_tokens": len(prompt_ids),
            "completion_tokens": len(result.output_tokens) if result else 0,
            "total_tokens": len(prompt_ids) + (len(result.output_tokens) if result else 0),
        }
        if result is not None and result.finish_reason == "error":
            return await self._json(req, error_payload(result.error or "generation failed"), 400)
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

    async def _serve_stream(self, req: Request, sampling: SamplingParams,
                            prompt_ids: list[int], rid: str, chat: bool,
                            priority: str = "interactive") -> bool:
        await start_stream(req, 200, [("Content-Type", "text/event-stream"),
                                      ("Cache-Control", "no-cache"),
                                      ("Connection", "keep-alive")])

        async def send(obj: dict) -> None:
            await write_chunk(req, f"data: {json.dumps(obj, ensure_ascii=False)}\n\n".encode())

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
            await write_chunk(req, b"data: [DONE]\n\n")
            await end_stream(req)
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
