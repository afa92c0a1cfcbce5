"""L5: the REST control plane; port of ``githubrepostorag_tpu/api/app.py``
on the port's HTTP/1.1 core (``serving/http_core.py``) instead of aiohttp,
which the card's machine does not have.

Same route surface as the JAX package's app:
  POST /rag/jobs                  -> {"job_id": ...} (uuid4 hex, enqueued);
                                     400 on a bad body, 429 + Retry-After
                                     at JOB_QUEUE_MAX_DEPTH
  GET  /rag/jobs/{id}/events      -> SSE stream from the progress bus, with
                                     ``: heartbeat`` comments while it is quiet
  POST /rag/jobs/{id}/cancel      -> sets the cooperative cancel flag
  GET  /rag/jobs/{id}/result      -> kept result (keep_result window)
  GET  /debug/traces[/{trace_id}] -> the flight recorder
  GET  /debug/index               -> the live index's watermarks
  GET  /health                    -> deep aggregate (503 when DOWN)
  GET  /metrics                   -> Prometheus exposition
  GET  /                          -> 302 to /static/index.html, the chat UI
with the JAX app's three middlewares -- CORS headers on every reply (and
204 to OPTIONS), the per-request count/latency series, and a root span
per /rag request continuing an incoming ``traceparent``.

and the observability planes' routes:
  GET  /debug/slo                 -> the SLO plane (burn states, decisions)
  GET  /debug/fleet               -> per-replica ledgers, monitors, stats
  GET  /debug/hbm                 -> the page observatories
  GET  /debug/timeline            -> one Perfetto trace (?window_s=; 400
                                     when it is not a number)
Their payloads are empty of replicas in a process with no engine (the
split deployment's API pod), as in the JAX app.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import mimetypes
import time
import uuid
from pathlib import Path

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.events.base import CancelFlags, JobQueue, ProgressBus
from githubrepostorag_tpu_torch.metrics import HTTP_LATENCY, HTTP_REQUESTS, JOBS_SHED, render
from githubrepostorag_tpu_torch.models_dto import QueryRequest
from githubrepostorag_tpu_torch.obs import current_context, get_recorder, root_span
from githubrepostorag_tpu_torch.resilience.policy import Deadline
from githubrepostorag_tpu_torch.serving.http_core import (
    HTTPServer,
    Request,
    debug_plane_routes,
    end_stream,
    respond,
    start_stream,
    timeline_window,
    write_chunk,
    write_json,
)
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_STATIC_DIR = Path(__file__).resolve().parent / "static"

# health probes get their own pool: the default executor is shared with
# agent jobs (worker.py run_in_executor), so a busy pod would otherwise
# queue liveness probes behind minutes of RAG work and get itself killed
_HEALTH_POOL = concurrent.futures.ThreadPoolExecutor(
    max_workers=2, thread_name_prefix="health-probe"
)

_CORS = [("Access-Control-Allow-Origin", "*"),
         ("Access-Control-Allow-Methods", "GET, POST, OPTIONS"),
         ("Access-Control-Allow-Headers", "Content-Type")]


class RagApi(HTTPServer):
    def __init__(self, bus: ProgressBus, flags: CancelFlags, queue: JobQueue) -> None:
        super().__init__()
        self.bus = bus
        self.flags = flags
        self.queue = queue
        self.routes = {
            "/rag/jobs": {"POST": self.create_job},
            "/rag/jobs/{job_id}/events": {"GET": self.job_events},
            "/rag/jobs/{job_id}/cancel": {"POST": self.cancel_job},
            "/rag/jobs/{job_id}/result": {"GET": self.job_result},
            "/debug/traces": {"GET": self.debug_traces},
            "/debug/traces/{trace_id}": {"GET": self.debug_trace},
            "/debug/index": {"GET": self.debug_index},
            **debug_plane_routes(),
            "/debug/timeline": {"GET": self.debug_timeline},
            "/health": {"GET": self.health},
            "/metrics": {"GET": self.metrics},
            "/": {"GET": self.index_redirect},
        }
        if _STATIC_DIR.is_dir():
            self.routes["/static/{filename}"] = {"GET": self.static}

    async def start(self, host: str = "0.0.0.0", port: int = 8080) -> int:
        # import now so the health module's uptime clock starts with the
        # server, not with the first probe request
        from githubrepostorag_tpu_torch.api import health  # noqa: F401

        bound = await self.listen(host, port)
        logger.info("RAG API on %s:%d", host, bound)
        return bound

    async def stop(self) -> None:
        await self.close()

    # ---------------------------------------------------------- middleware

    async def handle(self, req: Request, handler) -> bool:
        """The JAX app's middlewares, outermost first: CORS, then the
        request count/latency series, then the root span of /rag requests
        (scrape and debug endpoints would just fill the recorder ring with
        noise).  An unmatched path counts as ``unmatched``, so 404 scans
        mint no label values."""
        req.extra_headers = list(_CORS)
        if req.method == "OPTIONS":
            return await respond(req, 204, b"", "text/plain")
        start = time.monotonic()
        route = req.route or "unmatched"
        try:
            if not req.path.startswith("/rag"):
                return await handler(req)
            with root_span(f"http {req.method} {route}",
                           wire=req.headers.get("traceparent")) as sp:
                keep_alive = await handler(req)
                status = req.status or 500
                if status >= 500:
                    sp.set_status(f"error: http {status}")
                sp.set_attr("status", status)
                return keep_alive
        finally:
            HTTP_REQUESTS.labels(req.method, route, str(req.status or 500)).inc()
            HTTP_LATENCY.labels(req.method, route).observe(time.monotonic() - start)

    # ------------------------------------------------------------ handlers

    async def create_job(self, req: Request) -> bool:
        try:
            body = req.json()
            request = QueryRequest(**body)
        except Exception as exc:  # noqa: BLE001
            return await write_json(req, 400, {"error": f"invalid request: {exc}"})
        s = get_settings()
        if request.deadline_ms is not None and (
            isinstance(request.deadline_ms, bool) or request.deadline_ms <= 0
        ):
            return await write_json(
                req, 400, {"error": "deadline_ms must be a positive integer"})
        # backpressure: shed before enqueueing once the queue is saturated,
        # so the client backs off instead of the backlog growing unbounded
        try:
            depth = await self.queue.depth()
        except Exception:  # noqa: BLE001 - a flaky depth probe must not block intake
            depth = 0
        if depth >= s.job_queue_max_depth:
            JOBS_SHED.inc()
            retry_after = max(1, int(s.job_timeout_seconds // 10))
            return await write_json(
                req, 429, {"error": f"job queue full ({depth} queued); retry later"},
                (("Retry-After", str(retry_after)),))
        # per-class admission decision: sheds only when the SLO plane's
        # decision table (registered when the plane is built) says so
        from githubrepostorag_tpu_torch.resilience.admission import should_shed

        if should_shed(request.priority or s.priority_default_class):
            JOBS_SHED.inc()
            return await write_json(
                req, 429, {"error": "SLO burn rate critical; shedding load, retry later"},
                (("Retry-After", "1"),))
        job_id = uuid.uuid4().hex
        cap_ms = s.job_timeout_seconds * 1000
        budget_ms = min(request.deadline_ms or cap_ms, cap_ms)
        # the trace context (opened by the middleware) crosses the queue on
        # the envelope next to the deadline; the worker continues it
        ctx = current_context()
        await self.queue.enqueue_job(
            "run_rag_job",
            job_id,
            request.model_dump(),
            _job_id=job_id,
            deadline=Deadline(budget_ms / 1000.0).to_wire(),
            trace=ctx.to_wire() if ctx is not None and ctx.sampled else None,
        )
        reply = {"job_id": job_id}
        if ctx is not None and ctx.sampled:
            reply["trace_id"] = ctx.trace_id
        return await write_json(req, 200, reply)

    async def job_events(self, req: Request) -> bool:
        job_id = req.params["job_id"]
        await start_stream(req, 200, [("Content-Type", "text/event-stream"),
                                      ("Cache-Control", "no-cache"),
                                      ("Connection", "keep-alive")])
        heartbeat = get_settings().sse_heartbeat_seconds
        it = self.bus.stream(job_id).__aiter__()
        # the pending __anext__ must survive heartbeat timeouts: wait_for
        # would cancel it, and cancelling an async generator's __anext__
        # kills the generator mid-await
        pending: asyncio.Task | None = None
        try:
            while True:
                if req.reader.at_eof():  # the client closed its end
                    raise ConnectionResetError("client closed the connection")
                if pending is None:
                    pending = asyncio.ensure_future(it.__anext__())
                done, _ = await asyncio.wait({pending}, timeout=heartbeat)
                if not done:
                    # comment frame: keeps proxies/LBs from idling the
                    # connection out while the agent thinks
                    await write_chunk(req, b": heartbeat\n\n")
                    continue
                step, pending = pending, None
                try:
                    frame = step.result()
                except StopAsyncIteration:
                    break
                except (ConnectionError, OSError):
                    raise
                except Exception as exc:  # noqa: BLE001 - bus died mid-stream
                    logger.exception("bus stream failed for %s", job_id)
                    err = json.dumps(
                        {"event": "error", "data": {"error": f"event stream failed: {exc}"}}
                    )
                    await write_chunk(req, f"data: {err}\n\n".encode())
                    break
                await write_chunk(req, frame.encode())
                # close the stream after the terminal event so EventSource
                # clients do not reconnect forever
                if '"event": "final"' in frame or '"event": "error"' in frame:
                    break
            await end_stream(req)
        except (ConnectionError, OSError):
            return False  # client went away; nothing left to tell it
        finally:
            if pending is not None:
                pending.cancel()
            aclose = getattr(it, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:  # noqa: BLE001
                    pass
        return req.keep_alive

    async def cancel_job(self, req: Request) -> bool:
        job_id = req.params["job_id"]
        await self.flags.cancel(job_id)
        return await write_json(req, 200, {"job_id": job_id, "cancelled": True})

    async def job_result(self, req: Request) -> bool:
        job_id = req.params["job_id"]
        result = await self.queue.get_result(job_id)
        if result is None:
            return await write_json(
                req, 404, {"error": "no result (pending, expired, or unknown)"})
        return await write_json(req, 200, result)

    async def debug_traces(self, req: Request) -> bool:
        return await write_json(req, 200, get_recorder().summaries_payload())

    async def debug_trace(self, req: Request) -> bool:
        payload = get_recorder().trace_payload(req.params["trace_id"])
        if payload is None:
            return await write_json(
                req, 404, {"error": "unknown trace (evicted or never recorded)"})
        return await write_json(req, 200, payload)

    async def debug_index(self, req: Request) -> bool:
        from githubrepostorag_tpu_torch.retrieval.live_index import live_index_payload

        return await write_json(req, 200, live_index_payload())

    async def debug_timeline(self, req: Request) -> bool:
        """One Perfetto trace for the recent past (``?window_s=`` bounds
        it); save the body and open it in ui.perfetto.dev."""
        from githubrepostorag_tpu_torch.obs.timeline import build_timeline

        try:
            window_s = timeline_window(req)
        except ValueError:
            return await write_json(req, 400, {"error": "window_s must be a number"})
        return await write_json(req, 200, build_timeline(window_s=window_s))

    async def health(self, req: Request) -> bool:
        from githubrepostorag_tpu_torch.api.health import health_report

        # queue depth is async-only; resolve it here and hand the value to
        # the sync report
        try:
            queue_depth = await self.queue.depth()
        except Exception:  # noqa: BLE001
            queue_depth = None
        # health probes do blocking I/O (HTTP to the LLM backend, store
        # connectivity); keep them off the event loop so SSE streams and
        # enqueues never stall behind a slow probe
        payload, status = await asyncio.get_running_loop().run_in_executor(
            _HEALTH_POOL, lambda: health_report(queue_depth=queue_depth)
        )
        return await write_json(req, status, payload)

    async def metrics(self, req: Request) -> bool:
        return await respond(req, 200, render(), "text/plain")

    async def index_redirect(self, req: Request) -> bool:
        return await respond(req, 302, b"", "text/plain",
                             (("Location", "/static/index.html"),))

    async def static(self, req: Request) -> bool:
        path = (_STATIC_DIR / req.params["filename"]).resolve()
        if path.parent != _STATIC_DIR or not path.is_file():
            return await write_json(req, 404, self.error_payload(f"no route {req.path}"))
        ctype = mimetypes.guess_type(path.name)[0] or "application/octet-stream"
        return await respond(req, 200, path.read_bytes(), ctype)

