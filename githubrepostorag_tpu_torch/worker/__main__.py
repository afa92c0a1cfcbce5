"""Worker-only pod: ``python -m githubrepostorag_tpu_torch.worker``; port of
``githubrepostorag_tpu/worker/__main__.py`` for one NVIDIA GPU.

Mirrors the reference's rag-worker Deployment (``arq
worker.worker.WorkerSettings`` with a Prometheus server on :9000,
rag_worker/src/worker/worker.py:24-47,182-187): consumes jobs from the
Redis queue (REDIS_URL), runs the agent, emits progress over the Redis
bus, and serves ``/metrics`` on METRICS_PORT for annotation-based
Prometheus scraping.  The metrics server is the port's HTTP core
(``serving/http_core.py``), not aiohttp.

The single-pod mode (``python -m githubrepostorag_tpu_torch.api``) embeds
this worker in-process; this entry point serves the split deployment,
where rag-api (``api --redis --no-worker``) and rag-worker are separate
pods joined by Redis.  The LLM is ``api/__main__``'s (LLM_BACKEND
``inprocess``: the engine on the card), the retrievers run over the
configured store (STORE_BACKEND, DEVICE_INDEX) on the same device.

    python -m githubrepostorag_tpu_torch.worker               # on the card
    python -m githubrepostorag_tpu_torch.worker --device cpu  # plain path

On SIGTERM the pod stops taking jobs, closes the engine, the metrics
server and its Redis connections, and exits 0.
"""

from __future__ import annotations

import argparse
import asyncio

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.serving.http_core import HTTPServer, Request, respond
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class MetricsServer(HTTPServer):
    """``GET /metrics``: the process's Prometheus exposition."""

    def __init__(self) -> None:
        super().__init__()
        self.routes = {"/metrics": {"GET": self.metrics}}

    async def metrics(self, req: Request) -> bool:
        from githubrepostorag_tpu_torch.metrics import render

        return await respond(req, 200, render(), "text/plain")


async def serve(device: str | None = None, host: str = "0.0.0.0") -> None:
    from githubrepostorag_tpu_torch.api.__main__ import (bus_flags_queue, close_events,
                                                         start_worker, stop_event, stop_worker)

    s = get_settings()
    metrics = MetricsServer()
    port = await metrics.listen(host, s.metrics_port)
    logger.info("worker metrics on :%d/metrics", port)
    stop = stop_event()
    bus, flags, queue = bus_flags_queue(use_redis=True)
    running = None
    try:
        running = await start_worker(bus, flags, queue, device)
        logger.info("worker ready: consuming %s", s.redis_url)
        await stop.wait()  # serve until the pod is stopped
    finally:
        if running is not None:
            await stop_worker(*running)
        await close_events(bus, flags, queue)
        await metrics.close()
        logger.info("RAG worker stopped")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="RAG worker (Redis queue consumer, PyTorch/CUDA)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu, which runs the plain PyTorch path")
    parser.add_argument("--host", default="0.0.0.0", help="the metrics server's address")
    args = parser.parse_args(argv)
    asyncio.run(serve(args.device, args.host))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
