"""Run the RAG service: ``python -m githubrepostorag_tpu_torch.api``; port of
``githubrepostorag_tpu/api/__main__.py`` for one NVIDIA GPU.

Single-pod mode: API + worker + agent share one process over the
in-memory bus, the configured store, and the configured LLM backend
(LLM_BACKEND=fake for smoke tests; =http against a separate model server,
``python -m githubrepostorag_tpu_torch.serving``; =inprocess with
MODEL_WEIGHTS_PATH for the whole stack on the card).  The in-process
engine is built by the model server's own ``build_engine``, so the two
entry points build the same engine from the same settings and refuse the
same modes.

    python -m githubrepostorag_tpu_torch.api --port 8080               # on the card
    python -m githubrepostorag_tpu_torch.api --device cpu --port 8080  # plain path

The service runs on the card unless ``--device cpu`` asks for the CPU:
the engine, the encoder and the device index all go there.

Split deployment: ``--redis`` puts the bus, the cancel flags and the queue
on Redis (REDIS_URL, the in-tree RESP client), and ``--no-worker`` (which
needs ``--redis``) serves the API alone: a ``python -m
githubrepostorag_tpu_torch.worker`` pod consumes the queue, like the
reference's rag-api / rag-worker pair.  An API pod with ``--no-worker``
builds no LLM and no engine.  On SIGTERM the pod stops its worker, its
server and its engine, and closes its Redis connections.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from githubrepostorag_tpu_torch.config import Settings, get_settings
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def inprocess_llm(s: Settings, params: dict, cfg, tokenizer, device):
    """An ``InProcessLLM`` over ``AsyncEngine(build_engine(...))``, the
    engine warmed up (its kernels built on the card)."""
    from githubrepostorag_tpu_torch.llm import InProcessLLM
    from githubrepostorag_tpu_torch.serving.__main__ import build_engine, check_served
    from githubrepostorag_tpu_torch.serving.async_engine import AsyncEngine

    check_served(s)
    engine = build_engine(s, params, cfg, device)
    engine.warmup()
    return InProcessLLM(AsyncEngine(engine), tokenizer)


def _build_llm(device: str | None = None):
    s = get_settings()
    backend = s.llm_backend.lower()
    if backend == "inprocess":
        import torch

        from githubrepostorag_tpu_torch.device import resolve_device
        from githubrepostorag_tpu_torch.models.hf_loader import load_qwen2
        from githubrepostorag_tpu_torch.serving.tokenizer import make_tokenizer

        if not s.model_weights_path:
            raise SystemExit("LLM_BACKEND=inprocess requires MODEL_WEIGHTS_PATH")
        dev = resolve_device(device)
        tokenizer = make_tokenizer(s.model_weights_path)
        params, cfg = load_qwen2(s.model_weights_path, dtype=torch.bfloat16,
                                 quantize=s.quantize_weights, fuse=True, device=dev,
                                 moe_capacity_factor=s.moe_capacity_factor)
        return inprocess_llm(s, params, cfg, tokenizer, dev)
    from githubrepostorag_tpu_torch.llm import get_llm

    return get_llm()


def bus_flags_queue(use_redis: bool) -> tuple:
    """The bus, cancel flags and job queue: over Redis (REDIS_URL) or in
    process."""
    if use_redis:
        from githubrepostorag_tpu_torch.events.redis import (RedisBus, RedisCancelFlags,
                                                             RedisJobQueue)

        return RedisBus(), RedisCancelFlags(), RedisJobQueue()
    from githubrepostorag_tpu_torch.events import MemoryBus, MemoryCancelFlags, MemoryJobQueue

    return MemoryBus(), MemoryCancelFlags(), MemoryJobQueue()


def stop_event() -> asyncio.Event:
    """An event that SIGTERM and SIGINT set."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    return stop


async def start_worker(bus, flags, queue, device: str | None = None):
    """The LLM from the settings (``_build_llm``), the agent over it and a
    ``RagWorker`` consuming ``queue``, running.  Returns (llm, worker,
    its task)."""
    from githubrepostorag_tpu_torch.agent import GraphAgent
    from githubrepostorag_tpu_torch.llm import set_llm
    from githubrepostorag_tpu_torch.metrics import MeteredLLM
    from githubrepostorag_tpu_torch.retrieval import RetrieverFactory
    from githubrepostorag_tpu_torch.worker import RagWorker

    raw_llm = _build_llm(device)
    set_llm(raw_llm)  # health.py probes the shared instance for engine stats
    agent = GraphAgent(MeteredLLM(raw_llm), RetrieverFactory(device=device))
    worker = RagWorker(agent, bus, flags, queue)
    return raw_llm, worker, asyncio.create_task(worker.run_forever())


async def stop_worker(raw_llm, worker, task) -> None:
    """Stop taking jobs, end the consumer loop, close the engine."""
    worker.stop()
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    close = getattr(raw_llm, "close", None)
    if close is not None:
        await asyncio.get_running_loop().run_in_executor(None, close)


async def close_events(*parts) -> None:
    """Close whatever of the bus, flags and queue holds a connection."""
    for part in parts:
        close = getattr(part, "close", None)
        if close is not None:
            await close()


async def serve(host: str, port: int, device: str | None = None, use_redis: bool = False,
                run_worker: bool = True) -> None:
    from githubrepostorag_tpu_torch.api.app import RagApi

    bus, flags, queue = bus_flags_queue(use_redis)
    api = RagApi(bus, flags, queue)
    await api.start(host=host, port=port)
    logger.info("service up — UI at http://%s:%d/static/index.html", host, port)
    stop = stop_event()
    running = None
    try:
        # --no-worker (rag-api pod): a separate worker pod consumes the
        # queue over Redis
        if run_worker:
            running = await start_worker(bus, flags, queue, device)
        await stop.wait()  # serve until the pod is stopped
    finally:
        if running is not None:
            await stop_worker(*running)
        await api.stop()
        await close_events(bus, flags, queue)
        logger.info("RAG service stopped")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Run the RAG API + worker (PyTorch/CUDA)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu, which runs the plain PyTorch path")
    parser.add_argument("--redis", action="store_true",
                        help="use Redis (REDIS_URL) for bus/queue instead of in-memory")
    parser.add_argument("--no-worker", action="store_true",
                        help="API only; a separate `python -m githubrepostorag_tpu_torch.worker` "
                             "pod consumes the queue (requires --redis)")
    args = parser.parse_args(argv)
    if args.no_worker and not args.redis:
        parser.error("--no-worker requires --redis (the queue must be shared)")
    asyncio.run(serve(args.host, args.port, args.device, args.redis,
                      run_worker=not args.no_worker))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
