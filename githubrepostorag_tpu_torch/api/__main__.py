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
the engine, the encoder and the device index all go there.  The JAX
package's split deployment (``--redis``, ``--no-worker``: the bus and the
queue over Redis, a separate worker pod) is not ported yet; either flag
exits naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from githubrepostorag_tpu_torch.config import Settings, get_settings
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SPLIT_DEPLOYMENT = ("ROADMAP.md queue 1 item 4 (the split deployment over Redis: "
                    "events/resp.py, events/redis.py, worker/__main__.py)")


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
                                 quantize=s.quantize_weights, fuse=True, device=dev)
        return inprocess_llm(s, params, cfg, tokenizer, dev)
    from githubrepostorag_tpu_torch.llm import get_llm

    return get_llm()


async def serve(host: str, port: int, device: str | None = None) -> None:
    from githubrepostorag_tpu_torch.agent import GraphAgent
    from githubrepostorag_tpu_torch.api.app import RagApi
    from githubrepostorag_tpu_torch.events import MemoryBus, MemoryCancelFlags, MemoryJobQueue
    from githubrepostorag_tpu_torch.llm import set_llm
    from githubrepostorag_tpu_torch.metrics import MeteredLLM
    from githubrepostorag_tpu_torch.retrieval import RetrieverFactory
    from githubrepostorag_tpu_torch.worker import RagWorker

    bus, flags, queue = MemoryBus(), MemoryCancelFlags(), MemoryJobQueue()
    api = RagApi(bus, flags, queue)
    await api.start(host=host, port=port)
    logger.info("service up — UI at http://%s:%d/static/index.html", host, port)

    raw_llm = _build_llm(device)
    set_llm(raw_llm)  # health.py probes the shared instance for engine stats
    agent = GraphAgent(MeteredLLM(raw_llm), RetrieverFactory(device=device))
    worker = RagWorker(agent, bus, flags, queue)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    task = asyncio.create_task(worker.run_forever())
    try:
        await stop.wait()  # serve until the pod is stopped
    finally:
        worker.stop()
        task.cancel()
        await api.stop()
        close = getattr(raw_llm, "close", None)
        if close is not None:
            await loop.run_in_executor(None, close)
        logger.info("RAG service stopped")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Run the RAG API + worker (PyTorch/CUDA)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu, which runs the plain PyTorch path")
    parser.add_argument("--redis", action="store_true",
                        help="not ported yet: exits naming the ROADMAP item")
    parser.add_argument("--no-worker", action="store_true",
                        help="not ported yet: exits naming the ROADMAP item")
    args = parser.parse_args(argv)
    if args.redis or args.no_worker:
        flag = "--redis" if args.redis else "--no-worker"
        raise SystemExit(f"{flag}: the torch port runs the single-pod service only; "
                         f"{SPLIT_DEPLOYMENT} brings it")
    asyncio.run(serve(args.host, args.port, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
