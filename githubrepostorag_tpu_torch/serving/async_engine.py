"""Async facade over the synchronous Engine; port of the driver core of
``githubrepostorag_tpu/serving/async_engine.py::AsyncEngine``.

A dedicated driver thread spins ``engine.step()`` while work exists
(continuous batching); token and final events hop into per-request asyncio
queues through ``call_soon_threadsafe``.  The device never waits on the
event loop and the event loop never blocks on the device.  The JAX
version's observability planes (step profiler, token ledger, SLO monitor,
page observatory, router digest, metrics) are not ported yet.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from dataclasses import dataclass
from typing import AsyncIterator

from githubrepostorag_tpu_torch.serving.engine import Engine, GenerationResult
from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams

logger = logging.getLogger(__name__)


@dataclass
class StreamEvent:
    type: str  # "token" | "final"
    token_id: int | None = None
    result: GenerationResult | None = None


class AsyncEngine:
    def __init__(self, engine: Engine) -> None:
        self.engine = engine
        self._lock = threading.Lock()  # engine state belongs to the driver
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._queues: dict[str, asyncio.Queue[StreamEvent]] = {}
        self.driver_error: str | None = None

    async def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(target=self._drive, name="engine-driver", daemon=True)
        self._thread.start()

    async def stop(self) -> None:
        self._stop = True
        self._wake.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            # the driver may be mid-step; join off the loop
            await asyncio.get_running_loop().run_in_executor(None, thread.join, 30)

    def _drive(self) -> None:
        while not self._stop:
            with self._lock:
                try:
                    has_work = self.engine.has_work()
                    finished = self.engine.step() if has_work else []
                except Exception as exc:  # noqa: BLE001 - fail every waiter, never hang
                    logger.exception("engine driver failed")
                    self.driver_error = repr(exc)
                    self._fail_in_flight(self.driver_error)
                    return
            for res in finished:
                self._emit(res.request_id, StreamEvent(type="final", result=res))
            if not has_work:
                self._wake.wait(timeout=0.02)
                self._wake.clear()

    def _fail_in_flight(self, reason: str) -> None:
        for rid in list(self._queues):
            res = GenerationResult(request_id=rid, prompt_tokens=[], output_tokens=[],
                                   finish_reason="error", error=reason)
            self._emit(rid, StreamEvent(type="final", result=res))

    def _emit(self, rid: str, event: StreamEvent) -> None:
        q = self._queues.get(rid)
        if q is None or self._loop is None:
            return
        self._loop.call_soon_threadsafe(q.put_nowait, event)

    async def stream(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        request_id: str | None = None,
        deadline_s: float | None = None,
    ) -> AsyncIterator[StreamEvent]:
        """Submit a request and yield its token events, then the final
        event.  ``deadline_s`` (absolute time.monotonic()) lets the engine
        reap the request once its caller's budget is gone."""
        await self.start()
        if self.driver_error is not None:
            raise RuntimeError(f"engine driver is dead: {self.driver_error}")
        q: asyncio.Queue[StreamEvent] = asyncio.Queue()

        def on_token(rid: str, token_id: int) -> None:
            self._emit(rid, StreamEvent(type="token", token_id=token_id))

        with self._lock:
            rid = self.engine.add_request(prompt_ids, sampling, on_token=on_token,
                                          request_id=request_id, deadline_s=deadline_s)
            self._queues[rid] = q
        self._wake.set()
        try:
            while True:
                event = await q.get()
                yield event
                if event.type == "final":
                    return
        finally:
            self._queues.pop(rid, None)

    async def generate(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        request_id: str | None = None,
        deadline_s: float | None = None,
    ) -> GenerationResult:
        async for event in self.stream(prompt_ids, sampling, request_id, deadline_s):
            if event.type == "final":
                return event.result
        raise RuntimeError("stream ended without a final event")  # pragma: no cover

    async def cancel(self, request_id: str) -> None:
        with self._lock:
            self.engine.cancel(request_id)
        self._wake.set()
