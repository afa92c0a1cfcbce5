"""Async facade over the synchronous Engine; port of the driver core of
``githubrepostorag_tpu/serving/async_engine.py::AsyncEngine``.

A dedicated driver thread spins ``engine.step()`` while work exists
(continuous batching); token and final events hop into per-request asyncio
queues through ``call_soon_threadsafe``.  The device never waits on the
event loop and the event loop never blocks on the device.  The JAX
version's observability planes (step profiler, token ledger, SLO monitor,
page observatory, router digest, metrics) are not ported yet.

The engine belongs to the driver thread alone.  Submissions and
cancellations go into an inbox that the driver applies before each step,
so the event loop never waits for the driver: taking the driver's lock on
the loop, as the JAX version does, starves the loop under concurrent HTTP
arrivals (the busy driver retakes the lock within one step's Python), and
the requests then run one after another.

``stats()`` returns the JAX version's key set; keys of modes the port does
not run read 0, as the JAX version's defaults give them while the mode is
off.  It reads the engine's counters without a lock, each read atomic
under the interpreter lock, so a row may mix two steps' values; the JAX
version's bounded wait and stale row need the fleet controller's stats
timeout, a setting the port does not have yet.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable

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
        self.engine = engine  # driven by the driver thread alone
        # (request id, operation) the driver applies before its next step
        self._inbox: deque[tuple[str, Callable[[], None]]] = deque()
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
            self._apply_inbox()
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
            if not has_work and not self._inbox:
                self._wake.wait(timeout=0.02)
                self._wake.clear()

    def _apply_inbox(self) -> None:
        """Run the queued submissions and cancellations in order; one that
        raises ends its own request with an error, not the driver."""
        while self._inbox:
            rid, op = self._inbox.popleft()
            try:
                op()
            except Exception as exc:  # noqa: BLE001 - one bad request must not stop serving
                logger.exception("engine rejected %s", rid)
                res = GenerationResult(request_id=rid, prompt_tokens=[], output_tokens=[],
                                       finish_reason="error", error=repr(exc))
                self._emit(rid, StreamEvent(type="final", result=res))

    def _submit(self, rid: str, op: Callable[[], None]) -> None:
        self._inbox.append((rid, op))
        self._wake.set()

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
        priority: str | None = None,
    ) -> AsyncIterator[StreamEvent]:
        """Submit a request and yield its token events, then the final
        event.  ``deadline_s`` (absolute time.monotonic()) lets the engine
        reap the request once its caller's budget is gone; ``priority`` is
        its SLO class (the engine's default class when None).  A stream
        closed before its final event cancels the request (the JAX version
        leaves the row decoding to its end)."""
        await self.start()
        if self.driver_error is not None:
            raise RuntimeError(f"engine driver is dead: {self.driver_error}")
        q: asyncio.Queue[StreamEvent] = asyncio.Queue()
        rid = request_id or f"req-{uuid.uuid4().hex}"

        def on_token(rid: str, token_id: int) -> None:
            self._emit(rid, StreamEvent(type="token", token_id=token_id))

        self._queues[rid] = q
        if self.driver_error is not None:  # it died before the queue was there to fail
            self._queues.pop(rid, None)
            raise RuntimeError(f"engine driver is dead: {self.driver_error}")
        self._submit(rid, lambda: self.engine.add_request(
            prompt_ids, sampling, on_token=on_token, request_id=rid, deadline_s=deadline_s,
            priority=priority))
        done = False
        try:
            while True:
                event = await q.get()
                done = event.type == "final"
                yield event
                if done:
                    return
        finally:
            self._queues.pop(rid, None)
            if not done:
                # the consumer left first (its task was cancelled or it
                # closed the stream): end the row so its pages come back
                self._submit(rid, lambda: self.engine.cancel(rid))

    async def generate(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        request_id: str | None = None,
        deadline_s: float | None = None,
        priority: str | None = None,
    ) -> GenerationResult:
        async for event in self.stream(prompt_ids, sampling, request_id, deadline_s,
                                       priority):
            if event.type == "final":
                return event.result
        raise RuntimeError("stream ended without a final event")  # pragma: no cover

    async def cancel(self, request_id: str) -> None:
        self._submit(request_id, lambda: self.engine.cancel(request_id))

    def stats(self) -> dict[str, Any]:
        """Queue, page and request counters for ``/health``."""
        eng = self.engine
        out = {
            "role": "fused",
            "running": eng.num_running,
            "waiting": eng.num_waiting,
            "requests_admitted": eng.requests_admitted,
            "free_pages": eng._allocator.free_count,
            "total_pages": eng._allocator.num_pages,
            "prefix_cache_hit_tokens": getattr(eng._allocator, "hit_tokens", 0),
            "deadline_reaps": eng.deadline_reaps,
        }
        # the sequence-parallel, speculative, host-tier, disaggregation and
        # preemption modes are not ported: their counters stay 0
        zero = ("sp_prefills", "sp_ring_segments", "sp_ring_tokens", "spec_proposed",
                "spec_accepted", "spec_fallbacks", "kv_host_pages", "kv_fault_ins",
                "kv_writebacks", "kv_dedup_hits", "kv_dedup_holds", "kv_pages_exported",
                "kv_pages_imported", "parked", "preemptions", "preempted_pages",
                "preempt_resumes", "resume_faulted_pages", "resume_recomputed_tokens",
                "resume_recomputed_prompt_tokens")
        out.update(dict.fromkeys(zero, 0), spec_acceptance_rate=0.0)
        return out
