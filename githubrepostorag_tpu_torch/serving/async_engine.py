"""Async facade over the synchronous Engine; port of the driver core of
``githubrepostorag_tpu/serving/async_engine.py::AsyncEngine``.

A dedicated driver thread spins ``engine.step()`` while work exists
(continuous batching); token and final events hop into per-request asyncio
queues through ``call_soon_threadsafe``.  The device never waits on the
event loop and the event loop never blocks on the device.  After each
step the driver turns the engine's park events into ``parked`` stream
events (advisory: a parked request resumes token for token) and exports
the speculative, host-tier and preemption counters to ``metrics.py``'s
series under the replica label, as the JAX version does.  The JAX
version's observability planes (step profiler, token ledger, SLO monitor,
page observatory, router digest) are not ported yet (ROADMAP queue 1 item
6): nothing attaches a page observer (``Engine.attach_page_observer``) or
pushes class pressure (``Engine.set_class_pressure``) here.

The engine belongs to the driver thread alone.  Submissions and
cancellations go into an inbox that the driver applies before each step,
so the event loop never waits for the driver: taking the driver's lock on
the loop, as the JAX version does, starves the loop under concurrent HTTP
arrivals (the busy driver retakes the lock within one step's Python), and
the requests then run one after another.

``stats()`` returns the JAX version's key set and values; the
sequence-parallel keys read 0, as the JAX version gives them on one chip.
It reads the engine's counters without a lock, each read atomic
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
    type: str  # "token" | "parked" | "final"
    token_id: int | None = None
    result: GenerationResult | None = None


class AsyncEngine:
    def __init__(self, engine: Engine, replica: str = "r0") -> None:
        self.engine = engine  # driven by the driver thread alone
        self.replica = replica  # the metrics' replica label
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
        self._export = _CounterExport(self.engine, self.replica)
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
            for rid in self.engine.drain_park_events():
                # advisory: the request is parked in the host tier and will
                # resume token for token; consumers keep waiting
                self._emit(rid, StreamEvent(type="parked"))
            self._export.step(finished)
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
        """Queue, page, speculation, host-tier and preemption counters for
        ``/health``, with the JAX version's keys."""
        eng = self.engine
        alloc = eng._allocator
        return {
            "role": "fused",
            "running": eng.num_running,
            "waiting": eng.num_waiting,
            "requests_admitted": eng.requests_admitted,
            "free_pages": alloc.free_count,
            "total_pages": alloc.num_pages,
            "prefix_cache_hit_tokens": getattr(alloc, "hit_tokens", 0),
            # sequence-parallel prefill needs a mesh (ROADMAP queue 1 item 8)
            "sp_prefills": 0,
            "sp_ring_segments": 0,
            "sp_ring_tokens": 0,
            "spec_proposed": eng.spec_proposed,
            "spec_accepted": eng.spec_accepted,
            "spec_acceptance_rate": eng.spec_accepted / max(1, eng.spec_proposed),
            "spec_fallbacks": sum(eng.spec_fallbacks.values()),
            "deadline_reaps": eng.deadline_reaps,
            "kv_host_pages": getattr(alloc, "host_pages", 0),
            "kv_fault_ins": getattr(alloc, "fault_ins", 0),
            "kv_writebacks": getattr(alloc, "writebacks", 0),
            "kv_dedup_hits": getattr(alloc, "dedup_hits", 0),
            "kv_dedup_holds": eng.dedup_holds,
            "kv_pages_exported": eng.kv_pages_exported,
            "kv_pages_imported": eng.kv_pages_imported,
            "parked": eng.num_parked,
            "preemptions": eng.preemptions,
            "preempted_pages": eng.preempted_pages,
            "preempt_resumes": eng.preempt_resumes,
            "resume_faulted_pages": eng.resume_faulted_pages,
            "resume_recomputed_tokens": eng.resume_recomputed_tokens,
            "resume_recomputed_prompt_tokens": eng.resume_recomputed_prompt_tokens,
        }


class _CounterExport:
    """The engine's cumulative counters exported as deltas to the metrics'
    series after each step (the JAX driver's ``export_counters``): the
    speculative ones while n-gram speculation is on, the host tier's while
    the tier is on, the preemption ones while preemption is on.  A series'
    replica child is made at its first export, so an engine that runs none
    of these modes adds no sample to ``/metrics``."""

    def __init__(self, engine: Engine, replica: str) -> None:
        self.engine = engine
        self.replica = replica
        self.last = {"prop": 0, "acc": 0, "fb": {}, "kv_fault": 0, "kv_wb": 0, "kv_dedup": 0,
                     "kv_hold": 0, "kv_mig_s": 0.0, "preempts": 0, "resumes": 0}

    def _child(self, metric, **labels):
        return metric.labels(replica=self.replica, **labels)

    def _inc(self, metric, key: str, value) -> None:
        if value > self.last[key]:
            self._child(metric).inc(value - self.last[key])
            self.last[key] = value

    def step(self, finished: list[GenerationResult]) -> None:
        from githubrepostorag_tpu_torch import metrics as m

        eng, last = self.engine, self.last
        if eng.spec_ngram_k > 0:
            d_prop, d_acc = eng.spec_proposed - last["prop"], eng.spec_accepted - last["acc"]
            if d_prop > 0:
                self._child(m.SPEC_PROPOSED).inc(d_prop)
                self._child(m.SPEC_PROPOSED_TOTAL).inc(d_prop)
            if d_acc > 0:
                self._child(m.SPEC_ACCEPTED).inc(d_acc)
                self._child(m.SPEC_ACCEPTED_TOTAL).inc(d_acc)
            last.update(prop=eng.spec_proposed, acc=eng.spec_accepted)
            for reason, n in eng.spec_fallbacks.items():
                prev = last["fb"].get(reason, 0)
                if n > prev:
                    self._child(m.SPEC_FALLBACKS, reason=reason).inc(n - prev)
                    last["fb"][reason] = n
            for res in finished:
                if res.spec_proposed > 0:
                    self._child(m.SPEC_ACCEPTANCE).observe(res.spec_accepted / res.spec_proposed)
        if eng._kv_tier_on:
            alloc = eng._allocator
            self._inc(m.KV_FAULT_INS, "kv_fault", alloc.fault_ins)
            self._inc(m.KV_WRITEBACKS, "kv_wb", alloc.writebacks)
            self._inc(m.KV_DEDUP_HITS, "kv_dedup", alloc.dedup_hits)
            self._inc(m.KV_DEDUP_HOLDS, "kv_hold", eng.dedup_holds)
            mig_s = eng.migration_seconds_total + eng.fault_in_seconds_total
            if mig_s > last["kv_mig_s"]:
                # one observation per step that migrated: its host time
                self._child(m.KV_MIGRATION_SECONDS).observe(mig_s - last["kv_mig_s"])
                last["kv_mig_s"] = mig_s
            self._child(m.KV_TIER_DEVICE_PAGES).set(alloc.free_count)
            self._child(m.KV_TIER_HOST_PAGES).set(alloc.host_pages)
        if eng._preempt_on:
            self._inc(m.ENGINE_PREEMPTIONS, "preempts", eng.preemptions)
            self._inc(m.ENGINE_PREEMPT_RESUMES, "resumes", eng.preempt_resumes)
