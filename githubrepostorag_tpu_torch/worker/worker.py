"""The RAG job worker: consumes ``run_rag_job`` jobs from the queue, drives
the agent in a thread, streams progress to the bus, supports cooperative
cancellation; a copy of ``githubrepostorag_tpu/worker/worker.py``.

Rebuild of rag_worker/src/worker/worker.py with its gaps fixed:
  - cancellation is checked *between agent stages* via a should_stop probe
    (the reference checked once before work, worker.py:121-124)
  - the progress callback is per-job, bridged thread->loop with
    run_coroutine_threadsafe exactly like the reference (worker.py:55-70)
  - max_jobs concurrency (10), per-job timeout (300 s), results kept 3600 s
    (WorkerSettings, worker.py:182-187)
Event sequence per job: started -> iteration -> turn* -> retrieval ->
final (or error + empty final).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any

from githubrepostorag_tpu_torch.agent import GraphAgent, RunCancelled
from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.events.base import CancelFlags, EnqueuedJob, JobQueue, ProgressBus
from githubrepostorag_tpu_torch.metrics import (
    JOB_DURATION,
    JOBS_IN_FLIGHT,
    JOBS_TOTAL,
    RETRIEVAL_HITS,
    WORKER_DEQUEUE_ERRORS,
)
from githubrepostorag_tpu_torch.obs import current_context, get_recorder, root_span
from githubrepostorag_tpu_torch.resilience.policy import Deadline, DeadlineExceeded, RetryPolicy
from githubrepostorag_tpu_torch.resilience.supervise import ResilientBus
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class RagWorker:
    def __init__(
        self,
        agent: GraphAgent,
        bus: ProgressBus,
        flags: CancelFlags,
        queue: JobQueue,
        max_jobs: int | None = None,
        job_timeout: int | None = None,
    ) -> None:
        s = get_settings()
        self.agent = agent
        # every emit goes through the supervised bus: retried with backoff
        # behind the shared "bus" breaker, terminal events with a deeper
        # budget, drops counted (resilience/supervise.py)
        self.bus = bus if isinstance(bus, ResilientBus) else ResilientBus(bus)
        self.flags = flags
        self.queue = queue
        self.max_jobs = max_jobs or s.worker_max_jobs
        self.job_timeout = job_timeout or s.job_timeout_seconds
        self._sem = asyncio.Semaphore(self.max_jobs)
        self._stopping = False
        self._tasks: set[asyncio.Task] = set()  # strong refs: loop holds tasks weakly

    # ------------------------------------------------------------ lifecycle

    async def run_forever(self) -> None:
        logger.info("worker: consuming jobs (max_jobs=%d)", self.max_jobs)
        policy = RetryPolicy.from_settings()
        failures = 0
        while not self._stopping:
            try:
                job = await self.queue.dequeue()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - a flaky queue must not kill the loop
                WORKER_DEQUEUE_ERRORS.inc()
                delay = policy.delay_for(failures)
                failures += 1
                logger.exception(
                    "dequeue failed (attempt %d); retrying in %.3fs", failures, delay
                )
                await asyncio.sleep(delay)
                continue
            failures = 0
            await self._sem.acquire()
            task = asyncio.create_task(self._run_with_limit(job))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    def stop(self) -> None:
        self._stopping = True

    async def _run_with_limit(self, job: EnqueuedJob) -> None:
        JOBS_IN_FLIGHT.inc()
        try:
            if job.function != "run_rag_job":
                logger.warning("unknown job function %r", job.function)
                return
            kwargs = job.kwargs or {}
            wire = kwargs.get("deadline")
            deadline = Deadline.from_wire(wire) if wire else Deadline(self.job_timeout)
            # the outer wait_for is a backstop; the deadline itself travels
            # into the agent and engine, so the budget caps the wall clock
            timeout = max(0.05, min(float(self.job_timeout), deadline.remaining()))
            # continue the trace the API opened (kwargs["trace"] rides the
            # envelope exactly like the deadline); old envelopes without it
            # start a fresh worker-rooted trace
            with root_span("worker.job", wire=kwargs.get("trace"),
                           job_id=job.job_id) as sp:
                try:
                    await asyncio.wait_for(self.run_rag_job(job, deadline), timeout=timeout)
                except (asyncio.TimeoutError, DeadlineExceeded):
                    sp.set_status("error: deadline")
                    JOBS_TOTAL.labels(status="timeout").inc()
                    await self._terminal(
                        job.job_id,
                        error=f"job exceeded its deadline ({self.job_timeout}s cap)",
                    )
                except Exception as exc:  # noqa: BLE001
                    logger.exception("job %s crashed", job.job_id)
                    sp.set_status(f"error: {type(exc).__name__}")
                    JOBS_TOTAL.labels(status="error").inc()
                    await self._terminal(job.job_id, error=str(exc))
        finally:
            JOBS_IN_FLIGHT.dec()
            self._sem.release()

    def _trace_summary(self) -> dict[str, Any]:
        """Compact phase-timing summary for the terminal SSE event: the
        active trace's id plus per-phase seconds from the flight recorder,
        so a client sees where its job's time went without a second call.
        Empty when the job is untraced."""
        ctx = current_context()
        if ctx is None or not ctx.sampled:
            return {}
        return {"trace_id": ctx.trace_id,
                "phases": get_recorder().phase_summary(ctx.trace_id)}

    async def _terminal(self, job_id: str, error: str) -> None:
        """Emit the error+empty-final pair AND store a terminal result so
        polling clients can distinguish failed from pending."""
        await self._safe_emit(job_id, "error", {"error": error})
        await self._safe_emit(job_id, "final",
                              {"answer": "", "sources": [], **self._trace_summary()})
        try:
            await self.queue.set_result(job_id, {"answer": "", "sources": [], "error": error})
        except Exception:  # noqa: BLE001
            logger.exception("set_result failed for %s", job_id)

    # ------------------------------------------------------------ the job

    async def run_rag_job(self, job: EnqueuedJob, deadline: Deadline | None = None) -> dict[str, Any]:
        job_id = job.job_id
        if deadline is not None and deadline.expired:
            raise DeadlineExceeded(f"job {job_id} deadline expired before it started")
        req: dict[str, Any] = job.args[1] if len(job.args) > 1 else (job.args[0] if job.args else {})
        if not isinstance(req, dict):
            req = {}
        query = req.get("query", "")
        namespace = req.get("namespace") or get_settings().default_namespace
        force_level = req.get("force_level")
        # per-request result cap — the schema drift the reference shipped
        # (QueryRequest declared top_k, the worker never read it)
        top_k = req.get("top_k")
        if not isinstance(top_k, int) or isinstance(top_k, bool) or top_k <= 0:
            top_k = None
        # SLO priority class off the job envelope; the scope below hands it
        # to the agent's LLM calls the same way the deadline travels
        priority = req.get("priority") or get_settings().priority_default_class
        start = time.monotonic()

        await self.bus.emit(job_id, "started", {"job_id": job_id, "query": query})

        if await self.flags.is_cancelled(job_id):
            await self.bus.emit(job_id, "final", {"answer": "", "sources": [], "cancelled": True})
            await self.queue.set_result(job_id, {"answer": "", "sources": [], "cancelled": True})
            JOBS_TOTAL.labels(status="cancelled").inc()
            return {"cancelled": True}

        await self.bus.emit(job_id, "iteration", {"n": 1})

        loop = asyncio.get_running_loop()
        cancelled = threading.Event()

        async def poll_cancel() -> None:
            while not cancelled.is_set():
                try:
                    if await self.flags.is_cancelled(job_id):
                        cancelled.set()
                        return
                except Exception:  # noqa: BLE001 - flag-store outage must not stop polling
                    logger.exception("cancel poll failed for %s", job_id)
                await asyncio.sleep(0.5)

        poller = asyncio.create_task(poll_cancel())

        def progress_cb(event: dict) -> None:
            # thread -> loop hop, the one crossing (worker.py:55-70)
            asyncio.run_coroutine_threadsafe(
                self._safe_emit(job_id, "turn", event), loop
            )

        def token_cb(delta: str) -> None:
            # real token streaming through the bus (the reference faked it:
            # qwen_llm.py:149-151); same thread -> loop hop as progress
            asyncio.run_coroutine_threadsafe(
                self._safe_emit(job_id, "token", {"text": delta}), loop
            )

        # run_in_executor does NOT propagate contextvars — hand the trace
        # context to the agent explicitly, like the deadline
        trace_ctx = current_context()

        def run_with_priority():
            # priority_scope is thread-local, so it must be entered INSIDE
            # the executor thread the agent (and its LLM calls) run on
            from githubrepostorag_tpu_torch.resilience.policy import priority_scope

            with priority_scope(priority):
                return self.agent.run(
                    query, namespace=namespace, progress_cb=progress_cb,
                    force_level=force_level, should_stop=cancelled.is_set,
                    token_cb=token_cb, top_k=top_k, deadline=deadline,
                    trace=trace_ctx,
                )

        try:
            result = await loop.run_in_executor(None, run_with_priority)
        except RunCancelled:
            await self.bus.emit(job_id, "final", {"answer": "", "sources": [], "cancelled": True})
            await self.queue.set_result(job_id, {"answer": "", "sources": [], "cancelled": True})
            JOBS_TOTAL.labels(status="cancelled").inc()
            return {"cancelled": True}
        finally:
            cancelled.set()
            poller.cancel()

        debug = result.debug or {}
        RETRIEVAL_HITS.observe(len(result.sources))
        await self.bus.emit(
            job_id,
            "retrieval",
            {
                "scope": debug.get("final_scope", ""),
                "sources_found": len(result.sources),
                "turns": debug.get("turns", []),
                "final_ctx_blocks": debug.get("final_ctx_blocks", 0),
            },
        )
        await self.bus.emit(
            job_id, "final",
            {"answer": result.answer, "sources": result.sources,
             **self._trace_summary()},
        )
        JOBS_TOTAL.labels(status="ok").inc()
        JOB_DURATION.observe(time.monotonic() - start)
        await self.queue.set_result(job_id, {"answer": result.answer, "sources": result.sources})
        return {"answer": result.answer}

    async def _safe_emit(self, job_id: str, event: str, data: dict) -> None:
        try:
            await self.bus.emit(job_id, event, data)
        except Exception:  # noqa: BLE001 - the bus must not kill the job
            logger.exception("emit %s failed for %s", event, job_id)
