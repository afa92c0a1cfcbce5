"""Async facade over the synchronous Engine; port of the driver core of
``githubrepostorag_tpu/serving/async_engine.py::AsyncEngine``.

A dedicated driver thread spins ``engine.step()`` while work exists
(continuous batching); token and final events hop into per-request asyncio
queues through ``call_soon_threadsafe``.  The device never waits on the
event loop and the event loop never blocks on the device.  After each
step the driver turns the engine's park events into ``parked`` stream
events (advisory: a parked request resumes token for token) and exports
the speculative, host-tier and preemption counters to ``metrics.py``'s
series under the replica label, as the JAX version does.

The observability planes are wired as in the JAX driver: a step profiler
(scheduler stall, the compile watchdog, re-baselined by ``mark_warm`` at
each ``start()``), a token ledger and an SLO burn-rate monitor registered
with the process's SLO plane, a page observatory attached to the engine
(``Engine.attach_page_observer``) and registered with the HBM plane, and a
continuous profiler.  Every 0.25 s the driver pushes the monitor's class
states into ``Engine.set_class_pressure``, so preemption and headroom act
on a burning error budget; each finished request is one ``slo.observe``.
The hooks run on the driver thread, after the step; a hook that raises is
logged and serving goes on.  ``obs_seconds_total`` and
``step_seconds_total`` sum the hooks' and the steps' host time.

What the fleet (``serving/multi_engine.py``, ``controller.py``) reads off
a replica, as in the JAX version: ``digest``, the ``ReplicaDigest`` the
driver publishes (the allocator's resident and host chain hashes, at most
every ``ROUTE_DIGEST_INTERVAL_S``); ``lifecycle`` and ``role``, which the
fleet sets; ``heartbeat``, stamped at the top of every driver iteration
and every 50 ms while the driver waits for a peer's step (below), and
``driver_alive()``; ``fail_in_flight``, the fence's error frames;
``load()``, the queue depth the router ranks by; and the per-replica chaos
seam ``fleet.step.<replica>`` before each iteration, where ``error`` kills
the driver (it records ``driver_error`` and exits, leaving its requests
for the fence) and ``delay`` wedges it.

The engine belongs to the driver thread.  Submissions and cancellations
go into an inbox that the driver applies before each step, so the event
loop never waits for the driver: taking the driver's lock on the loop, as
the JAX version does, starves the loop under concurrent HTTP arrivals
(the busy driver retakes the lock within one step's Python), and the
requests then run one after another.  The driver holds ``_lock`` over
each iteration, and ``step_lock`` (when the fleet sets one) over each
step.  Waiting for ``step_lock`` is no wedge: the waiting driver keeps
stamping its heartbeat, so the controller's liveness probe finds only the
replica that holds the lock and does not return, and the lock is re-read
at each stamp, so the fresh one a fence hands the peers of a fenced
holder is taken.  Work that must not interleave with a step takes ``_lock`` from
an executor thread: ``export_kv_pages`` / ``import_kv_pages`` (the
disaggregated handoff), the fleet's host-tier writeback at drain and the
controller's actuators.  ``on_admit`` fires when the request enters the
inbox; until the driver applies it, ``load()`` counts it as submitted, so
the router's view of a replica never drops or doubles a request.

A request of no stated class whose prompt would take the ring prefill
(``Engine.is_longctx``) is put in the ``longctx`` class, as in JAX.

On a mesh, rank 0's driver is the leader of ``serving/spmd.py``'s
lockstep: before each step it hands the leader what it applied since the
last one (admissions and cancellations, the class pressure) with
its clock reading, which the step's deadlines are read against, and the
other ranks apply the same and step with it.

``stats()`` returns the JAX version's key set and values, the
sequence-parallel counters from the engine.  It reads the engine's counters without a lock, each read atomic under the
interpreter lock, so a row may mix two steps' values but never waits: a
wedged driver's row stays live where the JAX version's bounded wait
(``CTRL_STATS_TIMEOUT_S``) serves a stale one.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.obs.continuous import ContinuousProfiler, register_profiler
from githubrepostorag_tpu_torch.obs.engine_profile import (
    CompileWatchdog,
    EngineStepProfiler,
    plan_caches,
)
from githubrepostorag_tpu_torch.obs.hbm import PageObservatory, get_hbm_plane
from githubrepostorag_tpu_torch.obs.ledger import TokenLedger, engine_snapshot, flops_per_token
from githubrepostorag_tpu_torch.obs.slo import SLOMonitor, get_slo_plane
from githubrepostorag_tpu_torch.resilience.faults import InjectedFault, fire_sync
from githubrepostorag_tpu_torch.serving.engine import Engine, GenerationResult
from githubrepostorag_tpu_torch.serving.routing import ReplicaDigest
from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams
from githubrepostorag_tpu_torch.serving.spmd import apply_op

logger = logging.getLogger(__name__)


@dataclass
class StreamEvent:
    type: str  # "token" | "parked" | "final"
    token_id: int | None = None
    result: GenerationResult | None = None


class AsyncEngine:
    def __init__(self, engine: Engine, replica: str = "r0") -> None:
        self.engine = engine  # driven by the driver thread
        self.replica = replica  # the metrics' and the planes' replica label
        # (request id, operation as data for spmd.apply_op, is an
        # admission) the driver applies before its next step
        self._inbox: deque[tuple[str, tuple, bool]] = deque()
        # held by the driver over each iteration (module docstring)
        self._lock = threading.Lock()
        # admissions in the inbox; with the engine's queues under
        # _admit_lock, so load() counts each request once
        self._admit_lock = threading.Lock()
        self._unapplied = 0
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._queues: dict[str, asyncio.Queue[StreamEvent]] = {}
        self._priority: dict[str, str | None] = {}  # SLO class per request
        self.driver_error: str | None = None
        # the observability planes, federated per replica (module docstring)
        # the watchdog also counts the engine's dispatch shapes
        self.profiler = EngineStepProfiler(
            CompileWatchdog(plan_caches() + [
                ("engine.dispatch_shapes", lambda: len(getattr(engine, "dispatch_shapes", ())))]),
            replica=replica)
        s = get_settings()
        fpt = s.model_flops_per_token or (
            flops_per_token(engine.cfg) if getattr(engine, "cfg", None) else 0.0)
        self.ledger = TokenLedger(replica, flops_per_tok=fpt,
                                  peak_flops=s.chip_peak_tflops * 1e12,
                                  window_s=s.slo_ledger_window_s)
        self.slo = SLOMonitor(replica)
        self.page_obs = PageObservatory(replica)
        if hasattr(engine, "attach_page_observer"):
            engine.attach_page_observer(self.page_obs)
        self.page_obs.attach_pool_view(self._pool_view)
        get_hbm_plane().register(replica, self.page_obs)
        self.continuous = ContinuousProfiler(replica)
        register_profiler(replica, self.continuous)
        # the fleet router's view of the allocator's chain hashes
        self.digest = ReplicaDigest(replica)
        # set by the fleet on the event loop; other threads only read them
        self.role = "fused"  # "fused" | "prefill" | "decode"
        self.lifecycle = "active"
        # time.monotonic() at the top of the driver's latest iteration
        self.heartbeat: float | None = None
        # held around each step when set: the fleet gives the replicas of
        # one device one lock (serving/multi_engine.py)
        self.step_lock: threading.Lock | None = None
        get_slo_plane().register(replica, ledger=self.ledger, monitor=self.slo,
                                 stats=self.stats, digest=self.digest)
        # host seconds of the steps that had work, and of the obs hooks
        # after them (the planes' cost a step)
        self.step_seconds_total = 0.0
        self.obs_seconds_total = 0.0
        self.steps_total = 0
        # a mesh's leader (serving/spmd.Leader): what each step applied,
        # sent to the other ranks before the step runs
        self.lockstep = None
        self._applied: list[tuple] = []

    def _pool_view(self) -> dict:
        """Advisory allocator snapshot for the page observatory's payload:
        lock-free attribute reads and one list copy, so /debug/hbm renders
        while the driver steps."""
        alloc = self.engine._allocator
        free = list(getattr(alloc, "_free", ()))
        lru = getattr(alloc, "_lru", None)
        out = {
            "num_pages": alloc.num_pages,
            "free": alloc.free_count,
            "plain_free": len(free),
            "cached_lru": len(lru) if lru is not None else 0,
            "host_pages": getattr(alloc, "host_pages", 0),
            "free_pages": free,
            "hit_tokens": getattr(alloc, "hit_tokens", 0),
        }
        for k in ("fault_ins", "writebacks", "dedup_hits", "host_evictions",
                  "tier_drops", "page_imports", "import_dedup_skips",
                  "preempt_parked_pages"):
            out[k] = getattr(alloc, k, 0)
        return out

    async def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        # re-baseline the compile watchdog: first-time work before serving
        # (warmup, another engine's warmup in this process) is expected
        self.profiler.mark_warm()
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
        eng = self.engine
        pressure_next = digest_next = 0.0
        digest_interval = get_settings().route_digest_interval_s
        fault_site = f"fleet.step.{self.replica}"
        while not self._stop:
            self.heartbeat = time.monotonic()
            with self._lock:
                try:
                    fire_sync(fault_site)
                except InjectedFault as exc:
                    # the chaos model of a dead replica: leave the evidence
                    # and exit; the controller fences its requests
                    self.driver_error = str(exc)
                    logger.error("replica %s driver killed: %s", self.replica, exc)
                    return
                self._apply_inbox()
                step_start = time.monotonic()
                try:
                    pressure = None
                    if step_start >= pressure_next:
                        # burn-rate states feed the engine's preemption
                        # trigger and headroom doubling
                        pressure = self.slo.class_states()
                        eng.set_class_pressure(pressure)
                        pressure_next = time.monotonic() + 0.25
                    has_work = eng.has_work()
                    finished = []
                    waited = 0.0
                    if self.lockstep is not None:
                        # the other ranks apply the same and step with us
                        step_start = time.monotonic()
                        applied, self._applied = self._applied, []
                        self.lockstep.publish(applied, pressure, step_start, has_work)
                        if has_work:
                            finished = eng.step(now=step_start)
                    elif has_work:
                        lock, waited = self._take_step_lock()
                        try:
                            step_start = time.monotonic()
                            finished = eng.step()
                        finally:
                            if lock is not None:
                                lock.release()
                except Exception as exc:  # noqa: BLE001 - fail every waiter, never hang
                    logger.exception("engine driver failed")
                    self.driver_error = repr(exc)
                    self.fail_in_flight(self.driver_error)
                    return
                step_end = time.monotonic()
                parked = eng.drain_park_events()
                if step_end >= digest_next:
                    self._publish_digest()
                    digest_next = step_end + digest_interval
            for rid in parked:
                # advisory: the request is parked in the host tier and will
                # resume token for token; consumers keep waiting
                self._emit(rid, StreamEvent(type="parked"))
            try:
                self._observe_step(has_work, step_start, step_end, finished, waited)
            except Exception:  # noqa: BLE001 - a failing plane never stops serving
                logger.exception("observability hook failed on replica %s", self.replica)
            for res in finished:
                self._emit(res.request_id, StreamEvent(type="final", result=res))
            if not has_work and not self._inbox:
                self._wake.wait(timeout=0.02)
                self._wake.clear()

    def _take_step_lock(self) -> tuple[threading.Lock | None, float]:
        """Take the step lock the fleet set; return it (None when there is
        none) and the seconds waited for it, stamping the heartbeat every
        50 ms while a peer steps (module docstring)."""
        t0 = time.monotonic()
        while True:
            lock = self.step_lock
            if lock is None or lock.acquire(timeout=0.05):
                return lock, time.monotonic() - t0
            self.heartbeat = time.monotonic()

    def _observe_step(self, has_work: bool, step_start: float, step_end: float,
                      finished: list[GenerationResult], waited: float = 0.0) -> None:
        """The JAX driver's per-step hooks, after the step: the series, the
        step profiler, the ledger and the continuous profiler (or their
        idle calls), and each finished request into the SLO monitor.
        ``waited``: the seconds before the step spent on a peer's turn at
        the step lock, which the profiler and the ledger keep out of the
        scheduler stall (JAX's replicas, each on its own chips, wait for
        none, and the router would read the wait as a stall limiter)."""
        eng = self.engine
        t0 = time.monotonic()
        self._export.step(finished)
        if has_work:
            snap = engine_snapshot(eng)
            alloc = eng._allocator
            compiles = self.profiler.on_step(step_start, step_end, waited_s=waited)
            self.ledger.on_step(snap, step_start, step_end, compiles=compiles,
                                waited_s=waited)
            self.continuous.on_step(
                step_end, self.ledger.last_rec or {},
                queue=(eng.num_running, eng.num_waiting, eng.num_parked),
                pool=(alloc.free_count, getattr(alloc, "host_pages", 0)))
        else:
            self.profiler.idle()
            self.ledger.idle()
        for res in finished:
            self.slo.observe(self._priority.pop(res.request_id, None) or "interactive",
                             ttft_s=res.ttft_s, tpot_s=_tpot(res),
                             deadline_missed=res.finish_reason == "deadline")
        # burn rates keep decaying while nothing finishes
        self.slo.maybe_refresh()
        if has_work:
            self.steps_total += 1
            self.step_seconds_total += step_end - step_start
            self.obs_seconds_total += time.monotonic() - t0

    def _publish_digest(self) -> None:
        """Publish the allocator's chain-hash populations for the router
        (driver thread; the digest's lock is the handoff)."""
        alloc = self.engine._allocator
        res_fn = getattr(alloc, "resident_chain_hashes", None)
        host_fn = getattr(alloc, "host_chain_hashes", None)
        if res_fn is None and host_fn is None:
            return
        t0 = time.monotonic()
        resident = res_fn() if res_fn else frozenset()
        host = host_fn() if host_fn else frozenset()
        self.digest.publish(resident, host, time.monotonic() - t0)

    def _apply_inbox(self) -> None:
        """Run the queued submissions and cancellations in order
        (``spmd.apply_op``, which a lockstep's followers run on the same
        data); one that raises ends its own request with an error, not the
        driver.  Under a lockstep leader each applied operation is also kept
        for the other ranks."""
        while self._inbox:
            rid, op, admits = self._inbox.popleft()
            if self.lockstep is not None:
                self._applied.append(op)
            try:
                if admits:
                    with self._admit_lock:
                        self._unapplied -= 1
                        apply_op(self.engine, op, on_token=self._on_token)
                else:
                    apply_op(self.engine, op)
            except Exception as exc:  # noqa: BLE001 - one bad request must not stop serving
                logger.exception("engine rejected %s", rid)
                res = GenerationResult(request_id=rid, prompt_tokens=[], output_tokens=[],
                                       finish_reason="error", error=repr(exc))
                self._emit(rid, StreamEvent(type="final", result=res))

    def _on_token(self, rid: str, token_id: int) -> None:
        self._emit(rid, StreamEvent(type="token", token_id=token_id))

    def _submit(self, rid: str, op: tuple, admits: bool = False) -> None:
        if admits:
            with self._admit_lock:
                self._unapplied += 1
        self._inbox.append((rid, op, admits))
        self._wake.set()

    def load(self) -> int:
        """Requests on this replica: running, waiting, and submitted but
        not applied yet."""
        with self._admit_lock:
            return self.engine.num_running + self.engine.num_waiting + self._unapplied

    def driver_alive(self) -> bool:
        """True while the driver thread runs.  A driver killed by the
        ``fleet.step.<replica>`` seam exits, so this turns false without
        ``stop()``."""
        t = self._thread
        return t is not None and t.is_alive()

    def fail_in_flight(self, reason: str) -> list[str]:
        """End every in-flight request with the standard error frame (a
        final result with finish_reason "error") and return their ids, so
        no caller waits on a dead or wedged driver.  Takes no lock: the
        driver may be wedged holding one."""
        failed = list(self._queues)
        for rid in failed:
            res = GenerationResult(request_id=rid, prompt_tokens=[], output_tokens=[],
                                   finish_reason="error", error=reason)
            self._emit(rid, StreamEvent(type="final", result=res))
        return failed

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
        on_admit: Callable[[str], None] | None = None,
    ) -> AsyncIterator[StreamEvent]:
        """Submit a request and yield its token events, then the final
        event.  ``deadline_s`` (absolute time.monotonic()) lets the engine
        reap the request once its caller's budget is gone; ``priority`` is
        its SLO class (the engine's default class when None).
        ``on_admit(rid)`` fires on the event loop once the request counts
        in ``load()``: the router retires its pending pick there.  A stream
        closed before its final event cancels the request (the JAX version
        leaves the row decoding to its end)."""
        await self.start()
        if self.driver_error is not None:
            raise RuntimeError(f"engine driver is dead: {self.driver_error}")
        q: asyncio.Queue[StreamEvent] = asyncio.Queue()
        rid = request_id or f"req-{uuid.uuid4().hex}"

        if priority is None:
            is_longctx = getattr(self.engine, "is_longctx", None)
            if callable(is_longctx) and is_longctx(len(prompt_ids)):
                # a ring-bound request counts against the longctx class
                priority = "longctx"
        # the class the engine stamps, so the SLO plane observes the same
        priority = priority or getattr(self.engine, "default_priority", "interactive")
        self._queues[rid] = q
        self._priority[rid] = priority
        if self.driver_error is not None:  # it died before the queue was there to fail
            self._queues.pop(rid, None)
            raise RuntimeError(f"engine driver is dead: {self.driver_error}")
        self._submit(rid, ("add", list(prompt_ids), sampling, rid, deadline_s, priority),
                     admits=True)
        if on_admit is not None:
            on_admit(rid)
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
            self._priority.pop(rid, None)
            if not done:
                # the consumer left first (its task was cancelled or it
                # closed the stream): end the row so its pages come back
                self._submit(rid, ("cancel", rid))

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
        self._submit(request_id, ("cancel", request_id))

    async def export_kv_pages(self, hashes: list[bytes]) -> list[tuple[bytes, object]]:
        """Pack the KV payloads of ``hashes`` for a peer replica, off the
        loop and under the driver lock, so no step migrates or evicts the
        pages under the gather."""

        def work() -> list[tuple[bytes, object]]:
            with self._lock:
                return self.engine.export_kv_pages(hashes)

        return await asyncio.get_running_loop().run_in_executor(None, work)

    async def import_kv_pages(self, pages: list[tuple[bytes, object]]) -> int:
        """Admit a peer's page payloads into this replica's host tier
        (host work, but the allocator belongs to the driver)."""

        def work() -> int:
            with self._lock:
                return self.engine.import_kv_pages(pages)

        return await asyncio.get_running_loop().run_in_executor(None, work)

    def stats(self) -> dict[str, Any]:
        """Queue, page, speculation, host-tier and preemption counters for
        ``/health``, with the JAX version's keys."""
        eng = self.engine
        alloc = eng._allocator
        return {
            "role": self.role,
            "running": eng.num_running,
            "waiting": eng.num_waiting,
            "requests_admitted": eng.requests_admitted,
            "free_pages": alloc.free_count,
            "total_pages": alloc.num_pages,
            "prefix_cache_hit_tokens": getattr(alloc, "hit_tokens", 0),
            "sp_prefills": eng.sp_prefills,
            "sp_ring_segments": eng.sp_ring_segments,
            "sp_ring_tokens": eng.sp_ring_tokens,
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


def _tpot(res: GenerationResult) -> float | None:
    """Decode seconds a token after the first (the prefill's), or None."""
    decoded = len(res.output_tokens) - 1
    return res.decode_time_s / decoded if decoded > 0 and res.decode_time_s > 0 else None


class _CounterExport:
    """The engine's series after each step (the JAX driver's
    ``export_counters``): running and waiting rows; each finished
    request's tokens, TTFT and TPOT; and the cumulative counters as deltas
    -- the speculative ones while a speculative mode is on, the host
    tier's (and the handoff's transfer seconds) while the tier is on, the
    preemption ones while preemption is on.  A mode series' replica child is made at its first export, so an
    engine that runs none of these modes adds none of their samples to
    ``/metrics``."""

    def __init__(self, engine: Engine, replica: str) -> None:
        self.engine = engine
        self.replica = replica
        self.last = {"prop": 0, "acc": 0, "fb": {}, "kv_fault": 0, "kv_wb": 0, "kv_dedup": 0,
                     "kv_hold": 0, "kv_mig_s": 0.0, "xfer_s": 0.0, "preempts": 0, "resumes": 0}

    def _child(self, metric, **labels):
        return metric.labels(replica=self.replica, **labels)

    def _inc(self, metric, key: str, value) -> None:
        if value > self.last[key]:
            self._child(metric).inc(value - self.last[key])
            self.last[key] = value

    def step(self, finished: list[GenerationResult]) -> None:
        from githubrepostorag_tpu_torch import metrics as m

        eng, last = self.engine, self.last
        self._child(m.ENGINE_RUNNING).set(eng.num_running)
        self._child(m.ENGINE_WAITING).set(eng.num_waiting)
        for res in finished:
            self._child(m.DECODE_TOKENS).inc(len(res.output_tokens))
            if res.ttft_s is not None:
                self._child(m.TTFT).observe(res.ttft_s)
            tpot = _tpot(res)
            if tpot is not None:
                self._child(m.TPOT).observe(tpot)
        if eng.spec_ngram_k > 0 or eng._draft_enabled:
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
            # the disaggregated handoff's pack / unpack host time
            self._inc(m.DISAGG_TRANSFER_SECONDS, "xfer_s", eng.transfer_seconds_total)
        if eng._preempt_on:
            self._inc(m.ENGINE_PREEMPTIONS, "preempts", eng.preemptions)
            self._inc(m.ENGINE_PREEMPT_RESUMES, "resumes", eng.preempt_resumes)
