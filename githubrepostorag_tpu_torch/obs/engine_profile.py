"""Serving-engine step instrumentation; port of
``githubrepostorag_tpu/obs/engine_profile.py``.

Three concerns, all driven from the engine driver thread
(``AsyncEngine._drive``) so the event loop never pays for them:

* **Per-request phase attribution** -- the engine stamps monotonic
  timestamps as a request moves waiting -> prefilling -> first token ->
  done (``GenerationResult.timings``); ``record_engine_spans`` turns
  those into retroactive ``engine.queue_wait`` / ``engine.prefill`` /
  ``engine.decode`` spans under the request's trace.

* **Scheduler-stall gauge** -- the gap between consecutive steps while
  work exists is scheduler stall (host scheduling between dispatches,
  invisible in aggregate latency histograms).

* **Compile watchdog** -- the port compiles no program per shape, as XLA
  does; what it pays the first time the card meets a shape is a kernel
  library's build or load (``kernels.launcher``) and a launch plan
  (``_plan_window`` for kernels A and C, ``_plan_decode`` for B and F,
  ``_plan_int4_shape`` for D, ``_plan_w4a8_shape`` for E: each cached by
  its static shape), and an engine dispatch shape (``AsyncEngine`` adds
  the count of ``Engine.dispatch_shapes``, on the CPU too).  The watchdog
  sums the libraries loaded, every plan cache's misses and the shapes
  each step; a positive delta after ``mark_warm`` means live traffic
  reached a kernel or a dispatch shape that ``Engine.warmup()`` did not
  run.  It keeps the JAX series name,
  ``rag_xla_compiles_total``, so ``/metrics`` reads the same; every
  registered in-flight span gets an ``xla_compile`` event.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING, Any, Callable

from githubrepostorag_tpu_torch.obs.trace import TraceContext, record_span

if TYPE_CHECKING:  # pragma: no cover - typing only
    from githubrepostorag_tpu_torch.obs.trace import Span

logger = logging.getLogger(__name__)


def plan_caches() -> list[tuple[str, Callable[[], int]]]:
    """The first-time work the card can meet while serving, each as a
    zero-arg count that only grows: kernel libraries loaded, and the
    misses of every kernel's launch-plan cache.  Takes the place of the
    JAX package's ``discover_jits``."""
    from githubrepostorag_tpu_torch import kernels
    from githubrepostorag_tpu_torch.ops import fused_decode, int4_matmul, paged_decode

    def misses(fn) -> Callable[[], int]:
        return lambda: fn.cache_info().misses

    return [
        ("kernels.launcher", lambda: len(kernels._launchers)),
        ("fused_decode._plan_window", misses(fused_decode._plan_window)),
        ("paged_decode._plan_decode", misses(paged_decode._plan_decode)),
        ("int4_matmul._plan_int4_shape", misses(int4_matmul._plan_int4_shape)),
        ("int4_matmul._plan_w4a8_shape", misses(int4_matmul._plan_w4a8_shape)),
    ]


class CompileWatchdog:
    """Tracks the first-time work the card has met (libraries loaded, plan
    cache misses) and reports fresh work as deltas between samples."""

    def __init__(self, caches: list[tuple[str, Callable[[], int]]] | None = None) -> None:
        self._caches = plan_caches() if caches is None else list(caches)
        # resync() runs on the event loop (serve start / mark_warm) while
        # sample() runs on the driver thread every step; _last needs a lock
        # or a resync racing a sample mis-attributes warmup compiles to
        # live traffic
        self._lock = threading.Lock()
        self._last = self.cache_size()

    def cache_size(self) -> int:
        total = 0
        for _, count in self._caches:
            try:
                total += int(count())
            except Exception:  # noqa: BLE001 - a cache that fails to read counts 0
                pass
        return total

    def resync(self) -> None:
        """Rebaseline -- called at serve start so warmup's own first-time
        work (expected, pre-traffic) never counts as live traffic's."""
        size = self.cache_size()
        with self._lock:
            self._last = size

    def sample(self) -> int:
        """New first-time work since the previous sample (>= 0)."""
        size = self.cache_size()
        with self._lock:
            delta = size - self._last
            self._last = size
        return max(0, delta)


class EngineStepProfiler:
    """Per-step hook owned by ``AsyncEngine``.  ``on_step`` runs once per
    engine step on the driver thread; in-flight request spans register so
    compile events land on the request that met them."""

    def __init__(self, watchdog: CompileWatchdog | None = None,
                 replica: str = "r0") -> None:
        self.watchdog = watchdog or CompileWatchdog()
        self.replica = replica
        self._lock = threading.Lock()
        self._live: dict[int, "Span"] = {}
        self._last_step_end: float | None = None

    # ----------------------------------------------------- live requests --

    def register(self, span: "Span") -> None:
        with self._lock:
            self._live[id(span)] = span

    def unregister(self, span: "Span") -> None:
        with self._lock:
            self._live.pop(id(span), None)

    def mark_warm(self) -> None:
        """Declare warmup finished: first-time work observed after this is
        live traffic's.  ``AsyncEngine.start`` calls it, so each engine
        started in one process re-baselines over the others' warmups."""
        self.watchdog.resync()
        with self._lock:
            self._last_step_end = None

    # ------------------------------------------------------------- steps --

    def on_step(self, step_start: float, step_end: float, waited_s: float = 0.0) -> int:
        """Record stall + compile telemetry for one completed engine step.
        ``waited_s`` of the gap before it went to a peer replica's turn at
        the fleet's step lock and is no stall.  Returns the first-time work
        observed (for tests)."""
        from githubrepostorag_tpu_torch.metrics import SCHED_STALL, XLA_COMPILES

        with self._lock:
            prev = self._last_step_end
            self._last_step_end = step_end
        if prev is not None:
            SCHED_STALL.labels(replica=self.replica).set(max(0.0, step_start - prev - waited_s))

        delta = self.watchdog.sample()
        if delta > 0:
            XLA_COMPILES.labels(replica=self.replica).inc(delta)
            with self._lock:
                live = list(self._live.values())
            for sp in live:
                sp.add_event("xla_compile", new_programs=delta,
                             step_s=round(step_end - step_start, 6))
            logger.warning(
                "first-time kernel work during live traffic: %d new plan(s) or "
                "library load(s) in a %.3fs step (warmup should have run this shape)",
                delta, step_end - step_start,
            )
        return delta

    def idle(self) -> None:
        """The driver found no work — the next gap is idleness, not stall."""
        with self._lock:
            self._last_step_end = None
        from githubrepostorag_tpu_torch.metrics import SCHED_STALL

        SCHED_STALL.labels(replica=self.replica).set(0.0)


def record_engine_spans(result: Any, parent: TraceContext | None) -> None:
    """Turn a ``GenerationResult``'s monotonic phase stamps into
    queue-wait / prefill / decode spans under ``parent``.  Tolerates
    partial timings (errored or reaped requests may never prefill)."""
    timings = getattr(result, "timings", None)
    if not timings or parent is None or not parent.sampled:
        return
    submit = timings.get("submit_t")
    pstart = timings.get("prefill_start_t")
    ftok = timings.get("first_token_t")
    done = timings.get("done_t", time.monotonic())
    attrs = {"request_id": getattr(result, "request_id", "")}
    if submit is not None and pstart is not None:
        record_span("engine.queue_wait", submit, pstart, parent=parent, attrs=attrs)
    if pstart is not None and ftok is not None:
        psp = record_span("engine.prefill", pstart, ftok, parent=parent, attrs={
            **attrs, "prompt_tokens": len(getattr(result, "prompt_tokens", ()) or ()),
        })
        if psp is not None:
            # KV tiering: prefix pages this admission swapped in from the
            # host tier instead of recomputing
            faulted = getattr(result, "faulted_pages", 0)
            if faulted:
                psp.add_event("kv_fault_in", pages=faulted)
    if ftok is not None and done > ftok:
        sp = record_span("engine.decode", ftok, done, parent=parent, attrs={
            **attrs, "output_tokens": len(getattr(result, "output_tokens", ()) or ()),
            "finish_reason": getattr(result, "finish_reason", ""),
        })
        if sp is not None:
            # speculative-decoding outcome as events on the decode span
            proposed = getattr(result, "spec_proposed", 0)
            if proposed:
                sp.add_event(
                    "spec", proposed=proposed,
                    accepted=getattr(result, "spec_accepted", 0),
                    acceptance=round(
                        getattr(result, "spec_accepted", 0) / proposed, 4),
                )
            fallback = getattr(result, "spec_fallback", None)
            if fallback:
                sp.add_event("spec_fallback", reason=fallback)
