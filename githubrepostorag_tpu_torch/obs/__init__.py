"""Observability: distributed tracing, the per-job flight recorder, the
engine's step profiler, the token ledger, the SLO plane, the continuous
profiler, the page observatory, the timeline and trace-stamped JSON
logging; port of ``githubrepostorag_tpu/obs/__init__.py``.

One trace per job, causally linked across every hop the job takes: the
API opens the root span, the queue envelope carries the context
(``TraceContext.to_wire`` rides ``kwargs["trace"]`` exactly like
``Deadline`` rides ``kwargs["deadline"]``), the worker continues it, the
agent wraps its stages, and the in-process LLM attributes the engine's
queue-wait / prefill / decode (``engine_profile.record_engine_spans``).
Completed spans land in a bounded in-process flight recorder exposed at
``GET /debug/traces``.  Each engine driver (serving/async_engine.py)
registers its ledger, SLO monitor, page observatory and continuous
profiler here; ``/debug/slo``, ``/debug/fleet``, ``/debug/hbm`` and
``/debug/timeline`` render them.
"""

from githubrepostorag_tpu_torch.obs.trace import (
    NOOP_SPAN,
    Span,
    TraceContext,
    current_context,
    current_span,
    record_span,
    root_span,
    span,
    trace_scope,
)
from githubrepostorag_tpu_torch.obs.recorder import FlightRecorder, get_recorder, reset_recorder
from githubrepostorag_tpu_torch.obs.ledger import TokenLedger
from githubrepostorag_tpu_torch.obs.slo import (
    SLOMonitor,
    SLOPlane,
    get_slo_plane,
    reset_slo_plane,
)
from githubrepostorag_tpu_torch.obs.continuous import (
    ContinuousProfiler,
    profilers,
    register_profiler,
    reset_profilers,
    unregister_profiler,
)
from githubrepostorag_tpu_torch.obs.hbm import (
    PageObservatory,
    get_hbm_plane,
    reset_hbm_plane,
)
from githubrepostorag_tpu_torch.obs.timeline import (
    build_timeline,
    dump_timeline,
    reset_fleet_events_provider,
    set_fleet_events_provider,
)

__all__ = [
    "ContinuousProfiler",
    "FlightRecorder",
    "PageObservatory",
    "SLOMonitor",
    "SLOPlane",
    "TokenLedger",
    "build_timeline",
    "dump_timeline",
    "get_hbm_plane",
    "get_slo_plane",
    "profilers",
    "register_profiler",
    "reset_fleet_events_provider",
    "reset_hbm_plane",
    "reset_profilers",
    "reset_slo_plane",
    "set_fleet_events_provider",
    "unregister_profiler",
    "NOOP_SPAN",
    "Span",
    "TraceContext",
    "current_context",
    "current_span",
    "get_recorder",
    "record_span",
    "reset_recorder",
    "root_span",
    "span",
    "trace_scope",
]
