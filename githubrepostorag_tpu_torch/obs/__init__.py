"""Observability: distributed tracing, the per-job flight recorder and
trace-stamped JSON logging; port of ``githubrepostorag_tpu/obs/__init__.py``.

One trace per job, causally linked across every hop the job takes: the
API opens the root span, the queue envelope carries the context
(``TraceContext.to_wire`` rides ``kwargs["trace"]`` exactly like
``Deadline`` rides ``kwargs["deadline"]``), the worker continues it, the
agent wraps its stages, and the in-process LLM attributes the engine's
queue-wait / prefill / decode (``engine_profile.record_engine_spans``).
Completed spans land in a bounded in-process flight recorder exposed at
``GET /debug/traces``.  The JAX package's other planes (token ledger, SLO
plane, continuous profiler, HBM observatory, timeline) come with ROADMAP
queue 1 item 6.
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

__all__ = [
    "FlightRecorder",
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
