"""Bounded in-process flight recorder for completed spans; a copy of
``githubrepostorag_tpu/obs/recorder.py``.

A ring buffer of traces: the recorder keeps at most ``trace_max_traces``
traces (oldest evicted on arrival of a new trace id) and at most
``trace_max_spans`` spans per trace (further spans are counted as
dropped, not stored) — so memory is O(max_traces * max_spans_per_trace)
regardless of traffic, and recording stays a dict append under one lock.

Two render functions produce the JSON served by ``GET /debug/traces``
and ``GET /debug/traces/{trace_id}``.  ``phase_summary`` collapses
a trace into per-phase seconds (queue/plan/retrieve/judge/rewrite/
synthesize/prefill/decode) — the compact dict attached to each job's
terminal SSE event.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:  # pragma: no cover - typing only
    from githubrepostorag_tpu_torch.obs.trace import Span

# span name -> phase bucket for the compact per-job summary
_PHASE_BY_SPAN = {
    "engine.queue_wait": "queue",
    "engine.prefill": "prefill",
    "engine.decode": "decode",
    "agent.plan": "plan",
    "agent.retrieve": "retrieve",
    "agent.judge": "judge",
    "agent.rewrite": "rewrite",
    "agent.synthesize": "synthesize",
}


class _TraceEntry:
    __slots__ = ("spans", "dropped", "wall_t")

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.dropped = 0
        self.wall_t: float | None = None


class FlightRecorder:
    def __init__(self, max_traces: int | None = None,
                 max_spans_per_trace: int | None = None) -> None:
        if max_traces is None or max_spans_per_trace is None:
            from githubrepostorag_tpu_torch.config import get_settings

            settings = get_settings()
            if max_traces is None:
                max_traces = settings.trace_max_traces
            if max_spans_per_trace is None:
                max_spans_per_trace = settings.trace_max_spans
        self.max_traces = max(1, int(max_traces))
        self.max_spans_per_trace = max(1, int(max_spans_per_trace))
        self._lock = threading.Lock()
        self._traces: OrderedDict[str, _TraceEntry] = OrderedDict()
        self._dropped_traces = 0
        # high-water marks + cross-trace drop totals: /debug/traces must
        # say when its window wrapped, not silently look complete
        self._dropped_spans_total = 0
        self._span_watermark = 0
        self._trace_watermark = 0

    # ------------------------------------------------------------ write --

    def record(self, span: "Span") -> None:
        if not span.trace_id:
            return
        with self._lock:
            entry = self._traces.get(span.trace_id)
            if entry is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                    self._dropped_traces += 1
                entry = _TraceEntry()
                self._traces[span.trace_id] = entry
                self._trace_watermark = max(self._trace_watermark,
                                            len(self._traces))
            if entry.wall_t is None:
                entry.wall_t = span.wall_t
            if len(entry.spans) >= self.max_spans_per_trace:
                entry.dropped += 1
                self._dropped_spans_total += 1
                return
            entry.spans.append(span)
            self._span_watermark = max(self._span_watermark,
                                       len(entry.spans))

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._dropped_traces = 0
            self._dropped_spans_total = 0
            self._span_watermark = 0
            self._trace_watermark = 0

    # ------------------------------------------------------------- read --

    def trace_ids(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def export_spans(self) -> list[tuple[str, list["Span"], float]]:
        """Every retained trace as (trace_id, spans, wall_t), oldest trace
        first — the timeline exporter's raw-span source (monotonic start/
        end preserved; the renders above round and rebase)."""
        with self._lock:
            return [(tid, list(e.spans), e.wall_t or 0.0)
                    for tid, e in self._traces.items()]

    def _snapshot(self, trace_id: str) -> tuple[list["Span"], int, float] | None:
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            return list(entry.spans), entry.dropped, entry.wall_t or 0.0

    def phase_summary(self, trace_id: str) -> dict[str, float]:
        """Per-phase seconds for one trace; summed when a phase recurs
        (e.g. several retrieve waves).  Untracked span names are ignored."""
        snap = self._snapshot(trace_id)
        if snap is None:
            return {}
        phases: dict[str, float] = {}
        for sp in snap[0]:
            phase = _PHASE_BY_SPAN.get(sp.name)
            if phase is None or sp.end is None:
                continue
            phases[phase] = phases.get(phase, 0.0) + (sp.end - sp.start)
        return {k: round(v, 6) for k, v in phases.items()}

    def summaries_payload(self) -> dict[str, Any]:
        """The ``GET /debug/traces`` body: newest-first one-line-per-trace
        summaries plus the recorder's capacity so a reader can tell when
        the window wrapped."""
        with self._lock:
            ids = list(self._traces)
            dropped_traces = self._dropped_traces
            meta = {
                "evicted_traces": self._dropped_traces,
                "dropped_spans_total": self._dropped_spans_total,
                "trace_watermark": self._trace_watermark,
                "span_watermark": self._span_watermark,
                "trace_ring_utilization": round(
                    len(self._traces) / self.max_traces, 6),
                "span_watermark_utilization": round(
                    self._span_watermark / self.max_spans_per_trace, 6),
            }
        traces = []
        for trace_id in reversed(ids):
            snap = self._snapshot(trace_id)
            if snap is None:  # evicted between the two locks
                continue
            spans, dropped, wall_t = snap
            finished = [sp for sp in spans if sp.end is not None]
            t0 = min((sp.start for sp in spans), default=0.0)
            t1 = max((sp.end for sp in finished), default=t0)
            roots = [sp for sp in spans if sp.parent_id is None]
            root = min(roots, key=lambda sp: sp.start) if roots else None
            status = "ok"
            for sp in spans:
                if sp.status != "ok":
                    status = sp.status
                    break
            traces.append({
                "trace_id": trace_id,
                "root": root.name if root is not None else None,
                "span_count": len(spans),
                "dropped_spans": dropped,
                "start_wall_t": wall_t,
                "duration_s": round(max(0.0, t1 - t0), 6),
                "status": status,
                "phases": self.phase_summary(trace_id),
            })
        return {
            "capacity": {
                "max_traces": self.max_traces,
                "max_spans_per_trace": self.max_spans_per_trace,
            },
            "trace_count": len(traces),
            "dropped_traces": dropped_traces,
            "meta": meta,
            "traces": traces,
        }

    def trace_payload(self, trace_id: str) -> dict[str, Any] | None:
        """The ``GET /debug/traces/{trace_id}`` body: the full span tree,
        times rebased to the trace's first span start (``start_s`` is
        seconds into the trace, not an epoch)."""
        snap = self._snapshot(trace_id)
        if snap is None:
            return None
        spans, dropped, wall_t = snap
        t0 = min((sp.start for sp in spans), default=0.0)
        rendered = []
        for sp in sorted(spans, key=lambda s: s.start):
            rendered.append({
                "name": sp.name,
                "span_id": sp.span_id,
                "parent_id": sp.parent_id,
                "start_s": round(sp.start - t0, 6),
                "duration_s": round(sp.duration_s(), 6),
                "status": sp.status,
                "attrs": dict(sp.attrs),
                "events": [
                    {**ev, "t": round(ev["t"] - t0, 6)} for ev in sp.events
                ],
            })
        return {
            "trace_id": trace_id,
            "start_wall_t": wall_t,
            "span_count": len(rendered),
            "dropped_spans": dropped,
            "phases": self.phase_summary(trace_id),
            "spans": rendered,
        }


_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def reset_recorder() -> FlightRecorder:
    """Replace the process-wide recorder (tests; config reloads)."""
    global _recorder
    with _recorder_lock:
        _recorder = FlightRecorder()
    return _recorder
