"""W3C-traceparent-style distributed tracing; a copy of
``githubrepostorag_tpu/obs/trace.py``.

``TraceContext`` is the identity that travels: a 128-bit trace id, the
64-bit span id of the current parent, and a flags byte whose low bit is
the sampled decision (the W3C ``traceparent`` layout, so the wire form is
one recognizable string).  Crossing the queue is ``to_wire()`` /
``from_wire()`` riding the job envelope's kwargs exactly like
``Deadline`` does (resilience/policy.py); inside a process the context
rides a contextvar scope — per-thread by construction, so the engine
driver thread never inherits a request's scope, while the worker can
hand the context into the agent's executor thread explicitly (the same
hand-off discipline as ``deadline_scope``).

``Span`` is the recorder: name, attrs, events, status, and monotonic
start/end (wall clocks drift and step backwards; every duration here is
``time.monotonic``).  Finished spans are handed to the flight recorder
(obs/recorder.py).

Cost discipline: with no active scope — TRACE_SAMPLE=0, or simply
nothing upstream opened a trace — ``span()`` is one contextvar read and
yields a shared no-op singleton: no allocation, no lock, no recorder
touch.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import re
import time
from typing import Any, Iterator

_TRACEPARENT_RE = re.compile(
    r"^00-(?P<trace_id>[0-9a-f]{32})-(?P<span_id>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$"
)

FLAG_SAMPLED = 0x01

# Span/event caps: a runaway loop must not balloon one trace's memory —
# the recorder additionally caps spans per trace (O(1) per-trace memory).
MAX_EVENTS_PER_SPAN = 32
MAX_ATTRS_PER_SPAN = 32

_ids = random.Random()  # os-seeded; ids need uniqueness, not crypto


def _new_trace_id() -> str:
    return f"{_ids.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_ids.getrandbits(64):016x}"


def _sample_rate() -> float:
    # read the env directly (not get_settings) so TRACE_SAMPLE=0 keeps the
    # root-creation path config-singleton-free and tests can flip it with
    # reload-free monkeypatching
    try:
        return float(os.environ.get("TRACE_SAMPLE", "1"))
    except ValueError:
        return 1.0


class TraceContext:
    """Immutable (trace_id, span_id, flags) triple.  ``span_id`` is the id
    of the span that children should parent to — empty string for a fresh
    root that has no parent yet."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str = "", flags: int = FLAG_SAMPLED) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    @classmethod
    def new_root(cls) -> "TraceContext":
        rate = _sample_rate()
        sampled = rate >= 1.0 or (rate > 0.0 and _ids.random() < rate)
        return cls(_new_trace_id(), "", FLAG_SAMPLED if sampled else 0)

    def child(self, span_id: str) -> "TraceContext":
        return TraceContext(self.trace_id, span_id, self.flags)

    # ------------------------------------------------------------- wire --

    def to_header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id or '0' * 16}-{self.flags:02x}"

    def to_wire(self) -> dict[str, str]:
        """Queue-envelope form, riding ``kwargs["trace"]`` next to
        ``kwargs["deadline"]``.  Pure identifiers — no clocks — so unlike
        ``Deadline.to_wire`` there is no transit correction to make."""
        return {"traceparent": self.to_header()}

    @classmethod
    def from_header(cls, value: str | None) -> "TraceContext | None":
        if not isinstance(value, str):
            return None
        m = _TRACEPARENT_RE.match(value.strip().lower())
        if m is None:
            return None
        return cls(m.group("trace_id"), m.group("span_id"), int(m.group("flags"), 16))

    @classmethod
    def from_wire(cls, wire: Any) -> "TraceContext | None":
        """Tolerant inverse of ``to_wire``: accepts the dict form, a bare
        traceparent string, or anything else (old-format envelopes carry
        no trace field at all) -> None, never a raise."""
        if isinstance(wire, str):
            return cls.from_header(wire)
        if isinstance(wire, dict):
            return cls.from_header(wire.get("traceparent"))
        return None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.to_header()})"


class Span:
    """One recorded operation.  Durations are monotonic; ``wall_t`` stamps
    the start once with the epoch clock purely for display (never used in
    arithmetic)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "flags",
                 "start", "end", "wall_t", "attrs", "events", "status")

    def __init__(self, name: str, context: TraceContext,
                 start: float | None = None) -> None:
        self.name = name
        self.trace_id = context.trace_id
        self.span_id = _new_span_id()
        self.parent_id = context.span_id or None
        self.flags = context.flags
        self.start = time.monotonic() if start is None else start
        self.end: float | None = None
        self.wall_t = time.time()  # display stamp only, never subtracted
        self.attrs: dict[str, Any] = {}
        self.events: list[dict[str, Any]] = []
        self.status = "ok"

    @property
    def context(self) -> TraceContext:
        """The context children of this span should carry."""
        return TraceContext(self.trace_id, self.span_id, self.flags)

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    def set_attr(self, key: str, value: Any) -> None:
        if len(self.attrs) < MAX_ATTRS_PER_SPAN:
            self.attrs[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        if len(self.events) < MAX_EVENTS_PER_SPAN:
            self.events.append({"name": name, "t": time.monotonic(), **attrs})

    def set_status(self, status: str) -> None:
        self.status = status

    def duration_s(self) -> float:
        return (self.end if self.end is not None else time.monotonic()) - self.start

    def finish(self, end: float | None = None) -> None:
        if self.end is not None:
            return  # idempotent: generators may finalize twice
        self.end = time.monotonic() if end is None else end
        from githubrepostorag_tpu_torch.obs.recorder import get_recorder

        get_recorder().record(self)


class _NoopSpan:
    """Shared do-nothing span for the unsampled/untraced fast path."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    status = "ok"
    sampled = False
    context = None

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attrs: Any) -> None:
        pass

    def set_status(self, status: str) -> None:
        pass

    def duration_s(self) -> float:
        return 0.0

    def finish(self, end: float | None = None) -> None:
        pass


NOOP_SPAN = _NoopSpan()

# The active scope: a Span (in-flight) or a bare TraceContext (handed into
# a thread that has not opened its first span yet).  Contextvars give each
# thread its own binding, and asyncio tasks inherit their creator's —
# exactly the propagation tracing wants.
_ACTIVE: contextvars.ContextVar[Span | TraceContext | None] = contextvars.ContextVar(
    "rag_trace_scope", default=None
)


def current_span() -> Span | None:
    active = _ACTIVE.get()
    return active if isinstance(active, Span) else None


def current_context() -> TraceContext | None:
    """The context a child span (or a queue hop) should carry right now."""
    active = _ACTIVE.get()
    if isinstance(active, Span):
        return active.context
    return active


@contextlib.contextmanager
def trace_scope(context: TraceContext | None) -> Iterator[TraceContext | None]:
    """Bind ``context`` as the active scope for the duration — the
    explicit hand-off used when work crosses into an executor thread
    (agent.run), mirroring ``deadline_scope``."""
    if context is None:
        yield None
        return
    token = _ACTIVE.set(context)
    try:
        yield context
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span | _NoopSpan]:
    """Open a child span of the active scope.  No active scope, or an
    unsampled one -> the shared no-op span (one contextvar read)."""
    active = _ACTIVE.get()
    if active is None:
        yield NOOP_SPAN
        return
    ctx = active.context if isinstance(active, Span) else active
    if not ctx.sampled:
        yield NOOP_SPAN
        return
    sp = Span(name, ctx)
    for key, value in attrs.items():
        sp.set_attr(key, value)
    token = _ACTIVE.set(sp)
    try:
        yield sp
    except BaseException as exc:
        sp.set_status(f"error: {type(exc).__name__}")
        raise
    finally:
        _ACTIVE.reset(token)
        sp.finish()


@contextlib.contextmanager
def root_span(name: str, wire: Any = None, **attrs: Any) -> Iterator[Span | _NoopSpan]:
    """Open a root span: continue the trace ``wire`` carries (queue
    envelope dict or traceparent header string), else start a new one."""
    ctx = TraceContext.from_wire(wire) or TraceContext.new_root()
    with trace_scope(ctx):
        with span(name, **attrs) as sp:
            yield sp


def record_span(name: str, start: float, end: float,
                parent: TraceContext | None = None,
                attrs: dict[str, Any] | None = None,
                status: str = "ok") -> "Span | None":
    """Record a retroactive span from already-measured monotonic
    timestamps (engine queue/prefill/decode attribution, coalescer wave
    timing) under ``parent`` or the active scope.  Returns the finished
    span so callers can stamp events on it (record_engine_spans annotates
    the decode span with speculation outcomes); None when untraced."""
    ctx = parent if parent is not None else current_context()
    if ctx is None or not ctx.sampled:
        return None
    sp = Span(name, ctx, start=start)
    if attrs:
        for key, value in attrs.items():
            sp.set_attr(key, value)
    sp.status = status
    sp.finish(end=end)
    return sp
