"""Resilience primitives: retry, circuit breaking, and deadline budgets;
a copy of ``githubrepostorag_tpu/resilience/policy.py``.

The north star serves millions of users, where transient dependency failure
is the steady state, not the exception ([vllm-pagedattention]'s argument
applied to the control plane: throughput dies to stalls and orphaned work,
not FLOPs).  Three primitives, each process-cheap and asyncio-safe:

  - ``RetryPolicy`` — jittered exponential backoff (full jitter, seeded for
    deterministic tests).  ``delay_for`` is the schedule, ``call`` the async
    driver; sync callers iterate ``delays()`` themselves and sleep however
    their context allows (never ``time.sleep`` inside ``async def`` —
    tpulint ASY001 exists because that one bug froze the reference's loop).
  - ``CircuitBreaker`` — per-dependency closed/open/half-open with counted
    state transitions, registered in a process-wide registry so /health can
    report every breaker and go 503 while one is open.
  - ``Deadline`` — a wall-budget object threaded API -> queue -> worker ->
    agent -> LLM -> engine.  Crossing a process boundary uses ``to_wire``
    (budget + epoch stamp; monotonic clocks don't travel), inside a process
    it rides a thread-local scope so the LLM protocol signature stays
    unchanged.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Iterator

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.metrics import BREAKER_TRANSITIONS
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class DeadlineExceeded(Exception):
    """The request's wall budget ran out (checked between agent stages and
    at LLM submission; the engine reaps its own rows at step boundaries)."""


class CircuitOpen(ConnectionError):
    """Raised when a call is refused because the dependency's breaker is
    open.  Subclasses ConnectionError so callers that already treat
    connection failures as retryable/degradable handle it for free."""


# --------------------------------------------------------------------- retry


@dataclass
class RetryPolicy:
    """Jittered exponential backoff: delay(n) = uniform(d/2, d) with
    d = min(cap, base * 2**n) (AWS full-jitter, halved floor so retries
    never synchronize across workers).  ``seed`` pins the jitter stream for
    deterministic tests; production leaves it None."""

    max_attempts: int = 4
    base: float = 0.05
    cap: float = 2.0
    seed: int | None = None
    _rng: random.Random = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    @classmethod
    def from_settings(cls, **overrides: Any) -> "RetryPolicy":
        s = get_settings()
        kw: dict[str, Any] = dict(
            max_attempts=s.retry_max_attempts,
            base=s.retry_base_seconds,
            cap=s.retry_cap_seconds,
        )
        kw.update(overrides)
        return cls(**kw)

    def delay_for(self, attempt: int) -> float:
        d = min(self.cap, self.base * (2 ** max(0, attempt)))
        return self._rng.uniform(d / 2, d)

    def delays(self) -> Iterator[float]:
        """The backoff schedule between attempts (max_attempts - 1 gaps)."""
        for attempt in range(max(0, self.max_attempts - 1)):
            yield self.delay_for(attempt)

    async def call(
        self,
        fn: Callable[..., Awaitable[Any]],
        *args: Any,
        retry_on: tuple[type[BaseException], ...] = (ConnectionError, OSError),
        **kwargs: Any,
    ) -> Any:
        """Await ``fn`` up to ``max_attempts`` times, sleeping the jittered
        schedule between failures.  The final failure propagates."""
        import asyncio

        last: BaseException | None = None
        for attempt in range(self.max_attempts):
            try:
                return await fn(*args, **kwargs)
            except retry_on as exc:
                last = exc
                if attempt + 1 >= self.max_attempts:
                    break
                delay = self.delay_for(attempt)
                logger.debug("retry %d/%d after %s: sleeping %.3fs",
                             attempt + 1, self.max_attempts, exc, delay)
                await asyncio.sleep(delay)
        assert last is not None
        raise last


# ------------------------------------------------------------------ breaker

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-dependency circuit breaker.

    closed -> open after ``failure_threshold`` consecutive failures; open
    refuses calls (``CircuitOpen``) for ``reset_seconds``, then one probe is
    allowed (half-open); probe success closes, probe failure re-opens.
    Every state transition is counted (``snapshot()``) and exported
    (rag_breaker_transitions_total) so /health and dashboards see flapping,
    not just the current state.  Thread-safe: the agent runs in executor
    threads while the bus lives on the loop.
    """

    def __init__(
        self,
        name: str,
        failure_threshold: int | None = None,
        reset_seconds: float | None = None,
    ) -> None:
        s = get_settings()
        self.name = name
        self.failure_threshold = failure_threshold or s.breaker_failure_threshold
        self.reset_seconds = (
            s.breaker_reset_seconds if reset_seconds is None else reset_seconds
        )
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.transitions: dict[str, int] = {}

    # -- state machine (all under the lock) --

    def _transition(self, to_state: str) -> None:
        if to_state == self._state:
            return
        self._state = to_state
        self.transitions[to_state] = self.transitions.get(to_state, 0) + 1
        BREAKER_TRANSITIONS.labels(dep=self.name, to_state=to_state).inc()
        logger.info("breaker %s -> %s", self.name, to_state)

    def allow(self) -> bool:
        """True if a call may proceed now.  In half-open, only the single
        probe call is admitted until it reports success/failure."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if time.monotonic() - self._opened_at >= self.reset_seconds:
                    self._transition(HALF_OPEN)
                    self._probing = True
                    return True
                return False
            # half-open: one in-flight probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                self._opened_at = time.monotonic()
                self._transition(OPEN)
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = time.monotonic()
                self._transition(OPEN)

    def _end_probe(self) -> None:
        with self._lock:
            self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "transitions": dict(self.transitions),
            }

    async def call(
        self,
        fn: Callable[..., Awaitable[Any]],
        *args: Any,
        failure_on: tuple[type[BaseException], ...] = (ConnectionError, OSError),
        **kwargs: Any,
    ) -> Any:
        if not self.allow():
            raise CircuitOpen(f"circuit {self.name!r} is open")
        try:
            result = await fn(*args, **kwargs)
        except failure_on:
            self.record_failure()
            raise
        except Exception:
            # non-connection errors are the dependency answering, not dying
            self._end_probe()
            raise
        self.record_success()
        return result


_BREAKERS: dict[str, CircuitBreaker] = {}
_BREAKERS_LOCK = threading.Lock()


def get_breaker(name: str, **kwargs: Any) -> CircuitBreaker:
    """Process-wide breaker registry, one breaker per dependency name."""
    with _BREAKERS_LOCK:
        breaker = _BREAKERS.get(name)
        if breaker is None:
            breaker = CircuitBreaker(name, **kwargs)
            _BREAKERS[name] = breaker
        return breaker


def breaker_states() -> dict[str, dict[str, Any]]:
    with _BREAKERS_LOCK:
        return {name: b.snapshot() for name, b in _BREAKERS.items()}


def reset_breakers() -> None:
    """Drop every registered breaker (test isolation)."""
    with _BREAKERS_LOCK:
        _BREAKERS.clear()


# ----------------------------------------------------------------- deadline


class Deadline:
    """A wall-clock budget.  Created once at admission (API), then threaded
    with the job; each layer spends from the same budget instead of stacking
    independent timeouts that can sum past what the client will wait."""

    __slots__ = ("_expires_at",)

    def __init__(self, budget_s: float) -> None:
        self._expires_at = time.monotonic() + max(0.0, budget_s)

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self._expires_at

    def remaining(self) -> float:
        return max(0.0, self._expires_at - time.monotonic())

    def monotonic_deadline(self) -> float:
        """Absolute time.monotonic() timestamp — same-process only (the
        engine compares it against its own clock at step boundaries)."""
        return self._expires_at

    def to_wire(self) -> dict[str, float]:
        """Serialize for a queue hop.  Monotonic clocks don't cross process
        boundaries, so the wire form is remaining budget + an epoch stamp;
        the receiver subtracts its own queue-transit time from the budget."""
        return {"budget_ms": int(self.remaining() * 1000), "t0": time.time()}

    @classmethod
    def from_wire(cls, wire: dict[str, float]) -> "Deadline":
        budget_s = float(wire.get("budget_ms", 0)) / 1000.0
        # cross-process transit needs the wall clock: monotonic bases
        # differ per host, and the max(0, ...) clamp absorbs skew
        transit = max(0.0, time.time() - float(wire.get("t0", time.time())))
        return cls(budget_s - transit)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(remaining={self.remaining():.3f}s)"


_SCOPE = threading.local()


@contextlib.contextmanager
def deadline_scope(deadline: Deadline | None):
    """Bind ``deadline`` to the current thread for the duration.  The agent
    sets this around a run; LLM backends read it via ``current_deadline()``
    so the ``LLM`` protocol signature stays unchanged.  Thread-local, not a
    contextvar: the agent and its LLM calls share one executor thread, and
    the engine's driver thread must NOT inherit it."""
    prev = getattr(_SCOPE, "deadline", None)
    _SCOPE.deadline = deadline
    try:
        yield deadline
    finally:
        _SCOPE.deadline = prev


def current_deadline() -> Deadline | None:
    return getattr(_SCOPE, "deadline", None)


@contextlib.contextmanager
def priority_scope(klass: str | None):
    """Bind the job's SLO priority class to the current thread, same shape
    and rationale as ``deadline_scope``: the worker sets it around a run,
    LLM backends read it via ``current_priority()`` and stamp it on engine
    requests — the ``LLM`` protocol signature stays unchanged."""
    prev = getattr(_SCOPE, "priority", None)
    _SCOPE.priority = klass
    try:
        yield klass
    finally:
        _SCOPE.priority = prev


def current_priority() -> str | None:
    return getattr(_SCOPE, "priority", None)
