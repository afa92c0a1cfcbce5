"""Deterministic fault injection for chaos tests and staging soak; a copy
of ``githubrepostorag_tpu/resilience/faults.py``.

A fault spec rides the ``FAULTS`` env var::

    FAULTS="redis.send:drop@3;cql.exchange:error@0.5;llm.complete:delay=2"

Grammar per ``;``-separated entry: ``site:action[@param]`` where

  - ``site`` is a seam name wired into the I/O layers (``redis.send``,
    ``redis.recv``, ``cql.exchange``, ``llm.complete``, ``bus.emit``)
  - ``action`` is ``drop`` (the operation is lost — connection seams close
    the socket and raise, the bus seam raises so the supervised emit path
    retries and counts), ``error`` (raise ``InjectedFault``, a
    ``ConnectionError`` subclass so every reconnect path treats it as a
    dead dependency), or ``delay=SECONDS`` (sleep, then proceed)
  - ``@param`` selects WHICH calls fire: an integer N >= 1 means
    deterministically every Nth call at that site (``drop@3`` = calls
    3, 6, 9, ...); a float in (0, 1) is a seeded per-call probability
    (``error@0.5``); ``window=N:M`` fires only on calls N..M inclusive,
    1-based (``delay=2@window=5:8`` = calls 5, 6, 7, 8; ``error@window=40:``
    is open-ended from call 40) so a chaos script can express "healthy,
    then dies, then recovers" at one site; omitted means every call.

Probabilities draw from ``random.Random(FAULTS_SEED ^ crc32(site))`` — the
builtin ``hash()`` is salted per process and would unseed the chaos suite.
When ``FAULTS`` is unset the seams cost one attribute load and a falsy
check; no parsing, no locks, no metrics.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from random import Random

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.metrics import FAULTS_INJECTED
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class InjectedFault(ConnectionError):
    """An injected dependency failure.  Subclasses ConnectionError (itself
    an OSError) so the production reconnect/replay/retry paths exercise
    their real branches instead of a parallel test-only codepath."""


class FaultSpecError(ValueError):
    """Malformed FAULTS spec — raised at parse, never mid-traffic."""


@dataclass
class _Fault:
    site: str
    action: str  # "drop" | "error" | "delay"
    every: int | None = None  # fire every Nth call
    probability: float | None = None  # seeded per-call probability
    window_lo: int | None = None  # fire only on calls N..M (1-based, inclusive)
    window_hi: int | None = None  # None = open-ended
    delay_s: float = 0.0
    calls: int = 0
    fired: int = 0
    _rng: Random = field(default_factory=Random, repr=False)

    def should_fire(self) -> bool:
        self.calls += 1
        if self.window_lo is not None:
            if self.calls < self.window_lo:
                return False
            return self.window_hi is None or self.calls <= self.window_hi
        if self.every is not None:
            return self.calls % self.every == 0
        if self.probability is not None:
            return self._rng.random() < self.probability
        return True


def _parse_entry(entry: str, seed: int) -> _Fault:
    entry = entry.strip()
    site, sep, action_spec = entry.partition(":")
    if not sep or not site or not action_spec:
        raise FaultSpecError(f"FAULTS entry {entry!r}: expected 'site:action[@param]'")
    action_spec, _, param = action_spec.partition("@")
    action, _, value = action_spec.partition("=")
    if action not in ("drop", "error", "delay"):
        raise FaultSpecError(f"FAULTS entry {entry!r}: unknown action {action!r}")
    fault = _Fault(site=site.strip(), action=action)
    fault._rng = Random(seed ^ zlib.crc32(fault.site.encode()))
    if action == "delay":
        try:
            fault.delay_s = float(value)
        except ValueError:
            raise FaultSpecError(f"FAULTS entry {entry!r}: delay needs '=seconds'") from None
    elif value:
        raise FaultSpecError(f"FAULTS entry {entry!r}: only delay takes '=value'")
    if param.startswith("window="):
        lo_s, sep2, hi_s = param[len("window="):].partition(":")
        if not sep2:
            raise FaultSpecError(
                f"FAULTS entry {entry!r}: window needs 'N:M' (M empty = open-ended)"
            )
        try:
            fault.window_lo = int(lo_s)
            fault.window_hi = int(hi_s) if hi_s else None
        except ValueError:
            raise FaultSpecError(
                f"FAULTS entry {entry!r}: window bounds must be integers"
            ) from None
        if fault.window_lo < 1 or (
            fault.window_hi is not None and fault.window_hi < fault.window_lo
        ):
            raise FaultSpecError(
                f"FAULTS entry {entry!r}: window needs 1 <= N <= M"
            )
    elif param:
        try:
            num = float(param)
        except ValueError:
            raise FaultSpecError(f"FAULTS entry {entry!r}: bad param {param!r}") from None
        if num >= 1:
            if num != int(num):
                raise FaultSpecError(
                    f"FAULTS entry {entry!r}: every-Nth param must be an integer"
                )
            fault.every = int(num)
        elif 0 < num < 1:
            fault.probability = num
        else:
            raise FaultSpecError(f"FAULTS entry {entry!r}: param must be >0")
    return fault


class FaultRegistry:
    """Parsed faults grouped by site.  One instance per process, rebuilt
    when tests reload settings (conftest calls ``reset_faults``)."""

    def __init__(self, faults: list[_Fault]) -> None:
        self.by_site: dict[str, list[_Fault]] = {}
        for f in faults:
            self.by_site.setdefault(f.site, []).append(f)
        self._lock = threading.Lock()
        # timestamped injection ring for the /debug/timeline exporter —
        # prometheus keeps the totals, this keeps the WHEN
        self._events: deque[tuple[float, str, str]] = deque(maxlen=256)

    @classmethod
    def from_env(cls) -> "FaultRegistry":
        s = get_settings()
        spec = s.faults.strip()
        if not spec:
            return cls([])
        faults = [_parse_entry(e, s.faults_seed) for e in spec.split(";") if e.strip()]
        if faults:
            logger.warning("FAULT INJECTION ACTIVE: %s", spec)
        return cls(faults)

    def decide(self, site: str) -> tuple[str | None, float]:
        """-> (action or None, delay_s).  Counters advance under a lock so
        every-Nth cadence stays exact across threads."""
        entries = self.by_site.get(site)
        if not entries:
            return None, 0.0
        with self._lock:
            for fault in entries:
                if fault.should_fire():
                    fault.fired += 1
                    FAULTS_INJECTED.labels(site=site, action=fault.action).inc()
                    self._events.append(
                        (time.monotonic(), site, fault.action))
                    return fault.action, fault.delay_s
        return None, 0.0

    def events(self, t_min: float = 0.0) -> list[tuple[float, str, str]]:
        """Injections fired at or after ``t_min`` as (monotonic_t, site,
        action) — the timeline's fault-instant source."""
        with self._lock:
            return [e for e in self._events if e[0] >= t_min]

    def stats(self) -> dict[str, list[dict]]:
        with self._lock:
            return {
                site: [
                    {"action": f.action, "calls": f.calls, "fired": f.fired}
                    for f in entries
                ]
                for site, entries in self.by_site.items()
            }


_registry: FaultRegistry | None = None
_registry_lock = threading.Lock()


def get_registry() -> FaultRegistry:
    global _registry
    reg = _registry
    if reg is None:
        with _registry_lock:
            reg = _registry
            if reg is None:
                reg = _registry = FaultRegistry.from_env()
    return reg


def reset_faults() -> None:
    """Force a re-parse of FAULTS on next use (test isolation)."""
    global _registry
    with _registry_lock:
        _registry = None


def active() -> bool:
    return bool(get_registry().by_site)


def fire_sync(site: str) -> bool:
    """Fault seam for synchronous code (CQL store, LLM backends).

    Returns True when a ``drop`` fired — the caller owns drop semantics
    (close a socket, skip a publish).  ``error`` raises ``InjectedFault``;
    ``delay`` sleeps then returns False.  Zero-cost when FAULTS is unset.
    """
    reg = get_registry()
    if not reg.by_site:
        return False
    action, delay_s = reg.decide(site)
    if action is None:
        return False
    if action == "delay":
        time.sleep(delay_s)
        return False
    if action == "error":
        raise InjectedFault(f"injected error at {site}")
    return True  # drop


async def fire_async(site: str) -> bool:
    """Async twin of ``fire_sync`` for seams on the event loop (RESP
    client, progress bus).  Delays use asyncio.sleep — a blocking sleep
    here would stall every SSE stream and dequeue in the process (the
    exact ASY001 bug tpulint flags)."""
    import asyncio

    reg = get_registry()
    if not reg.by_site:
        return False
    action, delay_s = reg.decide(site)
    if action is None:
        return False
    if action == "delay":
        await asyncio.sleep(delay_s)
        return False
    if action == "error":
        raise InjectedFault(f"injected error at {site}")
    return True  # drop
