"""Per-class admission decisions consulted by the API's load-shedding
check; a copy of ``githubrepostorag_tpu/resilience/admission.py``.  The
SLO plane (obs/slo.get_slo_plane) registers its providers when a process
first builds it; until then every decision is "accept".

The SLO plane (obs/slo.py) registers two callables here at construction:
the legacy fleet-wide ``admission_hint`` and the per-class
``decision_table``.  This module deliberately holds only callables so
``resilience`` never imports ``obs`` (no import cycle) and works unchanged
when no plane exists (standalone workers, unit tests): the default
decision is "accept".

Decisions form the graceful-degradation ladder, least to most drastic:

    "accept"   all SLOs ok for the class
    "throttle" the protected class is in warn — batch admission tightens
               (headroom doubles engine-side) but requests still queue
    "preempt"  the protected class is critical — the engine is parking
               batch-class victims to the KV host tier; batch intake
               continues but expect queueing
    "shed"     the class's own error budget is burning critically AND
               preemption has no victims left to reclaim — reject with
               429 now, before the queue does it slower

Failure is open by design — a broken SLO plane must never take the API
down with it — but no longer silent: every fail-open is logged and counted
(``rag_admission_failopen_total``) so a dead provider shows up on a
dashboard instead of masquerading as a healthy fleet.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

from githubrepostorag_tpu_torch.metrics import ADMISSION_FAILOPEN

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_provider: Callable[[], str] | None = None
_table_provider: Callable[[], dict] | None = None

ACCEPT, THROTTLE, PREEMPT, SHED = "accept", "throttle", "preempt", "shed"
_DECISIONS = (ACCEPT, THROTTLE, PREEMPT, SHED)


def set_hint_provider(fn: Callable[[], str]) -> None:
    global _provider
    with _lock:
        _provider = fn


def clear_hint_provider() -> None:
    global _provider
    with _lock:
        _provider = None


def set_table_provider(fn: Callable[[], dict]) -> None:
    """Register the per-class decision-table callable (the SLO plane's
    ``decision_table``)."""
    global _table_provider
    with _lock:
        _table_provider = fn


def clear_table_provider() -> None:
    global _table_provider
    with _lock:
        _table_provider = None


def _failopen(what: str, exc: Exception | None = None) -> None:
    ADMISSION_FAILOPEN.inc()
    if exc is not None:
        logger.warning("admission %s failed open: %r", what, exc)
    else:
        logger.warning("admission %s failed open: invalid value", what)


def admission_hint() -> str:
    """Legacy fleet-wide hint (worst state across every class); failure-open
    with logging + counting."""
    with _lock:
        fn = _provider
    if fn is None:
        return ACCEPT
    try:
        hint = fn()
    except Exception as exc:  # noqa: BLE001 - hint is advisory, never fatal
        _failopen("hint provider", exc)
        return ACCEPT
    if hint not in (ACCEPT, THROTTLE, SHED):
        _failopen("hint provider")
        return ACCEPT
    return hint


def admission_table() -> dict[str, str]:
    """Current per-class decision table ({} when no plane is registered).
    A raising or garbage-returning provider fails open to {} — logged and
    counted, never fatal."""
    from githubrepostorag_tpu_torch.resilience.faults import InjectedFault, get_registry

    with _lock:
        fn = _table_provider
    if fn is None:
        return {}
    try:
        # fault seam: FAULTS="admission.decide:error" proves the fail-open
        # path under chaos load (tests/test_chaos.py).  Inlined rather than
        # fire_sync() because admission runs on the event loop — a delay
        # action degrades to an immediate error instead of a blocking sleep.
        reg = get_registry()
        if reg.by_site and reg.decide("admission.decide")[0] is not None:
            raise InjectedFault("injected fault at admission.decide")
        table = fn()
    except Exception as exc:  # noqa: BLE001 - advisory, never fatal
        _failopen("table provider", exc)
        return {}
    if not isinstance(table, dict):
        _failopen("table provider")
        return {}
    out: dict[str, str] = {}
    for klass, decision in table.items():
        if decision in _DECISIONS:
            out[str(klass)] = decision
        else:
            _failopen("table provider")
    return out


def admission_decision(klass: str | None = None) -> str:
    """Decision for one priority class.  Unknown classes inherit the
    legacy fleet-wide hint so a brand-new label is still protected by the
    old worst-state behavior rather than silently accepted."""
    table = admission_table()
    if klass is not None and klass in table:
        return table[klass]
    hint = admission_hint()
    return hint if hint in _DECISIONS else ACCEPT


def should_shed(klass: str | None = None) -> bool:
    return admission_decision(klass) == SHED
