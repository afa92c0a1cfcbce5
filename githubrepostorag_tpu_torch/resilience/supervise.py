"""Supervision wrappers over the events layer; a copy of
``githubrepostorag_tpu/resilience/supervise.py``.

``ResilientBus`` decorates any ``ProgressBus`` with the delivery guarantees
the worker needs under partial failure:

  - every ``emit`` retries through a jittered ``RetryPolicy`` behind the
    shared ``bus`` circuit breaker;
  - terminal events (``final`` / ``error``) get a deeper retry budget than
    progress chatter — a lost ``turn`` is cosmetic, a lost ``final`` strands
    every SSE client and poller on that job;
  - an emit that exhausts its retries (or hits an open breaker) is DROPPED,
    but never silently: rag_bus_emit_drops_total counts it by event kind and
    the log carries the job id.  emit never raises into the job path.

The bus stream side (re-subscribe on connection loss) lives in the Redis
bus itself — a generator can't be usefully wrapped from out here without
buffering semantics the memory hub already provides.
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from githubrepostorag_tpu_torch.events.base import ProgressBus
from githubrepostorag_tpu_torch.metrics import EVENT_EMIT_DROPS
from githubrepostorag_tpu_torch.resilience.policy import RetryPolicy, get_breaker
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

TERMINAL_EVENTS = ("final", "error")


class ResilientBus(ProgressBus):
    """Retrying, breaker-guarded, never-raising decorator for emit."""

    def __init__(
        self,
        inner: ProgressBus,
        policy: RetryPolicy | None = None,
        terminal_policy: RetryPolicy | None = None,
    ) -> None:
        self._inner = inner
        self._policy = policy or RetryPolicy.from_settings()
        self._terminal_policy = terminal_policy or RetryPolicy.from_settings(
            max_attempts=max(6, self._policy.max_attempts)
        )
        self._breaker = get_breaker("bus")

    async def emit(self, job_id: str, event: str, data: dict[str, Any]) -> None:
        # the breaker observes the whole retried emit as ONE dependency
        # call: a blip absorbed by a retry is a success, not a failure
        if not self._breaker.allow():
            EVENT_EMIT_DROPS.labels(event=event).inc()
            logger.warning("bus breaker open: dropped %r for job %s", event, job_id)
            return
        policy = self._terminal_policy if event in TERMINAL_EVENTS else self._policy
        try:
            await policy.call(self._inner.emit, job_id, event, data)
        except Exception as exc:  # noqa: BLE001 - emit must not kill the job
            self._breaker.record_failure()
            EVENT_EMIT_DROPS.labels(event=event).inc()
            logger.warning(
                "emit %r for job %s dropped after %d attempts: %s",
                event, job_id, policy.max_attempts, exc,
            )
        else:
            self._breaker.record_success()

    def stream(self, job_id: str) -> AsyncIterator[str]:
        return self._inner.stream(job_id)

    async def close(self) -> None:
        await self._inner.close()
