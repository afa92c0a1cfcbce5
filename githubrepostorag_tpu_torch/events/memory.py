"""In-process event bus / cancel flags / job queue; a copy of
``githubrepostorag_tpu/events/memory.py``.

Used by tests and by single-pod deployments where Redis would be overkill.
Improves on the reference's raw pub/sub in one way: a bounded replay buffer
per job lets an SSE subscriber that connects *after* the first events were
emitted still see them (the reference races job start against EventSource
connect and silently drops early frames).
"""

from __future__ import annotations

import asyncio
import time
import uuid
from collections import deque
from typing import Any, AsyncIterator

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.events.base import (
    CANCEL_TTL_SECONDS,
    CancelFlags,
    EnqueuedJob,
    JobQueue,
    PING_FRAME,
    ProgressBus,
    encode_event,
    sse_frame,
)
from githubrepostorag_tpu_torch.resilience.faults import InjectedFault, fire_async

_REPLAY_LIMIT = 256


class _Hub:
    """Shared in-process state behind the three memory implementations."""

    def __init__(self) -> None:
        self.subscribers: dict[str, list[asyncio.Queue[str]]] = {}
        self.replay: dict[str, deque[str]] = {}
        self.replay_expiry: dict[str, float] = {}  # job_id -> expiry ts
        self.cancel_flags: dict[str, float] = {}  # job_id -> expiry ts
        self.queue: asyncio.Queue[EnqueuedJob] = asyncio.Queue()
        self.results: dict[str, tuple[float, Any]] = {}  # job_id -> (expiry, result)

    def prune(self, now: float) -> None:
        """Evict expired replay buffers and cancel flags (called on emit)."""
        for job_id in [j for j, exp in self.replay_expiry.items() if exp < now]:
            self.replay_expiry.pop(job_id, None)
            self.replay.pop(job_id, None)
        for job_id in [j for j, exp in self.cancel_flags.items() if exp < now]:
            self.cancel_flags.pop(job_id, None)


_hub: _Hub | None = None


def get_memory_hub() -> _Hub:
    global _hub
    if _hub is None:
        _hub = _Hub()
    return _hub


def reset_memory_hub() -> None:
    """Drop all in-process bus state (test isolation)."""
    global _hub
    _hub = None


class MemoryBus(ProgressBus):
    def __init__(self, hub: _Hub | None = None, ping_interval: float = 1.0) -> None:
        self._hub = hub or get_memory_hub()
        self._ping_interval = ping_interval

    async def emit(self, job_id: str, event: str, data: dict[str, Any]) -> None:
        # ``bus.emit`` injection seam: drop and error both raise so the
        # supervised emit path (resilience.ResilientBus) sees the failure,
        # retries, and counts what it ultimately loses — a fault that
        # silently vanished here could never be "counted, never silent"
        if await fire_async("bus.emit"):
            raise InjectedFault("injected drop at bus.emit")
        payload = encode_event(event, data)
        now = time.monotonic()
        self._hub.prune(now)
        buf = self._hub.replay.setdefault(job_id, deque(maxlen=_REPLAY_LIMIT))
        buf.append(payload)
        self._hub.replay_expiry[job_id] = now + CANCEL_TTL_SECONDS
        for q in self._hub.subscribers.get(job_id, []):
            q.put_nowait(payload)

    async def stream(self, job_id: str) -> AsyncIterator[str]:
        q: asyncio.Queue[str] = asyncio.Queue()
        for payload in self._hub.replay.get(job_id, ()):  # catch-up
            q.put_nowait(payload)
        self._hub.subscribers.setdefault(job_id, []).append(q)
        try:
            while True:
                try:
                    payload = await asyncio.wait_for(q.get(), timeout=self._ping_interval)
                    yield sse_frame(payload)
                except asyncio.TimeoutError:
                    yield PING_FRAME
        finally:
            subs = self._hub.subscribers.get(job_id, [])
            if q in subs:
                subs.remove(q)
            if not subs:
                self._hub.subscribers.pop(job_id, None)


class MemoryCancelFlags(CancelFlags):
    def __init__(self, hub: _Hub | None = None) -> None:
        self._hub = hub or get_memory_hub()

    async def cancel(self, job_id: str) -> None:
        self._hub.cancel_flags[job_id] = time.monotonic() + CANCEL_TTL_SECONDS

    async def is_cancelled(self, job_id: str) -> bool:
        expiry = self._hub.cancel_flags.get(job_id)
        if expiry is None:
            return False
        if time.monotonic() > expiry:
            self._hub.cancel_flags.pop(job_id, None)
            return False
        return True


class MemoryJobQueue(JobQueue):
    def __init__(self, hub: _Hub | None = None) -> None:
        self._hub = hub or get_memory_hub()
        self._keep_result = get_settings().keep_result_seconds

    async def enqueue_job(self, function: str, *args: Any, _job_id: str | None = None, **kwargs: Any) -> EnqueuedJob:
        job = EnqueuedJob(job_id=_job_id or uuid.uuid4().hex, function=function, args=args, kwargs=kwargs)
        await self._hub.queue.put(job)
        return job

    async def dequeue(self) -> EnqueuedJob:
        return await self._hub.queue.get()

    async def depth(self) -> int:
        return self._hub.queue.qsize()

    async def set_result(self, job_id: str, result: Any) -> None:
        self._prune()
        self._hub.results[job_id] = (time.monotonic() + self._keep_result, result)

    async def get_result(self, job_id: str) -> Any:
        self._prune()
        entry = self._hub.results.get(job_id)
        return entry[1] if entry else None

    def _prune(self) -> None:
        now = time.monotonic()
        expired = [k for k, (exp, _) in self._hub.results.items() if exp < now]
        for k in expired:
            self._hub.results.pop(k, None)
