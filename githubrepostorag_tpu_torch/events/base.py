"""Event bus / cancel flag / job queue protocols and the SSE wire format;
a copy of ``githubrepostorag_tpu/events/base.py``.

Wire behavior matches the reference (rag_shared/bus.py): events are JSON
``{"event": e, "data": d}`` published on ``job:{id}:events``; SSE framing is
``data: <json>\n\n`` plus ``: ping\n\n`` keepalives; the cancel flag is key
``job:{id}:cancel`` with TTL 3600 s.
"""

from __future__ import annotations

import abc
import json
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

CHANNEL_FMT = "job:{id}:events"
CANCEL_FLAG_FMT = "job:{id}:cancel"
CANCEL_TTL_SECONDS = 3600
PING_FRAME = ": ping\n\n"


def channel_for(job_id: str) -> str:
    return CHANNEL_FMT.format(id=job_id)


def cancel_key_for(job_id: str) -> str:
    return CANCEL_FLAG_FMT.format(id=job_id)


def encode_event(event: str, data: dict[str, Any]) -> str:
    return json.dumps({"event": event, "data": data}, ensure_ascii=False)


def sse_frame(payload: str) -> str:
    return f"data: {payload}\n\n"


@dataclass
class EnqueuedJob:
    """A queued unit of work (the ARQ-enqueue equivalent)."""

    job_id: str
    function: str
    args: tuple = ()
    kwargs: dict[str, Any] = field(default_factory=dict)


class ProgressBus(abc.ABC):
    """Publish/stream job progress events."""

    @abc.abstractmethod
    async def emit(self, job_id: str, event: str, data: dict[str, Any]) -> None:
        """Publish one event on the job's channel."""

    @abc.abstractmethod
    def stream(self, job_id: str) -> AsyncIterator[str]:
        """Yield SSE frames (``data: ...`` events interleaved with pings).

        The iterator never terminates on its own; callers stop consuming when
        they see a terminal event (``final`` / ``error``) or disconnect.
        """

    async def close(self) -> None:  # pragma: no cover - default no-op
        return None


class CancelFlags(abc.ABC):
    """Cooperative cancellation flags keyed by job id."""

    @abc.abstractmethod
    async def cancel(self, job_id: str) -> None: ...

    @abc.abstractmethod
    async def is_cancelled(self, job_id: str) -> bool: ...


class JobQueue(abc.ABC):
    """Minimal job queue with the ARQ semantics the reference relies on:
    named-function enqueue, at-most-once dequeue, job timeout handled by the
    worker, results kept for ``keep_result`` seconds."""

    @abc.abstractmethod
    async def enqueue_job(self, function: str, *args: Any, _job_id: str | None = None, **kwargs: Any) -> EnqueuedJob: ...

    @abc.abstractmethod
    async def dequeue(self) -> EnqueuedJob:
        """Block until a job is available."""

    @abc.abstractmethod
    async def set_result(self, job_id: str, result: Any) -> None: ...

    @abc.abstractmethod
    async def get_result(self, job_id: str) -> Any: ...

    async def depth(self) -> int:
        """Jobs enqueued but not yet dequeued — the admission bound's input
        (api/app.py create_job sheds at JOB_QUEUE_MAX_DEPTH).  Default 0:
        a queue that can't report depth never sheds."""
        return 0
