"""Redis-backed bus / cancel flags / job queue over the in-tree RESP client;
port of ``githubrepostorag_tpu/events/redis.py``.

Wire-behavior parity with the reference (rag_shared/bus.py): events are
published on ``job:{id}:events``, the cancel flag is ``job:{id}:cancel``
SET EX 3600, SSE framing with ~1 Hz pings.  The job queue uses LPUSH /
BRPOP on a list (the at-most-once dequeue semantics the reference gets
from ARQ) with results in ``job:{id}:result`` SET EX keep_result.

These classes are constructed only by the split deployment (``python -m
githubrepostorag_tpu_torch.api --redis`` and ``python -m
githubrepostorag_tpu_torch.worker``); tests and single-pod deploys use the
memory implementations.

One divergence by design: ``RedisCancelFlags`` and ``RedisJobQueue`` have
``close()`` (the queue closes both of its connections, the one parked in
``BRPOP`` included), and both pods call it on shutdown.  The JAX classes
have none, so their sockets stay open until the process exits, and a
server that waits for its clients to leave (asyncio's
``Server.wait_closed()`` since Python 3.12) waits forever.
"""

from __future__ import annotations

import asyncio
import json
import uuid
from typing import Any, AsyncIterator

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.events.base import (
    CANCEL_TTL_SECONDS,
    CancelFlags,
    EnqueuedJob,
    JobQueue,
    PING_FRAME,
    ProgressBus,
    cancel_key_for,
    channel_for,
    encode_event,
    sse_frame,
)
from githubrepostorag_tpu_torch.events.resp import RespConnection
from githubrepostorag_tpu_torch.metrics import BUS_RECONNECTS
from githubrepostorag_tpu_torch.resilience.faults import InjectedFault, fire_async
from githubrepostorag_tpu_torch.resilience.policy import RetryPolicy
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_QUEUE_KEY = "rag:jobs:queue"


class RedisBus(ProgressBus):
    def __init__(self, url: str | None = None, ping_interval: float = 1.0) -> None:
        self._url = url or get_settings().redis_url
        self._cmd = RespConnection(self._url)
        self._ping_interval = ping_interval

    async def emit(self, job_id: str, event: str, data: dict[str, Any]) -> None:
        # ``bus.emit`` seam mirrors the memory bus: the fault surfaces as a
        # raised error for the supervised emit path to retry/count.  The
        # RESP layer has its own redis.send/recv seams underneath.
        if await fire_async("bus.emit"):
            raise InjectedFault("injected drop at bus.emit")
        await self._cmd.command("PUBLISH", channel_for(job_id), encode_event(event, data))

    async def stream(self, job_id: str) -> AsyncIterator[str]:
        """Subscribe and yield frames, re-subscribing with jittered backoff
        when the connection dies.  Pub/sub has no replay: events published
        during the gap are lost (counted via rag_bus_reconnects_total; the
        worker's supervised emit keeps terminal events retrying, and the
        result key tells a reconnected subscriber how the job ended even
        if it missed the final frame)."""
        policy = RetryPolicy.from_settings()
        failures = 0
        while True:
            conn = RespConnection(self._url)
            try:
                await conn.connect()
                await conn.send("SUBSCRIBE", channel_for(job_id))
                await conn.read_reply()  # subscribe ack
                failures = 0
                while True:
                    try:
                        reply = await asyncio.wait_for(conn.read_reply(), timeout=self._ping_interval)
                    except asyncio.TimeoutError:
                        yield PING_FRAME
                        continue
                    if isinstance(reply, list) and len(reply) == 3 and reply[0] == "message":
                        yield sse_frame(reply[2])
            except (ConnectionError, OSError):
                BUS_RECONNECTS.inc()
                delay = policy.delay_for(failures)
                failures += 1
                logger.warning(
                    "bus stream for %s lost its connection; re-subscribing in %.2fs",
                    job_id, delay,
                )
                await asyncio.sleep(delay)
            finally:
                await conn.close()

    async def close(self) -> None:
        await self._cmd.close()


class RedisCancelFlags(CancelFlags):
    def __init__(self, url: str | None = None) -> None:
        self._conn = RespConnection(url or get_settings().redis_url)

    async def cancel(self, job_id: str) -> None:
        await self._conn.command("SET", cancel_key_for(job_id), "1", "EX", CANCEL_TTL_SECONDS)

    async def is_cancelled(self, job_id: str) -> bool:
        return await self._conn.command("GET", cancel_key_for(job_id)) is not None

    async def close(self) -> None:
        """Close the connection (a later command would open a new one)."""
        await self._conn.close()


class RedisJobQueue(JobQueue):
    def __init__(self, url: str | None = None) -> None:
        self._url = url or get_settings().redis_url
        self._cmd = RespConnection(self._url)
        self._pop = RespConnection(self._url)  # BRPOP blocks; keep it separate
        self._keep_result = get_settings().keep_result_seconds

    async def enqueue_job(self, function: str, *args: Any, _job_id: str | None = None,
                          **kwargs: Any) -> EnqueuedJob:
        job = EnqueuedJob(job_id=_job_id or uuid.uuid4().hex, function=function, args=args,
                          kwargs=kwargs)
        payload = json.dumps(
            {"job_id": job.job_id, "function": job.function, "args": list(job.args),
             "kwargs": job.kwargs}
        )
        await self._cmd.command("LPUSH", _QUEUE_KEY, payload)
        return job

    async def dequeue(self) -> EnqueuedJob:
        while True:
            reply = await self._pop.command("BRPOP", _QUEUE_KEY, 1)
            if reply is None:
                continue
            raw = json.loads(reply[1])
            return EnqueuedJob(
                job_id=raw["job_id"],
                function=raw["function"],
                args=tuple(raw.get("args", ())),
                kwargs=raw.get("kwargs", {}),
            )

    async def depth(self) -> int:
        reply = await self._cmd.command("LLEN", _QUEUE_KEY)
        return int(reply or 0)

    async def set_result(self, job_id: str, result: Any) -> None:
        await self._cmd.command(
            "SET", f"job:{job_id}:result", json.dumps(result, ensure_ascii=False), "EX",
            self._keep_result
        )

    async def get_result(self, job_id: str) -> Any:
        raw = await self._cmd.command("GET", f"job:{job_id}:result")
        return json.loads(raw) if raw is not None else None

    async def close(self) -> None:
        """Close both connections, the one parked in ``BRPOP`` too.  Cancel
        the consumer's ``dequeue`` first: a ``dequeue`` still running would
        reconnect on its next ``BRPOP``."""
        await self._pop.close()
        await self._cmd.close()
