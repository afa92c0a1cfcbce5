"""L4: job queue + progress event bus + cancel flags; port of
``githubrepostorag_tpu/events/__init__.py``.

Protocol-compatible with the reference's Redis pub/sub bus
(rag_shared/bus.py:8-40): channel ``job:{id}:events`` carries JSON frames
``{"event": <name>, "data": {...}}`` rendered to SSE as ``data: <json>\n\n``
with ``: ping\n\n`` keepalives; cancellation is a flag key ``job:{id}:cancel``
with a 3600 s TTL.

Implementations:
  - ``MemoryBus`` / ``MemoryCancelFlags`` / ``MemoryJobQueue`` — in-process,
    for tests and single-pod deployments (no Redis needed at all).
  - ``events.redis`` (``RedisBus`` / ``RedisCancelFlags`` /
    ``RedisJobQueue``) — the same wire behavior against a real Redis via
    the in-tree RESP client (``events/resp.py``); the split deployment's
    API and worker pods share them (``api --redis``, ``worker``).
    Imported lazily, so the single-pod service never loads them.
"""

from githubrepostorag_tpu_torch.events.base import (
    CancelFlags,
    EnqueuedJob,
    JobQueue,
    ProgressBus,
    sse_frame,
    PING_FRAME,
)
from githubrepostorag_tpu_torch.events.memory import (
    MemoryBus,
    MemoryCancelFlags,
    MemoryJobQueue,
    get_memory_hub,
    reset_memory_hub,
)

__all__ = [
    "ProgressBus",
    "CancelFlags",
    "JobQueue",
    "EnqueuedJob",
    "sse_frame",
    "PING_FRAME",
    "MemoryBus",
    "MemoryCancelFlags",
    "MemoryJobQueue",
    "get_memory_hub",
    "reset_memory_hub",
]
