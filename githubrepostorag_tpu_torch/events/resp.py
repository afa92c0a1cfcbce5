"""Minimal asyncio Redis client speaking RESP2; a copy of
``githubrepostorag_tpu/events/resp.py``.

No third-party redis package is needed: the Redis-backed bus, cancel flags
and job queue (``events/redis.py``) ride this client.  It covers exactly
the command surface the reference's bus uses (rag_shared/bus.py: PUBLISH /
SUBSCRIBE / GET / SET EX) plus LPUSH / BRPOP / LLEN for the job queue.

Two race fixes of the reference are kept: ``close()`` captures and clears
the writer before it awaits (a second ``close()`` finds None), and a
connection-level failure inside ``command`` / ``send`` closes the socket
before it raises, so the next command reconnects instead of reading a
misaligned stream.  The ``redis.send`` / ``redis.recv`` fault seams
(``resilience/faults.py``) sit where the reference has them.
"""

from __future__ import annotations

import asyncio
from urllib.parse import urlparse

from githubrepostorag_tpu_torch.resilience.faults import fire_async


class RespError(Exception):
    pass


def _encode_command(*args: str | bytes | int | float) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        else:
            b = str(a).encode("utf-8")
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


class RespConnection:
    """One TCP connection to Redis.  Not safe for concurrent commands; the
    higher layers open one connection per logical role (cmd vs subscribe)."""

    def __init__(self, url: str) -> None:
        parsed = urlparse(url)
        self.host = parsed.hostname or "localhost"
        self.port = parsed.port or 6379
        self.db = int((parsed.path or "/0").lstrip("/") or 0)
        self.password = parsed.password
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        if self.password:
            await self.command("AUTH", self.password)
        if self.db:
            await self.command("SELECT", self.db)

    async def close(self) -> None:
        # capture-and-clear before awaiting: a second close() racing past
        # wait_closed() must find None, not a half-torn-down writer
        writer, self._reader, self._writer = self._writer, None, None
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @property
    def connected(self) -> bool:
        return self._writer is not None and not self._writer.is_closing()

    async def command(self, *args: str | bytes | int | float):
        """Send one command and read one reply.  A connection-level failure
        mid-exchange tears the socket down before propagating, so the next
        command reconnects instead of reading a misaligned stream; so does
        a command cancelled between its write and its reply (a worker
        cancels its cancel-flag poll when the job ends), whose reply would
        otherwise answer the next command."""
        async with self._lock:
            if not self.connected:
                await self.connect()
            try:
                await self._fire_faults()
                self._writer.write(_encode_command(*args))
                await self._writer.drain()
                return await self.read_reply()
            except RespError:
                raise  # a whole error reply: the stream stays aligned
            except (ConnectionError, OSError):
                await self.close()
                raise
            except BaseException:
                writer, self._reader, self._writer = self._writer, None, None
                if writer is not None:
                    writer.close()
                raise

    async def send(self, *args: str | bytes | int | float) -> None:
        """Send without reading a reply (subscribe-mode writes)."""
        async with self._lock:
            if not self.connected:
                await self.connect()
            try:
                await self._fire_faults()
                self._writer.write(_encode_command(*args))
                await self._writer.drain()
            except (ConnectionError, OSError):
                await self.close()
                raise

    async def _fire_faults(self) -> None:
        """``redis.send`` injection seam.  A drop simulates the peer
        vanishing mid-write: raise ConnectionError and let the caller's
        close-on-error path mark the socket dead."""
        if await fire_async("redis.send"):
            raise ConnectionError("injected drop at redis.send")

    async def read_reply(self):
        if await fire_async("redis.recv"):
            raise ConnectionError("injected drop at redis.recv")
        line = await self._reader.readline()
        if not line:
            raise ConnectionError("redis connection closed")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest.decode("utf-8")
        if kind == b"-":
            raise RespError(rest.decode("utf-8"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            length = int(rest)
            if length == -1:
                return None
            data = await self._reader.readexactly(length + 2)
            return data[:-2].decode("utf-8", errors="replace")
        if kind == b"*":
            count = int(rest)
            if count == -1:
                return None
            return [await self.read_reply() for _ in range(count)]
        raise RespError(f"unexpected RESP type byte: {line!r}")
