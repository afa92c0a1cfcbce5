"""The port's RESP client and Redis bus / cancel flags / job queue against
the JAX package's, over ``tests/miniredis.py`` (a real RESP2 server on a
TCP socket): the wire bytes, the replies read back, frames and jobs that
cross from one package to the other, the fault seams, the single-pod
API / worker parity cases of ``test_torch_api_worker.py`` with the Redis
bus on both sides, and the split deployment's entry points (an in-process
``--redis --no-worker`` API and the worker pod as a subprocess).

Every socket test is bounded (``asyncio.wait_for``), closes its
connections before ``MiniRedis.stop()`` and bounds ``stop()`` too: since
Python 3.12 ``Server.wait_closed()`` waits until every client connection
is closed, and ``test_redis_queue_and_flags_close_their_connections``
shows where the JAX classes leave one open."""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

import githubrepostorag_tpu.events.redis as j_redis
import githubrepostorag_tpu.events.resp as j_resp
from githubrepostorag_tpu.config import reload_settings as j_reload
from githubrepostorag_tpu.events.base import channel_for
from githubrepostorag_tpu_torch import config
from githubrepostorag_tpu_torch.api import __main__ as api_main
from githubrepostorag_tpu_torch.events import redis as p_redis
from githubrepostorag_tpu_torch.events import resp as p_resp
from githubrepostorag_tpu_torch.events.base import encode_event, sse_frame
from githubrepostorag_tpu_torch.metrics import BUS_RECONNECTS, counter_value
from githubrepostorag_tpu_torch.resilience import reset_breakers, reset_faults
from githubrepostorag_tpu_torch.store import factory
from test_torch_api_worker import (AGENT_SCRIPT, DOCS, SIDES, SLOW_SCRIPT, _slow, events_of,
                                   normalized, on_both, request)
from test_torch_serving_main import ROOT, _free_port
from tests.miniredis import MiniRedis

BOUND_S = 20  # every socket test's limit
STOP_S = 5  # MiniRedis.stop()'s limit once every connection is closed

REDIS = {"jax": SimpleNamespace(Bus=j_redis.RedisBus, Flags=j_redis.RedisCancelFlags,
                                Queue=j_redis.RedisJobQueue),
         "port": SimpleNamespace(Bus=p_redis.RedisBus, Flags=p_redis.RedisCancelFlags,
                                 Queue=p_redis.RedisJobQueue)}


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    """The port's settings, fault registry and breakers, fresh per test."""
    config.reload_settings()
    reset_faults()
    reset_breakers()
    yield
    monkeypatch.undo()
    config.reload_settings()
    j_reload()
    reset_faults()
    reset_breakers()


async def _close_jax(part) -> None:
    """Close a JAX flags / queue object's connections by hand (the JAX
    classes have no ``close()``)."""
    for name in ("_conn", "_cmd", "_pop"):
        conn = getattr(part, name, None)
        if conn is not None:
            await conn.close()


async def _with_server(fn):
    """``fn(url, server)`` over a fresh MiniRedis, bounded; ``fn`` closes
    its connections, so the bounded ``stop()`` returns."""
    server = MiniRedis()
    port = await server.start()
    try:
        await asyncio.wait_for(fn(f"redis://127.0.0.1:{port}/0", server), BOUND_S)
    finally:
        await asyncio.wait_for(server.stop(), STOP_S)


async def _subscribed(server, job_id: str) -> None:
    for _ in range(500):
        if server.subscribers.get(channel_for(job_id)):
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"no subscriber on {channel_for(job_id)}")


# ------------------------------------------------------------------ RESP

ENCODE_CASES = [
    ("PUBLISH", "job:ab12:events", encode_event("token", {"text": "héllo 世界 🚀"})),
    ("SET", "job:ab12:cancel", "1", "EX", 3600),
    ("BRPOP", "rag:jobs:queue", 1),
    ("SET", b"\x00\xff raw bytes\r\n", 2.5, -7),
    ("LLEN",),
    ("GET", ""),
]


@pytest.mark.parametrize("args", ENCODE_CASES, ids=lambda a: a[0] if a else "empty")
def test_encode_command_bytes_equal_jax(args):
    assert p_resp._encode_command(*args) == j_resp._encode_command(*args)


REPLY_STREAM = (
    b"+OK\r\n-ERR wrong type\r\n:42\r\n:-7\r\n$5\r\nhello\r\n$0\r\n\r\n$-1\r\n*-1\r\n*0\r\n"
    b"*3\r\n$7\r\nmessage\r\n$11\r\njob:x:event\r\n$2\r\nhi\r\n"
    b"*2\r\n:1\r\n*2\r\n$3\r\nabc\r\n$-1\r\n"
    b"$6\r\n\xc3\xa9t\xff\xfe!\r\n$4\r\na\r\nb\r\n%bad\r\n"
)


async def test_read_reply_values_equal_jax():
    """Every RESP type (+ - : $ *, null bulk, null array, nested arrays,
    bulk bytes that are not UTF-8, CRLF inside a bulk string, an unknown
    type byte, then the end of the stream) reads back alike."""
    async def read_all(mod):
        conn = mod.RespConnection("redis://127.0.0.1:1/0")
        reader = asyncio.StreamReader()
        reader.feed_data(REPLY_STREAM)
        reader.feed_eof()
        conn._reader = reader
        out = []
        while True:
            try:
                out.append(("value", await conn.read_reply()))
            except (mod.RespError, ConnectionError) as exc:
                out.append((type(exc).__name__, str(exc)))
                if isinstance(exc, ConnectionError):
                    return out

    port, jax_side = await read_all(p_resp), await read_all(j_resp)
    assert port == jax_side
    assert port[0] == ("value", "OK") and port[1] == ("RespError", "ERR wrong type")
    assert ("value", None) in port and port[-1][0] == "ConnectionError"


async def test_double_close_and_a_command_after_the_peer_dropped_match_jax():
    """Closing twice is a no-op; a command whose peer drops the connection
    raises ConnectionError and leaves the connection closed; the next
    command reconnects."""
    async def scenario(mod):
        accepted = []

        async def handle(reader, writer):
            accepted.append(writer)
            await reader.read(1024)
            if len(accepted) == 1:  # the first connection: drop without a reply
                writer.close()
                return
            writer.write(b"+OK\r\n")
            await writer.drain()
            await reader.read(1024)
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        conn = mod.RespConnection(f"redis://127.0.0.1:{port}/0")
        out = []
        try:
            await conn.close()
            await conn.close()
            out.append(conn.connected)
            try:
                await conn.command("GET", "k")
            except ConnectionError as exc:
                out.append((type(exc).__name__, str(exc)))
            out.append(conn.connected)
            out.append(await conn.command("PING"))
            out.append(conn.connected)
            await asyncio.gather(conn.close(), conn.close())
            out.append((conn.connected, len(accepted)))
        finally:
            await conn.close()
            server.close()
            await asyncio.wait_for(server.wait_closed(), STOP_S)
        return out

    port = await asyncio.wait_for(scenario(p_resp), BOUND_S)
    jax_side = await asyncio.wait_for(scenario(j_resp), BOUND_S)
    assert port == jax_side
    assert port == [False, ("ConnectionError", "redis connection closed"), False, "OK", True,
                    (False, 2)]


async def test_a_command_cancelled_before_its_reply_leaves_no_stray_reply():
    """A divergence by design (ROADMAP queue 3 item 22): a command cancelled
    after its write and before its reply (a worker cancels its cancel-flag
    poll when the job ends) leaves that reply in the socket.  The JAX
    connection hands it to the next command -- a cancel flag's "1" then
    answers another job's poll, and that job ends cancelled; the port's
    drops the socket, and the next command reconnects and gets its own."""
    async def run(url, server):
        got = {}
        for side, mod in (("jax", j_resp), ("port", p_resp)):
            conn = mod.RespConnection(url)
            try:
                await conn.command("SET", "job:a:cancel", "1")
                written, read = asyncio.Event(), conn.read_reply

                async def held_read():
                    written.set()
                    await asyncio.Event().wait()  # the reply is never read

                conn.read_reply = held_read
                poll = asyncio.create_task(conn.command("GET", "job:a:cancel"))
                await asyncio.wait_for(written.wait(), BOUND_S)
                conn.read_reply = read
                poll.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await poll
                got[side] = await asyncio.wait_for(conn.command("GET", "job:b:cancel"),
                                                   BOUND_S)
            finally:
                await conn.close()
        assert got == {"jax": "1", "port": None}

    await _with_server(run)


# ------------------------------------------------- over miniredis: the port

async def test_redis_bus_publish_subscribe_roundtrip():
    async def body(url, server):
        bus = p_redis.RedisBus(url, ping_interval=0.05)
        frames = []

        async def subscriber():
            async for f in bus.stream("j1"):
                if f.startswith("data:"):
                    frames.append(f)
                    return

        task = asyncio.create_task(subscriber())
        await _subscribed(server, "j1")
        await bus.emit("j1", "final", {"answer": "hi"})
        await asyncio.wait_for(task, 5)
        payload = json.loads(frames[0][len("data: "):].strip())
        assert payload == {"event": "final", "data": {"answer": "hi"}}
        await bus.close()

    await _with_server(body)


async def test_redis_cancel_flags():
    async def body(url, server):
        flags = p_redis.RedisCancelFlags(url)
        assert not await flags.is_cancelled("j")
        await flags.cancel("j")
        assert await flags.is_cancelled("j")
        key, (value, expiry) = "job:j:cancel", server.kv["job:j:cancel"]
        assert value == "1" and 3590 < expiry - time.monotonic() <= 3600, key
        await flags.close()

    await _with_server(body)


async def test_redis_job_queue_roundtrip():
    async def body(url, server):
        q = p_redis.RedisJobQueue(url)
        job = await q.enqueue_job("run_rag_job", "j-1", {"query": "x"}, _job_id="j-1")
        assert job.job_id == "j-1" and await q.depth() == 1
        got = await asyncio.wait_for(q.dequeue(), 5)
        assert got.job_id == "j-1"
        assert got.function == "run_rag_job"
        assert got.args == ("j-1", {"query": "x"})
        await q.set_result("j-1", {"answer": "done"})
        assert await q.get_result("j-1") == {"answer": "done"}
        assert await q.get_result("nope") is None and await q.depth() == 0
        await q.close()

    await _with_server(body)


# ------------------------------------------------ cross-package wire parity

async def test_frames_cross_between_the_packages():
    """A frame emitted by the JAX RedisBus arrives at the port's stream
    and the other way round, as the same SSE bytes."""
    data = {"answer": "héllo 世界", "sources": [{"doc_id": "c1", "score": 0.5}]}

    async def body(url, server):
        buses = {side: REDIS[side].Bus(url, ping_interval=0.05) for side in REDIS}
        for emitter, listener in (("jax", "port"), ("port", "jax")):
            job = f"{emitter}-to-{listener}"
            frames = []

            async def subscriber():
                async for f in buses[listener].stream(job):
                    if f.startswith("data:"):
                        frames.append(f)
                        return

            task = asyncio.create_task(subscriber())
            await _subscribed(server, job)
            await buses[emitter].emit(job, "final", data)
            await asyncio.wait_for(task, 5)
            assert frames == [sse_frame(encode_event("final", data))]
        for bus in buses.values():
            await bus.close()

    await _with_server(body)


async def test_jobs_and_results_cross_between_the_packages():
    """A job enqueued by one package's queue is dequeued by the other's
    with equal fields, and a result set by one reads back equal from the
    other."""
    async def body(url, server):
        queues = {side: REDIS[side].Queue(url) for side in REDIS}
        try:
            for producer, consumer in (("jax", "port"), ("port", "jax")):
                job_id = f"{producer}-job"
                sent = await queues[producer].enqueue_job(
                    "run_rag_job", job_id, {"query": "q", "top_k": 3}, _job_id=job_id,
                    deadline={"budget_s": 1.5}, trace=None)
                got = await asyncio.wait_for(queues[consumer].dequeue(), 5)
                assert (got.job_id, got.function, got.args, got.kwargs) == \
                    (sent.job_id, sent.function, sent.args, sent.kwargs)
                result = {"answer": "ünïcode", "sources": [], "cancelled": False}
                await queues[consumer].set_result(job_id, result)
                assert await queues[producer].get_result(job_id) == result
            assert server.kv["job:port-job:result"][0] == \
                json.dumps({"answer": "ünïcode", "sources": [], "cancelled": False},
                           ensure_ascii=False)
        finally:
            await queues["port"].close()
            await _close_jax(queues["jax"])

    await _with_server(body)


# ------------------------------------------------------------ fault seams

async def test_redis_send_drop_seam(monkeypatch):
    """``redis.send:drop@2``: every second RESP send raises a
    ConnectionError and closes the socket; the next command reconnects."""
    monkeypatch.setenv("FAULTS", "redis.send:drop@2")
    config.reload_settings()
    reset_faults()

    async def body(url, server):
        flags = p_redis.RedisCancelFlags(url)
        await flags.cancel("j")  # send 1
        with pytest.raises(ConnectionError, match="injected drop at redis.send"):
            await flags.is_cancelled("j")  # send 2: dropped
        assert not flags._conn.connected
        assert await flags.is_cancelled("j")  # send 3 reconnects
        await flags.close()

    await _with_server(body)


async def test_redis_stream_reconnects_after_connection_loss(monkeypatch):
    """Killing the server side of the SUBSCRIBE connection re-subscribes
    (counted in rag_bus_reconnects_total) and delivery resumes."""
    monkeypatch.setenv("RETRY_BASE_SECONDS", "0.01")
    config.reload_settings()

    async def body(url, server):
        bus = p_redis.RedisBus(url, ping_interval=0.1)
        channel = channel_for("jr")
        frames: list[str] = []
        done = asyncio.Event()

        async def subscriber():
            async for f in bus.stream("jr"):
                if f.startswith("data:"):
                    frames.append(f)
                    if len(frames) >= 2:
                        done.set()
                        return

        task = asyncio.create_task(subscriber())
        try:
            await _subscribed(server, "jr")
            await bus.emit("jr", "turn", {"n": 1})
            for _ in range(300):
                if frames:
                    break
                await asyncio.sleep(0.01)
            assert frames, "first event never arrived"
            before = counter_value(BUS_RECONNECTS)
            for w in list(server.subscribers.get(channel, [])):
                w.close()  # server-side kill: LB reap / redis restart
            server.subscribers[channel].clear()
            await _subscribed(server, "jr")
            assert counter_value(BUS_RECONNECTS) - before >= 1
            await bus.emit("jr", "final", {"answer": "hi"})
            await asyncio.wait_for(done.wait(), timeout=5)
            assert '"final"' in frames[-1]
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await bus.close()

    await _with_server(body)


# ------------------------------------------------ the divergence: close()

async def _worker_stack_left_after_shutdown(side: str) -> float | None:
    """A worker stack over one package's Redis classes: its consumer parked
    in BRPOP, a flag polled, an event published; then shut down as that
    package's pods shut down (the bus closed, and whatever of the flags and
    queue has a ``close()``).  Returns None when ``MiniRedis.stop()`` then
    returns within 2 s, else the seconds the bounded stop waited."""
    s = SIDES[side]
    classes = REDIS[side]
    server = MiniRedis()
    port = await server.start()
    url = f"redis://127.0.0.1:{port}/0"
    store, enc = s.Store(), s.Encoder()
    agent = s.Agent(s.FakeLLM(script=AGENT_SCRIPT), s.Factory(store, enc), namespace="default")
    bus, flags, queue = classes.Bus(url, ping_interval=0.05), classes.Flags(url), classes.Queue(url)
    worker = s.Worker(agent, bus, flags, queue, max_jobs=1, job_timeout=5)
    task = asyncio.create_task(worker.run_forever())
    try:
        assert not await flags.is_cancelled("nothing")
        await bus.emit("nothing", "turn", {})
        for _ in range(500):  # the consumer's BRPOP is on the wire
            if queue._pop.connected:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        worker.stop()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await api_main.close_events(bus, flags, queue)
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(server.stop(), 2)
            return None
        except TimeoutError:
            return time.monotonic() - t0
    finally:
        await _close_jax(flags)
        await _close_jax(queue)
        await asyncio.wait_for(server.stop(), STOP_S)


async def test_redis_queue_and_flags_close_their_connections():
    """The port's RedisCancelFlags and RedisJobQueue close their
    connections (the queue's BRPOP one too), so MiniRedis.stop() returns
    after the port's worker stack shuts down.  The JAX classes have no
    close(): the same shutdown leaves their sockets open and the bounded
    stop() times out (where tests/test_chaos.py's Redis stack case hangs
    under Python 3.12)."""
    assert await asyncio.wait_for(_worker_stack_left_after_shutdown("port"), BOUND_S) is None
    waited = await asyncio.wait_for(_worker_stack_left_after_shutdown("jax"), BOUND_S)
    assert waited is not None and waited >= 1.9
    assert not hasattr(j_redis.RedisJobQueue, "close")
    assert not hasattr(j_redis.RedisCancelFlags, "close")


# ------------------------------------- API / worker parity over Redis


class RedisServices:
    """Both packages' API + worker stacks on one event loop in a thread,
    each over its own MiniRedis.  The workers start only when asked, so a
    test can subscribe to a job's stream before the job runs (pub/sub has
    no replay)."""

    def __init__(self, script=None, slow=False):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="rag-redis-services",
                                       daemon=True)
        self.thread.start()
        self.servers, self.ports, self.apis, self.workers, self.tasks, self.parts = \
            {}, {}, {}, {}, {}, {}
        for side, s in SIDES.items():
            server = MiniRedis()
            url = f"redis://127.0.0.1:{self.run(server.start())}/0"
            store, enc = s.Store(), s.Encoder()
            store.upsert("embeddings", [
                s.Doc(d, t, {"namespace": "default", "scope": "chunk", **m}, enc.encode([t])[0])
                for d, t, m in DOCS])
            s.factory.set_store(store)
            fake = _slow(s.FakeLLM) if slow else s.FakeLLM
            llm = s.Metered(fake(script=script or AGENT_SCRIPT))
            agent = s.Agent(llm, s.Factory(store, enc), namespace="default")
            r = REDIS[side]
            bus, flags, queue = r.Bus(url, ping_interval=0.05), r.Flags(url), r.Queue(url)
            self.workers[side] = s.Worker(agent, bus, flags, queue, max_jobs=4, job_timeout=30)
            self.apis[side] = s.Api(bus, flags, queue)
            self.ports[side] = self.run(self.apis[side].start(host="127.0.0.1", port=0))
            self.servers[side], self.parts[side] = server, (bus, flags, queue)

    def run(self, coro, timeout=BOUND_S):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def start_worker(self, side: str, job_ids) -> None:
        """Start ``side``'s worker once every job's stream is subscribed."""
        for job_id in job_ids:
            self.run(_subscribed(self.servers[side], job_id))
        self.tasks[side] = asyncio.run_coroutine_threadsafe(
            self.workers[side].run_forever(), self.loop)

    async def _shutdown(self, side: str) -> None:
        self.workers[side].stop()
        task = self.tasks.get(side)
        if task is not None:
            task.cancel()
        await self.apis[side].stop()
        bus, flags, queue = self.parts[side]
        await bus.close()
        for part in (flags, queue):
            await (part.close() if side == "port" else _close_jax(part))
        await asyncio.wait_for(self.servers[side].stop(), STOP_S)

    def close(self):
        async def shutdown():
            await asyncio.gather(*(self._shutdown(side) for side in SIDES))

        self.run(shutdown())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


@pytest.fixture
def redis_services(monkeypatch):
    made = []

    def make(**kw):
        svc = RedisServices(**kw)
        made.append(svc)
        return svc

    monkeypatch.setenv("DEVICE_INDEX", "off")
    config.reload_settings()
    reset_faults()
    reset_breakers()
    yield make
    for svc in made:
        svc.close()
    factory.reset_store()
    for s in SIDES.values():
        s.factory.reset_store()


def jobs_over_redis(svc, bodies, cancel_after: float | None = None):
    """Per side: POST every body, subscribe to every stream, start the
    worker, read each stream to ``final`` (cancelling the first job after
    ``cancel_after`` seconds when asked), then GET each result."""
    def fn(side, port):
        ids = [request(port, "POST", "/rag/jobs", b)[2]["job_id"] for b in bodies]
        with ThreadPoolExecutor(len(ids)) as pool:
            runs = [pool.submit(events_of, port, j) for j in ids]
            svc.start_worker(side, ids)
            if cancel_after is not None:
                time.sleep(cancel_after)
                status, _, ack = request(port, "POST", f"/rag/jobs/{ids[0]}/cancel")
                assert status == 200 and ack == {"job_id": ids[0], "cancelled": True}
            events = [r.result(BOUND_S) for r in runs]
        results = [request(port, "GET", f"/rag/jobs/{j}/result")[2] for j in ids]
        return [normalized(ev, j) for ev, j in zip(events, ids)], results
    return on_both(svc, fn)


def test_job_lifecycle_over_redis_matches_jax(redis_services):
    svc = redis_services()
    out = jobs_over_redis(svc, [{"query": "how are jobs created?"}])
    assert out["port"] == out["jax"]
    events, results = out["port"]
    kinds = [e["event"] for e in events[0]]
    assert kinds[:2] == ["started", "iteration"] and kinds[-1] == "final"
    assert "turn" in kinds and "retrieval" in kinds and "token" in kinds
    assert events[0][-1]["data"]["answer"] == results[0]["answer"]
    assert "POST /rag/jobs" in results[0]["answer"]


def test_cancel_over_redis_matches_jax(redis_services):
    """The cancel reaches the worker through the Redis flag."""
    svc = redis_services(script=SLOW_SCRIPT, slow=True)
    out = jobs_over_redis(svc, [{"query": "slow question"}], cancel_after=0.5)
    assert out["port"] == out["jax"]
    events, results = out["port"]
    assert events[0][0]["event"] == "started" and events[0][-1]["event"] == "final"
    assert events[0][-1]["data"] == {"answer": "", "sources": [], "cancelled": True}
    assert results[0]["cancelled"] is True


def test_concurrent_jobs_over_redis_match_jax(redis_services):
    svc = redis_services()
    out = jobs_over_redis(svc, [{"query": f"question {i}"} for i in range(4)])
    assert out["port"] == out["jax"]
    assert all(run[-1]["event"] == "final" and run[-1]["data"]["answer"]
               for run in out["port"][0])


# ------------------------------------------------------------ entry points


def test_api_main_no_worker_needs_redis_as_jax():
    from githubrepostorag_tpu.api.__main__ import main as j_main

    codes = []
    for main in (api_main.main, j_main):
        with pytest.raises(SystemExit) as exc:
            main(["--no-worker"])
        codes.append(exc.value.code)
    assert codes == [2, 2]


async def test_worker_pod_serves_a_job_posted_by_a_split_api(monkeypatch, tmp_path):
    """``python -m githubrepostorag_tpu_torch.worker --device cpu`` (the
    real entry point, LLM_BACKEND=fake) consumes a job that an in-process
    ``--redis --no-worker`` API enqueued, answers /metrics, and exits 0 on
    SIGTERM; then no connection is left on MiniRedis."""
    server = MiniRedis()
    redis_port = await server.start()
    url = f"redis://127.0.0.1:{redis_port}/0"
    api_port, metrics_port = _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MESH_SHAPE", "SPEC_DRAFT_MODEL")}
    env.update(REDIS_URL=url, METRICS_PORT=str(metrics_port), LLM_BACKEND="fake",
               DEVICE_INDEX="off", STORE_BACKEND="memory", EMBED_MODEL="/nonexistent",
               LOG_FORMAT="plain", CTRL="off", DATA_DIR=str(tmp_path))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "githubrepostorag_tpu_torch.worker", "--device", "cpu",
        "--host", "127.0.0.1", cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    monkeypatch.setenv("REDIS_URL", url)
    monkeypatch.setenv("DEVICE_INDEX", "off")
    monkeypatch.setenv("LLM_BACKEND", "fake")
    config.reload_settings()
    stop = asyncio.Event()
    monkeypatch.setattr(api_main, "stop_event", lambda: stop)
    api = asyncio.create_task(api_main.serve("127.0.0.1", api_port, "cpu", use_redis=True,
                                             run_worker=False))
    loop = asyncio.get_running_loop()

    def call(*args):
        return loop.run_in_executor(None, request, *args)

    async def body():
        for _ in range(200):
            try:
                status, _, reply = await call(api_port, "POST", "/rag/jobs",
                                              {"query": "how are jobs created?"})
                break
            except OSError:
                await asyncio.sleep(0.05)
        assert status == 200, reply
        for _ in range(300):  # the worker pod starts, dequeues and runs it
            assert proc.returncode is None
            status, _, result = await call(api_port, "GET",
                                           f"/rag/jobs/{reply['job_id']}/result")
            if status == 200:
                break
            await asyncio.sleep(0.05)
        assert status == 200 and "answer" in result and "error" not in result
        status, _, text = await call(metrics_port, "GET", "/metrics", None, None, True)
        assert status == 200 and b'rag_jobs_total{status="ok"} 1.0' in text
        assert b"rag_bus_reconnects_total" in text
        proc.send_signal(signal.SIGTERM)
        out = (await asyncio.wait_for(proc.communicate(), 15))[0].decode()
        assert proc.returncode == 0, out
        assert "RAG worker stopped" in out
        stop.set()
        await api

    try:
        await asyncio.wait_for(body(), BOUND_S)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.communicate()
        stop.set()
        await asyncio.gather(api, return_exceptions=True)
        factory.reset_store()
        await asyncio.wait_for(server.stop(), STOP_S)
