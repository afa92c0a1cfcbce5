"""The port's stdlib OpenAI-compatible server against the JAX package's
aiohttp one, over real sockets with stdlib clients.

One pair of servers for the module, on one event loop in a background
thread: the JAX ``OpenAIServer`` over the JAX tiny ``Engine`` (f32 KV), and
the port's over the port's ``Engine`` on ``params_from_jax`` of the same
tree (``device="cpu"``), both with ``ByteTokenizer``.  The same greedy
requests to each must give the same text, finish reason and usage, streamed
and not; stop strings the same truncation; malformed bodies 400 from both.
Then the port alone: keep-alive, concurrent streams, a client that goes
away mid-stream (its request is cancelled and its pages freed), HTTP
errors, and ``stop()`` with the driver mid-step not blocking the loop.
GET /debug/index renders the same live-index payload as the JAX server's."""

from __future__ import annotations

import asyncio
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu.serving import Engine as JEngine
from githubrepostorag_tpu.serving.async_engine import AsyncEngine as JAsyncEngine
from githubrepostorag_tpu.serving.openai_api import OpenAIServer as JOpenAIServer
from githubrepostorag_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine, SamplingParams
from githubrepostorag_tpu_torch.serving.openai_api import MAX_BODY, OpenAIServer
from githubrepostorag_tpu_torch.serving.tokenizer import ByteTokenizer

ENGINE_KW = dict(max_num_seqs=4, num_pages=256, page_size=8, max_seq_len=512, prefill_chunk=32)
NAME = "tiny-test"
HI = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 8, "temperature": 0}


@pytest.fixture(scope="module")
def servers():
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    # x4: greedy decoding of the tiny random model walks varied tokens
    jp = jax.tree.map(lambda x: x * 4 if x.ndim >= 2 else x, j_init(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    j_srv = JOpenAIServer(JAsyncEngine(JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW)),
                          JByteTokenizer(), model_name=NAME)
    engine = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **ENGINE_KW)
    t_srv = OpenAIServer(AsyncEngine(engine), ByteTokenizer(), model_name=NAME)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="servers", daemon=True)
    thread.start()

    def run(coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    j_port, t_port = run(j_srv.start("127.0.0.1", 0)), run(t_srv.start("127.0.0.1", 0))
    try:
        yield SimpleNamespace(jax=j_port, port=t_port, engine=engine, server=t_srv, run=run)
    finally:
        run(t_srv.stop())
        run(j_srv.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()


def _request(port: int, method: str, path: str, body=None, raw: bytes | None = None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def _post(port, path, body=None, raw=None):
    status, _, data = _request(port, "POST", path, body, raw)
    return status, json.loads(data)


def _sse(data: bytes) -> list:
    """The events of an SSE body: parsed JSON objects, then "[DONE]"."""
    events = []
    for block in data.decode().split("\n\n"):
        if block:
            assert block.startswith("data: "), block
            payload = block[len("data: "):]
            events.append(payload if payload == "[DONE]" else json.loads(payload))
    return events


def _strip(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if k not in ("id", "created")}


@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions", HI),
    ("/v1/chat/completions", {"messages": [{"role": "system", "content": "terse"},
                                           {"role": "user", "content": "tell me a story"}],
                              "max_completion_tokens": 6, "temperature": 0}),
    ("/v1/completions", {"prompt": "xyz 123", "max_tokens": 8, "temperature": 0}),
    ("/v1/completions", {"prompt": "abc", "max_tokens": 8, "temperature": 0}),  # EOS at once
])
def test_greedy_replies_match_jax(servers, path, body):
    status, port = _post(servers.port, path, body)
    j_status, ref = _post(servers.jax, path, body)
    assert status == j_status == 200
    assert _strip(port) == _strip(ref)
    assert port["id"].startswith("chatcmpl-" if "chat" in path else "cmpl-")


def test_stream_matches_nonstream_and_jax(servers):
    body = dict(HI, stream=True)
    status, headers, data = _request(servers.port, "POST", "/v1/chat/completions", body)
    assert status == 200 and headers["Content-Type"] == "text/event-stream"
    assert headers["Transfer-Encoding"] == "chunked"
    events = _sse(data)
    ref = _sse(_request(servers.jax, "POST", "/v1/chat/completions", body)[2])
    assert events[-1] == ref[-1] == "[DONE]"
    assert [_strip(e) for e in events[:-1]] == [_strip(e) for e in ref[:-1]]
    assert [sorted(e) for e in events[:-1]] == [sorted(e) for e in ref[:-1]]
    final = events[-2]["choices"][0]
    assert final["delta"] == {} and final["finish_reason"] == "length"
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in events[:-1])
    assert text == _post(servers.port, "/v1/chat/completions", HI)[1]["choices"][0]["message"][
        "content"]


@pytest.mark.parametrize("stream", [False, True])
def test_stop_string_truncates_as_jax(servers, stream):
    """"Z!" completes inside the reply to "hi": the text stops before it and
    the request is cancelled.  completion_tokens is left out: it counts the
    tokens the engine made before the cancel landed."""
    body = dict(HI, stop="Z!", stream=stream)
    got = []
    for port in (servers.port, servers.jax):
        status, _, data = _request(port, "POST", "/v1/chat/completions", body)
        assert status == 200
        if stream:
            events = _sse(data)
            got.append(("".join(e["choices"][0]["delta"].get("content", "")
                                for e in events[:-1]), events[-2]["choices"][0]["finish_reason"]))
        else:
            choice = json.loads(data)["choices"][0]
            got.append((choice["message"]["content"], choice["finish_reason"]))
    assert got[0] == got[1]
    assert got[0][1] == "stop" and "Z!" not in got[0][0]


@pytest.mark.parametrize("path,raw", [
    ("/v1/chat/completions", b"{not json"),
    ("/v1/chat/completions", b'{"max_tokens": 4}'),
    ("/v1/completions", b'{"messages": []}'),
])
def test_malformed_body_is_400_on_both(servers, path, raw):
    for port in (servers.port, servers.jax):
        status, payload = _post(port, path, raw=raw)
        assert status == 400 and payload["error"]["type"] == "invalid_request_error"


def test_models_and_health_match_jax(servers):
    models = [json.loads(_request(p, "GET", "/v1/models")[2]) for p in (servers.port, servers.jax)]
    assert models[0] == models[1] and models[0]["data"][0]["id"] == NAME
    health = [json.loads(_request(p, "GET", "/health")[2]) for p in (servers.port, servers.jax)]
    assert sorted(health[0]) == sorted(health[1]) and health[0]["status"] == "ok"


def test_debug_index_matches_jax(servers):
    """GET /debug/index: {"enabled": false} from both with no applier
    registered; with appliers that drained the same ops into device
    indexes, the same payload, key for key and value for value."""
    from githubrepostorag_tpu.ingest.stream import MutationLog as JMutationLog
    from githubrepostorag_tpu.retrieval import live_index as j_live
    from githubrepostorag_tpu.retrieval.device_index import DeviceIndexedStore as JIndex
    from githubrepostorag_tpu.store.base import Doc as JDoc
    from githubrepostorag_tpu.store.memory import MemoryVectorStore as JMemory
    from githubrepostorag_tpu_torch.ingest.stream import MutationLog
    from githubrepostorag_tpu_torch.retrieval import live_index
    from githubrepostorag_tpu_torch.retrieval.device_index import DeviceIndexedStore
    from githubrepostorag_tpu_torch.store.base import Doc
    from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

    def get_both():
        out = []
        for port in (servers.port, servers.jax):
            status, _, data = _request(port, "GET", "/debug/index")
            assert status == 200
            out.append(json.loads(data))
        return out

    assert get_both() == [{"enabled": False}] * 2
    rng = np.random.default_rng(0)
    rows = [(f"d{i}", f"text {i}", {"repo": f"r{i % 2}"}, rng.normal(size=8).astype(np.float32))
            for i in range(10)]
    appliers = []
    for log, index, doc in ((MutationLog(),
                             DeviceIndexedStore(MemoryVectorStore(), max_wave=4, device="cpu"), Doc),
                            (JMutationLog(), JIndex(JMemory(), max_wave=4), JDoc)):
        log.append_upsert("t", [doc(i, t, dict(m), v.copy()) for i, t, m, v in rows])
        log.append_delete("t", ["d3"])
        appliers.append((log, index))
    t_app = live_index.LiveIndexApplier(*appliers[0])
    j_app = j_live.LiveIndexApplier(*appliers[1])
    assert t_app.drain() == j_app.drain() == 11
    live_index.register_live_applier(t_app)
    j_live.register_live_applier(j_app)
    try:
        port_payload, jax_payload = get_both()
    finally:
        live_index.register_live_applier(None)
        j_live.register_live_applier(None)
    assert port_payload == jax_payload
    assert port_payload["enabled"] is True and port_payload["watermark"]["applied"] == 11
    assert port_payload["tables"]["t"]["live_rows"] == 9


def test_keep_alive_and_http_errors(servers):
    conn = http.client.HTTPConnection("127.0.0.1", servers.port, timeout=60)
    try:
        seen = []
        for method, path, body in (("GET", "/health", None),
                                   ("POST", "/v1/completions",
                                    json.dumps({"prompt": "hey", "max_tokens": 3,
                                                "temperature": 0})),
                                   ("GET", "/nope", None), ("GET", "/v1/completions", None)):
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            seen.append((resp.status, resp.getheader("Allow"), json.loads(resp.read())))
        sock = conn.sock
        conn.request("GET", "/v1/models")  # still the same socket
        assert conn.sock is sock and conn.getresponse().status == 200
    finally:
        conn.close()
    assert [s for s, _, _ in seen] == [200, 200, 404, 405]
    assert seen[3][1] == "POST" and "error" in seen[2][2] and "error" in seen[3][2]
    # a body of MAX_BODY bytes is refused before it is sent; a chunked body
    # is read (the cases below ask both packages' servers)
    with socket.create_connection(("127.0.0.1", servers.port), timeout=30) as s:
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
                  % MAX_BODY)
        assert s.recv(4096).startswith(b"HTTP/1.1 413 ")


def _raw_exchange(port: int, head: bytes, body: bytes = b"", wait_continue: bool = False):
    """Send one request with ``Connection: close`` over a raw socket and read
    to the end: (interim status lines, final status, final body).  With
    ``wait_continue`` the body goes out only after the server's ``100
    Continue``, as curl sends a large body."""
    head = head.rstrip(b"\r\n") + b"\r\nConnection: close\r\n\r\n"
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        data = b""
        if wait_continue:
            s.sendall(head)
            while b"\r\n\r\n" not in data:
                data += s.recv(65536)
            s.sendall(body)
        else:
            # one write: aiohttp 3.13 answers a malformed chunk that arrives
            # with the head, and hangs on one that arrives after it
            s.sendall(head + body)
        while chunk := s.recv(65536):
            data += chunk
    interim = []
    while data.startswith(b"HTTP/1.1 1"):
        line, _, data = data.partition(b"\r\n\r\n")
        interim.append(line.decode())
    head_part, _, payload = data.partition(b"\r\n\r\n")
    return interim, int(head_part.split(b" ", 2)[1]), payload


def _chunked(data: bytes, size: int) -> bytes:
    """``data`` in chunks of ``size`` bytes, one with an extension, and a trailer."""
    parts = [b"%x;ext=1\r\n%s\r\n" % (len(data[i:i + size]), data[i:i + size])
             for i in range(0, len(data), size)]
    return b"".join(parts) + b"0\r\nX-Trailer: 1\r\n\r\n"


COMPLETION = {"prompt": "xyz 123", "max_tokens": 6, "temperature": 0}
POST_COMPLETIONS = b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"


@pytest.mark.parametrize("case", ["chunked", "expect_large_body", "expect_chunked",
                                  "expect_unknown", "expect_http10", "chunked_too_large",
                                  "chunked_bad_size", "gzip_coding", "coding_and_length"])
def test_request_bodies_answered_as_jax(servers, case):
    """Chunked request bodies and ``Expect`` as the JAX aiohttp server answers
    them: the same interim and final status on both, and for a body that
    reaches the handler the same completion."""
    body = json.dumps(COMPLETION).encode()
    # a curl-style large body: 300 kB of padding in a field the handler ignores
    large = json.dumps({**COMPLETION, "user": "u" * 300_000}).encode()
    chunked = b"\r\nTransfer-Encoding: chunked"
    head, payload, wait = {
        "chunked": (POST_COMPLETIONS + chunked, _chunked(body, 7), False),
        "expect_large_body": (POST_COMPLETIONS + b"\r\nExpect: 100-continue\r\n"
                              b"Content-Length: %d" % len(large), large, True),
        "expect_chunked": (POST_COMPLETIONS + chunked + b"\r\nExpect: 100-Continue",
                           _chunked(large, 65536), True),
        "expect_unknown": (POST_COMPLETIONS + b"\r\nExpect: nothing\r\n"
                           b"Content-Length: %d" % len(body), body, False),
        "expect_http10": (POST_COMPLETIONS.replace(b"HTTP/1.1", b"HTTP/1.0")
                          + b"\r\nExpect: 100-continue\r\nContent-Length: %d" % len(body),
                          body, False),
        "chunked_too_large": (POST_COMPLETIONS + chunked, _chunked(b" " * MAX_BODY, 1 << 16),
                              False),
        "chunked_bad_size": (POST_COMPLETIONS + chunked, b"zz\r\n", False),
        "gzip_coding": (POST_COMPLETIONS + b"\r\nTransfer-Encoding: gzip", b"", False),
        "coding_and_length": (POST_COMPLETIONS + chunked + b"\r\nContent-Length: 5",
                              b"0\r\n\r\n", False),
    }[case]
    got = {side: _raw_exchange(port, head, payload, wait)
           for side, port in (("jax", servers.jax), ("port", servers.port))}
    (j_interim, j_status, j_body), (interim, status, data) = got["jax"], got["port"]
    assert (interim, status) == (j_interim, j_status), case
    want_status = {"chunked": 200, "expect_large_body": 200, "expect_chunked": 200,
                   "expect_unknown": 417, "expect_http10": 200, "chunked_too_large": 413,
                   "chunked_bad_size": 400, "gzip_coding": 400, "coding_and_length": 400}[case]
    assert status == want_status
    assert interim == (["HTTP/1.1 100 Continue"] if case.startswith("expect_") and status == 200
                       and case != "expect_http10" else [])
    if status == 200:
        assert _strip(json.loads(data)) == _strip(json.loads(j_body))
        assert json.loads(data)["choices"][0]["text"]


def test_concurrent_streams_all_finish(servers):
    def one(i):
        body = {"prompt": f"prompt {i} " * (i + 1), "max_tokens": 8, "temperature": 0,
                "stream": True}
        events = _sse(_request(servers.port, "POST", "/v1/completions", body)[2])
        return events[-2]["choices"][0]["finish_reason"], events[-1]

    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(one, range(4)))
    assert all(r[1] == "[DONE]" and r[0] in ("stop", "length") for r in results)


def test_client_gone_mid_stream_frees_pages(servers):
    cancelled = []
    aeng = servers.server.engine
    real_cancel = aeng.cancel

    async def spy(rid):
        cancelled.append(rid)
        await real_cancel(rid)

    aeng.cancel = spy
    try:
        body = json.dumps({"prompt": "a long one", "max_tokens": 400, "temperature": 0,
                           "stream": True}).encode()
        with socket.create_connection(("127.0.0.1", servers.port), timeout=30) as s:
            s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                      b"application/json\r\nContent-Length: %d\r\n\r\n%s" % (len(body), body))
            assert s.recv(4096).startswith(b"HTTP/1.1 200 ")  # the stream has begun
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            stats = json.loads(_request(servers.port, "GET", "/health")[2])
            if cancelled and stats["running"] == 0 and stats["free_pages"] == stats["total_pages"]:
                break
            time.sleep(0.05)
    finally:
        del aeng.cancel
    assert len(cancelled) == 1 and cancelled[0].startswith("cmpl-")
    assert stats["running"] == 0 and stats["free_pages"] == stats["total_pages"]


async def test_stop_with_the_driver_mid_step_keeps_the_loop_running():
    """stop() ends open connections and joins the engine's driver off the
    loop: a step that takes 0.5 s stalls no coroutine."""
    cfg = Qwen2Config.tiny()
    g = torch.Generator().manual_seed(0)
    from githubrepostorag_tpu_torch.models.qwen2 import init_params

    engine = Engine(init_params(cfg, g, device="cpu"), cfg, kv_dtype=torch.float32,
                    device="cpu", max_num_seqs=2, num_pages=32, page_size=8, max_seq_len=64)
    real_step = engine.step

    def slow_step():
        time.sleep(0.5)
        return real_step()

    engine.step = slow_step
    server = OpenAIServer(AsyncEngine(engine), ByteTokenizer())
    await server.start("127.0.0.1", 0)
    work = asyncio.create_task(server.engine.generate([1, 2, 3], SamplingParams(max_tokens=2)))
    await asyncio.sleep(0.1)  # the driver is inside the slow step now
    ticks = 0

    async def ticker():
        nonlocal ticks
        while True:
            await asyncio.sleep(0.01)
            ticks += 1

    tick_task = asyncio.create_task(ticker())
    t0 = time.monotonic()
    await server.stop()
    elapsed = time.monotonic() - t0
    tick_task.cancel()
    work.cancel()
    await asyncio.gather(tick_task, work, return_exceptions=True)
    assert elapsed > 0.2  # it did wait for the step
    assert ticks >= 0.5 * elapsed / 0.01, (ticks, elapsed)


async def test_a_request_arriving_mid_run_is_admitted_at_once():
    """A request that arrives while another streams is admitted within a
    step or two, not after the first finishes: the event loop never waits
    for the driver."""
    from githubrepostorag_tpu_torch.models.qwen2 import init_params

    cfg = Qwen2Config.tiny()
    engine = Engine(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg,
                    kv_dtype=torch.float32, device="cpu", max_num_seqs=2, num_pages=64,
                    page_size=8, max_seq_len=256, decode_burst=1)
    real_step, real_add = engine.step, engine.add_request
    admitted = {}

    def slow_step():
        time.sleep(0.01)  # a step of the card's length, with the GIL free
        return real_step()

    def add(prompt, sampling=None, **kw):
        admitted[kw["request_id"]] = time.monotonic()
        return real_add(prompt, sampling, **kw)

    engine.step, engine.add_request = slow_step, add
    server = OpenAIServer(AsyncEngine(engine), ByteTokenizer())
    port = await server.start("127.0.0.1", 0)
    loop = asyncio.get_running_loop()
    try:
        body = {"prompt": "first", "max_tokens": 60, "temperature": 0, "stream": True}
        first = loop.run_in_executor(None, _request, port, "POST", "/v1/completions", body)
        while not admitted:
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.1)  # the first request is decoding now
        t_sent = time.monotonic()
        second = await loop.run_in_executor(None, _post, port, "/v1/completions",
                                            {"prompt": "second", "max_tokens": 2,
                                             "temperature": 0})
        t_second = time.monotonic()
        events = _sse((await first)[2])
        t_first = time.monotonic()
    finally:
        await server.stop()
    assert second[0] == 200 and events[-1] == "[DONE]"
    assert admitted[second[1]["id"]] - t_sent < 0.2
    assert t_second < t_first


def test_debug_plane_routes_match_jax_and_the_golden(servers):
    """GET /debug/slo, /debug/fleet, /debug/hbm and /debug/timeline after
    traffic: the JAX server's statuses and top-level keys, bodies that
    conform to the committed golden schemas, the timeline's window and its
    400; POST /debug/fleet/drain and /activate: JAX's single-engine 404."""
    from githubrepostorag_tpu_torch.obs.hbm import get_hbm_plane
    from githubrepostorag_tpu_torch.obs.slo import get_slo_plane
    from test_torch_obs_planes import conforms, golden, shape

    # another test's server may have registered its own engine as r0 since
    aeng = servers.server.engine
    get_slo_plane().register("r0", ledger=aeng.ledger, monitor=aeng.slo, stats=aeng.stats)
    get_hbm_plane().register("r0", aeng.page_obs)
    assert _post(servers.port, "/v1/completions", {"prompt": "obs", "max_tokens": 4,
                                                   "temperature": 0})[0] == 200
    assert _post(servers.jax, "/v1/completions", {"prompt": "obs", "max_tokens": 4,
                                                  "temperature": 0})[0] == 200
    slo_g, tl_g = golden("debug_slo_schema.json"), golden("debug_timeline_schema.json")
    bodies = {}
    for path in ("/debug/slo", "/debug/fleet", "/debug/hbm", "/debug/timeline",
                 "/debug/timeline?window_s=30"):
        out = {}
        for side in ("port", "jax"):
            status, _, data = _request(getattr(servers, side), "GET", path)
            out[side] = (status, json.loads(data))
        assert out["port"][0] == out["jax"][0] == 200, path
        assert sorted(out["port"][1]) == sorted(out["jax"][1]), path
        bodies[path] = out["port"][1]
    conforms(shape(bodies["/debug/slo"]), slo_g["GET /debug/slo"])
    conforms(shape(bodies["/debug/fleet"]), slo_g["GET /debug/fleet"])
    conforms(shape(bodies["/debug/hbm"]), tl_g["GET /debug/hbm"])
    tl = bodies["/debug/timeline?window_s=30"]
    conforms(shape({**tl, "traceEvents": []}), tl_g["GET /debug/timeline"])
    assert tl["metadata"]["window_s"] == 30.0 and tl["metadata"]["replicas"] == ["r0"]
    assert tl["metadata"]["sources"]["steps"] > 0
    fleet = bodies["/debug/fleet"]
    assert fleet["fleet"]["replicas"] == 1 and fleet["replicas"][0]["stats"]["total_pages"] == 256
    assert fleet["replicas"][0]["ledger"]["tokens"]["committed"] > 0
    hbm = bodies["/debug/hbm"]["replicas"]["r0"]
    assert hbm["attribution"]["finished_requests"] > 0
    for side in ("port", "jax"):
        status, _, data = _request(getattr(servers, side), "GET", "/debug/timeline?window_s=x")
        assert status == 400 and json.loads(data)["error"]["message"] == "window_s must be a number"
        for verb in ("drain", "activate"):
            status, body = _post(getattr(servers, side), f"/debug/fleet/{verb}", {"replica": "r0"})
            assert status == 404
            assert body["error"]["message"] == "fleet lifecycle requires replica groups"
