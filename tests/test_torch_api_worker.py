"""The port's RAG API and worker against the JAX package's, over real
sockets: the JAX ``RagApi`` (aiohttp) and the port's (stdlib HTTP) run
side by side on one event loop in a thread, each with its own worker,
agent, ``FakeLLM`` script and store; stdlib clients send both the same
requests.  Status codes, SSE event sequences (job ids, trace ids and
phase times aside), kept results and health keys must match.  The cases
are those of ``tests/test_api_worker.py``.  The entry point runs in a
subprocess over a tiny checkpoint, with the in-process engine."""

from __future__ import annotations

import asyncio
import http.client
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
import torch

import githubrepostorag_tpu.store.factory as j_factory
from githubrepostorag_tpu.agent import GraphAgent as JGraphAgent
from githubrepostorag_tpu.api.app import RagApi as JRagApi
from githubrepostorag_tpu.config import reload_settings as j_reload
from githubrepostorag_tpu.embedding import HashingTextEncoder as JEncoder
from githubrepostorag_tpu.events import (MemoryBus as JBus, MemoryCancelFlags as JFlags,
                                         MemoryJobQueue as JQueue)
from githubrepostorag_tpu.llm import FakeLLM as JFakeLLM
from githubrepostorag_tpu.metrics import MeteredLLM as JMeteredLLM
from githubrepostorag_tpu.retrieval import RetrieverFactory as JFactory
from githubrepostorag_tpu.store import Doc as JDoc, MemoryVectorStore as JStore
from githubrepostorag_tpu.worker import RagWorker as JRagWorker
from githubrepostorag_tpu_torch import config
from githubrepostorag_tpu_torch.agent import GraphAgent
from githubrepostorag_tpu_torch.api.app import RagApi
from githubrepostorag_tpu_torch.embedding import HashingTextEncoder
from githubrepostorag_tpu_torch.events import (MemoryBus, MemoryCancelFlags, MemoryJobQueue,
                                               reset_memory_hub)
from githubrepostorag_tpu_torch.llm import FakeLLM
from githubrepostorag_tpu_torch.metrics import MeteredLLM
from githubrepostorag_tpu_torch.obs import reset_recorder
from githubrepostorag_tpu_torch.resilience import reset_breakers, reset_faults
from githubrepostorag_tpu_torch.retrieval import RetrieverFactory
from githubrepostorag_tpu_torch.store import factory
from githubrepostorag_tpu_torch.store.base import Doc
from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore
from githubrepostorag_tpu_torch.worker import RagWorker
from test_torch_serving_main import ROOT, SERVER_ENV, _free_port, checkpoint  # noqa: F401

SIDES = {
    "jax": SimpleNamespace(Agent=JGraphAgent, Api=JRagApi, Encoder=JEncoder, Bus=JBus,
                           Flags=JFlags, Queue=JQueue, FakeLLM=JFakeLLM, Metered=JMeteredLLM,
                           Factory=JFactory, Store=JStore, Doc=JDoc, Worker=JRagWorker,
                           factory=j_factory),
    "port": SimpleNamespace(Agent=GraphAgent, Api=RagApi, Encoder=HashingTextEncoder, Bus=MemoryBus,
                            Flags=MemoryCancelFlags, Queue=MemoryJobQueue, FakeLLM=FakeLLM,
                            Metered=MeteredLLM, Factory=RetrieverFactory, Store=MemoryVectorStore,
                            Doc=Doc, Worker=RagWorker, factory=factory),
}

AGENT_SCRIPT = {
    r"Pick the retrieval scope": '{"scope": "chunk", "filters": {}}',
    r"Assess whether the retrieved": '{"coverage": 0.9, "needs_more": false}',
    r"senior engineer": "Jobs are created via POST /rag/jobs [1].",
}
SLOW_SCRIPT = {
    r"Pick the retrieval scope": '{"scope": "chunk", "filters": {}}',
    r"Assess whether the retrieved": '{"coverage": 0.2, "needs_more": true}',
    r"Rephrase": "retry query",
    r"alternative search": '["alt"]',
    r"senior engineer": "should never get here",
}
DOCS = [
    ("c1", "async def create_job(request): enqueue and return job id",
     {"repo": "api", "module": "app", "file_path": "app/jobs.py"}),
    ("c2", "class RagWorker: consumes jobs and emits progress events",
     {"repo": "api", "module": "worker", "file_path": "worker/worker.py"}),
    ("c3", "def health_report(): aggregate store and llm probes",
     {"repo": "api", "module": "app", "file_path": "app/health.py"}),
]


def _slow(fake_cls):
    class SlowLLM(fake_cls):
        def complete(self, prompt, **kw):
            time.sleep(0.3)
            return super().complete(prompt, **kw)

    return SlowLLM


class Services:
    """Both packages' API + worker stacks on one event loop in a thread."""

    def __init__(self, script=None, slow=False, max_jobs=4):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="rag-services",
                                       daemon=True)
        self.thread.start()
        self.ports, self.apis, self.workers, self.tasks = {}, {}, {}, {}
        for side, s in SIDES.items():
            store, enc = s.Store(), s.Encoder()
            store.upsert("embeddings", [
                s.Doc(d, t, {"namespace": "default", "scope": "chunk", **m}, enc.encode([t])[0])
                for d, t, m in DOCS])
            s.factory.set_store(store)  # /health probes the process-wide store
            fake = _slow(s.FakeLLM) if slow else s.FakeLLM
            llm = s.Metered(fake(script=script or AGENT_SCRIPT))
            agent = s.Agent(llm, s.Factory(store, enc), namespace="default")
            bus = s.Bus(ping_interval=0.05)
            flags, queue = s.Flags(), s.Queue()
            worker = s.Worker(agent, bus, flags, queue, max_jobs=max_jobs, job_timeout=30)
            api = s.Api(bus, flags, queue)
            self.ports[side] = self.run(api.start(host="127.0.0.1", port=0))
            self.apis[side], self.workers[side] = api, worker
            self.tasks[side] = asyncio.run_coroutine_threadsafe(worker.run_forever(), self.loop)

    def run(self, coro, timeout=30):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        for side in SIDES:
            self.workers[side].stop()
            self.tasks[side].cancel()
            self.run(self.apis[side].stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


@pytest.fixture
def services(monkeypatch):
    made = []

    def make(**kw):
        svc = Services(**kw)
        made.append(svc)
        return svc

    monkeypatch.setenv("DEVICE_INDEX", "off")
    config.reload_settings()
    reset_memory_hub()
    reset_faults()
    reset_breakers()
    reset_recorder()
    yield make
    for svc in made:
        svc.close()
    factory.reset_store()
    j_factory.reset_store()
    reset_memory_hub()
    monkeypatch.undo()
    config.reload_settings()
    j_reload()


def request(port, method, path, body=None, headers=None, raw=False):
    """(status, headers, JSON body or raw bytes) on a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json",
                                                       **(headers or {})})
        resp = conn.getresponse()
        payload = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        if raw or not payload:
            return resp.status, hdrs, payload
        return resp.status, hdrs, json.loads(payload)
    finally:
        conn.close()


def events_of(port, job_id):
    """Every SSE data event of the job, read until ``final``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", f"/rag/jobs/{job_id}/events")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Content-Type", "").startswith(
            "text/event-stream")
        out = []
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                out.append(json.loads(line[len("data: "):]))
                if out[-1]["event"] == "final":
                    break
        return out
    finally:
        conn.close()


def normalized(events, job_id):
    """Events with the job id, trace id and phase times taken out."""
    out = []
    for ev in events:
        data = dict(ev["data"])
        if data.get("job_id") == job_id:
            data["job_id"] = "<job>"
        if "trace_id" in data:
            data["trace_id"] = "<trace>"
        if "phases" in data:
            data["phases"] = sorted(data["phases"])
        out.append({"event": ev["event"], "data": data})
    return out


def on_both(svc, fn):
    """``fn(side, port)`` for both sides at once, from two client threads."""
    with ThreadPoolExecutor(2) as pool:
        futs = {side: pool.submit(fn, side, port) for side, port in svc.ports.items()}
        return {side: f.result(60) for side, f in futs.items()}


def post_and_follow(body):
    def fn(side, port):
        status, _, reply = request(port, "POST", "/rag/jobs", body)
        assert status == 200, reply
        job_id = reply["job_id"]
        events = events_of(port, job_id)
        _, _, result = request(port, "GET", f"/rag/jobs/{job_id}/result")
        return {"reply_keys": sorted(reply), "id_len": len(job_id),
                "events": normalized(events, job_id), "result": result,
                "trace_id": reply.get("trace_id")}
    return fn


def test_job_lifecycle_events_and_result_match_jax(services):
    svc = services()
    out = on_both(svc, post_and_follow({"query": "how are jobs created?"}))
    assert out["port"]["events"] == out["jax"]["events"]
    assert out["port"]["result"] == out["jax"]["result"]
    assert out["port"]["reply_keys"] == ["job_id", "trace_id"] and out["port"]["id_len"] == 32
    kinds = [e["event"] for e in out["port"]["events"]]
    assert kinds[:2] == ["started", "iteration"] and kinds[-1] == "final"
    assert "turn" in kinds and "retrieval" in kinds
    assert kinds.index("token") < kinds.index("final")  # tokens stream before final
    final = out["port"]["events"][-1]["data"]
    streamed = "".join(e["data"]["text"] for e in out["port"]["events"] if e["event"] == "token")
    assert streamed.strip() == final["answer"] == out["port"]["result"]["answer"]
    assert "POST /rag/jobs" in final["answer"] and final["sources"]


def test_job_trace_matches_jax(services):
    svc = services()
    out = on_both(svc, post_and_follow({"query": "how are jobs created?"}))

    def trace(side, port):
        status, _, payload = request(port, "GET", f"/debug/traces/{out[side]['trace_id']}")
        _, _, listing = request(port, "GET", "/debug/traces")
        missing = request(port, "GET", "/debug/traces/" + "0" * 32)[0]
        return (status, sorted(payload), sorted(sp["name"] for sp in payload["spans"]),
                sorted(listing), listing["traces"][0]["root"], missing)

    got = on_both(svc, trace)
    assert got["port"] == got["jax"]
    names = got["port"][2]
    assert {"worker.job", "agent.run", "agent.plan", "agent.retrieve", "agent.judge",
            "agent.synthesize", "llm.complete", "llm.stream"} <= set(names)


def test_cancel_mid_run_matches_jax(services):
    svc = services(script=SLOW_SCRIPT, slow=True)

    def fn(side, port):
        _, _, reply = request(port, "POST", "/rag/jobs", {"query": "slow question"})
        job_id = reply["job_id"]
        time.sleep(0.5)  # let it get into the loop
        status, _, cancel = request(port, "POST", f"/rag/jobs/{job_id}/cancel")
        events = events_of(port, job_id)
        _, _, result = request(port, "GET", f"/rag/jobs/{job_id}/result")
        return status, cancel == {"job_id": job_id, "cancelled": True}, events[0]["event"], \
            events[-1]["event"], events[-1]["data"], result

    out = on_both(svc, fn)
    assert out["port"] == out["jax"]
    assert out["port"][4] == {"answer": "", "sources": [], "cancelled": True}


@pytest.mark.parametrize("body", [b"nope", b"{}", b'{"query": 5}',
                                  b'{"query": "q", "deadline_ms": 0}',
                                  b'{"query": "q", "deadline_ms": -5}'])
def test_bad_request_400_matches_jax(services, body):
    svc = services()
    out = on_both(svc, lambda side, port: request(port, "POST", "/rag/jobs", body))
    assert out["port"][0] == out["jax"][0] == 400
    assert out["port"][2] == out["jax"][2]  # the same error text
    assert "error" in out["port"][2]


def test_queue_full_sheds_429_matches_jax(services, monkeypatch):
    monkeypatch.setenv("JOB_QUEUE_MAX_DEPTH", "0")
    config.reload_settings()
    j_reload()
    svc = services()
    out = on_both(svc, lambda side, port: request(port, "POST", "/rag/jobs", {"query": "q"}))
    assert out["port"][0] == out["jax"][0] == 429
    assert out["port"][1]["retry-after"] == out["jax"][1]["retry-after"] == "30"
    assert out["port"][2] == out["jax"][2]


def test_concurrent_jobs_match_jax(services):
    svc = services()

    def fn(side, port):
        ids = [request(port, "POST", "/rag/jobs", {"query": f"question {i}"})[2]["job_id"]
               for i in range(4)]
        with ThreadPoolExecutor(4) as pool:
            runs = list(pool.map(lambda j: normalized(events_of(port, j), j), ids))
        return runs

    out = on_both(svc, fn)
    assert out["port"] == out["jax"]
    assert all(run[-1]["event"] == "final" and run[-1]["data"]["answer"] for run in out["port"])


def test_per_request_top_k_matches_jax(services):
    svc = services()
    capped = on_both(svc, post_and_follow({"query": "how are jobs created?", "top_k": 1,
                                           "force_level": "chunk"}))
    full = on_both(svc, post_and_follow({"query": "how are jobs created?",
                                         "force_level": "chunk"}))
    assert capped["port"]["events"] == capped["jax"]["events"]
    assert full["port"]["events"] == full["jax"]["events"]
    assert len(capped["port"]["events"][-1]["data"]["sources"]) == 1
    assert len(full["port"]["events"][-1]["data"]["sources"]) >= 2


def test_health_matches_jax(services):
    svc = services()

    def fn(side, port):
        status, _, payload = request(port, "GET", "/health")
        comps = payload["components"]
        return status, payload["status"], sorted(comps), {
            name: (c["status"], sorted(c["details"])) for name, c in comps.items()}

    out = on_both(svc, fn)
    assert out["port"] == out["jax"]
    assert out["port"][:2] == (200, "UP") and "uptime" in out["port"][3]["system"][1]


def test_health_503_when_store_breaks_matches_jax(services, monkeypatch):
    svc = services()

    class BrokenStore:
        def health(self):
            return {"status": "DOWN", "error": "no contact points"}

    monkeypatch.setattr(factory, "_store", BrokenStore())
    monkeypatch.setattr(j_factory, "_store", BrokenStore())
    out = on_both(svc, lambda side, port: request(port, "GET", "/health"))
    assert out["port"][0] == out["jax"][0] == 503
    assert out["port"][2]["status"] == out["jax"][2]["status"] == "DOWN"


def test_metrics_series_and_labels_match_jax(services):
    """The same traffic moves the same ``rag_api_requests_total`` label
    sets on both sides (read as deltas: other tests in the process feed
    the same registries), and every family the port exposes is one of
    the JAX app's."""
    svc = services()

    def scrape(side, port):
        status, hdrs, text = request(port, "GET", "/metrics", raw=True)
        lines = text.decode().splitlines()
        api = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1]) for ln in lines
               if ln.startswith("rag_api_requests_total{") and "/metrics" not in ln}
        families = {ln.split()[2] for ln in lines if ln.startswith("# TYPE")}
        return status, hdrs["content-type"].split(";")[0], api, families

    before = on_both(svc, scrape)
    on_both(svc, post_and_follow({"query": "q"}))
    after = on_both(svc, scrape)
    moved = {side: sorted(k for k, v in after[side][2].items()
                          if v != before[side][2].get(k, 0.0)) for side in SIDES}
    assert after["port"][:2] == after["jax"][:2] == (200, "text/plain")
    assert moved["port"] == moved["jax"]
    assert any("/rag/jobs/{job_id}/events" in k for k in moved["port"])
    assert after["port"][3] <= after["jax"][3]
    assert {"rag_api_requests_total", "rag_jobs_total", "rag_job_seconds",
            "rag_llm_calls_total", "rag_retrieval_hits"} <= after["port"][3]


def test_static_ui_redirect_and_cors_match_jax(services):
    svc = services()

    def fn(side, port):
        status, hdrs, html = request(port, "GET", "/static/index.html", raw=True)
        root = request(port, "GET", "/", raw=True)
        options = request(port, "OPTIONS", "/rag/jobs", raw=True)
        missing = request(port, "GET", "/static/nope.html", raw=True)[0]
        return (status, hdrs["content-type"], html, root[0], root[1]["location"],
                options[0], hdrs["access-control-allow-origin"],
                options[1]["access-control-allow-methods"], missing)

    out = on_both(svc, fn)
    assert out["port"] == out["jax"]
    assert b"EventSource" in out["port"][2] and b"/rag/jobs" in out["port"][2]
    assert out["port"][3] == 302 and out["port"][5] == 204


def test_debug_routes(services):
    """/debug/index answers as JAX's; /debug/slo, /debug/fleet, /debug/hbm
    and /debug/timeline as the JAX app serves them (no engine in this
    process: no replica), their bodies equal to JAX's but for clocks and
    conforming to the committed golden schemas; /debug/traces after a job
    conforms too; a window that is not a number gets JAX's 400."""
    from test_torch_obs_planes import conforms, golden, reset_planes, shape

    reset_planes()
    svc = services()
    out = on_both(svc, lambda side, port: request(port, "GET", "/debug/index"))
    assert out["port"][0] == out["jax"][0] == 200 and out["port"][2] == out["jax"][2]
    on_both(svc, post_and_follow({"query": "how are jobs created?"}))
    slo_g, tl_g = golden("debug_slo_schema.json"), golden("debug_timeline_schema.json")
    bodies = {}
    for path in ("/debug/slo", "/debug/fleet", "/debug/hbm", "/debug/timeline?window_s=60",
                 "/debug/traces"):
        out = on_both(svc, lambda side, port: request(port, "GET", path))
        assert out["port"][0] == out["jax"][0] == 200, path
        assert sorted(out["port"][2]) == sorted(out["jax"][2]), path
        bodies[path] = out["port"][2]
    assert bodies["/debug/slo"]["decisions"] == {"interactive": "accept"}
    assert bodies["/debug/hbm"]["replica_count"] == 0
    conforms(shape(bodies["/debug/slo"]), slo_g["GET /debug/slo"])
    conforms(shape(bodies["/debug/fleet"]), slo_g["GET /debug/fleet"])
    conforms(shape(bodies["/debug/hbm"]), tl_g["GET /debug/hbm"])
    tl = bodies["/debug/timeline?window_s=60"]
    conforms(shape({**tl, "traceEvents": []}), tl_g["GET /debug/timeline"])
    assert tl["metadata"]["sources"]["spans"] > 0  # the job's span tree
    conforms(shape(bodies["/debug/traces"]),
             golden("debug_traces_schema.json")["GET /debug/traces"])
    out = on_both(svc, lambda side, port: request(port, "GET", "/debug/timeline?window_s=soon"))
    assert out["port"][0] == out["jax"][0] == 400 and out["port"][2] == out["jax"][2]
    status, hdrs, _ = request(svc.ports["port"], "GET", "/rag/jobs")
    assert status == 405 and hdrs["allow"] == "POST"


def test_api_sheds_when_the_plane_says_shed(services, monkeypatch):
    """A monitor registered with the port's SLO plane, driven critical on
    the batch class: POST /rag/jobs of that class gets 429 with
    ``Retry-After: 1`` as from the JAX app under its plane, the protected
    class is still accepted, and the shed counts."""
    from githubrepostorag_tpu.obs.slo import SLOMonitor as JMonitor, get_slo_plane as j_plane
    from githubrepostorag_tpu_torch.obs.slo import SLOMonitor, get_slo_plane
    from test_torch_obs_planes import reset_planes

    from githubrepostorag_tpu_torch.metrics import JOBS_SHED, counter_value

    monkeypatch.setenv("SLO_WINDOWS", "1,5")
    config.reload_settings()
    j_reload()
    reset_planes()
    svc = services()
    try:
        for plane, mon in ((get_slo_plane(), SLOMonitor("shed")),
                           (j_plane(), JMonitor("shed"))):
            plane.register("shed", monitor=mon)
            for i in range(6):
                mon.observe("batch", deadline_missed=True, now=time.monotonic() + 0.01 * i)
            mon.maybe_refresh(force=True)
        shed_before = counter_value(JOBS_SHED)
        out = on_both(svc, lambda side, port: request(
            port, "POST", "/rag/jobs", {"query": "q", "priority": "batch"}))
        assert out["port"][0] == out["jax"][0] == 429
        assert out["port"][1]["retry-after"] == out["jax"][1]["retry-after"] == "1"
        assert out["port"][2] == out["jax"][2]
        assert counter_value(JOBS_SHED) == shed_before + 1
        status, _, reply = request(svc.ports["port"], "POST", "/rag/jobs", {"query": "q"})
        assert status == 200 and reply["job_id"]
    finally:
        reset_planes()


def test_sse_heartbeat_while_the_agent_thinks(services, monkeypatch):
    """A quiet bus gets ``: heartbeat`` comments; the stream still ends
    at ``final``."""
    monkeypatch.setenv("SSE_HEARTBEAT_SECONDS", "0.05")
    config.reload_settings()
    svc = services(script=AGENT_SCRIPT, slow=True)
    port = svc.ports["port"]
    job_id = request(port, "POST", "/rag/jobs", {"query": "q"})[2]["job_id"]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", f"/rag/jobs/{job_id}/events")
    lines = [raw.decode().strip() for raw in conn.getresponse()]
    conn.close()
    assert ": heartbeat" in lines
    assert json.loads([ln for ln in lines if ln.startswith("data: ")][-1][6:])["event"] == "final"


def test_api_main_refuses_the_split_deployment(monkeypatch, capsys):
    """The split deployment's flag rules: ``--no-worker`` needs
    ``--redis`` (a parser error, as in JAX), and an API pod with
    ``--redis --no-worker`` serves the API over Redis and builds no LLM."""
    from githubrepostorag_tpu_torch.api import __main__ as api_main
    from githubrepostorag_tpu_torch.events.redis import RedisBus, RedisJobQueue

    with pytest.raises(SystemExit) as exc:
        api_main.main(["--no-worker"])
    assert exc.value.code == 2 and "--no-worker requires --redis" in capsys.readouterr().err
    served = []

    async def fake_serve(host, port, device, use_redis, run_worker):
        bus, flags, queue = api_main.bus_flags_queue(use_redis)
        served.append((use_redis, run_worker, type(bus), type(queue)))

    def no_llm(device=None):
        raise AssertionError("an API pod with --no-worker built an LLM")

    monkeypatch.setattr(api_main, "serve", fake_serve)
    monkeypatch.setattr(api_main, "_build_llm", no_llm)
    assert api_main.main(["--redis", "--no-worker"]) == 0
    assert served == [(True, False, RedisBus, RedisJobQueue)]


def test_build_llm_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    """``LLM_BACKEND=inprocess`` builds the engine on the card: without one
    it raises, never falling back to the CPU."""
    from githubrepostorag_tpu_torch.api.__main__ import _build_llm

    monkeypatch.setenv("LLM_BACKEND", "inprocess")
    monkeypatch.delenv("MODEL_WEIGHTS_PATH", raising=False)
    config.reload_settings()
    with pytest.raises(SystemExit, match="MODEL_WEIGHTS_PATH"):
        _build_llm()
    monkeypatch.setenv("MODEL_WEIGHTS_PATH", str(tmp_path))
    config.reload_settings()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _build_llm()
    monkeypatch.undo()
    config.reload_settings()


def test_service_answers_a_job_from_a_checkpoint(checkpoint):
    """``python -m githubrepostorag_tpu_torch.api --device cpu`` in a
    subprocess with the in-process engine over a tiny checkpoint: a job
    reaches ``final`` through the engine (its spans in the job's trace),
    and SIGTERM stops the service cleanly."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MESH_SHAPE", "SPEC_DRAFT_MODEL")}
    env.update(SERVER_ENV, MODEL_WEIGHTS_PATH=str(checkpoint), CTRL="off",
               LLM_BACKEND="inprocess", QWEN_MAX_OUTPUT="4", LOG_FORMAT="plain")
    proc = subprocess.Popen(
        [sys.executable, "-m", "githubrepostorag_tpu_torch.api", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                status, _, health = request(port, "GET", "/health")
                break
            except (ConnectionError, OSError):
                assert time.monotonic() < deadline, "service never came up"
                time.sleep(0.2)
        assert status == 200 and health["components"]["llm"]["details"]["backend"] == "inprocess"
        status, _, reply = request(port, "POST", "/rag/jobs",
                                   {"query": "how does the forward pass work?"})
        assert status == 200
        events = events_of(port, reply["job_id"])
        kinds = [e["event"] for e in events]
        assert kinds[0] == "started" and kinds[-1] == "final" and "error" not in kinds
        _, _, trace = request(port, "GET", f"/debug/traces/{reply['trace_id']}")
        names = [sp["name"] for sp in trace["spans"]]
        assert {"worker.job", "agent.plan", "agent.synthesize", "llm.generate",
                "engine.prefill"} <= set(names)
        _, _, health = request(port, "GET", "/health")
        details = health["components"]["llm"]["details"]
        assert details["free_pages"] == details["total_pages"] == 64
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "RAG service stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
