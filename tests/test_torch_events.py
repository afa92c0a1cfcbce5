"""The port's memory bus, resilience layer, flight recorder and metrics
against the JAX package's: the cases of ``tests/test_events.py`` on both
buses (frames equal), ``Deadline`` wire round trips, breaker transitions,
one ``FAULTS`` string and seed firing at the same calls, the supervised
emit, the recorder's payloads, and the Prometheus exposition."""

from __future__ import annotations

import asyncio
import json
import re
import time
from types import SimpleNamespace

import pytest

from githubrepostorag_tpu import events as j_events, metrics as j_metrics
from githubrepostorag_tpu.config import reload_settings as j_reload
from githubrepostorag_tpu.obs import recorder as j_recorder, trace as j_trace
from githubrepostorag_tpu.resilience import faults as j_faults, policy as j_policy
from githubrepostorag_tpu.resilience import supervise as j_supervise
from githubrepostorag_tpu_torch import config, events, metrics
from githubrepostorag_tpu_torch.obs import recorder, trace
from githubrepostorag_tpu_torch.resilience import admission, faults, policy, supervise

SIDES = {
    "jax": SimpleNamespace(events=j_events, faults=j_faults, policy=j_policy,
                           supervise=j_supervise, metrics=j_metrics, trace=j_trace,
                           recorder=j_recorder, reload=j_reload),
    "port": SimpleNamespace(events=events, faults=faults, policy=policy, supervise=supervise,
                            metrics=metrics, trace=trace, recorder=recorder,
                            reload=config.reload_settings),
}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    def reset():
        config.reload_settings()
        events.reset_memory_hub()
        faults.reset_faults()
        policy.reset_breakers()
        recorder.reset_recorder()

    reset()
    yield
    reset()


def _reload(monkeypatch, **env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for side in SIDES.values():
        side.reload()
        side.faults.reset_faults()
        side.policy.reset_breakers()


# ------------------------------------------------------------- memory bus


async def _collect(bus, job_id, n_frames, timeout=5.0):
    out = []

    async def consume():
        async for frame in bus.stream(job_id):
            out.append(frame)
            if len([f for f in out if f.startswith("data:")]) >= n_frames:
                return

    await asyncio.wait_for(consume(), timeout)
    return out


def _datas(frames):
    return [f for f in frames if f.startswith("data:")]


async def _bus_script(side):
    """tests/test_events.py's bus cases in order; returns every data
    frame and ping seen."""
    ev = SIDES[side].events
    out = {}
    bus = ev.MemoryBus(ping_interval=0.05)
    await bus.emit("j1", "started", {"job_id": "j1"})
    out["replayed"] = _datas(await _collect(bus, "j1", 1))

    async def emitter():
        await asyncio.sleep(0.05)
        await bus.emit("j2", "final", {"answer": "42"})

    task = asyncio.create_task(emitter())
    out["live"] = _datas(await _collect(bus, "j2", 1))
    await task

    idle = ev.MemoryBus(ping_interval=0.01)
    gen = idle.stream("j3")
    out["ping"] = await asyncio.wait_for(gen.__anext__(), 1.0)
    await gen.aclose()

    await bus.emit("j4", "turn", {"stage": "retrieve", "text": "ünïcode"})
    out["format"] = _datas(await _collect(bus, "j4", 1))

    r1 = asyncio.create_task(_collect(bus, "j5", 1))
    r2 = asyncio.create_task(_collect(bus, "j5", 1))
    await asyncio.sleep(0.05)
    await bus.emit("j5", "iteration", {"n": 1})
    out["fanout"] = [_datas(f) for f in await asyncio.gather(r1, r2)]
    return out


async def test_memory_bus_frames_match_jax():
    port, ref = await _bus_script("port"), await _bus_script("jax")
    assert port == ref
    assert json.loads(port["replayed"][0][len("data: "):]) == {
        "event": "started", "data": {"job_id": "j1"}}
    assert port["ping"] == events.PING_FRAME == ": ping\n\n"
    assert all(f.endswith("\n\n") for f in port["format"])


async def test_cancel_flags_and_job_queue_match_jax():
    out = {}
    for side in SIDES:
        ev = SIDES[side].events
        flags, q = ev.MemoryCancelFlags(), ev.MemoryJobQueue()
        seen = [await flags.is_cancelled("jx")]
        await flags.cancel("jx")
        seen += [await flags.is_cancelled("jx"), await flags.is_cancelled("other")]
        j1 = await q.enqueue_job("run_rag_job", "j-1", {"query": "q"}, _job_id="j-1",
                                 deadline={"budget_ms": 5}, trace=None)
        await q.enqueue_job("run_rag_job", "j-2", {"query": "r"}, _job_id="j-2")
        depth = await q.depth()
        first, second = await q.dequeue(), await q.dequeue()
        await q.set_result("j-1", {"answer": "a"})
        out[side] = (seen, vars(j1), depth, vars(first), vars(second), await q.depth(),
                     await q.get_result("j-1"), await q.get_result("missing"))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [False, True, False] and out["port"][2] == 2


def test_sse_wire_helpers_match_jax():
    for name in ("CHANNEL_FMT", "CANCEL_FLAG_FMT", "CANCEL_TTL_SECONDS", "PING_FRAME"):
        assert getattr(events.base, name) == getattr(j_events.base, name)
    payload = events.base.encode_event("turn", {"stage": "plan", "x": "é"})
    assert payload == j_events.base.encode_event("turn", {"stage": "plan", "x": "é"})
    assert events.sse_frame(payload) == j_events.sse_frame(payload)
    assert events.base.channel_for("a") == j_events.base.channel_for("a")
    assert events.base.cancel_key_for("a") == j_events.base.cancel_key_for("a")


# ------------------------------------------------------------- resilience


@pytest.mark.parametrize("budget_s", [0.0, 0.25, 3.0, 300.0])
def test_deadline_wire_round_trip_matches_jax(budget_s):
    wire = policy.Deadline(budget_s).to_wire()
    j_wire = j_policy.Deadline(budget_s).to_wire()
    assert set(wire) == set(j_wire) == {"budget_ms", "t0"}
    assert abs(wire["budget_ms"] - j_wire["budget_ms"]) <= 1
    # each side reads the other's wire form
    for make, w in ((policy.Deadline.from_wire, j_wire), (j_policy.Deadline.from_wire, wire)):
        back = make(w)
        assert abs(back.remaining() - budget_s) < 0.05
        assert back.expired == (budget_s == 0.0)
    late = dict(wire, t0=wire["t0"] - 1.0)  # 1 s in transit
    assert abs(policy.Deadline.from_wire(late).remaining()
               - j_policy.Deadline.from_wire(late).remaining()) < 0.05


def test_deadline_and_priority_scopes():
    for side in SIDES.values():
        pol = side.policy
        assert pol.current_deadline() is None and pol.current_priority() is None
        d = pol.Deadline(1.0)
        with pol.deadline_scope(d), pol.priority_scope("batch"):
            assert pol.current_deadline() is d and pol.current_priority() == "batch"
            with pol.deadline_scope(None):
                assert pol.current_deadline() is None
            assert pol.current_deadline() is d
        assert pol.current_deadline() is None and pol.current_priority() is None


def _breaker_walk(side):
    pol = SIDES[side].policy
    b = pol.get_breaker("dep", failure_threshold=2, reset_seconds=0.05)
    steps = [b.state]
    b.record_failure()
    steps.append(b.state)
    b.record_failure()
    steps += [b.state, b.allow()]
    time.sleep(0.06)
    steps += [b.allow(), b.state, b.allow()]  # one probe in half-open
    b.record_failure()
    steps.append(b.state)
    time.sleep(0.06)
    steps += [b.allow(), b.state]
    b.record_success()
    steps += [b.state, b.allow(), b.snapshot(), pol.breaker_states()]
    return steps


def test_breaker_transitions_match_jax():
    port = _breaker_walk("port")
    assert port == _breaker_walk("jax")
    assert port[:4] == ["closed", "closed", "open", False]
    assert metrics.counter_value(metrics.BREAKER_TRANSITIONS, dep="dep", to_state="open") == 2


@pytest.mark.parametrize("spec", [
    "llm.complete:drop@3",
    "llm.complete:error@0.5;bus.emit:drop@window=2:4",
    "llm.complete:delay=0@window=3:;bus.emit:error@2",
    "bus.emit:drop",
])
def test_faults_fire_at_the_same_calls(monkeypatch, spec):
    _reload(monkeypatch, FAULTS=spec, FAULTS_SEED="7")
    fired = {}
    for side in SIDES:
        f = SIDES[side].faults
        seq = []
        for i in range(12):
            for site in ("llm.complete", "bus.emit", "redis.send"):
                try:
                    seq.append((site, f.fire_sync(site)))
                except f.InjectedFault as exc:
                    seq.append((site, str(exc)))
        fired[side] = (seq, f.get_registry().stats())
    assert fired["port"] == fired["jax"]
    assert any(x is True or isinstance(x, str) for _, x in fired["port"][0])


@pytest.mark.parametrize("bad", ["nosep", "x:explode", "x:drop@0", "x:drop@window=3",
                                 "x:error=2", "x:drop@1.5"])
def test_bad_fault_specs_raise_on_both_sides(monkeypatch, bad):
    _reload(monkeypatch, FAULTS=bad)
    with pytest.raises(faults.FaultSpecError):
        faults.get_registry()
    with pytest.raises(j_faults.FaultSpecError):
        j_faults.get_registry()


def test_retry_policy_schedule_matches_jax(monkeypatch):
    _reload(monkeypatch, RETRY_MAX_ATTEMPTS="5", RETRY_BASE_SECONDS="0.01")
    port = policy.RetryPolicy.from_settings(seed=3)
    ref = j_policy.RetryPolicy.from_settings(seed=3)
    assert list(port.delays()) == list(ref.delays())
    assert (port.max_attempts, port.base, port.cap) == (5, 0.01, 2.0)


async def test_retry_call_and_resilient_bus_drop_accounting(monkeypatch):
    """An emit seam that drops every 2nd call: the supervised emit retries
    through it; a bus that always fails is dropped, counted, never raised."""
    _reload(monkeypatch, FAULTS="bus.emit:drop@2", RETRY_BASE_SECONDS="0.001")
    out = {}
    for side in SIDES:
        s = SIDES[side]
        bus = s.events.MemoryBus(ping_interval=0.05)
        rb = s.supervise.ResilientBus(bus)
        for i in range(4):
            await rb.emit("j", "turn", {"i": i})
        frames = _datas(await _collect(bus, "j", 4))

        class Dead(s.events.ProgressBus):
            async def emit(self, job_id, event, data):
                raise ConnectionError("down")

            def stream(self, job_id):
                raise NotImplementedError

        before = s.metrics.counter_value(s.metrics.EVENT_EMIT_DROPS, event="final")
        dead = s.supervise.ResilientBus(
            Dead(), policy=s.policy.RetryPolicy(max_attempts=2, base=0.001, seed=0),
            terminal_policy=s.policy.RetryPolicy(max_attempts=2, base=0.001, seed=0))
        await dead.emit("j", "final", {})
        dropped = s.metrics.counter_value(s.metrics.EVENT_EMIT_DROPS, event="final") - before
        out[side] = (frames, dropped, s.policy.get_breaker("bus").snapshot())
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 4 and out["port"][1] == 1


def test_admission_fails_open_and_sheds_on_request():
    assert admission.should_shed("interactive") is False
    admission.set_table_provider(lambda: {"batch": "shed", "x": "bogus"})
    before = metrics.counter_value(metrics.ADMISSION_FAILOPEN)
    try:
        assert admission.should_shed("batch") is True
        assert admission.should_shed("interactive") is False
        assert metrics.counter_value(metrics.ADMISSION_FAILOPEN) > before  # "bogus"
        admission.set_table_provider(lambda: 1 / 0)
        assert admission.should_shed("batch") is False
    finally:
        admission.clear_table_provider()
        admission.clear_hint_provider()


# -------------------------------------------------------- flight recorder


def _traced_run(side):
    s = SIDES[side]
    rec = s.recorder.reset_recorder()
    with s.trace.root_span("worker.job", job_id="j1") as root:
        for name in ("agent.plan", "agent.retrieve", "agent.judge", "agent.synthesize"):
            with s.trace.span(name):
                pass
        s.trace.record_span("engine.prefill", 1.0, 1.5, parent=root.context)
        s.trace.record_span("engine.decode", 1.5, 2.25, parent=root.context)
    tid = root.trace_id
    detail = rec.trace_payload(tid)
    return {
        "names": sorted(sp["name"] for sp in detail["spans"]),
        "parents": sorted((sp["name"], sp["parent_id"] is None) for sp in detail["spans"]),
        "phases": sorted(rec.phase_summary(tid)),
        "decode": rec.phase_summary(tid)["decode"],
        "summary_keys": sorted(rec.summaries_payload()),
        "trace_keys": sorted(detail),
        "root": rec.summaries_payload()["traces"][0]["root"],
        "missing": rec.trace_payload("0" * 32),
    }


def test_recorder_payloads_match_jax(monkeypatch):
    monkeypatch.delenv("TRACE_SAMPLE", raising=False)
    assert _traced_run("port") == _traced_run("jax")


# ---------------------------------------------------------------- metrics


def _families(text: str) -> dict[str, str]:
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _samples(text: str) -> set[str]:
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#") and "_created" not in line}


def _value(text: str, head: str) -> float:
    got = [ln for ln in text.splitlines() if ln.startswith(head + " ")]
    assert len(got) <= 1, head
    return float(got[0].rsplit(" ", 1)[1]) if got else 0.0


def test_metrics_exposition_matches_prometheus_client():
    """Every family the port renders exists in the JAX registry with the
    same type and samples, and the same observations move the same
    samples by the same amounts."""
    heads = ('rag_api_requests_total{method="GET",path="/probe/{x}",status="200"}',
             'rag_jobs_total{status="probe"}', 'rag_job_seconds_bucket{le="5.0"}',
             'rag_job_seconds_bucket{le="10.0"}', 'rag_job_seconds_bucket{le="+Inf"}',
             "rag_job_seconds_count", "rag_job_seconds_sum", "rag_jobs_in_flight",
             'rag_llm_calls_total{status="probe"}', "rag_bus_emit_drops_total{event=\"probe\"}")
    before = {name: (side.metrics.render().decode()) for name, side in SIDES.items()}
    for side in SIDES.values():
        m = side.metrics
        m.HTTP_REQUESTS.labels("GET", "/probe/{x}", "200").inc()
        m.JOBS_TOTAL.labels(status="probe").inc(2)
        m.JOB_DURATION.observe(7.0)
        m.JOBS_IN_FLIGHT.inc()
        m.JOBS_IN_FLIGHT.dec()
        m.LLM_CALLS.labels(status="probe").inc()
        m.EVENT_EMIT_DROPS.labels(event="probe").inc()
    after = {name: side.metrics.render().decode() for name, side in SIDES.items()}
    for head in heads:
        deltas = {n: _value(after[n], head) - _value(before[n], head) for n in SIDES}
        assert deltas["port"] == deltas["jax"], head
    port_fams, jax_fams = _families(after["port"]), _families(after["jax"])
    assert port_fams and all(jax_fams.get(f) == t for f, t in port_fams.items())
    assert _samples(after["port"]) <= _samples(after["jax"])
