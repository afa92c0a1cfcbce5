"""The port's observability planes against the JAX package's (CPU): the
token ledger, the SLO monitor and plane, the page observatory, the
continuous profiler and the timeline get the same inputs (snapshot dicts,
``observe`` sequences, claim / hold / release seams, explicit clocks) on
both sides and must give equal payloads, limiters, burn states and
transitions -- the cases of ``tests/test_slo.py`` and
``tests/test_timeline.py``.  The ``/debug/slo``, ``/debug/fleet``,
``/debug/hbm``, ``/debug/timeline`` and ``/debug/traces`` payloads, built
by the port's modules from the committed schema scripts' inputs, equal the
golden schemas under ``tests/golden/`` exactly (``conforms`` holds a live
server's body to them); the compile watchdog counts 0 across mixed draft /
plain traffic after ``warmup()`` and counts a new plan after it; the new
metric series carry the JAX package's names and labels."""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import githubrepostorag_tpu.config as j_config
import githubrepostorag_tpu.metrics as j_metrics
import githubrepostorag_tpu.obs.continuous as j_continuous
import githubrepostorag_tpu.obs.hbm as j_hbm
import githubrepostorag_tpu.obs.ledger as j_ledger
import githubrepostorag_tpu.obs.recorder as j_recorder
import githubrepostorag_tpu.obs.slo as j_slo
import githubrepostorag_tpu.obs.timeline as j_timeline
import githubrepostorag_tpu.resilience.admission as j_admission
import githubrepostorag_tpu.resilience.faults as j_faults
from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig
from githubrepostorag_tpu_torch import config as t_config
from githubrepostorag_tpu_torch import metrics as t_metrics
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.obs import continuous as t_continuous
from githubrepostorag_tpu_torch.obs import hbm as t_hbm
from githubrepostorag_tpu_torch.obs import ledger as t_ledger
from githubrepostorag_tpu_torch.obs import recorder as t_recorder
from githubrepostorag_tpu_torch.obs import slo as t_slo
from githubrepostorag_tpu_torch.obs import timeline as t_timeline
from githubrepostorag_tpu_torch.obs.engine_profile import (
    CompileWatchdog,
    EngineStepProfiler,
    plan_caches,
)
from githubrepostorag_tpu_torch.resilience import admission as t_admission
from githubrepostorag_tpu_torch.resilience import faults as t_faults

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"

SIDES = {
    "jax": SimpleNamespace(ledger=j_ledger, slo=j_slo, hbm=j_hbm, continuous=j_continuous,
                           timeline=j_timeline, config=j_config, admission=j_admission,
                           recorder=j_recorder, faults=j_faults),
    "port": SimpleNamespace(ledger=t_ledger, slo=t_slo, hbm=t_hbm, continuous=t_continuous,
                            timeline=t_timeline, config=t_config, admission=t_admission,
                            recorder=t_recorder, faults=t_faults),
}


def reset_planes() -> None:
    """Drop both packages' process-wide planes and registries."""
    for m in SIDES.values():
        m.slo.reset_slo_plane()
        m.hbm.reset_hbm_plane()
        m.continuous.reset_profilers()
        m.timeline.reset_fleet_events_provider()
        m.recorder.reset_recorder()
        m.faults.reset_faults()


@pytest.fixture
def planes(monkeypatch):
    """Both packages' planes, reset, with the environment ``env`` sets
    read by both settings objects; everything reset again after."""
    reset_planes()

    def env(**values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
        t_config.reload_settings()
        j_config.reload_settings()

    yield env
    monkeypatch.undo()
    t_config.reload_settings()
    j_config.reload_settings()
    reset_planes()


def on_both(fn):
    """``fn(side modules)`` on each package; returns {side: result}."""
    return {name: fn(m) for name, m in SIDES.items()}


def assert_same(fn):
    out = on_both(fn)
    assert out["port"] == out["jax"]
    return out["port"]


# ------------------------------------------------------------- ledger --

def _snap(m, **kw):
    base = {f: 0.0 for f in m.ledger.SNAPSHOT_FIELDS}
    base.update(kw)
    return base


# the ledger cases of tests/test_slo.py: (window_s, flops, peak, steps, now);
# a step is (snapshot fields, start, end, compiles) or ("idle", now)
LEDGER_CASES = {
    "buckets_and_goodput": (60.0, 0.0, 0.0, [
        (dict(prefill_tokens=20, prefill_seconds_total=0.3), 100.0, 100.4, 0),
        (dict(prefill_tokens=20, prefill_seconds_total=0.3, committed_tokens=8,
              decode_seconds_total=0.55), 100.5, 100.8, 0)], 100.8),
    "compile": (60.0, 0.0, 0.0, [(dict(prefill_seconds_total=0.2), 10.0, 12.0, 1)], 12.0),
    "hbm_pages": (60.0, 0.0, 0.0, [
        (dict(decode_seconds_total=0.1, admission_blocked_steps=1), 10.0, 10.1, 0),
        (dict(decode_seconds_total=0.2, admission_blocked_steps=2), 10.1, 10.2, 0)], 10.2),
    "swap_wait": (60.0, 0.0, 0.0, [
        (dict(decode_seconds_total=0.4, migration_seconds_total=0.6), 10.0, 11.0, 0)], 11.0),
    "stall": (60.0, 0.0, 0.0, [(dict(decode_seconds_total=0.1), 100.0, 100.1, 0),
                               (dict(decode_seconds_total=0.2), 101.0, 101.1, 0)], 101.1),
    "idle_gap": (60.0, 0.0, 0.0, [(dict(decode_seconds_total=0.1), 20.0, 20.1, 0),
                                  ("idle", 20.5),
                                  (dict(decode_seconds_total=0.2), 21.0, 21.1, 0)], 21.1),
    "window_prunes": (1.0, 0.0, 0.0, [
        (dict(committed_tokens=8, decode_seconds_total=0.2), 10.0, 10.2, 0)], 12.0),
    "wasted": (60.0, 0.0, 0.0, [
        (dict(committed_tokens=6, reaped_tokens=2, spec_proposed=10, spec_accepted=6,
              spec_verify_seconds_total=0.2), 10.0, 10.3, 0)], 10.3),
    "mfu": (60.0, 1e9, 1e12, [
        (dict(prefill_tokens=10, prefill_seconds_total=0.4), 0.0, 0.5, 0),
        (dict(prefill_tokens=10, prefill_seconds_total=0.4, committed_tokens=10,
              decode_seconds_total=0.4), 0.5, 1.0, 0)], 1.0),
    "transfer_and_dispatch": (60.0, 0.0, 0.0, [
        (dict(decode_seconds_total=0.1, fused_steps_total=1, step_dispatches_total=1),
         5.0, 5.1, 0),
        (dict(decode_seconds_total=0.2, transfer_seconds_total=0.3, fused_steps_total=2,
              step_dispatches_total=3), 5.5, 5.6, 0)], 5.6),
}


@pytest.mark.parametrize("case", list(LEDGER_CASES))
def test_token_ledger_matches_jax(planes, case):
    window, fpt, peak, steps, now = LEDGER_CASES[case]

    def run(m):
        led = m.ledger.TokenLedger(f"led-{case}", flops_per_tok=fpt, peak_flops=peak,
                                   window_s=window)
        for step in steps:
            if step[0] == "idle":
                led.idle(now=step[1])
            else:
                led.on_step(_snap(m, **step[0]), step[1], step[2], compiles=step[3])
        return (led.snapshot(now=now), led.justification(now=now),
                led.current_limiter(now=now), led.recent_steps(None, now=now), led.last_rec)

    out = assert_same(run)
    assert out[0]["steps"] == (0 if case == "window_prunes" else
                               sum(1 for s in steps if s[0] != "idle"))


def test_flops_per_token_matches_jax():
    for name in ("tiny", "qwen2_0_5b", "qwen2_7b"):
        j, t = getattr(JConfig, name)(), getattr(Qwen2Config, name)()
        assert t_ledger.flops_per_token(t) == j_ledger.flops_per_token(j) > 0


def test_engine_snapshot_reads_the_ports_counters():
    """Every SNAPSHOT_FIELDS counter is an attribute of the port's Engine."""
    from githubrepostorag_tpu_torch.models.qwen2 import init_params
    from githubrepostorag_tpu_torch.serving import Engine

    cfg = Qwen2Config.tiny()
    eng = Engine(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg,
                 max_num_seqs=2, num_pages=16, page_size=4, max_seq_len=32, device="cpu")
    assert t_ledger.SNAPSHOT_FIELDS == j_ledger.SNAPSHOT_FIELDS
    assert all(hasattr(eng, f) for f in t_ledger.SNAPSHOT_FIELDS)
    assert t_ledger.engine_snapshot(eng) == {f: 0.0 for f in t_ledger.SNAPSHOT_FIELDS}


# ------------------------------------------------------- SLO monitor --

# (environment, observations (klass, ttft, tpot, missed, t), read times)
MONITOR_CASES = {
    "critical_then_recovers": ({"SLO_WINDOWS": "1,5"},
                               [("interactive", None, None, True, 1000.0 + 0.1 * i)
                                for i in range(5)]
                               + [("interactive", None, None, False, 1010.0 + 0.1 * i)
                                  for i in range(3)], [1000.5, 1010.5]),
    "warn": ({"SLO_WINDOWS": "1,5"},
             [("interactive", None, None, i % 2 == 0, 2000.0 + 0.05 * i) for i in range(10)],
             [2000.5]),
    "both_windows": ({"SLO_WINDOWS": "1,5"},
                     [("interactive", None, None, False, 3000.0 + 0.05 * i) for i in range(6)]
                     + [("interactive", None, None, True, 3002.0 + 0.05 * i) for i in range(2)],
                     [3002.2]),
    "ttft_tpot": ({"SLO_WINDOWS": "1,5", "SLO_TPOT_MS": "100"},
                  [("batch", 0.01, 0.5, False, 4000.0 + 0.05 * i) for i in range(5)], [4000.3]),
    "longctx": ({"SLO_WINDOWS": "1,5", "SLO_TTFT_P99_MS": "1000",
                 "SLO_LONGCTX_TTFT_P99_MS": "45000"},
                [(k, 5.0, None, False, 5000.0 + 0.05 * i) for i in range(5)
                 for k in ("interactive", "longctx")], [5000.3]),
}


@pytest.mark.parametrize("case", list(MONITOR_CASES))
def test_slo_monitor_matches_jax(planes, case):
    env, observations, reads = MONITOR_CASES[case]
    planes(**env)

    def run(m):
        mon = m.slo.SLOMonitor(f"mon-{case}")
        out = []
        for klass, ttft, tpot, missed, t in observations:
            mon.observe(klass, ttft_s=ttft, tpot_s=tpot, deadline_missed=missed, now=t)
            out.append((mon.worst_state(), mon.class_states()))
        for t in reads:
            out.append((mon.payload(now=t), mon.burn_state(now=t)))
        out.append(sorted(mon.transition_counts().items()))
        return out

    out = assert_same(run)
    assert any(state for state, _ in out[: len(observations)]) or case == "both_windows"


@pytest.mark.parametrize("protected", ["interactive", "batch"])
def test_slo_plane_decisions_and_payloads_match_jax(planes, protected):
    """Two replicas' monitors driven to warn / critical on different
    classes: the plane's class states, admission hint, decision table,
    SLO payload and the admission module's per-class shedding agree."""
    planes(SLO_WINDOWS="1,5", PRIORITY_PROTECTED_CLASS=protected)

    def run(m):
        plane = m.slo.get_slo_plane()
        out = []
        t0 = time.monotonic()
        mons = {r: m.slo.SLOMonitor(r) for r in ("r0", "r1")}
        for r, mon in mons.items():
            plane.register(r, monitor=mon, stats=lambda r=r: {"role": "fused", "replica": r})
        steps = [("r0", "batch", True), ("r1", "interactive", False), ("r1", "batch", True),
                 ("r0", "interactive", True), ("r0", "interactive", True)]
        for i, (r, klass, missed) in enumerate(steps * 3):
            mons[r].observe(klass, ttft_s=0.1, tpot_s=0.01, deadline_missed=missed,
                            now=t0 + 0.01 * i)
            mons[r].maybe_refresh(t0 + 0.01 * i, force=True)
            out.append((plane.class_states(), plane.admission_hint(), plane.decision_table(),
                        {k: m.admission.admission_decision(k)
                         for k in ("interactive", "batch", "longctx")},
                        m.admission.should_shed("batch")))
        slo = plane.slo_payload()
        out.append(slo)
        out.append(plane.decision_snapshot(t0 + 1.0))
        return out

    out = assert_same(run)
    assert {d["batch"] for _, _, d, _, _ in out[:-2]} & {"shed", "preempt", "throttle"}


def test_slo_plane_fleet_payload_matches_jax(planes):
    """The fleet payload over a ledger and a monitor (JAX
    ``test_plane_fleet_payload_federates_ledger_and_monitor``), rendered at
    one pinned clock on both sides."""

    def run(m):
        plane = m.slo.get_slo_plane()
        led = m.ledger.TokenLedger("p0", window_s=60.0)
        now = 500.0
        led.on_step(_snap(m, committed_tokens=10, decode_seconds_total=0.2, reaped_tokens=1),
                    now - 0.5, now)
        mon = m.slo.SLOMonitor("p0")
        mon.observe(deadline_missed=False, now=now)
        plane.register("p0", ledger=led, monitor=mon, stats=lambda: {"num_running": 0})
        real = time.monotonic
        time.monotonic = lambda: now + 0.25
        try:
            fleet = plane.fleet_payload()
        finally:
            time.monotonic = real
        plane.unregister("p0")
        return fleet, plane.fleet_payload()["fleet"]

    fleet, empty = assert_same(run)
    assert fleet["fleet"]["committed_tokens"] == 10 and empty["replicas"] == 0


def test_port_plane_registers_the_admission_providers(planes):
    """Building the port's plane registers its hint and decision table with
    the port's admission module; a failing provider fails open and counts."""
    assert t_admission.admission_decision("batch") == "accept"
    planes(SLO_WINDOWS="1,5")
    plane = t_slo.get_slo_plane()
    mon = t_slo.SLOMonitor("adm")
    plane.register("adm", monitor=mon)
    for i in range(6):
        mon.observe("batch", deadline_missed=True, now=100.0 + 0.01 * i)
    mon.maybe_refresh(100.1, force=True)
    assert t_admission.should_shed("batch") and not t_admission.should_shed("interactive")
    before = t_metrics.counter_value(t_metrics.ADMISSION_FAILOPEN)
    t_admission.set_table_provider(lambda: 1 / 0)
    t_admission.set_hint_provider(lambda: "maybe")
    assert not t_admission.should_shed("batch")
    assert t_metrics.counter_value(t_metrics.ADMISSION_FAILOPEN) == before + 2
    t_slo.reset_slo_plane()
    assert t_admission.admission_decision("batch") == "accept"


# ------------------------------------------------- page observatory --

def _pool_view():
    return {"num_pages": 64, "free": 40, "plain_free": 30, "cached_lru": 10, "host_pages": 2,
            "free_pages": [1, 2, 3, 8, 9, 16, 17, 18, 19, 40] + list(range(44, 64)),
            "hit_tokens": 64, "fault_ins": 1, "writebacks": 1, "dedup_hits": 1,
            "host_evictions": 0, "tier_drops": 0, "page_imports": 1, "import_dedup_skips": 0,
            "preempt_parked_pages": 4}


def test_page_observatory_matches_jax(planes, monkeypatch):
    """Claims, holds (a park / resume re-hold under one rid), releases and
    tier events at explicit times: payloads, justification, integrals and
    the event ring are equal, and attribution meets the occupancy
    integral."""
    monkeypatch.setattr(time, "monotonic", lambda: 50.0)

    def run(m):
        obs = m.hbm.PageObservatory("rh", recent_requests=4, event_ring=8)
        obs.attach_pool_view(_pool_view)
        ops = [("claims", 8, 50.1), ("hold", "a", "interactive", 8, 50.1),
               ("claims", 4, 50.3), ("hold", "b", "batch", 4, 50.3),
               ("tier", "writeback", 2, 50.4), ("claims", -4, 50.6), ("release", "b", 50.6),
               ("claims", 4, 50.8), ("hold", "b", "batch", 4, 50.8),
               ("tier", "fault_in", 1, 50.9), ("claims", 2, 51.0),
               ("hold", "a", "interactive", 10, 51.0), ("claims", -10, 51.5),
               ("release", "a", 51.5), ("tier", "park", 3, 51.6)]
        for op in ops:
            kind, *args = op
            if kind == "claims":
                obs.on_claims(args[0], now=args[1])
            elif kind == "hold":
                obs.on_request_hold(*args[:3], now=args[3])
            elif kind == "release":
                obs.on_request_release(args[0], now=args[1])
            else:
                obs.on_tier_event(args[0], args[1], now=args[2])
        m.hbm.get_hbm_plane().register("rh", obs)
        return (obs.payload(now=52.0), obs.justification(now=52.0),
                obs.occupancy_integral(52.0), obs.attributed_page_seconds(52.0),
                obs.events(50.5), m.hbm.get_hbm_plane().payload(52.0))

    out = assert_same(run)
    occ, attr = out[2], out[3]
    assert abs(occ - attr) <= 1e-9 * max(1.0, occ)
    assert out[0]["fragmentation"]["runs"] > 1


# ------------------------------------------------ continuous profiler --

@pytest.mark.parametrize("every,ring", [(4, 8), (0, 8), (1, 3)])
def test_continuous_profiler_matches_jax(planes, every, ring):
    def run(m):
        prof = m.continuous.ContinuousProfiler("rp", sample_every=every, ring=ring)
        rec = {"decode": 1e-3, "wall": 2e-3, "committed": 4.0}
        for i in range(40):
            prof.on_step(100.0 + i * 0.01, rec if i % 3 else None, queue=(2, i % 4, 0),
                         pool=(10, 3))
        m.continuous.register_profiler("rp", prof)
        return prof.payload(), prof.samples(100.2), sorted(m.continuous.profilers())

    assert_same(run)


def test_continuous_profiler_reads_the_settings(planes):
    planes(PROFILE_SAMPLE_EVERY="5", PROFILE_RING="7")
    out = assert_same(lambda m: (m.continuous.ContinuousProfiler("rs").sample_every,
                                 m.continuous.ContinuousProfiler("rs").ring))
    assert out == (5, 7)


# ------------------------------------------------------------ timeline --

def _populate(m, now):
    """Every timeline source but the real-time ones, at explicit times."""
    led = m.ledger.TokenLedger("r0", window_s=60.0)
    snap = _snap(m)
    led.on_step(dict(snap), now - 1.0, now - 0.8, compiles=1)
    snap.update(committed_tokens=8, prefill_tokens=16, prefill_seconds_total=0.1,
                decode_seconds_total=0.1)
    led.on_step(dict(snap), now - 0.7, now - 0.2)
    m.slo.get_slo_plane().register("r0", ledger=led, monitor=m.slo.SLOMonitor("r0"))
    prof = m.continuous.ContinuousProfiler("r1", sample_every=1, ring=8)
    prof.on_step(now - 0.6, {"prefill": 0.01, "decode": 0.05, "wall": 0.06},
                 queue=(2, 1, 0), pool=(30, 2))
    m.continuous.register_profiler("r1", prof)
    obs = m.hbm.PageObservatory("r0")
    obs.on_tier_event("writeback", 2, now=now - 1.1)
    obs.on_tier_event("fault_in", 1, now=now - 0.9)
    obs.on_tier_event("park", 1, now=now - 500.0)  # outside the window
    m.hbm.get_hbm_plane().register("r0", obs)
    m.slo.get_slo_plane().set_controller_info(lambda: {"log": [
        {"t": now - 0.4, "replica": "r0", "action": "failover", "reason": "dead",
         "status": "dispatched", "justification": {"ledger": led.justification(now)},
         "detail": {"victim": "r0"}}]})
    m.timeline.set_fleet_events_provider(lambda: [
        {"t": now - 1.9, "kind": "fleet.lifecycle", "replica": "r0", "state": "active"},
        {"t": now - 1.6, "kind": "router.pick", "replica": "r0", "decision": "affinity_hit"},
        {"t": now - 0.3, "kind": "fleet.fence", "replica": "r0",
         "failed_requests": ["req-b", "req-c"]},
        {"t": now - 99.0, "kind": "router.pick", "replica": "r1"}])


@pytest.mark.parametrize("window,cap", [(60.0, 20000), (60.0, 5), (0.5, 20000)])
def test_build_timeline_matches_jax(planes, window, cap):
    """The merged Perfetto trace from the same sources: the same events in
    the same order, the same counts, drops and replicas."""
    now = 1000.0

    def run(m):
        _populate(m, now)
        trace = m.timeline.build_timeline(window_s=window, now=now, max_events=cap)
        md = dict(trace["metadata"])
        md.pop("anchor_wall_t")
        md.pop("anchor_monotonic_s")
        return trace["traceEvents"], md, trace["displayTimeUnit"]

    events, md, unit = assert_same(run)
    assert unit == "ms" and md["replicas"] == ["r0", "r1"]
    assert (md["dropped_events"] > 0) == (cap == 5)
    assert len([e for e in events if e["ph"] != "M"]) <= cap


# ------------------------------------------------------- golden schemas --

def shape(value):
    """The schema scripts' type shape (scripts/check_*_schema.py)."""
    if isinstance(value, dict):
        return {k: shape(v) for k, v in sorted(value.items())}
    if isinstance(value, list):
        return [shape(value[0])] if value else []
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, (int, float)):
        return "number"
    if value is None:
        return "null"
    return type(value).__name__


def conforms(got, golden, path="$") -> None:
    """A live payload's shape against the golden one: every key it has, the
    golden has with the same shape (a dict keyed by names -- replicas,
    classes, request ids -- holds its values to the golden's one entry, an
    empty golden map takes any names); a section the golden fills may be
    null or empty here (no router, no
    controller, no traffic yet).  A replica's ``stats`` is its engine's
    own dict (the golden's is a stand-in provider's) and is not held."""
    if got in ("null", []) or (got == {} and isinstance(golden, dict)):
        return
    if path.endswith(".stats"):
        assert isinstance(got, dict), f"{path}: {got}"
        return
    if isinstance(golden, dict):
        assert isinstance(got, dict), f"{path}: {got} vs {golden}"
        if not golden:  # a map by name the golden build left empty
            return
        for k, v in got.items():
            if k in golden:
                conforms(v, golden[k], f"{path}.{k}")
            else:
                assert len(golden) == 1, f"{path}: key {k!r} not in the golden schema"
                conforms(v, next(iter(golden.values())), f"{path}.{k}")
    elif isinstance(golden, list):
        assert isinstance(got, list), f"{path}: {got} vs {golden}"
        if got and golden:
            conforms(got[0], golden[0], f"{path}[0]")
    else:
        assert got == golden or (golden == "null"), f"{path}: {got} vs {golden}"


def golden(name: str) -> dict:
    return json.loads((GOLDEN / name).read_text())


def _port_schema_script(script: str) -> dict:
    """``build_payloads`` of a committed schema script, run against the
    port's modules (the fleet's router digest, which the port does not
    have yet, stays the JAX object whose ``payload()`` the plane renders)."""
    src = (REPO / "scripts" / script).read_text()
    src = src.replace("githubrepostorag_tpu.", "githubrepostorag_tpu_torch.")
    src = src.replace("githubrepostorag_tpu_torch.serving.routing",
                      "githubrepostorag_tpu.serving.routing")
    ns = {"__name__": f"port_{script}", "__file__": str(REPO / "scripts" / script)}
    exec(compile(src, script, "exec"), ns)  # noqa: S102 - a committed script
    return ns


def test_debug_slo_and_fleet_payloads_equal_the_golden(planes):
    ns = _port_schema_script("check_slo_schema.py")
    slo, fleet = ns["build_payloads"]()
    assert {"GET /debug/slo": shape(slo), "GET /debug/fleet": shape(fleet)} == \
        golden("debug_slo_schema.json")


def test_debug_timeline_and_hbm_payloads_equal_the_golden(planes, monkeypatch):
    monkeypatch.setenv("FAULTS", "")
    ns = _port_schema_script("check_timeline_schema.py")
    timeline, hbm = ns["build_payloads"]()
    top = dict(timeline)
    top["traceEvents"] = []
    assert {"GET /debug/timeline": shape(top),
            "GET /debug/timeline traceEvents": ns["event_shapes"](timeline),
            "GET /debug/hbm": shape(hbm)} == golden("debug_timeline_schema.json")
    assert all(timeline["metadata"]["sources"].values())


def test_debug_traces_payloads_equal_the_golden(planes, monkeypatch):
    monkeypatch.setenv("TRACE_SAMPLE", "1")
    ns = _port_schema_script("check_traces_schema.py")
    summaries, detail = ns["build_payloads"]()
    assert {"GET /debug/traces": shape(summaries),
            "GET /debug/traces/{trace_id}": shape(detail)} == golden("debug_traces_schema.json")


def test_conforms_accepts_a_live_subset_and_refuses_drift():
    g = golden("debug_slo_schema.json")["GET /debug/fleet"]
    live = {"admission_hint": "str", "controller": "null", "router": "null",
            "fleet": g["fleet"], "replicas": []}
    conforms(live, g)
    with pytest.raises(AssertionError):
        conforms({**live, "admission": "str"}, g)
    with pytest.raises(AssertionError):
        conforms({**live, "admission_hint": "number"}, g)


# ------------------------------------------------------------- watchdog --

def test_compile_watchdog_counts_new_plans_and_rebaselines():
    from githubrepostorag_tpu_torch.ops.fused_decode import _plan_window
    from githubrepostorag_tpu_torch.ops.paged_decode import _plan_decode

    shapes: set = set()
    prof = EngineStepProfiler(CompileWatchdog(plan_caches() + [("shapes", lambda: len(shapes))]),
                              replica="wd")
    prof.mark_warm()
    assert prof.on_step(1.0, 1.1) == 0
    _plan_window(3, 7, 14, 2, 64, 128, 131)  # a shape no test uses elsewhere
    _plan_window(3, 7, 14, 2, 64, 128, 131)  # cached: no second miss
    _plan_decode(3, 2, 17, 128, 131)
    shapes.add(("draft", 3, 2))
    before = t_metrics.counter_value(t_metrics.XLA_COMPILES, replica="wd")
    assert prof.on_step(1.2, 1.3) == 3
    assert t_metrics.counter_value(t_metrics.XLA_COMPILES, replica="wd") == before + 3
    shapes.add(("draft", 4, 2))
    prof.mark_warm()  # another engine's warmup: re-baselined away
    assert prof.on_step(1.4, 1.5) == 0
    assert t_metrics.SCHED_STALL.labels(replica="wd").value == pytest.approx(0.1)


# -------------------------------------------------------------- metrics --

NEW_SERIES = ("XLA_COMPILES", "TPOT", "SCHED_STALL", "LEDGER_GOODPUT", "LEDGER_MFU",
              "LEDGER_LIMITER", "LEDGER_STEP_SECONDS", "LEDGER_TOKENS", "ENGINE_FUSED_STEPS",
              "ENGINE_STEP_DISPATCHES", "SLO_BURN", "SLO_STATE", "SLO_TRANSITIONS",
              "HBM_HELD_PAGES", "HBM_PAGE_SECONDS", "PROFILE_SAMPLES", "TIMELINE_EXPORTS",
              "TIMELINE_EVENTS_DROPPED", "ENGINE_RUNNING", "ENGINE_WAITING")


@pytest.mark.parametrize("name", NEW_SERIES)
def test_new_series_names_and_labels_equal_jax(name):
    t, j = getattr(t_metrics, name), getattr(j_metrics, name)
    # prometheus_client keeps a counter's name without its _total suffix
    assert t.name in (j._name, j._name + "_total")
    assert t.labelnames == tuple(j._labelnames)
    assert type(t).__name__ == type(j).__name__
    if name != "XLA_COMPILES":  # the port's help says what it counts
        assert t.documentation == j._documentation
    if hasattr(j, "_upper_bounds"):
        assert list(t.buckets) + [float("inf")] == list(j._upper_bounds)


# --------------------------------------------------------------- driver --

def test_driver_wires_the_planes_and_pushes_class_pressure(planes):
    """``AsyncEngine`` registers its ledger, monitor, page observatory and
    profiler under its replica, pushes the monitor's class states into
    ``Engine.set_class_pressure`` (every 0.25 s, on the driver thread),
    observes each finished request, and the ledger's committed tokens
    equal the requests' tokens; the page observatory's attribution meets
    its occupancy integral within the JAX test's 1 %."""
    import asyncio

    from githubrepostorag_tpu_torch.models.qwen2 import init_params
    from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine, SamplingParams

    planes(SLO_WINDOWS="1,5", PROFILE_SAMPLE_EVERY="1")
    cfg = Qwen2Config.tiny()
    eng = Engine(init_params(cfg, torch.Generator().manual_seed(2), device="cpu"), cfg,
                 max_num_seqs=2, num_pages=32, page_size=4, max_seq_len=64, device="cpu")
    pushed = []
    real = eng.set_class_pressure

    def record(states):
        pushed.append(dict(states))
        real(states)

    eng.set_class_pressure = record
    sp = SamplingParams(max_tokens=6, temperature=0.0)

    async def run():
        ae = AsyncEngine(eng, replica="drv")
        try:
            res = await asyncio.gather(*(ae.generate([3 + i, 4, 5, 6], sp, priority="batch")
                                         for i in range(3)))
            for i in range(6):  # the protected class burns critically
                ae.slo.observe("interactive", deadline_missed=True)
            ae.slo.maybe_refresh(force=True)
            await asyncio.sleep(0.3)
            res.append(await ae.generate([9, 9, 9], sp))
            return ae, res
        finally:
            await ae.stop()

    ae, res = asyncio.run(run())
    # (under load the batch requests' TTFT may burn their class too)
    assert pushed and pushed[0] == {} and any(p.get("interactive") == 2 for p in pushed)
    assert t_slo.get_slo_plane().ledgers()["drv"] is ae.ledger
    assert t_hbm.get_hbm_plane().get("drv") is ae.page_obs
    assert t_continuous.profilers()["drv"] is ae.continuous
    led = ae.ledger.snapshot()
    assert led["tokens"]["committed"] == sum(len(r.output_tokens) for r in res)
    assert led["steps"] == ae.steps_total > 0
    events = {(r["objective"], r["klass"]): r["events"] for r in ae.slo.payload()["objectives"]}
    assert events[("deadline_miss", "batch")] == 3
    now = time.monotonic()
    occ, attr = ae.page_obs.occupancy_integral(now), ae.page_obs.attributed_page_seconds(now)
    assert occ > 0 and abs(occ - attr) <= 0.01 * occ
    assert ae.continuous.payload()["captured"] == ae.steps_total


def test_unlabelled_request_counts_against_the_engines_default_class_as_jax(planes):
    """A request with no class is stamped with the engine's default class,
    and the SLO plane observes that class (ROADMAP queue 3 item 20): under
    ``default_priority="batch"`` both drivers observe ``['batch']`` for an
    unlabelled ``generate``, and ``/debug/slo``'s per-class event counts
    are equal."""
    import asyncio

    import jax
    import jax.numpy as jnp
    import numpy as np

    from githubrepostorag_tpu.models.qwen2 import init_params as j_init
    from githubrepostorag_tpu.serving import Engine as JEngine, SamplingParams as JSamplingParams
    from githubrepostorag_tpu.serving.async_engine import AsyncEngine as JAsyncEngine
    from githubrepostorag_tpu_torch.models.convert import params_from_jax
    from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine, SamplingParams

    planes(SLO_WINDOWS="1,5")
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    geom = dict(max_num_seqs=2, num_pages=32, page_size=4, max_seq_len=64,
                default_priority="batch")
    sides = {
        "jax": (JAsyncEngine, lambda: JEngine(jp, jcfg, kv_dtype=jnp.float32, **geom),
                JSamplingParams),
        "port": (AsyncEngine, lambda: Engine(
            params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu"), cfg,
            kv_dtype=torch.float32, device="cpu", **geom), SamplingParams),
    }

    def run(name):
        cls, engine, sp = sides[name]

        async def go():
            ae = cls(engine(), replica="r0")
            seen = []
            observe = ae.slo.observe

            def record(klass, **kw):
                seen.append(klass)
                return observe(klass, **kw)

            ae.slo.observe = record
            try:
                await asyncio.wait_for(ae.generate([3, 4, 5, 6], sp(max_tokens=1,
                                                                    temperature=0.0)), 60)
                for _ in range(100):  # the driver observes as it emits the final event
                    if seen:
                        break
                    await asyncio.sleep(0.02)
                plane = SIDES[name].slo.get_slo_plane().slo_payload()
                counts = {(r["objective"], r["klass"]): r["events"]
                          for rep in plane["replicas"] for r in rep["objectives"]}
                return seen, counts
            finally:
                await ae.stop()

        return asyncio.run(go())

    out = {name: run(name) for name in sides}
    assert out["port"][0] == out["jax"][0] == ["batch"]
    assert out["port"][1] == out["jax"][1]
    assert {k for k, _ in out["port"][1]} and {c for _, c in out["port"][1]} == {"batch"}
