"""The port's self-healing fleet controller against the JAX package's
(CPU): every case of ``tests/test_controller.py`` runs both controllers
over the same fake fleet under the same simulated clock (``tick(now=...)``)
and compares what they act on, the actuator calls in order, the guard
counters, the action log and the ``/debug/fleet`` controller section; and
the chaos case of ``tests/test_chaos.py`` (a FAULTS-killed replica fenced,
a warm spare restored from an index snapshot and activated, the corpse
retired) runs on both packages' real fleets over the same numpy-seeded
tiny Qwen2 with the same outcome."""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
from types import SimpleNamespace

import pytest

import githubrepostorag_tpu.config as j_config
import githubrepostorag_tpu.metrics as j_metrics
import githubrepostorag_tpu.obs.slo as j_slo
import githubrepostorag_tpu.resilience.faults as j_faults
import githubrepostorag_tpu.serving.controller as j_controller
from githubrepostorag_tpu_torch import config as t_config
from githubrepostorag_tpu_torch import metrics as t_metrics
from githubrepostorag_tpu_torch.obs import slo as t_slo
from githubrepostorag_tpu_torch.resilience import faults as t_faults
from githubrepostorag_tpu_torch.serving import controller as t_controller

from tests.test_torch_fleet import _port_state, greedy, set_env, sides  # noqa: F401

PKGS = {
    "jax": SimpleNamespace(controller=j_controller, metrics=j_metrics, slo=j_slo,
                           config=j_config, faults=j_faults),
    "port": SimpleNamespace(controller=t_controller, metrics=t_metrics, slo=t_slo,
                            config=t_config, faults=t_faults),
}


class FakeReplica:
    """Just the surface the controller touches on an AsyncEngine row."""

    def __init__(self, rid: str, lifecycle: str = "active") -> None:
        self.replica = rid
        self.lifecycle = lifecycle
        self.heartbeat: float | None = None
        self.driver_error: str | None = None
        self.alive = False
        self._lock = threading.Lock()
        self.engine = SimpleNamespace(
            _allocator=SimpleNamespace(host_pool_pages=4, num_pages=8),
            _spec_k_ladder=[1, 2, 4], spec_k=4)

    def driver_alive(self) -> bool:
        return self.alive


class FakeFleet:
    """Records every actuator call the controller makes, in order."""

    def __init__(self, replicas: list[FakeReplica]) -> None:
        self._engines = replicas
        self._by_id = {ae.replica: ae for ae in replicas}
        self.affinity_slack = 4.0
        self.calls: list[tuple[str, str]] = []

    def replicas(self) -> list[FakeReplica]:
        return list(self._engines)

    def spare_replicas(self) -> list[str]:
        return [ae.replica for ae in self._engines if ae.lifecycle == "spare"]

    def set_affinity_slack(self, slack: float) -> float:
        self.affinity_slack = max(0.5, float(slack))
        return self.affinity_slack

    async def fence(self, replica: str) -> dict:
        self.calls.append(("fence", replica))
        return {"replica": replica, "lifecycle": "draining", "failed": 2}

    async def activate(self, replica: str) -> dict:
        self.calls.append(("activate", replica))
        self._by_id[replica].lifecycle = "active"
        return {"replica": replica, "lifecycle": "active"}

    async def retire(self, replica: str) -> dict:
        self.calls.append(("retire", replica))
        self._by_id[replica].lifecycle = "drained"
        return {"replica": replica, "lifecycle": "drained"}


def make_fleet(*lifecycles: str) -> FakeFleet:
    return FakeFleet([FakeReplica(f"r{i}", lc) for i, lc in enumerate(lifecycles)])


def ctrl(pkg, monkeypatch, fleet, *, restore=None, **env: str):
    env.setdefault("CTRL_HYSTERESIS_TICKS", "2")
    env.setdefault("CTRL_COOLDOWN_S", "10")
    env.setdefault("CTRL_MAX_ACTIONS", "4")
    env.setdefault("CTRL_ACTION_WINDOW_S", "100")
    env.setdefault("CTRL_LIVENESS_TIMEOUT_S", "5")
    set_env(monkeypatch, **env)
    return pkg.controller.FleetController(fleet, clock=lambda: 0.0, restore=restore)


def sensed(rid: str, *, lifecycle: str = "active", thread_alive: bool = True,
           heartbeat_age_s: float | None = 0.1, breaker: str = "closed", burn: str = "ok",
           limiter: str = "none") -> dict:
    return {rid: {
        "ledger": {"limiter": limiter, "window_s": 60.0, "steps": 5, "goodput_tok_s": 100.0},
        "burn": {"state": burn, "classes": {"interactive": burn}},
        "lifecycle": lifecycle,
        "liveness": {"started": True, "thread_alive": thread_alive,
                     "heartbeat_age_s": heartbeat_age_s, "driver_error": None,
                     "breaker": breaker},
    }}


def script(monkeypatch, c, snap) -> None:
    monkeypatch.setattr(c, "_sense", snap if callable(snap) else (lambda now: snap))


def acted(entries: list[dict]) -> list[tuple]:
    return [(a["replica"], a["action"], a["reason"], a["ticks_agreed"]) for a in entries]


def payload(c) -> dict:
    """The controller section without the ``running`` flag's thread."""
    return {k: v for k, v in c.payload().items() if k != "running"}


def counters(pkg) -> dict:
    m = pkg.metrics
    return {
        "suppressed": {g: m.counter_value(m.CTRL_SUPPRESSED, guard=g)
                       for g in ("hysteresis", "cooldown", "budget", "inflight")},
        "failopen": m.counter_value(m.CTRL_FAILOPEN),
        "actions": {f"{a}:{r}": m.counter_value(m.CTRL_ACTIONS, action=a, reason=r)
                    for a in j_controller.ACTIONS
                    for r in ("dead", "wedged", "breaker_open", "burn_critical", "hbm_pages",
                              "swap_wait")},
    }


def deltas(before: dict, after: dict) -> dict:
    out = {}
    for key, value in after.items():
        out[key] = (deltas(before[key], value) if isinstance(value, dict)
                    else value - before[key])
    return out


def on_both(fn) -> dict:
    """``fn(pkg)`` for each package (each with its own counters' deltas)."""
    out = {}
    for name, pkg in PKGS.items():
        before = counters(pkg)
        result = fn(pkg)
        out[name] = (result, deltas(before, counters(pkg)))
    return out


def same(out: dict):
    assert out["port"] == out["jax"]
    return out["port"]


# ------------------------------------------------------------------- sense --


def test_constants_and_surface_match_jax():
    assert t_controller.ACTIONS == j_controller.ACTIONS
    assert t_controller._LOG_RING == j_controller._LOG_RING


def test_sense_merges_liveness_with_plane_snapshot_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active", "active")
        c = ctrl(pkg, monkeypatch, fl)
        r0, r1 = fl._by_id["r0"], fl._by_id["r1"]
        r0.heartbeat, r0.alive = 10.0, True
        r1.heartbeat, r1.alive, r1.driver_error = 3.0, False, "injected"
        return c._sense(now=11.0)

    out, _ = same(on_both(run))
    assert out["r0"]["liveness"] == {"started": True, "thread_alive": True,
                                     "heartbeat_age_s": 1.0, "driver_error": None,
                                     "breaker": "closed"}
    assert out["r1"]["liveness"]["heartbeat_age_s"] == 8.0
    assert out["r0"]["ledger"] is None and out["r0"]["burn"] is None


def test_never_started_replica_is_not_declared_dead_as_jax(monkeypatch):
    def run(pkg):
        c = ctrl(pkg, monkeypatch, make_fleet("active"))
        return c.tick(now=0.0), c.tick(now=1.0), c._pending

    got, d = same(on_both(run))
    assert got == ([], [], {}) and d["suppressed"]["hysteresis"] == 0


# -------------------------------------------------------------- hysteresis --


def test_failover_needs_two_consecutive_agreeing_ticks_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active", "spare")
        c = ctrl(pkg, monkeypatch, fl)
        script(monkeypatch, c, sensed("r0", thread_alive=False))
        first = c.tick(now=0.0)
        pending = c.payload()["hysteresis"]["pending"]
        second = acted(c.tick(now=1.0))
        entry = c.payload()["log"][-1]
        return first, pending, second, fl.calls, entry, payload(c)

    (first, pending, second, calls, entry, _), d = same(on_both(run))
    assert first == [] and pending == {"r0:failover:dead": 1}
    assert second == [("r0", "failover", "dead", 2)]
    assert calls == [("fence", "r0"), ("activate", "r1"), ("retire", "r0")]
    assert entry["status"] == "dispatched" and entry["detail"]["spare"] == "r1"
    assert d["suppressed"]["hysteresis"] == 1 and d["actions"]["failover:dead"] == 1


def test_hysteresis_resets_when_the_decision_vanishes_as_jax(monkeypatch):
    def run(pkg):
        c = ctrl(pkg, monkeypatch, make_fleet("active", "spare"))
        dead, healthy = sensed("r0", thread_alive=False), sensed("r0")
        script(monkeypatch, c, lambda now: dead if now != 1.0 else healthy)
        ticks = [acted(c.tick(now=t)) for t in (0.0, 1.0)]
        pending = c.payload()["hysteresis"]["pending"]
        ticks += [acted(c.tick(now=t)) for t in (2.0, 3.0)]
        return ticks, pending

    (ticks, pending), _ = same(on_both(run))
    assert ticks[:3] == [[], [], []] and pending == {}
    assert ticks[3] == [("r0", "failover", "dead", 2)]


# ------------------------------------------------- cooldown / budget guards --


def test_cooldown_absorbs_oscillation_then_allows_refire_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active")
        c = ctrl(pkg, monkeypatch, fl, CTRL_COOLDOWN_S="10", CTRL_HOST_POOL_MAX_PAGES="64")
        script(monkeypatch, c, sensed("r0", limiter="hbm_pages"))
        alloc = fl._by_id["r0"].engine._allocator
        trace = []
        for t in (0.0, 1.0, 2.0, 5.0, 10.9, 11.1, 12.1):
            trace.append((t, acted(c.tick(now=t)), alloc.host_pool_pages))
        return trace, payload(c)

    (trace, _), d = same(on_both(run))
    assert [p for *_, p in trace] == [4, 6, 6, 6, 6, 6, 9]
    assert d["suppressed"]["cooldown"] == 3


def test_budget_caps_actions_per_sliding_window_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active", "active", "spare")
        c = ctrl(pkg, monkeypatch, fl, CTRL_MAX_ACTIONS="1", CTRL_ACTION_WINDOW_S="100")
        script(monkeypatch, c, {**sensed("r0", thread_alive=False),
                                **sensed("r1", thread_alive=False)})
        ticks = [acted(c.tick(now=t)) for t in (0.0, 1.0)]
        used = c.payload()["budget"]["used"]
        ticks.append(acted(c.tick(now=102.0)))
        return ticks, used

    (ticks, used), d = same(on_both(run))
    assert ticks[1] == [("r0", "failover", "dead", 2)] and used == 1
    assert [a[0] for a in ticks[2]] == ["r1"] and d["suppressed"]["budget"] == 1


def test_inflight_failover_suppresses_stacked_actions_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active", "spare")
        c = ctrl(pkg, monkeypatch, fl)
        script(monkeypatch, c, sensed("r0", thread_alive=False))
        blocker: concurrent.futures.Future = concurrent.futures.Future()
        c._inflight["r0"] = blocker
        ticks = [acted(c.tick(now=t)) for t in (0.0, 1.0)]
        calls = list(fl.calls)
        blocker.set_result(None)
        ticks += [acted(c.tick(now=t)) for t in (2.0, 3.0)]
        return ticks, calls

    (ticks, calls), d = same(on_both(run))
    assert ticks[:3] == [[], [], []] and calls == [] and d["suppressed"]["inflight"] == 2
    assert [a[1] for a in ticks[3]] == ["failover"]


# ------------------------------------------------------------- the ladder --


def test_hbm_pages_prefers_pool_growth_until_capped_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active")
        c = ctrl(pkg, monkeypatch, fl, CTRL_HOST_POOL_MAX_PAGES="4", CTRL_COOLDOWN_S="0")
        script(monkeypatch, c, sensed("r0", limiter="hbm_pages"))
        eng = fl._by_id["r0"].engine
        trace = [(acted(c.tick(now=float(t))), list(eng._spec_k_ladder), eng.spec_k)
                 for t in range(6)]
        return trace, c.payload()["log"][-1]["detail"]

    (trace, detail), _ = same(on_both(run))
    assert trace[1][1:] == ([1, 2], 2) and trace[3][1:] == ([1], 1)
    assert trace[5][0][0][1] == "spec_k_down"
    assert detail == {"noop": "spec-k ladder already at its floor"}


def test_swap_wait_halves_affinity_slack_with_floor_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active")
        c = ctrl(pkg, monkeypatch, fl, CTRL_COOLDOWN_S="0")
        script(monkeypatch, c, sensed("r0", limiter="swap_wait"))
        slacks = []
        for t in range(10):
            c.tick(now=float(t))
            slacks.append(fl.affinity_slack)
        return slacks

    slacks, _ = same(on_both(run))
    assert slacks[1] == 2.0 and slacks[-1] == 0.5


@pytest.mark.parametrize("kind", ["breaker_open", "burn_critical", "wedged"])
def test_breaker_open_critical_burn_and_wedge_mean_failover_as_jax(monkeypatch, kind):
    snaps = {"breaker_open": sensed("r0", breaker="open"),
             "burn_critical": sensed("r0", burn="critical"),
             "wedged": sensed("r0", heartbeat_age_s=6.0)}

    def run(pkg):
        fl = make_fleet("active", "spare")
        c = ctrl(pkg, monkeypatch, fl)
        script(monkeypatch, c, snaps[kind])
        c.tick(now=0.0)
        return acted(c.tick(now=1.0)), fl.calls

    (got, calls), _ = same(on_both(run))
    assert got == [("r0", "failover", kind, 2)] and ("fence", "r0") in calls


def test_failover_without_spare_still_fences_and_retires_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active")
        c = ctrl(pkg, monkeypatch, fl)
        script(monkeypatch, c, sensed("r0", thread_alive=False))
        c.tick(now=0.0)
        return acted(c.tick(now=1.0)), fl.calls, c.payload()["log"][-1]["detail"]

    (got, calls, detail), _ = same(on_both(run))
    assert calls == [("fence", "r0"), ("retire", "r0")] and detail["no_spare"] is True


def test_failover_restores_snapshot_before_activating_spare_as_jax(monkeypatch):
    def run(pkg):
        order: list[str] = []
        fl = make_fleet("active", "spare")

        async def activate(replica):
            order.append(f"activate-{replica}")
            return {"replica": replica, "lifecycle": "active"}

        fl.activate = activate
        c = ctrl(pkg, monkeypatch, fl,
                 restore=lambda: order.append("restore") or {"replayed": 3})
        script(monkeypatch, c, sensed("r0", thread_alive=False))
        c.tick(now=0.0)
        c.tick(now=1.0)
        fut = c.inflight()["r0"]
        return fut.done(), order, fut.result()

    (done, order, result), _ = same(on_both(run))
    assert done and order == ["restore", "activate-r1"] and result["restored"] == {"replayed": 3}


def test_restore_failure_downgrades_to_cold_activate_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active", "spare")

        def broken_restore():
            raise RuntimeError("snapshot dir lost")

        c = ctrl(pkg, monkeypatch, fl, restore=broken_restore)
        script(monkeypatch, c, sensed("r0", thread_alive=False))
        c.tick(now=0.0)
        c.tick(now=1.0)
        return c.inflight()["r0"].result(timeout=5), fl.calls

    (out, calls), d = same(on_both(run))
    assert out["restored"] == {"error": "snapshot dir lost"} and ("activate", "r1") in calls
    assert d["failopen"] == 1


# ---------------------------------------------------------------- fail-open --


def test_sense_exception_fails_open_and_keeps_observing_as_jax(monkeypatch):
    def run(pkg):
        c = ctrl(pkg, monkeypatch, make_fleet("active", "spare"))
        boom = {"on": True}

        def sense(now):
            if boom["on"]:
                raise RuntimeError("plane exploded")
            return sensed("r0", thread_alive=False)

        script(monkeypatch, c, sense)
        ticks = [acted(c.tick(now=t)) for t in (0.0, 1.0)]
        p = c.payload()
        boom["on"] = False
        ticks += [acted(c.tick(now=t)) for t in (2.0, 3.0)]
        return ticks, p["failopen"], p["log"][-1]

    (ticks, failopen, entry), d = same(on_both(run))
    assert ticks[:3] == [[], [], []] and [a[1] for a in ticks[3]] == ["failover"]
    assert failopen == 2 and entry["status"] == "failopen" and d["failopen"] == 2


def test_action_exception_fails_open_without_poisoning_others_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active", "active")
        c = ctrl(pkg, monkeypatch, fl, CTRL_COOLDOWN_S="0")
        script(monkeypatch, c, {**sensed("r0", limiter="swap_wait"),
                                **sensed("r1", limiter="hbm_pages")})
        monkeypatch.setattr(c, "_act_spread_affinity",
                            lambda: (_ for _ in ()).throw(RuntimeError("boom")))
        c.tick(now=0.0)
        return acted(c.tick(now=1.0)), fl._by_id["r1"].engine._allocator.host_pool_pages

    (got, pool), d = same(on_both(run))
    assert [a[:2] for a in got] == [("r1", "grow_host_pool")] and pool == 6
    assert d["failopen"] == 1


def test_controller_act_fault_seam_drops_the_action_as_jax(monkeypatch):
    def run(pkg):
        fl = make_fleet("active", "spare")
        c = ctrl(pkg, monkeypatch, fl)
        set_env(monkeypatch, FAULTS="fleet.controller.act:drop")
        script(monkeypatch, c, sensed("r0", thread_alive=False))
        c.tick(now=0.0)
        return acted(c.tick(now=1.0)), fl.calls, c.payload()["log"][-1]

    (got, calls, entry), _ = same(on_both(run))
    assert got == [] and calls == [] and (entry["status"], entry["action"]) == (
        "dropped", "failover")


# -------------------------------------------------------------- publication --


def test_payload_reaches_debug_fleet_via_the_plane_as_jax(monkeypatch):
    def run(pkg):
        c = ctrl(pkg, monkeypatch, make_fleet("active", "spare"))
        script(monkeypatch, c, sensed("r0", thread_alive=False))
        c.tick(now=0.0)
        c.tick(now=1.0)
        section = pkg.slo.get_slo_plane().fleet_payload()["controller"]
        return {k: v for k, v in section.items() if k != "running"}

    section, _ = same(on_both(run))
    assert section["actions_total"] == 1 and section["ticks"] == 2
    assert section["log"][-1]["action"] == "failover" and "r0:failover" in section["cooldowns"]


async def test_start_stop_runs_the_reconcile_thread_as_jax(monkeypatch):
    out = {}
    for name, pkg in PKGS.items():
        fl = make_fleet("active")
        set_env(monkeypatch, CTRL_TICK_S="0.01")
        c = pkg.controller.FleetController(fl)  # the real clock
        r0 = fl._by_id["r0"]
        r0.heartbeat, r0.alive = time.monotonic(), True
        await c.start()
        try:
            for _ in range(200):
                if c.payload()["ticks"] >= 3:
                    break
                await asyncio.sleep(0.01)
            running = (c.payload()["ticks"] >= 3, c.payload()["running"])
        finally:
            c.stop()
        ticks = c.payload()["ticks"]
        await asyncio.sleep(0.05)
        out[name] = (running, c.payload()["ticks"] == ticks, c.payload()["running"], fl.calls)
    assert out["port"] == out["jax"] == ((True, True), True, False, [])


# ------------------------------------------------ chaos (JAX test_chaos) --


async def test_controller_chaos_killed_replica_recovers_via_spare_as_jax(
        sides, monkeypatch, tmp_path):
    """FAULTS kills r0's driver on its third iteration under load: on both
    packages the controller fences r0 (its in-flight requests end with the
    standard error frame), restores the index snapshot into the spare's
    store, activates r2, retires r0, and the next wave is served, with the
    same requests failed, the same action log and the same counters."""
    import githubrepostorag_tpu.embedding as j_embedding
    import githubrepostorag_tpu.retrieval.snapshot as j_snapshot
    import githubrepostorag_tpu.store as j_store
    import githubrepostorag_tpu_torch.embedding as t_embedding
    import githubrepostorag_tpu_torch.retrieval.snapshot as t_snapshot
    from githubrepostorag_tpu_torch.store.base import Doc as TDoc
    from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore as TMemoryStore

    stores = {"jax": (j_store.MemoryVectorStore, j_store.Doc, j_embedding, j_snapshot),
              "port": (TMemoryStore, TDoc, t_embedding, t_snapshot)}
    ps = [[1 + i, 2 + i, 3 + i, 4 + i] for i in range(8)]

    async def run(name, side):
        store_cls, doc_cls, embedding, snapshot = stores[name]
        root = tmp_path / name
        source = store_cls()
        text = "def handler(req): route and serve"
        source.upsert("embeddings", [doc_cls(
            "d1", text, {"namespace": "default", "scope": "chunk"},
            embedding.HashingTextEncoder().encode([text])[0])])
        snapshot.save_snapshot(source, str(root / "snap-001"), watermark=7)
        restored_into = store_cls()
        calls: list[dict] = []

        def restore():
            out = snapshot.restore_for_activation(str(root), restored_into)
            calls.append(out)
            return out

        # objectives no CPU run misses: under a loaded machine the tiny
        # model's TTFT would burn the budget critical and fail over a live
        # replica too (the burn rung has its own case above)
        set_env(monkeypatch, FAULTS="fleet.step.r0:error@window=3:", CTRL_TICK_S="0.05",
                CTRL_HYSTERESIS_TICKS="2", CTRL_COOLDOWN_S="0.1", CTRL_LIVENESS_TIMEOUT_S="30",
                CTRL_MAX_ACTIONS="4", CTRL_ACTION_WINDOW_S="60", SLO_TTFT_P50_MS="600000",
                SLO_TTFT_P99_MS="600000", SLO_TPOT_MS="600000")
        geom = dict(max_num_seqs=4, page_size=8)
        sp = greedy(side, 12)
        plain = [r.output_tokens for r in side.engine(**geom).generate(ps, sp)]
        multi = side.multi.MultiAsyncEngine([side.engine(**geom) for _ in range(3)], spares=1)
        pkg = PKGS[name]
        before = counters(pkg)
        c = pkg.controller.FleetController(multi, restore=restore)
        await c.start()
        try:
            wave1 = await asyncio.wait_for(
                asyncio.gather(*(multi.generate(p, sp) for p in ps)), timeout=120)
            fenced = multi.router_stats()["per_replica"]["r0"]["routed"]
            for _ in range(400):
                if (multi._by_id["r2"].lifecycle == "active"
                        and multi._by_id["r0"].lifecycle == "drained"):
                    break
                await asyncio.sleep(0.025)
            state = {r: (ae.lifecycle, ae.driver_alive())
                     for r, ae in multi._by_id.items()}
            section = multi.fleet()["controller"]
            fo = [e for e in section["log"] if e["action"] == "failover"
                  and e["status"] == "dispatched"]
            wave2 = await asyncio.wait_for(
                asyncio.gather(*(multi.generate(p, sp) for p in ps[:4])), timeout=120)
            per = multi.router_stats()["per_replica"]
            # which requests r0 held depends on the drivers' timing (the
            # JAX driver's admission blocks the loop): each request either
            # ended with the fence's error frame or gave one engine's tokens
            errors = [r.error for r in wave1 if r.finish_reason == "error"]
            return {
                "wave1_fenced_are_r0s": len(errors) == fenced > 0,
                "wave1_errors": sorted(set(errors)),
                "wave1_others_plain": all(r.output_tokens == want for r, want in zip(wave1, plain)
                                          if r.finish_reason != "error"),
                "state": state, "driver_error": multi._by_id["r0"].driver_error,
                "restore": [(o["replayed"], o["manifest"]["watermark"]["seq"]) for o in calls],
                "restored_rows": len(restored_into.find_by_metadata("embeddings", {},
                                                                    limit=10)),
                "failover": [(e["reason"], e["justification"]["liveness"]["thread_alive"],
                              e["justification"]["ledger"]["window_s"] > 0,
                              e["justification"]["burn"]["state"]) for e in fo],
                "failopen": section["failopen"],
                "wave2": [(r.finish_reason, r.output_tokens == want)
                          for r, want in zip(wave2, plain)],
                "r2_routed": per["r2"]["routed"] >= 1,
                "actions": deltas(before, counters(pkg))["actions"],
            }
        finally:
            c.stop()
            await multi.stop()

    out = {name: await run(name, side) for name, side in sides.items()}
    got = same(out)
    assert got["wave1_fenced_are_r0s"] and got["wave1_others_plain"]
    assert got["wave1_errors"] == ["replica r0 fenced by fleet controller"]
    assert got["state"] == {"r0": ("drained", False), "r1": ("active", True),
                            "r2": ("active", True)}
    assert got["restore"] == [(0, 7)] and got["restored_rows"] == 1
    assert got["failover"] == [("dead", False, True, "ok")] and got["failopen"] == 0
    assert got["wave2"] == [("length", True)] * 4 and got["r2_routed"]
    assert got["actions"]["failover:dead"] == 1


async def test_a_replica_wedged_inside_its_step_is_fenced_alone(sides, monkeypatch):
    """Port only: the replicas of one device step under one lock, which
    JAX's fleet has not (ROADMAP queue 3 item 19).  r0 wedges inside its
    engine step, holding that lock, while r1 has work waiting on it.  r1's
    driver keeps stamping its heartbeat, so the controller fails over r0
    alone ("wedged"); the fence hands r1 and the spare r2 a fresh lock, so
    r1's request ends with one engine's tokens and r2 serves while r0 is
    still wedged."""
    side = sides["port"]
    set_env(monkeypatch, CTRL_HYSTERESIS_TICKS="2", CTRL_COOLDOWN_S="60",
            CTRL_LIVENESS_TIMEOUT_S="1.0", CTRL_MAX_ACTIONS="4", CTRL_ACTION_WINDOW_S="60",
            SLO_TTFT_P50_MS="600000", SLO_TTFT_P99_MS="600000", SLO_TPOT_MS="600000")
    geom = dict(max_num_seqs=4, page_size=8)
    sp = greedy(side, 8)
    ps = [[1 + i, 2 + i, 3 + i, 4 + i] for i in range(3)]
    plain = [r.output_tokens for r in side.engine(**geom).generate(ps, sp)]
    multi = side.multi.MultiAsyncEngine([side.engine(**geom) for _ in range(3)], spares=1,
                                        policy="round_robin")
    r0 = multi._by_id["r0"]
    wedged, release = threading.Event(), threading.Event()
    step = r0.engine.step

    def wedge():
        wedged.set()
        release.wait(timeout=60)
        return step()

    r0.engine.step = wedge
    c = t_controller.FleetController(multi)
    c.bind(asyncio.get_running_loop())
    try:
        on_r0 = asyncio.ensure_future(multi.generate(ps[0], sp))
        for _ in range(400):
            if wedged.is_set():
                break
            await asyncio.sleep(0.01)
        assert wedged.is_set()
        r0_driver = r0._thread
        on_r1 = asyncio.ensure_future(multi.generate(ps[1], sp))
        await asyncio.sleep(1.5)  # past the liveness timeout, r1 waiting on r0's lock
        assert not on_r1.done()
        ages = {r: d["liveness"]["heartbeat_age_s"]
                for r, d in c._sense(time.monotonic()).items()}
        got = acted(c.tick()) + acted(c.tick())
        assert [a[:3] for a in got] == [("r0", "failover", "wedged")], (got, ages)
        assert ages["r0"] > 1.0 and ages["r1"] < 1.0
        res0 = await asyncio.wait_for(on_r0, timeout=30)
        res1 = await asyncio.wait_for(on_r1, timeout=30)
        assert (res0.finish_reason, res0.error) == (
            "error", "replica r0 fenced by fleet controller")
        assert res1.output_tokens == plain[1]
        for _ in range(400):
            if multi._by_id["r2"].lifecycle == "active":
                break
            await asyncio.sleep(0.01)
        # round robin over r1 and r2; r0 still wedged
        wave = await asyncio.wait_for(asyncio.gather(
            multi.generate(ps[2], sp), multi.generate(ps[0], sp)), timeout=30)
        assert [r.output_tokens for r in wave] == [plain[2], plain[0]]
        assert multi.router_stats()["per_replica"]["r2"]["routed"] == 1
        assert r0_driver.is_alive()  # still wedged (retire waits on its join)
        release.set()
        out = await asyncio.wait_for(asyncio.wrap_future(c.inflight()["r0"]), timeout=60)
        assert out["spare"] == "r2" and out["failed_in_flight"] == 1
        assert {r: ae.lifecycle for r, ae in multi._by_id.items()} == {
            "r0": "drained", "r1": "active", "r2": "active"}
    finally:
        release.set()
        c.stop()
        await multi.stop()
