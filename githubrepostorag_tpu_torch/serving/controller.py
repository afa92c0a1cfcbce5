"""Self-healing fleet controller: the sense -> decide -> act SLO loop;
port of ``githubrepostorag_tpu/serving/controller.py``.

It connects the fleet's senses (the token ledger's goodput and limiter,
the SLO monitors' burn states, the page observatory) to its actuators
(fence, warm-spare activate, snapshot restore, the host KV pool's cap,
the spec-k ladder, the router's affinity slack).  A ``FleetController``
runs a reconciliation loop on its own daemon thread at ``CTRL_TICK_S``
cadence: each tick it reads the SLO plane's decision snapshot plus a
liveness probe per replica (driver-step heartbeat age, driver-thread
aliveness, breaker state) and walks a guarded action ladder:

    dead / wedged driver, breaker open,      -> failover: fence the victim
    or sustained critical burn                  (fail its in-flight work
                                                with the standard error
                                                frame so nothing hangs),
                                                restore the latest index
                                                snapshot into a warm
                                                spare, activate it, and
                                                force-retire the corpse
    limiter == hbm_pages                     -> grow the host KV pool cap,
                                                or shift the spec-k ladder
                                                down once the pool is
                                                capped (both warmed up:
                                                no new launch plan)
    limiter == swap_wait                     -> halve the router's affinity
                                                load-slack so prefix-hot
                                                tenants spread across
                                                replicas

Guards, in evaluation order per decision: an in-flight action on the
same replica suppresses new ones; a per-(replica, action) cooldown
absorbs oscillation after an action lands; hysteresis requires
``CTRL_HYSTERESIS_TICKS`` consecutive agreeing ticks before acting; and
a sliding max-actions-per-window budget bounds runaway remediation.

Every action is stamped with the ledger window and burn state that
justified it (``obs/ledger.TokenLedger.justification`` +
``obs/slo.SLOMonitor.burn_state``), appended to a ring the SLO plane
renders as the ``controller`` section of ``/debug/fleet``, and counted
as ``rag_ctrl_actions_total{action,reason}``.  The ``fleet.controller.act``
FAULTS seam runs before each action so chaos tests can drop/delay/error
any rung deterministically.

Fail-open contract: any controller-internal exception — in sensing,
deciding, or acting — is caught, counted (``rag_ctrl_failopen_total``),
logged to the ring, and the loop keeps observing.  The controller can
never take the fleet down; at worst it degrades to a spectator.

The clock is injectable: unit tests drive ``tick(now=...)`` with a
simulated clock and every guard (hysteresis, cooldown, budget,
liveness age) is evaluated against that same reading, so the whole
ladder is deterministic without sleeping.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import threading
import time
from collections import deque
from typing import Any, Callable

from githubrepostorag_tpu_torch import metrics
from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.obs.hbm import get_hbm_plane
from githubrepostorag_tpu_torch.obs.slo import get_slo_plane
from githubrepostorag_tpu_torch.resilience.faults import fire_sync
from githubrepostorag_tpu_torch.resilience.policy import get_breaker

logger = logging.getLogger(__name__)

# ladder rungs, highest severity first (decision order per replica)
ACTIONS = ("failover", "grow_host_pool", "spec_k_down", "spread_affinity")

_LOG_RING = 64


class FleetController:
    """Reconciliation loop over a ``MultiAsyncEngine`` fleet.

    ``clock`` defaults to ``time.monotonic``; tests inject a simulated
    one and call ``tick(now=...)`` directly.  ``restore`` is an optional
    zero-arg callable invoked (off the event loop) before a warm spare
    activates — normally ``retrieval.snapshot.restore_for_activation``
    closed over the spare's store; a restore failure downgrades to a
    cold activate rather than aborting the failover."""

    def __init__(self, multi, *,
                 clock: Callable[[], float] = time.monotonic,
                 tick_s: float | None = None,
                 restore: Callable[[], Any] | None = None) -> None:
        s = get_settings()
        self._multi = multi
        self._clock = clock
        self._restore = restore
        self.tick_s = s.ctrl_tick_s if tick_s is None else float(tick_s)
        self.hysteresis_ticks = max(1, s.ctrl_hysteresis_ticks)
        self.cooldown_s = s.ctrl_cooldown_s
        self.max_actions = max(1, s.ctrl_max_actions)
        self.action_window_s = s.ctrl_action_window_s
        self.liveness_timeout_s = s.ctrl_liveness_timeout_s
        self.host_pool_grow = max(1.0, s.ctrl_host_pool_grow)
        self.host_pool_max_pages = s.ctrl_host_pool_max_pages

        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._ticks = 0
        self._actions_total = 0
        self._failopen = 0
        self._suppressed = {"hysteresis": 0, "cooldown": 0, "budget": 0,
                            "inflight": 0}
        # (replica, action, reason) -> consecutive agreeing ticks
        self._pending: dict[tuple[str, str, str], int] = {}
        # (replica, action) -> clock reading the cooldown expires at
        self._cooldown_until: dict[tuple[str, str], float] = {}
        # clock readings of executed actions (sliding budget window)
        self._recent: deque[float] = deque()
        # replica -> in-flight failover future (async actions only)
        self._inflight: dict[str, concurrent.futures.Future] = {}
        self._log: deque[dict] = deque(maxlen=_LOG_RING)
        get_slo_plane().set_controller_info(self.payload)

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        """Capture the running loop (async actions dispatch onto it) and
        launch the reconcile daemon thread."""
        with self._lock:
            self._loop = asyncio.get_running_loop()
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._run, name="fleet-controller", daemon=True)
            self._thread.start()

    def bind(self, loop: asyncio.AbstractEventLoop) -> None:
        """Test hook: bind the dispatch loop without starting the thread
        (tests then drive ``tick(now=...)`` themselves)."""
        with self._lock:
            self._loop = loop

    def stop(self) -> None:
        self._stop_evt.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)

    def _run(self) -> None:
        while not self._stop_evt.wait(self.tick_s):
            self.tick()

    # ----------------------------------------------------------------- tick

    def tick(self, now: float | None = None) -> list[dict]:
        """One sense -> decide -> act cycle; returns the entries acted on
        (or dispatched).  Every internal exception fails open."""
        now = self._clock() if now is None else now
        with self._lock:
            self._ticks += 1
        try:
            sensed = self._sense(now)
            decided = self._decide(sensed, now)
        except Exception as exc:  # noqa: BLE001 - fail-open contract
            self._fail_open(now, "sense", exc)
            return []
        acted = []
        for entry in decided:
            try:
                if self._execute(entry, now):
                    acted.append(entry)
            except Exception as exc:  # noqa: BLE001 - fail-open contract
                self._fail_open(now, entry["action"], exc,
                                replica=entry["replica"])
        return acted

    def _fail_open(self, now: float, stage: str, exc: Exception, *,
                   replica: str = "") -> None:
        metrics.CTRL_FAILOPEN.inc()
        logger.error("fleet controller failing open at %s: %s", stage, exc)
        with self._lock:
            self._failopen += 1
            self._log.append({
                "t": round(now, 3), "replica": replica, "action": stage,
                "reason": "internal_error", "status": "failopen",
                "justification": None, "detail": {"error": str(exc)},
            })

    # ---------------------------------------------------------------- sense

    def _sense(self, now: float) -> dict[str, dict]:
        """Per-replica view: SLO plane decision snapshot (ledger window
        justification + burn state) merged with the liveness probe and
        lifecycle off the fleet itself."""
        snap = get_slo_plane().decision_snapshot(now=now)
        out: dict[str, dict] = {}
        for ae in self._multi.replicas():
            rid = ae.replica
            d = dict(snap.get(rid) or {"ledger": None, "burn": None})
            hb = ae.heartbeat
            started = hb is not None
            alive = ae.driver_alive()
            age = (now - hb) if started else None
            d["lifecycle"] = ae.lifecycle
            # page-pool evidence for hbm_pages attributions: held claims,
            # occupancy integral, host-tier depth (obs/hbm.py) — None when
            # no observatory is registered for this replica
            d["hbm"] = get_hbm_plane().justification(rid, now)
            d["liveness"] = {
                "started": started,
                "thread_alive": alive,
                "heartbeat_age_s": round(age, 3) if age is not None else None,
                "driver_error": ae.driver_error,
                "breaker": get_breaker(f"replica-{rid}").state,
            }
            out[rid] = d
        return out

    # --------------------------------------------------------------- decide

    def _decide(self, sensed: dict[str, dict], now: float) -> list[dict]:
        """Walk the ladder per active replica, apply the guards in order
        (inflight -> cooldown -> hysteresis -> budget), and return the
        entries cleared to execute.  Pure against ``sensed`` + ``now``:
        deterministic under a simulated clock."""
        desired: list[tuple[str, str, str, dict]] = []
        for rid, d in sensed.items():
            if d.get("lifecycle") != "active":
                continue
            live = d.get("liveness") or {}
            burn = d.get("burn") or {}
            ledger = d.get("ledger") or {}
            started = live.get("started")
            if started and not live.get("thread_alive"):
                desired.append((rid, "failover", "dead", d))
            elif (started and live.get("heartbeat_age_s") is not None
                    and live["heartbeat_age_s"] > self.liveness_timeout_s):
                desired.append((rid, "failover", "wedged", d))
            elif live.get("breaker") == "open":
                desired.append((rid, "failover", "breaker_open", d))
            elif burn.get("state") == "critical":
                desired.append((rid, "failover", "burn_critical", d))
            elif ledger.get("limiter") == "hbm_pages":
                action = ("grow_host_pool"
                          if self._can_grow_host_pool(rid)
                          else "spec_k_down")
                desired.append((rid, action, "hbm_pages", d))
            elif ledger.get("limiter") == "swap_wait":
                desired.append((rid, "spread_affinity", "swap_wait", d))

        cleared: list[dict] = []
        with self._lock:
            wanted_keys = set()
            for rid, action, reason, d in desired:
                key = (rid, action, reason)
                wanted_keys.add(key)
                fut = self._inflight.get(rid)
                if fut is not None and not fut.done():
                    self._suppress("inflight")
                    continue
                if self._cooldown_until.get((rid, action), 0.0) > now:
                    self._suppress("cooldown")
                    continue
                agreed = self._pending.get(key, 0) + 1
                self._pending[key] = agreed
                if agreed < self.hysteresis_ticks:
                    self._suppress("hysteresis")
                    continue
                while self._recent and self._recent[0] < now - self.action_window_s:
                    self._recent.popleft()
                if len(self._recent) >= self.max_actions:
                    self._suppress("budget")
                    continue
                self._pending.pop(key, None)
                self._recent.append(now)
                cleared.append({
                    "replica": rid, "action": action, "reason": reason,
                    "ticks_agreed": agreed,
                    "justification": {
                        "ledger": d.get("ledger"),
                        "burn": d.get("burn"),
                        "liveness": d.get("liveness"),
                        "hbm": d.get("hbm"),
                    },
                })
            # a decision that vanished this tick resets its hysteresis
            for key in list(self._pending):
                if key not in wanted_keys:
                    del self._pending[key]
        return cleared

    def _suppress(self, guard: str) -> None:
        self._suppressed[guard] += 1
        metrics.CTRL_SUPPRESSED.labels(guard=guard).inc()

    def _can_grow_host_pool(self, replica: str) -> bool:
        ae = self._multi._by_id.get(replica)
        alloc = getattr(getattr(ae, "engine", None), "_allocator", None)
        cur = getattr(alloc, "host_pool_pages", None)
        if cur is None:
            return False
        return cur < self._host_pool_cap(alloc)

    def _host_pool_cap(self, alloc) -> int:
        if self.host_pool_max_pages > 0:
            return self.host_pool_max_pages
        return 8 * int(getattr(alloc, "num_pages", 0) or 0)

    # ------------------------------------------------------------------ act

    def _execute(self, entry: dict, now: float) -> bool:
        """Run one cleared action.  The ``fleet.controller.act`` seam fires
        first: ``drop`` skips the action (logged), ``delay`` stalls the
        controller thread, ``error`` raises into the per-action fail-open."""
        rid, action, reason = entry["replica"], entry["action"], entry["reason"]
        if fire_sync("fleet.controller.act"):
            with self._lock:
                self._log.append({
                    "t": round(now, 3), "replica": rid, "action": action,
                    "reason": reason, "status": "dropped",
                    "justification": entry["justification"], "detail": {},
                })
            return False
        detail: dict[str, Any] = {}
        if action == "failover":
            detail = self._act_failover(rid, reason)
            status = "dispatched"
        elif action == "grow_host_pool":
            detail = self._act_grow_host_pool(rid)
            status = "ok"
        elif action == "spec_k_down":
            detail = self._act_spec_k_down(rid)
            status = "ok"
        elif action == "spread_affinity":
            detail = self._act_spread_affinity()
            status = "ok"
        else:  # pragma: no cover - ladder and executor enumerate ACTIONS
            raise RuntimeError(f"unknown action {action!r}")
        metrics.CTRL_ACTIONS.labels(action=action, reason=reason).inc()
        logger.warning("fleet controller: %s on %s (%s): %s",
                       action, rid, reason, detail)
        with self._lock:
            self._actions_total += 1
            self._cooldown_until[(rid, action)] = now + self.cooldown_s
            self._log.append({
                "t": round(now, 3), "replica": rid, "action": action,
                "reason": reason, "status": status,
                "justification": entry["justification"], "detail": detail,
            })
        return True

    def _act_failover(self, victim: str, reason: str) -> dict:
        """Fence the victim, bring a warm spare up from the latest index
        snapshot, retire the corpse.  The sequence is async fleet work, so
        it is dispatched onto the event loop as ONE coroutine; its future
        blocks further controller actions on the victim until it lands.
        With no spare the victim is still fenced and retired — a dead
        driver must never keep callers hanging."""
        spares = self._multi.spare_replicas()
        spare = spares[0] if spares else None

        async def failover() -> dict:
            out = {"victim": victim, "spare": spare, "restored": None}
            fenced = await self._multi.fence(victim)
            out["failed_in_flight"] = fenced.get("failed", 0)
            if spare is not None:
                if self._restore is not None:
                    try:
                        out["restored"] = await asyncio.get_running_loop(
                        ).run_in_executor(None, self._restore)
                    except Exception as exc:  # noqa: BLE001 - cold activate
                        metrics.CTRL_FAILOPEN.inc()
                        logger.error("spare restore failed (activating "
                                     "cold): %s", exc)
                        out["restored"] = {"error": str(exc)}
                await self._multi.activate(spare)
            await self._multi.retire(victim)
            return out

        fut = self._dispatch(failover())
        with self._lock:
            self._inflight[victim] = fut
        return {"victim": victim, "spare": spare,
                "no_spare": spare is None, "trigger": reason}

    def _dispatch(self, coro) -> concurrent.futures.Future:
        with self._lock:
            loop = self._loop
        if loop is not None:
            return asyncio.run_coroutine_threadsafe(coro, loop)
        # no loop bound: the controller thread owns no loop, run inline
        fut: concurrent.futures.Future = concurrent.futures.Future()
        try:
            fut.set_result(asyncio.run(coro))
        except Exception as exc:  # noqa: BLE001 - surfaced via the future
            fut.set_exception(exc)
        return fut

    def _act_grow_host_pool(self, replica: str) -> dict:
        """hbm_pages remediation, rung 1: raise the host KV pool cap so
        writebacks stop evicting (the cap is a host-side int the allocator
        enforces on writeback and import: no device memory moves)."""
        ae = self._multi._by_id[replica]
        if not ae._lock.acquire(timeout=1.0):
            raise RuntimeError(f"driver lock on {replica} busy; retry next tick")
        try:
            alloc = ae.engine._allocator
            cur = getattr(alloc, "host_pool_pages", None)
            if cur is None:
                return {"noop": "allocator has no host pool"}
            cap = self._host_pool_cap(alloc)
            new = min(cap, max(cur + 1, int(cur * self.host_pool_grow)))
            alloc.host_pool_pages = new
            return {"host_pool_pages": {"from": cur, "to": new, "cap": cap}}
        finally:
            ae._lock.release()

    def _act_spec_k_down(self, replica: str) -> dict:
        """hbm_pages remediation, rung 2: drop the top spec-k ladder rung
        so speculative bursts commit fewer pages per dispatch.  Warmup ran
        every remaining rung, so the shift plans nothing new."""
        ae = self._multi._by_id[replica]
        if not ae._lock.acquire(timeout=1.0):
            raise RuntimeError(f"driver lock on {replica} busy; retry next tick")
        try:
            engine = ae.engine
            ladder = getattr(engine, "_spec_k_ladder", None)
            if not ladder or len(ladder) <= 1:
                return {"noop": "spec-k ladder already at its floor"}
            removed = ladder.pop()
            engine.spec_k = ladder[-1]
            return {"spec_k": {"removed_rung": removed, "top": ladder[-1]}}
        finally:
            ae._lock.release()

    def _act_spread_affinity(self) -> dict:
        """swap_wait remediation: halve the router's affinity load-slack —
        prefix-hot tenants spill to other replicas sooner, spreading the
        migration pressure that swap_wait attributes."""
        cur = self._multi.affinity_slack
        new = self._multi.set_affinity_slack(cur * 0.5)
        return {"affinity_slack": {"from": cur, "to": new}}

    # -------------------------------------------------------------- reading

    def inflight(self) -> dict[str, concurrent.futures.Future]:
        """In-flight async action futures by victim replica (tests await
        these to observe failover completion)."""
        with self._lock:
            return dict(self._inflight)

    def payload(self) -> dict:
        """The ``controller`` section of ``/debug/fleet``: action-log
        ring, per-action cooldowns, hysteresis state, guard counters."""
        now = self._clock()
        with self._lock:
            cooldowns = {
                f"{rid}:{action}": round(until - now, 3)
                for (rid, action), until in self._cooldown_until.items()
                if until > now
            }
            return {
                "tick_s": self.tick_s,
                "ticks": self._ticks,
                "running": self._thread is not None,
                "actions_total": self._actions_total,
                "failopen": self._failopen,
                "suppressed": dict(self._suppressed),
                "budget": {
                    "max_actions": self.max_actions,
                    "window_s": self.action_window_s,
                    "used": sum(1 for t in self._recent
                                if t >= now - self.action_window_s),
                },
                "hysteresis": {
                    "required_ticks": self.hysteresis_ticks,
                    "pending": {
                        f"{rid}:{action}:{reason}": n
                        for (rid, action, reason), n in self._pending.items()
                    },
                },
                "cooldowns": cooldowns,
                "log": list(self._log),
            }
