"""SLO burn-rate monitor + fleet SLO plane; port of
``githubrepostorag_tpu/obs/slo.py``.

Objectives are defined per priority class over the request stream the
engine driver already observes (TTFT, TPOT, finish_reason): TTFT p50/p99,
TPOT, and deadline-miss rate.  Each finished request is a good/bad event
against each objective; over two rolling windows (SLO_WINDOWS, short+long)
the monitor computes the SRE burn rate

    burn = observed_miss_fraction / error_budget

and runs an ok -> warn -> critical state machine per (objective, class).  A
transition fires only when BOTH windows cross the threshold (canonical
multi-window multi-burn-rate alerting: the short window gives fast
trip/reset, the long window filters blips).  States and burns are exported
as gauges, transitions as counters, and the worst state across the fleet
maps to an admission hint (accept | throttle | shed) that
``resilience.admission`` exposes to the API's load-shedding check.

``SLOPlane`` is the per-process registry federating per-replica ledgers and
monitors; `/debug/slo` and `/debug/fleet` render its payloads.  The fleet
fills its router and controller seams: ``MultiAsyncEngine`` registers
``set_router_info``, ``FleetController`` ``set_controller_info``.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from githubrepostorag_tpu_torch import metrics
from githubrepostorag_tpu_torch.config import get_settings

OK, WARN, CRITICAL = 0, 1, 2
STATE_NAMES = {OK: "ok", WARN: "warn", CRITICAL: "critical"}
HINTS = {OK: "accept", WARN: "throttle", CRITICAL: "shed"}
DEFAULT_CLASS = "interactive"

# how often the state machine re-evaluates on the driver thread; transitions
# need no more resolution than the shortest practical window and the driver
# loop must stay cheap (the obs planes' share of a step)
_REFRESH_S = 0.25


def _windows() -> tuple[float, ...]:
    s = get_settings()
    try:
        ws = tuple(float(w) for w in str(s.slo_windows).split(",") if w.strip())
    except ValueError:
        ws = ()
    return ws or (60.0, 300.0)


def _objectives() -> list[dict]:
    """Objective table from settings: (name, threshold in seconds or None,
    error budget as a miss-fraction).  ``per_class`` overrides the
    threshold for classes whose latency physics differ — the ``longctx``
    class (whole-repo ring-prefill requests) legitimately takes seconds to
    first token, and judging it by interactive TTFT would keep the plane
    permanently critical.  Budgets and the burn-rate machine are shared:
    only the threshold moves."""
    s = get_settings()
    return [
        {"name": "ttft_p50", "threshold_s": s.slo_ttft_p50_ms / 1000.0, "budget": 0.50,
         "per_class": {"longctx": s.slo_longctx_ttft_p50_ms / 1000.0}},
        {"name": "ttft_p99", "threshold_s": s.slo_ttft_p99_ms / 1000.0, "budget": 0.01,
         "per_class": {"longctx": s.slo_longctx_ttft_p99_ms / 1000.0}},
        {"name": "tpot", "threshold_s": s.slo_tpot_ms / 1000.0, "budget": 0.05,
         "per_class": {"longctx": s.slo_longctx_tpot_ms / 1000.0}},
        {"name": "deadline_miss", "threshold_s": None,
         "budget": s.slo_deadline_miss_budget},
    ]


class SLOMonitor:
    """Per-replica burn-rate monitor.  ``observe`` runs on the driver
    thread; ``payload``/``worst_state`` may run on any thread."""

    def __init__(self, replica: str = "r0") -> None:
        self.replica = replica
        self.windows = _windows()
        self.objectives = _objectives()
        s = get_settings()
        self.burn_warn = s.slo_burn_warn
        self.burn_critical = s.slo_burn_critical
        self._lock = threading.Lock()
        # (objective, klass) -> deque[(t, bad)] pruned to the longest window
        self._events: dict[tuple[str, str], deque] = {}
        self._state: dict[tuple[str, str], int] = {}
        self._transitions: dict[tuple[str, str, str], int] = {}
        self._last_refresh = 0.0

    # ------------------------------------------------------------ feeding --

    def observe(self, klass: str = DEFAULT_CLASS, *,
                ttft_s: float | None = None,
                tpot_s: float | None = None,
                deadline_missed: bool = False,
                now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        klass = klass or DEFAULT_CLASS
        with self._lock:
            for obj in self.objectives:
                name = obj["name"]
                thr = obj.get("per_class", {}).get(klass, obj["threshold_s"])
                if name == "deadline_miss":
                    bad = deadline_missed
                elif name.startswith("ttft"):
                    if ttft_s is None:
                        continue
                    bad = ttft_s > thr
                else:  # tpot
                    if tpot_s is None:
                        continue
                    bad = tpot_s > thr
                q = self._events.setdefault((name, klass), deque())
                q.append((now, bool(bad)))
        # rate-limited, not forced: observe rides the driver hot loop and
        # a refresh walks every (objective, class) queue + burn gauges
        self.maybe_refresh(now)

    # ------------------------------------------------------ state machine --

    def _burn_locked(self, q: deque, window: float, budget: float,
                     now: float) -> float:
        cutoff = now - window
        total = bad = 0
        for t, b in reversed(q):
            if t < cutoff:
                break
            total += 1
            bad += b
        if not total or budget <= 0:
            return 0.0
        return (bad / total) / budget

    def maybe_refresh(self, now: float | None = None, force: bool = False) -> None:
        now = time.monotonic() if now is None else now
        if not force and now - self._last_refresh < _REFRESH_S:
            return
        self._last_refresh = now
        long_w = max(self.windows)
        with self._lock:
            budgets = {o["name"]: o["budget"] for o in self.objectives}
            for (name, klass), q in self._events.items():
                cutoff = now - long_w
                while q and q[0][0] < cutoff:
                    q.popleft()
                burns = [self._burn_locked(q, w, budgets[name], now)
                         for w in self.windows]
                for w, burn in zip(self.windows, burns):
                    metrics.SLO_BURN.labels(
                        replica=self.replica, objective=name, klass=klass,
                        window=f"{w:g}").set(burn)  # windows: a fixed 2-element setting, not per request
                if burns and all(b >= self.burn_critical for b in burns):
                    new = CRITICAL
                elif burns and all(b >= self.burn_warn for b in burns):
                    new = WARN
                else:
                    new = OK
                old = self._state.get((name, klass), OK)
                if new != old:
                    self._state[(name, klass)] = new
                    sname = STATE_NAMES[new]
                    key = (name, klass, sname)
                    self._transitions[key] = self._transitions.get(key, 0) + 1
                    metrics.SLO_TRANSITIONS.labels(
                        replica=self.replica, objective=name, klass=klass,
                        state=sname).inc()
                metrics.SLO_STATE.labels(
                    replica=self.replica, objective=name, klass=klass).set(new)

    # ----------------------------------------------------------- reading --

    def worst_state(self) -> int:
        with self._lock:
            return max(self._state.values(), default=OK)

    def class_states(self) -> dict[str, int]:
        """Worst state per priority class across objectives — the engine's
        preempt-to-host trigger reads this, not ``worst_state``, so a
        burning batch class cannot make the scheduler preempt on the
        protected class's behalf."""
        with self._lock:
            out: dict[str, int] = {}
            for (_name, klass), st in self._state.items():
                out[klass] = max(out.get(klass, OK), st)
            return out

    def burn_state(self, now: float | None = None) -> dict:
        """Compact burn view for the fleet controller's decision snapshot:
        worst state overall plus the worst state per class, refreshed at
        the caller's (possibly simulated) clock."""
        now = time.monotonic() if now is None else now
        self.maybe_refresh(now, force=True)
        with self._lock:
            worst = max(self._state.values(), default=OK)
            classes: dict[str, int] = {}
            for (_name, klass), st in self._state.items():
                classes[klass] = max(classes.get(klass, OK), st)
        return {
            "state": STATE_NAMES[worst],
            "classes": {k: STATE_NAMES[v] for k, v in sorted(classes.items())},
        }

    def transition_counts(self) -> dict[tuple[str, str, str], int]:
        with self._lock:
            return dict(self._transitions)

    def payload(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        self.maybe_refresh(now, force=True)
        with self._lock:
            budgets = {o["name"]: o["budget"] for o in self.objectives}
            rows = []
            for (name, klass) in sorted(self._events):
                q = self._events[(name, klass)]
                rows.append({
                    "objective": name,
                    "klass": klass,
                    "state": STATE_NAMES[self._state.get((name, klass), OK)],
                    "burn": [
                        {"window_s": w,
                         "rate": round(self._burn_locked(
                             q, w, budgets[name], now), 4)}
                        for w in self.windows
                    ],
                    "events": len(q),
                    "bad": sum(1 for _, b in q if b),
                })
            transitions = sum(self._transitions.values())
            return {
                "replica": self.replica,
                "state": STATE_NAMES[max(self._state.values(), default=OK)],
                "transitions": transitions,
                "objectives": rows,
            }


class SLOPlane:
    """Process-wide federation point: every AsyncEngine driver registers its
    (replica -> ledger, monitor, stats provider) here; the API renders the
    pod at a glance and the admission hint feeds load shedding."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._replicas: dict[str, dict] = {}
        self._router_info = None
        self._controller_info = None

    def register(self, replica: str, *, ledger=None, monitor=None,
                 stats=None, digest=None) -> None:
        with self._lock:
            self._replicas[replica] = {
                "ledger": ledger, "monitor": monitor, "stats": stats,
                "digest": digest,
            }

    def set_router_info(self, provider) -> None:
        """Router registers a zero-arg callable returning its decision
        counters / lifecycle map for the fleet payload (same inversion as
        the admission hint: obs never imports serving)."""
        with self._lock:
            self._router_info = provider

    def set_controller_info(self, provider) -> None:
        """Fleet controller registers a zero-arg callable returning its
        action log / cooldown / hysteresis view for the fleet payload
        (same inversion as the router info)."""
        with self._lock:
            self._controller_info = provider

    def unregister(self, replica: str) -> None:
        with self._lock:
            self._replicas.pop(replica, None)

    def decision_snapshot(self, now: float | None = None) -> dict[str, dict]:
        """Controller-consumable sense snapshot: per replica, the ledger's
        window justification and the monitor's burn state, all evaluated
        at ONE caller-supplied clock reading so a simulated-clock test is
        deterministic.  Never touches the prometheus registry beyond the
        monitor's gauge refresh."""
        now = time.monotonic() if now is None else now
        with self._lock:
            entries = sorted(self._replicas.items())
        out: dict[str, dict] = {}
        for rid, e in entries:
            led = e.get("ledger")
            mon = e.get("monitor")
            out[rid] = {
                "ledger": led.justification(now) if led is not None else None,
                "burn": mon.burn_state(now) if mon is not None else None,
            }
        return out

    def admission_hint(self) -> str:
        with self._lock:
            entries = list(self._replicas.values())
        worst = OK
        for e in entries:
            mon = e.get("monitor")
            if mon is not None:
                worst = max(worst, mon.worst_state())
        return HINTS[worst]

    def class_states(self) -> dict[str, int]:
        """Fleet-federated worst state per priority class."""
        with self._lock:
            entries = list(self._replicas.values())
        out: dict[str, int] = {}
        for e in entries:
            mon = e.get("monitor")
            if mon is None:
                continue
            for klass, st in mon.class_states().items():
                out[klass] = max(out.get(klass, OK), st)
        return out

    def decision_table(self) -> dict[str, str]:
        """Per-class admission decisions — the graceful-degradation ladder
        (admit -> throttle -> preempt -> shed).

        The protected class is accepted while preemption can still reclaim
        pages on its behalf: batch classes absorb the pressure (throttle at
        protected-warn, preempt at protected-critical, shed only on their
        OWN critical burn).  The protected class itself sheds only when it
        is critical AND no batch class remains to preempt — which is
        exactly the old worst-state behavior for a single-class fleet."""
        protected = get_settings().priority_protected_class
        states = self.class_states()
        states.setdefault(protected, OK)
        prot = states[protected]
        batch_absorbing = any(
            st < CRITICAL for k, st in states.items() if k != protected)
        table: dict[str, str] = {}
        for klass, own in states.items():
            if klass == protected:
                if prot >= CRITICAL and not batch_absorbing:
                    table[klass] = "shed"
                else:
                    table[klass] = "accept"
            elif own >= CRITICAL:
                table[klass] = "shed"
            elif prot >= CRITICAL:
                table[klass] = "preempt"
            elif prot >= WARN:
                table[klass] = "throttle"
            else:
                table[klass] = HINTS[own]
        return table

    def ledgers(self) -> dict[str, object]:
        """Registered token ledgers by replica — the timeline exporter's
        per-step anatomy source (obs-internal; serving never calls this)."""
        with self._lock:
            return {rid: e["ledger"] for rid, e in self._replicas.items()
                    if e.get("ledger") is not None}

    def controller_payload(self) -> dict | None:
        """Render the registered controller-info provider (None when no
        controller registered or the provider fails)."""
        with self._lock:
            controller_info = self._controller_info
        if not callable(controller_info):
            return None
        try:
            return controller_info() or None
        except Exception:  # noqa: BLE001 - debug payload must render
            return None

    def slo_payload(self) -> dict:
        s = get_settings()
        with self._lock:
            entries = sorted(self._replicas.items())
        return {
            "admission_hint": self.admission_hint(),
            "classes": {k: STATE_NAMES[v]
                        for k, v in sorted(self.class_states().items())},
            "decisions": self.decision_table(),
            "config": {
                "windows_s": list(_windows()),
                "burn_warn": s.slo_burn_warn,
                "burn_critical": s.slo_burn_critical,
                "ttft_p50_ms": s.slo_ttft_p50_ms,
                "ttft_p99_ms": s.slo_ttft_p99_ms,
                "tpot_ms": s.slo_tpot_ms,
                "longctx_ttft_p50_ms": s.slo_longctx_ttft_p50_ms,
                "longctx_ttft_p99_ms": s.slo_longctx_ttft_p99_ms,
                "longctx_tpot_ms": s.slo_longctx_tpot_ms,
                "deadline_miss_budget": s.slo_deadline_miss_budget,
                "protected_class": s.priority_protected_class,
                "preempt_headroom_pages": s.preempt_headroom_pages,
            },
            "replicas": [
                e["monitor"].payload()
                for _, e in entries if e.get("monitor") is not None
            ],
        }

    def fleet_payload(self) -> dict:
        with self._lock:
            entries = sorted(self._replicas.items())
            router_info = self._router_info
            controller_info = self._controller_info
        replicas = []
        goodput = 0.0
        committed = 0
        wasted = 0
        for rid, e in entries:
            led = e.get("ledger")
            mon = e.get("monitor")
            stats_fn = e.get("stats")
            snap = led.snapshot() if led is not None else None
            if snap is not None:
                goodput += snap["goodput_tok_s"]
                committed += snap["tokens"]["committed"]
                wasted += (snap["tokens"]["spec_rejected"]
                           + snap["tokens"]["deadline_reaped"])
            stats = {}
            if callable(stats_fn):
                try:
                    stats = stats_fn() or {}
                except Exception:  # noqa: BLE001 - debug payload must render
                    stats = {}
            dig = e.get("digest")
            replicas.append({
                "replica": rid,
                # serving role under disaggregation, hoisted out of stats
                # so fleet dashboards get it even when stats fail to render
                "role": stats.get("role", "fused"),
                "ledger": snap,
                "slo": mon.payload() if mon is not None else None,
                "stats": stats,
                "digest": dig.payload() if dig is not None else None,
            })
        router = None
        if callable(router_info):
            try:
                router = router_info() or None
            except Exception:  # noqa: BLE001 - debug payload must render
                router = None
        controller = None
        if callable(controller_info):
            try:
                controller = controller_info() or None
            except Exception:  # noqa: BLE001 - debug payload must render
                controller = None
        roles: dict[str, int] = {}
        for r in replicas:
            roles[r["role"]] = roles.get(r["role"], 0) + 1
        return {
            "admission_hint": self.admission_hint(),
            "fleet": {
                "replicas": len(replicas),
                "roles": roles,
                "goodput_tok_s": round(goodput, 3),
                "committed_tokens": committed,
                "wasted_tokens": wasted,
            },
            "router": router,
            "controller": controller,
            "replicas": replicas,
        }


_plane: SLOPlane | None = None
_plane_lock = threading.Lock()


def get_slo_plane() -> SLOPlane:
    global _plane
    with _plane_lock:
        if _plane is None:
            _plane = SLOPlane()
            # the plane is the process's hint authority; resilience keeps
            # only callables so it never imports obs (no cycle)
            from githubrepostorag_tpu_torch.resilience.admission import (
                set_hint_provider, set_table_provider)
            set_hint_provider(_plane.admission_hint)
            set_table_provider(_plane.decision_table)
        return _plane


def reset_slo_plane() -> None:
    """Test hook: drop the plane and its admission registrations."""
    global _plane
    with _plane_lock:
        _plane = None
    from githubrepostorag_tpu_torch.resilience.admission import (
        clear_hint_provider, clear_table_provider)
    clear_hint_provider()
    clear_table_provider()
