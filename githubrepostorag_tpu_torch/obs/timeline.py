"""Chrome-trace-event / Perfetto timeline exporter: one artifact per pod;
port of ``githubrepostorag_tpu/obs/timeline.py``.

``build_timeline`` merges, on demand and bounded by a time window,
everything the process already records into a single JSON trace that
opens directly in ui.perfetto.dev:

  * flight-recorder span trees (API -> worker -> agent -> engine), one
    host thread per trace so spans nest correctly;
  * per-step token-ledger anatomy per replica: one slice per driver step
    plus counter tracks for the prefill/decode/spec_verify/kv_migration/
    kv_transfer/sched_stall/compile buckets;
  * continuous-profiler samples (queue depths + pool occupancy counters)
    so the recent past renders even with tracing off;
  * KV tier-migration events from the page observatory (fault-in,
    writeback, park, host-evict, disagg import);
  * fleet router ``pick`` decisions, lifecycle verbs, and per-victim
    fenced-request instants (serving/multi_engine.py registers a
    provider through ``set_fleet_events_provider``; obs never imports
    serving);
  * controller actions with their full justification stamps;
  * FAULTS injections, attributed to the victim replica when the site
    names one.

Every source already records in ``time.monotonic()``; the exporter uses
that single timebase directly (microseconds) and stamps one wall-clock
anchor pair in the trace metadata for display alignment only.

Process layout: pid 1 = host request traces, pid 2 = fleet (router +
lifecycle + unattributed faults), pid 3 = controller, pid 10+i = replica
i (threads: 1 driver steps, 2 kv migrations, 3 fenced requests).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

from githubrepostorag_tpu_torch import metrics

_HOST_PID = 1
_FLEET_PID = 2
_CTRL_PID = 3
_REPLICA_PID0 = 10

# replica-process thread ids
_TID_DRIVER = 1
_TID_KV = 2
_TID_REQS = 3

# fleet-process thread ids
_TID_ROUTER = 1
_TID_LIFECYCLE = 2
_TID_FAULTS = 3

# ledger step-record keys rendered as per-replica counter tracks
_BUCKET_KEYS = ("prefill", "decode", "spec_verify", "kv_migration",
                "kv_transfer", "sched_stall", "compile")

# fleet-event provider registry (the fleet registers one; the
# same provider inversion as SLOPlane.set_router_info)
_provider_lock = threading.Lock()
_fleet_events_provider = None


def set_fleet_events_provider(provider) -> None:
    """Register a zero-arg callable returning the fleet's recent event
    dicts (each at least {"t": monotonic_seconds, "kind": str})."""
    global _fleet_events_provider
    with _provider_lock:
        _fleet_events_provider = provider


def reset_fleet_events_provider() -> None:
    global _fleet_events_provider
    with _provider_lock:
        _fleet_events_provider = None


def _fleet_events() -> list[dict]:
    with _provider_lock:
        provider = _fleet_events_provider
    if provider is None:
        return []
    try:
        return list(provider() or [])
    except Exception:  # noqa: BLE001 - debug export must render
        return []


def _us(t: float) -> int:
    return int(round(t * 1e6))


def _clip(value: Any, limit: int = 256) -> Any:
    if isinstance(value, str) and len(value) > limit:
        return value[:limit] + "..."
    return value


def build_timeline(window_s: float | None = None,
                   now: float | None = None,
                   max_events: int | None = None) -> dict:
    """Build the merged Perfetto trace dict (``{"traceEvents": [...]}``).

    ``window_s`` bounds how far back events are merged (default: the
    TIMELINE_WINDOW_S setting); an event is kept when its [start, end]
    intersects [now - window_s, now].  Events beyond ``max_events``
    (TIMELINE_MAX_EVENTS) are dropped oldest-first and counted in the
    trace metadata — never silently."""
    from githubrepostorag_tpu_torch.config import get_settings
    from githubrepostorag_tpu_torch.obs.continuous import profilers
    from githubrepostorag_tpu_torch.obs.hbm import get_hbm_plane
    from githubrepostorag_tpu_torch.obs.recorder import get_recorder
    from githubrepostorag_tpu_torch.obs.slo import get_slo_plane
    from githubrepostorag_tpu_torch.resilience.faults import get_registry

    s = get_settings()
    now = time.monotonic() if now is None else now
    if window_s is None:
        window_s = s.timeline_window_s
    if max_events is None:
        max_events = s.timeline_max_events
    t_min = now - max(0.0, float(window_s))

    plane = get_slo_plane()
    ledgers = plane.ledgers()
    profs = profilers()
    hbm = get_hbm_plane().replicas()
    replicas = sorted(set(ledgers) | set(profs) | set(hbm))
    rep_pid = {r: _REPLICA_PID0 + i for i, r in enumerate(replicas)}

    meta: list[dict] = []

    def _process(pid: int, name: str) -> None:
        meta.append({"ph": "M", "pid": pid, "name": "process_name",
                     "args": {"name": name}})
        meta.append({"ph": "M", "pid": pid, "name": "process_sort_index",
                     "args": {"sort_index": pid}})

    def _thread(pid: int, tid: int, name: str) -> None:
        meta.append({"ph": "M", "pid": pid, "tid": tid,
                     "name": "thread_name", "args": {"name": name}})

    _process(_HOST_PID, "host (request traces)")
    _process(_FLEET_PID, "fleet (router + lifecycle)")
    _thread(_FLEET_PID, _TID_ROUTER, "router picks")
    _thread(_FLEET_PID, _TID_LIFECYCLE, "lifecycle")
    _thread(_FLEET_PID, _TID_FAULTS, "fault injections")
    _process(_CTRL_PID, "controller")
    _thread(_CTRL_PID, 1, "actions")
    for r in replicas:
        _process(rep_pid[r], f"replica {r}")
        _thread(rep_pid[r], _TID_DRIVER, "driver steps")
        _thread(rep_pid[r], _TID_KV, "kv migrations")
        _thread(rep_pid[r], _TID_REQS, "fenced requests")

    events: list[dict] = []
    counts = {"spans": 0, "span_events": 0, "steps": 0, "samples": 0,
              "kv_events": 0, "controller_actions": 0, "fleet_events": 0,
              "fenced_requests": 0, "faults": 0}

    # ---- flight-recorder span trees: one host thread per trace ----
    traces = get_recorder().export_spans()
    for tid_idx, (trace_id, spans, wall_t) in enumerate(traces):
        tid = tid_idx + 1
        named = False
        for sp in spans:
            end = sp.end if sp.end is not None else now
            if end < t_min or sp.start > now:
                continue
            if not named:
                _thread(_HOST_PID, tid, f"trace {trace_id[:8]}")
                named = True
            args = {"trace_id": trace_id, "span_id": sp.span_id,
                    "parent_id": sp.parent_id, "status": sp.status}
            for k, v in sp.attrs.items():
                args[k] = _clip(v)
            if sp.end is None:
                args["live"] = True
            events.append({
                "ph": "X", "pid": _HOST_PID, "tid": tid, "cat": "span",
                "name": sp.name, "ts": _us(sp.start),
                "dur": max(1, _us(end) - _us(sp.start)), "args": args,
            })
            counts["spans"] += 1
            for ev in sp.events:
                if ev["t"] < t_min or ev["t"] > now:
                    continue
                ev_args = {k: _clip(v) for k, v in ev.items()
                           if k not in ("name", "t")}
                events.append({
                    "ph": "i", "pid": _HOST_PID, "tid": tid, "s": "t",
                    "cat": "span_event", "name": ev["name"],
                    "ts": _us(ev["t"]), "args": ev_args,
                })
                counts["span_events"] += 1

    # ---- per-replica step anatomy: slices + bucket counter tracks ----
    for r, ledger in sorted(ledgers.items()):
        pid = rep_pid[r]
        for t_end, rec in ledger.recent_steps(window_s, now):
            start = t_end - rec.get("wall", 0.0)
            dominant = max(_BUCKET_KEYS, key=lambda b: rec.get(b, 0.0))
            events.append({
                "ph": "X", "pid": pid, "tid": _TID_DRIVER, "cat": "step",
                "name": f"step:{dominant}", "ts": _us(start),
                "dur": max(1, _us(t_end) - _us(start)),
                "args": {k: round(v, 6) for k, v in rec.items()},
            })
            events.append({
                "ph": "C", "pid": pid, "ts": _us(t_end),
                "name": f"{r} step anatomy (ms)",
                "args": {b: round(rec.get(b, 0.0) * 1e3, 3)
                         for b in _BUCKET_KEYS},
            })
            counts["steps"] += 1

    # ---- continuous-profiler counter tracks ----
    for r, prof in sorted(profs.items()):
        pid = rep_pid[r]
        for sample in prof.samples(t_min):
            ts = _us(sample["t"])
            events.append({
                "ph": "C", "pid": pid, "ts": ts, "name": f"{r} queues",
                "args": {"running": sample.get("running", 0),
                         "waiting": sample.get("waiting", 0),
                         "parked": sample.get("parked", 0)},
            })
            events.append({
                "ph": "C", "pid": pid, "ts": ts, "name": f"{r} kv pages",
                "args": {"free": sample.get("free_pages", 0),
                         "host": sample.get("host_pages", 0)},
            })
            counts["samples"] += 1

    # ---- KV tier-migration instants ----
    for r, obs in sorted(hbm.items()):
        pid = rep_pid[r]
        for t, kind, n in obs.events(t_min):
            events.append({
                "ph": "i", "pid": pid, "tid": _TID_KV, "s": "t",
                "cat": "kv", "name": f"kv.{kind}", "ts": _us(t),
                "args": {"pages": n},
            })
            counts["kv_events"] += 1

    # ---- controller actions with justification stamps ----
    ctrl = plane.controller_payload()
    for entry in (ctrl or {}).get("log", []):
        t = entry.get("t")
        if not isinstance(t, (int, float)) or t < t_min or t > now:
            continue
        events.append({
            "ph": "X", "pid": _CTRL_PID, "tid": 1, "cat": "controller",
            "name": f"ctrl.{entry.get('action', '?')}", "ts": _us(t),
            "dur": 1000,  # display width; controller actions are instants
            "args": {"replica": entry.get("replica"),
                     "reason": entry.get("reason"),
                     "status": entry.get("status"),
                     "justification": entry.get("justification"),
                     "detail": entry.get("detail")},
        })
        counts["controller_actions"] += 1

    # ---- fleet events: router picks, lifecycle, fenced requests ----
    for ev in _fleet_events():
        t = ev.get("t")
        if not isinstance(t, (int, float)) or t < t_min or t > now:
            continue
        kind = str(ev.get("kind", "?"))
        args = {k: _clip(v) for k, v in ev.items() if k not in ("t", "kind")}
        tid = _TID_ROUTER if kind.startswith("router.") else _TID_LIFECYCLE
        events.append({
            "ph": "i", "pid": _FLEET_PID, "tid": tid, "s": "t",
            "cat": "fleet", "name": kind, "ts": _us(t), "args": args,
        })
        counts["fleet_events"] += 1
        if kind == "fleet.fence":
            victim_pid = rep_pid.get(str(ev.get("replica", "")))
            for rid in ev.get("failed_requests", []) or []:
                events.append({
                    "ph": "i",
                    "pid": victim_pid if victim_pid is not None else _FLEET_PID,
                    "tid": _TID_REQS, "s": "t", "cat": "fence",
                    "name": "request.fenced", "ts": _us(t),
                    "args": {"request_id": rid,
                             "replica": ev.get("replica")},
                })
                counts["fenced_requests"] += 1

    # ---- FAULTS injections, attributed to the victim when site names one
    for t, site, action in get_registry().events(t_min):
        if t > now:
            continue
        pid, tid = _FLEET_PID, _TID_FAULTS
        for r in replicas:
            if site.endswith(f".{r}"):
                pid, tid = rep_pid[r], _TID_DRIVER
                break
        events.append({
            "ph": "i", "pid": pid, "tid": tid, "s": "t", "cat": "fault",
            "name": f"fault.{action}", "ts": _us(t),
            "args": {"site": site},
        })
        counts["faults"] += 1

    events.sort(key=lambda e: e["ts"])
    dropped = 0
    if len(events) > max_events:
        dropped = len(events) - max_events
        events = events[dropped:]  # keep the most recent
        metrics.TIMELINE_EVENTS_DROPPED.inc(dropped)
    metrics.TIMELINE_EXPORTS.inc()

    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "metadata": {
            "window_s": float(window_s),
            "now_monotonic_s": round(now, 6),
            # wall anchor for display alignment only (never duration math)
            "anchor_wall_t": time.time(),
            "anchor_monotonic_s": time.monotonic(),
            "replicas": replicas,
            "sources": counts,
            "dropped_events": dropped,
        },
    }


def dump_timeline(path: str, window_s: float | None = None,
                  now: float | None = None) -> dict:
    """Build and write a timeline JSON artifact (a failed run's dump);
    returns the built trace."""
    trace = build_timeline(window_s=window_s, now=now)
    with open(path, "w") as f:
        json.dump(trace, f, default=str)
    return trace
