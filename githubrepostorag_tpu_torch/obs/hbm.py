"""Page-pool observatory: the memory analogue of the token ledger; port
of ``githubrepostorag_tpu/obs/hbm.py``.

The serving allocators (serving/kv_cache.py) hand out *claims* on device
pages — every block-table listing is one refcount, one claim on pool
capacity.  The observatory integrates that claim count over time into a
pool-occupancy integral (page-seconds), and independently attributes the
same page-seconds to the requests that held them: the engine reports each
request's page hold at admission and its release at completion, so

    sum over requests of attributed page-seconds
        ~= integral of held claims dt

to within the microseconds between the allocator seam and the engine seam
firing.  Divergence between the two is a leak detector: a claim nobody
attributes is a page the scheduler lost track of.

Feeding is seam-cheap by construction — every hook is O(1) dict/float
work under one small lock, and prometheus publishing is rate-limited to
the ledger's flush cadence (obs/ledger.py _PUBLISH_S) so the observatory
stays a small share of a driver step.  Expensive renders
(free-run fragmentation histogram, lifetime percentiles) happen only in
``payload()``, i.e. when someone actually GETs /debug/hbm.

Federation mirrors the SLO plane: serving attaches an observatory per
replica and registers it with the process-wide ``_HBMPlane``; obs never
imports serving.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from githubrepostorag_tpu_torch import metrics

# registry-publish cadence, matching the token ledger's flush rationale
_PUBLISH_S = 0.25

# tier-migration event kinds the timeline renders on the kv thread track
EVENT_KINDS = ("fault_in", "writeback", "park", "host_evict", "import")


class PageObservatory:
    """Per-replica page-pool observatory.

    Thread-compat: the allocator/engine seams run on the driver thread
    (under the driver lock); ``payload``/``justification`` may be called
    from any thread — all state is guarded by one small lock.
    """

    def __init__(self, replica: str = "r0", *,
                 recent_requests: int = 128,
                 event_ring: int = 512,
                 lifetime_ring: int = 512) -> None:
        self.replica = replica
        self._lock = threading.Lock()
        # ---- pool-occupancy integral over allocator claims ----
        self._held = 0  # live refcount claims (block-table listings)
        self._held_peak = 0
        self._occ_integral = 0.0  # page-seconds, advanced on every event
        self._occ_t: float | None = None  # last integral advance
        self._alloc_events = 0
        self._alloc_pages = 0
        self._release_pages = 0
        # ---- per-request / per-priority attribution ----
        self._live: dict[str, dict] = {}  # rid -> {priority,pages,t0,t,acc}
        self._done: OrderedDict[str, dict] = OrderedDict()
        self._done_cap = max(1, int(recent_requests))
        self._done_page_s = 0.0  # sum of finalized attributions
        self._by_priority: dict[str, dict] = {}
        self._lifetimes: deque[float] = deque(maxlen=max(1, int(lifetime_ring)))
        # ---- tier-migration event ring (timeline source) ----
        self._events: deque[tuple[float, str, int]] = deque(
            maxlen=max(1, int(event_ring)))
        self._event_totals: dict[str, int] = {}
        # ---- pool snapshot provider (attached by serving) ----
        self._pool_view = None
        # ---- rate-limited prometheus flush ----
        self._m_held = metrics.HBM_HELD_PAGES.labels(replica=replica)
        self._m_page_s: dict[str, object] = {}
        self._pending_page_s: dict[str, float] = {}
        self._last_pub = 0.0
        self._created_t = time.monotonic()

    # ------------------------------------------------- allocator seams --

    def on_claims(self, delta: int, now: float | None = None) -> None:
        """Refcount claims changed by ``delta`` (allocate/share grow,
        release shrinks).  Advances the occupancy integral."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._advance_locked(now)
            self._held = max(0, self._held + delta)
            self._held_peak = max(self._held_peak, self._held)
            if delta > 0:
                self._alloc_events += 1
                self._alloc_pages += delta
            else:
                self._release_pages += -delta
            if now - self._last_pub >= _PUBLISH_S:
                self._flush_locked(now)

    def on_tier_event(self, kind: str, n: int = 1,
                      now: float | None = None) -> None:
        """A tier migration happened (fault-in, writeback, park, host
        eviction, disagg import) — ring-buffered for the timeline."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((now, kind, int(n)))
            self._event_totals[kind] = self._event_totals.get(kind, 0) + int(n)

    # ---------------------------------------------------- engine seams --

    def on_request_hold(self, rid: str, priority: str, pages: int,
                        now: float | None = None) -> None:
        """A request now holds ``pages`` block-table claims (admission, or
        a parked victim's resume re-admission under the same rid)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ent = self._live.get(rid)
            if ent is None:
                self._live[rid] = {"priority": priority, "pages": int(pages),
                                   "t0": now, "t": now, "acc": 0.0}
                return
            ent["acc"] += ent["pages"] * (now - ent["t"])
            ent["pages"] = int(pages)
            ent["t"] = now

    def on_request_release(self, rid: str, now: float | None = None) -> None:
        """The request's claims are gone (finished, reaped, cancelled, or
        preempt-parked) — finalize its page-second attribution."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ent = self._live.pop(rid, None)
            if ent is None:
                return
            acc = ent["acc"] + ent["pages"] * (now - ent["t"])
            held_s = now - ent["t0"]
            self._done_page_s += acc
            self._lifetimes.append(held_s)
            pri = ent["priority"]
            tot = self._by_priority.setdefault(
                pri, {"page_s": 0.0, "requests": 0})
            tot["page_s"] += acc
            tot["requests"] += 1
            prev = self._done.pop(rid, None)
            if prev is not None:  # park -> resume: merge the two holds
                acc += prev["page_s"]
                held_s += prev["held_s"]
            self._done[rid] = {"priority": pri,
                               "page_s": acc,
                               "pages_max": max(ent["pages"],
                                                prev["pages_max"] if prev else 0),
                               "held_s": held_s}
            while len(self._done) > self._done_cap:
                self._done.popitem(last=False)
            self._pending_page_s[pri] = (
                self._pending_page_s.get(pri, 0.0) + acc)
            if now - self._last_pub >= _PUBLISH_S:
                self._flush_locked(now)

    # ----------------------------------------------------------- views --

    def attach_pool_view(self, fn) -> None:
        """Serving attaches a zero-arg callable returning an advisory
        allocator snapshot dict (free page list, counters); the obs side
        never imports serving."""
        self._pool_view = fn

    def _advance_locked(self, now: float) -> None:
        if self._occ_t is not None and now > self._occ_t:
            self._occ_integral += self._held * (now - self._occ_t)
        self._occ_t = now

    def _flush_locked(self, now: float) -> None:
        self._m_held.set(self._held)
        for pri, v in self._pending_page_s.items():
            if v <= 0:
                continue
            m = self._m_page_s.get(pri)
            if m is None:
                m = metrics.HBM_PAGE_SECONDS.labels(
                    replica=self.replica, priority=pri)
                self._m_page_s[pri] = m
            m.inc(v)
        self._pending_page_s.clear()
        self._last_pub = now

    def occupancy_integral(self, now: float | None = None) -> float:
        """Pool-occupancy integral: page-seconds of held claims so far."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._advance_locked(now)
            return self._occ_integral

    def attributed_page_seconds(self, now: float | None = None) -> float:
        """Sum of per-request attributions (finished + live-to-now)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            live = sum(e["acc"] + e["pages"] * (now - e["t"])
                       for e in self._live.values())
            return self._done_page_s + live

    def events(self, t_min: float = 0.0) -> list[tuple[float, str, int]]:
        """Tier-migration events at or after ``t_min`` (timeline source)."""
        with self._lock:
            return [e for e in self._events if e[0] >= t_min]

    def justification(self, now: float | None = None) -> dict:
        """Compact pool view the fleet controller stamps onto actions (the
        page evidence behind an hbm_pages limiter attribution)."""
        now = time.monotonic() if now is None else now
        pool = self._pool_snapshot()
        with self._lock:
            self._advance_locked(now)
            return {
                "held_pages": self._held,
                "held_peak": self._held_peak,
                "occupancy_page_s": round(self._occ_integral, 6),
                "live_requests": len(self._live),
                "plain_free": pool.get("plain_free", -1),
                "host_pages": pool.get("host_pages", 0),
            }

    def _pool_snapshot(self) -> dict:
        view = self._pool_view
        if view is None:
            return {}
        try:
            return view() or {}
        except Exception:  # advisory snapshot: a racing teardown is fine
            return {}

    def payload(self, now: float | None = None) -> dict:
        """The per-replica body of ``GET /debug/hbm``."""
        now = time.monotonic() if now is None else now
        pool = self._pool_snapshot()
        frag = _free_run_histogram(pool.get("free_pages"))
        with self._lock:
            self._advance_locked(now)
            elapsed = max(1e-9, now - self._created_t)
            live = {
                rid: {"priority": e["priority"], "pages": e["pages"],
                      "page_s": round(
                          e["acc"] + e["pages"] * (now - e["t"]), 6),
                      "held_s": round(now - e["t0"], 6)}
                for rid, e in self._live.items()
            }
            attributed = self._done_page_s + sum(
                v["page_s"] for v in live.values())
            lifetimes = sorted(self._lifetimes)
            num_pages = pool.get("num_pages", 0)
            return {
                "replica": self.replica,
                "pool": {
                    "num_pages": num_pages,
                    "held_claims": self._held,
                    "held_peak": self._held_peak,
                    "free": pool.get("free", -1),
                    "plain_free": pool.get("plain_free", -1),
                    "cached_lru": pool.get("cached_lru", 0),
                    "host_pages": pool.get("host_pages", 0),
                    "occupancy_pct": round(
                        100.0 * self._held / num_pages, 3)
                        if num_pages else 0.0,
                },
                "fragmentation": frag,
                "counters": {k: pool.get(k, 0) for k in (
                    "fault_ins", "writebacks", "dedup_hits",
                    "host_evictions", "tier_drops", "page_imports",
                    "import_dedup_skips", "preempt_parked_pages",
                    "hit_tokens")},
                "churn": {
                    "alloc_events": self._alloc_events,
                    "alloc_pages": self._alloc_pages,
                    "released_pages": self._release_pages,
                    "alloc_pages_per_s": round(
                        self._alloc_pages / elapsed, 3),
                },
                "lifetime_s": {
                    "count": len(lifetimes),
                    "p50": round(_pct(lifetimes, 0.50), 6),
                    "p95": round(_pct(lifetimes, 0.95), 6),
                    "max": round(lifetimes[-1], 6) if lifetimes else 0.0,
                },
                "tier_events": dict(sorted(self._event_totals.items())),
                "attribution": {
                    "occupancy_integral_page_s": round(
                        self._occ_integral, 6),
                    "attributed_page_s": round(attributed, 6),
                    "live_requests": len(self._live),
                    "finished_requests": sum(
                        v["requests"]
                        for v in self._by_priority.values()),
                    "by_priority": {
                        pri: {"page_s": round(v["page_s"], 6),
                              "requests": v["requests"]}
                        for pri, v in sorted(self._by_priority.items())},
                    "live": live,
                    "recent": [
                        {"request_id": rid,
                         "priority": v["priority"],
                         "page_s": round(v["page_s"], 6),
                         "pages_max": v["pages_max"],
                         "held_s": round(v["held_s"], 6)}
                        for rid, v in reversed(self._done.items())
                    ][:16],
                },
            }


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def _free_run_histogram(free_pages) -> dict:
    """Contiguity of the free set: runs of consecutive page indices,
    bucketed by power-of-two run length.  A pool whose free pages are all
    singleton runs is maximally fragmented (pure bookkeeping signal here —
    pages are indirection slots, but run shape still tracks churn)."""
    if not free_pages:
        return {"runs": 0, "largest_run": 0, "histogram": {}}
    pages = sorted(set(int(p) for p in free_pages))
    runs: list[int] = []
    run = 1
    for prev, cur in zip(pages, pages[1:]):
        if cur == prev + 1:
            run += 1
        else:
            runs.append(run)
            run = 1
    runs.append(run)
    hist: dict[str, int] = {}
    for r in runs:
        bucket = 1
        while bucket * 2 <= r:
            bucket *= 2
        key = f"{bucket}+" if bucket >= 16 else str(bucket)
        hist[key] = hist.get(key, 0) + 1
    return {"runs": len(runs), "largest_run": max(runs),
            "histogram": dict(sorted(hist.items()))}


class _HBMPlane:
    """Process-wide replica -> observatory federation (same inversion as
    obs/slo.py's SLOPlane: serving registers, obs renders)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._replicas: dict[str, PageObservatory] = {}

    def register(self, replica: str, obs: PageObservatory) -> None:
        with self._lock:
            self._replicas[replica] = obs

    def unregister(self, replica: str) -> None:
        with self._lock:
            self._replicas.pop(replica, None)

    def get(self, replica: str) -> PageObservatory | None:
        with self._lock:
            return self._replicas.get(replica)

    def replicas(self) -> dict[str, PageObservatory]:
        with self._lock:
            return dict(self._replicas)

    def justification(self, replica: str,
                      now: float | None = None) -> dict | None:
        obs = self.get(replica)
        return obs.justification(now) if obs is not None else None

    def payload(self, now: float | None = None) -> dict:
        """The ``GET /debug/hbm`` body: per-replica observatories plus the
        pod-level attribution roll-up."""
        now = time.monotonic() if now is None else now
        per = {r: o.payload(now) for r, o in sorted(self.replicas().items())}
        return {
            "replica_count": len(per),
            "totals": {
                "occupancy_integral_page_s": round(sum(
                    p["attribution"]["occupancy_integral_page_s"]
                    for p in per.values()), 6),
                "attributed_page_s": round(sum(
                    p["attribution"]["attributed_page_s"]
                    for p in per.values()), 6),
                "held_claims": sum(
                    p["pool"]["held_claims"] for p in per.values()),
                "host_pages": sum(
                    p["pool"]["host_pages"] for p in per.values()),
            },
            "replicas": per,
        }


_plane: _HBMPlane | None = None
_plane_lock = threading.Lock()


def get_hbm_plane() -> _HBMPlane:
    global _plane
    if _plane is None:
        with _plane_lock:
            if _plane is None:
                _plane = _HBMPlane()
    return _plane


def reset_hbm_plane() -> _HBMPlane:
    """Replace the process-wide plane (tests)."""
    global _plane
    with _plane_lock:
        _plane = _HBMPlane()
    return _plane
