"""Token ledger: rolling goodput / MFU / bottleneck attribution per replica;
port of ``githubrepostorag_tpu/obs/ledger.py``.

The serving engine already keeps cumulative token-economics counters
(`committed_tokens`, `prefill_tokens`, `reaped_tokens`, per-phase step
seconds — serving/engine.py) and AsyncEngine's driver already stamps
monotonic step start/end times for the profiler (obs/engine_profile.py).
The ledger sits between them: each driver step it snapshots the engine's
cumulative counters, differences them against the previous snapshot, and
classifies the step's wall time into phase buckets:

    prefill | decode | spec_verify | kv_migration | kv_transfer |
    sched_stall | compile

`sched_stall` is the inter-step gap (host scheduling, lock contention),
less the wait for a peer replica's turn at the fleet's step lock;
`kv_transfer` is disaggregated-handoff pack/unpack time (the engine's
export/import gathers run under the driver lock between steps, so the
raw gap would misread as scheduler stall without the split);
`compile` is the step time left unaccounted for by the measured phases in
a step where the compile watchdog saw first-time work on the card (a
kernel build or load, a new launch plan, an unwarmed dispatch shape:
obs/engine_profile.py).  Token deltas are classified as committed (landed in a
request's output), spec_rejected (drafted but refused by the target model —
[vllm-pagedattention]'s wasted-token accounting), or deadline_reaped
(committed then discarded because the request blew its deadline).

Over a rolling window (SLO_LEDGER_WINDOW_S) the ledger derives:
  * goodput — committed tokens / elapsed (the BASELINE tok/s/chip number)
  * MFU     — (committed + prefill) tokens x flops/token
              over elapsed x peak chip FLOPs
  * limiter — windowed bottleneck attribution:
              compile > hbm_pages > swap_wait > kv_transfer > stall > none

On the card every bucket is HOST wall time: the engine's
``*_seconds_total`` are ``time.monotonic()`` around calls that enqueue
kernels and return (serving/engine.py), and the ledger adds no sync to
make them device time.  So `prefill` and `decode` / `spec_verify` are
the host's time issuing those dispatches (and any host read inside them:
the decode chain's token read, a spec step's token block read, which wait
for the device), `kv_migration` the host's time planning and issuing page
gathers / copies / scatters, and `sched_stall` the driver's time between
steps (inbox, hooks, stream events).  A bucket that grows with the card's
work is one that ends in a read; the device's own idle share comes from a
profile, not from here.

Everything is O(1) amortized per step (running sums maintained on
append/prune), because the driver calls `on_step` inside its hot loop and
the JAX package holds its obs planes to <= 2 % of a step.  Prometheus
publishing (counter incs + gauge sets, ~15 series) is the expensive part
of a step, so it is rate-limited: steps accumulate into plain dicts and
the registry is flushed at most every ``_PUBLISH_S`` (and on idle /
snapshot, so a scrape never reads a stale window edge).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from githubrepostorag_tpu_torch import metrics

BUCKETS = ("prefill", "decode", "spec_verify", "kv_migration",
           "kv_transfer", "sched_stall", "compile")
OUTCOMES = ("committed", "spec_rejected", "deadline_reaped")
LIMITERS = ("hbm_pages", "stall", "compile", "swap_wait", "kv_transfer",
            "none")

# max registry-publish cadence from the driver hot loop (same resolution
# rationale as obs/slo.py's _REFRESH_S)
_PUBLISH_S = 0.25

# cumulative engine attributes the ledger differences each step; a snapshot
# is just {field: float} so tests and the schema gate can feed dicts
SNAPSHOT_FIELDS = (
    "committed_tokens", "prefill_tokens", "reaped_tokens",
    "spec_proposed", "spec_accepted",
    "admission_blocked_steps",
    "prefill_seconds_total", "decode_seconds_total",
    "spec_verify_seconds_total",
    "migration_seconds_total", "fault_in_seconds_total",
    "transfer_seconds_total",
    "fused_steps_total", "step_dispatches_total",
)


def engine_snapshot(engine) -> dict[str, float]:
    """Cumulative counter snapshot off a serving Engine (caller holds the
    driver lock; plain attribute reads, no device sync)."""
    return {f: float(getattr(engine, f, 0) or 0) for f in SNAPSHOT_FIELDS}


def flops_per_token(cfg) -> float:
    """~2x active-parameter FLOPs per token for a dense Qwen2-family config
    (PaLM appendix-B style estimate; good to ~5% and only the MFU
    numerator, so systematic error cancels in A/B comparisons)."""
    h = cfg.hidden_size
    attn = h * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    attn += cfg.num_heads * cfg.head_dim * h  # output projection
    inter = getattr(cfg, "moe_intermediate_size", 0) or cfg.intermediate_size
    mlp = 3 * h * inter  # gate + up + down
    params = cfg.num_layers * (attn + mlp) + cfg.vocab_size * h
    return 2.0 * params


class TokenLedger:
    """Per-replica rolling token ledger.  Thread-compat: `on_step` is called
    from one driver thread; `snapshot()` may be called from any thread (the
    API handler) — state is guarded by a small lock."""

    def __init__(self, replica: str = "r0", *,
                 flops_per_tok: float = 0.0,
                 peak_flops: float = 0.0,
                 window_s: float = 60.0) -> None:
        self.replica = replica
        self.flops_per_tok = float(flops_per_tok)
        self.peak_flops = float(peak_flops)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._prev: dict[str, float] | None = None
        self._prev_end: float | None = None
        self._steps: deque[tuple[float, dict[str, float]]] = deque()
        # running sums over the window (updated on append/prune -> O(1))
        self._sums: dict[str, float] = {}
        # counter increments accumulated between rate-limited publishes
        self._pending: dict[str, float] = {}
        self._last_pub = 0.0
        self._m_step = {b: metrics.LEDGER_STEP_SECONDS.labels(
            replica=replica, bucket=b) for b in BUCKETS}
        self._m_tok = {o: metrics.LEDGER_TOKENS.labels(
            replica=replica, outcome=o) for o in OUTCOMES}
        self._m_goodput = metrics.LEDGER_GOODPUT.labels(replica=replica)
        self._m_mfu = metrics.LEDGER_MFU.labels(replica=replica)
        self._m_limiter = {lim: metrics.LEDGER_LIMITER.labels(
            replica=replica, limiter=lim) for lim in LIMITERS}
        self._m_fused = metrics.ENGINE_FUSED_STEPS.labels(replica=replica)
        self._m_dispatches = metrics.ENGINE_STEP_DISPATCHES.labels(
            replica=replica)
        # last classified step record (GIL-atomic reference swap): the
        # continuous profiler samples it without re-taking the lock
        self.last_rec: dict[str, float] | None = None

    # ------------------------------------------------------------ feeding --

    def on_step(self, snap: dict[str, float], step_start: float,
                step_end: float, compiles: int = 0, waited_s: float = 0.0) -> None:
        """Classify one engine step.  ``snap`` is the engine's cumulative
        counter snapshot AFTER the step (engine_snapshot).  ``waited_s`` of
        the gap before it went to a peer replica's turn at the fleet's step
        lock: neither this step's work nor a scheduler stall, so it is left
        out of both."""
        with self._lock:
            prev = self._prev or {f: 0.0 for f in SNAPSHOT_FIELDS}
            d = {f: snap.get(f, 0.0) - prev.get(f, 0.0) for f in SNAPSHOT_FIELDS}
            self._prev = dict(snap)
            wall = max(0.0, step_end - step_start)
            stall = 0.0
            if self._prev_end is not None:
                stall = max(0.0, step_start - self._prev_end - waited_s)
            self._prev_end = step_end

            # handoff export/import runs under the driver lock BETWEEN
            # steps, so its wall time arrives as inter-step gap: charge it
            # to kv_transfer and keep only the remainder as genuine stall
            xfer = max(0.0, d["transfer_seconds_total"])
            rec = {
                "prefill": max(0.0, d["prefill_seconds_total"]),
                "decode": max(0.0, d["decode_seconds_total"]),
                "spec_verify": max(0.0, d["spec_verify_seconds_total"]),
                "kv_migration": max(0.0, d["migration_seconds_total"]
                                    + d["fault_in_seconds_total"]),
                "kv_transfer": xfer,
                "sched_stall": max(0.0, stall - xfer),
                "compile": 0.0,
                "committed": max(0.0, d["committed_tokens"]),
                "prefill_tokens": max(0.0, d["prefill_tokens"]),
                "spec_rejected": max(0.0, d["spec_proposed"] - d["spec_accepted"]),
                "deadline_reaped": max(0.0, d["reaped_tokens"]),
                "blocked": 1.0 if d["admission_blocked_steps"] > 0 else 0.0,
                "compiles": float(compiles),
                "wall": wall,
                "steps": 1.0,
                # dispatch attribution: how many main-model programs this
                # step issued, and whether the fused single-dispatch
                # program served it (serving/fused_step.py)
                "fused_steps": max(0.0, d["fused_steps_total"]),
                "dispatches": max(0.0, d["step_dispatches_total"]),
            }
            if compiles > 0:
                # kv_transfer stays out of ``measured``: it is inter-step
                # time, never part of this step's wall
                measured = (rec["prefill"] + rec["decode"]
                            + rec["spec_verify"] + rec["kv_migration"])
                rec["compile"] = max(0.0, wall - measured)

            self._append(step_end, rec)
            self.last_rec = rec
            for k in BUCKETS + OUTCOMES + ("fused_steps",):
                if rec[k] > 0:
                    self._pending[k] = self._pending.get(k, 0.0) + rec[k]
            if step_end - self._last_pub >= _PUBLISH_S:
                self._flush_locked(step_end)

    def idle(self, now: float | None = None) -> None:
        """Prune + republish while the driver has no work (keeps the rolling
        goodput decaying toward zero instead of freezing at the last value)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prev_end = None  # idle gaps are not scheduler stalls
            self._prune(now)
            self._flush_locked(now)

    def _flush_locked(self, now: float) -> None:
        """Publish accumulated counter deltas + current gauges (the only
        part of a step that touches the prometheus registry)."""
        for b in BUCKETS:
            v = self._pending.pop(b, 0.0)
            if v > 0:
                self._m_step[b].inc(v)
        for o in OUTCOMES:
            v = self._pending.pop(o, 0.0)
            if v > 0:
                self._m_tok[o].inc(v)
        v = self._pending.pop("fused_steps", 0.0)
        if v > 0:
            self._m_fused.inc(v)
        self._publish_locked(now)
        self._last_pub = now

    def _append(self, t: float, rec: dict[str, float]) -> None:
        self._steps.append((t, rec))
        for k, v in rec.items():
            self._sums[k] = self._sums.get(k, 0.0) + v
        self._prune(t)

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._steps and self._steps[0][0] < cutoff:
            _, old = self._steps.popleft()
            for k, v in old.items():
                self._sums[k] -= v

    # ---------------------------------------------------------- deriving --

    def _elapsed(self, now: float) -> float:
        if not self._steps:
            return 0.0
        return max(1e-9, min(self.window_s, now - self._steps[0][0])) or 1e-9

    def _limiter_locked(self, now: float) -> str:
        s = self._sums
        steps = s.get("steps", 0.0)
        if not steps:
            return "none"
        busy = sum(s.get(b, 0.0) for b in
                   ("prefill", "decode", "spec_verify", "kv_migration",
                    "kv_transfer", "compile"))
        denom = max(1e-9, busy + s.get("sched_stall", 0.0))
        if s.get("compiles", 0.0) > 0 and s.get("compile", 0.0) / denom > 0.05:
            return "compile"
        if s.get("blocked", 0.0) / steps > 0.5:
            return "hbm_pages"
        if s.get("kv_migration", 0.0) / denom > 0.25:
            return "swap_wait"
        if s.get("kv_transfer", 0.0) / denom > 0.25:
            return "kv_transfer"
        if s.get("sched_stall", 0.0) / denom > 0.5:
            return "stall"
        return "none"

    def _publish_locked(self, now: float) -> None:
        elapsed = self._elapsed(now)
        goodput = self._sums.get("committed", 0.0) / elapsed if elapsed else 0.0
        mfu = 0.0
        if elapsed and self.flops_per_tok and self.peak_flops:
            work = (self._sums.get("committed", 0.0)
                    + self._sums.get("prefill_tokens", 0.0)) * self.flops_per_tok
            mfu = work / (elapsed * self.peak_flops)
        limiter = self._limiter_locked(now)
        self._m_goodput.set(goodput)
        self._m_mfu.set(mfu)
        steps = self._sums.get("steps", 0.0)
        self._m_dispatches.set(
            self._sums.get("dispatches", 0.0) / steps if steps else 0.0)
        for lim, g in self._m_limiter.items():
            g.set(1.0 if lim == limiter else 0.0)
        self._last = (goodput, mfu, limiter)

    def recent_steps(self, window_s: float | None = None,
                     now: float | None = None) -> list[tuple[float, dict]]:
        """Step records whose end time falls within the window — the
        timeline exporter's per-step anatomy source.  Each entry is
        (step_end_monotonic, record); a step's start is end - rec["wall"].
        Bounded by the ledger's own retention (window_s at most)."""
        now = time.monotonic() if now is None else now
        cutoff = now - (self.window_s if window_s is None else window_s)
        with self._lock:
            return [(t, dict(rec)) for t, rec in self._steps if t >= cutoff]

    def current_limiter(self, now: float | None = None) -> str:
        """Cheap limiter-only read for the fleet router's fallback
        weighting (no prune, no publish — a slightly stale attribution is
        fine at routing cadence)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._limiter_locked(now)

    def justification(self, now: float | None = None) -> dict:
        """Compact window view the fleet controller stamps onto every
        action it takes (the ledger evidence that justified remediation).
        Unlike ``snapshot`` this never publishes to the registry — the
        controller reads it every tick for every replica."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune(now)
            elapsed = self._elapsed(now)
            s = self._sums
            return {
                "window_s": self.window_s,
                "elapsed_s": round(elapsed, 6),
                "steps": int(s.get("steps", 0.0)),
                "goodput_tok_s": round(
                    s.get("committed", 0.0) / elapsed if elapsed else 0.0, 3),
                "committed_tokens": int(s.get("committed", 0.0)),
                "limiter": self._limiter_locked(now),
            }

    def snapshot(self, now: float | None = None) -> dict:
        """Rolling-window view for /debug/slo + /debug/fleet payloads."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune(now)
            self._flush_locked(now)  # a scrape reads current, not stale
            elapsed = self._elapsed(now)
            s = self._sums
            goodput = s.get("committed", 0.0) / elapsed if elapsed else 0.0
            mfu = 0.0
            if elapsed and self.flops_per_tok and self.peak_flops:
                work = (s.get("committed", 0.0)
                        + s.get("prefill_tokens", 0.0)) * self.flops_per_tok
                mfu = work / (elapsed * self.peak_flops)
            committed = s.get("committed", 0.0)
            wasted = s.get("spec_rejected", 0.0) + s.get("deadline_reaped", 0.0)
            return {
                "replica": self.replica,
                "window_s": self.window_s,
                "elapsed_s": round(elapsed, 6),
                "steps": int(s.get("steps", 0.0)),
                "goodput_tok_s": round(goodput, 3),
                "mfu": round(mfu, 6),
                "limiter": self._limiter_locked(now),
                "tokens": {
                    "committed": int(committed),
                    "prefill": int(s.get("prefill_tokens", 0.0)),
                    "spec_rejected": int(s.get("spec_rejected", 0.0)),
                    "deadline_reaped": int(s.get("deadline_reaped", 0.0)),
                    "wasted_fraction": round(
                        wasted / max(1.0, committed + wasted), 6),
                },
                "bucket_seconds": {b: round(s.get(b, 0.0), 6) for b in BUCKETS},
                "dispatch": {
                    "fused_steps": int(s.get("fused_steps", 0.0)),
                    "dispatches": int(s.get("dispatches", 0.0)),
                    "dispatches_per_step": round(
                        s.get("dispatches", 0.0) / s.get("steps", 1.0)
                        if s.get("steps", 0.0) else 0.0, 6),
                },
            }
