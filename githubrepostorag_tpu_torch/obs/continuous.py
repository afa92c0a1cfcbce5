"""Always-on sampled step profiling; port of
``githubrepostorag_tpu/obs/continuous.py``.

Tracing answers "what happened to THIS request"; the ledger answers "what
is the rolling window doing"; neither can reconstruct the minutes before
an incident once the window rolled past it.  The continuous profiler
fills that gap: every Nth driver step (``PROFILE_SAMPLE_EVERY``) it
captures the full step anatomy (the token ledger's bucket classification),
queue depths, and a pool snapshot into a bounded ring
(``PROFILE_RING`` samples) — cheap enough to leave on in production
(non-sampled steps pay one int increment + modulo), deep enough that
``/debug/timeline`` can render counter tracks for the recent past with
tracing entirely off.

Federation follows the SLO-plane inversion: the serving driver creates a
profiler per replica and registers it in this module's registry; obs
never imports serving.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from githubrepostorag_tpu_torch import metrics

# step-anatomy keys copied out of the ledger's step record into a sample
_ANATOMY_KEYS = ("prefill", "decode", "spec_verify", "kv_migration",
                 "kv_transfer", "sched_stall", "compile", "committed",
                 "wall", "compiles")


class ContinuousProfiler:
    """Per-replica sampling ring.  ``on_step`` is called from one driver
    thread; ``samples``/``payload`` from any thread."""

    def __init__(self, replica: str = "r0", *,
                 sample_every: int | None = None,
                 ring: int | None = None) -> None:
        if sample_every is None or ring is None:
            from githubrepostorag_tpu_torch.config import get_settings

            s = get_settings()
            if sample_every is None:
                sample_every = s.profile_sample_every
            if ring is None:
                ring = s.profile_ring
        self.replica = replica
        self.sample_every = int(sample_every)
        self.ring = max(1, int(ring))
        self._seen = 0
        self._captured = 0
        self._lock = threading.Lock()
        self._samples: deque[dict] = deque(maxlen=self.ring)
        self._m_samples = metrics.PROFILE_SAMPLES.labels(replica=replica)

    def on_step(self, now: float, rec: dict | None,
                queue: tuple[int, int, int] = (0, 0, 0),
                pool: tuple[int, int] = (0, 0)) -> None:
        """Driver hot-loop hook: count the step; every Nth one, capture.
        ``rec`` is the ledger's last step record (may be None before the
        first classified step), ``queue`` is (running, waiting, parked),
        ``pool`` is (free_pages, host_pages)."""
        self._seen += 1
        if self.sample_every <= 0 or self._seen % self.sample_every:
            return
        sample = {"t": now, "seq": self._seen,
                  "running": queue[0], "waiting": queue[1],
                  "parked": queue[2],
                  "free_pages": pool[0], "host_pages": pool[1]}
        if rec:
            for k in _ANATOMY_KEYS:
                sample[k] = rec.get(k, 0.0)
        with self._lock:
            self._samples.append(sample)
            self._captured += 1
        self._m_samples.inc()

    def samples(self, t_min: float = 0.0) -> list[dict]:
        """Samples at or after ``t_min`` (timeline counter-track source)."""
        with self._lock:
            return [dict(s) for s in self._samples if s["t"] >= t_min]

    def payload(self) -> dict:
        with self._lock:
            samples = [dict(s) for s in self._samples]
        return {
            "replica": self.replica,
            "sample_every": self.sample_every,
            "ring": self.ring,
            "steps_seen": self._seen,
            "captured": self._captured,
            "retained": len(samples),
            "evicted": self._captured - len(samples),
            "samples": samples,
        }


_lock = threading.Lock()
_profilers: dict[str, ContinuousProfiler] = {}


def register_profiler(replica: str, profiler: ContinuousProfiler) -> None:
    with _lock:
        _profilers[replica] = profiler


def unregister_profiler(replica: str) -> None:
    with _lock:
        _profilers.pop(replica, None)


def profilers() -> dict[str, ContinuousProfiler]:
    with _lock:
        return dict(_profilers)


def reset_profilers() -> None:
    """Clear the registry (tests)."""
    with _lock:
        _profilers.clear()
