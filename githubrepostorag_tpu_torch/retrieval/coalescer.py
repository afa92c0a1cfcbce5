"""Retrieval micro-batcher: concurrent ``retrieve()`` calls coalesce into
waves that run as ONE encoder forward + ONE search dispatch; a copy of
``githubrepostorag_tpu/retrieval/coalescer.py``.

Every agent turn encodes a batch of ONE and searches once per query, so
a 16-session burst pays 16 encoder dispatches and 16 corpus scans for
work one wave covers.  ``RetrievalCoalescer`` is the retrieval
mirror of ``AsyncEngine``'s driver thread: callers (worker executor
threads running the agent loop) enqueue and block on an event; a lazy
daemon drain thread snapshots whatever is pending, groups it by encode
kind and table, and distributes the results.

An under-full snapshot holds a sub-millisecond formation window
(``wave_window_s``, default 500 us; 0 disables) before dispatching:
when a wave completes, its callers resubmit STAGGERED by thread wakeup,
and with zero window the first resubmitter ships as a wave of one while
the other fifteen land in the next snapshot (the solo wave still
streams the whole corpus).  The window is noise next to
a single retrieval's latency.

Single-caller behaviour matches the direct path (a wave of one, one
window), so the coalescer is on by default (``RETRIEVAL_COALESCE=0``
disables).
"""

from __future__ import annotations

import threading
import time
from typing import Mapping, Sequence

import numpy as np

from githubrepostorag_tpu_torch.metrics import RETRIEVAL_SECONDS, RETRIEVAL_WAVE_SIZE
from githubrepostorag_tpu_torch.obs.trace import current_context, record_span
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class _Request:
    __slots__ = ("table", "text", "kind", "k", "filter", "done", "qvec",
                 "hits", "error", "t_submit", "t_dispatch", "wave_size", "ctx")

    def __init__(self, table: str, text: str, kind: str, k: int,
                 filter: Mapping[str, str] | None) -> None:
        self.table = table
        self.text = text
        self.kind = kind
        self.k = k
        self.filter = filter
        self.done = threading.Event()
        self.qvec: np.ndarray | None = None
        self.hits = None
        self.error: BaseException | None = None
        self.t_submit = time.monotonic()
        # stamped by the drain thread when the wave ships; the caller's
        # trace context is captured at submit because the drain thread has
        # no scope of its own (it serves every caller's wave at once)
        self.t_dispatch: float | None = None
        self.wave_size = 0
        self.ctx = current_context()


class RetrievalCoalescer:
    def __init__(self, store, encoder, max_wave: int = 16,
                 wave_window_s: float = 0.0005) -> None:
        self.store = store
        self.encoder = encoder
        self.max_wave = max(1, max_wave)
        self.wave_window_s = max(0.0, wave_window_s)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._pending: list[_Request] = []
        self._thread: threading.Thread | None = None
        self._closed = False

    # ------------------------------------------------------------- public

    def search_text(self, table: str, text: str, k: int,
                    filter: Mapping[str, str] | None = None,
                    kind: str = "query"):
        """Encode ``text`` and search ``table`` -> (query_vector, hits)."""
        return self.search_many(table, [text], k, filter, kind=kind)[0]

    def search_many(self, table: str, texts: Sequence[str], k: int,
                    filter: Mapping[str, str] | None = None,
                    kind: str = "query"):
        """Enqueue a group of queries as one submission; other sessions'
        concurrent groups coalesce into the same wave.  Returns
        ``[(query_vector, hits), ...]`` in input order."""
        if not texts:
            return []
        reqs = [_Request(table, t, kind, k, filter) for t in texts]
        with self._lock:
            if self._closed:
                raise RuntimeError("RetrievalCoalescer is closed")
            self._ensure_thread()
            self._pending.extend(reqs)
        self._wake.set()
        out = []
        for r in reqs:
            r.done.wait()
            t_done = time.monotonic()
            RETRIEVAL_SECONDS.observe(t_done - r.t_submit)
            # wave-formation wait vs dispatch, attributed to the caller's
            # trace (no-ops when untraced)
            if r.ctx is not None and r.t_dispatch is not None:
                record_span("retrieval.wave_wait", r.t_submit, r.t_dispatch,
                            parent=r.ctx, attrs={"wave_size": r.wave_size})
                record_span("retrieval.dispatch", r.t_dispatch, t_done,
                            parent=r.ctx,
                            attrs={"wave_size": r.wave_size, "table": r.table})
            if r.error is not None:
                raise r.error
            out.append((r.qvec, r.hits))
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)  # drain exits once pending empties

    # ------------------------------------------------------------- drain

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._drive, name="retrieval-coalescer", daemon=True
            )
            self._thread.start()

    def _drive(self) -> None:
        while True:
            self._wake.wait()
            with self._lock:
                if self._closed and not self._pending:
                    return
                wave = self._pending[: self.max_wave]
                del self._pending[: len(wave)]
                if not self._pending:
                    self._wake.clear()
            if not wave:
                continue
            if len(wave) < self.max_wave and self.wave_window_s > 0:
                # formation window: let resubmitting callers join before
                # the dispatch ships (see module docstring)
                time.sleep(self.wave_window_s)
                with self._lock:
                    extra = self._pending[: self.max_wave - len(wave)]
                    del self._pending[: len(extra)]
                    if not self._pending:
                        self._wake.clear()
                wave.extend(extra)
            RETRIEVAL_WAVE_SIZE.observe(len(wave))
            t_dispatch = time.monotonic()
            for r in wave:
                r.t_dispatch = t_dispatch
                r.wave_size = len(wave)
            try:
                self._run_wave(wave)
            except BaseException as exc:  # noqa: BLE001 - fan the error out
                logger.warning("retrieval wave of %d failed: %s", len(wave), exc)
                for r in wave:
                    r.error = exc
            finally:
                for r in wave:
                    r.done.set()

    def _run_wave(self, wave: list[_Request]) -> None:
        # ONE encoder forward per kind present (a wave is almost always all
        # kind="query"; mixed kinds cost one forward each, never one per text)
        by_kind: dict[str, list[int]] = {}
        for i, r in enumerate(wave):
            by_kind.setdefault(r.kind, []).append(i)
        qvecs: list[np.ndarray | None] = [None] * len(wave)
        for kind, idxs in by_kind.items():
            vecs = self.encoder.encode([wave[i].text for i in idxs], kind=kind)
            for i, v in zip(idxs, vecs):
                qvecs[i] = v
        # ONE search dispatch per table in the wave
        by_table: dict[str, list[int]] = {}
        for i, r in enumerate(wave):
            by_table.setdefault(r.table, []).append(i)
        for table, idxs in by_table.items():
            qb = np.stack([qvecs[i] for i in idxs])
            k_max = max(wave[i].k for i in idxs)
            filters = [wave[i].filter for i in idxs]
            hit_lists = self.store.search_batch(table, qb, k_max, filters)
            for i, hits in zip(idxs, hit_lists):
                wave[i].qvec = qvecs[i]
                wave[i].hits = hits[: wave[i].k]
