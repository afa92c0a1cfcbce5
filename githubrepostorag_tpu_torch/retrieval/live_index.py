"""Live index: the apply loop that drains the ingest mutation log into
the (device-indexed) store while queries run, plus the background
compactor's trigger logic and the ``/debug/index`` payload; port of
``githubrepostorag_tpu/retrieval/live_index.py``.

The contract mirrors continuous batching on the serving side: mutation
application interleaves with query traffic instead of blocking it.  The
store's own lock serializes each apply run against in-flight searches,
so every query observes some exact *prefix* of the mutation stream —
the applied watermark published here is the lower bound of that prefix
("applied through at least seq N").  All device work rides shapes
``DeviceIndexedStore.warmup()`` already dispatched (the dirty-row
scatter ladder and the compaction repack gather), so sustained mutation
traffic adds no new shape on the card.

Compaction policy: after each apply batch (and on an idle tick every
``compact_interval_s``), any table whose tombstoned-hole count crosses
``compact_min_holes`` or whose hole fraction crosses
``compact_max_hole_fraction`` is repacked in place via
``DeviceIndexedStore.compact()`` — holes return to ~0 under
delete-heavy churn without a single whole-table ``full_sync`` re-put.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Mapping, Sequence

import numpy as np

from githubrepostorag_tpu_torch.ingest.stream import MutationLog, apply_ops
from githubrepostorag_tpu_torch.metrics import (
    INDEX_APPLY_LAG,
    INDEX_OPS_APPLIED,
    INDEX_WATERMARK,
)
from githubrepostorag_tpu_torch.store.base import Doc, SearchHit, VectorStore
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the aggregate (all-tables) series' scope label on the watermark gauges
TOTAL_SCOPE = "_total"


class LiveIndexApplier:
    """Daemon thread draining a :class:`MutationLog` into a store.

    ``start_seq`` skips ops at or below a snapshot's watermark, so a
    restored replica replays only the log suffix.  Without ``start()``
    the applier also works synchronously (``drain()``), which tests and
    the snapshot-restore path use."""

    def __init__(
        self,
        log: MutationLog,
        store: VectorStore,
        *,
        apply_batch: int = 64,
        start_seq: int = 0,
        compact_interval_s: float = 5.0,
        compact_min_holes: int = 64,
        compact_max_hole_fraction: float = 0.25,
    ) -> None:
        self.log = log
        self.store = store
        self.apply_batch = max(1, apply_batch)
        self.compact_interval_s = compact_interval_s
        self.compact_min_holes = max(1, compact_min_holes)
        self.compact_max_hole_fraction = compact_max_hole_fraction
        self._lock = threading.Lock()
        self._applied = int(start_seq)
        self._table_applied: dict[str, int] = {}
        self._ops_applied = 0
        self._compact_runs = 0
        self._reclaimed_rows = 0
        self._publish_s = 0.0   # host seconds spent on gauge publishing
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "LiveIndexApplier":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="live-index-apply", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self.log.poke()  # release the park point immediately
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.apply_once() == 0:
                woke = self.log.wait_for(self.applied_seq(),
                                         timeout=self.compact_interval_s,
                                         stop=self._stop)
                if not woke:
                    self.compact_if_needed()  # idle tick: scan all tables

    # ---------------------------------------------------------------- apply

    def applied_seq(self) -> int:
        with self._lock:
            return self._applied

    def apply_once(self) -> int:
        """Drain up to ``apply_batch`` ops; returns how many applied."""
        ops = self.log.read_since(self.applied_seq(), limit=self.apply_batch)
        if not ops:
            return 0
        apply_ops(self.store, ops)
        with self._lock:
            self._applied = ops[-1].seq
            for op in ops:
                self._table_applied[op.table] = op.seq
            self._ops_applied += len(ops)
        self._publish(ops)
        self.compact_if_needed(tables={op.table for op in ops})
        return len(ops)

    def drain(self, timeout: float = 30.0) -> int:
        """Apply synchronously until the log is caught up (no thread
        needed); returns total ops applied."""
        deadline = time.monotonic() + timeout
        total = 0
        while time.monotonic() < deadline:
            n = self.apply_once()
            total += n
            if n == 0 and self.log.watermark()["seq"] <= self.applied_seq():
                return total
        return total

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every op appended so far has been applied.  With a
        running thread this just waits; without one it drains inline."""
        target = self.log.watermark()["seq"]
        if self._thread is None or not self._thread.is_alive():
            self.drain(timeout)
            return self.applied_seq() >= target
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.applied_seq() >= target:
                return True
            time.sleep(0.002)
        return False

    def _publish(self, ops) -> None:
        t0 = time.monotonic()
        appended = self.log.watermark()
        with self._lock:
            applied, per_table = self._applied, dict(self._table_applied)
        INDEX_WATERMARK.labels(scope=TOTAL_SCOPE, kind="appended").set(
            appended["seq"])
        INDEX_WATERMARK.labels(scope=TOTAL_SCOPE, kind="applied").set(applied)
        INDEX_APPLY_LAG.labels(scope=TOTAL_SCOPE).set(
            max(0, appended["seq"] - applied))
        for table in {op.table for op in ops}:
            a = appended["tables"].get(table, 0)
            p = per_table.get(table, 0)
            INDEX_WATERMARK.labels(scope=table, kind="appended").set(a)
            INDEX_WATERMARK.labels(scope=table, kind="applied").set(p)
            INDEX_APPLY_LAG.labels(scope=table).set(max(0, a - p))
        counts: dict[tuple[str, str], int] = {}
        for op in ops:
            key = (op.table, op.kind)
            counts[key] = counts.get(key, 0) + 1
        for (table, kind), n in counts.items():
            INDEX_OPS_APPLIED.labels(table=table, kind=kind).inc(n)
        with self._lock:
            self._publish_s += time.monotonic() - t0

    def publish_seconds(self) -> float:
        """Cumulative host time spent publishing stream gauges."""
        with self._lock:
            return self._publish_s

    # ----------------------------------------------------------- compaction

    def compact_if_needed(self, tables: Iterable[str] | None = None) -> int:
        """Run the hole-reclaim triggers; returns rows reclaimed.  A
        store without ``compact()`` (plain host store) is a no-op."""
        compact = getattr(self.store, "compact", None)
        if compact is None:
            return 0
        dev = self.store.health().get("device_index", {})
        names = set(tables) if tables is not None else set(dev)
        reclaimed = 0
        for name in names:
            info = dev.get(name)
            if not info:
                continue
            holes = info.get("holes", 0)
            cap = max(1, info.get("capacity", 1))
            if holes <= 0:
                continue
            if (holes >= self.compact_min_holes
                    or holes / cap >= self.compact_max_hole_fraction):
                for report in compact(name):
                    reclaimed += report["reclaimed"]
        if reclaimed:
            with self._lock:
                self._compact_runs += 1
                self._reclaimed_rows += reclaimed
        return reclaimed

    # -------------------------------------------------------------- payload

    def payload(self) -> dict:
        """The ``/debug/index`` JSON body."""
        appended = self.log.watermark()
        with self._lock:
            applied = self._applied
            per_table = dict(self._table_applied)
            ops_applied = self._ops_applied
            compact_runs = self._compact_runs
            reclaimed = self._reclaimed_rows
        scopes = {}
        for table in sorted(set(appended["tables"]) | set(per_table)):
            a = appended["tables"].get(table, 0)
            p = per_table.get(table, 0)
            scopes[table] = {"appended": a, "applied": p,
                             "lag": max(0, a - p)}
        health = self.store.health() if hasattr(self.store, "health") else {}
        return {
            "enabled": True,
            "watermark": {
                "appended": appended["seq"],
                "applied": applied,
                "scopes": scopes,
            },
            "lag_ops": max(0, appended["seq"] - applied),
            "ops_applied": ops_applied,
            "tables": health.get("device_index", {}),
            "compaction": {
                "runs": compact_runs,
                "reclaimed_rows": reclaimed,
                "interval_s": self.compact_interval_s,
                "min_holes": self.compact_min_holes,
                "max_hole_fraction": self.compact_max_hole_fraction,
            },
        }


class LiveIndexedStore(VectorStore):
    """The LIVE_INDEX=on store front: writes append to the mutation log
    (returning immediately with the producer's watermark recorded), the
    applier drains them into the wrapped store in the background, reads
    serve from the wrapped store's applied state.  Readers therefore see
    a consistent, watermark-bounded view that trails producers by the
    published lag instead of blocking on them."""

    def __init__(self, store: VectorStore, log: MutationLog,
                 applier: LiveIndexApplier) -> None:
        self.store = store
        self.log = log
        self.applier = applier

    # writes -> the log (async apply)
    def upsert(self, table: str, docs: Sequence[Doc]) -> int:
        self.log.append_upsert(table, docs)
        return len(docs)

    def delete(self, table: str, doc_ids: Iterable[str]) -> int:
        ids = list(doc_ids)
        self.log.append_delete(table, ids)
        return len(ids)

    # reads -> the applied store state
    def search(self, table: str, query_vector: np.ndarray, k: int,
               filter: Mapping[str, str] | None = None) -> list[SearchHit]:
        return self.store.search(table, query_vector, k, filter=filter)

    def search_batch(self, table: str, query_vectors, k: int,
                     filters=None) -> list[list[SearchHit]]:
        return self.store.search_batch(table, query_vectors, k, filters)

    def find_by_metadata(self, table: str, filter: Mapping[str, str],
                         limit: int = 100) -> list[Doc]:
        return self.store.find_by_metadata(table, filter, limit)

    def find_by_metadata_batch(self, table: str, filters, limit: int = 100):
        return self.store.find_by_metadata_batch(table, filters, limit)

    def get(self, table: str, doc_id: str) -> Doc | None:
        return self.store.get(table, doc_id)

    def count(self, table: str) -> int:
        return self.store.count(table)

    def tables(self) -> list[str]:
        return self.store.tables()

    def health(self) -> dict:
        h = self.store.health()
        h["live_index"] = self.applier.payload()
        return h

    def save(self) -> None:
        # drain first so the persisted store reflects every append
        self.applier.flush()
        self.store.save()


# ------------------------------------------------------------------ registry

_live_applier: LiveIndexApplier | None = None
_registry_lock = threading.Lock()


def register_live_applier(applier: LiveIndexApplier | None) -> None:
    """Install (or clear, with None) the process-wide applier the
    ``/debug/index`` handlers render."""
    global _live_applier
    with _registry_lock:
        _live_applier = applier


def get_live_applier() -> LiveIndexApplier | None:
    with _registry_lock:
        return _live_applier


def live_index_payload() -> dict:
    """What ``/debug/index`` returns: the registered applier's payload,
    or an explicit disabled marker when no live index runs here."""
    applier = get_live_applier()
    if applier is None:
        return {"enabled": False}
    return applier.payload()
