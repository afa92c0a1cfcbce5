"""Streaming ingest: the watermarked mutation log between producers and
the live device index; a copy of ``githubrepostorag_tpu/ingest/stream.py``
(the log file format is the same, so either package replays the other's).

An offline batch re-index writes straight into the store and queries see
whatever half-written state the batch left.  This module makes index
mutation a first-class *stream*: every add/update/delete becomes an
ordered :class:`MutationOp` with a monotonic sequence number appended to
a :class:`MutationLog`.  An apply loop
(:class:`~githubrepostorag_tpu_torch.retrieval.live_index.LiveIndexApplier`)
drains the log into the store while queries keep running, and the log's
**watermarks** — highest appended seq, per-table, plus the applier's
highest applied seq — define exactly which prefix of the stream any
query can observe (``/debug/index``).

Durability: with ``path`` set, every op is appended to a JSONL file
before its sequence number is published, so a restarted replica replays
``read_since(snapshot_watermark)`` instead of re-ingesting.  Vectors are
serialized as float lists (float32 -> repr -> float32 round-trips
bit-exactly), which keeps replayed scores identical to the original's.

:class:`StreamSink` is the producer adapter: it quacks like the two
store methods the ingest pipeline actually calls (``upsert`` /
``delete``), so an ingest pipeline streams through the log unchanged
(``ingest/vector_write.py`` through ``get_store()``).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from githubrepostorag_tpu_torch.store.base import Doc
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

UPSERT = "upsert"
DELETE = "delete"


@dataclass(frozen=True)
class MutationOp:
    """One ordered index mutation.  ``seq`` is assigned by the log and is
    strictly monotonic across tables — the stream has ONE total order, so
    "applied through seq N" is an unambiguous replica state."""

    seq: int
    kind: str                      # UPSERT | DELETE
    table: str
    doc_id: str
    text: str = ""
    metadata: Mapping[str, str] = field(default_factory=dict)
    vector: np.ndarray | None = None

    def to_doc(self) -> Doc:
        return Doc(self.doc_id, self.text, dict(self.metadata), self.vector)

    def to_json(self) -> dict:
        return {
            "seq": self.seq,
            "kind": self.kind,
            "table": self.table,
            "doc_id": self.doc_id,
            "text": self.text,
            "metadata": dict(self.metadata),
            "vector": None if self.vector is None
            else [float(x) for x in np.asarray(self.vector).reshape(-1)],
        }

    @classmethod
    def from_json(cls, rec: Mapping) -> "MutationOp":
        vec = rec.get("vector")
        return cls(
            seq=int(rec["seq"]),
            kind=str(rec["kind"]),
            table=str(rec["table"]),
            doc_id=str(rec["doc_id"]),
            text=str(rec.get("text", "")),
            metadata=dict(rec.get("metadata", {})),
            vector=None if vec is None else np.asarray(vec, dtype=np.float32),
        )


class MutationLog:
    """Ordered, watermarked, optionally durable mutation stream.

    Appends publish under one lock: seq assignment, the durable file
    write, and the in-memory tail extension are atomic, so a reader that
    observes watermark N can always ``read_since(M)`` every op in
    ``(M, N]``.  ``wait_for`` parks applier threads on a condition
    variable instead of polling.
    """

    def __init__(self, path: str | None = None) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._ops: list[MutationOp] = []
        self._min_seq = 0              # ops <= min_seq live only in the file
        self._seq = 0
        self._table_seq: dict[str, int] = {}
        self._path = path or None
        self._fh = None
        if self._path:
            self._load_existing()
            os.makedirs(os.path.dirname(os.path.abspath(self._path)),
                        exist_ok=True)
            self._fh = open(self._path, "a", encoding="utf-8")  # noqa: SIM115

    # ------------------------------------------------------------- durability

    def _load_existing(self) -> None:
        if not os.path.exists(self._path):
            return
        n = 0
        with open(self._path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                op = MutationOp.from_json(json.loads(line))
                self._ops.append(op)
                self._seq = max(self._seq, op.seq)
                self._table_seq[op.table] = max(
                    self._table_seq.get(op.table, 0), op.seq)
                n += 1
        if n:
            logger.info("mutation log %s: replayed %d ops, watermark %d",
                        self._path, n, self._seq)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # --------------------------------------------------------------- appends

    def _append(self, kind: str, table: str, doc_id: str, *, text: str = "",
                metadata: Mapping[str, str] | None = None,
                vector=None) -> MutationOp:
        self._seq += 1
        op = MutationOp(
            seq=self._seq, kind=kind, table=table, doc_id=doc_id, text=text,
            metadata=dict(metadata or {}),
            vector=None if vector is None
            else np.asarray(vector, dtype=np.float32).reshape(-1),
        )
        if self._fh is not None:
            self._fh.write(json.dumps(op.to_json()) + "\n")
            self._fh.flush()
        self._ops.append(op)
        self._table_seq[table] = op.seq
        return op

    def append_upsert(self, table: str, docs: Sequence[Doc]) -> int:
        """Append one upsert op per doc; returns the last assigned seq
        (the producer's watermark for this write)."""
        with self._lock:
            for d in docs:
                self._append(UPSERT, table, d.doc_id, text=d.text,
                             metadata=d.metadata, vector=d.vector)
            self._cond.notify_all()
            return self._seq

    def append_delete(self, table: str, doc_ids: Iterable[str]) -> int:
        with self._lock:
            for did in doc_ids:
                self._append(DELETE, table, did)
            self._cond.notify_all()
            return self._seq

    # ---------------------------------------------------------------- reads

    def watermark(self) -> dict:
        """Highest appended seq, globally and per table."""
        with self._lock:
            return {"seq": self._seq, "tables": dict(self._table_seq)}

    def __len__(self) -> int:
        with self._lock:
            return len(self._ops)

    def read_since(self, seq: int, limit: int | None = None) -> list[MutationOp]:
        """Ops with sequence number strictly greater than ``seq``, in
        order.  Ops trimmed from memory are re-read from the durable file
        (a restore replaying a suffix older than the retained tail)."""
        with self._lock:
            if seq < self._min_seq and self._path:
                return self._read_file_since(seq, limit)
            # the in-memory tail is seq-ordered; binary search the cut
            lo, hi = 0, len(self._ops)
            while lo < hi:
                mid = (lo + hi) // 2
                if self._ops[mid].seq <= seq:
                    lo = mid + 1
                else:
                    hi = mid
            out = self._ops[lo:]
            return list(out[:limit]) if limit is not None else list(out)

    def _read_file_since(self, seq: int, limit: int | None) -> list[MutationOp]:
        out: list[MutationOp] = []
        with open(self._path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                op = MutationOp.from_json(json.loads(line))
                if op.seq > seq:
                    out.append(op)
                    if limit is not None and len(out) >= limit:
                        break
        return out

    def wait_for(self, seq: int, timeout: float | None = None,
                 stop: threading.Event | None = None) -> bool:
        """Block until the appended watermark exceeds ``seq``; returns
        False on timeout.  The applier's park point; a set ``stop``
        event (after :meth:`poke`) releases the wait for shutdown."""
        with self._lock:
            return self._cond.wait_for(
                lambda: self._seq > seq or (stop is not None and stop.is_set()),
                timeout=timeout)

    def poke(self) -> None:
        """Wake every ``wait_for`` so it re-checks its predicate (used by
        applier shutdown; appends wake waiters on their own)."""
        with self._lock:
            self._cond.notify_all()

    def trim(self, upto_seq: int) -> int:
        """Drop ops <= ``upto_seq`` from memory (they stay in the durable
        file).  Memory-only logs refuse: the retained tail is their only
        replay source.  Returns the number of ops dropped."""
        with self._lock:
            if not self._path:
                return 0
            keep = [op for op in self._ops if op.seq > upto_seq]
            dropped = len(self._ops) - len(keep)
            if dropped:
                self._ops = keep
                self._min_seq = max(self._min_seq, upto_seq)
            return dropped


def apply_ops(store, ops: Sequence[MutationOp]) -> None:
    """Apply a seq-ordered op slice to a store, batching maximal runs of
    the same (kind, table) into one store call — the shared apply step
    of the live applier's drain loop and snapshot-restore's log-suffix
    replay.  Batched upserts ride the device index's coalesced dirty-row
    scatter exactly like a direct write would."""
    i = 0
    while i < len(ops):
        j = i
        while (j < len(ops) and ops[j].kind == ops[i].kind
               and ops[j].table == ops[i].table):
            j += 1
        run = ops[i:j]
        if run[0].kind == UPSERT:
            store.upsert(run[0].table, [op.to_doc() for op in run])
        else:
            store.delete(run[0].table, [op.doc_id for op in run])
        i = j


class StreamSink:
    """Producer-side store adapter: the two mutating store methods the
    ingest pipeline calls, rerouted into the log.  Pass as
    ``ingest_component(..., store=StreamSink(log))`` and a whole repo
    ingest becomes an ordered replayable stream instead of direct store
    writes; reads are not supported (producers don't read)."""

    def __init__(self, log: MutationLog) -> None:
        self.log = log

    def upsert(self, table: str, docs: Sequence[Doc]) -> int:
        self.log.append_upsert(table, docs)
        return len(docs)

    def delete(self, table: str, doc_ids: Iterable[str]) -> int:
        ids = list(doc_ids)
        self.log.append_delete(table, ids)
        return len(ids)

    def save(self) -> None:  # durable already: every append hit the file
        return None


def dir_fingerprint(root: str) -> tuple[int, int]:
    """(file count, max mtime_ns) over a local repo tree — the cheap
    change signal ``--watch`` polls.  Hidden dirs are skipped the same
    way LocalRepoReader skips them."""
    count, newest = 0, 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        for name in filenames:
            if name.startswith("."):
                continue
            try:
                st = os.stat(os.path.join(dirpath, name))
            except OSError:
                continue
            count += 1
            newest = max(newest, st.st_mtime_ns)
    return count, newest


def watch_local(root: str, on_change: Callable[[], None], *,
                interval_s: float = 2.0, max_polls: int | None = None,
                stop: threading.Event | None = None) -> int:
    """Poll a local directory and invoke ``on_change`` whenever its
    fingerprint moves — the ``python -m ...ingest --watch`` loop.  The
    first poll always fires (initial index).  Returns the number of
    change events fired; ``max_polls`` / ``stop`` bound the loop for
    tests and orderly shutdown."""
    stop = stop or threading.Event()
    last: tuple[int, int] | None = None
    fired = 0
    polls = 0
    while not stop.is_set():
        fp = dir_fingerprint(root)
        if fp != last:
            last = fp
            on_change()
            fired += 1
        polls += 1
        if max_polls is not None and polls >= max_polls:
            break
        if stop.wait(interval_s):
            break
    return fired
