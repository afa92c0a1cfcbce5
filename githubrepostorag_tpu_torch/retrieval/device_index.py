"""Device-resident top-k retrieval index on one card; port of
``githubrepostorag_tpu/retrieval/device_index.py``.

The corpus matrix lives on the card in float32, padded to capacity
buckets and stored transposed ``[dim, capacity]`` (row r of the corpus is
column r), so a whole query wave's search is one matmul -> mask -> top-k
on the card instead of a per-query host scan over the corpus.

``DeviceIndexedStore`` wraps any :class:`VectorStore`: every mutation is
delegated to the inner store (which stays the durable source of truth)
and mirrored into the device matrix; ``search``/``search_batch`` run on
the card with exact-parity semantics: the same top-k ids in the same tie
order (score descending, then insertion row ascending), metadata filters
applied as a mask built from an inverted ``(key, value) -> rows`` index
that honours the same SHREDDED_KEYS union as :func:`store.base._match`.

The search's matmul runs in IEEE float32 on the card whatever
``allow_tf32`` says (``device.ieee_float32``): TF32 would move scores by
~1e-3 against the host store's.

Tie order is explicit, not the sort's luck: ``_top_k`` ranks by one int64
key per element, the score's order-preserving bits above the complement
of its row, so no two elements tie and the largest k keys are the k best
in the contract's order (``torch.topk`` on the card promises nothing for
ties; JAX's ``lax.top_k`` gives them to the lower index).

No index sent to the card is out of range.  The JAX scatter pads its
bucket with the index ``capacity`` and drops it (``mode="drop"``); here
the padding repeats the last real (column, value) pair, the same write
twice.  The JAX repack fills from source ``capacity`` with zeros
(``mode="fill"``); here those columns gather column 0 and a keep mask
zeroes them.  (On the card an out-of-range index is a device-side assert
that ends the process's CUDA context.)

Shape discipline follows the JAX module's warmup contract: query counts
pad to power-of-two buckets, the corpus to a capacity bucket, k is fixed
at ``k_bucket``, scatters pad to the bucket ladder.  The program-cache
counts of the JAX module become the number of distinct shapes dispatched
so far (``search_program_cache_size``, ``mutation_program_cache_size``):
``warmup()`` dispatches the JAX package's exact set, and live traffic
adds none.  Requests outside the contract (k > k_bucket) go to the inner
store and are counted under ``rag_device_index_searches_total
{path="fallback"}``.  The JAX module's dp-sharded search over a mesh is
not ported (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import threading
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from githubrepostorag_tpu_torch.device import explicit_device, ieee_float32
from githubrepostorag_tpu_torch.metrics import (
    DEVICE_INDEX_SEARCHES,
    INDEX_CAPACITY,
    INDEX_COMPACTIONS,
    INDEX_FULL_SYNCS,
    INDEX_HOLES,
    INDEX_LIVE_ROWS,
)
from githubrepostorag_tpu_torch.store.base import (
    SHREDDED_KEYS,
    Doc,
    SearchHit,
    VectorStore,
    shred_entry,
)
from githubrepostorag_tpu_torch.utils import next_bucket
from githubrepostorag_tpu_torch.utils.logging import get_logger
from githubrepostorag_tpu_torch.utils.profiling import annotate

logger = get_logger(__name__)

# ingest seeds the mirror from the inner store's existing rows at wrap time
_SEED_LIMIT = 1_000_000


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best (score, row) per query row of ``scores`` [Q, cap], ranked
    by score descending, then row ascending; masked rows are -inf and rank
    last, also by row.  Scores are finite or -inf (no NaN)."""
    cap = scores.shape[1]
    s = scores + 0.0  # -0.0 -> +0.0: equal floats get equal keys
    bits = s.view(torch.int32)
    # order-preserving int32 of a float: flip the magnitude bits of negatives
    ordered = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    rows = torch.arange(cap, device=scores.device, dtype=torch.int64)
    key = ordered * (1 << 32) + ((1 << 32) - 1 - rows)
    idx = torch.topk(key, k, dim=1, sorted=True).indices
    return torch.gather(s, 1, idx), idx


class _DeviceTable:
    """Host mirror + device copy of one table's corpus matrix.

    Row assignment mirrors the memory store's docs-dict ordering so tie
    order is identical: re-upserting an existing doc_id rewrites the SAME
    row; deletes leave an invalid hole (a re-insert then appends, exactly
    like a dict re-insert moves to the end)."""

    def __init__(self, name: str, dim: int, capacity: int) -> None:
        self.name = name
        self.dim = dim
        self.capacity = capacity
        self.ids: list[str] = []          # row -> doc_id ("" = hole)
        self.rows: dict[str, int] = {}    # doc_id -> row
        self.host = np.zeros((capacity, dim), dtype=np.float32)  # normalized
        self.valid = np.zeros(capacity, dtype=bool)
        self.meta_rows: dict[tuple[str, str], set[int]] = {}
        self.meta_docs: dict[int, dict[str, str]] = {}  # row -> metadata
        self.corpus_dev: torch.Tensor | None = None     # [dim, capacity] on the card
        self.dirty_rows: set[int] = set()
        self.full_sync = True
        self.compactions = 0              # in-place hole reclaims
        self.full_syncs = 0               # whole-table transpose re-puts


class DeviceIndexedStore(VectorStore):
    """VectorStore wrapper running ANN search on the card (``device``:
    the card unless ``"cpu"``), one wave per ``max_wave`` queries."""

    def __init__(
        self,
        inner: VectorStore,
        *,
        k_bucket: int = 16,
        max_wave: int = 16,
        min_capacity: int = 64,
        device=None,
    ) -> None:
        self.device = explicit_device(device)
        self.inner = inner
        self.k_bucket = max(1, k_bucket)
        self.max_wave = max(1, max_wave)
        self.min_capacity = max(1, min_capacity)
        self._tables: dict[str, _DeviceTable] = {}
        self._lock = threading.RLock()
        # distinct shapes dispatched: (queries, dim, capacity, k) searches;
        # ("scatter", dim, capacity, rows) and ("repack", dim, capacity)
        self._search_shapes: set[tuple] = set()
        self._mutation_shapes: set[tuple] = set()
        self._seed_from_inner()

    # ------------------------------------------------------------ programs

    def _search_program(self, corpus: torch.Tensor, queries: torch.Tensor,
                        mask: torch.Tensor, k: int):
        self._search_shapes.add((queries.shape[0], *corpus.shape, k))
        with annotate("device_index.search"), ieee_float32(self.device):
            # corpus is stored TRANSPOSED [dim, cap]: contracting its
            # leading axis walks the big operand contiguously
            scores = queries @ corpus                       # [Qb, cap]
            scores = scores.masked_fill(~mask, float("-inf"))
            return _top_k(scores, k)

    def _scatter(self, corpus: torch.Tensor, idx: np.ndarray, vals: np.ndarray) -> None:
        """Write ``vals`` [dim, ub] into columns ``idx`` [ub] in place; every
        index is a real column (see the module docstring)."""
        self._mutation_shapes.add(("scatter", *corpus.shape, idx.shape[0]))
        with annotate("device_index.scatter"):
            corpus.index_copy_(1, torch.from_numpy(idx).to(self.device),
                               torch.from_numpy(vals).to(self.device))

    def _repack(self, corpus: torch.Tensor, src: np.ndarray) -> torch.Tensor:
        """Column j of the result is column ``src[j]`` of ``corpus``, or
        zeros where ``src[j] == capacity``."""
        cap = corpus.shape[1]
        self._mutation_shapes.add(("repack", *corpus.shape))
        keep = src < cap
        with annotate("device_index.repack"):
            cols = torch.from_numpy(np.where(keep, src, 0).astype(np.int64)).to(self.device)
            keep_d = torch.from_numpy(keep).to(self.device)
            gathered = corpus.index_select(1, cols)
            return torch.where(keep_d[None, :], gathered, torch.zeros((), device=self.device))

    def search_program_cache_size(self) -> int:
        """Distinct search shapes dispatched (the warmup-contract observable)."""
        return len(self._search_shapes)

    def mutation_program_cache_size(self) -> int:
        """Distinct mutation shapes dispatched: the dirty-row scatter ladder
        plus the compaction repack (the live-mutation observable)."""
        return len(self._mutation_shapes)

    # ------------------------------------------------------------ mirror

    def _seed_from_inner(self) -> None:
        for table in self.inner.tables():
            docs = self.inner.find_by_metadata(table, {}, limit=_SEED_LIMIT)
            if docs:
                self._mirror_upsert(table, docs)

    def _capacity_for(self, n: int) -> int:
        return next_bucket(n, 1 << 30, minimum=self.min_capacity)

    def _table_for(self, name: str, dim: int) -> _DeviceTable:
        t = self._tables.get(name)
        if t is None:
            t = _DeviceTable(name, dim, self._capacity_for(1))
            self._tables[name] = t
        return t

    def reserve(self, table: str, capacity: int, dim: int | None = None) -> None:
        """Pre-size a table's capacity bucket (snapshot restore, bulk
        setup) so a known-size corpus doesn't re-grow through every
        intermediate bucket while it streams in."""
        with self._lock:
            t = self._tables.get(table)
            if t is None:
                if dim is None:
                    raise ValueError("reserve() on a new table needs dim")
                t = _DeviceTable(table, dim, self._capacity_for(capacity))
                self._tables[table] = t
            elif self._capacity_for(capacity) > t.capacity:
                self._grow(t, capacity)

    @staticmethod
    def _meta_entries(metadata: Mapping[str, str]) -> list[tuple[str, str]]:
        return [(str(k), str(v)) for k, v in metadata.items()]

    def _index_row(self, t: _DeviceTable, row: int, metadata: Mapping[str, str]) -> None:
        for kv in self._meta_entries(metadata):
            t.meta_rows.setdefault(kv, set()).add(row)

    def _unindex_row(self, t: _DeviceTable, row: int, metadata: Mapping[str, str]) -> None:
        for kv in self._meta_entries(metadata):
            rows = t.meta_rows.get(kv)
            if rows is not None:
                rows.discard(row)
                if not rows:
                    del t.meta_rows[kv]

    @staticmethod
    def _remap(t: _DeviceTable, live: list[tuple[str, int]], cap: int) -> None:
        """Move the live ``(doc_id, old row)`` pairs, in order, to rows 0..n-1
        of a mirror of ``cap`` rows (relative order, hence tie order, kept)."""
        old = np.fromiter((r for _, r in live), dtype=np.int64, count=len(live))
        host = np.zeros((cap, t.dim), dtype=np.float32)
        valid = np.zeros(cap, dtype=bool)
        host[: len(live)] = t.host[old]
        valid[: len(live)] = t.valid[old]
        old_row_of = {o: new for new, (_, o) in enumerate(live)}
        t.capacity, t.host, t.valid = cap, host, valid
        t.ids = [rid for rid, _ in live]
        t.rows = {rid: new for new, (rid, _) in enumerate(live)}
        t.meta_rows = {
            kv: {old_row_of[r] for r in rs if r in old_row_of}
            for kv, rs in t.meta_rows.items()
        }
        t.meta_rows = {kv: rs for kv, rs in t.meta_rows.items() if rs}
        t.meta_docs = {old_row_of[r]: md for r, md in t.meta_docs.items() if r in old_row_of}

    def _grow(self, t: _DeviceTable, needed: int) -> None:
        """Re-pack the mirror into a bigger capacity bucket, compacting
        holes; the device copy is re-put wholesale on the next search."""
        live = sorted(t.rows.items(), key=lambda p: p[1])
        self._remap(t, live, self._capacity_for(max(needed, len(live))))
        t.corpus_dev, t.dirty_rows, t.full_sync = None, set(), True

    def _compact_table(self, t: _DeviceTable) -> dict:
        """Reclaim tombstoned holes IN PLACE: repack live rows to the
        front of the SAME capacity bucket.  Relative live-row order is
        preserved, so memory-store tie order survives; the device side is
        one repack gather (after a scatter that lands pending writes) —
        never the full-transpose re-put ``_grow`` pays.  Caller holds the
        lock."""
        holes = len(t.ids) - len(t.rows)
        if holes <= 0:
            return {"table": t.name, "reclaimed": 0, "live_rows": len(t.rows)}
        live = sorted(t.rows.items(), key=lambda p: p[1])  # (id, row) by row
        if t.corpus_dev is not None and not t.full_sync:
            corpus = self._sync(t)  # land dirty rows via the scatter
            src = np.full(t.capacity, t.capacity, dtype=np.int64)  # -> zeros
            src[: len(live)] = [old for _, old in live]
            t.corpus_dev = self._repack(corpus, src)
        self._remap(t, live, t.capacity)
        t.dirty_rows = set()  # the repacked device copy mirrors host exactly
        t.compactions += 1
        INDEX_COMPACTIONS.labels(table=t.name).inc()
        self._publish_gauges(t)
        logger.info("device index %s: compacted %d holes (%d live / %d cap)",
                    t.name, holes, len(t.rows), t.capacity)
        return {"table": t.name, "reclaimed": holes, "live_rows": len(t.rows)}

    def compact(self, table: str | None = None) -> list[dict]:
        """Reclaim tombstoned holes (all tables, or one).  Returns one
        report per table that actually had holes."""
        with self._lock:
            names = [table] if table is not None else sorted(self._tables)
            out = []
            for name in names:
                t = self._tables.get(name)
                if t is not None and len(t.ids) - len(t.rows) > 0:
                    out.append(self._compact_table(t))
            return out

    def _mirror_upsert(self, table: str, docs: Sequence[Doc]) -> None:
        with self._lock:
            dims = [np.asarray(d.vector).size for d in docs if d.vector is not None]
            t = self._tables.get(table)
            if t is None:
                if not dims:
                    return  # vectorless rows never enter the matrix
                t = self._table_for(table, dims[0])
            for doc in docs:
                row = t.rows.get(doc.doc_id)
                if row is not None:
                    self._unindex_row(t, row, self._row_metadata(t, row))
                if doc.vector is None:
                    if row is not None:
                        # memory-store parity: a vectorless re-upsert drops
                        # the row from the matrix but keeps its slot
                        t.valid[row] = False
                        t.host[row] = 0.0
                        t.dirty_rows.add(row)
                        self._index_row(t, row, doc.metadata)
                        t.meta_docs[row] = dict(doc.metadata)
                    continue
                if row is None:
                    if len(t.ids) >= t.capacity:
                        if len(t.rows) < len(t.ids):
                            # tombstoned holes exist: reclaim them in place
                            # instead of growing
                            self._compact_table(t)
                        if len(t.ids) >= t.capacity:
                            self._grow(t, len(t.ids) + 1)
                    row = len(t.ids)
                    t.ids.append(doc.doc_id)
                    t.rows[doc.doc_id] = row
                v = np.asarray(doc.vector, dtype=np.float32).reshape(-1)
                if v.size != t.dim:
                    raise ValueError(
                        f"vector dim {v.size} != table dim {t.dim} for "
                        f"{doc.doc_id!r} in {table!r}"
                    )
                n = float(np.linalg.norm(v))
                t.host[row] = v / n if n > 0 else 0.0
                t.valid[row] = True
                t.dirty_rows.add(row)
                self._index_row(t, row, doc.metadata)
                t.meta_docs[row] = dict(doc.metadata)
            self._publish_gauges(t)

    def _publish_gauges(self, t: _DeviceTable) -> None:
        INDEX_LIVE_ROWS.labels(table=t.name).set(len(t.rows))
        INDEX_HOLES.labels(table=t.name).set(len(t.ids) - len(t.rows))
        INDEX_CAPACITY.labels(table=t.name).set(t.capacity)

    def _row_metadata(self, t: _DeviceTable, row: int) -> Mapping[str, str]:
        return t.meta_docs.get(row, {})

    def _mirror_delete(self, table: str, doc_ids: Iterable[str]) -> None:
        with self._lock:
            t = self._tables.get(table)
            if t is None:
                return
            for did in doc_ids:
                row = t.rows.pop(did, None)
                if row is None:
                    continue
                self._unindex_row(t, row, self._row_metadata(t, row))
                t.meta_docs.pop(row, None)
                t.ids[row] = ""
                t.valid[row] = False
                t.host[row] = 0.0
                t.dirty_rows.add(row)
            self._publish_gauges(t)

    # ------------------------------------------------------------ device sync

    def _sync(self, t: _DeviceTable) -> torch.Tensor:
        if t.corpus_dev is None or t.full_sync:
            # the device copy is the TRANSPOSE of the host mirror
            t.corpus_dev = torch.from_numpy(np.ascontiguousarray(t.host.T)).to(self.device)
            t.dirty_rows, t.full_sync = set(), False
            t.full_syncs += 1
            INDEX_FULL_SYNCS.labels(table=t.name).inc()
        elif t.dirty_rows:
            rows = sorted(t.dirty_rows)
            ub = next_bucket(len(rows), t.capacity, minimum=16)
            idx = np.full(ub, rows[-1], dtype=np.int64)  # padding rewrites the last row
            idx[: len(rows)] = rows
            vals = np.ascontiguousarray(t.host[idx].T)
            self._scatter(t.corpus_dev, idx, vals)
            t.dirty_rows = set()
        return t.corpus_dev

    # ------------------------------------------------------------ filters

    def _filter_rows(self, t: _DeviceTable, flt: Mapping[str, str] | None) -> np.ndarray:
        """Valid-row mask for one filter, via the inverted metadata index.
        Shredded keys match metadata[k]==v OR the per-member shred entry,
        the exact union _match checks."""
        mask = t.valid[: t.capacity].copy()
        if not flt:
            return mask
        for k, v in flt.items():
            rows = set(t.meta_rows.get((str(k), str(v)), ()))
            if k in SHREDDED_KEYS:
                rows |= t.meta_rows.get((shred_entry(k, v), "1"), set())
            kmask = np.zeros(t.capacity, dtype=bool)
            if rows:
                kmask[sorted(rows)] = True
            mask &= kmask
            if not mask.any():
                break
        return mask

    # ------------------------------------------------------------ search

    def warmup(self, tables: Sequence[str] | None = None) -> int:
        """Dispatch the full live shape set once: every power-of-two query
        bucket up to ``max_wave`` against each table's current capacity
        bucket, plus the mutation ladder (every scatter bucket ``_sync``
        can dispatch, 16..capacity, and the compaction repack).  Returns
        the number of distinct search shapes afterwards."""
        with self._lock:
            names = list(tables) if tables is not None else sorted(self._tables)
            for name in names:
                t = self._tables.get(name)
                if t is None:
                    continue
                corpus = self._sync(t)
                k = min(self.k_bucket, t.capacity)
                qb = 1
                while True:
                    self._dispatch(corpus, np.zeros((qb, t.dim), np.float32),
                                   np.zeros((qb, t.capacity), bool), k)
                    if qb >= self.max_wave:
                        break
                    qb *= 2
                self._warm_mutation(t)
        return self.search_program_cache_size()

    def _warm_mutation(self, t: _DeviceTable) -> None:
        """Run every mutation shape once as an identity: each scatter bucket
        rewrites column 0 with its own (synced) value, and an arange repack
        gathers each column onto itself."""
        ub = 16  # _sync's minimum scatter bucket
        while True:
            ub = min(ub, t.capacity)
            idx = np.zeros(ub, dtype=np.int64)
            vals = np.repeat(t.host[0][:, None], ub, axis=1)
            self._scatter(t.corpus_dev, idx, vals)
            if ub >= t.capacity:
                break
            ub *= 2
        t.corpus_dev = self._repack(t.corpus_dev, np.arange(t.capacity, dtype=np.int64))

    def _dispatch(self, corpus: torch.Tensor, queries: np.ndarray, mask: np.ndarray, k: int):
        q = torch.from_numpy(queries).to(self.device)
        m = torch.from_numpy(mask).to(self.device)
        with torch.inference_mode():
            vals, idx = self._search_program(corpus, q, m, k)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def search_batch(
        self,
        table: str,
        query_vectors: np.ndarray,
        k: int,
        filters: Sequence[Mapping[str, str] | None] | None = None,
    ) -> list[list[SearchHit]]:
        qs = np.asarray(query_vectors, dtype=np.float32)
        if qs.ndim == 1:
            qs = qs[None, :]
        nq = qs.shape[0]
        if filters is None:
            filters = [None] * nq
        if nq == 0:
            return []
        with self._lock:
            t = self._tables.get(table)
            if t is None:
                # nothing mirrored: the inner store has no vectored rows
                # either (every vectored upsert goes through the wrapper)
                return [[] for _ in range(nq)]
            if k > self.k_bucket or k <= 0:
                # outside the warmed k contract -> host path, counted
                DEVICE_INDEX_SEARCHES.labels(path="fallback").inc(nq)
                return [
                    self.inner.search(table, q, k, filter=f)
                    for q, f in zip(qs, filters)
                ]
            out: list[list[SearchHit]] = []
            for start in range(0, nq, self.max_wave):
                chunk = range(start, min(start + self.max_wave, nq))
                out.extend(self._search_wave(
                    table, t, qs[chunk.start:chunk.stop],
                    [filters[i] for i in chunk], k))
            return out

    def _search_wave(self, table: str, t: _DeviceTable, qs: np.ndarray,
                     filters: Sequence[Mapping[str, str] | None], k: int,
                     ) -> list[list[SearchHit]]:
        nq = qs.shape[0]
        corpus = self._sync(t)
        qb = next_bucket(nq, self.max_wave, minimum=1)
        queries = np.zeros((qb, t.dim), dtype=np.float32)
        mask = np.zeros((qb, t.capacity), dtype=bool)
        norms = np.linalg.norm(qs, axis=1)
        for i in range(nq):
            if norms[i] == 0:
                continue  # zero query: mask stays empty -> no hits (parity)
            queries[i] = qs[i] / norms[i]
            mask[i] = self._filter_rows(t, filters[i])
        k_prog = min(self.k_bucket, t.capacity)
        vals, idx = self._dispatch(corpus, queries, mask, k_prog)
        DEVICE_INDEX_SEARCHES.labels(path="device").inc(nq)
        out: list[list[SearchHit]] = []
        for i in range(nq):
            hits: list[SearchHit] = []
            for j in range(k_prog):
                if len(hits) >= k or np.isneginf(vals[i, j]):
                    break
                row = int(idx[i, j])
                doc = self.inner.get(table, t.ids[row])
                if doc is None:  # mirror/inner raced; skip defensively
                    continue
                hits.append(SearchHit(doc=doc, score=float(vals[i, j])))
            out.append(hits)
        return out

    # ------------------------------------------------------------ VectorStore

    def upsert(self, table: str, docs: Sequence[Doc]) -> int:
        n = self.inner.upsert(table, docs)
        self._mirror_upsert(table, docs)
        return n

    def search(
        self,
        table: str,
        query_vector: np.ndarray,
        k: int,
        filter: Mapping[str, str] | None = None,
    ) -> list[SearchHit]:
        return self.search_batch(table, np.asarray(query_vector)[None, :], k, [filter])[0]

    def find_by_metadata(self, table: str, filter: Mapping[str, str],
                         limit: int = 100) -> list[Doc]:
        return self.inner.find_by_metadata(table, filter, limit)

    def find_by_metadata_batch(self, table: str,
                               filters: Sequence[Mapping[str, str]],
                               limit: int = 100) -> list[list[Doc]]:
        return self.inner.find_by_metadata_batch(table, filters, limit)

    def get(self, table: str, doc_id: str) -> Doc | None:
        return self.inner.get(table, doc_id)

    def count(self, table: str) -> int:
        return self.inner.count(table)

    def delete(self, table: str, doc_ids: Iterable[str]) -> int:
        ids = list(doc_ids)
        n = self.inner.delete(table, ids)
        self._mirror_delete(table, ids)
        return n

    def tables(self) -> list[str]:
        return self.inner.tables()

    def health(self) -> dict:
        h = self.inner.health()
        dev: dict[str, dict] = {}
        with self._lock:
            for name, t in self._tables.items():
                holes = len(t.ids) - len(t.rows)
                dev[name] = {
                    "capacity": t.capacity,
                    "rows": len(t.rows),
                    "live_rows": len(t.rows),
                    "holes": holes,
                    "dirty_rows": len(t.dirty_rows),
                    "compactions": t.compactions,
                    "full_syncs": t.full_syncs,
                }
                self._publish_gauges(t)
        h["device_index"] = dev
        return h

    def save(self) -> None:
        self.inner.save()
