"""Brute-force in-memory vector store (numpy cosine), with optional JSON
persistence; a copy of ``githubrepostorag_tpu/store/memory.py``.  Exact
semantics of the Cassandra backend at test scale; also the default
local/dev backend (STORE_BACKEND=memory), and the host truth the device
index is held to."""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Iterable, Mapping, Sequence

import numpy as np

from githubrepostorag_tpu_torch.store.base import Doc, SearchHit, VectorStore, _match


class _Table:
    def __init__(self) -> None:
        self.docs: dict[str, Doc] = {}
        self._matrix: np.ndarray | None = None  # row-normalized vectors
        self._ids: list[str] = []
        self._dirty = True

    def invalidate(self) -> None:
        self._dirty = True

    def matrix(self) -> tuple[np.ndarray, list[str]]:
        if self._dirty:
            ids = [d for d, doc in self.docs.items() if doc.vector is not None]
            if ids:
                mat = np.stack([self.docs[i].vector for i in ids]).astype(np.float32)
                norms = np.linalg.norm(mat, axis=1, keepdims=True)
                norms[norms == 0] = 1.0
                mat = mat / norms
            else:
                mat = np.zeros((0, 0), dtype=np.float32)
            self._matrix, self._ids, self._dirty = mat, ids, False
        return self._matrix, self._ids


class MemoryVectorStore(VectorStore):
    def __init__(self, persist_dir: str | None = None) -> None:
        self._tables: dict[str, _Table] = {}
        self._lock = threading.RLock()
        self._persist_dir = Path(persist_dir) if persist_dir else None
        if self._persist_dir and self._persist_dir.exists():
            self._load()

    # -- core ops ---------------------------------------------------------

    def upsert(self, table: str, docs: Sequence[Doc]) -> int:
        with self._lock:
            t = self._tables.setdefault(table, _Table())
            for doc in docs:
                vec = None
                if doc.vector is not None:
                    vec = np.asarray(doc.vector, dtype=np.float32)
                t.docs[doc.doc_id] = Doc(doc.doc_id, doc.text, dict(doc.metadata), vec)
            t.invalidate()
            return len(docs)

    def search(
        self,
        table: str,
        query_vector: np.ndarray,
        k: int,
        filter: Mapping[str, str] | None = None,
    ) -> list[SearchHit]:
        with self._lock:
            t = self._tables.get(table)
            if t is None or k <= 0:
                return []
            mat, ids = t.matrix()
            if mat.shape[0] == 0:
                return []
            q = np.asarray(query_vector, dtype=np.float32).reshape(-1)
            qn = np.linalg.norm(q)
            if qn == 0:
                return []
            scores = mat @ (q / qn)
            if filter:
                rows = np.array(
                    [i for i, did in enumerate(ids)
                     if _match(t.docs[did].metadata, filter)],
                    dtype=np.int64,
                )
                if rows.size == 0:
                    return []
                cand = scores[rows]
            else:
                rows = None
                cand = scores
            # argpartition selects the k winners in O(n); the partial sort
            # of just those k is the canonical tie order: score desc, then
            # insertion (row) index asc — identical to the device index's
            # lax.top_k, whose ties also break toward the lower row.
            k_eff = min(k, cand.shape[0])
            if k_eff < cand.shape[0]:
                kth = cand[np.argpartition(-cand, k_eff - 1)[:k_eff]].min()
                # ties AT the k boundary: argpartition keeps an arbitrary
                # one, the canonical order keeps the lowest rows — rebuild
                # the winner set from the boundary score (flatnonzero is
                # ascending, so tied rows come out in insertion order)
                sure = np.flatnonzero(cand > kth)
                tied = np.flatnonzero(cand == kth)
                part = np.concatenate([sure, tied[: k_eff - sure.size]])
            else:
                part = np.arange(cand.shape[0])
            part = part[np.lexsort((part, -cand[part]))]
            out_rows = part if rows is None else rows[part]
            return [
                SearchHit(doc=t.docs[ids[i]], score=float(scores[i]))
                for i in out_rows
            ]

    def find_by_metadata(
        self,
        table: str,
        filter: Mapping[str, str],
        limit: int = 100,
    ) -> list[Doc]:
        with self._lock:
            t = self._tables.get(table)
            if t is None:
                return []
            out = []
            for doc in t.docs.values():
                if _match(doc.metadata, filter):
                    out.append(doc)
                    if len(out) >= limit:
                        break
            return out

    def get(self, table: str, doc_id: str) -> Doc | None:
        with self._lock:
            t = self._tables.get(table)
            return t.docs.get(doc_id) if t else None

    def count(self, table: str) -> int:
        with self._lock:
            t = self._tables.get(table)
            return len(t.docs) if t else 0

    def delete(self, table: str, doc_ids: Iterable[str]) -> int:
        with self._lock:
            t = self._tables.get(table)
            if t is None:
                return 0
            n = 0
            for did in doc_ids:
                if t.docs.pop(did, None) is not None:
                    n += 1
            t.invalidate()
            return n

    def tables(self) -> list[str]:
        with self._lock:
            return sorted(self._tables)

    # -- persistence ------------------------------------------------------

    def save(self) -> None:
        if not self._persist_dir:
            return
        with self._lock:
            self._persist_dir.mkdir(parents=True, exist_ok=True)
            for name, t in self._tables.items():
                rows = [
                    {
                        "doc_id": d.doc_id,
                        "text": d.text,
                        "metadata": d.metadata,
                        "vector": d.vector.tolist() if d.vector is not None else None,
                    }
                    for d in t.docs.values()
                ]
                tmp = self._persist_dir / f".{name}.json.tmp"
                tmp.write_text(json.dumps(rows))
                os.replace(tmp, self._persist_dir / f"{name}.json")

    def _load(self) -> None:
        for path in self._persist_dir.glob("*.json"):
            rows = json.loads(path.read_text())
            docs = [
                Doc(
                    r["doc_id"],
                    r["text"],
                    r.get("metadata", {}),
                    np.asarray(r["vector"], dtype=np.float32) if r.get("vector") is not None else None,
                )
                for r in rows
            ]
            self.upsert(path.stem, docs)
