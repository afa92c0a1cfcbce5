"""Vector store interface: upsert / ANN search / metadata lookup; a copy
of ``githubrepostorag_tpu/store/base.py``.

The row shape mirrors the reference's Cassandra schema
(cassandra-initdb-configmap.yaml:14-29): ``row_id``, ``body_blob``,
``vector``, ``metadata_s MAP<TEXT,TEXT>``.  Metadata values are *strings
only* — the ingest sanitizer (vector_write_service.py:44-98 in the
reference) flattens everything to text before writing, and retrieval-side
edge traversal joins on string equality.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

import numpy as np


@dataclass
class Doc:
    """One stored row.  ``vector`` may be None before embedding."""

    doc_id: str
    text: str
    metadata: dict[str, str] = field(default_factory=dict)
    vector: np.ndarray | None = None


@dataclass
class SearchHit:
    doc: Doc
    score: float  # cosine similarity in [-1, 1]


# List-valued metadata keys are SHREDDED at write time (the reference's
# ShreddingTransformer, vector_write_service.py:118,153): each member becomes
# its own map entry ``key:member -> "1"`` so an equality filter matches ANY
# member (Cassandra's entries(metadata_s) SAI index can only do equality).
SHREDDED_KEYS = frozenset({"topics", "keywords", "tech_stack"})


def shred_entry(key: str, member: str) -> str:
    return f"{key}:{member.strip().lower()}"


def filter_entries(flt: Mapping[str, str]) -> list[tuple[str, str]]:
    """Translate a user filter to (map_key, value) equality pairs: shredded
    keys match their per-member entries, everything else matches verbatim."""
    out = []
    for k, v in flt.items():
        if k in SHREDDED_KEYS:
            out.append((shred_entry(k, v), "1"))
        else:
            out.append((k, v))
    return out


def _match(metadata: Mapping[str, str], flt: Mapping[str, str] | None) -> bool:
    if not flt:
        return True
    for k, v in flt.items():
        if metadata.get(k) == v:
            continue
        if k in SHREDDED_KEYS and metadata.get(shred_entry(k, v)) == "1":
            continue
        return False
    return True


class VectorStore(abc.ABC):
    """Five logical tables (catalog/repo/module/file/chunk), ANN + filters."""

    @abc.abstractmethod
    def upsert(self, table: str, docs: Sequence[Doc]) -> int:
        """Idempotent write keyed by doc_id.  Returns rows written."""

    @abc.abstractmethod
    def search(
        self,
        table: str,
        query_vector: np.ndarray,
        k: int,
        filter: Mapping[str, str] | None = None,
    ) -> list[SearchHit]:
        """Cosine ANN with optional exact-match metadata filter."""

    def search_batch(
        self,
        table: str,
        query_vectors: np.ndarray,
        k: int,
        filters: Sequence[Mapping[str, str] | None] | None = None,
    ) -> list[list[SearchHit]]:
        """Batched ANN: one call for a whole query wave.  The default loops
        ``search`` (host backends); device-resident backends override this
        with a single fused dispatch (retrieval/device_index.py)."""
        qs = np.asarray(query_vectors, dtype=np.float32)
        if filters is None:
            filters = [None] * qs.shape[0]
        return [self.search(table, q, k, filter=f) for q, f in zip(qs, filters)]

    @abc.abstractmethod
    def find_by_metadata(
        self,
        table: str,
        filter: Mapping[str, str],
        limit: int = 100,
    ) -> list[Doc]:
        """Equality lookup on metadata entries (the graph-edge traversal
        primitive: SAI entries(metadata_s) index in the reference)."""

    def find_by_metadata_batch(
        self,
        table: str,
        filters: Sequence[Mapping[str, str]],
        limit: int = 100,
    ) -> list[list[Doc]]:
        """Batched edge lookup: one call per hierarchy-traversal level
        instead of one per (node, edge).  Default loops ``find_by_metadata``;
        server backends can override with a multi-key query."""
        return [self.find_by_metadata(table, f, limit) for f in filters]

    @abc.abstractmethod
    def get(self, table: str, doc_id: str) -> Doc | None: ...

    @abc.abstractmethod
    def count(self, table: str) -> int: ...

    @abc.abstractmethod
    def delete(self, table: str, doc_ids: Iterable[str]) -> int: ...

    @abc.abstractmethod
    def tables(self) -> list[str]: ...

    def health(self) -> dict:
        """Liveness + per-table row counts (feeds the deep /health probe)."""
        return {"status": "UP", "tables": {t: self.count(t) for t in self.tables()}}

    def save(self) -> None:
        """Flush to durable storage.  No-op for server-backed stores; the
        local memory/native backends persist their JSON snapshot."""
        return None
