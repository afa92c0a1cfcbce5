"""Cassandra 5 vector store backend (SAI ANN, cosine); port of
``githubrepostorag_tpu/store/cassandra.py``.

Behavioral equivalent of the reference's storage path
(ingest/src/app/services/cassandra_service.py:93-197 + the initdb CQL in
helm/templates/cassandra-initdb-configmap.yaml): keyspace ensure with
SimpleStrategy RF=1, one table per hierarchy scope with a cosine SAI index on
``vector`` and an entries index on ``metadata_s``, idempotent upserts keyed by
``row_id``.

Speaks CQL through the port's in-tree native-protocol v4 client
(store/cql.py), held against the JAX package's over the same servers
(tests/test_torch_stores.py).

One divergence by design: ``find_by_metadata`` with an empty filter (the
device index seeds itself from ``find_by_metadata(table, {}, limit)``)
issues no WHERE clause.  The JAX store sends ``... WHERE  LIMIT n``, which
a Cassandra node refuses as a syntax error; rows and order are the same on
a server that accepts both.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

from githubrepostorag_tpu_torch.store.base import Doc, SearchHit, VectorStore, filter_entries
from githubrepostorag_tpu_torch.store.cql import CQLCluster


_DDL_KEYSPACE = (
    "CREATE KEYSPACE IF NOT EXISTS {ks} WITH REPLICATION = "
    "{{'class':'SimpleStrategy','replication_factor':1}}"
)
_DDL_TABLE = (
    "CREATE TABLE IF NOT EXISTS {ks}.{table} ("
    " row_id TEXT PRIMARY KEY,"
    " attributes_blob TEXT,"
    " body_blob TEXT,"
    " vector VECTOR<FLOAT, {dim}>,"
    " metadata_s MAP<TEXT, TEXT>)"
)
_DDL_VIDX = (
    "CREATE CUSTOM INDEX IF NOT EXISTS idx_vector_{table} ON {ks}.{table} (vector)"
    " USING 'org.apache.cassandra.index.sai.StorageAttachedIndex'"
    " WITH OPTIONS = {{'similarity_function':'cosine'}}"
)
_DDL_MIDX = (
    "CREATE CUSTOM INDEX IF NOT EXISTS eidx_metadata_s_{table} ON {ks}.{table}"
    " (entries(metadata_s))"
    " USING 'org.apache.cassandra.index.sai.StorageAttachedIndex'"
)


def _row_doc(r) -> "Doc":
    """Row -> Doc including the stored vector (traversal scoring and MMR
    re-ranking need it; omitting the column silently degrades both)."""
    vec = getattr(r, "vector", None)
    return Doc(
        r.row_id, r.body_blob or "", dict(r.metadata_s or {}),
        np.asarray(vec, dtype=np.float32) if vec is not None else None,
    )


class CassandraVectorStore(VectorStore):
    def __init__(
        self,
        hosts: list[str],
        port: int = 9042,
        username: str = "cassandra",
        password: str = "cassandra",
        keyspace: str = "vector_store",
        embed_dim: int = 384,
    ) -> None:
        self._cluster = CQLCluster(
            contact_points=hosts, port=port, username=username, password=password
        )
        self._session = self._cluster.connect()
        self._ks = keyspace
        self._dim = embed_dim
        self._known_tables: set[str] = set()
        self._insert_stmts: dict[str, object] = {}
        self._session.execute(_DDL_KEYSPACE.format(ks=keyspace))

    def _ensure_table(self, table: str) -> None:
        if table in self._known_tables:
            return
        self._session.execute(_DDL_TABLE.format(ks=self._ks, table=table, dim=self._dim))
        self._session.execute(_DDL_VIDX.format(ks=self._ks, table=table))
        self._session.execute(_DDL_MIDX.format(ks=self._ks, table=table))
        self._known_tables.add(table)

    def upsert(self, table: str, docs: Sequence[Doc]) -> int:
        self._ensure_table(table)
        stmt = self._insert_stmts.get(table)
        if stmt is None:
            stmt = self._session.prepare(
                f"INSERT INTO {self._ks}.{table} (row_id, body_blob, vector, metadata_s) VALUES (?, ?, ?, ?)"
            )
            self._insert_stmts[table] = stmt
        for doc in docs:
            vec = [float(x) for x in doc.vector] if doc.vector is not None else None
            self._session.execute(stmt, (doc.doc_id, doc.text, vec, dict(doc.metadata)))
        return len(docs)

    @staticmethod
    def _filter_variants(filter: Mapping[str, str]) -> list[list[tuple[str, str]]]:
        """Equality-pair variants for a filter.  CQL has no OR, so shredded
        keys (topics=kafka -> entry 'topics:kafka'='1') get a SECOND variant
        using plain equality, tried only when the entry form matches nothing
        — keeps rows ingested before shredding landed retrievable, matching
        MemoryVectorStore._match's semantics."""
        primary = filter_entries(filter)
        plain = list(filter.items())
        return [primary] if primary == plain else [primary, plain]

    def search(
        self,
        table: str,
        query_vector: np.ndarray,
        k: int,
        filter: Mapping[str, str] | None = None,
    ) -> list[SearchHit]:
        self._ensure_table(table)
        vec = [float(x) for x in np.asarray(query_vector).reshape(-1)]
        for pairs in self._filter_variants(filter) if filter else [[]]:
            where = ""
            params: list = [vec]
            if pairs:
                clauses = []
                for key, val in pairs:
                    clauses.append("metadata_s[%s] = %s")
                    params.extend([key, val])
                where = " WHERE " + " AND ".join(clauses)
            params.append(int(k))
            cql = (
                f"SELECT row_id, body_blob, metadata_s, vector, "
                f"similarity_cosine(vector, %s) AS score "
                f"FROM {self._ks}.{table}{where} ORDER BY vector ANN OF %s LIMIT %s"
            )
            # ANN OF needs the vector twice (score projection + ordering)
            params.insert(-1, vec)
            rows = self._session.execute(cql, params)
            hits = [
                SearchHit(_row_doc(r), float(r.score))
                for r in rows
            ]
            if hits:
                return hits
        return []

    def find_by_metadata(self, table: str, filter: Mapping[str, str], limit: int = 100) -> list[Doc]:
        self._ensure_table(table)
        for pairs in self._filter_variants(filter):
            clauses, params = [], []
            for key, val in pairs:
                clauses.append("metadata_s[%s] = %s")
                params.extend([key, val])
            params.append(int(limit))
            where = f"WHERE {' AND '.join(clauses)} " if clauses else ""
            cql = (
                f"SELECT row_id, body_blob, metadata_s, vector FROM {self._ks}.{table} "
                f"{where}LIMIT %s"
            )
            rows = self._session.execute(cql, params)
            docs = [_row_doc(r) for r in rows]
            if docs:
                return docs
        return []

    def get(self, table: str, doc_id: str) -> Doc | None:
        self._ensure_table(table)
        rows = self._session.execute(
            f"SELECT row_id, body_blob, metadata_s, vector FROM {self._ks}.{table} "
            f"WHERE row_id = %s",
            (doc_id,),
        )
        row = rows.one()
        return _row_doc(row) if row else None

    def count(self, table: str) -> int:
        self._ensure_table(table)
        row = self._session.execute(f"SELECT COUNT(*) AS n FROM {self._ks}.{table}").one()
        return int(row.n) if row else 0

    def delete(self, table: str, doc_ids: Iterable[str]) -> int:
        # Existence-check first so the return value matches the memory
        # backend's "rows actually removed" contract.
        self._ensure_table(table)
        n = 0
        for did in doc_ids:
            row = self._session.execute(
                f"SELECT row_id FROM {self._ks}.{table} WHERE row_id = %s", (did,)
            ).one()
            if row is None:
                continue
            self._session.execute(f"DELETE FROM {self._ks}.{table} WHERE row_id = %s", (did,))
            n += 1
        return n

    def tables(self) -> list[str]:
        rows = self._session.execute(
            "SELECT table_name FROM system_schema.tables WHERE keyspace_name = %s", (self._ks,)
        )
        return sorted(r.table_name for r in rows)

    def health(self) -> dict:
        # Connectivity probe only: COUNT(*) per table is a full scan that can
        # itself time out at scale and flap the liveness probe.
        try:
            self._session.execute("SELECT release_version FROM system.local")
            return {"status": "UP", "tables": {t: -1 for t in self.tables()}}
        except Exception as exc:  # noqa: BLE001 - health must not raise
            return {"status": "DOWN", "error": str(exc)}
