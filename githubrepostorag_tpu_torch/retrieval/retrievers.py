"""Per-scope retrievers: ANN seed -> metadata-edge graph traversal; a
copy of ``githubrepostorag_tpu/retrieval/retrievers.py``.

Rebuilds the reference's query-time retriever factory
(graph_rag_retrievers.py:104-134: LangChain GraphRetriever with the Eager
strategy per scope; edges are equal-value metadata joins on
namespace/repo/module/file_path; fan-out k 6-10, start_k 2-3, adjacent_k
6-8, max_depth 2) directly over the VectorStore interface — no LangChain.

Traversal: seed with ANN top-``start_k``; walk edges breadth-first up to
``max_depth``, pulling up to ``adjacent_k`` neighbors per edge via the
metadata-entries index; score every candidate by cosine to the query;
return the top ``k``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.embedding import TextEncoder, get_encoder
from githubrepostorag_tpu_torch.store.base import VectorStore


@dataclass
class RetrievedDoc:
    doc_id: str
    text: str
    metadata: dict[str, str]
    score: float
    depth: int = 0  # 0 = ANN seed, >0 = reached via edge traversal


@dataclass(frozen=True)
class ScopeSpec:
    table_key: str  # key into Settings.scope_tables
    k: int
    start_k: int
    adjacent_k: int
    max_depth: int
    edges: tuple[str, ...]  # metadata keys joined on equality
    # MMR diversity re-ranking: final selection maximizes
    # lambda*relevance - (1-lambda)*max_similarity_to_selected.  None = pure
    # relevance (the reference's live Eager strategy); the narrow scopes use
    # the lambdas its richer GraphRetrieverFactory design specified
    # (GraphRetrieverFactory.py:105-161 — dead code there, live here).
    mmr_lambda: float | None = None


# Fan-out parameters mirror graph_rag_retrievers.py:104-134; edge sets follow
# the hierarchy (an L4 chunk connects to its file's other chunks, its module,
# and its repo).  The catalog scope IS routable here — the reference wrote
# embeddings_catalog but never queried it (SURVEY.md Appendix A).
SCOPE_SPECS: dict[str, ScopeSpec] = {
    "catalog": ScopeSpec("catalog", k=4, start_k=2, adjacent_k=4, max_depth=1, edges=("namespace",)),
    "repo": ScopeSpec("repo", k=6, start_k=2, adjacent_k=6, max_depth=2, edges=("namespace",)),
    "module": ScopeSpec("module", k=8, start_k=3, adjacent_k=8, max_depth=2, edges=("repo",),
                        mmr_lambda=0.4),
    "file": ScopeSpec("file", k=10, start_k=3, adjacent_k=8, max_depth=2, edges=("module", "repo"),
                      mmr_lambda=0.4),
    "chunk": ScopeSpec("chunk", k=10, start_k=3, adjacent_k=8, max_depth=2, edges=("file_path", "module"),
                       mmr_lambda=0.3),
}


def mmr_select(
    docs: Sequence[RetrievedDoc],
    vectors: Mapping[str, np.ndarray],
    k: int,
    lam: float,
) -> list[RetrievedDoc]:
    """Maximal-marginal-relevance selection: greedily pick the doc
    maximizing ``lam*relevance - (1-lam)*max_cos_to_already_selected``.
    Docs without vectors fall back to relevance-only (penalty 0)."""
    remaining = sorted(docs, key=lambda d: d.score, reverse=True)
    selected: list[RetrievedDoc] = []
    # running max-similarity-to-selected per candidate: only the vector
    # added last round can raise it, so each round is one dot per candidate
    penalty = {d.doc_id: 0.0 for d in remaining}
    last_vec: np.ndarray | None = None
    while remaining and len(selected) < k:
        if last_vec is not None:
            for d in remaining:
                v = vectors.get(d.doc_id)
                if v is not None:
                    penalty[d.doc_id] = max(penalty[d.doc_id], float(v @ last_vec))
        best_i = max(
            range(len(remaining)),
            key=lambda i: lam * remaining[i].score
            - (1.0 - lam) * penalty[remaining[i].doc_id],
        )
        pick = remaining.pop(best_i)
        selected.append(pick)
        last_vec = vectors.get(pick.doc_id)
    return selected

# The canonical five-level ladder, broadest to narrowest.  The agent's
# stage-down routing and prompt vocabulary import THIS — one source of truth.
SCOPE_LADDER = ["catalog", "repo", "module", "file", "chunk"]


class ScopeRetriever:
    def __init__(
        self,
        store: VectorStore,
        encoder: TextEncoder,
        scope: str,
        spec: ScopeSpec | None = None,
        table: str | None = None,
        coalescer=None,  # RetrievalCoalescer: embed+seed via shared waves
    ) -> None:
        self.store = store
        self.encoder = encoder
        self.scope = scope
        self.spec = spec or SCOPE_SPECS[scope]
        self.table = table or get_settings().scope_tables[self.spec.table_key]
        self.coalescer = coalescer

    def retrieve(self, query: str, filters: Mapping[str, str] | None = None,
                 top_k: int | None = None) -> list[RetrievedDoc]:
        """``top_k`` overrides the scope spec's result cap ``k`` for this
        call (per-request QueryRequest.top_k); the traversal fan-out
        (start_k/adjacent_k/depth) stays spec-driven."""
        return self.retrieve_many([query], filters, top_k=top_k)[0]

    def retrieve_many(
        self,
        queries: Sequence[str],
        filters: Mapping[str, str] | None = None,
        top_k: int | None = None,
    ) -> list[list[RetrievedDoc]]:
        """Batched retrieval: ONE encoder forward and ONE seed-search
        dispatch for the whole query set (via the coalescer when wired, so
        concurrent sessions share the same wave), then the graph traversal
        runs its per-level fan-out as batched metadata lookups instead of
        one store call per (node, edge)."""
        queries = list(queries)
        if not queries:
            return []
        spec = self.spec
        cap = top_k if top_k and top_k > 0 else spec.k
        flt = dict(filters or {})
        if self.coalescer is not None:
            pairs = self.coalescer.search_many(
                self.table, queries, spec.start_k, flt, kind="query"
            )
        else:
            qvecs = self.encoder.encode(queries, kind="query")
            seed_lists = self.store.search_batch(
                self.table, qvecs, spec.start_k, [flt] * len(queries)
            )
            pairs = list(zip(qvecs, seed_lists))
        # edge lookups repeat heavily across a wave's queries (expansions
        # share repo/module values) — memoize per retrieve_many call
        edge_cache: dict[tuple[tuple[str, str], ...], list] = {}
        return [self._traverse(qvec, seeds, flt, cap, edge_cache)
                for qvec, seeds in pairs]

    def _traverse(self, qvec: np.ndarray, seeds, flt: Mapping[str, str],
                  cap: int, edge_cache: dict) -> list[RetrievedDoc]:
        spec = self.spec
        found: dict[str, RetrievedDoc] = {}
        vectors: dict[str, np.ndarray] = {}  # unit vectors, for MMR

        def remember_vector(doc_id: str, vec) -> None:
            if vec is None:
                return
            v = np.asarray(vec, dtype=np.float32)
            n = np.linalg.norm(v)
            if n > 0:
                vectors[doc_id] = v / n

        for hit in seeds:
            found[hit.doc.doc_id] = RetrievedDoc(
                hit.doc.doc_id, hit.doc.text, dict(hit.doc.metadata), hit.score, depth=0
            )
            remember_vector(hit.doc.doc_id, hit.doc.vector)

        qnorm = np.linalg.norm(qvec)
        frontier = list(found.values())
        for depth in range(1, spec.max_depth + 1):
            # the whole level's fan-out as ONE batched metadata lookup
            # (minus wave-cache hits), preserving (frontier, edge) order
            wanted: list[tuple[tuple[str, str], ...]] = []
            for doc in frontier:
                for edge_key in spec.edges:
                    edge_val = doc.metadata.get(edge_key)
                    if not edge_val:
                        continue
                    edge_filter = dict(flt)
                    edge_filter[edge_key] = edge_val
                    key = tuple(sorted(edge_filter.items()))
                    if key not in edge_cache and key not in wanted:
                        wanted.append(key)
            if wanted:
                batches = self.store.find_by_metadata_batch(
                    self.table, [dict(key) for key in wanted],
                    limit=spec.adjacent_k,
                )
                edge_cache.update(zip(wanted, batches))

            new_docs: list[tuple] = []  # (Doc, depth) in traversal order
            claimed: set[str] = set()
            for doc in frontier:
                for edge_key in spec.edges:
                    edge_val = doc.metadata.get(edge_key)
                    if not edge_val:
                        continue
                    edge_filter = dict(flt)
                    edge_filter[edge_key] = edge_val
                    key = tuple(sorted(edge_filter.items()))
                    for adj in edge_cache.get(key, ()):
                        if adj.doc_id in found or adj.doc_id in claimed:
                            continue
                        claimed.add(adj.doc_id)
                        new_docs.append(adj)

            # score the level's candidates with ONE matmul (same formula as
            # the old per-doc dot: v @ qvec / (|v| * |qvec|))
            scores = np.zeros(len(new_docs), dtype=np.float32)
            if qnorm > 0 and new_docs:
                rows = [i for i, d in enumerate(new_docs) if d.vector is not None]
                if rows:
                    mat = np.stack([
                        np.asarray(new_docs[i].vector, dtype=np.float32)
                        for i in rows
                    ])
                    norms = np.linalg.norm(mat, axis=1)
                    dots = mat @ np.asarray(qvec, dtype=np.float32)
                    for i, dot, vn in zip(rows, dots, norms):
                        if vn > 0:
                            scores[i] = dot / (vn * qnorm)

            next_frontier: list[RetrievedDoc] = []
            for i, adj in enumerate(new_docs):
                rd = RetrievedDoc(adj.doc_id, adj.text, dict(adj.metadata),
                                  float(scores[i]), depth=depth)
                found[adj.doc_id] = rd
                remember_vector(adj.doc_id, adj.vector)
                next_frontier.append(rd)
            frontier = next_frontier
            if not frontier:
                break

        if spec.mmr_lambda is not None:
            return mmr_select(list(found.values()), vectors, cap, spec.mmr_lambda)
        ranked = sorted(found.values(), key=lambda d: d.score, reverse=True)
        return ranked[:cap]


class RetrieverFactory:
    """One retriever per scope over a shared store + encoder (the reference
    rebuilt a Cassandra session and HF embedder per factory; here both are
    process-wide singletons).  All scopes share ONE coalescer, so concurrent
    sessions' retrievals merge into the same encode+search waves
    (RETRIEVAL_COALESCE=0 restores the direct per-call path)."""

    def __init__(self, store: VectorStore | None = None,
                 encoder: TextEncoder | None = None, coalescer=None,
                 device=None) -> None:
        """``coalescer``: None = build one when RETRIEVAL_COALESCE is on;
        False = force the direct path; an instance = share it.  ``device``
        places the process-wide store and encoder when they are built here
        (the card unless ``"cpu"``)."""
        from githubrepostorag_tpu_torch.store import get_store

        self.store = store or get_store(device)
        self.encoder = encoder or get_encoder(device)
        s = get_settings()
        if coalescer is None and s.retrieval_coalesce:
            from githubrepostorag_tpu_torch.retrieval.coalescer import RetrievalCoalescer

            coalescer = RetrievalCoalescer(
                self.store, self.encoder, max_wave=s.retrieval_max_wave
            )
        self.coalescer = coalescer or None
        self._cache: dict[str, ScopeRetriever] = {}

    def for_scope(self, scope: str) -> ScopeRetriever:
        if scope not in SCOPE_SPECS:
            raise KeyError(f"unknown scope {scope!r}; valid: {list(SCOPE_SPECS)}")
        if scope not in self._cache:
            self._cache[scope] = ScopeRetriever(
                self.store, self.encoder, scope, coalescer=self.coalescer
            )
        return self._cache[scope]

    def retrieve(self, scope: str, query: str, filters: Mapping[str, str] | None = None,
                 top_k: int | None = None) -> list[RetrievedDoc]:
        return self.for_scope(scope).retrieve(query, filters, top_k=top_k)
