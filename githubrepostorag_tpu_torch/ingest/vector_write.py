"""Vector writes: nodes -> sanitized store rows, embedded in batches; a copy
of ``githubrepostorag_tpu/ingest/vector_write.py``.

Rebuild of vector_write_service.py: stable deterministic ids (idempotent
re-ingest, :166-198), metadata sanitized to MAP<TEXT,TEXT> semantics with a
per-scope allow-list plus keep-always keys (:28-98), list metadata SHREDDED
into per-member entries so equality filters match any member (the
reference's ShreddingTransformer, :118,153) alongside a comma-joined
display value, and batched writes of 128 (:110) with the embedding computed
by the shared batch encoder (on the card: ``TorchBertTextEncoder``) instead
of per-row CPU torch.  The rows go through ``get_store()``: on the card,
``DEVICE_INDEX=auto`` wraps the host store in the device index, and
``LIVE_INDEX=on`` sends them through the mutation log.
"""

from __future__ import annotations

import json
from typing import Sequence

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.embedding import TextEncoder, get_encoder
from githubrepostorag_tpu_torch.ingest.types import Node
from githubrepostorag_tpu_torch.store import Doc, VectorStore, get_store
from githubrepostorag_tpu_torch.store.base import SHREDDED_KEYS, shred_entry
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

WRITE_BATCH = 128

KEEP_ALWAYS = {"scope", "namespace", "repo", "collection", "component_kind"}

SCOPE_ALLOWED: dict[str, set[str]] = {
    "catalog": {"tech_stack", "topics", "title", "summary"},
    "repo": {"rollup_of", "rollup_count", "topics", "title", "summary"},
    "module": {"module", "rollup_of", "rollup_count", "topics", "title", "summary"},
    "file": {"module", "file_path", "language", "rollup_of", "rollup_count",
             "topics", "title", "summary", "keywords"},
    "chunk": {"module", "file_path", "language", "span", "title", "summary",
              "keywords", "topics"},
}


def sanitize_metadata(metadata: dict, scope: str) -> dict[str, str]:
    """Flatten to str->str under the scope's allow-list.  Shredded keys
    (topics/keywords/tech_stack) additionally write one ``key:member -> 1``
    entry per member, so an exact-match filter on e.g. ``topics=kafka``
    matches a doc whose topics are [Kafka, Streams, Consumer]."""
    allowed = SCOPE_ALLOWED.get(scope, set()) | KEEP_ALWAYS
    out: dict[str, str] = {}
    for key, val in metadata.items():
        if key not in allowed or val is None:
            continue
        members: list[str] | None = None
        if isinstance(val, str):
            s = val
            if key in SHREDDED_KEYS:
                members = [m for m in (p.strip() for p in val.split(",")) if m]
        elif isinstance(val, (int, float, bool)):
            s = str(val)
        elif isinstance(val, (list, tuple)):
            s = ", ".join(str(v) for v in val)
            if key in SHREDDED_KEYS:
                members = [str(v) for v in val]
        elif isinstance(val, dict):
            s = json.dumps(val, ensure_ascii=False, sort_keys=True)
        else:
            s = str(val)
        if not s:
            continue
        out[key] = s
        for member in members or ():
            out[shred_entry(key, member)] = "1"
    return out


def write_nodes_per_scope(
    nodes_by_scope: dict[str, Sequence[Node]],
    store: VectorStore | None = None,
    encoder: TextEncoder | None = None,
) -> dict[str, int]:
    """Embed + upsert every scope's nodes.  Returns rows written per scope."""
    store = store or get_store()
    encoder = encoder or get_encoder()
    tables = get_settings().scope_tables
    written: dict[str, int] = {}

    for scope, nodes in nodes_by_scope.items():
        table = tables.get(scope)
        if table is None:
            logger.warning("unknown scope %r; skipping %d nodes", scope, len(nodes))
            continue
        count = 0
        nodes = list(nodes)
        for start in range(0, len(nodes), WRITE_BATCH):
            batch = nodes[start : start + WRITE_BATCH]
            vectors = encoder.encode([n.text for n in batch], kind="passage")
            docs = [
                Doc(
                    doc_id=node.stable_id(),
                    text=node.text,
                    metadata=sanitize_metadata({**node.metadata, "scope": scope}, scope),
                    vector=vectors[i],
                )
                for i, node in enumerate(batch)
            ]
            count += store.upsert(table, docs)
        written[scope] = count
        logger.info("wrote %d %s nodes to %s", count, scope, table)
    return written
