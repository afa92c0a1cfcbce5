"""Document/node types flowing through the ingest pipeline; a copy of
``githubrepostorag_tpu/ingest/types.py`` (the same ``stable_id`` sha1, so
a re-ingest by either package is an idempotent upsert of the same rows)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any


@dataclass
class SourceDoc:
    """One file from a repository, pre-chunking."""

    path: str
    text: str
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class Node:
    """One chunk/summary headed for the vector store."""

    text: str
    metadata: dict[str, Any] = field(default_factory=dict)
    node_id: str | None = None

    def stable_id(self) -> str:
        """Deterministic id so re-ingest is an idempotent upsert
        (vector_write_service.py:166-198 in the reference)."""
        if self.node_id:
            return self.node_id
        md = self.metadata
        key = "|".join(
            str(md.get(k, ""))
            for k in ("scope", "namespace", "repo", "module", "file_path", "span")
        )
        return hashlib.sha1(f"{key}|{hashlib.sha1(self.text.encode()).hexdigest()}".encode()).hexdigest()
