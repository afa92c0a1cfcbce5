"""Request/response DTOs shared by the API, worker, and agent; a copy of
``githubrepostorag_tpu/models_dto.py``.

Parity with rag_shared/models.py:6-14 in the reference, with the schema drift
it had fixed: the reference's QueryRequest carried ``top_k``/``repo_name``
while the worker read ``force_level``/``namespace`` from the raw dict
(worker.py:101-107).  Here every field the pipeline actually consumes is
declared.
"""

from __future__ import annotations

from typing import Any, Optional

from pydantic import BaseModel, Field


class QueryRequest(BaseModel):
    query: str
    top_k: Optional[int] = 5
    repo_name: Optional[str] = None
    namespace: Optional[str] = None
    force_level: Optional[str] = None  # catalog|repo|module|file|chunk
    # wall-clock budget for the whole job; clamped to JOB_TIMEOUT_SECONDS
    # server-side and propagated API -> worker -> agent -> engine
    deadline_ms: Optional[int] = None
    # SLO priority class (None -> PRIORITY_DEFAULT_CLASS).  Unknown strings
    # are just new classes; propagated API -> worker -> agent -> engine,
    # where it drives per-class admission, headroom, and preemption
    priority: Optional[str] = None


class RAGResponse(BaseModel):
    answer: str
    sources: Optional[list[dict[str, Any]]] = None


class IngestRequest(BaseModel):
    components: list[str] = Field(default_factory=list)
    namespace: str = "default"
    branch: Optional[str] = None
