"""Agent state carried between stages; a copy of
``githubrepostorag_tpu/agent/state.py`` (the reference's AgentState TypedDict,
agent_graph.py:20-29, as a dataclass with a per-run progress context —
fixing the non-thread-safe instance-level callback swap of
agent_graph.py:526-543)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from githubrepostorag_tpu_torch.retrieval import RetrievedDoc

ProgressCallback = Callable[[dict[str, Any]], None]


@dataclass
class AgentState:
    query: str
    original_query: str
    scope: str = "repo"
    mode: str = "rag"  # "rag" = iterative retrieve loop; "longctx" = the
    # assembled whole repo through the serving stack's ring-prefill path as
    # ONE prompt (retrieval/assembler.py).  plan_scope picks; an over-budget
    # or chunk-less repo resets to "rag" and rejoins the normal loop.
    filters: dict[str, str] = field(default_factory=dict)
    attempt: int = 0
    top_k: int | None = None  # per-request result cap (QueryRequest.top_k —
    # the reference declared it, rag_shared/models.py:6-9, but never read it;
    # None falls back to settings ROUTER_TOP_K)
    docs: list[RetrievedDoc] = field(default_factory=list)
    best_docs: list[RetrievedDoc] = field(default_factory=list)  # last non-empty retrieval
    needs_more: bool = False
    rewrite: str | None = None
    answer: str | None = None
    sources: list[dict[str, Any]] = field(default_factory=list)
    debug: dict[str, Any] = field(default_factory=lambda: {"turns": []})
    progress_cb: ProgressCallback | None = None

    def breadcrumb(self, stage: str, **payload: Any) -> None:
        """Append a debug turn and emit the progress event (the reference's
        dual bookkeeping: debug['turns'] + _notify)."""
        entry = {"stage": stage, **payload}
        self.debug.setdefault("turns", []).append(entry)
        if self.progress_cb is not None:
            try:
                self.progress_cb(entry)
            except Exception:  # noqa: BLE001 - progress must never kill the run
                pass
