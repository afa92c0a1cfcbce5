"""Whole-repo document assembler: the agent's long-context answer mode;
a copy of ``githubrepostorag_tpu/retrieval/assembler.py``.

Chunk RAG answers from ~5 fragments; architecture-class questions ("how does
ingest flow into the store?") want the WHOLE repository in context.  The
serving stack makes that affordable — segment-packed ring prefill
(serving/long_prefill.py) runs a repo-sized prompt as one fixed-budget
device pass — so the retrieval side needs the dual: reassemble a repo's
ingested chunks back into one ordered document.

Layout: chunks group by file, files order module -> path (the same
hierarchy the ingest controller derived them from), and each file renders
under a ``### path`` header with its chunks in line-span order.  The split
overlap (ingest/chunker.py CODE_OVERLAP_LINES) means a few repeated lines
at chunk seams; that costs tokens but never correctness, and keeping the
assembler a pure store read means no re-fetch of the original tree.

Budget: ``longctx_token_budget()`` derives the prompt allowance from the
serving context window (minus the answer allowance) unless
LONGCTX_TOKEN_BUDGET pins it.  ``assemble_repo`` stops adding files once
the estimate crosses the budget and marks the result truncated — the agent
treats an over-budget assembly as "fall back to chunk RAG", not as a hard
error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.store.base import VectorStore
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# chars-per-token planning ratio for code+prose mixes.  Deliberately below
# the usual ~4 so the estimate over-counts tokens: an assembly that passes
# this gate fits the real tokenizer with margin, and the serving engine
# still hard-truncates as the backstop.
CHARS_PER_TOKEN = 3.5

# a single store read's row cap; repos past this many chunks are not
# long-context material anyway
MAX_CHUNKS = 4096


@dataclass
class AssembledRepo:
    repo: str
    text: str  # "### <path>" headers + chunks in line order
    files: int
    chunks: int
    token_estimate: int
    truncated: bool  # budget hit before every file made it in


def longctx_token_budget() -> int:
    """Prompt-token allowance for an assembled repo.  Explicit
    LONGCTX_TOKEN_BUDGET wins; otherwise the serving context window minus
    the configured answer allowance (QWEN_MAX_OUTPUT), floored so a tiny
    dev window still admits something."""
    s = get_settings()
    if s.longctx_token_budget > 0:
        return s.longctx_token_budget
    return max(1024, s.context_window - s.qwen_max_output)


def _span_start(md: Mapping[str, str]) -> int:
    span = md.get("span", "")
    head = span.split("-", 1)[0]
    return int(head) if head.isdigit() else 0


def assemble_repo(
    store: VectorStore,
    repo: str,
    namespace: str | None = None,
    token_budget: int | None = None,
) -> AssembledRepo | None:
    """Reassemble ``repo``'s ingested chunks into one ordered document.

    Returns None when the store has no chunks for the repo (unknown name,
    or ingested before the chunk scope existed) — the agent falls back to
    the normal RAG loop.  ``token_budget`` defaults to
    ``longctx_token_budget()``; assembly is whole-file granular, so the
    budget check runs between files and the flag, not an exception,
    reports overflow."""
    s = get_settings()
    budget = token_budget if token_budget is not None else longctx_token_budget()
    flt: dict[str, str] = {"repo": repo}
    if namespace:
        flt["namespace"] = namespace
    docs = store.find_by_metadata(s.scope_tables["chunk"], flt, limit=MAX_CHUNKS)
    if not docs:
        return None

    by_file: dict[str, list] = {}
    for d in docs:
        by_file.setdefault(d.metadata.get("file_path", ""), []).append(d)
    # module -> path ordering mirrors the ingest hierarchy; chunks inside a
    # file go back into line-span order
    ordered = sorted(
        by_file.items(),
        key=lambda kv: (kv[1][0].metadata.get("module", ""), kv[0]),
    )

    parts: list[str] = []
    chars = 0
    files = chunks = 0
    truncated = False
    for path, file_docs in ordered:
        file_docs.sort(key=lambda d: _span_start(d.metadata))
        block = f"### {path}\n" + "\n".join(d.text for d in file_docs)
        if parts and (chars + len(block)) / CHARS_PER_TOKEN > budget:
            truncated = True
            break
        parts.append(block)
        chars += len(block) + 2  # the joining blank line
        files += 1
        chunks += len(file_docs)

    text = "\n\n".join(parts)
    est = int(len(text) / CHARS_PER_TOKEN)
    if truncated:
        logger.info(
            "assemble_repo(%s): budget %d hit at %d/%d files (~%d tokens)",
            repo, budget, files, len(ordered), est,
        )
    return AssembledRepo(
        repo=repo, text=text, files=files, chunks=chunks,
        token_estimate=est, truncated=truncated,
    )
