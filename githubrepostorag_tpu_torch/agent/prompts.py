"""Prompt builders for the agent loop; a copy of
``githubrepostorag_tpu/agent/prompts.py``.  Functional parity with the
reference's inline prompts (agent_graph.py:198-516) in this framework's
five-scope vocabulary (catalog/repo/module/file/chunk instead of
project/package/file/code)."""

from __future__ import annotations

import json

from githubrepostorag_tpu_torch.retrieval.retrievers import SCOPE_LADDER as SCOPES


def plan_prompt(query: str) -> str:
    return (
        "Pick the retrieval scope that best fits this question about a code "
        "knowledge base. Scopes, from broadest to narrowest: catalog (what "
        "projects exist), repo (whole-repository summaries), module "
        "(directory-level summaries), file (per-file summaries), chunk "
        "(actual code fragments).\n"
        'Reply with JSON only: {"scope": "catalog|repo|module|file|chunk", '
        '"filters": {"repo": "...", "module": "...", "topics": "..."}} '
        "(filters optional).\n"
        f"Question: {query}\n"
        "JSON:"
    )


def expansion_prompt(query: str, repo: str | None, scope: str | None) -> str:
    ctx = ""
    if repo:
        ctx += f" Repository under discussion: {repo}."
    if scope:
        ctx += f" Current search scope: {scope}."
    return (
        "Produce 3-4 alternative search queries that could surface the same "
        "information as the question below — use technical synonyms, related "
        "subsystem names, and rephrasings. Reply with a JSON array of "
        "strings only.\n"
        f"Question: {query}{ctx}\n"
        "JSON array:"
    )


def judge_prompt(query: str, inventory: list[dict], current_scope: str) -> str:
    deeper = SCOPES[min(SCOPES.index(current_scope) + 1, len(SCOPES) - 1)] if current_scope in SCOPES else "chunk"
    return (
        "Assess whether the retrieved items below can answer the question. "
        "Weigh both the metadata and the content previews. Reply with JSON "
        'only: {"coverage": 0.0-1.0, "needs_more": true|false, '
        '"suggest_filters": {"repo": "...", "module": "...", "topics": "..."}, '
        '"stage_down": "<a NARROWER scope than the current one, or null>", '
        '"rewrite": "optional better query"}.\n'
        f"Current scope: {current_scope} (narrower scopes: "
        f"{', '.join(SCOPES[SCOPES.index(current_scope) + 1:]) if current_scope in SCOPES else deeper} )\n"
        f"Question: {query}\n"
        f"Retrieved items: {json.dumps(inventory, ensure_ascii=False)}\n"
        "JSON:"
    )


def rewrite_prompt(query: str, context: str) -> str:
    return (
        f"Rephrase this question about a codebase so a vector search finds "
        f"more specific matches: '{query}'"
        + (f" (context: {context})" if context else "")
        + "\nReply with the rephrased question only:"
    )


def synthesis_prompt(query: str, blocks: list[str], overview: bool) -> str:
    if overview:
        style = (
            "You are a senior engineer summarizing a code knowledge base. "
            "Build a thorough answer from the context blocks, citing them as "
            "[1], [2], ... . When asked what projects or components exist, "
            "describe every one visible in the context."
        )
    else:
        style = (
            "You are a senior engineer answering a question about a "
            "codebase. Ground every claim in the context blocks and cite "
            "them as [1], [2], ... . If the context lacks the answer, say "
            "which repo or module likely contains it."
        )
    return f"{style}\n\nQuestion: {query}\n\nContext:\n" + "\n\n".join(blocks) + "\n\nAnswer:"


def longctx_synthesis_prompt(query: str, repo: str, repo_text: str) -> str:
    """Whole-repo answer mode: the assembled repository (every ingested
    chunk, file-ordered — retrieval/assembler.py) IS the context, so the
    style asks for cross-cutting structure instead of block citations."""
    style = (
        f"You are a senior engineer who has just read the ENTIRE {repo} "
        "repository, reproduced below with ### file headers. Answer from "
        "the whole codebase: describe how the pieces fit together, citing "
        "files by path where it helps."
    )
    return (
        f"{style}\n\nQuestion: {query}\n\nRepository {repo}:\n{repo_text}"
        "\n\nAnswer:"
    )


def encouraging_synthesis_prompt(query: str, blocks: list[str]) -> str:
    style = (
        "You are a helpful engineer. The context below genuinely contains "
        "relevant material — use it. Describe what the context shows rather "
        "than declining to answer, citing blocks as [1], [2], ... ."
    )
    return f"{style}\n\nQuestion: {query}\n\nContext:\n" + "\n\n".join(blocks) + "\n\nAnswer:"
