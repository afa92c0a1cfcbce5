"""Bottom-up hierarchy summaries: file (L3) -> module (L2) -> repo (L1); a
copy of ``githubrepostorag_tpu/ingest/hierarchy.py``.

Rebuild of hierarchy_summary_service.py: file summaries concat their chunks
up to 25 000 chars (:31), module summaries cover a top-level directory with
at most 40 files (:107), the single repo overview reads up to 3 READMEs and
10 module summaries (:166); every roll-up node records ``rollup_of``
(constituent node ids) and ``rollup_count``.  All summary calls go through
the batched LLM path.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Sequence

from githubrepostorag_tpu_torch.ingest.extractors import _batch_complete
from githubrepostorag_tpu_torch.ingest.types import Node
from githubrepostorag_tpu_torch.llm import LLM
from githubrepostorag_tpu_torch.utils.json_utils import truncate
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

FILE_INPUT_BUDGET = 25_000
MODULE_MAX_FILES = 40
REPO_MAX_READMES = 3
REPO_MAX_MODULES = 10


def top_directory(path: str, depth: int = 1) -> str:
    parts = [p for p in path.split("/") if p]
    if len(parts) <= depth:
        return "(root)"
    return "/".join(parts[:depth])


def _rollup_metadata(base: dict, scope: str, constituents: Sequence[Node]) -> dict:
    md = dict(base)
    md["scope"] = scope
    md["rollup_of"] = ",".join(n.stable_id() for n in constituents[:50])
    md["rollup_count"] = str(len(constituents))
    return md


def build_file_nodes(llm: LLM, chunk_nodes: Sequence[Node], common: dict) -> list[Node]:
    by_file: dict[str, list[Node]] = defaultdict(list)
    for node in chunk_nodes:
        fp = node.metadata.get("file_path")
        if fp:
            by_file[fp].append(node)

    files = sorted(by_file)
    prompts = []
    for fp in files:
        joined = "\n\n".join(n.text for n in by_file[fp])
        prompts.append(
            "Write a 200-300 word technical summary of this source file: its "
            "purpose, key definitions, and how it fits the project. Final "
            f"answer only.\n\nFile: {fp}\n\n{truncate(joined, FILE_INPUT_BUDGET)}\n\nSummary:"
        )
    responses = _batch_complete(llm, prompts, max_tokens=512)

    out = []
    for fp, summary in zip(files, responses):
        text = (summary or "").strip()
        if not text or text.lower().startswith("error"):
            # degrade to the leading chunk text rather than dropping the level
            text = truncate(by_file[fp][0].text, 1000)
        md = _rollup_metadata(common, "file", by_file[fp])
        md["file_path"] = fp
        md["module"] = top_directory(fp)
        md["language"] = by_file[fp][0].metadata.get("language", "")
        out.append(Node(text=text, metadata=md))
    return out


def build_module_nodes(llm: LLM, file_nodes: Sequence[Node], common: dict) -> list[Node]:
    by_module: dict[str, list[Node]] = defaultdict(list)
    for node in file_nodes:
        by_module[node.metadata.get("module", "(root)")].append(node)

    modules = sorted(by_module)
    prompts = []
    for mod in modules:
        files = by_module[mod][:MODULE_MAX_FILES]
        listing = "\n\n".join(
            f"### {n.metadata.get('file_path', '?')}\n{truncate(n.text, 1200)}" for n in files
        )
        prompts.append(
            "Write a technical summary of this module (directory) from its "
            "file summaries: responsibilities, main components, relationships. "
            f"Final answer only.\n\nModule: {mod}\n\n{listing}\n\nSummary:"
        )
    responses = _batch_complete(llm, prompts, max_tokens=512)

    out = []
    for mod, summary in zip(modules, responses):
        text = (summary or "").strip()
        if not text or text.lower().startswith("error"):
            text = truncate("\n".join(n.text for n in by_module[mod][:3]), 1500)
        md = _rollup_metadata(common, "module", by_module[mod])
        md["module"] = mod
        out.append(Node(text=text, metadata=md))
    return out


def build_repo_node(
    llm: LLM,
    module_nodes: Sequence[Node],
    readmes: Sequence[tuple[str, str]],
    common: dict,
) -> Node:
    readme_part = "\n\n".join(
        f"## {path}\n{truncate(text, 4000)}" for path, text in list(readmes)[:REPO_MAX_READMES]
    )
    module_part = "\n\n".join(
        f"### {n.metadata.get('module')}\n{truncate(n.text, 1500)}"
        for n in list(module_nodes)[:REPO_MAX_MODULES]
    )
    prompt = (
        "Write a comprehensive overview of this repository: what it does, its "
        "architecture, main modules, and technologies. Final answer only.\n\n"
        f"READMEs:\n{readme_part or '(none)'}\n\nModule summaries:\n{module_part or '(none)'}"
        "\n\nOverview:"
    )
    text = llm.complete(prompt, max_tokens=768).strip()
    if not text or text.lower().startswith("error"):
        text = truncate(readme_part or module_part or common.get("repo", "repository"), 2000)
    md = _rollup_metadata(common, "repo", list(module_nodes))
    return Node(text=text, metadata=md)
