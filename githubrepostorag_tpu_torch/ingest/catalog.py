"""Catalog (L0) document: the routing-level description of a component; a
copy of ``githubrepostorag_tpu/ingest/catalog.py``.

Rebuild of catalog_builder.py / catalog_service.py: an LLM judges README
quality GOOD/BAD (:8-31); a BAD/missing README triggers generation of a
project summary from key files (:34-80) or from code summaries with a
tech-stack list derived from file extensions (:140-194).
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Sequence

from githubrepostorag_tpu_torch.config import EXTENSION_TO_LANGUAGE
from githubrepostorag_tpu_torch.ingest.types import Node, SourceDoc
from githubrepostorag_tpu_torch.llm import LLM
from githubrepostorag_tpu_torch.utils.json_utils import truncate
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

KEY_FILE_NAMES = (
    "main.py", "app.py", "__main__.py", "index.js", "index.ts", "main.go",
    "main.rs", "setup.py", "pyproject.toml", "package.json", "pom.xml",
    "build.gradle", "makefile", "dockerfile",
)
KEY_FILE_SAMPLE = 500  # chars per key file (catalog_builder.py:49)


def _tech_stack(docs: Sequence[SourceDoc]) -> list[str]:
    counts = Counter()
    for d in docs:
        _, ext = os.path.splitext(d.path.lower())
        lang = EXTENSION_TO_LANGUAGE.get(ext)
        if lang:
            counts[lang] += 1
    return [lang for lang, _ in counts.most_common(6)]


def judge_readme_quality(llm: LLM, readme_text: str) -> bool:
    """True = GOOD (usable as the catalog description)."""
    if not readme_text or len(readme_text.strip()) < 80:
        return False
    raw = llm.complete(
        "Is this README a useful description of what the project does? "
        "Answer GOOD or BAD only.\n\n"
        f"{truncate(readme_text, 4000)}\n\nVerdict:",
        max_tokens=8,
    )
    verdict = raw.strip().upper()
    if "GOOD" in verdict:
        return True
    if "BAD" in verdict:
        return False
    # unparseable verdict: a long README is probably fine
    return len(readme_text) > 500


def build_catalog_node(
    llm: LLM,
    docs: Sequence[SourceDoc],
    chunk_nodes: Sequence[Node],
    common: dict,
) -> Node:
    readmes = [(d.path, d.text) for d in docs if os.path.basename(d.path).lower().startswith("readme")]
    tech = _tech_stack(docs)

    text = ""
    if readmes and judge_readme_quality(llm, readmes[0][1]):
        text = truncate(readmes[0][1], 6000)
    if not text:
        key_files = [
            d for d in docs if os.path.basename(d.path).lower() in KEY_FILE_NAMES
        ][:8]
        if key_files:
            samples = "\n\n".join(
                f"## {d.path}\n{truncate(d.text, KEY_FILE_SAMPLE)}" for d in key_files
            )
            text = llm.complete(
                "Describe what this project does based on these key files: "
                "purpose, entry points, technologies. Final answer only.\n\n"
                f"{samples}\n\nDescription:",
                max_tokens=512,
            ).strip()
    if not text or text.lower().startswith("error"):
        summaries = [
            n.metadata.get("summary", "") for n in chunk_nodes if n.metadata.get("summary")
        ][:10]
        if summaries:
            text = llm.complete(
                "Describe this project from these code summaries. Final answer "
                "only.\n\n" + "\n".join(f"- {s}" for s in summaries) + "\n\nDescription:",
                max_tokens=512,
            ).strip()
    if not text or text.lower().startswith("error"):
        text = f"Repository {common.get('repo', '?')} using {', '.join(tech) or 'unknown stack'}."

    md = dict(common)
    md["scope"] = "catalog"
    if tech:
        md["tech_stack"] = ", ".join(tech)
        md.setdefault("topics", tech[0])
    return Node(text=text, metadata=md)
