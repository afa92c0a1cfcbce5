"""Document filtering + transformation + language tagging; a copy of
``githubrepostorag_tpu/ingest/preprocess.py``.

Rebuild of preprocess_service.py / transform_service.py: skip-lists for
binary/data/license files, notebook cleaning (content-based), language
tagging from extensions, and the service-vs-standalone component heuristic.
"""

from __future__ import annotations

import os
import re

from githubrepostorag_tpu_torch.config import EXTENSION_TO_LANGUAGE
from githubrepostorag_tpu_torch.ingest.notebook import process_notebook_content
from githubrepostorag_tpu_torch.ingest.types import SourceDoc
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# transform_service.py:10-37 skip-lists
SKIP_EXTENSIONS = {
    ".png", ".jpg", ".jpeg", ".gif", ".bmp", ".ico", ".svg", ".webp",
    ".pdf", ".zip", ".tar", ".gz", ".7z", ".rar", ".jar", ".war",
    ".class", ".pyc", ".pyo", ".so", ".dll", ".dylib", ".exe", ".bin",
    ".woff", ".woff2", ".ttf", ".eot", ".otf", ".mp3", ".mp4", ".avi",
    ".mov", ".parquet", ".arrow", ".pkl", ".pickle", ".npy", ".npz",
    ".h5", ".hdf5", ".db", ".sqlite", ".lock",
}
SKIP_DATA_JSON_NAMES = {
    "package-lock.json", "yarn.lock", "poetry.lock", "pipfile.lock",
    "composer.lock", "cargo.lock",
}
SKIP_BASENAMES = {
    "license", "license.txt", "license.md", "copying", "notice",
    "changelog", "changelog.md", "changelog.txt", "authors", "contributors",
    ".gitignore", ".gitattributes", ".ds_store",
}
MAX_FILE_CHARS = 400_000  # generated/minified monsters are skipped

_MANIFEST_NAMES = {
    "dockerfile", "docker-compose.yml", "docker-compose.yaml",
    "openapi.yaml", "openapi.json", "swagger.yaml", "swagger.json",
}


def should_skip(path: str, text: str | None = None) -> bool:
    base = os.path.basename(path).lower()
    _, ext = os.path.splitext(base)
    if ext in SKIP_EXTENSIONS:
        return True
    if base in SKIP_DATA_JSON_NAMES or base in SKIP_BASENAMES:
        return True
    if text is not None:
        if len(text) > MAX_FILE_CHARS:
            return True
        if "\x00" in text[:4096]:  # binary sniff
            return True
    return False


def detect_language(path: str) -> str | None:
    base = os.path.basename(path).lower()
    if base == "dockerfile" or base.startswith("dockerfile."):
        return "dockerfile"
    if base.startswith("docker-compose"):
        return "yaml"
    _, ext = os.path.splitext(base)
    return EXTENSION_TO_LANGUAGE.get(ext)


def infer_component_kind(docs: list[SourceDoc], dev_force_standalone: bool = False) -> str:
    """'service' vs 'standalone' (transform_service.py:112-127): notebooks
    without a service manifest/openapi spec indicate a standalone analysis
    repo; DEV_MODE forces standalone."""
    if dev_force_standalone:
        return "standalone"
    paths = {os.path.basename(d.path).lower() for d in docs}
    has_manifest = bool(paths & _MANIFEST_NAMES)
    has_notebook = any(d.path.endswith(".ipynb") for d in docs)
    if has_notebook and not has_manifest:
        return "standalone"
    return "service"


def prepare_repo_documents(
    docs: list[SourceDoc], dev_force_standalone: bool = False
) -> list[SourceDoc]:
    """Filter -> transform -> language-tag.  Notebook cleaning is
    content-based (the reference's path-based version never ran in the
    GitHub flow — SURVEY.md Appendix A)."""
    kind = infer_component_kind(docs, dev_force_standalone)
    out: list[SourceDoc] = []
    for doc in docs:
        if should_skip(doc.path, doc.text):
            continue
        text = doc.text
        language = detect_language(doc.path)
        if doc.path.endswith(".ipynb"):
            try:
                text = process_notebook_content(text, language="python")
                language = "python"
            except ValueError:
                logger.warning("notebook %s unparseable; keeping raw text", doc.path)
        if not text.strip():
            continue
        md = dict(doc.metadata)
        md["file_path"] = doc.path
        if language:
            md["language"] = language
        md["component_kind"] = kind
        out.append(SourceDoc(path=doc.path, text=text, metadata=md))
    return out
