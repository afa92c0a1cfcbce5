"""Jupyter notebook cleaner; a copy of
``githubrepostorag_tpu/ingest/notebook.py``.

Behavioral rebuild of ingest/src/app/services/jupyter_notebook_handling.py
with its path bug fixed: the reference opened the repo-relative path from
the local filesystem (jupyter_notebook_handling.py:130), which always fails
in the GitHub-reader flow and silently falls back to raw JSON — here the
processor takes the notebook *content*, so the cell filtering actually runs.

Kept semantics: setup cells (pip/conda/apt installs, fs ops, magics) are
dropped; log-heavy outputs (ANSI codes, long uniform lines, timestamp/
loglevel/progress patterns) are dropped; markdown + code + meaningful
outputs become fenced blocks.
"""

from __future__ import annotations

import json
import re

_SETUP_PATTERNS = [
    re.compile(p, re.IGNORECASE)
    for p in (
        r"^\s*[!%]?\s*pip3?\s+install\b",
        r"^\s*[!%]?\s*conda\s+install\b",
        r"^\s*!\s*apt(-get)?\s+install\b",
        r"^\s*!\s*(mkdir|rm|cp|mv|wget|curl|unzip|tar)\b",
        r"^\s*%%?(bash|sh|capture|time|timeit|writefile|cd)\b",
        r"^\s*%\s*(load_ext|matplotlib|env|cd)\b",
    )
]

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")
_LOGLINE_RE = re.compile(
    r"(\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}|\b(DEBUG|INFO|WARNING|ERROR|CRITICAL)\b"
    r"|\d+%\|[█▏▎▍▌▋▊▉ ]*\||\b\d+/\d+\s*\[[0-9:<,\s]*\])"
)
_TABLE_MARKERS = ("|---", "+----", "</table>", "\t")


def _is_setup_cell(source: str) -> bool:
    lines = [ln for ln in source.splitlines() if ln.strip()]
    if not lines:
        return False
    setup_lines = sum(1 for ln in lines if any(p.search(ln) for p in _SETUP_PATTERNS))
    return setup_lines > 0 and setup_lines >= len(lines) / 2


def _is_log_heavy(output_text: str) -> bool:
    text = _ANSI_RE.sub("", output_text)
    if len(text) > 500 and not any(m in text for m in _TABLE_MARKERS):
        return True
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        return False
    loggy = sum(1 for ln in lines if _LOGLINE_RE.search(ln))
    return loggy / len(lines) > 0.3


def _output_text(output: dict) -> str:
    if output.get("output_type") == "stream":
        data = output.get("text", "")
        return "".join(data) if isinstance(data, list) else str(data)
    data = output.get("data", {})
    text = data.get("text/plain", "")
    return "".join(text) if isinstance(text, list) else str(text)


def process_notebook_content(content: str, language: str = "python") -> str:
    """Notebook JSON -> cleaned markdown+code document.  Raises ValueError
    on unparseable content (caller falls back to raw text, mirroring
    transform_service.py:101-103)."""
    try:
        nb = json.loads(content)
        cells = nb["cells"]
    except (json.JSONDecodeError, KeyError, TypeError) as exc:
        raise ValueError(f"not a notebook: {exc}") from exc

    parts: list[str] = []
    for cell in cells:
        src = cell.get("source", "")
        src = "".join(src) if isinstance(src, list) else str(src)
        kind = cell.get("cell_type")
        if kind == "markdown":
            if src.strip():
                parts.append(src.strip())
        elif kind == "code":
            if not src.strip() or _is_setup_cell(src):
                continue
            parts.append(f"```{language}\n{src.strip()}\n```")
            for output in cell.get("outputs", []):
                text = _output_text(output).strip()
                if text and not _is_log_heavy(text):
                    parts.append(f"Output:\n```\n{text[:1000]}\n```")
    return "\n\n".join(parts)
