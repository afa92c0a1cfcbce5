"""Language-aware code chunking + text chunking; a copy of
``githubrepostorag_tpu/ingest/chunker.py``.

Fills the role of the reference's tree-sitter CodeSplitter
(langauge_detector.py:76-137: chunk_lines=200, max_chars=4000, overlap 10
lines, with a SentenceSplitter(4000/200) fallback).  Three AST/boundary
backends behind one ``split_code`` seam, resolved per call:

  - ``treesitter`` — real tree-sitter grammars via the
    ``tree_sitter_language_pack`` C library when installed (the reference's
    idiomatic choice, kept per SURVEY.md §2.2); top-level AST node starts
    become chunk boundaries.
  - ``pyast``      — stdlib ``ast`` for Python sources: true AST boundaries
    (top-level statements + class-body methods, decorators glued) with zero
    native deps.
  - ``regex``      — per-language-family unindented-definition patterns;
    the documented fallback, mirroring create_code_splitter_safely's
    SentenceSplitter degradation (langauge_detector.py:115-137).

All backends feed the same greedy packer under the same line/char budgets,
so chunk semantics (200 lines / 4000 chars / 10-line overlap) are backend
-independent.  Text chunking mirrors the catalog pipeline's
SentenceSplitter(1500/100) (catalog_pipeline.py:17-18): paragraph-first
packing with character budgets and overlap.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache

CODE_CHUNK_LINES = 200
CODE_CHUNK_CHARS = 4000
CODE_OVERLAP_LINES = 10
TEXT_CHUNK_CHARS = 1500
TEXT_OVERLAP_CHARS = 100
FALLBACK_CHUNK_CHARS = 4000
FALLBACK_OVERLAP_CHARS = 200


@dataclass
class Chunk:
    text: str
    start_line: int  # 1-based inclusive
    end_line: int

    @property
    def span(self) -> str:
        return f"{self.start_line}-{self.end_line}"


# Top-level definition starters per language family (match at indent 0).
_BOUNDARY_PATTERNS: dict[str, re.Pattern] = {
    "python": re.compile(r"^(def |class |async def |@)"),
    "javascript": re.compile(
        r"^(function\b|class\b|const\s+\w+\s*=\s*(async\s*)?(\(|function)|export\b|async function\b)"
    ),
    "c_like": re.compile(
        r"^(?!\s)(?:[\w:<>,~&*\s]+\([^;]*\)\s*\{?\s*$|class\b|struct\b|namespace\b|template\b|"
        r"(public|private|protected|static|final|abstract)\b)"
    ),
    "go": re.compile(r"^(func\b|type\b|var\b|const\b)"),
    "rust": re.compile(r"^(fn\b|pub\b|impl\b|struct\b|enum\b|trait\b|mod\b|macro_rules!)"),
    "ruby": re.compile(r"^(def\b|class\b|module\b)"),
    "generic": re.compile(r"^\S"),  # any unindented line
}

_FAMILY = {
    "python": "python",
    "javascript": "javascript",
    "typescript": "javascript",
    "java": "c_like",
    "cpp": "c_like",
    "c": "c_like",
    "c_sharp": "c_like",
    "php": "c_like",
    "scala": "c_like",
    "kotlin": "c_like",
    "swift": "c_like",
    "go": "go",
    "rust": "rust",
    "ruby": "ruby",
}


def _regex_boundaries(lines: list[str], language: str | None) -> list[int]:
    """Indices where a new top-level unit starts (regex fallback backend)."""
    pattern = _BOUNDARY_PATTERNS.get(_FAMILY.get(language or "", ""), _BOUNDARY_PATTERNS["generic"])
    bounds = [0]
    for i, line in enumerate(lines[1:], start=1):
        if pattern.match(line):
            # decorators glue to the following def (python)
            if language == "python" and lines[i].startswith("@"):
                bounds.append(i)
            elif language == "python" and i > 0 and lines[i - 1].startswith("@"):
                continue
            else:
                bounds.append(i)
    return sorted(set(bounds))


def _pyast_boundaries(text: str, lines: list[str]) -> list[int] | None:
    """True-AST boundaries for Python via the stdlib parser: every top-level
    statement starts a unit (decorators glued to their def), and class-body
    functions add sub-boundaries so large classes pack method-by-method
    instead of being window-split.  Returns None on syntax errors (py2 code,
    templates) so the caller degrades to the regex backend."""
    import ast

    try:
        tree = ast.parse(text)
    except (SyntaxError, ValueError):
        return None
    bounds = {0}

    def start_line(node) -> int:
        deco = getattr(node, "decorator_list", None)
        if deco:
            return min(d.lineno for d in deco) - 1
        return node.lineno - 1

    for node in tree.body:
        bounds.add(start_line(node))
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    bounds.add(start_line(item))
    return sorted(b for b in bounds if 0 <= b < len(lines))


@lru_cache(maxsize=64)
def _treesitter_parser(language: str):
    """A tree-sitter parser for ``language``, or None when the C library /
    grammar pack isn't installed (it isn't in this image; deployments that
    add ``tree-sitter-language-pack`` get real grammars with no code
    change)."""
    try:  # pragma: no cover - exercised only when the native lib exists
        from tree_sitter_language_pack import get_parser

        return get_parser(language)
    except Exception:  # noqa: BLE001 - any failure means "backend unavailable"
        return None


def _treesitter_boundaries(text: str, lines: list[str], language: str) -> list[int] | None:
    parser = _treesitter_parser(language)
    if parser is None:
        return None
    try:  # pragma: no cover - native-lib only
        tree = parser.parse(text.encode("utf-8"))
    except Exception:  # noqa: BLE001
        return None
    bounds = {0}
    for node in tree.root_node.children:  # pragma: no cover - native-lib only
        bounds.add(node.start_point[0])
    return sorted(b for b in bounds if 0 <= b < len(lines))


def _boundaries(text: str, lines: list[str], language: str | None, backend: str) -> list[int]:
    """Resolve the chunking backend: explicit name, or ``auto`` =
    treesitter -> pyast (python) -> regex."""
    if backend in ("auto", "treesitter") and language:
        ts = _treesitter_boundaries(text, lines, language)
        if ts is not None:
            return ts
        if backend == "treesitter":
            raise RuntimeError(f"tree-sitter backend unavailable for {language!r}")
    if backend in ("auto", "pyast") and language == "python":
        py = _pyast_boundaries(text, lines)
        if py is not None:
            return py
        if backend == "pyast":
            return _regex_boundaries(lines, language)  # documented degradation
    return _regex_boundaries(lines, language)


def split_code(
    text: str,
    language: str | None = None,
    max_lines: int = CODE_CHUNK_LINES,
    max_chars: int = CODE_CHUNK_CHARS,
    overlap_lines: int = CODE_OVERLAP_LINES,
    backend: str = "auto",
) -> list[Chunk]:
    lines = text.splitlines()
    if not lines:
        return []
    bounds = _boundaries(text, lines, language, backend)
    bounds.append(len(lines))

    # segments between structural boundaries
    segments = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1) if bounds[i] < bounds[i + 1]]

    chunks: list[Chunk] = []
    cur_start: int | None = None
    cur_lines: list[str] = []

    def flush(end_line: int) -> None:
        nonlocal cur_start, cur_lines
        if cur_start is not None and cur_lines:
            chunks.append(Chunk("\n".join(cur_lines), cur_start + 1, end_line))
        cur_start, cur_lines = None, []

    for seg_start, seg_end in segments:
        seg = lines[seg_start:seg_end]
        seg_chars = sum(len(l) + 1 for l in seg)
        cur_chars = sum(len(l) + 1 for l in cur_lines)

        if len(seg) > max_lines or seg_chars > max_chars:
            # oversized single unit: flush current, hard-split with overlap
            flush(seg_start)
            pos = 0
            while pos < len(seg):
                window = seg[pos : pos + max_lines]
                while sum(len(l) + 1 for l in window) > max_chars and len(window) > 1:
                    window = window[: len(window) // 2]
                chunks.append(
                    Chunk("\n".join(window), seg_start + pos + 1, seg_start + pos + len(window))
                )
                if pos + len(window) >= len(seg):
                    break
                pos += max(len(window) - overlap_lines, 1)
            continue

        if cur_lines and (len(cur_lines) + len(seg) > max_lines or cur_chars + seg_chars > max_chars):
            flush(seg_start)
        if cur_start is None:
            cur_start = seg_start
        cur_lines.extend(seg)
    flush(len(lines))
    return [c for c in chunks if c.text.strip()]


def split_text(
    text: str,
    chunk_chars: int = TEXT_CHUNK_CHARS,
    overlap_chars: int = TEXT_OVERLAP_CHARS,
) -> list[Chunk]:
    """Paragraph-first text splitting with char budget + overlap."""
    if not text.strip():
        return []
    paragraphs = re.split(r"\n\s*\n", text)
    chunks: list[str] = []
    cur = ""
    for para in paragraphs:
        if not para.strip():
            continue
        if cur and len(cur) + len(para) + 2 > chunk_chars:
            chunks.append(cur)
            cur = cur[-overlap_chars:] if overlap_chars else ""
        cur = f"{cur}\n\n{para}" if cur else para
        while len(cur) > chunk_chars:
            chunks.append(cur[:chunk_chars])
            cur = cur[chunk_chars - overlap_chars :]
    if cur.strip():
        chunks.append(cur)
    return [Chunk(c.strip(), 0, 0) for c in chunks if c.strip()]


def split_document(text: str, language: str | None) -> list[Chunk]:
    """Dispatch: code languages get the structural splitter, prose gets the
    fallback splitter (4000/200)."""
    if language and language in _FAMILY or language in ("bash", "sql", "dockerfile"):
        return split_code(text, language)
    if language in ("markdown", "yaml", "json", "toml", "xml", "html", "css"):
        return split_text(text, FALLBACK_CHUNK_CHARS, FALLBACK_OVERLAP_CHARS)
    return split_text(text, FALLBACK_CHUNK_CHARS, FALLBACK_OVERLAP_CHARS)
