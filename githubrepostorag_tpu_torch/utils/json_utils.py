"""Robust parsing of LLM output; a copy of
``githubrepostorag_tpu/utils/json_utils.py``.  These fallbacks are
load-bearing for answer quality (SURVEY.md §7 'hardest parts' #5): scope
planning, judging, and selector prompts all consume model JSON that is
frequently malformed.

Behavioral parity targets in the reference:
  - markdown-fence stripping + selector-choice extraction:
    rag_worker/src/worker/services/qwen_llm.py:54-102
  - chain-of-thought sanitization (<think> blocks, role markers, chatty
    prefixes): ingest/src/app/llm_init.py:36-48
"""

from __future__ import annotations

import json
import re
from typing import Any

_FENCE_RE = re.compile(r"```(?:json|javascript|python)?\s*(.*?)\s*```", re.DOTALL)
_THINK_RE = re.compile(r"<think>.*?</think>", re.DOTALL | re.IGNORECASE)
_ROLE_RE = re.compile(r"^\s*(assistant|system|user)\s*[:>]\s*", re.IGNORECASE | re.MULTILINE)
_CHATTY_RE = re.compile(
    r"^\s*(sure[,!]?|certainly[,!]?|of course[,!]?|here(?:'s| is) (?:the|your)\b[^\n]*[:.]|"
    r"okay[,!]?|let me\b[^\n]*[:.])\s*",
    re.IGNORECASE,
)


def strip_fences(text: str) -> str:
    """If the text wraps its payload in a markdown code fence, unwrap it."""
    m = _FENCE_RE.search(text)
    return m.group(1) if m else text


def sanitize_llm_text(text: str) -> str:
    """Remove chain-of-thought blocks, role markers, and chatty prefixes."""
    out = _THINK_RE.sub("", text)
    out = _ROLE_RE.sub("", out)
    out = _CHATTY_RE.sub("", out)
    return out.strip()


def extract_json(text: str, default: Any = None) -> Any:
    """Best-effort extraction of a JSON object/array from model text.

    Order: direct parse -> fenced block -> first balanced {...} or [...]
    substring -> default.
    """
    if not text:
        return default
    for candidate in (text.strip(), strip_fences(text).strip()):
        try:
            return json.loads(candidate)
        except (json.JSONDecodeError, ValueError):
            pass
    snippet = _first_balanced(text)
    if snippet is not None:
        try:
            return json.loads(snippet)
        except (json.JSONDecodeError, ValueError):
            pass
    return default


def _first_balanced(text: str) -> str | None:
    for open_ch, close_ch in (("{", "}"), ("[", "]")):
        start = text.find(open_ch)
        if start == -1:
            continue
        depth = 0
        in_str = False
        esc = False
        for i in range(start, len(text)):
            ch = text[i]
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
                continue
            if ch == '"':
                in_str = True
            elif ch == open_ch:
                depth += 1
            elif ch == close_ch:
                depth -= 1
                if depth == 0:
                    return text[start : i + 1]
    return None


_CHOICE_PATTERNS = [
    re.compile(r"(?:choice|answer|option|select(?:ion)?)\s*(?:is|:)?\s*\(?(\d+)\)?", re.IGNORECASE),
    re.compile(r"^\s*\(?(\d+)\)?\s*[.)]?\s*$", re.MULTILINE),
]


def extract_choice(text: str, default: str = "1") -> str:
    """Extract a numeric choice from a selector-prompt response.

    Mirrors the reference's cascade (qwen_llm.py:54-102): explicit
    'choice is N' phrasing -> bare number line -> JSON {'choice': N} ->
    first digit anywhere -> default '1'.
    """
    if not text:
        return default
    cleaned = strip_fences(sanitize_llm_text(text))
    for pat in _CHOICE_PATTERNS:
        m = pat.search(cleaned)
        if m:
            return m.group(1)
    parsed = extract_json(cleaned)
    if isinstance(parsed, dict):
        for key in ("choice", "answer", "selection", "option"):
            if key in parsed:
                try:
                    return str(int(parsed[key]))
                except (TypeError, ValueError):
                    pass
    m = re.search(r"\d+", cleaned)
    if m:
        return m.group(0)
    return default


def truncate(text: str, limit: int) -> str:
    """Budgeted truncation used throughout the pipeline (the reference caps
    context instead of scaling it — SURVEY.md §5.7)."""
    if len(text) <= limit:
        return text
    return text[:limit]
