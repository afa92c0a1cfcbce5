"""Metadata extractors: summary / title / keywords per chunk; a copy of
``githubrepostorag_tpu/ingest/extractors.py``.

The reference runs LlamaIndex SummaryExtractor, TitleExtractor(nodes=5), and
KeywordExtractor(keywords=10) sequentially, each making one blocking HTTP
call per chunk (code_pipeline_service.py:13-54) — the dominant ingest cost
(SURVEY.md §3.2).  Here each extractor builds ALL its prompts up front and
submits them to the LLM layer as one batch: on the in-tree engine that means
continuous-batched prefill-heavy inference on the card (BASELINE config
#4: kernel A for the prompts, kernel B for the decode steps), not a
per-chunk round-trip.  Per-stage exception isolation is preserved — a
failing extractor stage leaves nodes untouched.
"""

from __future__ import annotations

from typing import Callable, Sequence

from githubrepostorag_tpu_torch.ingest.types import Node
from githubrepostorag_tpu_torch.llm import LLM
from githubrepostorag_tpu_torch.utils.json_utils import truncate
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

EXTRACT_INPUT_BUDGET = 3000  # chars of chunk text per extractor prompt


def _summary_prompt(node: Node) -> str:
    return (
        "Summarize what this code or documentation section does in 2-3 "
        "sentences. Final answer only.\n\n"
        f"{truncate(node.text, EXTRACT_INPUT_BUDGET)}\n\nSummary:"
    )


def _title_prompt(node: Node) -> str:
    return (
        "Give a short descriptive title (under 10 words) for this section. "
        "Final answer only.\n\n"
        f"{truncate(node.text, EXTRACT_INPUT_BUDGET)}\n\nTitle:"
    )


def _keywords_prompt(node: Node) -> str:
    return (
        "List up to 10 technical keywords for this section as a single "
        "comma-separated line. Final answer only.\n\n"
        f"{truncate(node.text, EXTRACT_INPUT_BUDGET)}\n\nKeywords:"
    )


def _batch_complete(llm: LLM, prompts: list[str], max_tokens: int) -> list[str]:
    """Submit all prompts; use the batch API when the backend has one."""
    batch = getattr(llm, "complete_batch", None)
    if callable(batch):
        return batch(prompts, max_tokens=max_tokens)
    return [llm.complete(p, max_tokens=max_tokens) for p in prompts]


def _run_stage(
    llm: LLM,
    nodes: Sequence[Node],
    stage: str,
    prompt_fn: Callable[[Node], str],
    apply_fn: Callable[[Node, str], None],
    max_tokens: int,
) -> None:
    """One extractor stage over all nodes, exception-isolated
    (code_pipeline_service.py:25-51)."""
    try:
        prompts = [prompt_fn(n) for n in nodes]
        responses = _batch_complete(llm, prompts, max_tokens)
        for node, resp in zip(nodes, responses):
            text = (resp or "").strip()
            if text and not text.lower().startswith("error"):
                apply_fn(node, text)
    except Exception as exc:  # noqa: BLE001
        logger.warning("extractor stage %r failed; nodes left unenriched: %s", stage, exc)


def enrich_nodes(llm: LLM, nodes: Sequence[Node]) -> None:
    """Summary -> title -> keywords, in place."""
    if not nodes:
        return
    _run_stage(llm, nodes, "summary", _summary_prompt,
               lambda n, t: n.metadata.__setitem__("summary", truncate(t, 1000)), 200)
    _run_stage(llm, nodes, "title", _title_prompt,
               lambda n, t: n.metadata.__setitem__("title", truncate(t.splitlines()[0], 120)), 40)

    def apply_keywords(n: Node, t: str) -> None:
        kws = [k.strip() for k in t.replace("\n", ",").split(",") if k.strip()][:10]
        if kws:
            n.metadata["keywords"] = ", ".join(kws)
            # every keyword becomes a topic: the sanitizer shreds the list
            # into key:member entries so a topics=<any member> filter matches
            # (reference: ShreddingTransformer, vector_write_service.py:118)
            n.metadata.setdefault("topics", [k.lower() for k in kws])

    _run_stage(llm, nodes, "keywords", _keywords_prompt, apply_keywords, 80)
