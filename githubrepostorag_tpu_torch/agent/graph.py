"""The agentic query loop: plan_scope -> [retrieve -> judge -> rewrite?]* ->
synthesize; a copy of ``githubrepostorag_tpu/agent/graph.py`` over the
port's retrievers and LLM backends.

Behavioral rebuild of the reference's LangGraph agent (agent_graph.py) as an
explicit state machine — same stages, same JSON-robustness fallbacks, same
truncation budgets, with the scope ladder extended to the full five-level
hierarchy (the reference never queried its catalog table — Appendix A of
SURVEY.md) and a per-run progress context instead of the racy instance-level
callback swap (agent_graph.py:526-543).

Stage semantics (reference file:line):
  plan_scope  — LLM JSON {scope, filters}; heuristic fallback looks_codey
                (:33-38), repo-hint regex (:40-42), tech synonyms (:31)
  retrieve    — scope retriever; on <3 hits or retry, LLM semantic expansion
                with content-hash dedup capped at ROUTER_TOP_K (:241-302)
  judge       — LLM JSON coverage/needs_more/suggest_filters/stage_down/
                rewrite; parse-fail auto-stage-down; coverage<0.3 ladder
                progression (:304-384)
  rewrite     — attempt 1: LLM rewrite; later: semantic expansion; stuck
                detection forces file scope (:386-446)
  synthesize  — <=5 blocks x 800 chars, citation prompts split
                overview/specific, anti-conservative retry (:448-516)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable

from githubrepostorag_tpu_torch.agent import prompts
from githubrepostorag_tpu_torch.agent.state import AgentState, ProgressCallback
from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.llm import LLM
from githubrepostorag_tpu_torch.obs.trace import TraceContext, span, trace_scope
from githubrepostorag_tpu_torch.resilience.policy import Deadline, DeadlineExceeded, deadline_scope
from githubrepostorag_tpu_torch.retrieval import RetrievedDoc, RetrieverFactory
from githubrepostorag_tpu_torch.retrieval.retrievers import SCOPE_LADDER
from githubrepostorag_tpu_torch.utils.json_utils import extract_json, truncate
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Heuristic scope fallback (agent_graph.py:33-38): code-smelling questions
# start narrow, everything else starts broad.
_CODEY_TERMS = (
    "stacktrace", "traceback", "exception", "error", "class ", "function ",
    "method ", "nullpointer", "undefined", "timeout", "reconnect", "retry",
    "implement", "bug", "regex", "snippet",
)

# Tech synonym -> topics filter (agent_graph.py:31).  Extensible map.
TECH_SYNONYMS: dict[str, tuple[str, ...]] = {
    "activemq": ("activemq", "jms", "amq", "broker", "stomp"),
    "kafka": ("kafka", "consumer group", "partition"),
    "redis": ("redis", "pubsub", "cache"),
    "cassandra": ("cassandra", "cql", "keyspace"),
    "kubernetes": ("kubernetes", "k8s", "helm", "kubectl"),
}

_REPO_HINT_RE = re.compile(r"(?:repo(?:sitory)?[:\s]+)([\w\-./]+)", re.IGNORECASE)
_OVERVIEW_TERMS = ("projects", "repositories", "overview", "tell me about", "what is", "describe")
# Architecture-class questions: cross-cutting structure that no 5-block
# chunk context can answer well.  With a repo identified, these route to
# the whole-repo long-context mode (retrieval/assembler.py feeds the
# serving stack's ring-prefill path) instead of the iterative RAG loop.
_ARCHITECTURE_TERMS = (
    "architecture", "how does", "how do", "design", "structure",
    "data flow", "end to end", "end-to-end", "walk me through",
    "walk through", "overall", "interact", "fit together", "lifecycle",
)
_CONSERVATIVE_PHRASES = (
    "insufficient", "don't see enough", "don't have enough", "can't answer",
    "not enough information", "cannot answer", "no information",
)

SOURCE_TEXT_BUDGET = 1200  # chars carried per source (agent_graph.py:84)
JUDGE_PREVIEW_BUDGET = 200  # chars per judge preview (agent_graph.py:314)
SYNTH_BLOCK_BUDGET = 800  # chars per synthesis block (agent_graph.py:453-459)
SYNTH_MAX_BLOCKS = 5


def looks_codey(query: str) -> bool:
    ql = query.lower()
    return any(term in ql for term in _CODEY_TERMS)


def wants_whole_repo(query: str) -> bool:
    """Architecture-class question — the whole repo beats any 5 chunks.
    Snippet-smelling questions (looks_codey) stay on chunk RAG: they want
    one precise fragment, not 11k tokens of everything."""
    ql = query.lower()
    return any(term in ql for term in _ARCHITECTURE_TERMS) and not looks_codey(query)


def extract_repo_hint(query: str) -> str | None:
    m = _REPO_HINT_RE.search(query)
    return m.group(1) if m else None


def next_scope_down(scope: str) -> str:
    try:
        idx = SCOPE_LADDER.index(scope)
    except ValueError:
        return "chunk"
    return SCOPE_LADDER[min(idx + 1, len(SCOPE_LADDER) - 1)]


class RunCancelled(Exception):
    """Raised between stages when the caller's should_stop probe fires
    (cooperative cancellation — the reference only checked once before any
    work, worker.py:121-124)."""


@dataclass
class AgentResult:
    answer: str
    sources: list[dict[str, Any]]
    debug: dict[str, Any] = field(default_factory=dict)


class GraphAgent:
    def __init__(
        self,
        llm: LLM,
        retrievers: RetrieverFactory | None = None,
        max_iters: int | None = None,
        namespace: str | None = None,
    ) -> None:
        s = get_settings()
        self.llm = llm
        self.retrievers = retrievers or RetrieverFactory()
        self.max_iters = max_iters or s.max_rag_attempts
        self.namespace = namespace
        self.router_top_k = s.router_top_k
        self.longctx = s.agent_longctx

    # ------------------------------------------------------------- stages

    def plan_scope(self, state: AgentState, force_level: str | None = None) -> None:
        q = state.query
        if self.namespace:
            state.filters.setdefault("namespace", self.namespace)
        hint = extract_repo_hint(q)
        if hint:
            state.filters["repo"] = hint

        if force_level in SCOPE_LADDER:
            # skip the planning round-trip entirely; hint/synonym filters
            # above still apply
            scope = force_level
        else:
            raw = self.llm.complete(prompts.plan_prompt(q))
            data = extract_json(raw, default=None)
            if isinstance(data, dict) and data.get("scope") in SCOPE_LADDER:
                scope = data["scope"]
                self._merge_filters(state.filters, data.get("filters"))
            else:
                scope = "chunk" if looks_codey(q) else "repo"

        for tech, terms in TECH_SYNONYMS.items():
            if "topics" in state.filters:
                break
            if any(t in q.lower() for t in terms):
                state.filters["topics"] = tech
                break

        state.scope = scope
        # whole-repo long-context routing: an architecture-class question
        # with the repo pinned down (hint or planner filter) skips the
        # iterative loop and reads the assembled repo in one ring-prefill
        # pass.  force_level is an explicit caller scope — honor it.
        if (
            self.longctx
            and force_level not in SCOPE_LADDER
            and state.filters.get("repo")
            and wants_whole_repo(q)
        ):
            state.mode = "longctx"
        state.breadcrumb(
            "plan", scope=scope, mode=state.mode, filters=dict(state.filters),
            attempt=state.attempt, forced=force_level in SCOPE_LADDER or None,
        )

    def retrieve(self, state: AgentState) -> None:
        retriever = self.retrievers.for_scope(state.scope)
        cap = state.top_k if state.top_k and state.top_k > 0 else self.router_top_k
        docs = retriever.retrieve(state.query, state.filters, top_k=state.top_k)
        original_count = len(docs)

        if (len(docs) < 3 or state.attempt > 0) and len(docs) < cap:
            expanded = self._expand_query(state.query, state.filters.get("repo"), state.scope)
            # collect every expansion candidate first, then rank — capping by
            # insertion order would drop stronger docs from later queries.
            # The whole expansion set goes out as ONE batched wave (one
            # encoder forward + one seed dispatch) instead of per-query
            # sequential retrievals.
            seen = {hash(d.text) for d in docs}
            extras: list[RetrievedDoc] = []
            retrieve_many = getattr(retriever, "retrieve_many", None)
            try:
                if callable(retrieve_many):
                    alt_lists = retrieve_many(expanded, state.filters,
                                              top_k=state.top_k)
                else:  # duck-typed retriever without the batched API
                    alt_lists = [retriever.retrieve(alt, state.filters,
                                                    top_k=state.top_k)
                                 for alt in expanded]
            except Exception as exc:  # noqa: BLE001 - expansion is best-effort
                logger.warning("expanded queries %r failed: %s", expanded, exc)
                alt_lists = []
            for alt_docs in alt_lists:
                for doc in alt_docs:
                    h = hash(doc.text)
                    if h not in seen:
                        seen.add(h)
                        extras.append(doc)
            extras.sort(key=lambda d: d.score, reverse=True)
            all_docs = (list(docs) + extras)[:cap]
            if len(all_docs) > original_count:
                state.breadcrumb(
                    "retrieve_expanded",
                    original_hits=original_count,
                    expanded_hits=len(all_docs),
                    expanded_queries=expanded,
                )
            docs = all_docs

        docs.sort(key=lambda d: d.score, reverse=True)
        state.docs = docs
        if docs:
            state.best_docs = docs
        state.breadcrumb(
            "retrieve", scope=state.scope, filters=dict(state.filters),
            hits=len(docs), original_hits=original_count, attempt=state.attempt,
        )

    def judge(self, state: AgentState) -> None:
        inventory = [
            {
                "i": i,
                "repo": d.metadata.get("repo", ""),
                "module": d.metadata.get("module", ""),
                "file": d.metadata.get("file_path", ""),
                "topics": d.metadata.get("topics", ""),
                "content_preview": truncate(d.text, JUDGE_PREVIEW_BUDGET),
                "relevance_score": round(d.score, 4),
            }
            for i, d in enumerate(state.docs, start=1)
        ]
        raw = self.llm.complete(prompts.judge_prompt(state.query, inventory, state.scope))
        data = extract_json(raw, default=None)
        if not isinstance(data, dict):
            # parse failure: the ladder keeps moving instead of stalling
            # (agent_graph.py:346-355)
            if state.scope in ("catalog", "repo", "module"):
                data = {"coverage": 0.2, "needs_more": True, "stage_down": next_scope_down(state.scope)}
            else:
                data = {"coverage": 0.4, "needs_more": False}

        self._merge_filters(state.filters, data.get("suggest_filters"))

        stage_down = data.get("stage_down")
        cur_idx = SCOPE_LADDER.index(state.scope) if state.scope in SCOPE_LADDER else 0
        if (
            stage_down in SCOPE_LADDER
            and SCOPE_LADDER.index(stage_down) > cur_idx  # only ever drill DOWN
        ):
            state.scope = stage_down
        elif _as_float(data.get("coverage")) < 0.3 and state.docs:
            state.scope = next_scope_down(state.scope)

        state.needs_more = bool(data.get("needs_more"))
        state.rewrite = data.get("rewrite") if isinstance(data.get("rewrite"), str) else None
        state.breadcrumb("judge", decision=data)

    def rewrite_or_end(self, state: AgentState) -> str:
        """Returns "synthesize" or "retry"."""
        if not state.needs_more:
            return "synthesize"
        attempt = state.attempt + 1
        if attempt >= self.max_iters:
            state.attempt = attempt
            state.breadcrumb("rewrite", action="end", reason="max_iters", attempt=attempt)
            return "synthesize"
        state.attempt = attempt

        # stuck detection: only summary-level docs while scoped broad ->
        # force the file level (agent_graph.py:396-404)
        if attempt > 1 and state.docs:
            all_summary_level = all(not d.metadata.get("file_path") for d in state.docs)
            if all_summary_level and state.scope in ("catalog", "repo", "module"):
                state.scope = "file"
                state.breadcrumb("rewrite", action="force_drill_down", scope="file", attempt=attempt)
                return "retry"

        base_query = state.rewrite or state.query
        context = " ".join(
            state.filters[k] for k in ("repo", "module") if state.filters.get(k)
        )
        if attempt == 1:
            raw = self.llm.complete(prompts.rewrite_prompt(base_query, context))
            sharpened = raw.strip().strip("\"'").strip()
            if not sharpened or len(sharpened) < 10 or sharpened.lower().startswith("error"):
                sharpened = f"{base_query} in {context}" if context else base_query
        else:
            expanded = self._expand_query(base_query, state.filters.get("repo"), state.scope)
            sharpened = expanded[0] if expanded else base_query

        state.query = sharpened
        state.breadcrumb("rewrite", action="retry", attempt=attempt, query=sharpened,
                         filters=dict(state.filters))
        return "retry"

    def synthesize(self, state: AgentState, token_cb: Callable[[str], None] | None = None) -> None:
        # Two robustness improvements over the reference, which synthesizes
        # over whatever the LAST retrieve returned (possibly nothing): fall
        # back to the best non-empty retrieval of the run, and as a last
        # resort try the chunk scope with the original query.
        docs = state.docs or state.best_docs
        if not docs:
            flt = {k: v for k, v in state.filters.items() if k == "namespace"}
            try:
                docs = self.retrievers.retrieve("chunk", state.original_query,
                                                flt, top_k=state.top_k)
            except Exception:  # noqa: BLE001
                docs = []
            if docs:
                state.breadcrumb("retrieve", scope="chunk", filters=flt,
                                 hits=len(docs), last_resort=True)
        blocks: list[str] = []
        sources: list[dict[str, Any]] = []
        for i, d in enumerate(docs[:SYNTH_MAX_BLOCKS], start=1):
            md = d.metadata
            snippet = truncate(d.text, SYNTH_BLOCK_BUDGET)
            blocks.append(
                f"[{i}] repo={md.get('repo', '')} module={md.get('module', '')} "
                f"file={md.get('file_path', '')}\n{snippet}"
            )
            sources.append(
                {
                    "id": i,
                    "doc_id": d.doc_id,
                    "repo": md.get("repo", ""),
                    "module": md.get("module", ""),
                    "file_path": md.get("file_path", ""),
                    "scope": md.get("scope", state.scope),
                    "score": round(d.score, 4),
                    "text": truncate(d.text, SOURCE_TEXT_BUDGET),
                }
            )

        ql = state.original_query.lower()
        overview = any(term in ql for term in _OVERVIEW_TERMS)
        has_content = any(len(b.split("\n", 1)[-1].strip()) > 50 for b in blocks)

        synth_prompt = prompts.synthesis_prompt(
            state.original_query, blocks, overview and has_content
        )
        text = self._complete(synth_prompt, token_cb)

        # anti-conservative retry (agent_graph.py:489-503)
        if has_content and len(docs) >= 3 and _sounds_conservative(text):
            retry_text = self.llm.complete(
                prompts.encouraging_synthesis_prompt(state.original_query, blocks)
            )
            if retry_text and not _sounds_conservative(retry_text):
                # replaces the streamed draft; "final" is authoritative and
                # incremental consumers re-render from it
                text = retry_text
                state.debug["synthesis_retry"] = "overcame_conservative_answer"
            else:
                state.debug["synthesis_issue"] = "LLM_overly_conservative"

        state.answer = text
        state.sources = sources
        state.debug.update(
            final_ctx_blocks=len(blocks),
            sources_count=len(sources),
            final_scope=state.scope,
            question_type="overview" if overview else "specific",
            answer_length=len(text),
        )
        state.breadcrumb(
            "synthesize", final_ctx_blocks=len(blocks), sources_count=len(sources),
            answer_length=len(text), synthesis_issue=state.debug.get("synthesis_issue"),
        )

    def _complete(self, prompt: str, token_cb: Callable[[str], None] | None) -> str:
        """One completion, streamed into ``token_cb`` when given — real
        token streaming into the job event path (the reference promised
        this and faked it: qwen_llm.py:149-151 returns the whole completion
        as one "stream" chunk)."""
        if token_cb is None:
            return self.llm.complete(prompt)
        from githubrepostorag_tpu_torch.llm import postprocess_completion

        pieces: list[str] = []
        for delta in self.llm.stream_complete(prompt):
            pieces.append(delta)
            if token_cb is not None:
                try:
                    token_cb(delta)
                except Exception:  # noqa: BLE001 - streaming must not kill the run
                    token_cb = None
        # same post-processing as the non-streamed path, so the stored
        # answer is identical whether or not a consumer streamed it
        return postprocess_completion(prompt, "".join(pieces))

    def synthesize_longctx(
        self, state: AgentState, token_cb: Callable[[str], None] | None = None
    ) -> bool:
        """Whole-repo answer: assemble the planned repo's chunks into one
        ordered document (retrieval/assembler.py) and synthesize from ALL
        of it in a single completion — served as one long prompt, which the
        engine runs through segment-packed ring prefill past
        SP_PREFILL_THRESHOLD.  Returns False (after resetting the mode and
        leaving a fallback breadcrumb) when the repo has no chunks or blows
        the token budget; the caller rejoins the normal RAG loop."""
        from githubrepostorag_tpu_torch.retrieval import assemble_repo, longctx_token_budget

        repo = state.filters.get("repo", "")
        budget = longctx_token_budget()
        try:
            asm = assemble_repo(
                self.retrievers.store, repo,
                namespace=state.filters.get("namespace"), token_budget=budget,
            )
        except Exception as exc:  # noqa: BLE001 - mode is an optimization
            logger.warning("assemble_repo(%s) failed: %s", repo, exc)
            asm = None
        if asm is None or asm.truncated:
            state.mode = "rag"
            state.breadcrumb(
                "longctx_fallback",
                reason="no_chunks" if asm is None else "over_budget",
                repo=repo, budget=budget,
                token_estimate=asm.token_estimate if asm else 0,
            )
            return False

        state.breadcrumb(
            "assemble", repo=repo, files=asm.files, chunks=asm.chunks,
            token_estimate=asm.token_estimate,
        )
        text = self._complete(
            prompts.longctx_synthesis_prompt(state.original_query, repo, asm.text),
            token_cb,
        )
        state.answer = text
        state.sources = [
            {
                "id": 1,
                "doc_id": f"repo:{repo}",
                "repo": repo,
                "module": "",
                "file_path": "",
                "scope": "repo",
                "score": 1.0,
                "text": truncate(
                    f"whole repository: {asm.files} files, {asm.chunks} chunks",
                    SOURCE_TEXT_BUDGET,
                ),
            }
        ]
        state.debug.update(
            mode="longctx", longctx_files=asm.files, longctx_chunks=asm.chunks,
            longctx_tokens=asm.token_estimate, final_scope="repo",
            sources_count=1, answer_length=len(text),
        )
        state.breadcrumb(
            "synthesize", mode="longctx", files=asm.files,
            token_estimate=asm.token_estimate, answer_length=len(text),
        )
        return True

    # ------------------------------------------------------------- driver

    def run(
        self,
        question: str,
        namespace: str | None = None,
        progress_cb: ProgressCallback | None = None,
        force_level: str | None = None,
        should_stop: Callable[[], bool] | None = None,
        token_cb: Callable[[str], None] | None = None,
        top_k: int | None = None,
        deadline: Deadline | None = None,
        trace: "TraceContext | None" = None,
    ) -> AgentResult:
        state = AgentState(query=question, original_query=question,
                           progress_cb=progress_cb, top_k=top_k)
        if namespace or self.namespace:
            state.filters["namespace"] = namespace or self.namespace

        def check_cancel() -> None:
            if should_stop is not None and should_stop():
                raise RunCancelled()
            if deadline is not None and deadline.expired:
                raise DeadlineExceeded("agent budget exhausted at a stage boundary")

        # the deadline rides a thread-local scope for the duration of the
        # run so every llm.complete inside any stage sees the SAME budget
        # without widening the LLM protocol signature; the trace context
        # rides a contextvar scope the same way (run executes on an
        # executor thread, which inherits neither — both cross explicitly)
        with deadline_scope(deadline), trace_scope(trace):
            with span("agent.run") as run_sp:
                check_cancel()
                # force_level honored (the reference read it but ignored it —
                # worker.py:101-107, SURVEY.md Appendix A) and skips the plan LLM call
                with span("agent.plan"):
                    self.plan_scope(state, force_level=force_level)

                if state.mode == "longctx":
                    check_cancel()
                    with span("agent.longctx"):
                        served = self.synthesize_longctx(state, token_cb=token_cb)
                    if served:
                        run_sp.set_attr("sources", len(state.sources))
                        return AgentResult(
                            answer=state.answer or "",
                            sources=state.sources, debug=state.debug,
                        )
                    # fell back (no chunks / over budget): the normal
                    # loop below runs with the planned scope untouched

                while True:
                    check_cancel()
                    with span("agent.retrieve", scope=state.scope or ""):
                        self.retrieve(state)
                    check_cancel()
                    with span("agent.judge"):
                        self.judge(state)
                    check_cancel()  # rewrite pays an LLM call; don't start it cancelled
                    with span("agent.rewrite"):
                        decision = self.rewrite_or_end(state)
                    if decision == "synthesize":
                        break
                check_cancel()
                with span("agent.synthesize"):
                    self.synthesize(state, token_cb=token_cb)
                run_sp.set_attr("sources", len(state.sources))
        return AgentResult(answer=state.answer or "", sources=state.sources, debug=state.debug)

    # ------------------------------------------------------------ helpers

    def _expand_query(self, query: str, repo: str | None, scope: str | None) -> list[str]:
        raw = self.llm.complete(prompts.expansion_prompt(query, repo, scope))
        data = extract_json(raw, default=None)
        if isinstance(data, list):
            out = [q.strip() for q in data if isinstance(q, str) and q.strip()]
            if out:
                return out[:4]
        # keyword fallback (agent_graph.py:137-150)
        ql = query.lower()
        fallbacks: list[str] = []
        if "auth" in ql or "login" in ql:
            fallbacks += ["authentication mechanism", "security configuration"]
        if "cache" in ql or "caching" in ql:
            fallbacks += ["caching strategy", "cache configuration"]
        if "config" in ql:
            fallbacks += ["application settings", "environment configuration"]
        return fallbacks[:3] if fallbacks else [query]

    @staticmethod
    def _merge_filters(filters: dict[str, str], suggested: Any) -> None:
        """Accept string or single-element-list values.  LLMs sometimes
        pluralize keys ("repos": [...]) — depluralize only when that maps
        onto a canonical metadata key, never mangle canonical keys that
        already end in 's' (like "topics")."""
        canonical = {"namespace", "repo", "module", "file_path", "topics", "scope"}
        if not isinstance(suggested, dict):
            return
        for key, val in suggested.items():
            if key not in canonical and key.endswith("s") and key[:-1] in canonical:
                key = key[:-1]
            if key not in canonical:
                # an unknown key would become an exact-match filter no stored
                # doc can satisfy, zeroing every later retrieval
                continue
            if isinstance(val, str) and val:
                filters[key] = val
            elif isinstance(val, list) and val and isinstance(val[0], str):
                filters[key] = val[0]


def _sounds_conservative(text: str) -> bool:
    tl = text.lower()
    return any(phrase in tl for phrase in _CONSERVATIVE_PHRASES)


def _as_float(value: Any) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        return 0.0
