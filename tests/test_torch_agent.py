"""The port's agent loop, JSON helpers and whole-repo assembler against
the JAX package's, over a scripted ``FakeLLM`` and the host store.

Both packages get the same docs (hashing encoder: bit for bit the same
vectors; host stores: the same numpy arithmetic) and the same script, so
every run must give the identical answer, sources, debug turns (the
progress breadcrumbs) and LLM prompts.  The cases are those of
``tests/test_agent.py``; the fuzz runs drive both agents with the seeded
hostile completions of ``tests/test_agent_fuzz.py``."""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest

import githubrepostorag_tpu.retrieval as j_retrieval
import githubrepostorag_tpu_torch.retrieval as t_retrieval
from githubrepostorag_tpu.agent import GraphAgent as JGraphAgent, RunCancelled as JRunCancelled
from githubrepostorag_tpu.config import get_settings as j_settings
from githubrepostorag_tpu.embedding import HashingTextEncoder as JEncoder
from githubrepostorag_tpu.llm import FakeLLM as JFakeLLM
from githubrepostorag_tpu.retrieval import RetrieverFactory as JFactory
from githubrepostorag_tpu.store import Doc as JDoc, MemoryVectorStore as JStore
from githubrepostorag_tpu.utils import json_utils as j_json
from githubrepostorag_tpu_torch import config
from githubrepostorag_tpu_torch.agent import GraphAgent, RunCancelled
from githubrepostorag_tpu_torch.embedding import HashingTextEncoder
from githubrepostorag_tpu_torch.llm import FakeLLM
from githubrepostorag_tpu_torch.retrieval import RetrieverFactory
from githubrepostorag_tpu_torch.retrieval.retrievers import SCOPE_LADDER
from githubrepostorag_tpu_torch.store.base import Doc
from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore
from githubrepostorag_tpu_torch.utils import json_utils
from test_agent_fuzz import HOSTILE_OUTPUTS, QUERIES, HostileLLM

SIDES = {
    "jax": SimpleNamespace(Agent=JGraphAgent, FakeLLM=JFakeLLM, Factory=JFactory, Encoder=JEncoder,
                           Store=JStore, Doc=JDoc, retrieval=j_retrieval, settings=j_settings,
                           Cancelled=JRunCancelled),
    "port": SimpleNamespace(Agent=GraphAgent, FakeLLM=FakeLLM, Factory=RetrieverFactory,
                            Encoder=HashingTextEncoder, Store=MemoryVectorStore, Doc=Doc,
                            retrieval=t_retrieval, settings=config.get_settings,
                            Cancelled=RunCancelled),
}

PLAN = r"Pick the retrieval scope"
JUDGE = r"Assess whether the retrieved"
EXPAND = r"alternative search queries"
REWRITE = r"Rephrase this question"
SYNTH = r"senior engineer"
ENCOURAGE = r"helpful engineer"
LONGCTX = r"read the ENTIRE"
OK_JUDGE = '{"coverage": 0.9, "needs_more": false}'

# tests/test_agent.py's store: three chunks and one long repo summary
AGENT_DOCS = {
    "chunk": [
        ("c1", "def ingest_component(repo): run the ingest pipeline stages",
         {"repo": "coderag", "module": "ingest", "file_path": "ingest/controller.py"}),
        ("c2", "def run_rag_job(ctx, job_id): drive the agent and emit events",
         {"repo": "coderag", "module": "worker", "file_path": "worker/worker.py"}),
        ("c3", "class GraphAgent: plan retrieve judge rewrite synthesize loop",
         {"repo": "coderag", "module": "worker", "file_path": "worker/agent.py"}),
    ],
    "repo": [
        ("r1", "coderag: a RAG system over github repositories with hierarchical index "
         + "x" * 2000, {"repo": "coderag"}),
    ],
}

# tests/test_agent_fuzz.py's store: every scope of the ladder has rows
FUZZ_DOCS = {
    "catalog": [("cat1", "catalog of repositories in namespace default", {})],
    "repo": [("r1", "repo one: a message broker in java", {"repo": "broker"}),
             ("r2", "repo two: cassandra client library", {"repo": "cassclient"})],
    "module": [("m1", "module consumer handles message consumption",
                {"repo": "broker", "module": "consumer"})],
    "file": [("f1", "file Consumer.java implements the consumer loop",
              {"repo": "broker", "module": "consumer", "file_path": "Consumer.java"})],
    "chunk": [("c1", "class Consumer { void poll() { /* reconnect retry */ } }",
               {"repo": "broker", "module": "consumer", "file_path": "Consumer.java"}),
              ("c2", "def reconnect(): backoff and retry the session",
               {"repo": "cassclient", "module": "net", "file_path": "net/session.py"}),
              ("c3", "cache configuration yaml for the api tier",
               {"repo": "broker", "module": "config", "file_path": "config/cache.yaml"})],
}


@pytest.fixture(autouse=True)
def _fresh_port_settings():
    config.reload_settings()
    yield
    config.reload_settings()


def store_of(side, docs):
    """A host store and hashing encoder of one package holding ``docs``."""
    s = SIDES[side]
    store, enc = s.Store(), s.Encoder()
    tables = s.settings().scope_tables
    for scope, rows in docs.items():
        store.upsert(tables[scope], [
            s.Doc(d, t, {"namespace": "default", "scope": scope, **m}, enc.encode([t])[0])
            for d, t, m in rows])
    return store, enc


def result_of(res) -> dict:
    return {"answer": res.answer, "sources": res.sources, "debug": res.debug}


# ------------------------------------------------------------- json_utils

JSON_INPUTS = [
    '{"scope": "repo"}',
    'Here you go:\n```json\n{"scope": "file", "filters": {}}\n```\nDone.',
    'I think the plan is {"scope": "chunk", "filters": {"repo": "x"}} based on the query.',
    'prefix {"a": {"b": "with } brace"}, "c": [1, 2]} suffix',
    "no json here",
    "<think>hmm let me reason</think>The answer is 42.",
    "assistant: Sure, here is the summary:\nIt does X.",
    "The best choice is 3 because...",
    "2",
    '{"choice": 4}',
    "I pick option (2).",
    "none of the above",
    "plain text",
    "a" * 100,
    *HOSTILE_OUTPUTS,
]


@pytest.mark.parametrize("text", JSON_INPUTS, ids=range(len(JSON_INPUTS)))
def test_json_utils_match_jax(text):
    assert json_utils.extract_json(text, default={}) == j_json.extract_json(text, default={})
    assert json_utils.extract_json(text) == j_json.extract_json(text)
    assert json_utils.extract_choice(text) == j_json.extract_choice(text)
    assert json_utils.sanitize_llm_text(text) == j_json.sanitize_llm_text(text)
    assert json_utils.strip_fences(text) == j_json.strip_fences(text)
    assert json_utils.truncate(text, 10) == j_json.truncate(text, 10)


# ------------------------------------------------------------ agent cases


def _ladder(side):
    coverages = iter(['{"coverage": 0.1, "needs_more": true}', OK_JUDGE])
    return {PLAN: '{"scope": "repo", "filters": {}}', JUDGE: lambda p: next(coverages),
            REWRITE: "sharper question about the ingest pipeline", EXPAND: '["alt one", "alt two"]'}


# name -> (script or script factory, question, run keywords, max_iters)
AGENT_CASES = {
    "happy_path": ({PLAN: '{"scope": "chunk", "filters": {}}', JUDGE: OK_JUDGE,
                    SYNTH: "The ingest pipeline runs via ingest_component [1]."},
                   "how does the ingest pipeline run?", {}, 3),
    "plan_garbage_codey": ({PLAN: "utter nonsense, no json here", JUDGE: OK_JUDGE},
                           "why does this function throw an exception?", {}, 3),
    "plan_garbage_overview": ({PLAN: "still nonsense", JUDGE: OK_JUDGE},
                              "give me a summary of the architecture", {}, 3),
    "judge_parse_failure": ({PLAN: '{"scope": "repo", "filters": {}}', JUDGE: "no json at all"},
                            "what repositories exist?", {}, 2),
    "low_coverage_ladder": (_ladder, "tell me about ingest", {}, 3),
    "bounded_retries": ({PLAN: '{"scope": "chunk", "filters": {}}',
                         JUDGE: '{"coverage": 0.5, "needs_more": true}',
                         REWRITE: "rewritten question about workers",
                         EXPAND: '["expansion a", "expansion b"]'},
                        "an unanswerable question", {}, 3),
    "semantic_expansion": ({PLAN: '{"scope": "chunk", "filters": {}}',
                            EXPAND: '["agent loop class", "rag job worker"]', JUDGE: OK_JUDGE},
                           "???", {}, 3),
    "anti_conservative": ({PLAN: '{"scope": "chunk", "filters": {}}', JUDGE: OK_JUDGE,
                           ENCOURAGE: "Here are the projects: coderag does X [1].",
                           SYNTH: "I don't have enough information to answer."},
                          "what does the worker do?", {}, 3),
    "force_level_repo_hint": ({PLAN: '{"scope": "chunk", "filters": {}}', JUDGE: OK_JUDGE},
                              "summarize repo: coderag please", {"force_level": "repo"}, 3),
    "source_budget": ({PLAN: '{"scope": "repo", "filters": {}}', JUDGE: OK_JUDGE},
                      "describe the coderag repository", {}, 3),
    "plural_filters": ({PLAN: '{"scope": "chunk", "filters": {"repos": ["coderag"]}}',
                        JUDGE: OK_JUDGE}, "how does the agent work?", {}, 3),
    "longctx": ({PLAN: '{"scope": "repo", "filters": {"repo": "coderag"}}',
                 LONGCTX: "Ingest feeds the worker which drives the agent [worker/agent.py]."},
                "how do the components of coderag fit together?", {}, 3),
    "longctx_codey": ({PLAN: '{"scope": "chunk", "filters": {"repo": "coderag"}}',
                       JUDGE: OK_JUDGE}, "how does this function throw an exception?", {}, 3),
    "longctx_over_budget": ({PLAN: '{"scope": "repo", "filters": {"repo": "coderag"}}',
                             JUDGE: OK_JUDGE}, "what is the overall architecture here?", {}, 3),
    "longctx_unknown_repo": ({PLAN: '{"scope": "repo", "filters": {"repo": "ghost"}}',
                              JUDGE: OK_JUDGE}, "walk me through the design", {}, 3),
    "streamed_top_k": ({PLAN: '{"scope": "chunk", "filters": {}}', JUDGE: OK_JUDGE,
                        SYNTH: "Workers drive the agent [1]."},
                       "what does the worker do?", {"top_k": 1, "stream": True}, 3),
}


def run_case(side, name, monkeypatch):
    script, question, kw, max_iters = AGENT_CASES[name]
    s = SIDES[side]
    if name == "longctx_over_budget":
        monkeypatch.setattr(s.retrieval, "longctx_token_budget", lambda: 10)
    store, enc = store_of(side, AGENT_DOCS)
    llm = s.FakeLLM(script=script(side) if callable(script) else script,
                    default="generic answer [1]")
    agent = s.Agent(llm, s.Factory(store, enc), max_iters=max_iters, namespace="default")
    kw = dict(kw)
    events, tokens = [], []
    if kw.pop("stream", False):
        kw["token_cb"] = tokens.append
    res = agent.run(question, progress_cb=events.append, **kw)
    return {**result_of(res), "events": events, "tokens": tokens,
            "prompts": [c["prompt"] for c in llm.calls]}


@pytest.mark.parametrize("name", list(AGENT_CASES))
def test_agent_case_matches_jax(name, monkeypatch):
    port, ref = run_case("port", name, monkeypatch), run_case("jax", name, monkeypatch)
    assert port == ref
    assert port["answer"] and port["events"] == port["debug"]["turns"]


def test_progress_callback_errors_do_not_kill_run():
    def bad_cb(event):
        raise RuntimeError("boom")

    out = {}
    for side in SIDES:
        s = SIDES[side]
        store, enc = store_of(side, AGENT_DOCS)
        agent = s.Agent(s.FakeLLM(script={PLAN: '{"scope": "chunk", "filters": {}}',
                                          JUDGE: OK_JUDGE}),
                        s.Factory(store, enc), namespace="default")
        out[side] = result_of(agent.run("how does ingest work?", progress_cb=bad_cb))
    assert out["port"] == out["jax"] and out["port"]["answer"]


def test_assemble_repo_matches_jax():
    asm = {}
    for side in SIDES:
        store, _ = store_of(side, AGENT_DOCS)
        asm[side] = SIDES[side].retrieval.assemble_repo(store, "coderag", namespace="default")
        assert SIDES[side].retrieval.assemble_repo(store, "ghost") is None
        small = SIDES[side].retrieval.assemble_repo(store, "coderag", token_budget=10)
        assert small.truncated and small.files == 1
    assert vars(asm["port"]) == vars(asm["jax"])
    assert asm["port"].files == 3 and asm["port"].chunks == 3 and not asm["port"].truncated
    text = asm["port"].text
    assert text.index("### ingest/controller.py") < text.index("### worker/agent.py")
    assert t_retrieval.longctx_token_budget() == j_retrieval.longctx_token_budget()


# ------------------------------------------------------------------- fuzz


def _fuzz_run(side, trial, rng_seed):
    """tests/test_agent_fuzz.py's trial ``trial``: the same choices of
    factory, budget, namespace, forced scope, query and top_k on both
    sides, every completion hostile."""
    s = SIDES[side]
    rng = random.Random(rng_seed * 1000 + trial)
    full = s.Factory(*store_of(side, FUZZ_DOCS))
    empty = s.Factory(s.Store(), s.Encoder())
    agent = s.Agent(HostileLLM(seed=trial), full if rng.random() < 0.8 else empty,
                    max_iters=rng.choice([1, 2, 3, 4]),
                    namespace="default" if rng.random() < 0.7 else None)
    force = rng.choice([None, None, "bogus_level", *SCOPE_LADDER])
    tokens: list[str] = []
    res = agent.run(rng.choice(QUERIES), force_level=force,
                    top_k=rng.choice([None, 1, 3, 50, -2]),
                    token_cb=tokens.append if rng.random() < 0.5 else None)
    return {**result_of(res), "tokens": tokens, "llm_calls": agent.llm.calls}


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_hostile_runs_match_jax(seed):
    for trial in range(8):
        assert _fuzz_run("port", trial, seed) == _fuzz_run("jax", trial, seed), trial


@pytest.mark.parametrize("fire_after", range(5))
def test_cancellation_at_each_stage_matches_jax(fire_after):
    """should_stop firing before plan, retrieve, judge, rewrite or
    synthesize raises RunCancelled on both sides after the same turns."""
    turns = {}
    for side in SIDES:
        s = SIDES[side]
        calls = {"n": 0}

        def should_stop() -> bool:
            calls["n"] += 1
            return calls["n"] > fire_after

        events = []
        agent = s.Agent(HostileLLM(seed=fire_after), s.Factory(*store_of(side, FUZZ_DOCS)),
                        max_iters=3)
        with pytest.raises(s.Cancelled):
            agent.run("how does the consumer reconnect?", should_stop=should_stop,
                      progress_cb=events.append)
        turns[side] = events
    assert turns["port"] == turns["jax"]
