"""The whole question-answering slice against the JAX package's: a tiny
random Qwen2 (float32, greedy), its parameters carried across by
``params_from_jax``, served by each package's ``Engine`` and
``AsyncEngine`` behind its ``InProcessLLM``; each package's
``GraphAgent`` over a byte tokenizer, the hashing encoder and a host
store holding the same docs.  A code question, a repo question and a
whole-repo question must give the identical answer, sources, progress
breadcrumbs and LLM calls on both sides.

The random model's completions are not JSON, so every plan and judge
call takes the agent's fallbacks, as they do on the card.  Also here: the
in-process LLM's deadline reaping, an abandoned call's row, a refused
stream, and ``close()``."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.agent import GraphAgent as JGraphAgent
from githubrepostorag_tpu.embedding import HashingTextEncoder as JEncoder
from githubrepostorag_tpu.llm import InProcessLLM as JInProcessLLM
from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu.resilience.policy import Deadline as JDeadline
from githubrepostorag_tpu.resilience.policy import deadline_scope as j_deadline_scope
from githubrepostorag_tpu.retrieval import RetrieverFactory as JFactory
from githubrepostorag_tpu.serving import Engine as JEngine
from githubrepostorag_tpu.serving.async_engine import AsyncEngine as JAsyncEngine
from githubrepostorag_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from githubrepostorag_tpu.store import Doc as JDoc, MemoryVectorStore as JStore
from githubrepostorag_tpu_torch import config
from githubrepostorag_tpu_torch.agent import GraphAgent
from githubrepostorag_tpu_torch.embedding import HashingTextEncoder
from githubrepostorag_tpu_torch.llm import InProcessLLM
from githubrepostorag_tpu_torch.metrics import MeteredLLM
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.obs import get_recorder, root_span
from githubrepostorag_tpu_torch.resilience.policy import Deadline, deadline_scope
from githubrepostorag_tpu_torch.retrieval import RetrieverFactory
from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine
from githubrepostorag_tpu_torch.serving.tokenizer import ByteTokenizer
from githubrepostorag_tpu_torch.store.base import Doc
from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

# the tiny model's context: agent prompts are cut to their last 448 bytes
ENGINE_KW = dict(max_num_seqs=2, num_pages=64, page_size=8, max_seq_len=512, prefill_chunk=64)
LLM_KW = dict(default_max_tokens=6, default_temperature=0.0, context_window=512)

DOCS = {
    "repo": [("r1", "coderag: a RAG system over github repositories with a hierarchical index",
              {"repo": "coderag"})],
    "module": [("m1", "module worker consumes rag jobs and drives the agent",
                {"repo": "coderag", "module": "worker"}),
               ("m2", "module ingest chunks repositories into the five tables",
                {"repo": "coderag", "module": "ingest"})],
    "file": [("f1", "file worker/worker.py: the job worker and its event stream",
              {"repo": "coderag", "module": "worker", "file_path": "worker/worker.py"})],
    "chunk": [
        ("c1", "def ingest_component(repo): run the ingest pipeline stages",
         {"repo": "coderag", "module": "ingest", "file_path": "ingest/controller.py"}),
        ("c2", "def run_rag_job(ctx, job_id): drive the agent and emit events",
         {"repo": "coderag", "module": "worker", "file_path": "worker/worker.py"}),
        ("c3", "class GraphAgent: plan retrieve judge rewrite synthesize loop",
         {"repo": "coderag", "module": "worker", "file_path": "worker/agent.py"}),
        ("c4", "def create_job(request): enqueue the job and return its id",
         {"repo": "coderag", "module": "api", "file_path": "api/app.py"}),
    ],
}
QUESTIONS = [
    "what does the function create_job return?",  # code: the chunk scope
    "tell me about repo: coderag",  # repo scope, staged down by the judge fallback
    "explain the architecture of repo: coderag and how the pieces fit together",  # whole repo
]


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    jp = jax.tree.map(lambda x: x * 4 if x.ndim >= 2 else x, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_port_settings():
    config.reload_settings()
    yield
    config.reload_settings()


def _store(Store, Doc_, Encoder, tables):
    store, enc = Store(), Encoder()
    for scope, rows in DOCS.items():
        store.upsert(tables[scope], [
            Doc_(d, t, {"namespace": "default", "scope": scope, **m}, enc.encode([t])[0])
            for d, t, m in rows])
    return store, enc


def _port_llm(cfg, tp, **kw):
    engine = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **{**ENGINE_KW, **kw})
    return InProcessLLM(AsyncEngine(engine), ByteTokenizer(), **LLM_KW), engine


def _ask(agent, question):
    events, tokens = [], []
    res = agent.run(question, progress_cb=events.append, token_cb=tokens.append)
    return {"answer": res.answer, "sources": res.sources, "debug": res.debug,
            "events": events, "streamed": "".join(tokens)}


class Recorder:
    """The LLM protocol, recording each call's kind and prompt."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def complete(self, prompt, **kw):
        self.calls.append(("complete", prompt))
        return self.inner.complete(prompt, **kw)

    def stream_complete(self, prompt, **kw):
        self.calls.append(("stream", prompt))
        yield from self.inner.stream_complete(prompt, **kw)


def test_question_answering_matches_jax(weights):
    jcfg, cfg, jp, tp = weights
    from githubrepostorag_tpu.config import get_settings as j_settings

    je = JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW)
    j_llm = Recorder(JInProcessLLM(JAsyncEngine(je), JByteTokenizer(), **LLM_KW))
    j_agent = JGraphAgent(j_llm, JFactory(*_store(JStore, JDoc, JEncoder,
                                                  j_settings().scope_tables)),
                          namespace="default")
    port_llm, engine = _port_llm(cfg, tp)
    t_llm = Recorder(port_llm)
    agent = GraphAgent(MeteredLLM(t_llm), RetrieverFactory(*_store(
        MemoryVectorStore, Doc, HashingTextEncoder, config.get_settings().scope_tables)),
        namespace="default")
    try:
        for question in QUESTIONS:
            t_llm.calls.clear()
            j_llm.calls.clear()
            with root_span("test.ask") as sp:
                port = _ask(agent, question)
            ref = _ask(j_agent, question)
            assert port == ref, question
            assert t_llm.calls == j_llm.calls, question
            assert port["answer"] == port["streamed"].strip() or port["debug"].get(
                "synthesis_retry")
            # each engine call left its spans under the agent's
            spans = get_recorder().trace_payload(sp.trace_id)["spans"]
            names = [s["name"] for s in spans]
            assert names.count("llm.generate") == len(t_llm.calls)
            assert names.count("engine.prefill") == len(t_llm.calls)
        modes = [t["stage"] for t in port["debug"]["turns"]]
        assert "assemble" in modes and port["sources"][0]["doc_id"] == "repo:coderag"
        assert engine._allocator.free_count == engine._allocator.num_pages
    finally:
        port_llm.close()
        j_llm.inner.close()


def _slow_steps(engine, delay):
    step = engine.step

    def slow():
        time.sleep(delay)
        return step()

    engine.step = slow


def test_deadline_reaps_the_row_as_jax(weights):
    """A call whose deadline passes during its first engine step (each
    step slowed to 0.15 s) gets JAX's deadline text at the next step
    boundary, and the engine frees the row's pages."""
    jcfg, cfg, jp, tp = weights
    texts = {}
    llm, engine = _port_llm(cfg, tp)
    _slow_steps(engine, 0.15)
    je = JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW)
    j_llm = JInProcessLLM(JAsyncEngine(je), JByteTokenizer(), **LLM_KW)
    _slow_steps(je, 0.15)
    try:
        with deadline_scope(Deadline(0.1)):
            texts["port"] = llm.complete("a question", max_tokens=400)
        with j_deadline_scope(JDeadline(0.1)):
            texts["jax"] = j_llm.complete("a question", max_tokens=400)
        with deadline_scope(Deadline(0.0)):
            texts["expired"] = llm.complete("a question")
        with j_deadline_scope(JDeadline(0.0)):
            texts["j_expired"] = j_llm.complete("a question")
    finally:
        llm.close()
        j_llm.close()
    assert texts["port"] == texts["jax"] == "Error: deadline exceeded (engine reaped the request)"
    assert texts["expired"] == texts["j_expired"] == "Error: deadline exceeded before LLM call"
    assert engine.deadline_reaps == je.deadline_reaps == 1
    assert engine._allocator.free_count == engine._allocator.num_pages
    assert not engine.has_work()


def test_abandoned_call_cancels_its_row(weights, monkeypatch):
    """A wait that times out cancels the engine row (the JAX client leaves
    it decoding), so its pages come back."""
    _, cfg, _, tp = weights
    monkeypatch.setenv("JOB_TIMEOUT_SECONDS", "1")
    config.reload_settings()
    llm, engine = _port_llm(cfg, tp)
    _slow_steps(engine, 0.4)  # this prompt's greedy answer ends after 3 bursts
    try:
        text = llm.complete("a question", max_tokens=400)
        deadline = time.monotonic() + 10
        while engine.has_work() and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        llm.close()
    assert text.startswith("Error:")
    assert not engine.has_work()
    assert engine._allocator.free_count == engine._allocator.num_pages


def test_stream_over_a_dead_driver_ends_with_error_text(weights):
    """A refused submission ends the stream with error text (the JAX pump
    has no handler and leaves its consumer waiting)."""
    _, cfg, _, tp = weights
    llm, _ = _port_llm(cfg, tp)
    llm.engine.driver_error = "RuntimeError('boom')"
    try:
        out = list(llm.stream_complete("a question"))
    finally:
        llm.close()
    assert len(out) == 1 and out[0].startswith("Error: engine driver is dead")


def test_close_stops_the_engine_and_both_loops(weights):
    _, cfg, _, tp = weights
    llm, engine = _port_llm(cfg, tp)
    assert llm.complete("hello") is not None
    driver, loop_thread = llm.engine._thread, llm._loop_thread
    assert driver.is_alive() and loop_thread.is_alive()
    llm.close()
    assert not driver.is_alive() and not loop_thread.is_alive()
    assert llm._loop is None and llm.engine._thread is None
    # a later call starts both again
    assert llm.complete("hello again") is not None
    llm.close()
    assert engine._allocator.free_count == engine._allocator.num_pages


def test_http_llm_against_the_port_model_server_matches_jax(weights):
    """``LLM_BACKEND=http``: the port's urllib client and the JAX package's
    requests client against the port's model server (greedy) give the same
    completion and the same streamed deltas; a dead endpoint comes back as
    error text and counts against the ``llm.http`` breaker on both.

    One divergence by design: ``requests`` reads a ``text/event-stream``
    without a charset as ISO-8859-1, so the JAX client's streamed deltas
    garble every non-ASCII character (the random model's bytes make
    U+FFFD); the port's client reads the stream as UTF-8."""
    import asyncio
    import threading

    from githubrepostorag_tpu.llm import HTTPLLM as JHTTPLLM
    from githubrepostorag_tpu.resilience.policy import get_breaker as j_get_breaker
    from githubrepostorag_tpu_torch.llm import HTTPLLM
    from githubrepostorag_tpu_torch.resilience.policy import get_breaker, reset_breakers
    from githubrepostorag_tpu_torch.serving.openai_api import OpenAIServer

    reset_breakers()  # the JAX side's are reset for every test by the conftest
    _, cfg, _, tp = weights
    engine = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **ENGINE_KW)
    server = OpenAIServer(AsyncEngine(engine), ByteTokenizer(), model_name="tiny")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    port = asyncio.run_coroutine_threadsafe(server.start("127.0.0.1", 0), loop).result(30)
    try:
        out = {}
        for name, cls in (("port", HTTPLLM), ("jax", JHTTPLLM)):
            llm = cls(endpoint=f"http://127.0.0.1:{port}", model="tiny")
            out[name] = (llm.complete("what is a page table?", max_tokens=8, temperature=0.0),
                         list(llm.stream_complete("what is a page table?", max_tokens=8,
                                                  temperature=0.0)))
        dead = {name: cls(endpoint="http://127.0.0.1:9", timeout=2).complete("x")
                for name, cls in (("port", HTTPLLM), ("jax", JHTTPLLM))}
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
    assert out["port"][0] == out["jax"][0]
    assert [d.encode("utf-8").decode("latin-1") for d in out["port"][1]] == out["jax"][1]
    assert "".join(out["port"][1]).strip() == out["port"][0]
    assert dead["port"].startswith("Error: ") and dead["jax"].startswith("Error: ")
    assert get_breaker("llm.http").snapshot()["consecutive_failures"] == \
        j_get_breaker("llm.http").snapshot()["consecutive_failures"] == 1


def test_concurrent_first_calls_share_one_loop(weights):
    """Eight threads making an InProcessLLM's first calls at once (a
    worker's jobs starting together) all get their completions over one
    loop thread.  The JAX version checks for its loop without a lock:
    two first callers can start two loops, and the engine then delivers
    one caller's events onto the other's loop, where its waiter never
    wakes."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    _, cfg, _, tp = weights
    llm, engine = _port_llm(cfg, tp)
    barrier = threading.Barrier(8)

    def call(i):
        barrier.wait(10)
        return llm.complete(f"question {i}")

    try:
        with ThreadPoolExecutor(8) as pool:
            out = list(pool.map(call, range(8)))
        loops = [t for t in threading.enumerate() if t.name == "llm-loop"]
    finally:
        llm.close()
    assert all(isinstance(x, str) and not x.startswith("Error") for x in out)
    assert len(loops) == 1
    assert engine._allocator.free_count == engine._allocator.num_pages
