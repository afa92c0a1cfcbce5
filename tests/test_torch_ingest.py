"""The port's ingest pipeline against the JAX package's, on the CPU.

Units: the inputs of ``tests/test_ingest_units.py`` (skip lists, languages,
component kind, notebooks, both chunker backends at their budgets, the
missing tree-sitter seam, metadata sanitizing, stable ids, extractor
batching and exception isolation, catalog and hierarchy nodes) through both
packages give the same results.  End to end: one small tree (3 modules and
a root README) read by both ``LocalRepoReader``s and ingested by both
``ingest_component``s with the same scripted ``FakeLLM`` and the hashing
encoder fills identical memory stores (ids, text, metadata, vectors); a
re-ingest upserts; ``ingest_many`` writes the sentinel and keeps one bad
repo from stopping the rest; the CLI (``--local``, the sentinels,
``--force``, the saved store) behaves the same, the port's over the device
index on the CPU.  The whole slice: a tiny random greedy Qwen2 behind both
packages' ``InProcessLLM`` ingests a 3-file tree into identical stores, and
one agent question over each store gets the same answer and sources.  The
GitHub client (GraphQL pages, the tarball behind a redirect) runs against a
stdlib fake GitHub on localhost, and the stdlib Pushgateway push sends what
``prometheus_client.push_to_gateway`` sends."""

from __future__ import annotations

import io
import json
import tarfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu import config as j_config
from githubrepostorag_tpu.agent import GraphAgent as JGraphAgent
from githubrepostorag_tpu.embedding import HashingTextEncoder as JEncoder
from githubrepostorag_tpu.ingest import catalog as j_catalog
from githubrepostorag_tpu.ingest import chunker as j_chunker
from githubrepostorag_tpu.ingest import controller as j_controller
from githubrepostorag_tpu.ingest import extractors as j_extractors
from githubrepostorag_tpu.ingest import hierarchy as j_hierarchy
from githubrepostorag_tpu.ingest import notebook as j_notebook
from githubrepostorag_tpu.ingest import preprocess as j_preprocess
from githubrepostorag_tpu.ingest import sources as j_sources
from githubrepostorag_tpu.ingest import vector_write as j_vector_write
from githubrepostorag_tpu.ingest.__main__ import main as j_main
from githubrepostorag_tpu.ingest.types import Node as JNode, SourceDoc as JSourceDoc
from githubrepostorag_tpu.llm import FakeLLM as JFakeLLM, InProcessLLM as JInProcessLLM
from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu.retrieval import RetrieverFactory as JFactory
from githubrepostorag_tpu.retrieval.device_index import DeviceIndexedStore as JDeviceIndexedStore
from githubrepostorag_tpu.serving import Engine as JEngine
from githubrepostorag_tpu.serving.async_engine import AsyncEngine as JAsyncEngine
from githubrepostorag_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from githubrepostorag_tpu.store import MemoryVectorStore as JStore
from githubrepostorag_tpu_torch import config, embedding, llm as t_llm
from githubrepostorag_tpu_torch.agent import GraphAgent
from githubrepostorag_tpu_torch.embedding import HashingTextEncoder
from githubrepostorag_tpu_torch.ingest import catalog, chunker, controller, extractors
from githubrepostorag_tpu_torch.ingest import hierarchy, notebook, preprocess, sources
from githubrepostorag_tpu_torch.ingest import vector_write
from githubrepostorag_tpu_torch.ingest.__main__ import main
from githubrepostorag_tpu_torch.ingest.types import Node, SourceDoc
from githubrepostorag_tpu_torch.llm import FakeLLM, InProcessLLM
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.retrieval import DeviceIndexedStore, RetrieverFactory
from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine
from githubrepostorag_tpu_torch.serving.tokenizer import ByteTokenizer
from githubrepostorag_tpu_torch.store import factory as store_factory
from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

INGEST_SCRIPT = {
    r"Summarize": "Summarized section.",
    r"short descriptive title": "Section Title\nsecond line dropped",
    r"technical keywords": "Rag, TPU,\njax, , ingest",
    r"README a useful description": "maybe",
    r"Describe what this project does": "A project that serves answers.",
    r"200-300 word technical summary": "File-level summary of the source file.",
    r"summary of this module": "error: the module summary failed",
    r"comprehensive overview": "Repo overview: a RAG framework.",
}

# a repository of three modules and a root README: Python, JavaScript,
# Markdown, a notebook (a setup cell, a log-heavy output), a skipped image,
# a file past the chunk budget, and a Python file that does not parse
TREE = {
    "README.md": "# demo\n\nA demo repository that ingests code and answers questions "
                 "about it, with a worker, an API and docs.\n",
    "core/engine.py": "import os\n\n\n@cache\ndef plan(query):\n    return query.split()\n\n\n"
                      "class Engine:\n    def run(self, q):\n        return plan(q)\n\n"
                      "    @property\n    def name(self):\n        return 'engine'\n",
    "core/big.py": "def big():\n" + "\n".join(f"    value_{i} = {i} * 2" for i in range(260)),
    "core/legacy.py": "def f(:\n    print 'py2'\n" * 3,
    "api/server.js": "const express = require('express');\n\nfunction route(app) {\n"
                     "  app.get('/x', (req, res) => res.send('ok'));\n}\n\n"
                     "export function start() {\n  return route(express());\n}\n",
    "api/logo.png": "\x89PNG not really",
    "docs/guide.md": "# Guide\n\n" + "\n\n".join(f"Paragraph {i}. " + "word " * 120
                                                for i in range(4)),
    "docs/analysis.ipynb": json.dumps({"nbformat": 4, "cells": [
        {"cell_type": "markdown", "source": ["# Analysis\n", "of the index"]},
        {"cell_type": "code", "source": "!pip install pandas\n%matplotlib inline", "outputs": []},
        {"cell_type": "code", "source": "df = load()\ndf.head()", "outputs": [
            {"output_type": "stream", "text": "2024-01-01 10:00:00 INFO loading\n" * 30}]},
        {"cell_type": "code", "source": ["print(df.shape)"], "outputs": [
            {"output_type": "execute_result", "data": {"text/plain": ["(100, 5)"]}}]},
    ]}),
}


def write_tree(root: Path, files: dict[str, str]) -> Path:
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return root


def dump(store) -> dict:
    """Every row of a memory store: table -> doc id -> (text, metadata, vector)."""
    return {name: {d: (doc.text, doc.metadata,
                       None if doc.vector is None else doc.vector.tolist())
                   for d, doc in t.docs.items()}
            for name, t in store._tables.items()}


def run_fields(record: dict) -> dict:
    """A run record without what differs between two runs."""
    return {k: v for k, v in record.items()
            if k not in ("run_id", "timings", "total_seconds", "finished_at")}


@pytest.fixture
def env(monkeypatch):
    """Environment for both packages; the port's singletons reset around."""
    def reset():
        store_factory.reset_store()
        embedding.set_encoder(None)
        t_llm.set_llm(None)

    def apply(values: dict[str, str], side: str = "both"):
        for name, value in values.items():
            monkeypatch.setenv(name, value)
        if side in ("both", "port"):
            config.reload_settings()
        if side in ("both", "jax"):
            j_config.reload_settings()

    reset()
    yield apply
    monkeypatch.undo()
    reset()
    config.reload_settings()
    j_config.reload_settings()


# ---- preprocess, notebook ---------------------------------------------------

SKIP_CASES = [("logo.png", None), ("package-lock.json", None), ("LICENSE", None),
              ("deep/dir/CHANGELOG.md", None), ("src/main.py", None), ("src/main.py", "x = 1"),
              ("data.bin", "\x00\x01\x02"), ("huge.js", "x" * 500_000), ("a/.gitignore", None),
              ("yarn.lock", None), ("ok.ts", "a\x00b"), ("Cargo.lock", None)]
LANGUAGE_PATHS = ["a/b/c.py", "Dockerfile", "dockerfile.dev", "docker-compose.yaml",
                  "x.tsx", "noext", "Main.JAVA", "s.sh", "q.sql", "n.ipynb", "conf.toml"]


def test_skip_lists_and_languages_equal_jax():
    for path, text in SKIP_CASES:
        assert preprocess.should_skip(path, text) == j_preprocess.should_skip(path, text), path
    for path in LANGUAGE_PATHS:
        assert preprocess.detect_language(path) == j_preprocess.detect_language(path), path
    for name in ("SKIP_EXTENSIONS", "SKIP_DATA_JSON_NAMES", "SKIP_BASENAMES", "MAX_FILE_CHARS"):
        assert getattr(preprocess, name) == getattr(j_preprocess, name)


@pytest.mark.parametrize("names,dev", [
    (["analysis.ipynb"], False), (["analysis.ipynb", "Dockerfile"], False),
    (["analysis.ipynb", "Dockerfile"], True), (["a.py", "openapi.yaml"], False), ([], False),
])
def test_component_kind_equal_jax(names, dev):
    port = preprocess.infer_component_kind([SourceDoc(n, "{}") for n in names], dev)
    assert port == j_preprocess.infer_component_kind([JSourceDoc(n, "{}") for n in names], dev)


def test_prepare_repo_documents_equal_jax():
    raw = [(p, t) for p, t in TREE.items()] + [
        ("empty.py", "   "), ("bad.ipynb", "not a notebook"), ("img.png", "\x89PNG")]
    port = preprocess.prepare_repo_documents([SourceDoc(p, t, {"k": 1}) for p, t in raw])
    ref = j_preprocess.prepare_repo_documents([JSourceDoc(p, t, {"k": 1}) for p, t in raw])
    assert [(d.path, d.text, d.metadata) for d in port] == [(d.path, d.text, d.metadata)
                                                            for d in ref]
    assert "bad.ipynb" in [d.path for d in port]  # garbage kept as raw text on both


def test_notebook_equal_jax():
    text = TREE["docs/analysis.ipynb"]
    out = notebook.process_notebook_content(text, language="python")
    assert out == j_notebook.process_notebook_content(text, language="python")
    assert "pip install" not in out and "INFO loading" not in out and "(100, 5)" in out
    for garbage in ("not a notebook at all", "[1, 2]", '{"nbformat": 4}'):
        with pytest.raises(ValueError):
            notebook.process_notebook_content(garbage)
        with pytest.raises(ValueError):
            j_notebook.process_notebook_content(garbage)


# ---- chunker ------------------------------------------------------------------

_PY_FIXTURE = '''\
import os

@decorator
def first(a, b):
    """doc"""
    return a + b

class Big:
    x = 1

    def method_one(self):
        return 1

    @property
    def method_two(self):
        return 2

def last():
    pass
'''

CHUNK_CASES = {
    "python_boundaries": ("\n".join(f"def fn_{i}():\n" + "\n".join(f"    x = {j}" for j in range(30))
                                    for i in range(12)), "python", {}),
    "oversized_unit": ("def big():\n" + "\n".join(f"    line_{i} = {i}" for i in range(500)),
                       "python", {}),
    "pyast_budgets": (_PY_FIXTURE, "python", {"max_lines": 8, "max_chars": 400,
                                              "backend": "pyast"}),
    "regex_budgets": (_PY_FIXTURE, "python", {"max_lines": 8, "max_chars": 400,
                                              "backend": "regex"}),
    "syntax_error_pyast": ("def f(:\n    print 'py2'\nmore text here\n" * 5, "python",
                           {"backend": "pyast"}),
    "syntax_error_auto": ("def f(:\n    print 'py2'\nmore text here\n" * 5, "python", {}),
    "javascript": (TREE["api/server.js"] * 20, "javascript", {"max_lines": 30}),
    "go": ("package x\n\nfunc a() {}\n\ntype T struct{}\n" * 30, "go", {"max_lines": 25}),
    "long_lines": ("x = '" + "y" * 5000 + "'\n" + "z = 1\n" * 3, "python", {}),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_split_code_equal_jax(case):
    text, language, kw = CHUNK_CASES[case]
    port = chunker.split_code(text, language, **kw)
    ref = j_chunker.split_code(text, language, **kw)
    assert [(c.text, c.start_line, c.end_line, c.span) for c in port] == \
        [(c.text, c.start_line, c.end_line, c.span) for c in ref]
    assert port
    limit_lines, limit_chars = kw.get("max_lines", 200), kw.get("max_chars", 4000)
    assert all(len(c.text.splitlines()) <= limit_lines for c in port)
    if case != "long_lines":  # one line past the budget stays one chunk
        assert all(len(c.text) <= limit_chars for c in port)


@pytest.mark.parametrize("language", ["markdown", "yaml", None, "bash", "dockerfile", "python",
                                      "rust", "c_sharp"])
def test_split_document_and_text_equal_jax(language):
    text = "\n\n".join(f"Paragraph {i}. " + "word " * 100 for i in range(12))
    port = chunker.split_document(text, language)
    ref = j_chunker.split_document(text, language)
    assert [(c.text, c.span) for c in port] == [(c.text, c.span) for c in ref]
    for size, overlap in ((1500, 100), (700, 0)):
        assert [c.text for c in chunker.split_text(text, size, overlap)] == \
            [c.text for c in j_chunker.split_text(text, size, overlap)]
    assert chunker.split_document("", language) == j_chunker.split_document("", language) == []


def test_chunker_budgets_and_the_missing_treesitter_seam():
    for name in ("CODE_CHUNK_LINES", "CODE_CHUNK_CHARS", "CODE_OVERLAP_LINES", "TEXT_CHUNK_CHARS",
                 "TEXT_OVERLAP_CHARS", "FALLBACK_CHUNK_CHARS", "FALLBACK_OVERLAP_CHARS"):
        assert getattr(chunker, name) == getattr(j_chunker, name), name
    assert (chunker.CODE_CHUNK_LINES, chunker.CODE_CHUNK_CHARS, chunker.CODE_OVERLAP_LINES,
            chunker.TEXT_CHUNK_CHARS, chunker.TEXT_OVERLAP_CHARS) == (200, 4000, 10, 1500, 100)
    lines = _PY_FIXTURE.splitlines()
    assert chunker._pyast_boundaries(_PY_FIXTURE, lines) == \
        j_chunker._pyast_boundaries(_PY_FIXTURE, lines)
    try:
        import tree_sitter_language_pack  # noqa: F401
        pytest.skip("tree_sitter_language_pack is installed; the missing seam cannot show")
    except ImportError:
        pass
    for mod in (chunker, j_chunker):
        assert mod._treesitter_parser("python") is None
        assert mod._treesitter_boundaries(_PY_FIXTURE, lines, "python") is None
        with pytest.raises(RuntimeError, match="tree-sitter backend unavailable"):
            mod.split_code(_PY_FIXTURE, "python", backend="treesitter")
    # auto falls through to the stdlib ast backend on both
    assert [c.text for c in chunker.split_code(_PY_FIXTURE, "python", backend="auto")] == \
        [c.text for c in j_chunker.split_code(_PY_FIXTURE, "python", backend="pyast")]


# ---- sanitize, ids ------------------------------------------------------------

METADATA = {
    "scope": "chunk", "namespace": "default", "repo": "r", "module": "m", "collection": "c",
    "file_path": "a.py", "language": "python", "span": "1-10", "component_kind": "service",
    "keywords": "Kafka, Streams ,, Consumer", "topics": ["Kafka", " Streams", "x y"],
    "tech_stack": ("python", "go"), "secret_internal": "drop me", "rollup_of": ["x", "y"],
    "rollup_count": 2, "summary": None, "title": "", "module_info": {"b": 1, "a": "é"},
}


@pytest.mark.parametrize("scope", ["catalog", "repo", "module", "file", "chunk", "unknown"])
def test_sanitize_metadata_equal_jax(scope):
    md = dict(METADATA, scope=scope, module={"b": 1, "a": "é"} if scope == "module" else "m",
              rollup_count=2 if scope != "repo" else True)
    port = vector_write.sanitize_metadata(md, scope)
    assert port == j_vector_write.sanitize_metadata(md, scope)
    assert list(port) == list(j_vector_write.sanitize_metadata(md, scope))
    assert all(isinstance(v, str) for v in port.values())
    assert vector_write.SCOPE_ALLOWED == j_vector_write.SCOPE_ALLOWED
    assert (vector_write.KEEP_ALWAYS, vector_write.WRITE_BATCH) == \
        (j_vector_write.KEEP_ALWAYS, j_vector_write.WRITE_BATCH) == (
            {"scope", "namespace", "repo", "collection", "component_kind"}, 128)


def test_stable_ids_equal_jax():
    cases = [("same", {"scope": "chunk", "repo": "r", "span": "1-2"}),
             ("same", {"scope": "chunk", "repo": "r", "span": "3-4"}),
             ("ünïcode ✓", {"scope": "file", "namespace": "n", "module": "m", "file_path": "f"}),
             ("", {}), ("x", {"scope": "repo", "repo": 7})]
    ids = [Node(t, dict(m)).stable_id() for t, m in cases]
    assert ids == [JNode(t, dict(m)).stable_id() for t, m in cases]
    assert len(set(ids)) == len(ids)
    assert Node("t", {}, node_id="given").stable_id() == "given"


# ---- extractors, catalog, hierarchy -------------------------------------------

class BatchRecorder:
    """An LLM with ``complete_batch`` that records every call (kind, number
    of prompts, max_tokens) and answers from ``reply``; a stage whose
    prompts match ``fail`` raises."""

    def __init__(self, reply, fail: str | None = None, batch: bool = True):
        self.reply, self.fail, self.calls = reply, fail, []
        if not batch:
            self.complete_batch = None

    def complete(self, prompt, max_tokens=None, **kw):
        self.calls.append(("complete", 1, max_tokens))
        if self.fail and self.fail in prompt:
            raise RuntimeError("boom")
        return self.reply(prompt)

    def complete_batch(self, prompts, max_tokens=None, **kw):
        self.calls.append(("batch", len(prompts), max_tokens))
        if self.fail and any(self.fail in p for p in prompts):
            raise RuntimeError("boom")
        return [self.reply(p) for p in prompts]


def _reply(prompt: str) -> str:
    if prompt.startswith("Summarize"):
        return "  Summary of " + prompt[110:130] + "  " if "fn_1" not in prompt else "ERROR x"
    if prompt.startswith("Give a short"):
        return "A Title\nmore" if "fn_2" not in prompt else "   "
    return "Alpha, beta\nGamma, alpha, , d, e, f, g, h, i, j, k, l"


@pytest.mark.parametrize("fail,batch", [(None, True), (None, False), ("short descriptive title", True),
                                        ("Summarize", False)])
def test_enrich_nodes_batching_and_isolation_equal_jax(fail, batch):
    texts = [f"def fn_{i}():\n    return {i}\n" + "# pad\n" * (i * 300) for i in range(4)]
    llm, j_llm = BatchRecorder(_reply, fail, batch), BatchRecorder(_reply, fail, batch)
    nodes = [Node(t, {"file_path": "a.py"}) for t in texts]
    j_nodes = [JNode(t, {"file_path": "a.py"}) for t in texts]
    extractors.enrich_nodes(llm, nodes)
    j_extractors.enrich_nodes(j_llm, j_nodes)
    assert [n.metadata for n in nodes] == [n.metadata for n in j_nodes]
    assert llm.calls == j_llm.calls
    kinds = {k for k, _, _ in llm.calls}
    assert kinds == ({"batch"} if batch else {"complete"})
    assert [m for _, _, m in llm.calls if _ == len(texts)] in ([200, 40, 80], [])
    assert extractors.EXTRACT_INPUT_BUDGET == j_extractors.EXTRACT_INPUT_BUDGET == 3000
    extractors.enrich_nodes(llm, [])
    assert len(llm.calls) == len(j_llm.calls)


@pytest.mark.parametrize("readme,verdict", [
    ("# x\n" + "Serves answers about code. " * 10, "GOOD"),
    ("# x\n" + "Serves answers about code. " * 10, "bad"),
    ("# x\n" + "Serves answers about code. " * 30, "unclear"),
    ("# x\n" + "Serves answers about code. " * 4, "unclear"),
    ("short", "GOOD"), (None, "GOOD"),
])
def test_catalog_node_equal_jax(readme, verdict):
    docs = [("main.py", "print('main')"), ("pkg/util.go", "package util"), ("x.rs", "fn x() {}")]
    if readme is not None:
        docs.append(("README.md", readme))

    def reply(prompt):
        if "Verdict" in prompt:
            return verdict
        return "error: offline" if readme == "short" else "Describes the project."

    chunk_md = [{"summary": f"summary {i}"} for i in range(12)] + [{}]
    out = []
    for Node_, Doc_, mod, Fake in ((Node, SourceDoc, catalog, FakeLLM),
                                   (JNode, JSourceDoc, j_catalog, JFakeLLM)):
        llm = Fake(script={".": reply})
        node = mod.build_catalog_node(llm, [Doc_(p, t) for p, t in docs],
                                      [Node_("c", dict(m)) for m in chunk_md],
                                      {"repo": "demo", "namespace": "n"})
        out.append((node.text, node.metadata, [(c["prompt"], c["max_tokens"]) for c in llm.calls]))
    assert out[0] == out[1]


def test_hierarchy_nodes_equal_jax():
    files = {"core/a.py": 3, "core/b.py": 1, "api/c.js": 2, "README.md": 1, "x/y/z.go": 1}
    out = []
    for Node_, mod, Fake in ((Node, hierarchy, FakeLLM), (JNode, j_hierarchy, JFakeLLM)):
        llm = Fake(script={r"api/c\.js": "error: failed", r"Module: core": "   ",
                           r"comprehensive overview": "The overview."}, default="Fine summary.")
        chunks = [Node_(f"chunk {i} of {fp} " + "x" * 9000, {"file_path": fp, "language": "py"})
                  for fp, n in files.items() for i in range(n)] + [Node_("no path", {})]
        common = {"repo": "demo", "namespace": "n"}
        file_nodes = mod.build_file_nodes(llm, chunks, common)
        module_nodes = mod.build_module_nodes(llm, file_nodes, common)
        repo_node = mod.build_repo_node(llm, module_nodes, [("README.md", "# demo")], common)
        out.append(([(n.text, n.metadata) for n in file_nodes + module_nodes + [repo_node]],
                    [(c["prompt"], c["max_tokens"]) for c in llm.calls]))
    assert out[0] == out[1]
    # one call a file (5) and a module (4) at 512, the repo at 768
    assert [m for _, m in out[0][1]] == [512] * 9 + [768]
    assert hierarchy.top_directory("a/b/c.py") == j_hierarchy.top_directory("a/b/c.py") == "a"


# ---- end to end with the scripted LLM -----------------------------------------

def _ingest_both(docs_t, docs_j, repo="demo", **kw):
    store, j_store = MemoryVectorStore(), JStore()
    rec = controller.ingest_component(repo, docs=docs_t, llm=FakeLLM(script=INGEST_SCRIPT),
                                      store=store, encoder=HashingTextEncoder(), **kw)
    j_rec = j_controller.ingest_component(repo, docs=docs_j, llm=JFakeLLM(script=INGEST_SCRIPT),
                                          store=j_store, encoder=JEncoder(), **kw)
    return rec, j_rec, store, j_store


def test_ingest_component_fills_identical_stores(env, tmp_path):
    root = write_tree(tmp_path / "demo", TREE)
    data_t, data_j = tmp_path / "data_t", tmp_path / "data_j"
    env({"DATA_DIR": str(data_t)}, "port")
    env({"DATA_DIR": str(data_j)}, "jax")
    docs = sources.LocalRepoReader(str(root)).load()
    j_docs = j_sources.LocalRepoReader(str(root)).load()
    assert [(d.path, d.text) for d in docs] == [(d.path, d.text) for d in j_docs]
    stages = []
    rec, j_rec, store, j_store = _ingest_both(
        docs, j_docs, on_stage=lambda s, t: stages.append(s))
    assert run_fields(rec) == run_fields(j_rec)
    assert stages == list(rec["timings"]) + list(j_rec["timings"])  # port's run, then JAX's
    assert list(rec["timings"]) == list(j_rec["timings"])
    assert rec["written"] == {"catalog": 1, "repo": 1, "module": 4, "file": 7,
                              "chunk": rec["written"]["chunk"]}
    assert dump(store) == dump(j_store)
    chunks = store._tables[config.get_settings().scope_tables["chunk"]].docs.values()
    assert all(d.metadata["summary"] == "Summarized section." for d in chunks)
    assert all(d.metadata["topics:tpu"] == "1" for d in chunks)
    # the audit record and the raw-document dump under DATA_DIR
    for data, r in ((data_t, rec), (data_j, j_rec)):
        assert json.loads((data / "ingest_runs.jsonl").read_text())["run_id"] == r["run_id"]
    assert (data_t / "repos/demo/raw_documents_main.json").read_text() == \
        (data_j / "repos/demo/raw_documents_main.json").read_text()

    # re-ingest upserts the same rows
    controller.ingest_component("demo", docs=docs, llm=FakeLLM(script=INGEST_SCRIPT),
                                store=store, encoder=HashingTextEncoder())
    assert dump(store) == dump(j_store)
    assert len((data_t / "ingest_runs.jsonl").read_text().splitlines()) == 2


def test_ingest_into_the_device_index_on_the_cpu(env, tmp_path):
    """The rows written through the device index (``device="cpu"``) are the
    host store's and the JAX device index's, and a search of each chunk's
    own text ranks it first in both."""
    root = write_tree(tmp_path / "demo", TREE)
    docs = sources.LocalRepoReader(str(root)).load()
    index = DeviceIndexedStore(MemoryVectorStore(), device="cpu")
    j_index = JDeviceIndexedStore(JStore())
    enc, j_enc = HashingTextEncoder(), JEncoder()
    controller.ingest_component("demo", docs=docs, llm=FakeLLM(script=INGEST_SCRIPT),
                                store=index, encoder=enc)
    j_controller.ingest_component("demo", docs=j_sources.LocalRepoReader(str(root)).load(),
                                  llm=JFakeLLM(script=INGEST_SCRIPT), store=j_index,
                                  encoder=j_enc)
    _, _, _, j_store = _ingest_both(docs, j_sources.LocalRepoReader(str(root)).load())
    assert dump(index.inner) == dump(j_store) == dump(j_index.inner)
    for table in index.tables():
        assert index.count(table) == j_store.count(table) == j_index.count(table)
    table = config.get_settings().scope_tables["chunk"]
    for doc in list(index.inner._tables[table].docs.values())[:6]:
        hit = index.search(table, enc.encode([doc.text])[0], 1)[0]
        j_hit = j_index.search(table, j_enc.encode([doc.text])[0], 1)[0]
        assert hit.score == pytest.approx(1.0, abs=1e-5)
        assert index.inner.get(table, hit.doc.doc_id).text == doc.text
        assert hit.doc.doc_id == j_hit.doc.doc_id
        assert hit.score == pytest.approx(j_hit.score, abs=1e-5)


def test_ingest_many_sentinel_and_bad_repo_isolation(env, tmp_path, monkeypatch):
    env({"DATA_DIR": str(tmp_path / "t")}, "port")
    env({"DATA_DIR": str(tmp_path / "j")}, "jax")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()

    def load(self, repo, branch=None):
        if repo == "bad":
            raise RuntimeError("clone exploded")
        return [SourceDoc("src/x.py", f"def x():\n    return '{repo}@{branch}'\n")]

    monkeypatch.setattr(sources.GithubService, "load_repo_documents", load)
    monkeypatch.setattr(j_sources.GithubService, "load_repo_documents", load)
    results = controller.ingest_many(components=["one", "bad", "two"], branch="dev",
                                     llm=FakeLLM(script=INGEST_SCRIPT),
                                     store=MemoryVectorStore(), encoder=HashingTextEncoder())
    j_results = j_controller.ingest_many(components=["one", "bad", "two"], branch="dev",
                                         llm=JFakeLLM(script=INGEST_SCRIPT), store=JStore(),
                                         encoder=JEncoder())
    assert [run_fields(r) for r in results] == [run_fields(r) for r in j_results]
    assert results[1] == {"repo": "bad", "error": "clone exploded"}
    assert "error" not in results[0] and "error" not in results[2]
    for side in ("t", "j"):
        assert json.loads((tmp_path / side / ".ingest_complete").read_text())["repos"] == 3


def test_cli_local_sentinels_and_saved_store_as_jax(env, tmp_path, capsys):
    root = write_tree(tmp_path / "proj", TREE)
    common = {"LLM_BACKEND": "fake", "STORE_BACKEND": "memory", "EMBED_MODEL": "none",
              "LOG_FORMAT": "plain"}
    sides = {}
    for side, run, args in (("jax", j_main, []), ("port", main, ["--device", "cpu"])):
        data, store_dir = tmp_path / side / "data", tmp_path / side / "store"
        data.mkdir(parents=True)
        env({**common, "DATA_DIR": str(data), "STORE_PATH": str(store_dir)}, side)
        capsys.readouterr()
        assert run(["--local", str(root), "--repo", "proj", *args]) == 0
        record = json.loads(capsys.readouterr().out)
        sentinel = json.loads((data / ".ingest_complete").read_text())
        assert sentinel == {"finished_at": record["finished_at"], "repos": 1}
        # the sentinel holds the next run back; --force runs it again
        assert run(["--local", str(root), "--repo", "proj", *args]) == 0
        assert capsys.readouterr().out == ""
        assert run(["--local", str(root), "--repo", "proj", "--force", *args]) == 0
        again = json.loads(capsys.readouterr().out)
        assert run_fields(again) == run_fields(record)
        saved = {p.name: json.loads(p.read_text()) for p in sorted(store_dir.glob("*.json"))}
        sides[side] = (run_fields(record), saved)
        if side == "port":
            assert isinstance(store_factory.get_store(), DeviceIndexedStore)
    assert sides["port"] == sides["jax"]
    assert sides["port"][0]["written"]["repo"] == 1
    reloaded = MemoryVectorStore(persist_dir=str(tmp_path / "port" / "store"))
    assert {t: reloaded.count(t) for t in reloaded.tables()} == {
        f"{name}.json"[:-5]: len(rows) for name, rows in
        ((n[:-5], r) for n, r in sides["port"][1].items())}


# ---- the GitHub client against a local fake ------------------------------------

def _tarball() -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, data in (("octo-proj-abc/src/a.py", b"def a():\n    return 1\n"),
                           ("octo-proj-abc/node_modules/x.js", b"skip()"),
                           ("octo-proj-abc/bin.dat", b"\xff\xfe\x00\x01"),
                           ("octo-proj-abc/README.md", "# proj ✓\n".encode()),
                           ("octo-proj-abc/docs/deep/guide.md", b"guide")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        info = tarfile.TarInfo("octo-proj-abc/docs")
        info.type = tarfile.DIRTYPE
        tar.addfile(info)
    return buf.getvalue()


class FakeGithub(BaseHTTPRequestHandler):
    """GraphQL in two pages, and the tarball endpoint redirecting to a
    download host (localhost, where the API is 127.0.0.1)."""

    seen: list = []

    def log_message(self, *args):
        pass

    def _send(self, code: int, body: bytes, headers=()):
        self.send_response(code)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.seen.append(("POST", self.path, self.headers.get("Authorization"),
                          self.headers.get("Content-Type"), body["variables"]))
        cursor = body["variables"]["cursor"]
        nodes = ([{"name": "proj", "isFork": False, "isArchived": False, "isPrivate": False,
                   "defaultBranchRef": {"name": "trunk"}},
                  {"name": "forked", "isFork": True, "isArchived": False, "isPrivate": False}]
                 if cursor is None else
                 [{"name": "old", "isFork": False, "isArchived": True, "isPrivate": False},
                  {"name": "nobranch", "isFork": False, "isArchived": False, "isPrivate": False,
                   "defaultBranchRef": None}])
        page = {"data": {"user": {"repositories": {
            "pageInfo": {"hasNextPage": cursor is None, "endCursor": "c1"}, "nodes": nodes}}}}
        self._send(200, json.dumps(page).encode())

    def do_GET(self):
        self.seen.append(("GET", self.path, self.headers.get("Authorization")))
        port = self.server.server_address[1]
        if self.path.startswith("/repos/octo/proj/tarball/"):
            self._send(302, b"", [("Location", f"http://localhost:{port}/codeload/proj.tgz")])
        elif self.path == "/codeload/proj.tgz":
            self._send(200, _tarball())
        else:
            self._send(404, b"{}")


def test_github_service_against_a_fake_github(monkeypatch):
    server = ThreadingHTTPServer(("127.0.0.1", 0), FakeGithub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    api = f"http://127.0.0.1:{server.server_address[1]}"
    monkeypatch.setattr(sources, "_GITHUB_API", api)
    monkeypatch.setattr(j_sources, "_GITHUB_API", api)
    try:
        out = {}
        for side, mod in (("port", sources), ("jax", j_sources)):
            FakeGithub.seen = []
            svc = mod.GithubService(token="tok", user="octo")
            repos = svc.fetch_repositories()
            docs = svc.load_repo_documents("proj", "trunk")
            out[side] = (repos, [(d.path, d.text, d.metadata) for d in docs],
                         list(FakeGithub.seen))
            with pytest.raises(Exception) as err:
                svc.load_repo_documents("missing", "main")
            assert "404" in str(err.value)
        assert out["port"] == out["jax"]
        repos, docs, seen = out["port"]
        assert repos == [{"name": "proj", "default_branch": "trunk"},
                         {"name": "nobranch", "default_branch": "main"}]
        assert [d[0] for d in docs] == ["src/a.py", "README.md", "docs/deep/guide.md"]
        # the token went to the API host, not to the download host
        assert seen[0][2] == "Bearer tok" and seen[0][3] == "application/json"
        assert seen[-2:] == [("GET", "/repos/octo/proj/tarball/trunk", "Bearer tok"),
                             ("GET", "/codeload/proj.tgz", None)]
    finally:
        server.shutdown()
        server.server_close()


# ---- the Pushgateway push ----------------------------------------------------------

class Capture(BaseHTTPRequestHandler):
    seen: list = []

    def log_message(self, *args):
        pass

    def do_PUT(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.seen.append((self.command, self.path, body))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


def test_pushgateway_push_sends_what_prometheus_client_sends(env):
    server = ThreadingHTTPServer(("127.0.0.1", 0), Capture)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    gateway = f"127.0.0.1:{server.server_address[1]}"
    grouping = {"run_id": "abc123", "repo": "my repo", "namespace": "", "branch": "feature/x+y"}
    try:
        seen = {}
        for url in (gateway, f"http://{gateway}/"):
            env({"PUSHGATEWAY_URL": url})
            for side, mod in (("port", controller), ("jax", j_controller)):
                Capture.seen = []
                for stage, seconds in (("preprocess", 0.123), ('odd "st\\age"\n', 1234567.5),
                                       ("total", 1.2345e-05)):
                    mod._push_stage_gauge(stage, seconds, grouping)
                seen[side, url] = Capture.seen
            assert seen["port", url] == seen["jax", url] and len(seen["port", url]) == 3
        env({"PUSHGATEWAY_URL": ""})
        Capture.seen = []
        controller._push_stage_gauge("preprocess", 1.0, grouping)  # unset: no push
        assert Capture.seen == []
        method, path, body = seen["port", gateway][0]
        assert method == "PUT" and path.startswith("/metrics/job/ingest/branch@base64/")
        assert b'ingest_stage_duration_seconds{stage="preprocess"} 0.123\n' in body
    finally:
        server.shutdown()
        server.server_close()


# ---- the whole slice: a tiny greedy Qwen2 behind both InProcessLLMs -----------------

ENGINE_KW = dict(max_num_seqs=4, num_pages=192, page_size=8, max_seq_len=256, prefill_chunk=64)
LLM_KW = dict(default_max_tokens=6, default_temperature=0.0, context_window=256)
SLICE_TREE = {
    "README.md": "# mini\n\nA tiny repository: one engine module and one API script, "
                 "for the whole-slice parity test.\n",
    "core/engine.py": "def plan(query):\n    return query.split()\n\n\n"
                      "class Engine:\n    def run(self, q):\n        return plan(q)\n",
    "api/server.js": "function route(app) {\n  return app;\n}\n",
}


def test_whole_slice_with_a_tiny_qwen2_matches_jax(env, tmp_path):
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    jp = jax.tree.map(lambda x: x * 4 if x.ndim >= 2 else x, j_init(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    root = write_tree(tmp_path / "mini", SLICE_TREE)
    port_llm = InProcessLLM(AsyncEngine(Engine(tp, cfg, kv_dtype=torch.float32, device="cpu",
                                               **ENGINE_KW)), ByteTokenizer(), **LLM_KW)
    j_llm = JInProcessLLM(JAsyncEngine(JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW)),
                          JByteTokenizer(), **LLM_KW)
    try:
        store, j_store = MemoryVectorStore(), JStore()
        enc, j_enc = HashingTextEncoder(), JEncoder()
        rec = controller.ingest_component("mini", docs=sources.LocalRepoReader(str(root)).load(),
                                          llm=port_llm, store=store, encoder=enc)
        j_rec = j_controller.ingest_component(
            "mini", docs=j_sources.LocalRepoReader(str(root)).load(), llm=j_llm,
            store=j_store, encoder=j_enc)
        assert run_fields(rec) == run_fields(j_rec)
        assert dump(store) == dump(j_store)  # every summary, title and keyword string
        tables = config.get_settings().scope_tables
        chunks = store._tables[tables["chunk"]].docs.values()
        assert any("summary" in d.metadata for d in chunks)
        engine = port_llm.engine.engine
        assert engine._allocator.free_count == engine._allocator.num_pages

        question = "what does the function plan return in repo: mini?"
        res = GraphAgent(port_llm, RetrieverFactory(store, enc), namespace="default").run(question)
        ref = JGraphAgent(j_llm, JFactory(j_store, j_enc), namespace="default").run(question)
        assert (res.answer, res.sources) == (ref.answer, ref.sources)
        assert any(s.get("file_path") in SLICE_TREE for s in res.sources)
    finally:
        port_llm.close()
        j_llm.close()
