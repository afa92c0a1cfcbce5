"""The port's retrievers, coalescer and store factory against the JAX
package's.

With the hashing encoder (bit for bit the same in both packages) over
the host stores (the same numpy arithmetic), retrieval is identical:
ids, depths and scores.  The hashing encoder's cosines tie often in exact
arithmetic, and two float32 matmuls of another summation order break
such ties either way, so the port's device index (``device="cpu"``) is
held to the host store with an encoder of generic vectors: ids and depths
identical, scores within 1e-5.
"""

from __future__ import annotations

import threading
import zlib

import numpy as np
import pytest
import torch

from githubrepostorag_tpu.config import reload_settings as j_reload_settings
from githubrepostorag_tpu.embedding import HashingTextEncoder as JHashingTextEncoder
from githubrepostorag_tpu.retrieval import retrievers as j_retrievers
from githubrepostorag_tpu.store.base import Doc as JDoc
from githubrepostorag_tpu.store.memory import MemoryVectorStore as JMemoryVectorStore
from githubrepostorag_tpu_torch import config, embedding
from githubrepostorag_tpu_torch.embedding import HashingTextEncoder
from githubrepostorag_tpu_torch.metrics import RETRIEVAL_WAVE_SIZE, histogram_stats
from githubrepostorag_tpu_torch.retrieval import (
    DeviceIndexedStore,
    LiveIndexedStore,
    RetrievalCoalescer,
    RetrieverFactory,
    get_live_applier,
)
from githubrepostorag_tpu_torch.retrieval.retrievers import SCOPE_SPECS, mmr_select, RetrievedDoc
from githubrepostorag_tpu_torch.store import factory
from githubrepostorag_tpu_torch.store.base import Doc
from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

DIM = 64
WORDS = ("alpha", "beta", "gamma", "delta", "job", "queue", "index", "search", "vector",
         "cancel", "redis", "helm", "chart", "worker", "agent", "store", "token")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    factory.reset_store()
    embedding.set_encoder(None)
    config.reload_settings()
    yield
    factory.reset_store()
    embedding.set_encoder(None)
    config.reload_settings()


def _corpus(rng):
    """Rows of all five hierarchy tables: (table, id, text, metadata)."""
    s = config.get_settings()
    rows = []
    for i in range(60):
        repo, module = f"repo{i % 3}", f"mod{i % 6}"
        meta = {"namespace": "default", "repo": repo, "module": module,
                "file_path": f"{module}/f{i % 12}.py"}
        text = " ".join(rng.choice(WORDS, size=8)) + f" item{i}"
        rows.append((s.embeddings_table_chunk, f"c{i:03d}", text, meta))
        if i % 5 == 0:
            rows.append((s.embeddings_table_file, f"f{i:03d}", text, meta))
        if i % 6 == 0:
            rows.append((s.embeddings_table_module, f"m{i:03d}", text, meta))
        if i % 10 == 0:
            rows.append((s.embeddings_table_repo, f"r{i:03d}", text,
                         {"namespace": "default", "repo": repo}))
            rows.append((s.embeddings_table_catalog, f"k{i:03d}", text,
                         {"namespace": "default"}))
    return rows


class ProjectionEncoder:
    """Generic unit vectors, a seeded draw per text (no exact ties)."""

    dim = DIM

    def encode(self, texts, kind="passage"):
        out = np.stack([np.random.default_rng(zlib.crc32(f"{kind}:{t}".encode())).normal(size=DIM)
                        for t in texts]).astype(np.float32)
        return out / np.linalg.norm(out, axis=1, keepdims=True)


def _stores(rng, enc):
    """The JAX host store, the port's host store and the port's device index
    (CPU) over one corpus embedded by ``enc``."""
    j_store, t_store = JMemoryVectorStore(), MemoryVectorStore()
    t_dev = DeviceIndexedStore(MemoryVectorStore(), k_bucket=16, max_wave=8, device="cpu")
    for table, did, text, meta in _corpus(rng):
        vec = enc.encode([text])[0]
        j_store.upsert(table, [JDoc(did, text, dict(meta), vec.copy())])
        t_store.upsert(table, [Doc(did, text, dict(meta), vec.copy())])
        t_dev.upsert(table, [Doc(did, text, dict(meta), vec.copy())])
    return j_store, t_store, t_dev


def _same(a, b, exact=False):
    assert [d.doc_id for d in a] == [d.doc_id for d in b]
    assert [d.depth for d in a] == [d.depth for d in b]
    if exact:
        assert [d.score for d in a] == [d.score for d in b]
    np.testing.assert_allclose([d.score for d in a], [d.score for d in b], atol=1e-5)


def _same_lists(want, got, exact=False):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        _same(a, b, exact)


def test_scope_retrievers_match_jax():
    rng = np.random.default_rng(0)
    j_store, t_store, _ = _stores(rng, HashingTextEncoder(DIM))
    j_fac = j_retrievers.RetrieverFactory(j_store, JHashingTextEncoder(DIM), coalescer=False)
    t_fac = RetrieverFactory(t_store, HashingTextEncoder(DIM), coalescer=False)
    queries = [" ".join(rng.choice(WORDS, size=4)) for _ in range(5)]
    for scope in SCOPE_SPECS:
        for flt, top_k in ((None, None), ({"repo": "repo1"}, 3)):
            _same_lists(j_fac.for_scope(scope).retrieve_many(queries, flt, top_k=top_k),
                        t_fac.for_scope(scope).retrieve_many(queries, flt, top_k=top_k),
                        exact=True)
            _same(j_fac.retrieve(scope, queries[0], flt, top_k=top_k),
                  t_fac.retrieve(scope, queries[0], flt, top_k=top_k), exact=True)
    with pytest.raises(KeyError, match="unknown scope"):
        t_fac.for_scope("galaxy")


def test_device_index_through_every_scope():
    rng = np.random.default_rng(3)
    enc = ProjectionEncoder()
    _, t_store, t_dev = _stores(rng, enc)
    host = RetrieverFactory(t_store, enc, coalescer=False)
    dev = RetrieverFactory(t_dev, enc, coalescer=False)
    queries = [" ".join(rng.choice(WORDS, size=4)) for _ in range(5)]
    for scope in SCOPE_SPECS:
        for flt in (None, {"repo": "repo2"}):
            _same_lists(host.for_scope(scope).retrieve_many(queries, flt),
                        dev.for_scope(scope).retrieve_many(queries, flt))


def test_mmr_select_matches_jax():
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(12, 8)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    scores = rng.random(12)
    docs = [RetrievedDoc(f"d{i}", "", {}, float(s)) for i, s in enumerate(scores)]
    j_docs = [j_retrievers.RetrievedDoc(f"d{i}", "", {}, float(s)) for i, s in enumerate(scores)]
    vectors = {f"d{i}": v for i, v in enumerate(vecs) if i != 3}  # d3: relevance only
    for lam in (0.0, 0.3, 1.0):
        assert ([d.doc_id for d in mmr_select(docs, vectors, 6, lam)]
                == [d.doc_id for d in j_retrievers.mmr_select(j_docs, vectors, 6, lam)])


def test_coalescer_equals_the_direct_path_under_8_threads():
    rng = np.random.default_rng(2)
    enc = ProjectionEncoder()
    _, _, t_dev = _stores(rng, enc)
    table = config.get_settings().embeddings_table_chunk
    co = RetrievalCoalescer(t_dev, enc, max_wave=8)
    direct = RetrieverFactory(t_dev, enc, coalescer=False).for_scope("chunk")
    coalesced = RetrieverFactory(t_dev, enc, coalescer=co).for_scope("chunk")
    queries = [" ".join(rng.choice(WORDS, size=3)) for _ in range(32)]
    want = [direct.retrieve(q) for q in queries]
    want_hits = [t_dev.search(table, enc.encode([q], kind="query")[0], 3) for q in queries]
    waves0 = histogram_stats(RETRIEVAL_WAVE_SIZE)["count"]
    got, got_hits, errors = {}, {}, []
    barrier = threading.Barrier(8)

    def caller(t):
        try:
            barrier.wait(10)
            for i in range(t, len(queries), 8):
                got[i] = coalesced.retrieve(queries[i])
                got_hits[i] = co.search_text(table, queries[i], 3)[1]
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=caller, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    co.close()
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(len(queries)):
        _same(want[i], got[i])
        assert [h.doc.doc_id for h in got_hits[i]] == [h.doc.doc_id for h in want_hits[i]]
    waves = histogram_stats(RETRIEVAL_WAVE_SIZE)["count"] - waves0
    assert 0 < waves <= 2 * len(queries)  # every call went through a wave


def test_coalescer_propagates_errors_and_recovers():
    class Boom:
        dim = 8
        fail = True

        def encode(self, texts, kind="passage"):
            if self.fail:
                raise RuntimeError("encoder down")
            return np.ones((len(texts), 8), dtype=np.float32)

    enc = Boom()
    co = RetrievalCoalescer(MemoryVectorStore(), enc, max_wave=4)
    with pytest.raises(RuntimeError, match="encoder down"):
        co.search_text("embeddings", "q", 3)
    enc.fail = False  # the drain thread survives a failed wave
    qvec, hits = co.search_text("embeddings", "q", 3)
    assert hits == [] and qvec.shape == (8,)
    co.close()
    with pytest.raises(RuntimeError, match="closed"):
        co.search_text("embeddings", "q", 3)


def test_factory_device_index_rule(monkeypatch):
    """DEVICE_INDEX=auto (the default) and on wrap the store in the device
    index on the card: without one they raise unless device="cpu" (the
    JAX package keeps the host store off a TPU); off keeps the host store."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: auto wraps on it")
    for mode in ("auto", "on"):
        monkeypatch.setenv("DEVICE_INDEX", mode)
        config.reload_settings()
        factory.reset_store()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory.get_store()
        factory.reset_store()
        store = factory.get_store(device="cpu")
        assert isinstance(store, DeviceIndexedStore) and store.device.type == "cpu"
        assert factory.get_store() is store  # process-wide once built
    monkeypatch.setenv("DEVICE_INDEX", "auto")
    config.reload_settings()
    j_reload_settings()  # the JAX rule, for contrast: auto keeps the host store off a TPU
    from githubrepostorag_tpu.store import factory as j_factory

    assert not j_factory._device_index_enabled(j_factory.get_settings())
    factory.reset_store()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrieverFactory(encoder=HashingTextEncoder(DIM))  # the store it builds
    monkeypatch.setenv("DEVICE_INDEX", "off")
    config.reload_settings()
    factory.reset_store()
    assert type(factory.get_store()) is MemoryVectorStore


def test_factory_backends_and_live_front(monkeypatch, tmp_path):
    from githubrepostorag_tpu_torch.store.cassandra import CassandraVectorStore
    from githubrepostorag_tpu_torch.store.native import NativeVectorStore
    from tests.torch_minicassandra import MiniCassandra

    monkeypatch.setenv("DEVICE_INDEX", "off")
    monkeypatch.setenv("STORE_BACKEND", "native")
    config.reload_settings()
    factory.reset_store()
    assert type(factory.get_store(device="cpu")) is NativeVectorStore
    factory.reset_store()
    server = MiniCassandra()
    monkeypatch.setenv("STORE_BACKEND", "cassandra")
    monkeypatch.setenv("CASSANDRA_HOST", "127.0.0.1")
    monkeypatch.setenv("CASSANDRA_PORT", str(server.start()))
    config.reload_settings()
    try:
        store = factory.get_store(device="cpu")
        assert type(store) is CassandraVectorStore and store.health()["status"] == "UP"
    finally:
        factory.reset_store()
        server.stop()
    monkeypatch.setenv("DEVICE_INDEX", "on")
    monkeypatch.setenv("STORE_BACKEND", "mystery")
    config.reload_settings()
    with pytest.raises(ValueError, match="Unknown STORE_BACKEND"):
        factory.get_store(device="cpu")
    monkeypatch.setenv("STORE_BACKEND", "memory")
    monkeypatch.setenv("LIVE_INDEX", "on")
    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    config.reload_settings()
    store = factory.get_store(device="cpu")
    assert isinstance(store, LiveIndexedStore) and isinstance(store.store, DeviceIndexedStore)
    assert get_live_applier() is store.applier
    enc = HashingTextEncoder(DIM)
    store.upsert("t", [Doc(f"d{i}", f"alpha {i}", {}, enc.encode([f"alpha {i}"])[0])
                       for i in range(4)])
    assert store.applier.flush(timeout=10) and store.count("t") == 4
    assert (tmp_path / "mutation_log.jsonl").exists()  # DATA_DIR's durable log
    thread = store.applier._thread
    assert thread is not None and thread.is_alive()
    factory.reset_store()  # stops the drain thread and clears the registry
    assert get_live_applier() is None and not thread.is_alive()


def test_factory_builds_on_the_given_device(monkeypatch):
    monkeypatch.setenv("EMBED_MODEL", "/nonexistent")
    config.reload_settings()
    fac = RetrieverFactory(device="cpu")
    assert fac.coalescer is not None  # RETRIEVAL_COALESCE defaults on
    assert isinstance(fac.store, DeviceIndexedStore) and fac.store.device.type == "cpu"
    assert isinstance(fac.encoder, HashingTextEncoder)
    fac.coalescer.close()
    monkeypatch.setenv("RETRIEVAL_COALESCE", "0")
    config.reload_settings()
    assert RetrieverFactory(fac.store, fac.encoder).coalescer is None
