"""The port's CQL client, Cassandra store and native store against the JAX
package's: the CQL codec byte for byte, the cases of
``tests/test_cql_wire.py`` and ``tests/test_cassandra_cql.py`` run for the
port's store (over ``tests/minicassandra.py``, whose codec is the JAX
package's, so the port's wire is held to an independent codec), the same
docs through both packages' stores, ``tests/torch_minicassandra.py``
against ``tests/minicassandra.py`` reply for reply, the native store built
into the port's ``_build/``, and the factory's ``native`` and ``cassandra``
backends under the device index.  One stand-in server a kind, shared by
the module (a stop costs 0.5 s), its tables cleared before each test."""

from __future__ import annotations

import hashlib
import socket
import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from githubrepostorag_tpu.store import cql as j_cql
from githubrepostorag_tpu.store.base import Doc as JDoc
from githubrepostorag_tpu.store.cassandra import CassandraVectorStore as JCassandra
from githubrepostorag_tpu.store.memory import MemoryVectorStore as JMemory
from githubrepostorag_tpu.store.native import NativeVectorStore as JNative
from githubrepostorag_tpu_torch import config
from githubrepostorag_tpu_torch.resilience import reset_faults
from githubrepostorag_tpu_torch.resilience.faults import get_registry
from githubrepostorag_tpu_torch.retrieval import DeviceIndexedStore
from githubrepostorag_tpu_torch.store import cql, factory, native
from githubrepostorag_tpu_torch.store.base import Doc
from githubrepostorag_tpu_torch.store.cassandra import CassandraVectorStore
from githubrepostorag_tpu_torch.store.cql import CQLError, CQLSession
from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore
from githubrepostorag_tpu_torch.store.native import NativeVectorStore
from tests.minicassandra import MiniCassandra
from tests.torch_minicassandra import MiniCassandra as TorchMiniCassandra

DIM = 8


def _reset(srv) -> None:
    srv.tables.clear()
    srv.dims.clear()
    srv.keyspaces.clear()
    srv.prepared.clear()
    srv.queries.clear()


class _KillableCassandra(MiniCassandra):
    """MiniCassandra that dies mid-exchange: when a QUERY containing
    ``kill_on`` arrives it records the query, then closes the connection
    without replying (a node crash between request and response)."""

    kill_on: str | None = None

    def _run(self, cql: str):
        if self.kill_on and self.kill_on in cql:
            self.kill_on = None  # one-shot: the replayed request succeeds
            raise ConnectionError("server killed mid-exchange")
        return super()._run(cql)


@pytest.fixture(scope="module")
def servers():
    made = SimpleNamespace(jax=MiniCassandra(), port=TorchMiniCassandra(),
                           killable=_KillableCassandra())
    for srv in vars(made).values():
        srv.start()
    yield made
    for srv in vars(made).values():
        srv.stop()


@pytest.fixture()
def server(servers):
    _reset(servers.jax)
    return servers.jax


@pytest.fixture()
def killable(servers):
    _reset(servers.killable)
    servers.killable.kill_on = None
    return servers.killable


@pytest.fixture()
def store(server):
    return CassandraVectorStore(hosts=["127.0.0.1"], port=server.port, keyspace="ks",
                                embed_dim=DIM)


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    config.reload_settings()
    reset_faults()
    yield
    monkeypatch.undo()
    config.reload_settings()
    reset_faults()
    factory.reset_store()


def _vec(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=DIM).astype(np.float32)


def _docs(n: int, doc=Doc, **meta) -> list:
    return [doc(f"doc-{i}", f"body {i}", {"kind": "chunk", **meta}, _vec(i)) for i in range(n)]


# ------------------------------------------------------------- the codec

VEC = ("vector", 5)
MAP = ("map", (cql.TYPE_VARCHAR,), (cql.TYPE_VARCHAR,))
CODEC_CASES = [
    (VEC, np.random.default_rng(1).normal(size=5).astype(np.float32)),
    (VEC, [0.0, -0.0, 1e-38, 3.4e38, -1.5]),
    (MAP, {"repo": "api", "λ": "µ 🚀", "": "it's"}),
    (("list", (cql.TYPE_INT,)), [1, -2, 2 ** 31 - 1]),
    (("list", (cql.TYPE_VARCHAR,)), ["a", "b'c", ""]),
    ((cql.TYPE_VARCHAR,), "héllo 世界"),
    ((cql.TYPE_ASCII,), "plain"),
    ((cql.TYPE_INT,), -123456),
    ((cql.TYPE_BIGINT,), 2 ** 40 + 3),
    ((cql.TYPE_COUNTER,), 7),
    ((cql.TYPE_FLOAT,), 0.1),
    ((cql.TYPE_DOUBLE,), 0.1),
    ((cql.TYPE_BOOLEAN,), True),
    ((cql.TYPE_BOOLEAN,), False),
    (MAP, None),
]


@pytest.mark.parametrize("t,value", CODEC_CASES,
                         ids=[f"{i}-{t[0]}" for i, (t, _) in enumerate(CODEC_CASES)])
def test_codec_bytes_and_values_equal_jax(t, value):
    data = cql.encode_value(t, value)
    assert data == j_cql.encode_value(t, value)
    got, ref = cql.decode_value(t, data), j_cql.decode_value(t, data)
    if isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref and type(got) is type(ref)


def test_type_options_and_errors_equal_jax():
    cls = "org.apache.cassandra.db.marshal.VectorType(org.apache.cassandra.db.marshal.FloatType, 384)"
    options = (struct.pack(">H", cql.TYPE_CUSTOM) + cql._string(cls)
               + struct.pack(">HHH", cql.TYPE_MAP, cql.TYPE_VARCHAR, cql.TYPE_VARCHAR)
               + struct.pack(">HH", cql.TYPE_SET, cql.TYPE_BIGINT)
               + struct.pack(">H", cql.TYPE_CUSTOM) + cql._string("some.Custom"))
    port_buf, jax_buf = cql._Buf(options), j_cql._Buf(options)
    got = [cql.read_type(port_buf) for _ in range(4)]
    assert got == [j_cql.read_type(jax_buf) for _ in range(4)]
    assert got[0] == ("vector", 384)
    for mod in (cql, j_cql):
        with pytest.raises(mod.CQLError, match="vector dim 3 != column dim 5"):
            mod.encode_value(VEC, [1.0, 2.0, 3.0])
        with pytest.raises(mod.CQLError, match="truncated"):
            mod._Buf(b"\x00").i32()
    assert cql._string_map({"CQL_VERSION": "3.0.0"}) == j_cql._string_map({"CQL_VERSION": "3.0.0"})
    assert cql._long_string("é") == j_cql._long_string("é") and cql._bytes(None) == j_cql._bytes(None)


LITERALS = [None, "it's", True, False, 3, -2.5, np.float64(1.5), np.int32(2), np.float32(0.25),
            {"a": "b'c", "k": 1}, np.arange(3, dtype=np.float32), [1, "x", None], ("t", 2.0)]


def test_cql_literal_and_interpolate_equal_jax():
    for value in LITERALS:
        assert cql.cql_literal(value) == j_cql.cql_literal(value), value
    rng = np.random.default_rng(5)
    statements = [
        ("UPDATE t SET note = '50%savings' WHERE row_id = %s", ("r1",)),
        ("x = %s AND y = '%s it''s %s' AND z = %s", (1, 2)),
        ("SELECT * FROM t", None),
        ("SELECT a FROM t WHERE m[%s] = %s AND v = %s LIMIT %s",
         ("k'ey", "v", rng.normal(size=4).astype(np.float32), 10)),
    ]
    for stmt, params in statements:
        assert cql.interpolate(stmt, params) == j_cql.interpolate(stmt, params)
    for stmt, params in [("SELECT * FROM t WHERE v LIKE '%sql%'", ("extra",)),
                         ("a %s %s", ("one",)), ("DELETE FROM t WHERE row_id = %s", [])]:
        for mod in (cql, j_cql):
            with pytest.raises(ValueError):
                mod.interpolate(stmt, params)
    for mod in (cql, j_cql):
        with pytest.raises(TypeError):
            mod.cql_literal(object())


# ------------------------- tests/test_cql_wire.py's cases, the port's store

def test_auth_handshake_and_health(server, store):
    assert store.health() == {"status": "UP", "tables": {}}
    assert any(q.startswith("CREATE KEYSPACE") for q in server.queries)


def test_bad_credentials_rejected(server):
    with pytest.raises(CQLError, match="Bad credentials"):
        CQLSession("127.0.0.1", server.port, username="x", password="nope")


def test_upsert_is_prepared_and_idempotent(server, store):
    docs = _docs(3)
    assert store.upsert("chunks", docs) == 3
    assert store.upsert("chunks", docs) == 3  # keyed by row_id
    assert store.count("chunks") == 3
    assert any(q.startswith("PREPARE INSERT INTO ks.chunks") for q in server.queries)
    assert sum(q.startswith("PREPARE") for q in server.queries) == 1


def test_vector_roundtrip_exact(store):
    v = _vec(42)
    store.upsert("chunks", [Doc("d", "t", {}, v)])
    np.testing.assert_array_equal(store.get("chunks", "d").vector, v)


def test_ann_search_orders_by_cosine(store):
    store.upsert("chunks", _docs(8))
    hits = store.search("chunks", _vec(3), k=3)
    assert hits[0].doc.doc_id == "doc-3" and hits[0].score == pytest.approx(1.0, abs=1e-5)
    assert len(hits) == 3 and hits[0].score >= hits[1].score >= hits[2].score


def test_search_with_metadata_filter(store):
    store.upsert("chunks", _docs(4, repo="a"))
    store.upsert("chunks", [Doc("other", "x", {"kind": "chunk", "repo": "b"}, _vec(9))])
    hits = store.search("chunks", _vec(9), k=10, filter={"repo": "b"})
    assert [h.doc.doc_id for h in hits] == ["other"]


def test_find_by_metadata_and_entries_fallback(store):
    store.upsert("files", [Doc("f1", "x", {"topics": "kafka"}, _vec(1))])
    assert [d.doc_id for d in store.find_by_metadata("files", {"topics": "kafka"})] == ["f1"]


def test_get_missing_returns_none(store):
    store.upsert("chunks", _docs(1))
    assert store.get("chunks", "nope") is None
    assert store.get("chunks", "doc-0").text == "body 0"


def test_delete_returns_rows_actually_removed(store):
    store.upsert("chunks", _docs(2))
    assert store.delete("chunks", ["doc-0", "ghost"]) == 1
    assert store.count("chunks") == 1


def test_tables_lists_created_tables(store):
    store.upsert("chunks", _docs(1))
    store.upsert("files", _docs(1))
    assert store.tables() == ["chunks", "files"]


def test_quote_escaping_survives_the_wire(store):
    tricky = "it's a 'quoted' id"
    store.upsert("chunks", [Doc(tricky, "o'body", {"k": "v'al"}, _vec(5))])
    got = store.get("chunks", tricky)
    assert got is not None and got.text == "o'body" and got.metadata["k"] == "v'al"
    assert store.delete("chunks", [tricky]) == 1


def test_reconnect_after_connection_drop(store):
    store.upsert("chunks", _docs(1))
    store._session._sock.close()  # a server restart / LB reap
    assert store.count("chunks") == 1  # the simple statement path reconnects
    store._session._sock.close()
    assert store.upsert("chunks", _docs(2)) == 2  # the prepared EXECUTE path too
    assert store.health()["status"] == "UP"


def test_idempotent_request_is_replayed_after_mid_exchange_death(killable):
    sess = CQLSession("127.0.0.1", killable.port)
    killable.kill_on = "release_version"
    rs = sess.execute("SELECT release_version FROM system.local")
    assert rs.one().release_version == "5.0-mini"
    assert len([q for q in killable.queries if "release_version" in q]) == 2  # + the replay
    sess.close()


def test_non_idempotent_request_is_not_replayed(killable):
    sess = CQLSession("127.0.0.1", killable.port)
    killable.kill_on = "USE ks_counter"
    with pytest.raises((CQLError, OSError)):
        sess.execute("USE ks_counter", idempotent=False)
    assert len([q for q in killable.queries if "ks_counter" in q]) == 1  # never replayed
    rs = sess.execute("SELECT release_version FROM system.local")  # already reconnected
    assert rs.one().release_version == "5.0-mini"
    sess.close()


def test_injected_cql_fault_exercises_the_replay_path(killable, monkeypatch):
    sess = CQLSession("127.0.0.1", killable.port)  # the handshake takes no fault
    monkeypatch.setenv("FAULTS", "cql.exchange:error@2")
    config.reload_settings()
    reset_faults()
    for _ in range(4):  # calls 2, 4, ... fault then replay
        rs = sess.execute("SELECT release_version FROM system.local")
        assert rs.one().release_version == "5.0-mini"
    assert sum(e["fired"] for e in get_registry().stats()["cql.exchange"]) >= 2
    sess.close()


def test_unicode_text_roundtrip(store):
    store.upsert("chunks", [Doc("u", "héllo 世界 🚀", {"λ": "µ"}, _vec(6))])
    got = store.get("chunks", "u")
    assert got.text == "héllo 世界 🚀" and got.metadata == {"λ": "µ"}


# ------------ tests/test_cassandra_cql.py's cases: statements, both packages

class FakeResult:
    def __init__(self, rows):
        self._rows = rows

    def __iter__(self):
        return iter(self._rows)

    def one(self):
        return self._rows[0] if self._rows else None


class FakePrepared:
    def __init__(self, cql):
        self.cql = cql


class FakeSession:
    """Records every (cql, params) pair; scripted results by substring (a
    callable script sees the params)."""

    def __init__(self):
        self.calls: list[tuple[str, object]] = []
        self.results: list[tuple[str, object]] = []

    def script(self, substring: str, rows) -> None:
        self.results.append((substring, rows))

    def prepare(self, cql: str) -> FakePrepared:
        self.calls.append(("PREPARE", cql))
        return FakePrepared(cql)

    def execute(self, cql, params=None):
        text = cql.cql if isinstance(cql, FakePrepared) else cql
        self.calls.append((text, params))
        for sub, rows in self.results:
            if sub in text:
                return FakeResult(rows(params) if callable(rows) else rows)
        return FakeResult([])


def _fake_store(cls, session):
    store = cls.__new__(cls)
    store._session = session
    store._ks = "vector_store"
    store._dim = 4
    store._known_tables = set()
    store._insert_stmts = {}
    return store


def on_fake_sessions(op, script=()):
    """``op(store, Doc)`` on both packages' stores over recording fake
    sessions with the same script; the statements, parameters and results
    must be equal.  Returns the port's (session, result)."""
    out = {}
    for side, cls, doc in (("port", CassandraVectorStore, Doc), ("jax", JCassandra, JDoc)):
        session = FakeSession()
        for sub, rows in script:
            session.script(sub, rows)
        result = op(_fake_store(cls, session), doc)
        if isinstance(result, list):
            result = [(getattr(h, "doc", h).doc_id, getattr(h, "score", None)) for h in result]
        out[side] = (session, result)
    assert out["port"][0].calls == out["jax"][0].calls
    assert out["port"][1] == out["jax"][1]
    return out["port"]


def test_ensure_table_issues_schema_and_sai_indexes():
    s, _ = on_fake_sessions(lambda st, D: st.upsert("embeddings", []))
    ddl = [c[0] for c in s.calls]
    table_ddl = next(d for d in ddl if "CREATE TABLE IF NOT EXISTS vector_store.embeddings" in d)
    for col in ("row_id TEXT PRIMARY KEY", "body_blob TEXT", "vector VECTOR<FLOAT, 4>",
                "metadata_s MAP<TEXT, TEXT>"):
        assert col in table_ddl
    assert any("StorageAttachedIndex" in d and "(vector)" in d for d in ddl)
    assert any("entries(metadata_s)" in d for d in ddl)


def test_upsert_uses_prepared_statement_with_question_marks():
    s, n = on_fake_sessions(lambda st, D: st.upsert("embeddings", [
        D("id1", "hello", {"topics": "kafka"}, np.asarray([1, 2, 3, 4], dtype=np.float32))]))
    assert n == 1
    prepare = next(c for c in s.calls if c[0] == "PREPARE")
    assert prepare[1].count("?") == 4 and "%s" not in prepare[1]
    _, params = next(c for c in s.calls if c[0].startswith("INSERT"))
    assert params == ("id1", "hello", [1.0, 2.0, 3.0, 4.0], {"topics": "kafka"})


def test_unprepared_statements_use_percent_s_never_question_marks():
    def op(st, D):
        st.get("embeddings", "id1")
        st.count("embeddings")
        st.delete("embeddings", ["id1"])
        st.find_by_metadata("embeddings", {"repo": "svc"})
    s, _ = on_fake_sessions(op)
    for text, _ in s.calls:
        if not text.startswith(("CREATE", "PREPARE", "INSERT")):
            assert "?" not in text, text


def test_search_ann_cql_shape_and_params():
    row = SimpleNamespace(row_id="r1", body_blob="text", metadata_s={"repo": "svc"}, score=0.9)
    s, hits = on_fake_sessions(
        lambda st, D: st.search("embeddings", np.asarray([0.1, 0.2, 0.3, 0.4]), k=5,
                                filter={"repo": "svc"}),
        [("ORDER BY vector ANN OF", [row])])
    text, params = next(c for c in s.calls if "ANN OF" in c[0])
    assert "similarity_cosine(vector, %s)" in text and "WHERE metadata_s[%s] = %s" in text
    assert text.endswith("ORDER BY vector ANN OF %s LIMIT %s")
    assert params[0] == params[-2] == pytest.approx([0.1, 0.2, 0.3, 0.4])
    assert params[1:3] == ["repo", "svc"] and params[-1] == 5
    assert hits == [("r1", pytest.approx(0.9))]


def test_search_shredded_topics_filter_uses_entry_form():
    row = SimpleNamespace(row_id="r1", body_blob="t", metadata_s={}, score=1.0)
    s, _ = on_fake_sessions(
        lambda st, D: st.search("embeddings", np.asarray([0.0, 0.0, 0.0, 1.0]), k=3,
                                filter={"topics": "Kafka"}),
        [("topics:kafka", [row])])
    _, params = next(c for c in s.calls if "ANN OF" in c[0])
    assert params[1:3] == ["topics:kafka", "1"]


def test_search_falls_back_to_plain_equality_for_preshred_rows():
    old = SimpleNamespace(row_id="old", body_blob="t", metadata_s={"topics": "kafka"}, score=1.0)
    s, hits = on_fake_sessions(
        lambda st, D: st.search("embeddings", np.asarray([0.0, 0.0, 0.0, 1.0]), k=3,
                                filter={"topics": "kafka"}),
        [("ANN OF", lambda params: [] if "topics:kafka" in params else [old])])
    assert [h[0] for h in hits] == ["old"]
    ann = [c for c in s.calls if "ANN OF" in c[0]]
    assert len(ann) == 2 and "topics:kafka" in ann[0][1] and "kafka" in ann[1][1]


def test_find_by_metadata_cql_and_fallback():
    row = SimpleNamespace(row_id="r2", body_blob="b", metadata_s={"module": "api"})
    s, docs = on_fake_sessions(
        lambda st, D: st.find_by_metadata("embeddings", {"module": "api"}, limit=7),
        [("WHERE metadata_s", [row])])
    text, params = next(c for c in s.calls if "WHERE metadata_s" in c[0])
    assert text.startswith("SELECT row_id, body_blob, metadata_s, vector FROM vector_store.embeddings")
    assert params == ["module", "api", 7] and [d[0] for d in docs] == ["r2"]


def test_delete_checks_existence_first():
    s, n = on_fake_sessions(lambda st, D: st.delete("embeddings", ["a"]),
                            [("SELECT row_id FROM", [SimpleNamespace(row_id="a")])])
    assert n == 1
    kinds = [c[0] for c in s.calls]
    sel = next(i for i, c in enumerate(kinds) if c.startswith("SELECT row_id"))
    dele = next(i for i, c in enumerate(kinds) if c.startswith("DELETE"))
    assert sel < dele


def test_health_probe_is_lightweight():
    s, health = on_fake_sessions(
        lambda st, D: st.health(),
        [("system.local", [SimpleNamespace(release_version="5.0")]),
         ("system_schema.tables", [SimpleNamespace(table_name="embeddings")])])
    assert health == {"status": "UP", "tables": {"embeddings": -1}}
    assert not [c for c in s.calls if "COUNT(*)" in c[0]]  # liveness must not full-scan


def test_unfiltered_find_by_metadata_issues_no_where():
    """The standing divergence: the device index seeds from
    ``find_by_metadata(table, {}, limit)``; the port sends no WHERE, the
    JAX store ``WHERE  LIMIT``, which a Cassandra node refuses."""
    port = FakeSession()
    _fake_store(CassandraVectorStore, port).find_by_metadata("t", {}, limit=9)
    jax_side = FakeSession()
    _fake_store(JCassandra, jax_side).find_by_metadata("t", {}, limit=9)
    assert port.calls[-1] == ("SELECT row_id, body_blob, metadata_s, vector FROM "
                              "vector_store.t LIMIT %s", [9])
    assert jax_side.calls[-1][0].endswith("WHERE  LIMIT %s")


# -------------------------------------- both packages' stores, same docs

def test_same_docs_give_equal_results_through_both_stores(servers):
    """The same docs upserted through the JAX store (over minicassandra,
    the JAX codec) and the port's (over torch_minicassandra, the port's
    codec): search, find_by_metadata (filtered and not), get, count,
    delete and tables agree."""
    _reset(servers.jax)
    _reset(servers.port)
    stores = {"jax": JCassandra(hosts=["127.0.0.1"], port=servers.jax.port, keyspace="ks",
                                embed_dim=DIM),
              "port": CassandraVectorStore(hosts=["127.0.0.1"], port=servers.port.port,
                                           keyspace="ks", embed_dim=DIM)}
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(40, DIM)).astype(np.float32)
    rows = [(f"r{i}", f"text {i} it's", {"repo": f"repo{i % 3}", "topics": "kafka,redis"
                                          if i % 4 == 0 else "cql", "namespace": "default"})
            for i in range(40)]

    def run(side):
        st, D = stores[side], (JDoc if side == "jax" else Doc)
        st.upsert("chunks", [D(i, t, m, v) for (i, t, m), v in zip(rows, vecs)])
        st.upsert("files", [D("f1", "file", {"repo": "repo0"}, vecs[0])])
        out = []
        for q in vecs[:3]:
            for flt in (None, {"repo": "repo1"}, {"topics": "kafka"}):
                out.append([(h.doc.doc_id, h.doc.text, h.doc.metadata, h.score,
                             h.doc.vector.tolist()) for h in st.search("chunks", q, 5, flt)])
        for flt, limit in (({"repo": "repo2"}, 100), ({"topics": "redis"}, 3), ({}, 100)):
            out.append([(d.doc_id, d.metadata) for d in st.find_by_metadata("chunks", flt, limit)])
        got = st.get("chunks", "r7")
        out.append((got.doc_id, got.text, got.metadata, got.vector.tolist(),
                    st.get("chunks", "nope")))
        out.append((st.count("chunks"), st.delete("chunks", ["r1", "ghost"]), st.count("chunks"),
                    st.tables(), st.health()))
        return out

    port, jax_side = run("port"), run("jax")
    assert port == jax_side
    assert len(port[-3]) == 40 and port[-1][:3] == (40, 1, 39)


def _exchange(port: int, frames: list[bytes]) -> list[bytes]:
    """Send each request frame over one socket, read each reply frame."""
    replies = []
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        for frame in frames:
            sock.sendall(frame)
            header = b""
            while len(header) < 9:
                header += sock.recv(9 - len(header))
            length = struct.unpack(">i", header[5:9])[0]
            body = b""
            while len(body) < length:
                body += sock.recv(length - len(body))
            replies.append(header + body)
    return replies


def test_torch_minicassandra_replies_as_minicassandra(servers):
    """The same request bytes get the same reply bytes from the stand-in
    built on the port's codec as from the one built on the JAX codec."""
    _reset(servers.jax)
    _reset(servers.port)

    def frame(stream, op, body):
        return struct.pack(">BBhBi", cql.VERSION_REQ, 0, stream, op, len(body)) + body

    def query(stream, text):
        return frame(stream, cql.OP_QUERY, cql._long_string(text) + struct.pack(">HB", 1, 0))

    insert = "INSERT INTO ks.t (row_id, body_blob, vector, metadata_s) VALUES (?, ?, ?, ?)"
    qid = hashlib.md5(insert.encode()).digest()
    vec = ("vector", 4)
    values = [cql._bytes(cql.encode_value((cql.TYPE_VARCHAR,), "r'1")),
              cql._bytes(cql.encode_value((cql.TYPE_VARCHAR,), "body é")),
              cql._bytes(cql.encode_value(vec, [0.5, -1.0, 2.0, 0.25])),
              cql._bytes(cql.encode_value(MAP, {"repo": "a", "k": "v"}))]
    execute = (struct.pack(">H", len(qid)) + qid + struct.pack(">HB", 1, 1)
               + struct.pack(">H", 4) + b"".join(values))
    frames = [
        query(1, "SELECT release_version FROM system.local"),  # before auth: refused
        frame(2, cql.OP_STARTUP, cql._string_map({"CQL_VERSION": "3.0.0"})),
        frame(3, cql.OP_AUTH_RESPONSE, cql._bytes(b"\x00cassandra\x00cassandra")),
        query(4, "CREATE KEYSPACE IF NOT EXISTS ks WITH REPLICATION = {}"),
        query(5, "CREATE TABLE IF NOT EXISTS ks.t (row_id TEXT PRIMARY KEY, vector VECTOR<FLOAT, 4>)"),
        frame(6, cql.OP_PREPARE, cql._long_string(insert)),
        frame(7, cql.OP_EXECUTE, execute),
        query(8, "SELECT row_id, body_blob, metadata_s, vector FROM ks.t WHERE row_id = 'r''1'"),
        query(9, "SELECT row_id, body_blob, metadata_s, vector, similarity_cosine(vector, "
                 "[1.0, 0.0, 0.0, 0.0]) AS score FROM ks.t WHERE metadata_s['repo'] = 'a' "
                 "ORDER BY vector ANN OF [1.0, 0.0, 0.0, 0.0] LIMIT 3"),
        query(10, "SELECT COUNT(*) AS n FROM ks.t"),
        query(11, "SELECT table_name FROM system_schema.tables WHERE keyspace_name = 'ks'"),
        query(12, "DROP TABLE ks.t"),
        frame(13, 0x0B, b""),
    ]
    port, jax_side = _exchange(servers.port.port, frames), _exchange(servers.jax.port, frames)
    assert port == jax_side
    assert [r[4] for r in port] == [cql.OP_ERROR, cql.OP_AUTHENTICATE, cql.OP_AUTH_SUCCESS] + \
        [cql.OP_RESULT] * 8 + [cql.OP_ERROR] * 2


# ------------------------------------------------------- the native store

def _seeded(stores, n=200, d=32, dup=None, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    if dup is not None:
        vecs[dup] = vecs[7]
    for store, D in stores:
        store.upsert("embeddings", [D(f"d{i}", f"text {i}", {"repo": "r" + str(i % 3)}, vecs[i])
                                    for i in range(n)])
    return vecs, rng


def _ranked(hits):
    return [h.doc.doc_id for h in hits], np.array([h.score for h in hits])


def test_native_store_builds_in_the_ports_build_dir():
    store = NativeVectorStore()
    assert store.backend == "native" and native._get_lib() is not None
    lib = Path(native._get_lib()._name)
    assert lib.parent == Path(native.__file__).resolve().parents[1] / "_build"
    assert lib.name.startswith("libvecsearch-") and native._SOURCE.name == "vecsearch.cpp"


@pytest.mark.parametrize("flt", [None, {"repo": "r1"}], ids=["plain", "filter"])
def test_native_ranks_as_jax_native_and_the_memory_stores(flt):
    port, jax_native, memory, jax_memory = NativeVectorStore(), JNative(), MemoryVectorStore(), \
        JMemory()
    vecs, rng = _seeded([(port, Doc), (jax_native, JDoc), (memory, Doc), (jax_memory, JDoc)])
    for q in [rng.normal(size=32).astype(np.float32) for _ in range(6)] + [vecs[3]]:
        for k in (1, 5, 10, 64):
            ids, scores = _ranked(port.search("embeddings", q, k, flt))
            for ref in (jax_native, memory, jax_memory):
                ref_ids, ref_scores = _ranked(ref.search("embeddings", q, k, flt))
                assert ids == ref_ids
                np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-6)
            if flt:
                assert all(port.get("embeddings", i).metadata["repo"] == "r1" for i in ids)


@pytest.mark.parametrize("flt", [None, {"repo": "r1"}], ids=["plain", "filter"])
def test_native_ties_fall_in_insertion_order(flt):
    """The standing divergence: 41 rows with one vector tie on every
    query.  The port's native store returns them in insertion order, as
    the memory store does, at every k (across the k boundary too); the
    JAX native store returns them last-inserted first."""
    port, memory, jax_native = NativeVectorStore(), MemoryVectorStore(), JNative()
    vecs, rng = _seeded([(port, Doc), (memory, Doc), (jax_native, JDoc)], dup=slice(100, 140))
    for q in (vecs[7], vecs[3], rng.normal(size=32).astype(np.float32)):
        for k in (1, 3, 16, 30, 50, 300):
            ids, scores = _ranked(port.search("embeddings", q, k, flt))
            ref_ids, ref_scores = _ranked(memory.search("embeddings", q, k, flt))
            assert ids == ref_ids
            np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-6)
    tied = [i for i in _ranked(port.search("embeddings", vecs[7], 5, flt))[0]]
    jax_tied = _ranked(jax_native.search("embeddings", vecs[7], 5, flt))[0]
    assert tied == sorted(tied, key=lambda d: int(d[1:]))
    assert jax_tied == sorted(jax_tied, key=lambda d: -int(d[1:]))


# ---------------------------------------------------------- the factory

def test_factory_serves_native_and_cassandra_under_the_device_index(servers, monkeypatch):
    """STORE_BACKEND=native | cassandra with DEVICE_INDEX=on on the CPU:
    the backend wrapped in the device index; the Cassandra-backed index
    seeds itself with the rows already in the stand-in."""
    _reset(servers.port)
    monkeypatch.setenv("DEVICE_INDEX", "on")
    monkeypatch.setenv("EMBED_DIM", str(DIM))
    monkeypatch.setenv("STORE_BACKEND", "native")
    config.reload_settings()
    factory.reset_store()
    store = factory.get_store(device="cpu")
    assert isinstance(store, DeviceIndexedStore) and type(store.inner) is NativeVectorStore
    assert store.inner.backend == "native"
    factory.reset_store()

    seed = CassandraVectorStore(hosts=["127.0.0.1"], port=servers.port.port,
                                keyspace="vector_store", embed_dim=DIM)
    docs = _docs(24, repo="svc")
    seed.upsert("embeddings", docs)
    seed.upsert("embeddings_repo", [Doc("repo:svc", "svc", {"repo": "svc"}, _vec(99))])
    monkeypatch.setenv("STORE_BACKEND", "cassandra")
    monkeypatch.setenv("CASSANDRA_HOST", "127.0.0.1")
    monkeypatch.setenv("CASSANDRA_PORT", str(servers.port.port))
    config.reload_settings()
    store = factory.get_store(device="cpu")
    assert isinstance(store, DeviceIndexedStore) and type(store.inner) is CassandraVectorStore
    rows = {t: h["rows"] for t, h in store.health()["device_index"].items()}
    assert rows == {"embeddings": 24, "embeddings_repo": 1}
    host = MemoryVectorStore()
    host.upsert("embeddings", docs)
    for q in (_vec(3), _vec(50)):
        got = store.search("embeddings", q, 5)
        ref = host.search("embeddings", q, 5)
        assert [h.doc.doc_id for h in got] == [h.doc.doc_id for h in ref]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in ref], atol=1e-5)
    assert not any("WHERE  LIMIT" in q for q in servers.port.queries)
