"""The port's device index (on ``device="cpu"``) against the JAX package's
``DeviceIndexedStore`` and ``MemoryVectorStore`` on the same seeded docs.

Parity means: identical top-k ids in identical order (score descending,
then insertion row ascending), scores within 1e-5 (float32 dot products
summed in another order), and the same health counters.  JAX-side stores
stay at capacity <= 256 and max_wave <= 4, so XLA compiles few programs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from githubrepostorag_tpu.retrieval.device_index import DeviceIndexedStore as JDeviceIndexedStore
from githubrepostorag_tpu.store.base import Doc as JDoc
from githubrepostorag_tpu.store.memory import MemoryVectorStore as JMemoryVectorStore
from githubrepostorag_tpu_torch.metrics import DEVICE_INDEX_SEARCHES, counter_value
from githubrepostorag_tpu_torch.retrieval.device_index import DeviceIndexedStore, _top_k
from githubrepostorag_tpu_torch.store.base import Doc
from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

DIM = 24
FILTERS = [None, {"repo": "repo1"}, {"topics": "t0"}, {"repo": "repo0", "topics": "t1"},
           {"repo": "nope"}]


def _docs(rng, n, prefix="d", vectorless_every=0):
    out = []
    for i in range(n):
        vec = None
        if not vectorless_every or i % vectorless_every:
            vec = rng.normal(size=DIM).astype(np.float32)
        meta = {"namespace": "default", "repo": f"repo{i % 3}", "module": f"mod{i % 5}",
                "topics": f"t{i % 2}", f"topics:t{i % 2}": "1"}  # shredded, as ingest writes
        out.append((f"{prefix}{i:04d}", f"text {i}", meta, vec))
    return out


def _both(rows):
    """The same rows as the port's docs and the JAX package's."""
    return ([Doc(i, t, dict(m), None if v is None else v.copy()) for i, t, m, v in rows],
            [JDoc(i, t, dict(m), None if v is None else v.copy()) for i, t, m, v in rows])


def _ids(hits):
    return [h.doc.doc_id for h in hits]


def _scores(hits):
    return [h.score for h in hits]


def _cpu_index(inner=None, **kw):
    return DeviceIndexedStore(inner if inner is not None else MemoryVectorStore(),
                              device="cpu", **kw)


def _assert_same(ref_hits, hits):
    assert _ids(hits) == _ids(ref_hits)
    np.testing.assert_allclose(_scores(hits), _scores(ref_hits), atol=1e-5)


@pytest.mark.parametrize("n_docs", [1, 7, 130])
def test_randomized_parity_with_filters_and_shredded_keys(n_docs):
    rng = np.random.default_rng(n_docs)
    t_docs, j_docs = _both(_docs(rng, n_docs, vectorless_every=9))
    host = JMemoryVectorStore()
    host.upsert("t", j_docs)
    dev = _cpu_index(k_bucket=16, max_wave=8)
    dev.upsert("t", t_docs)
    queries = [rng.normal(size=DIM).astype(np.float32) for _ in range(4)]
    queries.append(np.zeros(DIM, dtype=np.float32))  # zero-norm -> no hits
    for k in (1, 3, 16):
        got = dev.search_batch("t", np.stack(queries * len(FILTERS)), k,
                               [f for f in FILTERS for _ in queries])
        want = [host.search("t", q, k, filter=f) for f in FILTERS for q in queries]
        for g, w in zip(got, want):
            _assert_same(w, g)


def test_ties_break_by_insertion_row():
    """Duplicate vectors tie exactly: both orders are insertion order, at
    the k boundary too, and a deleted and re-inserted doc moves last."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=DIM).astype(np.float32)
    rows = [(f"tie{i}", "same", {"repo": "r"}, v) for i in range(6)] + _docs(rng, 5)
    t_docs, j_docs = _both(rows)
    host, dev = JMemoryVectorStore(), _cpu_index()
    host.upsert("t", j_docs)
    dev.upsert("t", t_docs)
    assert _ids(dev.search("t", v, 4)) == _ids(host.search("t", v, 4)) == [
        f"tie{i}" for i in range(4)]
    for store in (host, dev):
        store.delete("t", ["tie1"])
    dev.upsert("t", [Doc("tie1", "same", {}, v.copy())])
    host.upsert("t", [JDoc("tie1", "same", {}, v.copy())])
    want = ["tie0", "tie2", "tie3", "tie4", "tie5", "tie1"]
    assert _ids(dev.search("t", v, 6)) == _ids(host.search("t", v, 6)) == want
    # anti-parallel query: the ties are the LOWEST scores, still row order
    assert _ids(dev.search("t", -v, 16)) == _ids(host.search("t", -v, 16))


def test_top_k_order_is_score_then_row():
    """The composite key against a stable lexsort, over many exact ties,
    -0.0 next to 0.0, and -inf (masked) rows."""
    rng = np.random.default_rng(3)
    scores = rng.integers(-3, 4, size=(5, 200)).astype(np.float32) / 4
    scores[0, ::7] = -0.0
    scores[1, ::3] = -np.inf
    scores[2] = -np.inf
    vals, idx = _top_k(torch.from_numpy(scores), 16)
    for i in range(scores.shape[0]):
        s = scores[i] + 0.0
        want = np.lexsort((np.arange(s.size), -s))[:16]
        np.testing.assert_array_equal(idx[i].numpy(), want)
        np.testing.assert_array_equal(vals[i].numpy(), s[want])


def test_k_over_the_corpus_and_over_the_bucket():
    rng = np.random.default_rng(3)
    t_docs, j_docs = _both(_docs(rng, 10))
    host, dev = JMemoryVectorStore(), _cpu_index(k_bucket=8)
    host.upsert("t", j_docs)
    dev.upsert("t", t_docs)
    q = rng.normal(size=DIM).astype(np.float32)
    _assert_same(host.search("t", q, 8), dev.search("t", q, 8))  # all 10 rows fit the bucket
    fallback = counter_value(DEVICE_INDEX_SEARCHES, path="fallback")
    device = counter_value(DEVICE_INDEX_SEARCHES, path="device")
    _assert_same(host.search("t", q, 50), dev.search("t", q, 50))  # k > k_bucket: the host
    assert counter_value(DEVICE_INDEX_SEARCHES, path="fallback") == fallback + 1
    dev.search_batch("t", rng.normal(size=(3, DIM)).astype(np.float32), 2)
    assert counter_value(DEVICE_INDEX_SEARCHES, path="device") == device + 3
    assert dev.search("missing", q, 5) == []


def test_upsert_delete_reupsert_and_growth_across_buckets():
    rng = np.random.default_rng(11)
    t_docs, j_docs = _both(_docs(rng, 40))
    host, dev = JMemoryVectorStore(), _cpu_index(min_capacity=4)
    q = rng.normal(size=DIM).astype(np.float32)
    caps = []
    for i, (td, jd) in enumerate(zip(t_docs, j_docs)):  # one doc at a time
        host.upsert("t", [jd])
        dev.upsert("t", [td])
        if i % 6 == 0:
            _assert_same(host.search("t", q, 10), dev.search("t", q, 10))
            caps.append(dev.health()["device_index"]["t"]["capacity"])
    assert caps == [4, 8, 16, 32, 32, 32, 64]  # 1, 7, 13, 19, 25, 31, 37 docs
    h = dev.health()["device_index"]["t"]
    assert h["full_syncs"] == 5  # one whole-table put per capacity bucket searched
    for store in (host, dev):
        store.delete("t", ["d0003", "d0010"])
    _assert_same(host.search("t", q, 10), dev.search("t", q, 10))
    # re-upsert an existing id: same row; a vectorless one leaves the matrix
    host.upsert("t", [JDoc("d0005", "updated", {"repo": "repo9"}, q.copy()),
                      JDoc("d0006", "no vector", {"repo": "repo9"}, None)])
    dev.upsert("t", [Doc("d0005", "updated", {"repo": "repo9"}, q.copy()),
                     Doc("d0006", "no vector", {"repo": "repo9"}, None)])
    for flt in (None, {"repo": "repo9"}, {"repo": "repo1"}):
        _assert_same(host.search("t", q, 5, filter=flt), dev.search("t", q, 5, filter=flt))
    assert _ids(dev.search("t", q, 5, filter={"repo": "repo9"})) == ["d0005"]


def test_wraps_preexisting_inner_rows():
    rng = np.random.default_rng(13)
    t_docs, j_docs = _both(_docs(rng, 20))
    inner, host = MemoryVectorStore(), JMemoryVectorStore()
    inner.upsert("t", t_docs)
    host.upsert("t", j_docs)
    dev = _cpu_index(inner)
    q = rng.normal(size=DIM).astype(np.float32)
    _assert_same(host.search("t", q, 6), dev.search("t", q, 6))


def test_hole_reuse_and_compaction_in_place():
    """Delete / re-upsert churn at capacity reuses holes by compacting in
    place: capacity pinned, no whole-table put, no new shape, parity and
    tie order through every remap; then compact() drains the holes."""
    rng = np.random.default_rng(29)
    t_docs, j_docs = _both(_docs(rng, 50))
    host, dev = JMemoryVectorStore(), _cpu_index(k_bucket=16, max_wave=4)
    host.upsert("t", j_docs)
    dev.upsert("t", t_docs)
    dev.warmup()
    h0 = dev.health()["device_index"]["t"]
    shapes = (dev.search_program_cache_size(), dev.mutation_program_cache_size())
    for cycle in range(40):
        did = f"d{int(rng.integers(50)):04d}"
        vec = rng.normal(size=DIM).astype(np.float32)
        for store, D in ((host, JDoc), (dev, Doc)):
            store.delete("t", [did])
            store.upsert("t", [D(did, f"cycle {cycle}", {"repo": "repo0"}, vec.copy())])
        if cycle % 7 == 0:
            q = rng.normal(size=DIM).astype(np.float32)
            _assert_same(host.search("t", q, 10), dev.search("t", q, 10))
    h1 = dev.health()["device_index"]["t"]
    assert h1["capacity"] == h0["capacity"] == 64
    assert h1["compactions"] > 0 and h1["full_syncs"] == h0["full_syncs"]
    assert (dev.search_program_cache_size(), dev.mutation_program_cache_size()) == shapes
    reports = dev.compact("t")
    assert reports and reports[0]["reclaimed"] > 0
    assert dev.health()["device_index"]["t"]["holes"] == 0
    t = dev._tables["t"]
    corpus = dev._sync(t)
    np.testing.assert_array_equal(corpus.numpy(), t.host.T)  # the repacked copy is the mirror
    assert not corpus[:, len(t.ids):].any()  # repack fill: zero columns past the live rows
    v = rng.normal(size=DIM).astype(np.float32)
    host.upsert("t", [JDoc(f"tie{i}", "same", {}, v.copy()) for i in range(3)])
    dev.upsert("t", [Doc(f"tie{i}", "same", {}, v.copy()) for i in range(3)])
    assert _ids(dev.search("t", v, 3)) == _ids(host.search("t", v, 3)) == ["tie0", "tie1", "tie2"]


def test_scatter_padding_never_touches_column_capacity(monkeypatch):
    """Every index sent to the device is a real column (an out-of-range one
    is a device-side assert on the card), and the padded scatter leaves
    the device copy exactly the host mirror."""
    rng = np.random.default_rng(31)
    t_docs, _ = _both(_docs(rng, 40))
    dev = _cpu_index(k_bucket=8, max_wave=4)
    dev.upsert("t", t_docs)
    dev.warmup()
    sent = []
    scatter, repack = dev._scatter, dev._repack

    def spy_scatter(corpus, idx, vals):
        sent.append(("scatter", corpus.shape[1], idx.copy()))
        return scatter(corpus, idx, vals)

    def spy_repack(corpus, src):
        sent.append(("repack", corpus.shape[1], np.where(src < corpus.shape[1], src, 0)))
        return repack(corpus, src)

    monkeypatch.setattr(dev, "_scatter", spy_scatter)
    monkeypatch.setattr(dev, "_repack", spy_repack)
    for n in (1, 3, 17):  # scatter buckets 16, 16, 32
        dev.upsert("t", [Doc(f"d{int(i):04d}", "x", {}, rng.normal(size=DIM).astype(np.float32))
                         for i in rng.choice(40, n, replace=False)])
        dev.search("t", rng.normal(size=DIM).astype(np.float32), 4)
    dev.delete("t", ["d0001", "d0002"])
    dev.compact("t")
    dev.warmup()  # the identity ladder, at capacity
    assert [s[0] for s in sent].count("scatter") >= 6 and ("repack" in [s[0] for s in sent])
    for _, cap, idx in sent:
        assert idx.min() >= 0 and idx.max() < cap
    t = dev._tables["t"]
    np.testing.assert_array_equal(dev._sync(t).numpy(), t.host.T)


def _jax_and_port(rows, **kw):
    t_docs, j_docs = _both(rows)
    jdev = JDeviceIndexedStore(JMemoryVectorStore(), **kw)
    tdev = _cpu_index(**kw)
    jdev.upsert("t", j_docs)
    tdev.upsert("t", t_docs)
    return jdev, tdev


def test_shape_sets_equal_jax_program_counts():
    """warmup() dispatches the JAX package's exact compile set (query
    buckets 1..max_wave, the scatter ladder, the repack) and live traffic
    (searches of every size, filters, upserts, deletes) adds nothing on
    either side; results equal JAX's index throughout."""
    rng = np.random.default_rng(19)
    jdev, tdev = _jax_and_port(_docs(rng, 50), k_bucket=16, max_wave=4)
    assert tdev.search_program_cache_size() == jdev.search_program_cache_size() == 0
    assert tdev.warmup() == jdev.warmup() == 3  # query buckets 1, 2, 4 x capacity 64
    warm = (jdev.search_program_cache_size(), jdev.mutation_program_cache_size())
    assert warm == (3, 3 + 1)  # scatter buckets 16, 32, 64 + the repack
    assert (tdev.search_program_cache_size(), tdev.mutation_program_cache_size()) == warm
    for nq in range(1, 7):
        qs = rng.normal(size=(nq, DIM)).astype(np.float32)
        for k, flt in ((1 + nq % 5, None), (4, {"repo": "repo1"})):
            for j, t in zip(jdev.search_batch("t", qs, k, [flt] * nq),
                            tdev.search_batch("t", qs, k, [flt] * nq)):
                _assert_same(j, t)
        row = [(f"late{nq}", "late", {"repo": "repo2"}, rng.normal(size=DIM).astype(np.float32))]
        t_late, j_late = _both(row)
        jdev.upsert("t", j_late)
        tdev.upsert("t", t_late)
        jdev.delete("t", [f"d{nq:04d}"])
        tdev.delete("t", [f"d{nq:04d}"])
    assert (jdev.search_program_cache_size(), jdev.mutation_program_cache_size()) == warm
    assert (tdev.search_program_cache_size(), tdev.mutation_program_cache_size()) == warm
    assert tdev.health() == jdev.health()  # every counter and gauge


def test_index_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceIndexedStore(MemoryVectorStore())
    assert _cpu_index().device == torch.device("cpu")
