"""The port's mutation log, live-index applier and snapshots against the JAX
package's: the same op streams drained by both appliers give the same
watermarks, compactions and ``/debug/index`` payloads; a log or a snapshot
written by either package is read by the other.

Scores across packages agree within 1e-5 (float32 dot products summed in
another order); within the port a restored replica is exactly equal.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest

from githubrepostorag_tpu.ingest import stream as j_stream
from githubrepostorag_tpu.retrieval import live_index as j_live
from githubrepostorag_tpu.retrieval import snapshot as j_snapshot
from githubrepostorag_tpu.retrieval.device_index import DeviceIndexedStore as JDeviceIndexedStore
from githubrepostorag_tpu.store.base import Doc as JDoc
from githubrepostorag_tpu.store.memory import MemoryVectorStore as JMemoryVectorStore
from githubrepostorag_tpu_torch.ingest.stream import (
    DELETE,
    UPSERT,
    MutationLog,
    StreamSink,
    apply_ops,
)
from githubrepostorag_tpu_torch.metrics import INDEX_FULL_SYNCS, INDEX_WATERMARK, counter_value
from githubrepostorag_tpu_torch.retrieval import (
    DeviceIndexedStore,
    LiveIndexApplier,
    LiveIndexedStore,
    get_live_applier,
    live_index_payload,
    load_snapshot,
    register_live_applier,
    restore_replica,
    save_snapshot,
)
from githubrepostorag_tpu_torch.retrieval.live_index import TOTAL_SCOPE
from githubrepostorag_tpu_torch.retrieval.snapshot import latest_snapshot, read_manifest
from githubrepostorag_tpu_torch.store.base import Doc
from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

DIM = 16


def _rows(rng, n, prefix="d"):
    return [(f"{prefix}{i:04d}", f"text {i}", {"namespace": "default", "repo": f"repo{i % 3}"},
             rng.normal(size=DIM).astype(np.float32)) for i in range(n)]


def _port_docs(rows):
    return [Doc(i, t, dict(m), v.copy()) for i, t, m, v in rows]


def _jax_docs(rows):
    return [JDoc(i, t, dict(m), v.copy()) for i, t, m, v in rows]


def _ids(hits):
    return [h.doc.doc_id for h in hits]


def _scores(hits):
    return [h.score for h in hits]


@pytest.fixture(autouse=True)
def _no_applier_registered():
    register_live_applier(None)
    yield
    register_live_applier(None)


def _churn(rng, n_seed, steps):
    """A seeded stream: the seed docs, then updates, deletes and re-upserts
    of deleted ids (the id set never grows past the seed's)."""
    seed = _rows(rng, n_seed)
    live, dead = {r[0] for r in seed}, set()
    plan = [(UPSERT, r) for r in seed]
    for step in range(steps):
        roll = rng.random()
        if roll < 0.35 and len(live) > n_seed // 2:
            did = sorted(live)[int(rng.integers(len(live)))]
            live.discard(did)
            dead.add(did)
            plan.append((DELETE, did))
        else:
            pool = dead if dead and roll < 0.6 else live
            did = sorted(pool)[int(rng.integers(len(pool)))]
            pool.discard(did)
            live.add(did)
            plan.append((UPSERT, (did, f"step {step}", {"repo": f"repo{step % 3}"},
                                  rng.normal(size=DIM).astype(np.float32))))
    return plan


def _append(log, plan, docs):
    for kind, arg in plan:
        if kind == DELETE:
            log.append_delete("t", [arg])
        else:
            log.append_upsert("t", docs([arg]))


def test_applier_drain_watermarks_and_compaction_match_jax():
    rng = np.random.default_rng(6)
    plan = _churn(rng, 50, 90)
    kw = dict(apply_batch=7, compact_min_holes=6, compact_max_hole_fraction=0.2)
    j_log, t_log = j_stream.MutationLog(), MutationLog()
    j_dev = JDeviceIndexedStore(JMemoryVectorStore(), k_bucket=16, max_wave=4)
    t_dev = DeviceIndexedStore(MemoryVectorStore(), k_bucket=16, max_wave=4, device="cpu")
    j_app = j_live.LiveIndexApplier(j_log, j_dev, **kw)
    t_app = LiveIndexApplier(t_log, t_dev, **kw)
    q = rng.normal(size=DIM).astype(np.float32)
    for start in range(0, len(plan), 23):  # producers and the applier interleave
        chunk = plan[start:start + 23]
        _append(j_log, chunk, _jax_docs)
        _append(t_log, chunk, _port_docs)
        assert t_app.apply_once() == j_app.apply_once() == min(7, len(chunk))  # one batch
        assert t_app.drain() == j_app.drain()
        assert t_app.applied_seq() == j_app.applied_seq() == t_log.watermark()["seq"]
        j_hits, t_hits = j_dev.search("t", q, 10), t_dev.search("t", q, 10)
        assert _ids(t_hits) == _ids(j_hits)
        np.testing.assert_allclose(_scores(t_hits), _scores(j_hits), atol=1e-5)
        assert t_app.payload() == j_app.payload()  # /debug/index, field by field
    payload = t_app.payload()
    assert payload["compaction"]["runs"] > 0 and payload["tables"]["t"]["holes"] < 6
    assert payload["tables"]["t"]["capacity"] == 64  # churn never grew the bucket
    assert counter_value(INDEX_WATERMARK, scope=TOTAL_SCOPE, kind="applied") == len(plan)


def test_mutation_log_files_cross_packages(tmp_path):
    """A JSONL log written by either package replays in the other with the
    same ops, float32 vectors bit for bit."""
    rng = np.random.default_rng(8)
    rows = _rows(rng, 5)
    for writer, reader, docs in ((j_stream.MutationLog, MutationLog, _jax_docs),
                                 (MutationLog, j_stream.MutationLog, _port_docs)):
        path = str(tmp_path / f"{writer.__module__}.jsonl")
        log = writer(path=path)
        log.append_upsert("t", docs(rows[:3]))
        log.append_delete("u", ["x", "y"])
        log.append_upsert("u", docs(rows[3:]))
        log.close()
        back = reader(path=path)
        assert back.watermark() == {"seq": 7, "tables": {"t": 3, "u": 7}}
        ops = back.read_since(2)
        assert [(o.seq, o.kind, o.table, o.doc_id) for o in ops] == [
            (3, UPSERT, "t", "d0002"), (4, DELETE, "u", "x"), (5, DELETE, "u", "y"),
            (6, UPSERT, "u", "d0003"), (7, UPSERT, "u", "d0004")]
        for op, row in zip((ops[0], ops[3], ops[4]), (rows[2], rows[3], rows[4])):
            assert op.vector.dtype == np.float32
            np.testing.assert_array_equal(op.vector.view(np.uint32), row[3].view(np.uint32))
        back.close()


def test_log_trim_reads_the_file_and_stream_sink_batches_runs(tmp_path):
    rng = np.random.default_rng(9)
    log = MutationLog(path=str(tmp_path / "log.jsonl"))
    sink = StreamSink(log)
    assert sink.upsert("t", _port_docs(_rows(rng, 4))) == 4
    assert sink.delete("t", ["d0001"]) == 1
    assert log.trim(3) == 3 and len(log) == 2
    assert [o.seq for o in log.read_since(0)] == [1, 2, 3, 4, 5]  # from the file
    assert MutationLog().trim(3) == 0  # memory-only logs keep their tail

    calls = []

    class Recorder:
        def upsert(self, table, docs):
            calls.append(("upsert", table, [d.doc_id for d in docs]))

        def delete(self, table, ids):
            calls.append(("delete", table, list(ids)))

    apply_ops(Recorder(), log.read_since(0))
    assert calls == [("upsert", "t", ["d0000", "d0001", "d0002", "d0003"]),
                     ("delete", "t", ["d0001"])]


def _snapshot_world(rng, docs, dev):
    """A churned store: 45 docs, 4 exact ties, 2 deletes, applied by a log."""
    log_cls = MutationLog if docs is _port_docs else j_stream.MutationLog
    app_cls = LiveIndexApplier if docs is _port_docs else j_live.LiveIndexApplier
    log = log_cls()
    app = app_cls(log, dev, apply_batch=16)
    v = rng.normal(size=DIM).astype(np.float32)
    log.append_upsert("t", docs(_rows(rng, 45)))
    log.append_upsert("t", docs([(f"tie{i}", "same", {"repo": "repo0"}, v) for i in range(4)]))
    log.append_delete("t", ["d0004", "d0010"])
    app.drain()
    return log, app, v


def test_snapshots_cross_packages_and_restore_identically(tmp_path):
    """save_snapshot by either package -> restore_replica by the other (and by
    the port into itself, exactly): same manifest, same files, replay of
    the log suffix only, same ids in the same tie order."""
    rng = np.random.default_rng(7)
    t_dev = DeviceIndexedStore(MemoryVectorStore(), k_bucket=16, max_wave=4, device="cpu")
    j_dev = JDeviceIndexedStore(JMemoryVectorStore(), k_bucket=16, max_wave=4)
    t_log, t_app, v = _snapshot_world(np.random.default_rng(7), _port_docs, t_dev)
    j_log, j_app, _ = _snapshot_world(np.random.default_rng(7), _jax_docs, j_dev)
    t_dir, j_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    t_man = save_snapshot(t_dev, t_dir, watermark=t_app.applied_seq())
    j_man = j_snapshot.save_snapshot(j_dev, j_dir, watermark=j_app.applied_seq())
    assert t_man == j_man and t_man["tables"][0]["count"] == 47
    for name in ("manifest.json", "table_00.json"):
        with open(os.path.join(t_dir, name), "rb") as a, open(os.path.join(j_dir, name), "rb") as b:
            assert a.read() == b.read()
    with np.load(os.path.join(t_dir, "table_00.npz")) as a, \
            np.load(os.path.join(j_dir, "table_00.npz")) as b:
        assert a.files == b.files == ["vectors"]
        np.testing.assert_array_equal(a["vectors"], b["vectors"])
    # two ops past the snapshot watermark, on both logs
    late = _rows(rng, 1, prefix="late")
    for log, docs in ((t_log, _port_docs), (j_log, _jax_docs)):
        log.append_upsert("t", docs([("d0004", "back", {"repo": "repo1"}, late[0][3])]))
        log.append_delete("t", ["tie3"])
    t_app.drain()
    j_app.drain()

    into_port = DeviceIndexedStore(MemoryVectorStore(), k_bucket=16, max_wave=4, device="cpu")
    into_jax = JDeviceIndexedStore(JMemoryVectorStore(), k_bucket=16, max_wave=4)
    port_self = DeviceIndexedStore(MemoryVectorStore(), k_bucket=16, max_wave=4, device="cpu")
    assert restore_replica(j_dir, into_port, log=t_log)["replayed"] == 2
    assert j_snapshot.restore_replica(t_dir, into_jax, log=j_log)["replayed"] == 2
    assert restore_replica(t_dir, port_self, log=t_log)["replayed"] == 2
    assert (into_port.health()["device_index"]["t"]["capacity"]
            == t_dev.health()["device_index"]["t"]["capacity"] == 64)  # reserve()d
    queries = [rng.normal(size=DIM).astype(np.float32) for _ in range(3)] + [v]
    for q in queries:
        for flt in (None, {"repo": "repo0"}):
            ref = t_dev.search("t", q, 8, filter=flt)
            same = port_self.search("t", q, 8, filter=flt)
            assert _ids(same) == _ids(ref) and _scores(same) == _scores(ref)  # exact
            for other in (into_port.search("t", q, 8, filter=flt),
                          into_jax.search("t", q, 8, filter=flt)):
                assert _ids(other) == _ids(ref)
                np.testing.assert_allclose(_scores(other), _scores(ref), atol=1e-5)
    assert _ids(t_dev.search("t", v, 3)) == ["tie0", "tie1", "tie2"]
    assert latest_snapshot(str(tmp_path)) in (t_dir, j_dir)


def test_snapshot_version_mismatch_is_refused(tmp_path):
    store = MemoryVectorStore()
    store.upsert("t", _port_docs(_rows(np.random.default_rng(8), 3)))
    snap = str(tmp_path / "snap")
    assert save_snapshot(store, snap, watermark=3)["watermark"] == {"seq": 3, "tables": {}}
    mpath = os.path.join(snap, "manifest.json")
    with open(mpath, encoding="utf-8") as fh:
        doc = json.load(fh)
    doc["version"] = 2
    with open(mpath, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    for load in (read_manifest, lambda p: load_snapshot(p, MemoryVectorStore())):
        with pytest.raises(ValueError, match="version"):
            load(snap)
    with pytest.raises(ValueError, match="version"):
        j_snapshot.load_snapshot(snap, JMemoryVectorStore())


def test_queries_see_only_stream_prefixes_while_the_applier_runs():
    """The applier thread drains a churn while two threads query: every
    result observed equals the result after some prefix of the stream, no
    new shape is dispatched, and no whole-table put happens."""
    rng = np.random.default_rng(5)
    plan = _churn(rng, 40, 60)
    seed, churn = plan[:40], plan[40:]
    dev = DeviceIndexedStore(MemoryVectorStore(), k_bucket=16, max_wave=4, device="cpu")
    dev.upsert("t", _port_docs([r for _, r in seed]))
    dev.warmup()
    shapes = (dev.search_program_cache_size(), dev.mutation_program_cache_size())
    full0 = counter_value(INDEX_FULL_SYNCS, table="t")
    queries = [rng.normal(size=DIM).astype(np.float32) for _ in range(3)]
    ref = MemoryVectorStore()
    ref.upsert("t", _port_docs([r for _, r in seed]))
    allowed = [{tuple(_ids(ref.search("t", q, 5)))} for q in queries]
    for kind, arg in churn:
        if kind == DELETE:
            ref.delete("t", [arg])
        else:
            ref.upsert("t", _port_docs([arg]))
        for i, q in enumerate(queries):
            allowed[i].add(tuple(_ids(ref.search("t", q, 5))))
    log = MutationLog()
    applier = LiveIndexApplier(log, dev, apply_batch=6, compact_interval_s=0.05,
                               compact_min_holes=8, compact_max_hole_fraction=0.2)
    observed = [set() for _ in queries]
    stop, errors = threading.Event(), []

    def query_loop():
        n = 0
        try:
            while not stop.is_set():
                observed[n % 3].add(tuple(_ids(dev.search("t", queries[n % 3], 5))))
                n += 1
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    applier.start()
    threads = [threading.Thread(target=query_loop) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for kind, arg in churn:
            if kind == DELETE:
                log.append_delete("t", [arg])
            else:
                log.append_upsert("t", _port_docs([arg]))
            if rng.random() < 0.3:
                time.sleep(0.001)
        assert applier.flush(timeout=30)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        applier.stop()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    for i, q in enumerate(queries):
        assert observed[i] and not observed[i] - allowed[i], observed[i] - allowed[i]
        assert _ids(dev.search("t", q, 5)) == _ids(ref.search("t", q, 5))
    assert (dev.search_program_cache_size(), dev.mutation_program_cache_size()) == shapes
    assert counter_value(INDEX_FULL_SYNCS, table="t") == full0


def test_live_front_and_registry_payload():
    log, store = MutationLog(), MemoryVectorStore()
    applier = LiveIndexApplier(log, store)
    front = LiveIndexedStore(store, log, applier)
    docs = _port_docs(_rows(np.random.default_rng(9), 6))
    assert front.upsert("t", docs) == 6 and front.count("t") == 0  # reads trail the log
    applier.flush()
    assert front.count("t") == 6 and front.tables() == ["t"]
    assert front.delete("t", [docs[0].doc_id]) == 1
    applier.flush()
    assert front.get("t", docs[0].doc_id) is None
    assert front.health()["live_index"]["lag_ops"] == 0
    assert live_index_payload() == {"enabled": False}
    register_live_applier(applier)
    assert get_live_applier() is applier
    assert live_index_payload()["watermark"]["applied"] == applier.applied_seq() == 7
