"""Versioned snapshot/restore of the index — the warm-spare bring-up
path (a fresh replica restores from a snapshot and replays only the
mutation-log suffix past the snapshot watermark); a copy of
``githubrepostorag_tpu/retrieval/snapshot.py``, whose files it reads
and writes (the same manifest keys, the same npz layout).

A snapshot directory holds:

``manifest.json``
    ``{"version", "watermark", "tables": [{"name", "count",
    "vectored", "dim", "capacity"}, ...]}`` — the watermark is whatever
    the caller recorded at save time (normally the applier's applied
    seq), and it is the replay cursor: restore feeds
    ``log.read_since(watermark["seq"])`` and nothing earlier.

``table_NN.json`` / ``table_NN.npz``
    Per table: every doc (id, text, metadata, vector flag) in the
    store's insertion order, and the RAW float32 vectors stacked in that
    same order.  Restoring upserts docs in this exact order, which
    reproduces the memory store's dict order AND the device mirror's
    row assignment — so a restored replica is score- and tie-order-
    identical to the original (same raw bits in, same normalize, same
    row-index tie-breaks), not merely set-equal.

Restore pre-sizes each device table to the recorded capacity bucket
(``DeviceIndexedStore.reserve``), so bring-up does one full-table put
at the final shape instead of re-growing through every bucket.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np

from githubrepostorag_tpu_torch.store.base import Doc, VectorStore
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SNAPSHOT_VERSION = 1
_SNAPSHOT_LIMIT = 10_000_000   # docs per table a snapshot will carry
_RESTORE_BATCH = 512


def _normalize_watermark(watermark) -> dict:
    if watermark is None:
        return {"seq": 0, "tables": {}}
    if isinstance(watermark, int):
        return {"seq": watermark, "tables": {}}
    return {"seq": int(watermark.get("seq", 0)),
            "tables": dict(watermark.get("tables", {}))}


def save_snapshot(store: VectorStore, path: str, *,
                  watermark: Mapping | int | None = None) -> dict:
    """Write a versioned snapshot of ``store`` under directory ``path``;
    returns the manifest.  ``watermark`` should be the mutation-log seq
    the store has applied through (the restore replay cursor)."""
    os.makedirs(path, exist_ok=True)
    health = store.health() if hasattr(store, "health") else {}
    dev = health.get("device_index", {}) if isinstance(health, dict) else {}
    tables = []
    for i, table in enumerate(sorted(store.tables())):
        docs = store.find_by_metadata(table, {}, limit=_SNAPSHOT_LIMIT)
        vectors = [np.asarray(d.vector, dtype=np.float32).reshape(-1)
                   for d in docs if d.vector is not None]
        dim = int(vectors[0].size) if vectors else 0
        stem = f"table_{i:02d}"
        with open(os.path.join(path, stem + ".json"), "w",
                  encoding="utf-8") as fh:
            json.dump({
                "table": table,
                "docs": [{"doc_id": d.doc_id, "text": d.text,
                          "metadata": dict(d.metadata),
                          "has_vector": d.vector is not None}
                         for d in docs],
            }, fh)
        np.savez_compressed(
            os.path.join(path, stem + ".npz"),
            vectors=(np.stack(vectors) if vectors
                     else np.zeros((0, 0), dtype=np.float32)))
        tables.append({
            "name": table,
            "stem": stem,
            "count": len(docs),
            "vectored": len(vectors),
            "dim": dim,
            "capacity": dev.get(table, {}).get("capacity", 0),
        })
    manifest = {
        "version": SNAPSHOT_VERSION,
        "watermark": _normalize_watermark(watermark),
        "tables": tables,
    }
    with open(os.path.join(path, "manifest.json"), "w",
              encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    logger.info("snapshot %s: %d tables, watermark %d", path, len(tables),
                manifest["watermark"]["seq"])
    return manifest


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json"), encoding="utf-8") as fh:
        manifest = json.load(fh)
    version = manifest.get("version")
    if version != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot {path}: version {version!r} != supported "
            f"{SNAPSHOT_VERSION} — regenerate the snapshot")
    return manifest


def load_snapshot(path: str, store: VectorStore) -> dict:
    """Restore a snapshot into ``store`` (normally a fresh
    ``DeviceIndexedStore``); returns the manifest.  Docs are upserted in
    snapshot (= original insertion) order, in batches, so tie order and
    scores reproduce exactly; the caller replays the mutation-log suffix
    past ``manifest["watermark"]["seq"]`` afterwards."""
    manifest = read_manifest(path)
    reserve = getattr(store, "reserve", None)
    for entry in manifest["tables"]:
        table, stem = entry["name"], entry["stem"]
        with open(os.path.join(path, stem + ".json"), encoding="utf-8") as fh:
            meta = json.load(fh)
        vectors = np.load(os.path.join(path, stem + ".npz"))["vectors"]
        if reserve is not None and entry["capacity"] and entry["dim"]:
            reserve(table, entry["capacity"], dim=entry["dim"])
        docs: list[Doc] = []
        vi = 0
        for rec in meta["docs"]:
            vec = None
            if rec["has_vector"]:
                vec = vectors[vi]
                vi += 1
            docs.append(Doc(rec["doc_id"], rec["text"], rec["metadata"], vec))
            if len(docs) >= _RESTORE_BATCH:
                store.upsert(table, docs)
                docs = []
        if docs:
            store.upsert(table, docs)
    return manifest


def latest_snapshot(root: str) -> str | None:
    """Most recently written snapshot directory under ``root`` (by
    manifest mtime) — the fleet controller's activate-from-snapshot
    source.  ``root`` itself may be a snapshot directory; returns None
    when nothing restorable exists (the spare activates cold)."""
    if not root or not os.path.isdir(root):
        return None
    best, best_t = None, -1.0
    for name in sorted(os.listdir(root)):
        mf = os.path.join(root, name, "manifest.json")
        if os.path.isfile(mf):
            t = os.path.getmtime(mf)
            if t > best_t:
                best, best_t = os.path.join(root, name), t
    if best is None and os.path.isfile(os.path.join(root, "manifest.json")):
        return root
    return best


def restore_for_activation(root: str, store: VectorStore, log=None) -> dict | None:
    """Warm-spare bring-up: find the latest snapshot under ``root`` and
    ``restore_replica`` it into ``store`` (snapshot + log-suffix replay).
    Returns the restore result with the chosen path, or None when no
    snapshot exists — the controller then activates the spare cold."""
    path = latest_snapshot(root)
    if path is None:
        return None
    out = restore_replica(path, store, log=log)
    out["path"] = path
    return out


def restore_replica(path: str, store: VectorStore, log=None,
                    replay_batch: int = 256) -> dict:
    """Snapshot restore + log-suffix replay in one call: load the
    snapshot into ``store``, then apply every op past the snapshot
    watermark from ``log`` (none earlier — the round-trip test asserts
    the op count).  Returns ``{"manifest", "replayed"}``."""
    from githubrepostorag_tpu_torch.ingest.stream import apply_ops

    manifest = load_snapshot(path, store)
    cursor = manifest["watermark"]["seq"]
    replayed = 0
    if log is not None:
        while True:
            ops = log.read_since(cursor, limit=replay_batch)
            if not ops:
                break
            apply_ops(store, ops)
            cursor = ops[-1].seq
            replayed += len(ops)
    return {"manifest": manifest, "replayed": replayed}
