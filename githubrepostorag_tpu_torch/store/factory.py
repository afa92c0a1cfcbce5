"""Store backend selection (STORE_BACKEND: memory | native | cassandra);
port of ``githubrepostorag_tpu/store/factory.py``.

The chain is the JAX package's: the backend, wrapped in the device index
(``DEVICE_INDEX``), wrapped in the live-index front (``LIVE_INDEX=on``).
The device index seeds itself from the backend's rows
(``find_by_metadata(table, {}, limit)``), so a fresh worker pod over
``cassandra`` loads its index from Cassandra.

One divergence by design: the JAX package's ``DEVICE_INDEX=auto`` wraps
the store on a TPU only and keeps the host store elsewhere.  The port
never keeps the host store because no card was found: ``auto`` and ``on``
both wrap on ``device`` (the card unless ``"cpu"``), and without a card
that raises; only ``off`` keeps the host store.
"""

from __future__ import annotations

import os

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.store.base import VectorStore

_store: VectorStore | None = None


def get_store(device=None) -> VectorStore:
    """The process-wide store, built from the settings on first use, its
    device index on ``device``."""
    global _store
    if _store is None:
        _store = _build(device)
    return _store


def reset_store() -> None:
    global _store
    applier = getattr(_store, "applier", None)
    if applier is not None:  # live-index front: stop the drain thread
        from githubrepostorag_tpu_torch.retrieval.live_index import register_live_applier

        applier.stop()
        register_live_applier(None)
    _store = None


def set_store(store: VectorStore | None) -> None:
    """Inject a store (tests / embedded deployments)."""
    global _store
    _store = store


def _device_index_enabled(s) -> bool:
    """DEVICE_INDEX "auto" (or empty) and "on" wrap the store; any other
    value keeps the host store, as in the JAX package."""
    return s.device_index.strip().lower() in {"auto", "", "on", "1", "true", "yes"}


def _build(device=None) -> VectorStore:
    s = get_settings()
    backend = s.store_backend.lower()
    if backend == "memory":
        from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

        store: VectorStore = MemoryVectorStore(persist_dir=s.store_path or None)
    elif backend == "native":
        from githubrepostorag_tpu_torch.store.native import NativeVectorStore

        store = NativeVectorStore(persist_dir=s.store_path or None)
    elif backend == "cassandra":
        from githubrepostorag_tpu_torch.store.cassandra import CassandraVectorStore

        store = CassandraVectorStore(
            hosts=[s.cassandra_host],
            port=s.cassandra_port,
            username=s.cassandra_username,
            password=s.cassandra_password,
            keyspace=s.cassandra_keyspace,
            embed_dim=s.embed_dim,
        )
    else:
        raise ValueError(f"Unknown STORE_BACKEND: {s.store_backend!r}")
    if _device_index_enabled(s):
        from githubrepostorag_tpu_torch.retrieval.device_index import DeviceIndexedStore

        store = DeviceIndexedStore(
            store,
            k_bucket=s.device_index_k_bucket,
            max_wave=s.retrieval_max_wave,
            device=device,
        )
    if s.live_index.strip().lower() in {"on", "1", "true", "yes"}:
        store = _wrap_live_index(store, s)
    return store


def _wrap_live_index(store: VectorStore, s) -> VectorStore:
    """LIVE_INDEX=on: writes append to the watermarked mutation log, a
    daemon apply loop drains them into the wrapped store while queries
    run, and the applier registers for /debug/index."""
    from githubrepostorag_tpu_torch.ingest.stream import MutationLog
    from githubrepostorag_tpu_torch.retrieval.live_index import (
        LiveIndexApplier,
        LiveIndexedStore,
        register_live_applier,
    )

    log_path = s.live_index_log_path or (
        os.path.join(s.data_dir, "mutation_log.jsonl") if s.data_dir else "")
    log = MutationLog(path=log_path or None)
    applier = LiveIndexApplier(
        log,
        store,
        apply_batch=s.live_index_apply_batch,
        compact_interval_s=s.index_compact_interval_s,
        compact_min_holes=s.index_compact_min_holes,
        compact_max_hole_fraction=s.index_compact_max_hole_fraction,
    ).start()
    register_live_applier(applier)
    return LiveIndexedStore(store, log, applier)
