"""L2: scoped retrieval over the vector store: the device index, the live
index and its snapshots, the coalescer, the per-scope retrievers and the
whole-repo assembler."""

from githubrepostorag_tpu_torch.retrieval.assembler import (
    AssembledRepo,
    assemble_repo,
    longctx_token_budget,
)
from githubrepostorag_tpu_torch.retrieval.coalescer import RetrievalCoalescer
from githubrepostorag_tpu_torch.retrieval.device_index import DeviceIndexedStore
from githubrepostorag_tpu_torch.retrieval.live_index import (
    LiveIndexApplier,
    LiveIndexedStore,
    get_live_applier,
    live_index_payload,
    register_live_applier,
)
from githubrepostorag_tpu_torch.retrieval.retrievers import (
    RetrievedDoc,
    RetrieverFactory,
    ScopeRetriever,
)
from githubrepostorag_tpu_torch.retrieval.snapshot import (
    load_snapshot,
    restore_replica,
    save_snapshot,
)

__all__ = [
    "AssembledRepo",
    "DeviceIndexedStore",
    "LiveIndexApplier",
    "LiveIndexedStore",
    "RetrievalCoalescer",
    "RetrievedDoc",
    "RetrieverFactory",
    "ScopeRetriever",
    "assemble_repo",
    "get_live_applier",
    "live_index_payload",
    "load_snapshot",
    "longctx_token_budget",
    "register_live_applier",
    "restore_replica",
    "save_snapshot",
]
