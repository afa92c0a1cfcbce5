"""L1: the vector store (five hierarchy tables, ANN + metadata filters)."""

from githubrepostorag_tpu_torch.store.base import Doc, SearchHit, VectorStore
from githubrepostorag_tpu_torch.store.factory import get_store, reset_store, set_store

__all__ = ["Doc", "SearchHit", "VectorStore", "get_store", "reset_store", "set_store"]
