"""L3': the index-building pipeline; port of ``githubrepostorag_tpu/ingest``.

Load -> preprocess -> chunk -> enrich (L4) -> catalog (L0) -> file (L3) ->
module (L2) -> repo (L1) summaries -> per-scope vector write -> audit, the
LLM stages batched through ``complete_batch`` (on the card: the engine's
continuous batching over kernels A and B), and the watermarked mutation
stream into the live index (``ingest/stream.py``).
"""

from githubrepostorag_tpu_torch.ingest.types import Node, SourceDoc
from githubrepostorag_tpu_torch.ingest.controller import ingest_component, ingest_many

__all__ = ["SourceDoc", "Node", "ingest_component", "ingest_many"]
