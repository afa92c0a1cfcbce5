"""L5: the REST control plane; port of ``githubrepostorag_tpu/api/``."""

from githubrepostorag_tpu_torch.api.app import RagApi

__all__ = ["RagApi"]
