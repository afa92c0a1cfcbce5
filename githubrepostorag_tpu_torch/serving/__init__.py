"""Serving: the paged-KV generation engine and its async driver."""

from githubrepostorag_tpu_torch.serving.async_engine import AsyncEngine, StreamEvent
from githubrepostorag_tpu_torch.serving.engine import Engine, GenerationResult
from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams

__all__ = ["AsyncEngine", "Engine", "GenerationResult", "SamplingParams", "StreamEvent"]
