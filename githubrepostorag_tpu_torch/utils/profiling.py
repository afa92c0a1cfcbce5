"""Named regions in device traces; the ``annotate`` half of
``githubrepostorag_tpu/utils/profiling.py``, on ``torch.profiler``."""

from __future__ import annotations

import torch


def annotate(name: str):
    """A ``torch.profiler.record_function`` range: a named span in a
    profiler trace around the enclosed host calls (the JAX package's
    ``TraceAnnotation``); costs next to nothing when no profiler runs."""
    return torch.profiler.record_function(name)
