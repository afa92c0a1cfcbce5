"""Small shared helpers; port of ``githubrepostorag_tpu/utils/__init__.py``."""

from githubrepostorag_tpu_torch.utils.json_utils import extract_choice, extract_json
from githubrepostorag_tpu_torch.utils.logging import get_logger


def next_bucket(n: int, cap: int, minimum: int = 16) -> int:
    """Smallest power-of-two >= n (floored at ``minimum``, capped at ``cap``).
    Shared by every path that pads dynamic lengths into a handful of
    shapes (encoder batches, index query waves and scatters)."""
    b = minimum
    while b < n:
        b *= 2
    return min(b, cap)


__all__ = ["extract_json", "extract_choice", "get_logger", "next_bucket"]
