"""Content chain hashing for KV pages — the shared identity scheme.

A page's hash is a blake2b chain over its full token prefix:

    h_i = blake2b(h_{i-1} || tokens_i, digest_size=16)

so equal hashes imply byte-identical KV content (vLLM's automatic
prefix-caching block hash).  A copy of ``githubrepostorag_tpu/serving/
chain_hash.py``: the port and the JAX package agree on page identity
byte for byte.
"""

from __future__ import annotations

import hashlib

import numpy as np


def chain_hashes(tokens: list[int], page_size: int) -> list[bytes]:
    """Chain hash per FULL page of ``tokens``; the trailing partial page
    (if any) gets no hash — its KV content is not final."""
    out: list[bytes] = []
    prev = b""
    for start in range(0, len(tokens) - page_size + 1, page_size):
        chunk = np.asarray(tokens[start : start + page_size], dtype=np.int64).tobytes()
        prev = hashlib.blake2b(prev + chunk, digest_size=16).digest()
        out.append(prev)
    return out
