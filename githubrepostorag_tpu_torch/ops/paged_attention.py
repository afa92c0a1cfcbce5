"""Paged attention over the page-pool KV cache, plain version; port of
``githubrepostorag_tpu/ops/paged_attention.py`` for full-precision pools.

``paged_attention_ref`` gathers each row's pages into a contiguous view and
runs dense attention.  It materializes the gathered KV, and it is the
oracle both attention kernels (``ops/fused_decode.py``,
``ops/paged_decode.py``) are held to.

Contract:
  q            [B, S, n_q, hd]  new queries (right-padded per row)
  k_pages      [n_kv, P, page_size, hd]  this layer's pool
  v_pages      [n_kv, P, page_size, hd]
  block_tables [B, max_pages] int  page ids per row
  cached_lens  [B] int  tokens in cache BEFORE this step
  new_lens     [B] int  valid new tokens this step (<= S), already committed
Returns [B, S, n_q, hd].
"""

from __future__ import annotations

import torch

from githubrepostorag_tpu_torch.ops.attention import dense_attention


def gather_kv(k_pages: torch.Tensor, v_pages: torch.Tensor, block_tables: torch.Tensor):
    """[n_kv, P, ps, hd] + [B, max_pages] -> [B, max_pages*ps, n_kv, hd] each."""
    b, max_pages = block_tables.shape
    n_kv, _, ps, hd = k_pages.shape
    idx = block_tables.long()

    def gather(pages: torch.Tensor) -> torch.Tensor:
        g = pages[:, idx]  # [n_kv, B, max_pages, ps, hd]
        return g.permute(1, 2, 3, 0, 4).reshape(b, max_pages * ps, n_kv, hd)

    return gather(k_pages), gather(v_pages)


def paged_attention_ref(q, k_pages, v_pages, block_tables, cached_lens, new_lens):
    k, v = gather_kv(k_pages, v_pages, block_tables)
    # new tokens are already scattered into the pages, so the valid kv
    # length is cached + new
    return dense_attention(
        q, k, v, causal=True, q_offset=cached_lens,
        kv_lengths=cached_lens + new_lens,
    )
