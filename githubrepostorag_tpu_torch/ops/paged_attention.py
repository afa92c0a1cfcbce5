"""Paged attention over the page-pool KV cache, plain version; port of
``githubrepostorag_tpu/ops/paged_attention.py`` (full-precision, int8 and
int4 pools).

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
  k_scales     [n_kv, P] f32 per-page scales of int8 / int4 pools, or None
  v_scales     [n_kv, P]
Returns [B, S, n_q, hd].
"""

from __future__ import annotations

import torch

from githubrepostorag_tpu_torch.ops.attention import dense_attention


def gather_kv(k_pages: torch.Tensor, v_pages: torch.Tensor, block_tables: torch.Tensor,
              k_scales: torch.Tensor | None = None, v_scales: torch.Tensor | None = None,
              dtype: torch.dtype | None = None):
    """[n_kv, P, ps, hd] + [B, max_pages] -> [B, max_pages*ps, n_kv, hd] each.

    With ``k_scales``/``v_scales`` ([n_kv, P] per-page scales of quantized
    pools) the gathered codes dequantize in float32 and round to ``dtype``
    (default bf16) on the way out; uint8 pools are ``pack_int4`` nibble
    planes and unpack to the full head width first."""
    # lazy: the serving package imports the model, which imports this module
    from githubrepostorag_tpu_torch.serving.kv_cache import unpack_int4

    b, max_pages = block_tables.shape
    n_kv, _, ps, _ = k_pages.shape
    idx = block_tables.long()

    def gather(pages: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
        g = pages[:, idx]  # [n_kv, B, max_pages, ps, hd_stored]
        if pages.dtype == torch.uint8:
            g = unpack_int4(g)
        g = g.permute(1, 2, 3, 0, 4).reshape(b, max_pages * ps, n_kv, g.shape[-1])
        if scales is None:
            return g
        s = scales[:, idx].permute(1, 2, 0)  # [B, max_pages, n_kv]
        s = s.repeat_interleave(ps, dim=1)  # page scale -> its ps token rows
        return (g.float() * s[..., None]).to(dtype or torch.bfloat16)

    return gather(k_pages, k_scales), gather(v_pages, v_scales)


def paged_attention_ref(q, k_pages, v_pages, block_tables, cached_lens, new_lens,
                        k_scales=None, v_scales=None):
    k, v = gather_kv(k_pages, v_pages, block_tables, k_scales, v_scales, dtype=q.dtype)
    # new tokens are already scattered into the pages, so the valid kv
    # length is cached + new
    return dense_attention(
        q, k, v, causal=True, q_offset=cached_lens,
        kv_lengths=cached_lens + new_lens,
    )
