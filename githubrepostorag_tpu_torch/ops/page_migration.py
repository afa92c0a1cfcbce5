"""Batched device <-> host KV page migration; port of
``githubrepostorag_tpu/ops/page_migration.py`` (XLA ops in the JAX package,
PyTorch ops here: no kernel).

``gather_pages`` reads a burst of pages out of the pools into fresh
contiguous buffers (the engine copies them into pinned host memory without
blocking and reads them one step later), and ``scatter_pages`` writes a
burst of host payloads back into the pools in place.  Both take a
fixed-width ``[nb]`` page-index vector padded with -1, so a burst's shapes
are the power-of-two ladder ``migrate_buckets``.  Gather clamps padding to
page 0 (those rows are discarded host-side); scatter sends padding to the
pools' drop page, the last page, which no block table references (the
JAX package remaps -1 past the pool and drops it; a torch index write
would wrap -1 onto the last real page).  Quantized pools (int8 codes, or
int4 nibble planes of half the head width) migrate their per-page scales
in the same call.
"""

from __future__ import annotations

import torch


def migrate_buckets(burst: int) -> list[int]:
    """Power-of-two bucket ladder for migration burst sizes, capped at the
    configured burst: every burst shape the engine dispatches."""
    out: set[int] = set()
    b = 1
    while b < burst:
        out.add(b)
        b *= 2
    out.add(max(1, burst))
    return sorted(out)


def split_page_payloads(bufs, n: int) -> list[tuple]:
    """Slice a landed gather burst into per-page payload tuples.

    ``bufs`` is the ``(k, v, ks, vs, dk, dv)`` buffer tuple of a
    ``gather_pages`` burst on the host (any member may be None), ``n`` the
    number of real pages in it.  Each payload copies its ``[:, :, i]``
    slice out of the burst (a view would pin the whole burst for as long
    as one page stays cached).  The tuple is the page-payload format of
    writeback, fault-in and export / import alike."""
    return [tuple(None if a is None else a[:, :, i].clone() for a in bufs) for i in range(n)]


def gather_pages(
    k_pages: torch.Tensor,  # [L, n_kv, P + 1, ps, hd] (hd // 2 for int4)
    v_pages: torch.Tensor,
    idx: torch.Tensor,  # [nb] int32 page indices, -1 padding
    k_scales: torch.Tensor | None = None,  # [L, n_kv, P + 1] f32
    v_scales: torch.Tensor | None = None,
):
    """Read a migration burst into fresh [L, n_kv, nb, ps, hd] buffers
    (and [L, n_kv, nb] scales).  The pools stay as they are: device ->
    host is a residency copy, not a release.  Padding indices clamp to
    page 0."""
    safe = torch.clamp(idx.long(), min=0)
    k = k_pages.index_select(2, safe)
    v = v_pages.index_select(2, safe)
    ks = None if k_scales is None else k_scales.index_select(2, safe)
    vs = None if v_scales is None else v_scales.index_select(2, safe)
    return k, v, ks, vs


def scatter_pages(
    k_pages: torch.Tensor,  # [L, n_kv, P + 1, ps, hd], updated in place
    v_pages: torch.Tensor,
    idx: torch.Tensor,  # [nb] int32 page indices, -1 padding
    k_vals: torch.Tensor,  # [L, n_kv, nb, ps, hd] payloads on the pools' device
    k_scales: torch.Tensor | None = None,  # [L, n_kv, P + 1] f32, in place
    v_scales: torch.Tensor | None = None,
    v_vals: torch.Tensor | None = None,
    ks_vals: torch.Tensor | None = None,  # [L, n_kv, nb] f32
    vs_vals: torch.Tensor | None = None,
):
    """Write a fault-in burst into the pools at ``idx``, in place; padding
    rows land on the drop page.  Returns (k_pages, v_pages, k_scales,
    v_scales)."""
    drop = k_pages.shape[2] - 1
    safe = torch.where(idx < 0, drop, idx).long()
    k_pages.index_copy_(2, safe, k_vals.to(k_pages.dtype))
    v_pages.index_copy_(2, safe, v_vals.to(v_pages.dtype))
    if k_scales is not None:
        k_scales.index_copy_(2, safe, ks_vals.to(k_scales.dtype))
        v_scales.index_copy_(2, safe, vs_vals.to(v_scales.dtype))
    return k_pages, v_pages, k_scales, v_scales
