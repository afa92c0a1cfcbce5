"""Sequence-parallel long-context prefill: a whole prompt (or many, packed)
in one pass with ring attention over the ``sp`` mesh axis, K/V committed to
the paged pools; port of ``githubrepostorag_tpu/serving/long_prefill.py``.

Chunked prefill bounds memory, but its attention work is serial in the
chunk count; here the sequence axis is sharded over ``sp``: each rank keeps
its contiguous query shard of ``width / sp`` tokens, K/V shards rotate
around the ring (``parallel/ring_attention.py``: ppermute and an online
softmax, exact causal), and decode then proceeds on the standard paged
path, so a long prompt is special only for its first step.

Both functions take the global ``[1, width]`` host layout, the same on
every rank (the engine's ranks take the same decisions), and cut their
shard of the sequence from it.  Each layer's post-RoPE K/V shard is
all-gathered over sp and committed whole through ``kv_cache.commit_paged``
(quantizing with the pages' first-write scales over int8 / int4 pools), so
every rank of the sp group ends with the whole prompt's pages, identical,
and a page's first-write scale sees all of its tokens.  Padding slots are
-1 and land on the pools' drop page, as on the chunked path (JAX sends them
out of range so its scatter drops them).  On a tp mesh the heads, the
pools and the projections are this rank's, with Megatron's collectives
(``models/qwen2._block(mesh=)``).

Logits are projected only at each segment's last token: the rank that
holds the token contributes its hidden state, the others zeros, and the
sum over sp (exact) gives every rank the same rows.  int4 projections pin
the exact bf16-dequant route (kernel D), as ``forward_paged`` does.
"""

from __future__ import annotations

import functools

import torch

from githubrepostorag_tpu_torch.models.qwen2 import (
    Qwen2Config,
    _block,
    _embed,
    _mesh_logits,
    layer_params,
)
from githubrepostorag_tpu_torch.models.quant import qmatmul
from githubrepostorag_tpu_torch.ops.norms import rms_norm
from githubrepostorag_tpu_torch.ops.rope import rope_cos_sin
from githubrepostorag_tpu_torch.parallel.collectives import gather_from_axis, reduce_from_axis
from githubrepostorag_tpu_torch.parallel.ring_attention import make_ring_attend
from githubrepostorag_tpu_torch.serving.kv_cache import commit_paged


@torch.no_grad()
def ring_prefill(
    params: dict,
    cfg: Qwen2Config,
    input_ids: torch.Tensor,  # [1, Sp] int, right-padded; Sp % sp == 0
    positions: torch.Tensor,  # [1, Sp] int
    k_pages: torch.Tensor,  # [L, n_kv, P + 1, page_size, hd], updated in place
    v_pages: torch.Tensor,
    slot_mapping: torch.Tensor,  # [1, Sp] int flat pool slots, -1 padding
    last_idx: torch.Tensor,  # [1] int index of the last real token
    mesh,  # parallel.mesh.Mesh (sp >= 1; tp composes)
    k_scales: torch.Tensor | None = None,  # [L, n_kv, P + 1] f32 per-page
    v_scales: torch.Tensor | None = None,  # scales of int8 / int4 pools
):
    """Prefill one whole prompt sequence-parallel and write its KV pages.
    Padding sits after the last real token, so causal masking keeps it out
    of every real position's attention.  Returns (logits [1, 1, V] float32,
    k_pages, v_pages, k_scales, v_scales): a fixed five, the scales None
    for full-precision pools."""
    return _ring_pass(params, cfg, input_ids, positions, k_pages, v_pages, slot_mapping,
                      None, last_idx, mesh, k_scales, v_scales)


@torch.no_grad()
def ring_prefill_packed(
    params: dict,
    cfg: Qwen2Config,
    input_ids: torch.Tensor,  # [1, Sp] int, many prompts back to back
    positions: torch.Tensor,  # [1, Sp] int, restarting at 0 per segment
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    slot_mapping: torch.Tensor,  # [1, Sp] int flat pool slots, -1 padding
    seg_ids: torch.Tensor,  # [1, Sp] int segment ids; >= R marks padding
    logits_at: torch.Tensor,  # [R] int each segment's last-token index
    mesh,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
):
    """Segment-packed ring prefill: many prompts flattened back to back into
    one ring pass (``ops/packed_prefill.ring_segment_layout``).  ``seg_ids``
    confine attention to each prompt's own tokens (the kv-side ids rotate
    with their K/V block), ``positions`` restart per segment, and each
    segment's K/V lands in its own pages.  Rows of ``logits_at`` past the
    live segment count point at index 0 and the caller ignores them.
    Returns (logits [R, 1, V], k_pages, v_pages, k_scales, v_scales)."""
    return _ring_pass(params, cfg, input_ids, positions, k_pages, v_pages, slot_mapping,
                      seg_ids, logits_at, mesh, k_scales, v_scales)


def _ring_pass(params, cfg, input_ids, positions, k_pages, v_pages, slot_mapping, seg_ids,
               logits_at, mesh, k_scales, v_scales):
    sp, my = mesh.shape["sp"], mesh.coords["sp"]
    sp_group = mesh.group("sp")
    width = input_ids.shape[1]
    if width % sp:
        raise ValueError(f"ring width {width} is not a multiple of sp={sp}")
    sl = width // sp  # this rank's tokens [my * sl, (my + 1) * sl)
    here = slice(my * sl, (my + 1) * sl)
    attend = make_ring_attend(mesh, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                              segmented=seg_ids is not None)
    seg_loc = seg_ids[:, here] if seg_ids is not None else None
    mm = functools.partial(qmatmul, w4a8=False)
    page_size = k_pages.shape[3]
    flat_slots = slot_mapping.reshape(-1)
    quant = k_scales is not None

    h = _embed(params, cfg, input_ids[:, here], mesh)
    cos, sin = rope_cos_sin(positions[:, here], cfg.head_dim, cfg.rope_theta)
    for li in range(cfg.num_layers):
        kv = []

        def capture(q, k, v):
            kv.append((k, v))  # post-RoPE, this rank's heads and tokens
            return attend(q, k, v) if seg_loc is None else attend(q, k, v, seg_loc)

        h = _block(cfg, h, layer_params(params["layers"], li), cos, sin, capture, mm,
                   mesh=mesh)
        for pools, scales, shard in ((k_pages, k_scales, kv[0][0]),
                                     (v_pages, v_scales, kv[0][1])):
            whole = gather_from_axis(shard, sp_group, dim=1)[0]  # [Sp, n_kv, hd]
            commit_paged(pools[li], whole.transpose(0, 1), flat_slots, page_size,
                         scales[li] if quant else None)

    h = rms_norm(h, params["norm"], cfg.rms_norm_eps)[0]  # [sl, d]
    local = logits_at.long() - my * sl
    inside = (local >= 0) & (local < sl)
    h_last = h[local.clamp(0, sl - 1)].masked_fill(~inside[:, None], 0)
    h_last = reduce_from_axis(h_last, sp_group)[:, None, :]  # [R, 1, d]
    logits = _mesh_logits(params, cfg, h_last, mesh, w4a8=False)
    return logits, k_pages, v_pages, k_scales, v_scales
