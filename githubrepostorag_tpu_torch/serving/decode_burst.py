"""Multi-step decode burst; port of ``githubrepostorag_tpu/serving/decode_burst.py``.

``decode_burst`` runs ``n_steps`` decode iterations for every active row
with no host sync inside: sampled tokens feed the next step's embedding
lookup on the device, the repetition-penalty presence mask updates in
place, and the host reads only the final [B, n_steps] token block.

The page pools stay frozen during the burst.  Each step's new K/V go to a
small staged buffer [L, B, n_kv, n_steps, hd]; attention covers (pool
prefix) + (staged tail so far); the staged tokens are committed into the
pools once, at burst end, with ``commit_paged``.  Attention runs kernel B
(``ops/paged_decode.py``) on the whole rank-5 pools; on CPU tensors its
wrapper runs the plain version.

Quantized pools (``k_scales``/``v_scales`` given) keep the staged tail in
the activation dtype, and the burst-end commit quantizes it with the pages'
first-write scales.  int8 pools run kernel B's int8 branch.  int4 (uint8)
pools take the gather path, as the JAX package does (the TPU kernel has no
nibble branch): each layer's pages are gathered and dequantized to the
activation dtype (``gather_kv``) and attention is ``dense_attention`` over
[pool prefix | staged tail].

Rows self-deactivate when they reach ``row_limits`` (their allocated page
capacity), so a burst never writes beyond a row's pages.

int4 projections and the logits take the automatic route, so a decode
batch (at most 256 rows) runs kernel E (``ops/int4_matmul.py``).  Each
layer's quantized leaves are views (``layer_params``), which the kernel
reads in place: the JAX package's ``Layered4`` / ``_split_q4`` (a stacked
weight plus a layer index, so its scan never slices a copy) have no
counterpart here.

On a mesh (``mesh=``) the weights are this rank's slices and the pools hold
its ``n_kv / tp`` heads: kernel B runs on this rank's heads and pools with
no collective inside (the JAX ``_staged_attend_tp`` island), the blocks run
Megatron's pair of collectives, and the vocab-parallel logits are gathered
whole on every rank, so each rank samples the same tokens from the same
generator.  int4 projections run kernels D / E on the rank's slices, where
JAX takes its partitionable XLA formulation (an opaque ``pallas_call`` has
no partitioning rule); the route is judged on the slice's shapes.
"""

from __future__ import annotations

import torch

from githubrepostorag_tpu_torch.models.qwen2 import (
    Qwen2Config,
    _block,
    _embed,
    _embed_dtype,
    _mesh_logits,
    layer_params,
)
from githubrepostorag_tpu_torch.ops.attention import dense_attention
from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv
from githubrepostorag_tpu_torch.ops.paged_decode import paged_attention_decode_staged
from githubrepostorag_tpu_torch.ops.rope import rope_cos_sin
from githubrepostorag_tpu_torch.ops.sampling import sample_tokens_capped, sample_tokens_nofilter
from githubrepostorag_tpu_torch.serving.kv_cache import commit_paged


def decode_burst(
    params: dict,
    cfg: Qwen2Config,
    last_tokens: torch.Tensor,  # [B] int32, last committed token (may be -1)
    seq_lens: torch.Tensor,  # [B] int32 tokens already cached per row
    k_pages: torch.Tensor,  # [L, n_kv, P, ps, hd], updated in place
    v_pages: torch.Tensor,
    presence: torch.Tensor,  # [B, >= V] bool, updated in place
    active: torch.Tensor,  # [B] bool
    row_limits: torch.Tensor,  # [B] int32 max cacheable tokens per row
    block_tables: torch.Tensor,  # [B, max_pages] int32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B] float32
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int32
    repetition_penalty: torch.Tensor,  # [B]
    n_steps: int,
    filter_sampling: bool = True,  # False: no running row filters (top_p >= 1,
    # top_k <= 0), so sampling takes the sort-free path
    k_scales: torch.Tensor | None = None,  # [L, n_kv, P] f32 per-page scales of
    v_scales: torch.Tensor | None = None,  # int8 / int4 pools, updated in place
    mesh=None,  # this rank's slices and pools (module docstring)
):
    """Returns (tokens [B, n_steps] int32, valid [B, n_steps] bool, k_pages,
    v_pages, presence, seq_lens), and k_scales, v_scales after them when
    quantized.  ``tokens`` is packed: -1 where the row was inactive, so the
    host learns tokens and validity from one transfer.  Presence columns
    past the vocab are never read or written here (the engine keeps one
    extra column as its drop sentinel)."""
    b = last_tokens.shape[0]
    L, n_kv, hd = cfg.num_layers, k_pages.shape[1], cfg.head_dim
    page_size = k_pages.shape[3]
    dev = last_tokens.device
    rows = torch.arange(b, device=dev)
    vocab = cfg.vocab_size
    start_lens = seq_lens  # pool validity is frozen for the whole burst
    quant = k_scales is not None
    gather_path = k_pages.dtype == torch.uint8  # int4 pages: no kernel branch
    # the staged tail stays in the activation dtype over quantized pools
    kv_dtype = _embed_dtype(params) if quant else k_pages.dtype

    staged_k = torch.zeros((L, b, n_kv, n_steps, hd), dtype=kv_dtype, device=dev)
    staged_v = torch.zeros_like(staged_k)
    staged_idx = torch.arange(n_steps, device=dev)
    if gather_path:
        pool_valid = (torch.arange(block_tables.shape[1] * page_size, device=dev)[None, :]
                      < start_lens[:, None])  # [B, max_pages * ps]

    last, lens, act = last_tokens, seq_lens, active
    toks_out, valid_out = [], []
    for step in range(n_steps):
        act = act & (lens < row_limits)
        # last may carry the -1 inactive sentinel (packed tokens chained
        # across bursts): clamp so inactive rows look up a real embedding
        h = _embed(params, cfg, torch.clamp(last, min=0)[:, None], mesh)
        cos, sin = rope_cos_sin(lens[:, None], hd, cfg.rope_theta)

        for li in range(L):
            p = layer_params(params["layers"], li)

            def attend(q, k_new, v_new):
                staged_k[li, :, :, step] = k_new[:, 0].to(staged_k.dtype)
                staged_v[li, :, :, step] = v_new[:, 0].to(staged_v.dtype)
                if gather_path:
                    return _gather_attend(q, k_pages[li], v_pages[li], k_scales[li],
                                          v_scales[li], block_tables, pool_valid,
                                          staged_k[li], staged_v[li], step)
                return paged_attention_decode_staged(
                    q, k_pages, v_pages, block_tables, start_lens,
                    staged_k[li], staged_v[li], step + 1, li, k_scales, v_scales)

            h = _block(cfg, h, p, cos, sin, attend, mesh=mesh)
        logits = _mesh_logits(params, cfg, h, mesh)[:, 0]

        pres = presence[:, :vocab]
        if filter_sampling:
            toks = sample_tokens_capped(logits, generator, temperature, top_p, top_k,
                                        repetition_penalty, pres)
        else:
            toks = sample_tokens_nofilter(logits, generator, temperature,
                                          repetition_penalty, pres)
        toks = torch.where(act, toks, last)
        tok_idx = toks.long()
        presence[rows, tok_idx] = presence[rows, tok_idx] | act
        lens = lens + act.to(lens.dtype)
        last = toks
        toks_out.append(toks)
        valid_out.append(act)

    toks = torch.stack(toks_out, dim=1)
    valid = torch.stack(valid_out, dim=1)
    packed = torch.where(valid, toks, -1).to(torch.int32)

    # one scatter commits the whole burst's staged K/V into the pools
    pos = start_lens[:, None].long() + staged_idx[None, :]  # [B, n_steps]
    page_idx = torch.clamp(pos // page_size, 0, block_tables.shape[1] - 1)
    slots = torch.gather(block_tables.long(), 1, page_idx) * page_size + pos % page_size
    flat_slots = torch.where(valid, slots, -1).reshape(-1)  # -1 is dropped
    for pools, staged, scales in ((k_pages, staged_k, k_scales), (v_pages, staged_v, v_scales)):
        # [L, B, n_kv, n, hd] -> [L, n_kv, B*n, hd] in flat_slots order
        vals = staged.transpose(1, 2).reshape(L, n_kv, b * n_steps, hd)
        commit_paged(pools, vals, flat_slots, page_size, scales)
    if quant:
        return packed, valid, k_pages, v_pages, presence, lens, k_scales, v_scales
    return packed, valid, k_pages, v_pages, presence, lens


def _gather_attend(q, kp, vp, ks, vs, block_tables, pool_valid, staged_k, staged_v,
                   step: int):
    """The JAX burst's gather path, for int4 pools: one layer's pages
    gathered and dequantized to the activation dtype, then dense attention
    over [valid pool prefix | staged tail up to this step]."""
    b, n_steps = staged_k.shape[0], staged_k.shape[2]
    pool_k, pool_v = gather_kv(kp, vp, block_tables, ks, vs, dtype=staged_k.dtype)
    k_all = torch.cat([pool_k, staged_k.transpose(1, 2)], dim=1)
    v_all = torch.cat([pool_v, staged_v.transpose(1, 2)], dim=1)
    staged_valid = (torch.arange(n_steps, device=q.device) <= step)[None, :].expand(b, n_steps)
    valid = torch.cat([pool_valid, staged_valid], dim=1)
    return dense_attention(q, k_all, v_all, causal=False, kv_valid=valid)
