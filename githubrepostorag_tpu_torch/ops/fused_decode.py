"""Prefill-window paged attention (kernel A); port of
``githubrepostorag_tpu/ops/fused_decode.py::fused_window_attention`` (:171)
and ``fused_paged_attention`` (:246), full-precision pools.

Every row scores an S-token query window based at ``cached_lens[b]``
against its block-table pages: causal mask ``kv_pos <= cached + t``,
validity ``kv_pos < cached + new``.  Masked scores are -1e30, a row with no
valid KV outputs 0, and scores and accumulators are float32.

``fused_window_attention`` launches the hand-written Hopper kernel
``csrc/fused_window_attention.cu`` for CUDA tensors and runs
``fused_window_attention_ref``, the plain PyTorch version, for CPU tensors.
The int8/int4 pool branches of the TPU kernel are not ported yet.
"""

from __future__ import annotations

import torch

from githubrepostorag_tpu_torch import kernels
from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def fused_window_attention_ref(q_win, k_pages, v_pages, block_tables, cached_lens,
                               new_lens):
    """Plain PyTorch version of kernel A: gather the pages, mask, softmax in
    float32.  Same contract and output dtype as ``fused_window_attention``."""
    b, s, n_q, hd = q_win.shape
    k, v = gather_kv(k_pages, v_pages, block_tables)  # [B, T, n_kv, hd]
    t, n_kv = k.shape[1], k.shape[2]
    group = n_q // n_kv
    dev = q_win.device

    qg = q_win.reshape(b, s, n_kv, group, hd).float()
    scores = torch.einsum("bsngh,btnh->bngst", qg, k.float()) * (1.0 / hd ** 0.5)
    cached = cached_lens.to(dev).long()
    total = cached + new_lens.to(dev).long()
    kv_pos = torch.arange(t, device=dev)
    q_pos = cached[:, None] + torch.arange(s, device=dev)  # [B, S]
    valid = (kv_pos[None, None, :] <= q_pos[:, :, None]) & (
        kv_pos[None, None, :] < total[:, None, None])  # [B, S, T]
    valid = valid[:, None, None]  # [B, 1, 1, S, T]
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.where(valid, torch.exp(scores - scores.amax(dim=-1, keepdim=True)), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bngst,btnh->bsngh", p / torch.where(denom == 0, 1.0, denom),
                       v.float())
    return out.reshape(b, s, n_q, hd).to(q_win.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_window_attention: {msg}")


def fused_window_attention(q_win, k_pages, v_pages, block_tables, cached_lens, new_lens):
    """q_win [B, S, n_q, hd]; k_pages/v_pages [n_kv, P, page_size, hd] (one
    layer's pool); block_tables [B, max_pages] int32; cached_lens, new_lens
    [B] int32 (the new tokens are already committed).  Returns
    [B, S, n_q, hd] in q_win.dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q_win.device.type == "cpu":
        return fused_window_attention_ref(q_win, k_pages, v_pages, block_tables,
                                          cached_lens, new_lens)
    _require(q_win.device.type == "cuda", f"unsupported device {q_win.device}")
    tensors = (q_win, k_pages, v_pages, block_tables, cached_lens, new_lens)
    _require(all(x.device == q_win.device for x in tensors),
             "all operands must be on one device")
    _require(all(x.is_contiguous() for x in tensors), "operands must be contiguous")
    _require(q_win.dim() == 4 and k_pages.dim() == 4, "q [B,S,n_q,hd], pools [n_kv,P,ps,hd]")
    b, s, n_q, hd = q_win.shape
    n_kv, num_pages, page_size, hd_pool = k_pages.shape
    _require(v_pages.shape == k_pages.shape, "k/v pool shapes differ")
    _require(hd_pool == hd and hd in _HEAD_DIMS, f"head_dim {hd} (pool {hd_pool}) not in {_HEAD_DIMS}")
    _require(n_q % n_kv == 0, f"n_q {n_q} not a multiple of n_kv {n_kv}")
    _require(q_win.dtype in _DTYPES and k_pages.dtype == q_win.dtype
             and v_pages.dtype == q_win.dtype,
             f"q/pool dtypes {q_win.dtype}/{k_pages.dtype}/{v_pages.dtype}; need one of bf16, f32")
    _require(block_tables.dim() == 2 and block_tables.shape[0] == b
             and block_tables.dtype == torch.int32, "block_tables must be [B, max_pages] int32")
    _require(cached_lens.shape == (b,) and new_lens.shape == (b,)
             and cached_lens.dtype == torch.int32 and new_lens.dtype == torch.int32,
             "cached_lens / new_lens must be [B] int32")
    _require(all(x.data_ptr() % 16 == 0 for x in (q_win, k_pages, v_pages)),
             "q and pools must be 16-byte aligned")
    out = torch.empty_like(q_win)
    stream = torch.cuda.current_stream(q_win.device).cuda_stream
    err = kernels.launcher("fused_window_attention")(
        q_win.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), cached_lens.data_ptr(), new_lens.data_ptr(),
        b, s, n_q, n_kv, num_pages, page_size, hd, block_tables.shape[1],
        _DTYPES[q_win.dtype], 1.0 / hd ** 0.5, stream,
    )
    kernels.check_launch("fused_window_attention", err)
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0  # kernel launches (CUDA path only)


def fused_paged_attention(q, k_pages, v_pages, block_tables, cached_lens, new_lens):
    """Drop-in for ``paged_attention_ref`` at the ``forward_paged`` seam:
    prefill chunks (and any S-token window) go through kernel A."""
    return fused_window_attention(q, k_pages, v_pages, block_tables, cached_lens,
                                  new_lens)
