"""Prefill-window paged attention (kernel A); port of
``githubrepostorag_tpu/ops/fused_decode.py::fused_window_attention`` (:171),
``fused_paged_attention`` (:246) and ``fused_packed_attention`` (:259),
over full-precision, int8 and int4 pools.

Every row scores an S-token query window based at ``cached_lens[b]``
against its block-table pages: causal mask ``kv_pos <= cached + t``,
validity ``kv_pos < cached + new``.  Masked scores are -1e30, a row with no
valid KV outputs 0, and scores and accumulators are float32.  Quantized
pools (int8 codes, or uint8 ``pack_int4`` nibble planes of half the head
width) carry one f32 scale per (kv head, page): a key's score is scaled by
its page's ``k_scales`` entry and a value row by its ``v_scales`` entry, in
float32, as the TPU kernel applies them.

``fused_window_attention`` launches the hand-written Hopper kernel
``csrc/fused_window_attention.cu`` for CUDA tensors and runs
``fused_window_attention_ref``, the plain PyTorch version, for CPU tensors.
"""

from __future__ import annotations

import torch

from githubrepostorag_tpu_torch import kernels
from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# pool element codes of the C entry points (csrc/common.cuh)
POOL_CODES = {"fp": 0, "int8": 1, "int4": 2}


def fused_window_attention_ref(q_win, k_pages, v_pages, block_tables, cached_lens,
                               new_lens, k_scales=None, v_scales=None):
    """Plain PyTorch version of kernel A: gather the pages (quantized ones
    dequantized in float32), mask, softmax in float32, round only the
    output.  Same contract and output dtype as ``fused_window_attention``."""
    b, s, n_q, hd = q_win.shape
    k, v = gather_kv(k_pages, v_pages, block_tables, k_scales, v_scales,
                     dtype=torch.float32)  # [B, T, n_kv, hd]
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


def fused_window_attention(q_win, k_pages, v_pages, block_tables, cached_lens, new_lens,
                           k_scales=None, v_scales=None):
    """q_win [B, S, n_q, hd]; k_pages/v_pages [n_kv, P, page_size, hd] (one
    layer's pool; int8, or uint8 [.., hd // 2] nibble planes, when
    quantized); block_tables [B, max_pages] int32; cached_lens, new_lens
    [B] int32 (the new tokens are already committed); k_scales/v_scales
    [n_kv, P] f32 per-page scales of quantized pools, else None.  Returns
    [B, S, n_q, hd] in q_win.dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if q_win.device.type == "cpu":
        return fused_window_attention_ref(q_win, k_pages, v_pages, block_tables,
                                          cached_lens, new_lens, k_scales, v_scales)
    _require(q_win.device.type == "cuda", f"unsupported device {q_win.device}")
    kind = "fp" if k_scales is None else ("int4" if k_pages.dtype == torch.uint8 else "int8")
    tensors = [q_win, k_pages, v_pages, block_tables, cached_lens, new_lens]
    if kind != "fp":
        _require(v_scales is not None, "k_scales without v_scales")
        tensors += [k_scales, v_scales]
    _require(all(x.device == q_win.device for x in tensors),
             "all operands must be on one device")
    _require(all(x.is_contiguous() for x in tensors), "operands must be contiguous")
    _require(q_win.dim() == 4 and k_pages.dim() == 4, "q [B,S,n_q,hd], pools [n_kv,P,ps,hd]")
    b, s, n_q, hd = q_win.shape
    n_kv, num_pages, page_size, hd_pool = k_pages.shape
    _require(v_pages.shape == k_pages.shape and v_pages.dtype == k_pages.dtype,
             "k/v pools differ")
    _require(hd in _HEAD_DIMS and hd_pool == (hd // 2 if kind == "int4" else hd),
             f"head_dim {hd} (pool {hd_pool}, {kind}) not in {_HEAD_DIMS}")
    _require(n_q % n_kv == 0, f"n_q {n_q} not a multiple of n_kv {n_kv}")
    pool_dtype = {"fp": q_win.dtype, "int8": torch.int8, "int4": torch.uint8}[kind]
    _require(q_win.dtype in _DTYPES and k_pages.dtype == pool_dtype,
             f"q/pool dtypes {q_win.dtype}/{k_pages.dtype}; need q bf16 or f32 and "
             "pools of q's dtype, int8 or uint8 (int4)")
    if kind != "fp":
        _require(all(x.shape == (n_kv, num_pages) and x.dtype == torch.float32
                     for x in (k_scales, v_scales)), "scales must be [n_kv, P] f32")
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
        k_scales.data_ptr() if kind != "fp" else None,
        v_scales.data_ptr() if kind != "fp" else None,
        b, s, n_q, n_kv, num_pages, page_size, hd, block_tables.shape[1],
        _DTYPES[q_win.dtype], POOL_CODES[kind], 1.0 / hd ** 0.5, stream,
    )
    kernels.check_launch("fused_window_attention", err)
    fused_window_attention.launches += 1
    fused_window_attention.launches_by_pool[kind] += 1
    return out


# kernel launches (CUDA path only), in all and per pool branch
fused_window_attention.launches = 0
fused_window_attention.launches_by_pool = dict.fromkeys(POOL_CODES, 0)


def fused_paged_attention(q, k_pages, v_pages, block_tables, cached_lens, new_lens,
                          k_scales=None, v_scales=None):
    """Drop-in for ``paged_attention_ref`` at the ``forward_paged`` seam:
    prefill chunks (and any S-token window) over fp, int8 or int4 pools go
    through kernel A."""
    return fused_window_attention(q, k_pages, v_pages, block_tables, cached_lens,
                                  new_lens, k_scales, v_scales)


def fused_packed_attention(q, k_pages, v_pages, block_tables, cached_lens, new_lens,
                           seg_ids, positions, *, tq: int, k_scales=None, v_scales=None):
    """Packed prefill over quantized pools: the packed queries [T, n_q, hd]
    scatter into the segment-major [R, tq] window view (a segment's chunk
    is a window based at its cached length), kernel A runs every segment,
    and the outputs gather back to packed order.  Padding tokens read a
    clamped row: finite values that nothing reads (their K/V is dropped and
    their logits never projected)."""
    from githubrepostorag_tpu_torch.ops.packed_prefill import _segment_scatter_indices

    t, n_q, hd = q.shape
    r = block_tables.shape[0]
    dest = _segment_scatter_indices(seg_ids, positions, cached_lens, tq).long()
    # one row past the view takes the padding tokens' writes
    q_seg = torch.zeros((r * tq + 1, n_q, hd), dtype=q.dtype, device=q.device)
    q_seg.index_copy_(0, dest, q)
    out_seg = fused_window_attention(
        q_seg[: r * tq].reshape(r, tq, n_q, hd), k_pages, v_pages, block_tables,
        cached_lens, new_lens, k_scales, v_scales)
    return out_seg.reshape(r * tq, n_q, hd)[torch.clamp(dest, max=r * tq - 1)]
