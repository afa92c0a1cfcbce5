"""Token-budget packed prefill attention (kernel C); port of
``githubrepostorag_tpu/ops/packed_prefill.py`` (:61-270).

A packed prefill wave holds every prefilling row's next chunk back to back
in one ``[T]`` token buffer (T = the token budget) with per-token segment
ids, so the dense layers scale with real tokens instead of rows x chunk.
Attention keeps each segment's causal structure over its own pages.

Contract:
  q            [T, n_q, hd]   packed new-token queries
  k_pages      [n_kv, P, page_size, hd] this layer's pool, the packed
               chunk's K/V already committed
  v_pages      [n_kv, P, page_size, hd]
  block_tables [R, max_pages] int32 page ids per segment
  cached_lens  [R] int32 tokens in cache before this chunk, per segment
  new_lens     [R] int32 new tokens this chunk, per segment (<= tq)
  seg_ids      [T] int32 owning segment per token; >= R marks padding
  positions    [T] int32 absolute position per token (token t sits at
               in-chunk index positions[t] - cached_lens[seg_ids[t]] < tq)
Returns [T, n_q, hd] in q.dtype.

``packed_prefill_attention`` routes as the JAX function does: quantized
pools to kernel A (``fused_decode.fused_packed_attention``), full-precision
pools to kernel C (``packed_prefill_attention_seg``, the hand-written Hopper
kernel ``csrc/packed_prefill.cu``: kernel A's bodies and plan,
``fused_decode._plan_window``), and with ``use_kernels=False`` to
``packed_prefill_attention_ref``, the XLA path of the JAX function.

``ring_segment_layout`` lays out the segment-packed ring buffer of the
sequence-parallel prefill (``serving/long_prefill.ring_prefill_packed``).
"""

from __future__ import annotations

import numpy as np
import torch

from githubrepostorag_tpu_torch import kernels
from githubrepostorag_tpu_torch.device import sm_count
from githubrepostorag_tpu_torch.ops.attention import dense_attention
from githubrepostorag_tpu_torch.ops.fused_decode import _plan_window, fused_packed_attention
from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _segment_scatter_indices(seg_ids, positions, cached_lens, tq: int) -> torch.Tensor:
    """Row of every packed token in the segment-major [R * tq] view;
    padding tokens (seg >= R) map to the sentinel R * tq, one past the
    view (a torch index write would wrap a negative index, so the sentinel
    is explicit and positive, as in the JAX function)."""
    r = cached_lens.shape[0]
    cached_ext = torch.cat([cached_lens.to(torch.int32),
                            torch.zeros(1, dtype=torch.int32, device=cached_lens.device)])
    seg_c = torch.clamp(seg_ids.long(), max=r)
    in_chunk = positions.to(torch.int32) - cached_ext[seg_c]
    return torch.where(seg_ids >= r, r * tq, seg_c.to(torch.int32) * tq + in_chunk)


def packed_prefill_attention_ref(q, k_pages, v_pages, block_tables, cached_lens, new_lens,
                                 seg_ids, positions, *, tq: int, k_scales=None,
                                 v_scales=None):
    """The XLA path of the JAX function: scatter the packed queries into
    the segment-major [R, tq] view, gather each segment's pages
    (quantized ones dequantized and rounded to q's dtype, as JAX's
    ``gather_kv`` does) and run ``dense_attention``, gather back.  Padding
    tokens get 0."""
    t, n_q, hd = q.shape
    r = block_tables.shape[0]
    dest = _segment_scatter_indices(seg_ids, positions, cached_lens, tq).long()
    q_seg = torch.zeros((r * tq + 1, n_q, hd), dtype=q.dtype, device=q.device)
    q_seg.index_copy_(0, dest, q)
    k, v = gather_kv(k_pages, v_pages, block_tables, k_scales, v_scales, dtype=q.dtype)
    cached = cached_lens.to(q.device)
    out_seg = dense_attention(q_seg[: r * tq].reshape(r, tq, n_q, hd), k, v, causal=True,
                              q_offset=cached, kv_lengths=cached + new_lens.to(q.device))
    out = out_seg.reshape(r * tq, n_q, hd)[torch.clamp(dest, max=r * tq - 1)]
    return torch.where((seg_ids < r).to(q.device)[:, None, None], out, 0.0).to(q.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"packed_prefill_attention_seg: {msg}")


def packed_prefill_attention_seg(q, k_pages, v_pages, block_tables, cached_lens, new_lens,
                                 seg_ids, positions, *, tq: int):
    """Kernel C: flash prefill per segment of the packed buffer, over
    full-precision pools.

    It keeps the JAX name, but not the JAX argument: the TPU kernel needs
    rectangular tiles, so its wrapper re-pads q into the segment-major
    [R, tq] view and back, two passes over [R * tq, n_q, hd] per layer and
    every segment's padding computed.  This kernel reads the packed q
    [T, n_q, hd] and writes the packed output directly; the view exists
    only as an int32 index of R * tq entries (the inverse of
    ``_segment_scatter_indices``), built here with one scatter of T integers
    on the device.  Padding tokens get 0.  CPU tensors take
    ``packed_prefill_attention_ref``; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return packed_prefill_attention_ref(q, k_pages, v_pages, block_tables, cached_lens,
                                            new_lens, seg_ids, positions, tq=tq)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    tensors = (q, k_pages, v_pages, block_tables, cached_lens, new_lens, seg_ids, positions)
    _require(all(x.device == q.device for x in tensors), "all operands must be on one device")
    _require(all(x.is_contiguous() for x in tensors), "operands must be contiguous")
    _require(q.dim() == 3 and k_pages.dim() == 4, "q [T, n_q, hd], pools [n_kv, P, ps, hd]")
    t, n_q, hd = q.shape
    n_kv, num_pages, page_size, hd_pool = k_pages.shape
    r = block_tables.shape[0]
    _require(v_pages.shape == k_pages.shape, "k/v pool shapes differ")
    _require(hd_pool == hd and hd in _HEAD_DIMS, f"head_dim {hd} (pool {hd_pool}) not in {_HEAD_DIMS}")
    _require(n_q % n_kv == 0, f"n_q {n_q} not a multiple of n_kv {n_kv}")
    _require(q.dtype in _DTYPES and k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
             f"q/pool dtypes {q.dtype}/{k_pages.dtype}/{v_pages.dtype}; need one of bf16, f32 "
             "(quantized pools take kernel A)")
    _require(block_tables.dim() == 2 and block_tables.dtype == torch.int32,
             "block_tables must be [R, max_pages] int32")
    _require(all(x.shape == (r,) and x.dtype == torch.int32 for x in (cached_lens, new_lens)),
             "cached_lens / new_lens must be [R] int32")
    _require(all(x.shape == (t,) and x.dtype == torch.int32 for x in (seg_ids, positions)),
             "seg_ids / positions must be [T] int32")
    _require(tq >= 1, f"tq {tq} must be >= 1")
    _require(all(x.data_ptr() % 16 == 0 for x in (q, k_pages, v_pages)),
             "q and pools must be 16-byte aligned")
    _plan_window(r, tq, n_q, n_kv, hd, page_size, sm_count(q.device),
                 route="wgmma" if q.dtype == torch.bfloat16 else "fma")
    dest = _segment_scatter_indices(seg_ids, positions, cached_lens, tq).long()
    # row_of[r * tq + i]: packed token of segment r's i-th new token; the
    # entry past the view takes the padding tokens' writes
    row_of = torch.full((r * tq + 1,), -1, dtype=torch.int32, device=q.device)
    row_of.scatter_(0, dest, torch.arange(t, dtype=torch.int32, device=q.device))
    out = torch.zeros_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = kernels.launcher("packed_prefill")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), cached_lens.data_ptr(), new_lens.data_ptr(),
        row_of.data_ptr(), r, tq, n_q, n_kv, num_pages, page_size, hd,
        block_tables.shape[1], _DTYPES[q.dtype], 1.0 / hd ** 0.5, stream,
    )
    kernels.check_launch("packed_prefill_attention_seg", err)
    packed_prefill_attention_seg.launches += 1
    return out


packed_prefill_attention_seg.launches = 0  # kernel launches (CUDA path only)


def packed_prefill_attention(q, k_pages, v_pages, block_tables, cached_lens, new_lens,
                             seg_ids, positions, *, tq: int, use_kernels: bool = True,
                             k_scales=None, v_scales=None):
    """Packed-buffer entry point (see the module docstring for the
    contract).  With ``use_kernels``, quantized pools (``k_scales`` given)
    run kernel A through ``fused_packed_attention`` and full-precision pools
    run kernel C; without, ``packed_prefill_attention_ref``."""
    if not use_kernels:
        return packed_prefill_attention_ref(q, k_pages, v_pages, block_tables, cached_lens,
                                            new_lens, seg_ids, positions, tq=tq,
                                            k_scales=k_scales, v_scales=v_scales)
    if k_scales is not None:
        return fused_packed_attention(q, k_pages, v_pages, block_tables, cached_lens,
                                      new_lens, seg_ids, positions, tq=tq,
                                      k_scales=k_scales, v_scales=v_scales)
    return packed_prefill_attention_seg(q, k_pages, v_pages, block_tables, cached_lens,
                                        new_lens, seg_ids, positions, tq=tq)


def ring_segment_layout(lens: list[int], width: int, rb: int):
    """Host layout of a segment-packed ring buffer: whole prompts back to
    back from position 0 (a ring pass has no cached prefix, so a token's
    index within its segment is its RoPE position).  Returns numpy arrays:

      seg       [width] int32 owning segment per token; ``rb`` (the fixed
                segment-row count) marks padding
      positions [width] int32, restarting at 0 per segment
      logits_at [rb]    int32 each segment's last-token index into the
                buffer; rows past len(lens) point at 0 (ignored)
      starts    [len(lens)] int32 each segment's first-token offset

    The engine's packed ring dispatch and its tests share it."""
    if sum(lens) > width or len(lens) > rb:
        raise ValueError(f"{len(lens)} segments of {sum(lens)} tokens do not fit a "
                         f"[{width}] ring buffer of {rb} segment rows")
    seg = np.full((width,), rb, dtype=np.int32)
    positions = np.zeros((width,), dtype=np.int32)
    logits_at = np.zeros((rb,), dtype=np.int32)
    starts = np.zeros((len(lens),), dtype=np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off: off + n] = i
        positions[off: off + n] = np.arange(n)
        logits_at[i] = off + n - 1
        starts[i] = off
        off += n
    return seg, positions, logits_at, starts
