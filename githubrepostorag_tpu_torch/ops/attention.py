"""Dense grouped-query attention; port of ``githubrepostorag_tpu/ops/attention.py``.

The plain path the paged-attention oracle runs on.  Q heads reshape to
[n_kv, group] so K/V are never repeated across the group."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def dense_attention(
    q: torch.Tensor,  # [B, Sq, n_q, hd]
    k: torch.Tensor,  # [B, Sk, n_kv, hd]
    v: torch.Tensor,  # [B, Sk, n_kv, hd]
    *,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,
    kv_lengths: torch.Tensor | None = None,  # [B] valid kv length per row
    kv_valid: torch.Tensor | None = None,  # [B, Sk] bool, arbitrary validity
) -> torch.Tensor:
    """Scaled-dot-product attention with causal masking and GQA.

    ``q_offset`` is the absolute position of q's first token in the kv
    sequence (scalar or [B]); ``kv_lengths`` masks right-padded kv per row;
    ``kv_valid`` masks arbitrary kv entries.  Returns [B, Sq, n_q, hd] in
    q.dtype; softmax in float32."""
    b, sq, n_q, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    group = n_q // n_kv
    dev = q.device

    qg = q.reshape(b, sq, n_kv, group, hd).float()
    scores = torch.einsum("bsngh,btnh->bngst", qg, k.float()) * (1.0 / hd ** 0.5)

    kv_pos = torch.arange(sk, device=dev)
    mask = torch.zeros((b, 1, 1, sq, sk), dtype=torch.bool, device=dev)
    if causal:
        offset = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
        q_pos = torch.arange(sq, device=dev) + offset  # [B or 1, Sq]
        mask = mask | (kv_pos[None, None, :] > q_pos[:, :, None])[:, None, None]
    if kv_lengths is not None:
        pad = kv_pos[None, :] >= kv_lengths.to(dev)[:, None]  # [B, Sk]
        mask = mask | pad[:, None, None, None, :]
    if kv_valid is not None:
        mask = mask | (~kv_valid)[:, None, None, None, :]
    scores = scores.masked_fill(mask, NEG_INF)

    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bngst,btnh->bsngh", probs, v.float())
    return out.reshape(b, sq, n_q, hd).to(q.dtype)
