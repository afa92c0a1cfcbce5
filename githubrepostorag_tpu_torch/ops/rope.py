"""Rotary position embeddings (rotate-half convention); port of
``githubrepostorag_tpu/ops/rope.py``.

cos/sin are computed in float32 from integer positions, then applied in
the activation dtype."""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """positions [B, S] (int) -> cos, sin each [B, S, head_dim] float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * inv_freq  # [B, S, hd/2]
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q [B, S, n_q, hd], k [B, S, n_kv, hd]; cos/sin [B, S, hd]."""
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin
