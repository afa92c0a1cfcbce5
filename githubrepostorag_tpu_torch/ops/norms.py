"""RMSNorm (Qwen2/Llama family); port of ``githubrepostorag_tpu/ops/norms.py``.

Computed in float32 whatever the input dtype, cast back before the weight
multiply, matching HF's Qwen2RMSNorm and the JAX reference."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return normed.to(x.dtype) * weight
