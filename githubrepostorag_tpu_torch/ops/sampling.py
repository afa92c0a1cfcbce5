"""Token sampling: greedy / temperature / top-k / top-p with repetition
penalty; port of ``githubrepostorag_tpu/ops/sampling.py``.

Plain PyTorch, no kernel.  Random draws come from an explicit
``torch.Generator``: categorical sampling is Gumbel-argmax, as
``jax.random.categorical`` is, but the two frameworks' random streams
differ, so only greedy rows match the JAX package token for token.

``sample_tokens_capped`` takes its candidate set from an exact
``torch.topk`` over the full vocab where the JAX package uses
``lax.approx_max_k``: this is the JAX package's ``SAMPLING_EXACT_TOPK=1``
behaviour.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _segment_logits(logits: torch.Tensor, seg_pos=None) -> torch.Tensor:
    """Take the fused window layout [B, S, V] directly: ``seg_pos`` ([B]
    int) gathers each row's window position on the device (None: position
    0, the committed token of a verify or decode window).  Rank-2 logits
    pass through untouched."""
    if logits.dim() == 2:
        return logits
    if seg_pos is None:
        return logits[:, 0]
    idx = seg_pos.long()[:, None, None].expand(-1, 1, logits.shape[-1])
    return torch.gather(logits, 1, idx)[:, 0]


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor, penalty):
    """HF/vLLM convention: divide positive logits by the penalty, multiply
    negative ones, for every token already seen.  ``presence`` [B, V] bool."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def top_k_mask(logits: torch.Tensor, k) -> torch.Tensor:
    """Keep the k highest logits per row; ``k`` scalar or [B] int, k <= 0
    disables filtering for that row."""
    vocab = logits.shape[-1]
    k_arr = torch.as_tensor(k, dtype=torch.int64, device=logits.device)
    k_arr = k_arr.expand(logits.shape[:-1])
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = torch.clamp(k_arr - 1, 0, vocab - 1)[..., None]
    threshold = torch.gather(sorted_desc, -1, idx)
    filtered = torch.where(logits < threshold, NEG_INF, logits)
    return torch.where((k_arr <= 0)[..., None], logits, filtered)


def top_p_mask(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus filtering: mask tokens outside the smallest set with
    cumulative probability >= p.  The top token always survives."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cumprobs = torch.cumsum(probs, dim=-1)
    p_arr = torch.as_tensor(p, dtype=logits.dtype, device=logits.device)
    keep = (cumprobs - probs) < p_arr[..., None]
    keep[..., 0] = True
    threshold = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, NEG_INF, logits)


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits): Gumbel-argmax."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample_tokens(logits, generator, temperature, top_p, top_k, repetition_penalty,
                  presence) -> torch.Tensor:
    """logits [B, V] float32 (or a [B, S, V] window: position 0); per-row
    params [B]; presence [B, V] bool.  Returns [B] int32: the exact argmax
    where temperature <= 0, else a draw from the top-k- and
    top-p-filtered distribution."""
    logits = _segment_logits(logits)
    logits = apply_repetition_penalty(logits, presence, repetition_penalty[:, None])
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    filtered = top_p_mask(top_k_mask(scaled, top_k), top_p)
    sampled = _categorical(filtered, generator)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def sample_tokens_capped(logits, generator, temperature, top_p, top_k,
                         repetition_penalty, presence, cap: int = 128,
                         seg_pos=None) -> torch.Tensor:
    """Decode-loop sampler: ``sample_tokens`` semantics with top-k/top-p
    applied within the ``cap`` highest logits, taken by an exact
    ``torch.topk`` (the JAX package's SAMPLING_EXACT_TOPK=1 path).
    ``logits`` [B, V], or a [B, S, V] window read at ``seg_pos`` ([B]
    window position per row; None: position 0)."""
    logits = _segment_logits(logits, seg_pos)
    logits = apply_repetition_penalty(logits, presence, repetition_penalty[:, None])
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    cap = min(cap, logits.shape[-1])
    vals, idx = torch.topk(scaled, cap, dim=-1, largest=True, sorted=True)
    ranks = torch.arange(cap, device=logits.device)[None, :]
    k_arr = top_k.to(torch.int64)[:, None]
    vals = torch.where((k_arr > 0) & (ranks >= k_arr), NEG_INF, vals)
    probs = torch.softmax(vals, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    keep[:, 0] = True
    vals = torch.where(keep, vals, NEG_INF)
    choice = _categorical(vals, generator)
    sampled = torch.gather(idx, -1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def sample_tokens_nofilter(logits, generator, temperature, repetition_penalty,
                           presence, seg_pos=None) -> torch.Tensor:
    """Fast path for rows with top_p >= 1 and top_k <= 0: one draw over the
    full vocab, no candidate sort.  ``logits`` as ``sample_tokens_capped``
    takes them."""
    logits = _segment_logits(logits, seg_pos)
    logits = apply_repetition_penalty(logits, presence, repetition_penalty[:, None])
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sampled = _categorical(scaled, generator)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
