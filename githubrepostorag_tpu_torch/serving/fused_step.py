"""One dispatch per engine step: packed prefill and a mixed spec / plain
decode burst together; port of ``githubrepostorag_tpu/serving/fused_step.py``.

The unfused step loop runs, at worst, a packed prefill dispatch and then
EITHER a spec burst (only when every running row is plain greedy: one
sampled row demotes the batch) OR a plain decode burst.  ``fused_step_burst``
is one host call that

  - phase A: runs the packed prefill wave (``forward_paged_packed``: kernel
    C over full-precision pools, kernel A over int8 / int4 ones) when the
    step admitted prompt work (``has_prefill``);
  - phase B: runs ``n_iters`` MIXED decode iterations.  Every row gets a
    (k+1)-wide window through ONE ``forward_paged`` (kernel A over fp, int8
    and int4 pages alike): greedy rows use it as an n-gram verify window
    (draft / verify / accept as serving/spec_burst.py, the same tokens),
    sampled rows use position 0 and draw one token on the device from the
    window's logits (ops/sampling's ``_segment_logits``).

No host sync happens inside: the JAX ``lax.scan`` is a Python loop over
device tensors, and the host reads the [B, n_iters, k+1] token block and
the prefill logits after the call.  Stop and max_tokens bookkeeping and
prefill first-token sampling stay host-side, as with ``spec_decode_burst``;
rows that finish prefill in phase A join the NEXT step's phase B.

The presence pool (engine rows, one drop column at index V) takes a True
at each committed (row, token) only: JAX's ``.max`` update writes False
for padding onto token 0 beside committed Trues, and a torch index write
with duplicate indices leaves the winner unspecified, so padding cells
write the drop column instead.  The sampled tokens come from the engine's
``torch.Generator``; they differ from the JAX package's keys, so only
greedy rows match it token for token (sampled rows: the same support).
"""

from __future__ import annotations

import torch

from githubrepostorag_tpu_torch.models.qwen2 import (
    Qwen2Config,
    forward_paged,
    forward_paged_packed,
)
from githubrepostorag_tpu_torch.ops.sampling import sample_tokens_capped, sample_tokens_nofilter
from githubrepostorag_tpu_torch.serving.spec_burst import (
    append_history,
    ngram_draft_device,
    verify_window,
)


def fused_step_burst(
    params: dict,
    cfg: Qwen2Config,
    history: torch.Tensor,  # [B, H] int32: prompt + committed output
    hist_lens: torch.Tensor,  # [B] int32
    lens: torch.Tensor,  # [B] int32 cached tokens per decode row
    k_pages: torch.Tensor,  # updated in place
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32 (decode rows)
    row_limits: torch.Tensor,  # [B] int32 max cacheable tokens
    active: torch.Tensor,  # [B] bool
    spec_ok: torch.Tensor,  # [B] bool: greedy rows (temperature <= 0,
    # repetition_penalty == 1) verify windows; the others sample 1 token
    row_idx: torch.Tensor,  # [B] int32 engine row of each compacted row
    presence: torch.Tensor,  # [max_num_seqs, V + 1] bool, updated in place
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int32
    repetition_penalty: torch.Tensor,  # [B]
    # phase-A packed prefill operands (all None when has_prefill is False)
    pf_ids: torch.Tensor | None = None,  # [1, T]
    pf_pos: torch.Tensor | None = None,  # [1, T]
    pf_slots: torch.Tensor | None = None,  # [T]
    pf_block_tables: torch.Tensor | None = None,  # [R, max_pages]
    pf_cached: torch.Tensor | None = None,  # [R]
    pf_new: torch.Tensor | None = None,  # [R]
    pf_seg: torch.Tensor | None = None,  # [T]
    pf_logits_at: torch.Tensor | None = None,  # [R]
    *,
    n_iters: int,
    k: int,
    tq: int = 0,
    filter_sampling: bool = True,
    has_prefill: bool = False,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
):
    """Returns (tokens [B, n_iters, k+1] int32 -1-padded, proposed
    [B, n_iters], pf_logits [R, 1, V] | None, k_pages, v_pages, presence
    [, k_scales, v_scales])."""
    b, h = history.shape
    width = k + 1
    dev = history.device
    vocab = cfg.vocab_size
    page_size = k_pages.shape[3]
    quant = k_scales is not None
    pf_logits = None
    if has_prefill:
        pf_logits = forward_paged_packed(
            params, cfg, pf_ids, pf_pos, k_pages, v_pages, pf_slots, pf_block_tables,
            pf_cached, pf_new, pf_seg, pf_logits_at, tq,
            k_scales=k_scales, v_scales=v_scales)[0]

    rows = torch.arange(b, device=dev)
    ar_k = torch.arange(k, device=dev)[None, :]
    ar_w = torch.arange(width, device=dev)[None, :]
    eng_rows = row_idx.long()
    # the presence write's value as a device tensor: a Python True would be
    # copied from host memory, a sync in every iteration
    true = torch.ones((), dtype=torch.bool, device=dev)
    hist = torch.cat([history.to(torch.int32),
                      torch.zeros((b, 1), dtype=torch.int32, device=dev)], dim=1)
    hist_lens = hist_lens.to(torch.int32)
    lens = lens.to(torch.int32)
    row_limits = row_limits.to(torch.int32)
    toks_out, prop_out = [], []
    for _ in range(n_iters):
        act = active & (lens + 1 <= row_limits)
        draft, dlen = ngram_draft_device(hist[:, :h], hist_lens, k)
        # sampled rows take a 1-token window; greedy rows leave room for the
        # correction token inside their page budget
        dlen = torch.where(spec_ok, dlen, 0)
        dlen = torch.minimum(dlen, torch.clamp(row_limits - lens - 1, min=0)).to(torch.int32)
        last = hist[rows, torch.clamp(hist_lens.long() - 1, min=0)]
        ids = torch.cat([last[:, None], draft], dim=1)  # [B, width]
        n_new = torch.where(act, 1 + dlen, 0).to(torch.int32)
        pos, slots = verify_window(lens, n_new, block_tables, page_size, width)
        logits = forward_paged(params, cfg, ids, pos, k_pages, v_pages, slots, block_tables,
                               lens, n_new, k_scales=k_scales, v_scales=v_scales)[0]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, width]

        # sampled rows draw from their window's position-0 logits
        pres_rows = presence[eng_rows, :vocab]
        if filter_sampling:
            tok_s = sample_tokens_capped(logits, generator, temperature, top_p, top_k,
                                         repetition_penalty, pres_rows)
        else:
            tok_s = sample_tokens_nofilter(logits, generator, temperature,
                                           repetition_penalty, pres_rows)
        final0 = torch.where(spec_ok, greedy[:, 0], tok_s)

        # greedy rows: the longest agreed prefix + correction (spec_burst's
        # rule, so their tokens are the spec path's); sampled rows: exactly
        # their one drawn token
        agree = (greedy[:, :k] == draft) & (ar_k < dlen[:, None])
        a = torch.cumprod(agree.to(torch.int32), dim=1).sum(dim=1)
        n_commit = torch.where(act, torch.where(spec_ok, a + 1, 1), 0).to(torch.int32)
        committed = ar_w < n_commit[:, None]
        toks_full = torch.cat([final0[:, None], greedy[:, 1:]], dim=1)
        toks_out.append(torch.where(committed, toks_full, -1))
        prop_out.append(torch.where(act & spec_ok, dlen, 0))

        # presence rides the engine-row index through the compaction: a
        # True at each committed token, the drop column for the rest
        marks = torch.where(committed, toks_full, vocab).long()
        presence.index_put_((eng_rows[:, None].expand(b, width), marks), true)
        append_history(hist, hist_lens, toks_full, committed, h)
        hist_lens = hist_lens + n_commit
        lens = lens + n_commit
    toks = torch.stack(toks_out, dim=1).to(torch.int32)
    proposed = torch.stack(prop_out, dim=1).to(torch.int32)
    if quant:
        return toks, proposed, pf_logits, k_pages, v_pages, presence, k_scales, v_scales
    return toks, proposed, pf_logits, k_pages, v_pages, presence
