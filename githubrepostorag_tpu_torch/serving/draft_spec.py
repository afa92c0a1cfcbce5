"""Draft-model speculative decode bursts: a second, small model proposes,
the target verifies, all on the device; port of
``githubrepostorag_tpu/serving/draft_spec.py``.

The draft holds its OWN page pools, indexed by the SAME block tables as the
target's, so the two caches stay position-aligned by construction and a
prefix-cache page carries valid KV for both models (the engine runs every
prefill chunk through both).  The pools are never quantized: a draft /
target disagreement is then always a real model disagreement.

Per iteration, all [B]-vectorized:
  1. DRAFT: ``k + 1`` single-token forwards of the draft model; step j
     feeds the newest token at position lens + j over the draft's pools and
     takes its argmax.  Steps 0..k-1 give the k draft tokens; step k is
     write-only: it commits the would-be correction position's draft KV, so
     a fully accepted round leaves the draft cache covering every
     committed token.  A step's slot is -1 past a row's ``row_limits`` (or
     for an inactive row), which ``commit_paged`` sends to the draft
     pools' own drop page, never to a real page.
  2. VERIFY: one target ``forward_paged`` over [last, draft...] (k+1
     positions read the target weights once; kernel A on the card).
  3. ACCEPT: the longest model-agreed draft prefix plus the target's
     correction token (cumprod of the agreement mask), appended to the
     history; greedy-token-identical to plain decoding by construction.

The JAX ``lax.scan`` over iterations and over draft steps becomes Python
loops over device tensors with no host sync: each draft step's argmax
feeds the next step as a device tensor, and the host reads the
[B, n_iters, k+1] token block once, after the loops (the engine's
``_draft_spec_step``).  History writes JAX drops land in a spare column,
as in serving/spec_burst.py.

Greedy only; the engine's controller picks ``k`` per dispatch from a
power-of-two ladder and falls back to plain ``decode_burst`` when
acceptance collapses or a deadline is near (serving/engine.py).
"""

from __future__ import annotations

import torch

from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, forward_paged
from githubrepostorag_tpu_torch.serving.spec_burst import append_history, verify_window


def draft_spec_burst(
    params: dict,
    draft_params: dict,
    cfg: Qwen2Config,
    draft_cfg: Qwen2Config,
    history: torch.Tensor,  # [B, H] int32: prompt + committed output
    hist_lens: torch.Tensor,  # [B] int32
    lens: torch.Tensor,  # [B] int32 cached tokens (hist_lens - 1 for running
    # rows: the newest committed token is not cached yet, in either pool)
    k_pages: torch.Tensor,  # target [L, n_kv, P + 1, ps, hd], updated in place
    v_pages: torch.Tensor,
    dk_pages: torch.Tensor,  # draft [dL, dn_kv, P + 1, ps, dhd], updated in place
    dv_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32, shared by both pools
    row_limits: torch.Tensor,  # [B] int32 max cacheable tokens
    active: torch.Tensor,  # [B] bool
    *,
    n_iters: int,
    k: int,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
):
    """Run ``n_iters`` draft / verify / accept iterations with no host sync.

    Returns (tokens [B, n_iters, k+1] int32 with -1 padding -- committed
    tokens in order, the ``decode_burst`` packing per iteration --,
    proposed [B, n_iters] draft lengths, k_pages, v_pages, dk_pages,
    dv_pages[, k_scales, v_scales]).  Tokens equal plain greedy decoding's
    whatever the draft proposes."""
    b, h = history.shape
    width = k + 1
    dev = history.device
    page_size = k_pages.shape[3]
    max_pages = block_tables.shape[1]
    quant = k_scales is not None
    rows = torch.arange(b, device=dev)
    ar_k = torch.arange(k, device=dev)[None, :]
    ar_w = torch.arange(width, device=dev)[None, :]
    ones = torch.ones((b,), dtype=torch.int32, device=dev)
    bt_long = block_tables.long()
    hist = torch.cat([history.to(torch.int32),
                      torch.zeros((b, 1), dtype=torch.int32, device=dev)], dim=1)
    hist_lens = hist_lens.to(torch.int32)
    lens = lens.to(torch.int32)
    row_limits = row_limits.to(torch.int32)
    toks_out, prop_out = [], []
    for _ in range(n_iters):
        act = active & (lens + 1 <= row_limits)
        last = hist[rows, torch.clamp(hist_lens.long() - 1, min=0)]  # [B]

        # 1. draft: k + 1 single-token forwards over the draft's pools
        tok = last
        drafted = []
        for j in range(k + 1):
            p = lens + j  # [B] position of the token this step feeds
            page_idx = torch.clamp(torch.div(p, page_size, rounding_mode="floor"), 0,
                                   max_pages - 1).long()
            slot = bt_long[rows, page_idx] * page_size + (p % page_size).long()
            # never write past a row's pages: -1 goes to the drop page (the
            # write-only step k lands inside the limit exactly when a full
            # accept could need it)
            slot = torch.where(act & (p < row_limits), slot, -1)
            dlogits = forward_paged(draft_params, draft_cfg, tok[:, None], p[:, None],
                                    dk_pages, dv_pages, slot[:, None], block_tables, p,
                                    ones)[0]
            tok = torch.argmax(dlogits[:, 0], dim=-1).to(torch.int32)
            drafted.append(tok)
        draft = torch.stack(drafted[:k], dim=1)  # step k's token: write-only

        # 2. verify, leaving room for the correction token in the row's budget
        dlen = torch.clamp(row_limits - lens - 1, min=0, max=k)
        dlen = torch.where(act, dlen, 0).to(torch.int32)
        ids = torch.cat([last[:, None], draft], dim=1)  # [B, width]
        n_new = torch.where(act, 1 + dlen, 0).to(torch.int32)
        pos, slots = verify_window(lens, n_new, block_tables, page_size, width)
        logits = forward_paged(params, cfg, ids, pos, k_pages, v_pages, slots, block_tables,
                               lens, n_new, k_scales=k_scales, v_scales=v_scales)[0]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, width]

        # 3. accept: a = leading draft positions the target reproduces;
        # commit greedy[:, :a + 1] (the agreed tokens and the correction)
        agree = (greedy[:, :k] == draft) & (ar_k < dlen[:, None])
        a = torch.cumprod(agree.to(torch.int32), dim=1).sum(dim=1)
        n_commit = torch.where(act, a + 1, 0).to(torch.int32)
        committed = ar_w < n_commit[:, None]
        toks_out.append(torch.where(committed, greedy, -1))
        prop_out.append(dlen)
        append_history(hist, hist_lens, greedy, committed, h)
        hist_lens = hist_lens + n_commit
        lens = lens + n_commit
    toks = torch.stack(toks_out, dim=1).to(torch.int32)
    proposed = torch.stack(prop_out, dim=1).to(torch.int32)
    if quant:
        return toks, proposed, k_pages, v_pages, dk_pages, dv_pages, k_scales, v_scales
    return toks, proposed, k_pages, v_pages, dk_pages, dv_pages
