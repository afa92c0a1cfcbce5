"""Speculative decode bursts: draft and verify on the device; port of
``githubrepostorag_tpu/serving/spec_burst.py``.

The host-dispatched spec path (serving/spec_decode.py and the engine's
``_spec_decode_step``) pays one dispatch and one read per verify.
``spec_decode_burst`` issues ``n_iters`` draft -> verify -> accept
iterations with no host sync between them: the JAX ``lax.scan`` becomes a
Python loop over device tensors, and the host reads the [B, n_iters, k+1]
token block once, after the loop.

Per iteration, all [B]-vectorized:
  1. DRAFT on the device: bigram prompt lookup over a device-resident
     token history [B, H]: the positions j where history[j:j+2] equals
     the row's last two tokens, the EARLIEST one (the first maximum of
     the match mask, as ``ngram_propose`` picks), and the k tokens after
     it.
  2. VERIFY: one ``forward_paged`` over [last, draft...] (k+1 positions,
     causal over the row's pages; kernel A on the card).  Positions
     outside a row's window take slot -1, which ``commit_paged`` sends to
     the pools' drop page; rejected positions' K/V are overwritten by the
     next iteration.
  3. ACCEPT: commit the longest model-agreed draft prefix plus the model's
     correction token (cumprod of the agreement mask), append it to the
     history, advance the lengths.

The JAX history write ``history.at[...].set(..., mode="drop")`` has no
torch counterpart: an out-of-range index raises on the CPU and asserts on
the card.  The history here carries one spare column past ``H``, where
every write that JAX drops lands; nothing reads it.

Greedy only, like the host spec path: the engine runs this burst when
every running row is plain greedy (temperature 0, no penalty), so outputs
equal the plain burst path's.  Stop-token and max_tokens bookkeeping stay
host-side on the returned tokens, as with ``decode_burst``.
"""

from __future__ import annotations

import torch

from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, forward_paged


def ngram_draft_device(
    history: torch.Tensor,  # [B, H] int32 token history (prompt + output)
    hist_lens: torch.Tensor,  # [B] int32 valid tokens per row
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized bigram prompt lookup: returns (draft [B, k] int32,
    draft_len [B] int32).  A row drafts 0 tokens when its history has no
    earlier occurrence of its final bigram, or is shorter than 4 tokens (a
    match must end strictly before the suffix and have a follower)."""
    b, h = history.shape
    dev = history.device
    rows = torch.arange(b, device=dev)
    lens = hist_lens.long()
    last1 = history[rows, torch.clamp(lens - 1, min=0)]  # [B]
    last0 = history[rows, torch.clamp(lens - 2, min=0)]
    # match[j]: history[j] == last0 and history[j + 1] == last1, j < H - 1
    m = (history[:, :-1] == last0[:, None]) & (history[:, 1:] == last1[:, None])
    j = torch.arange(h - 1, device=dev)[None, :]
    # strictly before the suffix bigram, with >= 1 follower: j < len - 3
    m = m & (j < (lens - 3)[:, None]) & (lens[:, None] >= 4)
    has = m.any(dim=1)
    # the first maximum of the mask: its earliest True (torch.argmax takes
    # no bool, and returns the first index among equal maxima)
    p = torch.argmax(m.to(torch.uint8), dim=1)
    idx = p[:, None] + 2 + torch.arange(k, device=dev)[None, :]  # followers
    draft = torch.gather(history, 1, torch.clamp(idx, 0, h - 1))
    n_follow = lens - (p + 2)  # valid tokens after the match
    dlen = torch.where(has, torch.clamp(n_follow, max=k), 0)
    return draft.to(torch.int32), torch.clamp(dlen, min=0).to(torch.int32)


def verify_window(lens: torch.Tensor, n_new: torch.Tensor, block_tables: torch.Tensor,
                  page_size: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions [B, width] of a verify window based at ``lens`` and its
    flat pool slots, -1 past each row's ``n_new`` tokens (the drop page's
    writes in ``commit_paged``)."""
    dev = lens.device
    pos = lens.long()[:, None] + torch.arange(width, device=dev)[None, :]
    in_window = torch.arange(width, device=dev)[None, :] < n_new[:, None]
    page_idx = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"), 0,
                           block_tables.shape[1] - 1)
    slots = torch.gather(block_tables.long(), 1, page_idx) * page_size + pos % page_size
    return pos, torch.where(in_window, slots, -1)


def append_history(history: torch.Tensor, hist_lens: torch.Tensor, toks: torch.Tensor,
                   committed: torch.Tensor, h: int) -> None:
    """Write ``toks`` [B, width] at each row's end of ``history`` [B, h + 1]
    in place where ``committed``; everything else, and anything past
    column h - 1, lands in the spare column h."""
    b, width = toks.shape
    dev = toks.device
    hidx = hist_lens.long()[:, None] + torch.arange(width, device=dev)[None, :]
    hidx = torch.where(committed & (hidx < h), hidx, h)
    rows = torch.arange(b, device=dev)[:, None].expand(b, width)
    history[rows, hidx] = toks.to(history.dtype)


def spec_decode_burst(
    params: dict,
    cfg: Qwen2Config,
    history: torch.Tensor,  # [B, H] int32: prompt + committed output
    hist_lens: torch.Tensor,  # [B] int32
    lens: torch.Tensor,  # [B] int32 cached tokens (hist_lens - 1 for running
    # rows: the newest committed token is not cached yet)
    k_pages: torch.Tensor,  # [L, n_kv, P + 1, ps, hd], updated in place
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    row_limits: torch.Tensor,  # [B] int32 max cacheable tokens
    active: torch.Tensor,  # [B] bool
    *,
    n_iters: int,
    k: int,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
):
    """Run ``n_iters`` draft/verify/accept iterations with no host sync.

    Returns (tokens [B, n_iters, k+1] int32 with -1 padding -- committed
    tokens in order, the ``decode_burst`` packing per iteration --,
    proposed [B, n_iters] draft lengths, k_pages, v_pages[, k_scales,
    v_scales]).  Tokens equal plain greedy decoding's."""
    b, h = history.shape
    width = k + 1
    dev = history.device
    page_size = k_pages.shape[3]
    quant = k_scales is not None
    rows = torch.arange(b, device=dev)
    ar_k = torch.arange(k, device=dev)[None, :]
    ar_w = torch.arange(width, device=dev)[None, :]
    hist = torch.cat([history.to(torch.int32),
                      torch.zeros((b, 1), dtype=torch.int32, device=dev)], dim=1)
    hist_lens = hist_lens.to(torch.int32)
    lens = lens.to(torch.int32)
    row_limits = row_limits.to(torch.int32)
    toks_out, prop_out = [], []
    for _ in range(n_iters):
        act = active & (lens + 1 <= row_limits)
        draft, dlen = ngram_draft_device(hist[:, :h], hist_lens, k)
        # leave room for the correction token inside the row's page budget
        dlen = torch.minimum(dlen, torch.clamp(row_limits - lens - 1, min=0))
        last = hist[rows, torch.clamp(hist_lens.long() - 1, min=0)]
        ids = torch.cat([last[:, None], draft], dim=1)  # [B, width]
        n_new = torch.where(act, 1 + dlen, 0).to(torch.int32)
        pos, slots = verify_window(lens, n_new, block_tables, page_size, width)
        out = forward_paged(params, cfg, ids, pos, k_pages, v_pages, slots, block_tables,
                            lens, n_new, k_scales=k_scales, v_scales=v_scales)
        logits = out[0]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, width]
        # a = leading draft positions the model reproduces; commit
        # greedy[:, :a + 1] (the agreed tokens and the correction at a)
        agree = (greedy[:, :k] == draft) & (ar_k < dlen[:, None])
        a = torch.cumprod(agree.to(torch.int32), dim=1).sum(dim=1)
        n_commit = torch.where(act, a + 1, 0).to(torch.int32)
        committed = ar_w < n_commit[:, None]
        toks_out.append(torch.where(committed, greedy, -1))
        prop_out.append(torch.where(act, dlen, 0))
        append_history(hist, hist_lens, greedy, committed, h)
        hist_lens = hist_lens + n_commit
        lens = lens + n_commit
    toks = torch.stack(toks_out, dim=1).to(torch.int32)
    proposed = torch.stack(prop_out, dim=1).to(torch.int32)
    if quant:
        return toks, proposed, k_pages, v_pages, k_scales, v_scales
    return toks, proposed, k_pages, v_pages
