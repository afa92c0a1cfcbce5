"""N-gram speculative decoding ("prompt lookup decoding"); port of
``githubrepostorag_tpu/serving/spec_decode.py``.

RAG answers quote their context: file paths, identifiers and code spans
from retrieved chunks reappear verbatim in the output.  When the last few
generated tokens match an n-gram seen earlier in the row's prompt+output,
the tokens that followed that earlier occurrence are a free draft.  The
engine then runs ONE paged forward over [last_token, draft...] (k+1
positions, kernel A's window on the card) and accepts the longest prefix
the model agrees with, committing up to k+1 tokens per dispatch.

Every speculative step is a synchronous dispatch and read, so this mode
forgoes the pipelined decode bursts (serving/decode_burst.py): it wins
when acceptance is high.  ``spec_ngram_k`` defaults to 0 (off).

Proposal search is host-side Python over small token lists; verification
is one device forward.
"""

from __future__ import annotations

SEARCH_WINDOW = 4096  # only scan this many recent tokens for matches


def ngram_propose(
    tokens: list[int],
    k: int,
    *,
    max_ngram: int = 4,
    min_ngram: int = 1,
) -> list[int]:
    """Draft up to ``k`` tokens: find the EARLIEST earlier occurrence of
    the longest suffix n-gram (length max_ngram down to min_ngram) and
    return the tokens that followed it.  Empty when nothing matches."""
    if k <= 0 or len(tokens) < min_ngram + 1:
        return []
    window = tokens[-SEARCH_WINDOW:]
    n_tok = len(window)
    # every candidate match, for every n-gram length, ends with the newest
    # token: index those end positions once.  e <= n_tok - 2 keeps at least
    # one follower after the match and excludes the suffix's own last token
    last = window[-1]
    ends = [e for e in range(n_tok - 1) if window[e] == last]
    if not ends:
        return []
    for n in range(min(max_ngram, n_tok - 1), min_ngram - 1, -1):
        # earliest occurrence wins: on repetitive text the most recent match
        # sits just before the suffix and truncates the draft.  For a fixed
        # n, ascending match ends are ascending match starts
        suffix = window[-n:]
        for e in ends:
            s = e - n + 1
            if s < 0:
                continue
            if window[s: e + 1] == suffix:
                return window[e + 1: e + 1 + k]
    return []
