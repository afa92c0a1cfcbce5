"""Paged KV cache: device page pools + host page allocators; port of the
full-precision half of ``githubrepostorag_tpu/serving/kv_cache.py``.

K/V live in fixed page pools ``[L, n_kv, P + 1, page_size, hd]``; a
sequence's pages are an indirection table (its block table).  Writes are
flat scatters in which padding slots (-1) land on the pools' last page, the
drop page, which no block table references.  Allocation is host-side
Python: control flow, not compute.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.serving.chain_hash import chain_hashes


@dataclass
class PagePools:
    """Every sequence's K/V pages for all layers, [L, n_kv, P + 1, page_size,
    hd]: pages 0..P-1 back block tables, page P is ``commit_paged``'s drop
    page.  Each page's (page_size, hd) slab is contiguous, and a layer's
    pool is a contiguous view the kernels read directly."""

    k: torch.Tensor
    v: torch.Tensor


def make_page_pools(cfg, num_pages: int, page_size: int, dtype=torch.bfloat16,
                    device=None) -> PagePools:
    """Zeroed bf16 or f32 pools on ``device``: ``num_pages`` pages for the
    allocator plus the drop page."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"pool dtype {dtype} not supported; use bf16 or f32 (quantized pools are not ported)")
    dev = resolve_device(device)
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages + 1, page_size, cfg.head_dim)
    return PagePools(k=torch.zeros(shape, dtype=dtype, device=dev),
                     v=torch.zeros(shape, dtype=dtype, device=dev))


def commit_paged(pools: torch.Tensor, vals: torch.Tensor, flat_slots: torch.Tensor,
                 page_size: int) -> torch.Tensor:
    """Scatter new K or V vectors into flat pool slots, IN PLACE: the one
    pool-commit rule shared by prefill (models/qwen2.forward_paged) and the
    decode burst (serving/decode_burst).

    pools [..., P + 1, page_size, hd], the last page being the drop page;
    vals [..., N, hd] (leading dims match); flat_slots [N] int.  Slots
    outside [0, P*page_size) -- the -1 padding slots -- are written to the
    drop page instead (a torch index write would wrap -1 onto the last real
    slot), so the commit is one ``index_copy_`` with no host sync.
    Returns ``pools``."""
    p, ps, hd = pools.shape[-3:]
    if ps != page_size:
        raise ValueError(f"page_size {page_size} does not match the pool's {ps}")
    flat = pools.view(-1, p * ps, hd)
    vals = vals.reshape(-1, vals.shape[-2], hd).to(pools.dtype)
    drop = (p - 1) * ps  # first slot of the drop page
    slots = torch.where((flat_slots >= 0) & (flat_slots < drop), flat_slots, drop).long()
    flat.index_copy_(1, slots, vals)
    return pools


class OutOfPages(RuntimeError):
    """The pool cannot back a new allocation; the scheduler queues instead."""


class PageAllocator:
    """Free-list allocator over the page pool."""

    def __init__(self, num_pages: int) -> None:
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self.num_pages = num_pages

    @property
    def free_count(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        self._free.extend(pages)

    def can_admit(self, hashes: list[bytes], need: int, extra_free: int = 0) -> bool:
        """Interface parity with PrefixCachingAllocator: no cache, so
        ``hashes`` never changes the answer."""
        return self.free_count + extra_free >= need

    def releasable_count(self, pages: list[int]) -> int:
        """Without refcounts every page frees on release."""
        return len(pages)


def page_hashes(prompt: list[int], page_size: int) -> list[bytes]:
    """Chain hash per FULL page of the prompt (serving/chain_hash.py)."""
    return chain_hashes(prompt, page_size)


class PrefixCachingAllocator:
    """Refcounting page allocator with an automatic prefix cache.

    ``register`` publishes a page under its prefix chain hash once prefill
    wrote the whole page; ``share`` hands an admission the longest run of
    cached pages matching its prompt's chain.  Pages released to refcount 0
    whose hash is registered park in an LRU instead of the free list, and
    ``allocate`` evicts from the LRU only when the free list runs dry, so
    "free" pool memory doubles as prefix cache.  ``free_count`` counts
    evictable cached pages as free."""

    def __init__(self, num_pages: int) -> None:
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self.num_pages = num_pages
        self._rc: dict[int, int] = {}
        self._hash_to_page: dict[bytes, int] = {}
        self._page_to_hash: dict[int, bytes] = {}
        self._lru: dict[int, None] = {}  # zero-ref cached pages, coldest first
        self.hit_tokens = 0  # stats: prompt tokens served from cache

    @property
    def free_count(self) -> int:
        return len(self._free) + len(self._lru)

    def allocate(self, n: int) -> list[int]:
        if n > self.free_count:
            raise OutOfPages(f"need {n} pages, {self.free_count} free")
        out: list[int] = []
        for _ in range(n):
            if self._free:
                page = self._free.pop()
            else:  # evict the coldest cached page
                page = next(iter(self._lru))
                del self._lru[page]
                del self._hash_to_page[self._page_to_hash.pop(page)]
            self._rc[page] = 1
            out.append(page)
        return out

    def release(self, pages: list[int]) -> None:
        # park tail-first: a chain is matchable only from its head, so the
        # head must be the last page eviction takes
        for page in reversed(pages):
            rc = self._rc.get(page, 0) - 1
            if rc > 0:
                self._rc[page] = rc
                continue
            self._rc.pop(page, None)
            if page in self._page_to_hash:
                self._lru[page] = None
            else:
                self._free.append(page)

    def releasable_count(self, pages: list[int]) -> int:
        """How many of ``pages`` would reach the allocatable set if released
        now (pages other requests still share would not)."""
        return sum(1 for p in pages if self._rc.get(p, 1) <= 1)

    def can_admit(self, hashes: list[bytes], need: int, extra_free: int = 0) -> bool:
        """Would ``share(hashes)`` + ``allocate(need - matched)`` succeed now
        (plus ``extra_free`` pages the caller could recycle first)?  Matched
        pages parked in the LRU do not count twice, and a page matches at
        most once per admission."""
        matched = parked = 0
        seen: set[int] = set()
        for h in hashes:
            page = self._hash_to_page.get(h)
            if page is None or page in seen:
                break
            seen.add(page)
            matched += 1
            if page in self._lru:
                parked += 1
        avail = len(self._free) + len(self._lru) - parked + extra_free
        return avail >= need - matched

    def share(self, hashes: list[bytes]) -> list[int]:
        """Claim the longest cached run matching ``hashes``: refcounts bump,
        parked pages leave the LRU.  Stops at the first hash that would
        re-claim a page already shared by this call."""
        out: list[int] = []
        seen: set[int] = set()
        for h in hashes:
            page = self._hash_to_page.get(h)
            if page is None or page in seen:
                break
            seen.add(page)
            self._lru.pop(page, None)
            self._rc[page] = self._rc.get(page, 0) + 1
            out.append(page)
        return out

    def register(self, h: bytes, page: int) -> None:
        """Publish a fully-written page under its chain hash.  First writer
        wins; a twin page stays private."""
        if h in self._hash_to_page or page in self._page_to_hash:
            return
        self._hash_to_page[h] = page
        self._page_to_hash[page] = h


def pages_needed(num_tokens: int, page_size: int) -> int:
    return -(-num_tokens // page_size)


def slot_mapping(block_table_row: np.ndarray, start_pos: int, num_tokens: int,
                 page_size: int, pad_to: int) -> np.ndarray:
    """Flat pool slots for tokens [start_pos, start_pos + num_tokens),
    padded with -1 (dropped by ``commit_paged``)."""
    positions = np.arange(start_pos, start_pos + num_tokens)
    slots = block_table_row[positions // page_size] * page_size + positions % page_size
    out = np.full((pad_to,), -1, dtype=np.int32)
    out[:num_tokens] = slots
    return out
