"""Paged KV cache: device page pools + host page allocators; port of
``githubrepostorag_tpu/serving/kv_cache.py`` (full-precision, int8 and
nibble-packed int4 pools).

K/V live in fixed page pools ``[L, n_kv, P + 1, page_size, hd]``; a
sequence's pages are an indirection table (its block table).  Writes are
flat scatters in which padding slots (-1) land on the pools' last page, the
drop page, which no block table references.  Quantized pools carry one f32
scale per (layer, kv head, page), fixed by the page's first write.
Allocation is host-side Python: control flow, not compute.
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
    pool is a contiguous view the kernels read directly.

    ``ks``/``vs``: per-page dequant scales [L, n_kv, P + 1] f32 for int8
    pools (int8 ``k``/``v``) and int4 pools (uint8 ``k``/``v`` of
    [..., hd // 2] nibble planes, ``pack_int4``); None for full precision.
    The last entry is the drop page's."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None = None
    vs: torch.Tensor | None = None


def quant_bits(quant) -> int:
    """Normalize the ``kv_quant`` option to a bit width: 0 (off), 8 (int8
    pages) or 4 (nibble-packed int4 pages).  Accepts a bool, the int, or
    the env-style string."""
    if quant is None or quant is False:
        return 0
    if quant is True:
        return 8
    if isinstance(quant, int) and quant in (0, 4, 8):
        return quant
    val = str(quant).strip().lower()
    if val in {"", "0", "false", "off"}:
        return 0
    if val in {"1", "true", "on", "int8", "8"}:
        return 8
    if val in {"int4", "4"}:
        return 4
    raise ValueError(f"kv_quant={quant!r} not understood; use int4, int8, or a bool")


def make_page_pools(cfg, num_pages: int, page_size: int, dtype=torch.bfloat16,
                    device=None, quant=0) -> PagePools:
    """Zeroed pools on ``device``: ``num_pages`` pages for the allocator
    plus the drop page.  ``quant`` 0 gives bf16 or f32 pools of ``dtype``;
    8 gives int8 pools, 4 uint8 nibble planes of half the head width, both
    with zeroed per-page scales."""
    dev = resolve_device(device)
    bits = quant_bits(quant)
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages + 1, page_size, cfg.head_dim)
    if bits:
        if bits == 4 and cfg.head_dim % 2:
            raise ValueError("int4 KV pages need an even head_dim")
        pool_shape = shape if bits == 8 else (*shape[:-1], cfg.head_dim // 2)
        pool_dtype = torch.int8 if bits == 8 else torch.uint8
        return PagePools(
            k=torch.zeros(pool_shape, dtype=pool_dtype, device=dev),
            v=torch.zeros(pool_shape, dtype=pool_dtype, device=dev),
            ks=torch.zeros(shape[:-2], dtype=torch.float32, device=dev),
            vs=torch.zeros(shape[:-2], dtype=torch.float32, device=dev),
        )
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"pool dtype {dtype} not supported; use bf16 or f32, or quant=8 / 4")
    return PagePools(k=torch.zeros(shape, dtype=dtype, device=dev),
                     v=torch.zeros(shape, dtype=dtype, device=dev))


# headroom on a page's first-write scale: later tokens appended to the same
# page reuse it, so the first chunk's amax gets margin before clipping
KV_SCALE_HEADROOM = 1.25


def quantize_kv_paged(vals: torch.Tensor, flat_slots: torch.Tensor, scales: torch.Tensor,
                      page_size: int, qmax: int = 127):
    """Per-page symmetric quantization for pool writes.

    vals [..., N, hd] new K or V vectors; flat_slots [N] pool slots;
    scales [..., P + 1] f32 per-page scales (0 = never written), the last
    entry being the drop page's.  A page's scale is fixed by the FIRST
    write that touches it -- the batch holding the page's slot 0 -- from
    that write's amax with ``KV_SCALE_HEADROOM``; later appends reuse the
    stored scale and clip at +-qmax (127 for int8 pages, 7 for int4).
    Slots outside [0, P * page_size) -- the -1 padding slots -- belong to
    the drop page: their amax sets only the drop page's scale.

    Returns (q int8 [..., N, hd], new scales [..., P + 1])."""
    p_ext = scales.shape[-1]
    drop = p_ext - 1
    lead = scales.shape[:-1]
    slots = flat_slots.long()
    valid = (slots >= 0) & (slots < drop * page_size)
    page_of = torch.where(valid, torch.div(slots, page_size, rounding_mode="floor"), drop)
    xf = vals.float()
    amax = xf.abs().amax(dim=-1)  # [..., N]
    idx = page_of.expand(*lead, page_of.shape[0])
    page_amax = torch.zeros_like(scales).scatter_reduce_(-1, idx, amax, "amax")
    fresh = torch.zeros(p_ext, dtype=torch.bool, device=scales.device)
    fresh[torch.where(valid & (slots % page_size == 0), page_of, drop)] = True
    scale_new = torch.clamp(page_amax * (KV_SCALE_HEADROOM / qmax), min=1e-8)
    upd = torch.where(fresh, scale_new, scales)
    tok_scale = torch.gather(upd, -1, idx)  # [..., N]
    q = torch.clamp(torch.round(xf / tok_scale[..., None]), -qmax, qmax).to(torch.int8)
    return q, upd


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int4 values [..., hd] -> uint8 bytes [..., hd // 2].

    Plane packing: byte c of a token holds component c (low nibble) and
    component c + hd // 2 (high nibble) of the same token, two's-complement
    nibbles."""
    half = q.shape[-1] // 2
    qi = q.to(torch.int32)
    return ((qi[..., :half] & 0xF) | ((qi[..., half:] & 0xF) << 4)).to(torch.uint8)


def unpack_int4(b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: uint8 [..., hd // 2] -> int8 values [..., hd],
    each nibble sign-extended as ``((x & 0xF) ^ 8) - 8``."""
    bi = b.to(torch.int32)
    lo = ((bi & 0xF) ^ 8) - 8
    hi = ((bi >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def commit_paged(pools: torch.Tensor, vals: torch.Tensor, flat_slots: torch.Tensor,
                 page_size: int, scales: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter new K or V vectors into flat pool slots, IN PLACE: the one
    pool-commit rule shared by prefill (models/qwen2.forward_paged and
    forward_paged_packed) and the decode burst (serving/decode_burst).

    pools [..., P + 1, page_size, hd_stored], the last page being the drop
    page; vals [..., N, hd] (leading dims match); flat_slots [N] int.  Slots
    outside [0, P*page_size) -- the -1 padding slots -- are written to the
    drop page instead (a torch index write would wrap -1 onto the last real
    slot), so the commit is one ``index_copy_`` with no host sync.
    ``scales`` None: full-precision pools, vals cast to their dtype.  Else
    ``scales`` [..., P + 1] are the pools' per-page scales, updated in
    place by ``quantize_kv_paged``: int8 pools store the codes, uint8 pools
    their ``pack_int4`` nibble planes.  Returns ``pools``."""
    p, ps, hd = pools.shape[-3:]
    if ps != page_size:
        raise ValueError(f"page_size {page_size} does not match the pool's {ps}")
    if scales is None:
        vals = vals.to(pools.dtype)
    else:
        q, new_scales = quantize_kv_paged(vals, flat_slots, scales, page_size,
                                          qmax=7 if pools.dtype == torch.uint8 else 127)
        scales.copy_(new_scales)
        vals = pack_int4(q) if pools.dtype == torch.uint8 else q
    flat = pools.view(-1, p * ps, hd)
    vals = vals.reshape(-1, vals.shape[-2], hd)
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


def packed_slot_mapping(block_table_row: np.ndarray, start_pos: int, num_tokens: int,
                        page_size: int, out: np.ndarray, offset: int) -> None:
    """Write one segment's flat pool slots for tokens [start_pos, start_pos +
    num_tokens) into ``out[offset : offset + num_tokens]``: the packed-prefill
    variant of ``slot_mapping``, filling a shared [budget] buffer (set to -1
    beforehand, so unfilled positions stay padding)."""
    positions = np.arange(start_pos, start_pos + num_tokens)
    out[offset: offset + num_tokens] = (
        block_table_row[positions // page_size] * page_size + positions % page_size)
