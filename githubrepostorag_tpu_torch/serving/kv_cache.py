"""Paged KV cache: device page pools + host page allocators; port of
``githubrepostorag_tpu/serving/kv_cache.py`` (full-precision, int8 and
nibble-packed int4 pools).

K/V live in fixed page pools ``[L, n_kv, P + 1, page_size, hd]``; a
sequence's pages are an indirection table (its block table).  Writes are
flat scatters in which padding slots (-1) land on the pools' last page, the
drop page, which no block table references.  Quantized pools carry one f32
scale per (layer, kv head, page), fixed by the page's first write.
Allocation is host-side Python: control flow, not compute.
``TieredPageAllocator`` keeps registered pages in a host-RAM tier behind the
prefix cache (writeback, fault-in, claims, preempt parking).
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
                    device=None, quant=0, mesh=None) -> PagePools:
    """Zeroed pools on ``device``: ``num_pages`` pages for the allocator
    plus the drop page.  ``quant`` 0 gives bf16 or f32 pools of ``dtype``;
    8 gives int8 pools, 4 uint8 nibble planes of half the head width, both
    with zeroed per-page scales.  On a ``mesh`` whose tp splits the KV heads
    the pools, and their scales, hold this rank's ``n_kv / tp`` heads (the
    JAX engine's pools sharded over their kv-head axis)."""
    dev = resolve_device(device)
    bits = quant_bits(quant)
    n_kv = cfg.num_kv_heads
    tp = mesh.shape["tp"] if mesh is not None else 1
    if tp > 1:
        if n_kv % tp:
            raise ValueError(f"tp={tp} does not divide num_kv_heads={n_kv}")
        n_kv //= tp
    shape = (cfg.num_layers, n_kv, num_pages + 1, page_size, cfg.head_dim)
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
    """The pool cannot back a new allocation; the scheduler queues (or
    preempts) instead."""


class _ObserverSeam:
    """Advisory hooks for a page observatory (the JAX package's obs/hbm.py).

    A *claim* is one block-table listing backed by the pool: one refcount
    where refcounts exist, one allocated page where they don't.  The
    allocator reports claim deltas where it mutates, and tier events.
    Hooks are advisory: a raising observer never breaks serving, so every
    call is fenced.  With no observer attached the cost is one attribute
    check per mutation."""

    _obs = None  # class default: no observer

    def attach_observer(self, obs) -> None:
        """Register an object with ``on_claims(delta)`` and
        ``on_tier_event(kind, n)``."""
        self._obs = obs

    def _note_claims(self, delta: int) -> None:
        if self._obs is not None and delta:
            try:
                self._obs.on_claims(delta)
            except Exception:  # noqa: BLE001 - advisory seam
                pass

    def _note_tier_event(self, kind: str, n: int = 1) -> None:
        if self._obs is not None and n:
            try:
                self._obs.on_tier_event(kind, n)
            except Exception:  # noqa: BLE001 - advisory seam
                pass


class PageAllocator(_ObserverSeam):
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
        out = [self._free.pop() for _ in range(n)]
        self._note_claims(n)
        return out

    def release(self, pages: list[int]) -> None:
        self._free.extend(pages)
        self._note_claims(-len(pages))

    def can_admit(self, hashes: list[bytes], need: int, extra_free: int = 0,
                  headroom: int = 0) -> bool:
        """Interface parity with PrefixCachingAllocator: no cache, so
        ``hashes`` never changes the answer.  ``headroom`` pages must stay
        allocatable after the admission (the per-class reservation that
        batch traffic pays and the protected class does not)."""
        return self.free_count + extra_free >= need + headroom

    def releasable_count(self, pages: list[int]) -> int:
        """Without refcounts every page frees on release."""
        return len(pages)


def page_hashes(prompt: list[int], page_size: int) -> list[bytes]:
    """Chain hash per FULL page of the prompt (serving/chain_hash.py)."""
    return chain_hashes(prompt, page_size)


class PrefixCachingAllocator(_ObserverSeam):
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
        self._note_claims(n)
        return out

    def release(self, pages: list[int]) -> None:
        self._note_claims(-len(pages))
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

    def can_admit(self, hashes: list[bytes], need: int, extra_free: int = 0,
                  headroom: int = 0) -> bool:
        """Would ``share(hashes)`` + ``allocate(need - matched)`` succeed now
        (plus ``extra_free`` pages the caller could recycle first) while
        leaving ``headroom`` pages allocatable?  Matched pages parked in the
        LRU do not count twice, and a page matches at most once per
        admission."""
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
        return avail >= need - matched + headroom

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
        self._note_claims(len(out))
        return out

    def register(self, h: bytes, page: int) -> None:
        """Publish a fully-written page under its chain hash.  First writer
        wins; a twin page stays private."""
        if h in self._hash_to_page or page in self._page_to_hash:
            return
        self._hash_to_page[h] = page
        self._page_to_hash[page] = h

    def resident_chain_hashes(self) -> frozenset[bytes]:
        """Chain hashes served from device pages now (the router's digest;
        the caller owns the engine, as for every allocator method)."""
        return frozenset(self._hash_to_page)

    def host_chain_hashes(self) -> frozenset[bytes]:
        """Chain hashes a fault-in could serve: none without a host tier."""
        return frozenset()


class TieredPageAllocator(PrefixCachingAllocator):
    """Prefix-caching allocator with a host-RAM swap tier behind the
    indirection table; port of the JAX package's ``TieredPageAllocator``.
    Page counts exclude the pools' drop page: the allocator never hands it
    out, so migration never moves it.

    Residency of a registered chain hash:

    * **device** — in ``_hash_to_page`` only (the base-class maps).
    * **host** — in ``_host`` only: the page content lives in host RAM as
      an opaque payload the engine gathered off-device.  ``share`` extends
      the cached run through host hits by allocating a device page and
      staging a fault-in scatter the engine dispatches before any program
      that could read the page.
    * **saved** (both) — device copy + host copy.  ``allocate`` reclaims
      saved parked pages FIRST: dropping their device copy costs nothing
      because the hash stays servable from host RAM.
    * **in-flight** — in ``_wb_inflight``: a writeback gather is dispatched
      but its DMA hasn't landed (``complete_writeback`` pending).  Counts
      as saved for reclaim — the gather snapshot was taken at dispatch and
      registered pages are immutable, so the payload is already correct.

    Page indices the allocator hands out are plain device pages — the
    block-table/indirection machinery upstream is untouched; tiering is
    purely an allocator + step-boundary-migration concern.  Only REGISTERED
    refcount-0 pages ever move tiers: refcounted pages are pinned on device
    (they never enter the LRU), so an active row's KV can't be swapped out
    from under it.

    ``_claims`` tracks chain hashes an admitted-but-unregistered prefill is
    about to publish, letting the engine hold an identical-prefix follower
    for one registration instead of duplicating the leader's whole
    footprint (cross-user dedup under oversubscription).
    """

    def __init__(
        self, num_pages: int, host_pool_pages: int = 0, migrate_burst: int = 8
    ) -> None:
        super().__init__(num_pages)
        # <= 0 means unbounded (the engine always passes a positive cap)
        self.host_pool_pages = host_pool_pages
        self.migrate_burst = max(1, migrate_burst)
        # hash -> opaque page payload, least-recently-used first
        self._host: dict[bytes, object] = {}
        self._wb_inflight: set[bytes] = set()
        # hash -> count of admitted prefills that will register it
        self._claims: dict[bytes, int] = {}
        # (device page, payload) scatters staged by share(); the engine
        # drains via fault_in() and dispatches before dependent programs
        self._staged_faults: list[tuple[int, object]] = []
        # preempt-park priority queue: chain hashes whose device copy is a
        # parked victim's ONLY copy.  evict() serves these before the
        # cold-first scan, and until their writeback dispatches the pages
        # are pinned (excluded from free_count / _pick_eviction)
        self._park_queue: dict[bytes, None] = {}
        # cumulative stats (async engine exports deltas)
        self.fault_ins = 0  # host->device re-admissions
        self.preempt_parked_pages = 0  # pages parked by preemption
        self.writebacks = 0  # device->host saves completed
        self.dedup_hits = 0  # share() hits on pages other requests hold
        self.host_evictions = 0  # host-LRU payloads dropped at capacity
        self.tier_drops = 0  # device evictions that cost nothing (saved)
        self.page_imports = 0  # disagg handoff pages admitted (import_page)
        self.import_dedup_skips = 0  # imports skipped: hash already servable

    @property
    def host_pages(self) -> int:
        return len(self._host)

    def host_chain_hashes(self) -> frozenset[bytes]:
        """Chain hashes a fault-in from the host tier could serve."""
        return frozenset(self._host)

    @property
    def plain_free_count(self) -> int:
        """Free pages available without evicting anything from the cache."""
        return len(self._free)

    @property
    def pending_park_writebacks(self) -> int:
        """Park-queue entries not yet drained by ``evict`` — the engine's
        preempt path loops migration until this hits zero so parked pages
        unpin within the step that parked them."""
        return len(self._park_queue)

    def _pinned_hashes(self) -> set[bytes]:
        """Park-queue hashes whose device page is still the only copy:
        LRU-resident, not yet saved or in flight.  Stale entries (re-shared
        pages, already-saved hashes) don't pin — evict() drops them."""
        out: set[bytes] = set()
        for h in self._park_queue:
            page = self._hash_to_page.get(h)
            if (page is not None and page in self._lru
                    and h not in self._host and h not in self._wb_inflight):
                out.add(h)
        return out

    @property
    def free_count(self) -> int:
        # pinned pages are NOT allocatable until their writeback dispatches
        # (one _migrate_pages step at most): reclaiming one would destroy a
        # preempted victim's only KV copy
        return len(self._free) + len(self._lru) - len(self._pinned_hashes())

    # ------------------------------------------------------------ device --

    def allocate(self, n: int) -> list[int]:
        if n > self.free_count:
            raise OutOfPages(f"need {n} pages, {self.free_count} free")
        out: list[int] = []
        for _ in range(n):
            if self._free:
                page = self._free.pop()
            else:
                page = self._pick_eviction()
                del self._lru[page]
                h = self._page_to_hash.pop(page)
                del self._hash_to_page[h]
                if h in self._host or h in self._wb_inflight:
                    self.tier_drops += 1
            self._rc[page] = 1
            out.append(page)
        self._note_claims(n)
        return out

    def _pick_eviction(self) -> int:
        # prefer the coldest SAVED parked page — its hash survives in host
        # RAM, so the device copy is free to drop; fall back to the coldest
        # overall (the hash is lost, exactly the base-class economics).
        # Preempt-pinned pages are skipped in both passes: free_count
        # excludes them, so a caller that passed the allocate() precheck is
        # guaranteed an unpinned candidate here.
        pinned = self._pinned_hashes()
        fallback = None
        for page in self._lru:
            h = self._page_to_hash[page]
            if h in pinned:
                continue
            if h in self._host or h in self._wb_inflight:
                return page
            if fallback is None:
                fallback = page
        if fallback is None:
            raise OutOfPages("every cached page is preempt-pinned")
        return fallback

    # -------------------------------------------------------- prefix API --

    def can_admit(self, hashes: list[bytes], need: int, extra_free: int = 0,
                  headroom: int = 0) -> bool:
        """Host-resident hash hits count as free-able capacity: a host hit
        still consumes a device page (the fault-in target, included in
        ``need``) but extends the shareable run instead of breaking it, and
        saved parked pages reclaim at zero cache cost.  Device-matched
        pages reduce the allocation need as in the base class (with the
        same one-match-per-page rule).  Preempt-pinned pages aren't
        allocatable — unless this admission's own run matches them, which
        is the resume fast path (sharing un-pins)."""
        pinned = self._pinned_hashes()
        matched = parked = 0
        seen: set[int] = set()
        for h in hashes:
            page = self._hash_to_page.get(h)
            if page is not None:
                if page in seen:
                    break
                seen.add(page)
                matched += 1
                if page in self._lru:
                    parked += 1
                pinned.discard(h)  # matched: counted once via ``parked``
                continue
            if h in self._host:
                continue  # fault-in target: needs a page, run continues
            break
        avail = (len(self._free) + len(self._lru) - parked - len(pinned)
                 + extra_free)
        return avail >= need - matched + headroom

    def share(self, hashes: list[bytes]) -> list[int]:
        """Claim the longest run servable from EITHER tier.  Device hits
        bump refcounts as in the base class; host hits allocate a fresh
        device page, stage its fault-in scatter, and re-register the hash
        immediately so concurrent claimants of the same prefix resolve to
        the one faulting page (paying a single migration)."""
        out: list[int] = []
        seen: set[int] = set()
        device_bumps = 0  # host hits claim via allocate(1) below — the
        # allocate seam counts those, so this seam counts ONLY direct
        # refcount bumps or the observatory would double-count claims
        for h in hashes:
            page = self._hash_to_page.get(h)
            if page is not None:
                if page in seen:
                    break
                seen.add(page)
                if self._rc.get(page, 0) > 0:
                    self.dedup_hits += 1
                if page in self._lru:
                    del self._lru[page]
                self._rc[page] = self._rc.get(page, 0) + 1
                device_bumps += 1
                out.append(page)
                continue
            payload = self._host.get(h)
            if payload is None:
                break
            try:
                [page] = self.allocate(1)
            except OutOfPages:
                break
            # refresh host-LRU recency; the payload stays (dual residency:
            # the device copy is droppable at zero cost from here on)
            del self._host[h]
            self._host[h] = payload
            self._hash_to_page[h] = page
            self._page_to_hash[page] = h
            self._staged_faults.append((page, payload))
            self.fault_ins += 1
            self._note_tier_event("fault_in")
            seen.add(page)
            out.append(page)
        self._note_claims(device_bumps)
        return out

    # --------------------------------------------------------- migration --

    def evict(self, max_n: int) -> list[tuple[int, bytes]]:
        """Plan one writeback burst: up to ``max_n`` of the coldest parked
        pages not yet saved to host (device→host is a residency transition,
        NOT a release — the pages stay device-resident and shareable until
        ``allocate`` reclaims them).  Marks each hash in-flight; the engine
        gathers the page contents and calls ``complete_writeback`` once the
        DMA lands.  Refcounted pages never appear (not in the LRU)."""
        out: list[tuple[int, bytes]] = []
        cap = self.host_pool_pages
        # preempt-parked hashes jump the queue: each is a victim's ONLY
        # copy and pins its device page until saved, so clearing them first
        # keeps the pin (which subtracts from free_count) one step long.
        # The host cap is not consulted — complete_writeback's LRU trim
        # makes room by dropping the coldest host payloads instead.
        drained: list[bytes] = []
        for h in self._park_queue:
            if len(out) >= max_n:
                break
            drained.append(h)  # served or stale either way
            page = self._hash_to_page.get(h)
            if (page is None or page not in self._lru
                    or h in self._host or h in self._wb_inflight):
                continue  # re-shared, reclaimed, or already saved
            self._wb_inflight.add(h)
            out.append((page, h))
        for h in drained:
            del self._park_queue[h]
        for page in self._lru:
            if len(out) >= max_n:
                break
            h = self._page_to_hash[page]
            if h in self._host or h in self._wb_inflight:
                continue
            if cap > 0 and len(self._host) + len(self._wb_inflight) >= cap:
                break
            self._wb_inflight.add(h)
            out.append((page, h))
        return out

    def park(self, pages: list[int]) -> int:
        """Preempt-park a victim's pages.

        Registered pages release into the LRU exactly like an ordinary
        ``release`` but jump the writeback queue: their hashes pin the
        device pages against reclaim until the payload is saved to host,
        so the very pool churn that triggered the preemption cannot
        destroy the victim's only KV copy before ``evict`` ships it.
        Unregistered pages (the partial tail) just free — their content
        has no chain hash to resume under and is recomputed at resume.
        Pages other requests still share stay device-resident and
        refcounted (nothing to save).  Returns how many pages remain
        resumable by ``share`` from either tier."""
        resumable = 0
        for page in pages:
            h = self._page_to_hash.get(page)
            if h is None:
                continue
            resumable += 1
            if self._rc.get(page, 0) <= 1 and not (
                    h in self._host or h in self._wb_inflight):
                self._park_queue[h] = None
        self.release(pages)  # claims seam fires inside release
        self.preempt_parked_pages += len(pages)
        self._note_tier_event("park", len(pages))
        return resumable

    def complete_writeback(self, h: bytes, payload: object) -> None:
        """Store a landed writeback payload under its chain hash.  Content
        addressing makes this unconditionally safe: even if the device page
        was reclaimed (or re-registered to a twin) meanwhile, the payload
        IS the content every holder of ``h`` expects."""
        self._wb_inflight.discard(h)
        self._host[h] = payload
        self.writebacks += 1
        self._note_tier_event("writeback")
        if self.host_pool_pages > 0:
            while len(self._host) > self.host_pool_pages:
                cold = next(iter(self._host))
                del self._host[cold]
                self.host_evictions += 1
                self._note_tier_event("host_evict")

    def fault_in(self) -> list[tuple[int, object]]:
        """Drain the staged host→device transitions for this step's scatter
        dispatch.  The caller MUST dispatch these before any program that
        could read the target pages (device program order then guarantees
        the faulted content is visible — no host sync needed)."""
        staged, self._staged_faults = self._staged_faults, []
        return staged

    # ------------------------------------------- disagg export / import --

    def host_payload(self, h: bytes) -> object | None:
        """Read a host-tier payload for the disagg export path WITHOUT
        refreshing LRU recency (an export is a read by a peer replica, not
        local reuse — it must not keep cold pages pinned here)."""
        return self._host.get(h)

    def device_page_of(self, h: bytes) -> int | None:
        """Device page currently registered under ``h``, if any (export
        falls back to a device gather when the host tier lacks the page)."""
        return self._hash_to_page.get(h)

    def import_page(self, h: bytes, payload: object) -> bool:
        """Admit a transferred page payload into the host tier (the disagg
        handoff import primitive).  Content addressing makes this
        unconditionally safe — the payload IS what every holder of ``h``
        expects — but a hash already servable from either tier is skipped
        so a redundant ship can't churn the host LRU.  Returns True when
        the payload was stored.  The imported page becomes claimable by
        the very next admission through the ordinary ``share`` fault-in
        machinery; nothing touches the device."""
        if h in self._hash_to_page or h in self._host:
            self.import_dedup_skips += 1
            return False
        self._host[h] = payload
        self.page_imports += 1
        self._note_tier_event("import")
        if self.host_pool_pages > 0:
            while len(self._host) > self.host_pool_pages:
                cold = next(iter(self._host))
                del self._host[cold]
                self.host_evictions += 1
                self._note_tier_event("host_evict")
        return True

    # ------------------------------------------------------ pending claims --

    def claim(self, hashes: list[bytes]) -> None:
        """Record that an admitted prefill will register ``hashes``."""
        for h in hashes:
            self._claims[h] = self._claims.get(h, 0) + 1

    def unclaim(self, hashes: list[bytes]) -> None:
        for h in hashes:
            n = self._claims.get(h, 0) - 1
            if n > 0:
                self._claims[h] = n
            else:
                self._claims.pop(h, None)

    def pending_claim_pages(self, hashes: list[bytes] | None = None) -> int:
        """How many pages of this prompt's shareable run are mid-prefill on
        another row right now (claimed, not yet registered).  >0 tells the
        scheduler a one-registration wait will dedup that many pages.

        With ``hashes=None``: total claimed-but-unregistered pages across
        all chains — the in-flight prefill work the fleet router folds into
        a replica's load snapshot (queue depth alone reads "idle" while a
        burst of admissions is still mid-prefill)."""
        if hashes is None:
            return sum(self._claims.values())
        n = 0
        for h in hashes:
            if self._hash_to_page.get(h) is not None or h in self._host:
                continue  # already servable — nothing to wait for
            if self._claims.get(h, 0) > 0:
                n += 1
            else:
                break
        return n


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
