"""The generation engine: chunked prefill + pipelined decode bursts over the
paged KV cache, with continuous batching; port of the default serving path
of ``githubrepostorag_tpu/serving/engine.py``.

What it runs: bf16 (or f32) KV pages, or int8 / int4 pages with per-page
scales (``kv_quant``); bf16/f32, int8 or int4 weights (models/quant.py;
int4 projections run kernel D at prefill and kernel E at decode); padded
chunked prefill (``forward_paged`` -> kernel A) or token-budget packed
prefill (``prefill_token_budget``: ``forward_paged_packed`` -> kernel C,
or kernel A over quantized pages), prefix caching, and pipelined decode
bursts (``decode_burst`` -> kernel B; int4 pages take the burst's gather
path, as in the JAX package).  Scheduling -- admission, page allocation,
who prefills and who decodes -- is host-side Python; compute stays on the
device.

Prefill widths (``prefill_widths``): a padded wave dispatches at the
smallest width of the ladder ``prefill_chunk``, ``/2``, ... (never below
one page, nor below 16) that covers its longest pending chunk, so a
ragged last chunk runs kernel A at a narrower window.  Unlike the JAX
engine, a narrow wave keeps at least ``prefill_chunk`` padded tokens
(more rows, padding: ``prefill_row_floor``), so its projections run GEMMs
of a row count the default engine also runs, and every row's prefill, and
its greedy tokens, are the same at every width.  Prefill priority (``prefill_priority``): a step
whose prefill chunk ran while prompts are still admitting runs no decode
burst; once no chunk can run, decode runs (which also frees pages).
``layer_unroll`` is kept as an attribute and changes nothing: the port
runs no layer scan to unroll.

Pipelining: while only decoding, burst k+1 is dispatched before burst k's
tokens are read, so the device->host read overlaps the next burst's
compute.  A prefill wave that completes prompts while other rows run keeps
its first tokens on the device (``_pending_first``); they are overlaid into
the next burst's chained last-token/length state and committed with that
burst's read.  The first host read (``.tolist()`` / ``.cpu()``) of a
result is the sync point, at the same places the JAX engine fetches.

Every other mode of the JAX engine (sequence-parallel ring prefill,
n-gram / draft / fused-step speculation, the host KV tier, preemption,
meshes) is rejected at construction: it is not ported yet.
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.models.qwen2 import (
    Qwen2Config,
    forward_paged,
    forward_paged_packed,
)
from githubrepostorag_tpu_torch.models.quant import QUANTIZED_TYPES, fuse_projections
from githubrepostorag_tpu_torch.ops.sampling import sample_tokens
from githubrepostorag_tpu_torch.serving.decode_burst import decode_burst
from githubrepostorag_tpu_torch.serving.kv_cache import (
    OutOfPages,
    PageAllocator,
    PrefixCachingAllocator,
    make_page_pools,
    packed_slot_mapping,
    page_hashes,
    pages_needed,
    quant_bits,
    slot_mapping,
)
from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams

logger = logging.getLogger(__name__)

TokenCallback = Callable[[str, int], None]  # (request_id, token_id)

def _bucket(n: int, cap: int, minimum: int = 16) -> int:
    """Smallest power-of-two >= n (floored at ``minimum``, capped at
    ``cap``): the JAX package's ``utils.next_bucket``, so both engines pad
    prefill waves to the same row counts."""
    b = minimum
    while b < n:
        b *= 2
    return min(b, cap)


# JAX Engine options whose modes are not ported, with the value that means
# "off" (for a mode's tuning keyword, its JAX default).  Passing any other
# value raises at construction, so the port is stricter than the JAX engine,
# which ignores a mode's tuning while the mode is off.
_UNPORTED_OPTIONS = {
    "mesh": None,
    "kv_tier": "off",
    "kv_host_pool_pages": 0,
    "sp_prefill_threshold": None,
    "spec_ngram_k": 0,
    "spec_burst_iters": 0,
    "fused_step": False,
    "draft_params": None,
    "draft_cfg": None,
    "preempt": "off",
    "preempt_headroom_pages": 0,
    # tuning of those modes (JAX defaults)
    "protected_priority": "interactive",
    "kv_migrate_burst": 8,
    "sp_ring_pack": True,
    "sp_ring_buckets": 0,
    "spec_k": 4,
    "spec_iters": 4,
    "spec_accept_floor": 0.35,
    "spec_deadline_margin_s": 0.25,
}
# values the JAX engine also reads as "off" for these options
_ALSO_OFF = {"kv_tier": ("auto",), "preempt": ("auto",)}


@dataclass
class GenerationResult:
    request_id: str
    prompt_tokens: list[int]
    output_tokens: list[int]
    finish_reason: str  # "stop" | "length" | "cancelled" | "deadline" | "error"
    ttft_s: float | None = None
    decode_time_s: float = 0.0
    error: str | None = None
    # monotonic phase stamps: submit_t / prefill_start_t / first_token_t / done_t
    timings: dict | None = None


@dataclass
class _Request:
    request_id: str
    prompt: list[int]
    sampling: SamplingParams
    on_token: TokenCallback | None
    state: str = "waiting"  # waiting -> prefilling -> running -> done
    row: int = -1
    pages: list[int] = field(default_factory=list)
    seq_len: int = 0  # tokens in the KV cache
    prefill_pos: int = 0
    page_hashes: list[bytes] = field(default_factory=list)
    pages_registered: int = 0
    cached_tokens: int = 0  # prompt tokens served from the prefix cache
    output: list[int] = field(default_factory=list)
    cancelled: bool = False
    error: str | None = None
    submit_t: float = field(default_factory=time.monotonic)
    prefill_start_t: float | None = None
    first_token_t: float | None = None
    deadline_ts: float | None = None  # absolute time.monotonic() budget
    deadline_expired: bool = False
    priority: str = "interactive"  # SLO class


class Engine:
    def __init__(
        self,
        params: dict,
        cfg: Qwen2Config,
        *,
        max_num_seqs: int = 8,
        num_pages: int = 512,
        page_size: int = 16,
        max_seq_len: int = 2048,
        prefill_chunk: int = 512,
        prefill_widths: int = 1,  # widths of the padded dispatch ladder:
        # prefill_chunk, /2, ... (the packed path ignores it)
        prefill_token_budget: int | None = None,  # token-budget packed
        # prefill: every prefilling row's next chunk (whole, or split where
        # the budget runs out) back to back in one [budget] buffer, so the
        # dense layers scale with real tokens.  None: padded prefill
        kv_dtype: torch.dtype = torch.bfloat16,
        kv_quant: bool | int | str = False,  # quantized KV pages with
        # per-page first-write scales: 8 (or True) int8, 4 nibble-packed
        # int4 (kv_cache.quant_bits)
        rng_seed: int = 0,
        decode_burst: int = 8,
        layer_unroll: int = 1,  # the JAX burst's layer-scan unroll; no
        # effect here (no scan), kept for the settings' sake
        prefix_caching: bool = True,
        prefill_priority: bool = False,  # no decode burst on a step whose
        # prefill chunk ran while prompts are still admitting
        default_priority: str = "interactive",  # class stamped on
        # unlabeled add_request calls (PRIORITY_DEFAULT_CLASS)
        device: str | torch.device | None = None,
        **unported,
    ) -> None:
        for name, value in unported.items():
            if name not in _UNPORTED_OPTIONS:
                raise TypeError(f"Engine() got an unexpected keyword argument {name!r}")
            default = _UNPORTED_OPTIONS[name]
            if not (value is default or value == default or value in _ALSO_OFF.get(name, ())):
                raise NotImplementedError(
                    f"Engine option {name}={value!r} selects or tunes a mode the torch "
                    f"port does not run yet (leave it at {default!r}); it serves padded or packed (prefill_token_budget) "
                    "chunked prefill, bf16/f32 or int8/int4 (kv_quant) KV pages, "
                    "bf16/f32, int8 or int4 weights, prefix caching and pipelined "
                    "decode bursts"
                )
        self.device = resolve_device(device)
        _check_params(params, self.device)
        # single-chip serving layout: 4 projection matmuls per layer, not 7
        # (quantized leaves fuse too)
        self.params = fuse_projections(params)
        self.cfg = cfg
        self.max_num_seqs = max_num_seqs
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.max_pages_per_seq = pages_needed(max_seq_len, page_size)
        self.prefill_chunk = prefill_chunk
        # dispatch-width buckets, largest first: [chunk, chunk/2, ...],
        # never below the page size (slot mappings stay page-aligned) nor 16
        self.prefill_width_buckets = [prefill_chunk]
        for _ in range(max(1, prefill_widths) - 1):
            half = self.prefill_width_buckets[-1] // 2
            if half < max(page_size, 16):
                break
            self.prefill_width_buckets.append(half)
        # padded tokens a narrow wave keeps at least (rows, padding): with
        # prefill_chunk, every GEMM the ladder runs has as many rows as one
        # the default engine runs (prefill_chunk times a power of two), so
        # the ladder adds no GEMM shape and a row's prefill, and its greedy
        # tokens, stay those of the full-width dispatch.  cuBLAS picks its
        # algorithm by shape: on an H100 it splits K of the 18944 -> 3584
        # down projection at 256 rows or fewer, and every row then differs
        # in its last bits.  0 turns the floor off (to measure its cost).
        self.prefill_row_floor = prefill_chunk
        if prefill_token_budget is not None and prefill_token_budget < 1:
            raise ValueError("prefill_token_budget must be >= 1 when set")
        self.prefill_token_budget = prefill_token_budget
        # per-segment chunk cap in the packed buffer
        self.packed_chunk = (min(prefill_chunk, prefill_token_budget)
                             if prefill_token_budget is not None else 0)
        self.packed_prefill_tokens = 0  # stats: real tokens dispatched packed
        self.packed_prefill_padding = 0  # stats: unused budget slots
        self.decode_burst = max(1, decode_burst)
        self.layer_unroll = max(1, layer_unroll)
        self.prefill_priority = prefill_priority
        self.default_priority = default_priority

        # 0 off, 8 int8, 4 nibble-packed int4
        self.kv_quant = quant_bits(kv_quant)
        pools = make_page_pools(cfg, num_pages, page_size, dtype=kv_dtype, device=self.device,
                                quant=self.kv_quant)
        self._k_pages, self._v_pages = pools.k, pools.v
        self._k_scales, self._v_scales = pools.ks, pools.vs
        self.prefix_caching = prefix_caching
        self._allocator = (PrefixCachingAllocator(num_pages) if prefix_caching
                           else PageAllocator(num_pages))

        self.requests_admitted = 0
        self.deadline_reaps = 0
        self.committed_tokens = 0
        self.prefill_tokens = 0
        self.step_dispatches_total = 0
        self.prefill_seconds_total = 0.0
        self.decode_seconds_total = 0.0

        # host-side batch state
        self._block_tables = np.zeros((max_num_seqs, self.max_pages_per_seq), dtype=np.int32)
        self._seq_lens = np.zeros((max_num_seqs,), dtype=np.int32)
        self._row_limits = np.zeros((max_num_seqs,), dtype=np.int32)
        self._free_rows = list(range(max_num_seqs - 1, -1, -1))
        self._row_req: dict[int, _Request] = {}

        # per-row sampling params (host mirror; pushed to the device when dirty)
        self._temp = np.full((max_num_seqs,), 1.0, dtype=np.float32)
        self._top_p = np.ones((max_num_seqs,), dtype=np.float32)
        self._top_k = np.zeros((max_num_seqs,), dtype=np.int32)
        self._rep_pen = np.ones((max_num_seqs,), dtype=np.float32)
        self._sampling_dirty = True
        self._temp_d = self._top_p_d = self._top_k_d = self._rep_pen_d = None

        # token-presence mask for the repetition penalty; column V is the
        # drop sentinel that padding positions are written to
        self._presence = torch.zeros((max_num_seqs, cfg.vocab_size + 1), dtype=torch.bool,
                                     device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        self._waiting: list[_Request] = []
        self._rejected: list[_Request] = []
        self._requests: dict[str, _Request] = {}
        self._ids = itertools.count()

        # pipelined decode state (see module docstring): the in-flight burst,
        # finished rows whose pages it may still read, and first-token waves
        self._chain: dict | None = None
        self._deferred: list[tuple[int, list[int]]] = []
        self._pending_first: list[tuple[torch.Tensor, list[tuple[_Request, int]]]] = []

    # ------------------------------------------------------------- intake --

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        """Copy a host array to the engine's device.  On the card the copy
        goes through pinned memory without blocking, so building the next
        dispatch never waits for the burst in flight."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cpu":
            return host.clone()
        return host.pin_memory().to(self.device, non_blocking=True)

    def add_request(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        on_token: TokenCallback | None = None,
        request_id: str | None = None,
        deadline_s: float | None = None,
        priority: str | None = None,
    ) -> str:
        rid = request_id or f"req-{next(self._ids)}"
        sampling = sampling or SamplingParams()
        req = _Request(request_id=rid, prompt=list(prompt_ids), sampling=sampling,
                       on_token=on_token, deadline_ts=deadline_s,
                       priority=priority or self.default_priority)
        if len(req.prompt) + sampling.max_tokens > self.max_seq_len:
            req.sampling = sampling.clamped(self.max_seq_len - len(req.prompt))
        self._requests[rid] = req
        self.requests_admitted += 1
        error = None
        if not req.prompt or len(req.prompt) >= self.max_seq_len:
            error = "prompt empty or exceeds max_seq_len"
        elif any(not 0 <= t < self.cfg.vocab_size for t in req.prompt):
            error = "prompt token id outside the vocabulary"
        else:
            need = pages_needed(
                min(len(req.prompt) + req.sampling.max_tokens, self.max_seq_len), self.page_size)
            if need > self._allocator.num_pages:
                error = (f"request needs {need} KV pages but the pool has only "
                         f"{self._allocator.num_pages}; raise num_pages or shorten the request")
        if error is not None:
            # surfaced through the next step() like any completion
            req.state = "done"
            req.error = error
            self._rejected.append(req)
            return rid
        self._waiting.append(req)
        return rid

    def cancel(self, request_id: str) -> None:
        req = self._requests.get(request_id)
        if req is not None:
            req.cancelled = True

    def has_work(self) -> bool:
        return bool(self._waiting or self._row_req or self._rejected)

    @property
    def num_running(self) -> int:
        return len(self._row_req)

    @property
    def is_admitting(self) -> bool:
        """True while a prompt wave is still being admitted: requests are
        queued or mid-prefill (what prefill priority reads)."""
        return bool(self._waiting) or any(
            r.state == "prefilling" for r in self._row_req.values())

    @property
    def num_waiting(self) -> int:
        return len(self._waiting)

    # --------------------------------------------------------- scheduling --

    def step(self) -> list[GenerationResult]:
        """One engine iteration: admit + prefill one chunk AND decode every
        running row, both dispatched with no host sync in between.  Returns
        the requests finished this step."""
        finished: list[GenerationResult] = []
        for req in self._rejected:
            res = self._result(req, "error")
            res.error = req.error
            finished.append(res)
        self._rejected.clear()
        self._reap_expired()
        self._reap_cancelled(finished)

        t_pf = time.monotonic()
        prefilled = self._try_prefill(finished)
        self.prefill_seconds_total += time.monotonic() - t_pf
        # prefill priority: a chunk ran and prompts remain, so the next step
        # goes to admission, not to a burst.  Nothing starves: once no chunk
        # can run, ``prefilled`` is False and decode runs.  The in-flight
        # burst and queued first-token waves stay on the device until then.
        skip_decode = self.prefill_priority and prefilled and self.is_admitting
        if not skip_decode and any(r.state == "running" for r in self._row_req.values()):
            t_run = time.monotonic()
            self._decode_step(finished)
            self.decode_seconds_total += time.monotonic() - t_run
        if not self._row_req:
            # nothing left running: land any in-flight burst and recycle
            self._drain_chain(finished)
        return finished

    def _reap_expired(self) -> None:
        """Mark past-deadline requests cancelled so the reap below frees
        their pages this step."""
        now = time.monotonic()
        for req in itertools.chain(self._waiting, self._row_req.values()):
            if req.deadline_ts is not None and not req.cancelled and now >= req.deadline_ts:
                req.cancelled = True
                req.deadline_expired = True
                self.deadline_reaps += 1

    def _reap_cancelled(self, finished: list[GenerationResult]) -> None:
        for req in [r for r in self._waiting if r.cancelled]:
            self._waiting.remove(req)
            req.state = "done"
            finished.append(self._result(req, "deadline" if req.deadline_expired else "cancelled"))
        for req in [r for r in self._row_req.values() if r.cancelled]:
            self._release(req)
            finished.append(self._result(req, "deadline" if req.deadline_expired else "cancelled"))

    def _register_full_pages(self, req: _Request) -> None:
        """Publish every prompt page prefill has completed so far: its KV is
        final, so identical prefixes admitted from now on skip it."""
        if not self.prefix_caching:
            return
        if not req.page_hashes:
            req.page_hashes = page_hashes(req.prompt, self.page_size)
        full = min(req.prefill_pos // self.page_size, len(req.page_hashes))
        while req.pages_registered < full:
            j = req.pages_registered
            self._allocator.register(req.page_hashes[j], req.pages[j])
            req.pages_registered = j + 1

    def _head_need_hashes(self, req: _Request) -> tuple[int, list[bytes]]:
        """Total page need for ``req`` and the chain hashes of the prefix
        pages its admission may share (capped so at least one prompt token
        still runs through prefill)."""
        need = pages_needed(
            min(len(req.prompt) + req.sampling.max_tokens, self.max_seq_len), self.page_size)
        hashes: list[bytes] = []
        if self.prefix_caching:
            if not req.page_hashes:
                req.page_hashes = page_hashes(req.prompt, self.page_size)
            shareable = min(len(req.page_hashes), (len(req.prompt) - 1) // self.page_size)
            hashes = req.page_hashes[:shareable]
        return need, hashes

    def _admission_feasible(self) -> bool:
        """True when the head-of-queue request could be admitted counting
        rows/pages a chain drain would recycle (draining the pipeline is
        not worth it for an admission the allocator would refuse)."""
        if not self._waiting:
            return False
        need, hashes = self._head_need_hashes(self._waiting[0])
        rows_avail = bool(self._free_rows) or bool(self._deferred)
        extra = sum(self._allocator.releasable_count(pages) for _, pages in self._deferred)
        return rows_avail and self._allocator.can_admit(hashes, need, extra_free=extra)

    def _try_prefill(self, finished: list[GenerationResult]) -> bool:
        """Admit every waiting request the pool can back, then run ONE
        batched prefill chunk over all prefilling rows.  Returns True if a
        chunk ran.  Free rows/pages are never referenced by an in-flight
        burst (finished rows wait in ``_deferred``), so the chain is drained
        only when the head of the queue needs those deferred resources."""
        if self._waiting:
            need0, hashes0 = self._head_need_hashes(self._waiting[0])
            can_free = bool(self._free_rows) and self._allocator.can_admit(hashes0, need0)
            if not can_free and self._admission_feasible():
                self._drain_chain(finished)
        cached_admits: list[_Request] = []
        while self._waiting and self._free_rows:
            req = self._waiting[0]
            need, hashes = self._head_need_hashes(req)
            if need > self.max_pages_per_seq:
                raise RuntimeError("intake clamp must bound the page need")
            if not self._allocator.can_admit(hashes, need):
                break
            shared = self._allocator.share(hashes) if hashes else []
            try:
                pages = shared + self._allocator.allocate(need - len(shared))
            except OutOfPages:
                self._allocator.release(shared)
                break  # wait for running requests to finish
            self._waiting.pop(0)
            row = self._free_rows.pop()
            req.row, req.pages, req.state = row, pages, "prefilling"
            req.prefill_start_t = time.monotonic()
            # cache hit: prefill resumes after the shared pages' tokens
            req.cached_tokens = len(shared) * self.page_size
            req.prefill_pos = req.seq_len = req.cached_tokens
            req.pages_registered = len(shared)
            if shared:
                self._allocator.hit_tokens += req.cached_tokens
            self._row_req[row] = req
            self._block_tables[row, : len(pages)] = pages
            self._seq_lens[row] = req.cached_tokens
            # a burst may never write past this row's pages nor the length cap
            self._row_limits[row] = min(len(pages) * self.page_size, self.max_seq_len - 1)
            self._set_row_sampling(row, req.sampling)
            if req.cached_tokens:
                cached_admits.append(req)
        if cached_admits:
            # skipped prefixes still count for the repetition penalty
            nr = _bucket(len(cached_admits), self.max_num_seqs, minimum=1)
            ids = np.zeros((nr, self.max_seq_len), dtype=np.int32)
            rows = np.zeros((nr,), dtype=np.int32)
            lens = np.zeros((nr,), dtype=np.int32)
            for i, req in enumerate(cached_admits):
                ids[i, : req.cached_tokens] = req.prompt[: req.cached_tokens]
                rows[i] = req.row
                lens[i] = req.cached_tokens
            self._mark_presence_chunks(self._tensor(rows), self._tensor(ids), self._tensor(lens))
        prefilling = [r for r in self._row_req.values() if r.state == "prefilling"]
        if not prefilling:
            return False
        self._prefill_batch(prefilling, finished)
        return True

    # ------------------------------------------------------------ compute --

    def _prefill_batch(self, reqs: list[_Request], finished: list[GenerationResult]) -> None:
        """One prefill dispatch covering a chunk of EVERY prefilling row.
        Rows whose prompt completes this chunk sample their first token in
        one batched call; while decode is running those tokens stay on the
        device and commit with the next burst.  With a token budget the
        wave is packed instead (``_prefill_batch_packed``)."""
        if self.prefill_token_budget is not None:
            self._prefill_batch_packed(reqs, finished)
            return
        others_running = any(r.state == "running" for r in self._row_req.values())
        n = len(reqs)
        width = self._dispatch_width(
            max(min(len(r.prompt) - r.prefill_pos, self.prefill_chunk) for r in reqs))
        # a narrow wave keeps at least prefill_row_floor padded tokens
        rb = max(_bucket(n, self.max_num_seqs, minimum=1), -(-self.prefill_row_floor // width))

        ids = np.zeros((rb, width), dtype=np.int32)
        pos = np.zeros((rb, width), dtype=np.int32)
        slots = np.full((rb, width), -1, dtype=np.int32)
        bt = np.zeros((rb, self.max_pages_per_seq), dtype=np.int32)
        cached = np.zeros((rb,), dtype=np.int32)
        new_lens = np.zeros((rb,), dtype=np.int32)
        last_idx = np.zeros((rb,), dtype=np.int32)
        valids = []
        for i, req in enumerate(reqs):
            start = req.prefill_pos
            valid = min(len(req.prompt) - start, self.prefill_chunk)
            valids.append(valid)
            ids[i, :valid] = req.prompt[start : start + valid]
            pos[i] = np.arange(start, start + width)
            slots[i] = slot_mapping(self._block_tables[req.row], start, valid, self.page_size, width)
            bt[i] = self._block_tables[req.row]
            cached[i] = start
            new_lens[i] = valid
            last_idx[i] = valid - 1

        ids_d = self._tensor(ids)
        new_lens_d = self._tensor(new_lens)
        self.step_dispatches_total += 1
        logits = self._run_prefill(
            forward_paged, ids_d, self._tensor(pos), self._tensor(slots), self._tensor(bt),
            self._tensor(cached), new_lens_d, logits_at=self._tensor(last_idx))

        # mark the chunk's prompt tokens (padding rows have lens 0)
        row_idx = np.zeros((rb,), dtype=np.int32)
        row_idx[:n] = [r.row for r in reqs]
        self._finish_prefill_wave(list(zip(reqs, valids)), rb, row_idx, ids_d, new_lens_d,
                                  logits, others_running, finished)

    def _dispatch_width(self, longest_chunk: int) -> int:
        """The padded dispatch width of a wave whose longest pending chunk
        is ``longest_chunk``: the smallest width bucket covering it.  The
        only width rule; ``warmup`` runs each width through it."""
        width = self.prefill_chunk
        for w in self.prefill_width_buckets:  # largest -> smallest
            if w >= longest_chunk:
                width = w
        return width

    def _run_prefill(self, fn, ids, pos, *args, **kwargs) -> torch.Tensor:
        """Run ``forward_paged`` or ``forward_paged_packed`` over the
        engine's pools (and their scales when quantized), which update in
        place; returns the logits."""
        out = fn(self.params, self.cfg, ids, pos, self._k_pages, self._v_pages, *args,
                 k_scales=self._k_scales, v_scales=self._v_scales, **kwargs)
        return out[0]

    def _finish_prefill_wave(self, granted: list[tuple[_Request, int]], rb: int,
                             row_idx: np.ndarray, ids_d: torch.Tensor, new_lens_d: torch.Tensor,
                             logits: torch.Tensor, others_running: bool,
                             finished: list[GenerationResult]) -> None:
        """Bookkeeping after a padded or packed prefill dispatch: presence
        marks for the chunk's tokens (``ids_d`` [rb, width], ``new_lens_d``
        [rb]), each request's advance by its granted tokens and page
        registration, and first-token sampling for rows whose prompt
        completed (``logits`` [rb, 1, V], one row per wave row)."""
        row_d = self._tensor(row_idx)
        self._mark_presence_chunks(row_d, ids_d, new_lens_d)

        done_idx: list[int] = []
        for i, (req, share) in enumerate(granted):
            req.prefill_pos += share
            self.prefill_tokens += int(share)
            req.seq_len = req.prefill_pos
            self._seq_lens[req.row] = req.seq_len
            self._register_full_pages(req)
            if req.prefill_pos >= len(req.prompt):
                done_idx.append(i)
        if not done_idx:
            return

        # sample first tokens over the whole padded wave; rows that are not
        # done (and bucket padding rows) sample too but their tokens are
        # discarded
        done_mask = np.zeros((rb,), dtype=bool)
        done_mask[done_idx] = True
        self._push_sampling()
        rows_l = row_d.long()
        vocab = self.cfg.vocab_size
        tokens_d = sample_tokens(
            logits[:, 0], self._gen, self._temp_d[rows_l], self._top_p_d[rows_l],
            self._top_k_d[rows_l], self._rep_pen_d[rows_l], self._presence[rows_l, :vocab],
        )
        safe = torch.where(self._tensor(done_mask), tokens_d, vocab)
        self._presence[rows_l, safe.long()] = True  # column V drops the rest
        wave = [(granted[i][0], i) for i in done_idx]
        for req, _ in wave:
            req.state = "running"
        if self._chain is None and not others_running:
            # engine otherwise idle: commit now (best TTFT)
            tokens = tokens_d.tolist()
            for req, i in wave:
                self._commit_token(req, tokens[i], finished)
        else:
            self._pending_first.append((tokens_d, wave))

    def packed_prefill_buckets(self) -> list[int]:
        """The segment-count row buckets a packed dispatch can take: at
        most min(max_num_seqs, budget) segments, through the same
        ``_bucket`` call ``_build_packed_wave`` makes, so both engines pad a
        packed wave to the same row count."""
        cap = min(self.max_num_seqs, self.prefill_token_budget or 0)
        out: list[int] = []
        b = 1
        while cap:
            out.append(_bucket(min(b, cap), self.max_num_seqs, minimum=1))
            if b >= cap:
                break
            b *= 2
        return list(dict.fromkeys(out))

    def _prefill_batch_packed(self, reqs: list[_Request],
                              finished: list[GenerationResult]) -> None:
        """Token-budget packed prefill dispatch.  Greedy packing walks the
        prefilling rows in order and grants each its next chunk -- whole,
        or split to whatever budget remains -- until the [budget] buffer is
        full; rows that get nothing wait for the next step.  Per-token
        segment ids carry each token's block table and cached length into
        the per-segment attention, first tokens sample at each segment's
        last position, and the handoff into ``_pending_first`` / the decode
        chain is the padded path's."""
        others_running = any(r.state == "running" for r in self._row_req.values())
        meta = self._build_packed_wave(reqs)
        self.step_dispatches_total += 1
        t = self._tensor
        logits = self._run_prefill(
            forward_paged_packed, t(meta["ids"]), t(meta["pos"]), t(meta["slots"]),
            t(meta["bt"]), t(meta["cached"]), t(meta["new_lens"]), t(meta["seg"]),
            t(meta["last_idx"]), self.packed_chunk)
        self._finish_prefill_wave(meta["packed"], meta["rb"], meta["row_idx"],
                                  t(meta["seg_ids_2d"]), t(meta["new_lens"]), logits,
                                  others_running, finished)

    def _build_packed_wave(self, reqs: list[_Request]) -> dict:
        """Greedy-pack the prefilling rows' next chunks into the [budget]
        token buffer and build every host array the packed dispatch
        needs."""
        budget = self.prefill_token_budget
        tq = self.packed_chunk
        packed: list[tuple[_Request, int]] = []  # (request, tokens granted)
        used = 0
        for req in reqs:
            if used >= budget:
                break
            share = min(len(req.prompt) - req.prefill_pos, tq, budget - used)
            packed.append((req, share))
            used += share
        n = len(packed)
        rb = _bucket(n, self.max_num_seqs, minimum=1)

        ids = np.zeros((1, budget), dtype=np.int32)
        pos = np.zeros((1, budget), dtype=np.int32)
        slots = np.full((budget,), -1, dtype=np.int32)
        seg = np.full((budget,), rb, dtype=np.int32)  # rb marks padding
        bt = np.zeros((rb, self.max_pages_per_seq), dtype=np.int32)
        cached = np.zeros((rb,), dtype=np.int32)
        new_lens = np.zeros((rb,), dtype=np.int32)
        last_idx = np.zeros((rb,), dtype=np.int32)
        # each segment's tokens as a [rb, tq] block, for the presence marks
        seg_ids_2d = np.zeros((rb, tq), dtype=np.int32)
        off = 0
        for i, (req, share) in enumerate(packed):
            start = req.prefill_pos
            chunk = req.prompt[start: start + share]
            ids[0, off: off + share] = chunk
            pos[0, off: off + share] = np.arange(start, start + share)
            packed_slot_mapping(self._block_tables[req.row], start, share, self.page_size,
                                slots, off)
            seg[off: off + share] = i
            seg_ids_2d[i, :share] = chunk
            bt[i] = self._block_tables[req.row]
            cached[i] = start
            new_lens[i] = share
            last_idx[i] = off + share - 1
            off += share
        self.packed_prefill_tokens += used
        self.packed_prefill_padding += budget - used
        row_idx = np.zeros((rb,), dtype=np.int32)
        row_idx[:n] = [req.row for req, _ in packed]
        return {"packed": packed, "rb": rb, "ids": ids, "pos": pos, "slots": slots,
                "seg": seg, "bt": bt, "cached": cached, "new_lens": new_lens,
                "last_idx": last_idx, "seg_ids_2d": seg_ids_2d, "row_idx": row_idx}

    def _decode_step(self, finished: list[GenerationResult]) -> None:
        """One decode dispatch: a burst of ``decode_burst`` iterations.
        Bursts are pipelined: this dispatch reuses the in-flight burst's
        device-side last-token / length state and only then reads the
        previous burst's tokens."""
        b = self.max_num_seqs
        active = np.zeros((b,), dtype=bool)
        remaining = 1
        for row, req in self._row_req.items():
            active[row] = req.state == "running"  # mid-prefill rows sit out
            if req.state == "running":
                remaining = max(remaining, req.sampling.max_tokens - len(req.output))
        n_steps = self.decode_burst

        if self._chain is not None and remaining <= self._chain["pending"].shape[1]:
            # the in-flight burst already covers every row's token budget:
            # land it instead of dispatching a burst that would be discarded
            self._drain_chain(finished)
            return

        if self._chain is None:
            last = np.zeros((b,), dtype=np.int32)
            for row, req in self._row_req.items():
                last[row] = req.output[-1] if req.output else req.prompt[-1]
            last_d = self._tensor(last)
            lens_d = self._tensor(self._seq_lens)
        else:
            last_d = self._chain["last"].clone()
            lens_d = self._chain["lens"].clone()

        # overlay freshly-prefilled rows: first token on the device, cache
        # length known on the host
        first_waves = self._pending_first
        self._pending_first = []
        for tokens_d, wave in first_waves:
            # skip requests released since their wave was queued: their row
            # is -1 (or reassigned), and -1 would index the last row
            live = [(req, i) for req, i in wave if req.state == "running" and req.row >= 0]
            if not live:
                continue
            rows = self._tensor(np.asarray([req.row for req, _ in live], dtype=np.int64))
            idxs = self._tensor(np.asarray([i for _, i in live], dtype=np.int64))
            lens = self._tensor(np.asarray([self._seq_lens[req.row] for req, _ in live],
                                           dtype=np.int32))
            last_d[rows] = tokens_d[idxs]
            lens_d[rows] = lens

        self._push_sampling()
        self.step_dispatches_total += 1
        toks, _, self._k_pages, self._v_pages, self._presence, out_lens, *_ = decode_burst(
            self.params, self.cfg, last_d, lens_d, self._k_pages, self._v_pages,
            self._presence, self._tensor(active), self._tensor(self._row_limits),
            self._tensor(self._block_tables), self._gen,
            self._temp_d, self._top_p_d, self._top_k_d, self._rep_pen_d,
            n_steps=n_steps,
            # sort-free sampling whenever no sampling row filters
            filter_sampling=bool(np.any((self._temp > 0.0)
                                        & ((self._top_p < 1.0) | (self._top_k > 0)))),
            k_scales=self._k_scales, v_scales=self._v_scales,
        )
        prev = self._chain
        self._chain = {"last": toks[:, -1], "lens": out_lens, "pending": toks,
                       "first": first_waves}
        if prev is not None:
            self._commit_burst(prev, finished)

    def _commit_first_tokens(self, waves, finished: list[GenerationResult]) -> None:
        """Read + commit deferred prefill first-token waves."""
        for tokens_d, wave in waves:
            tokens = None
            for req, i in wave:
                if req.state != "running" or req.output:
                    continue  # released, or already committed
                if tokens is None:
                    tokens = tokens_d.tolist()
                self._commit_token(req, tokens[i], finished)

    def _commit_burst(self, entry: dict, finished: list[GenerationResult]) -> None:
        """Read a burst's packed tokens -- ONE [B, n_steps] transfer -- and
        apply stop/length bookkeeping.  First-token waves attached to this
        burst commit before its tokens; -1 marks inactive steps."""
        self._commit_first_tokens(entry.get("first", []), finished)
        toks = entry["pending"].cpu().numpy()
        for i in range(toks.shape[1]):
            for row in sorted(self._row_req):
                req = self._row_req.get(row)
                if req is None or req.state != "running" or toks[row, i] < 0:
                    continue
                req.seq_len += 1
                self._seq_lens[row] = req.seq_len
                self._commit_token(req, int(toks[row, i]), finished)

    def _drain_chain(self, finished: list[GenerationResult]) -> None:
        """Land the in-flight burst (if any), commit its tokens and any
        deferred first-token waves, and recycle every deferred row/page now
        that nothing on the device reads them."""
        if self._chain is not None:
            entry = self._chain
            self._chain = None  # releases during this commit recycle directly
            self._commit_burst(entry, finished)
        if self._pending_first:
            waves, self._pending_first = self._pending_first, []
            self._commit_first_tokens(waves, finished)
        for row, pages in self._deferred:
            self._allocator.release(pages)
            self._free_rows.append(row)
        self._deferred.clear()

    def _push_sampling(self) -> None:
        """Mirror host sampling params to device tensors when dirty."""
        if self._sampling_dirty:
            self._temp_d = self._tensor(self._temp)
            self._top_p_d = self._tensor(self._top_p)
            self._top_k_d = self._tensor(self._top_k)
            self._rep_pen_d = self._tensor(self._rep_pen)
            self._sampling_dirty = False

    # ---------------------------------------------------------- lifecycle --

    def _commit_token(self, req: _Request, token: int, finished: list[GenerationResult]) -> None:
        if req.first_token_t is None:
            req.first_token_t = time.monotonic()
        req.output.append(token)
        self.committed_tokens += 1
        if req.on_token is not None:
            try:
                req.on_token(req.request_id, token)
            except Exception:  # noqa: BLE001 - a callback must not kill the engine
                logger.exception("on_token callback failed for %s", req.request_id)
        if token in req.sampling.stop_token_ids:
            self._release(req)
            finished.append(self._result(req, "stop"))
        elif len(req.output) >= req.sampling.max_tokens or req.seq_len + 1 >= self.max_seq_len:
            self._release(req)
            finished.append(self._result(req, "length"))

    def _release(self, req: _Request) -> None:
        if req.row >= 0:
            if self._chain is not None:
                # an in-flight burst still reads this row's pages
                self._deferred.append((req.row, req.pages))
            else:
                self._allocator.release(req.pages)
                self._free_rows.append(req.row)
            self._row_req.pop(req.row, None)
            self._seq_lens[req.row] = 0
            self._block_tables[req.row] = 0
            self._row_limits[req.row] = 0
            # reset the host mirrors to the no-filter defaults so a free row
            # never pins bursts onto the filtered sampler (the device copy
            # of a free row is never read; reassignment re-dirties)
            self._temp[req.row] = 1.0
            self._top_p[req.row] = 1.0
            self._top_k[req.row] = 0
            self._rep_pen[req.row] = 1.0
            req.row = -1
        req.state = "done"

    def _set_row_sampling(self, row: int, sp: SamplingParams) -> None:
        self._temp[row] = sp.temperature
        self._top_p[row] = sp.top_p
        self._top_k[row] = sp.top_k
        self._rep_pen[row] = sp.repetition_penalty
        self._sampling_dirty = True
        self._presence[row] = False  # fresh presence row for the new occupant

    def _result(self, req: _Request, reason: str) -> GenerationResult:
        self._requests.pop(req.request_id, None)
        ttft = (req.first_token_t - req.submit_t) if req.first_token_t else None
        done_t = time.monotonic()
        return GenerationResult(
            request_id=req.request_id,
            prompt_tokens=req.prompt,
            output_tokens=req.output,
            finish_reason=reason,
            ttft_s=ttft,
            decode_time_s=(done_t - req.first_token_t) if req.first_token_t else 0.0,
            timings={
                "submit_t": req.submit_t,
                "prefill_start_t": req.prefill_start_t,
                "first_token_t": req.first_token_t,
                "done_t": done_t,
            },
        )

    # ----------------------------------------------------- presence helpers --

    def _mark_presence_chunks(self, row_idx: torch.Tensor, ids: torch.Tensor,
                              lens: torch.Tensor) -> None:
        """Batched prompt-token presence marking: padding positions go to
        the drop column V."""
        vocab = self.cfg.vocab_size
        valid = torch.arange(ids.shape[1], device=ids.device)[None, :] < lens[:, None]
        safe_ids = torch.where(valid, ids, vocab).long()
        self._presence[row_idx.long()[:, None], safe_ids] = True

    # --------------------------------------------------------- convenience --

    def warmup(self) -> None:
        """Build the kernels and touch every path live traffic takes --
        prefill at each dispatch width (packed at the budget when one is
        set), a greedy and a sampled decode burst -- through the public step
        loop, leaving the engine state clean.  Each wave's prompt holds
        another token, so no wave resumes from an earlier one's cached
        pages."""
        if self.device.type == "cuda":
            from githubrepostorag_tpu_torch import kernels

            kernels.build()
        greedy = SamplingParams(max_tokens=2, temperature=0.0)
        widths = [self.prefill_chunk] if self.prefill_token_budget else self.prefill_width_buckets
        seen: set[int] = set()
        wave = 0
        for w in widths:
            plen = max(1, min(w, self.max_seq_len - 3))
            dw = self._dispatch_width(min(plen, self.prefill_chunk))
            if dw in seen:
                continue
            seen.add(dw)
            wave += 1
            self.generate([[2 + wave % max(2, self.cfg.vocab_size - 2)] * plen], greedy)
        wave += 1
        self.generate([[2 + wave % max(2, self.cfg.vocab_size - 2)] * 3],
                      SamplingParams(max_tokens=2, temperature=0.7, top_p=0.9))
        logger.info("engine warmup complete")

    def generate(self, prompts: list[list[int]],
                 sampling: SamplingParams | list[SamplingParams] | None = None,
                 ) -> list[GenerationResult]:
        """Synchronous batch generation (tests, scripts)."""
        if isinstance(sampling, list):
            sps = sampling
        else:
            sps = [sampling or SamplingParams()] * len(prompts)
        order = [self.add_request(p, sp) for p, sp in zip(prompts, sps)]
        done: dict[str, GenerationResult] = {}
        while self.has_work():
            for res in self.step():
                done[res.request_id] = res
        return [done[rid] for rid in order]


def _check_params(params: dict, device: torch.device) -> None:
    """Every leaf a float tensor or a quantized leaf of models/quant.py
    (int8 per channel, int4 group-wise, int8 embedding table), all on the
    engine's device; anything else raises."""
    leaves = [params["embed"], params["norm"], *params["layers"].values()]
    if "lm_head" in params:
        leaves.append(params["lm_head"])
    for leaf in leaves:
        if isinstance(leaf, QUANTIZED_TYPES):
            tensors = list(leaf)
        elif isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            tensors = [leaf]
        else:
            raise NotImplementedError(
                f"unsupported parameter leaf {type(leaf).__name__}; pass bf16/f32 tensors "
                "or the quantized leaves of githubrepostorag_tpu_torch.models.quant")
        for t in tensors:
            if t.device.type != device.type:
                raise ValueError(f"params live on {t.device}, the engine on {device}")
