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
its greedy tokens, are the same at every width; an MoE tree keeps JAX's
rows instead (its expert capacity counts padded tokens).  Prefill priority (``prefill_priority``): a step
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

Speculative modes (``spec_ngram_k``): every decode dispatch verifies an
n-gram draft window of k+1 tokens through kernel A and commits the longest
agreed prefix plus the correction token.  ``_spec_decode_step`` drafts on
the host (serving/spec_decode.py); ``spec_burst_iters`` moves drafting on
the device and runs that many iterations in one call whenever every
running row is plain greedy (serving/spec_burst.py); ``fused_step`` runs a
step's deferred packed prefill wave and a mixed spec / sampled burst in
one call (serving/fused_step.py).  Spec modes commit synchronously (no
decode chain, no kernel B).

Host KV tier (``kv_tier`` / ``kv_host_pool_pages``): registered cold pages
are copied device -> host at step boundaries (a gather into a device
buffer, a non-blocking copy into pinned memory, read one boundary later
once its event has completed) and fault back in host -> device on a prefix
hit, scattered on the engine's stream before any dispatch that reads them
(serving/kv_cache.TieredPageAllocator, ops/page_migration.py).
Preempt-to-host (``preempt``): a protected-class arrival that cannot be
admitted parks a batch-class victim's pages in the host tier; the victim
resumes through the prefix cache with no prompt token recomputed.

Draft-model speculation (``draft_params`` / ``draft_cfg``): a small model
drafts k tokens on its own page pools (never quantized, the same page
count, indexed by the target's block tables), the target verifies k+1
positions through kernel A, and ``spec_iters`` rounds run in one call
(serving/draft_spec.py).  Every prefill chunk also runs through the draft
into its pools; the host tier moves both pools' pages.  A controller picks
each dispatch's k from a power-of-two ladder by the batch's EMA acceptance
and demotes a request to plain decode, for the rest of its life, when its
acceptance falls under ``spec_accept_floor`` or its deadline comes within
``spec_deadline_margin_s``; a batch with any other row decodes plainly
that step.

Meshes (``mesh``: a ``parallel.mesh.Mesh`` from ``make_mesh``, one rank
of a ``torch.distributed`` world): every rank builds the same engine over
its own slices (``parallel/sharding.py``; the tree stays unfused) and its
``n_kv / tp`` heads of the pools, and takes the same host decisions in the
same order, so every forward's collectives meet (``serving/spmd.py`` keeps
a server's ranks in lockstep).  tp runs kernels A, B, C, D and E on the
rank's heads and slices with Megatron's collectives around them; an MoE
tree's experts split over ep; the logits come back whole on every rank, so
each samples the same tokens from the same seed.  Prompts of at least
``sp_prefill_threshold`` tokens, on a mesh with sp > 1, prefill in one
ring pass over sp (``serving/long_prefill.py``): segment-packed by default
(``sp_ring_pack``), at a width from ``sp_ring_bucket_ladder``.  On a mesh
with an axis above 1 the speculative modes, the fused step, the host tier
and preemption are still refused (ROADMAP queue 1 item 8.6).
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, field, replace
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
from githubrepostorag_tpu_torch.ops.packed_prefill import ring_segment_layout
from githubrepostorag_tpu_torch.ops.page_migration import (
    gather_pages,
    migrate_buckets,
    scatter_pages,
    split_page_payloads,
)
from githubrepostorag_tpu_torch.ops.sampling import sample_tokens
from githubrepostorag_tpu_torch.serving.decode_burst import decode_burst
from githubrepostorag_tpu_torch.serving.draft_spec import draft_spec_burst
from githubrepostorag_tpu_torch.serving.fused_step import fused_step_burst
from githubrepostorag_tpu_torch.serving.long_prefill import ring_prefill, ring_prefill_packed
from githubrepostorag_tpu_torch.serving.kv_cache import (
    OutOfPages,
    PageAllocator,
    PrefixCachingAllocator,
    TieredPageAllocator,
    make_page_pools,
    packed_slot_mapping,
    page_hashes,
    pages_needed,
    quant_bits,
    slot_mapping,
)
from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams
from githubrepostorag_tpu_torch.serving.spec_burst import spec_decode_burst
from githubrepostorag_tpu_torch.serving.spec_decode import ngram_propose

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


def derive_sp_prefill_threshold(*, sp: int, explicit: int, env_set: bool, prefill_chunk: int,
                                max_seq_len: int) -> int | None:
    """The ring-prefill routing threshold of an engine build, as the JAX
    server resolves it: None (off) without an sp axis; an explicit value
    wins (0 turns the ring off); unset, 4 prefill chunks (a prompt that
    would take 4 chunked passes amortizes the ring's rotations), clamped
    into [sp, max_seq_len // 2]."""
    if sp <= 1:
        return None
    if env_set:
        return explicit if explicit > 0 else None
    return max(sp, min(4 * prefill_chunk, max_seq_len // 2))


def _local_slices(params: dict, cfg: Qwen2Config, mesh) -> dict:
    """This rank's slices of a whole tree (``parallel/sharding.py``); a
    replicated leaf is kept as it is, not copied."""
    from githubrepostorag_tpu_torch.parallel.sharding import (
        qwen2_param_specs,
        shard_tensor,
        tree_map,
    )

    if "wqkv" in params["layers"] or "wgu" in params["layers"]:
        raise ValueError("an engine on a mesh takes the unfused tree (load_qwen2(fuse=False)): "
                         "fused projections cannot be cut into Megatron slices")
    specs = qwen2_param_specs(cfg, mesh, params)
    tp = mesh.shape["tp"]
    if tp > 1:
        # int4 q is nibble-packed within each group: a row-parallel slice is
        # a run of whole input rows only when tp divides the group count
        # (JAX's GSPMD pads such a cut instead)
        for name, leaf in params["layers"].items():
            spec = specs["layers"][name]
            if isinstance(leaf, tuple) and hasattr(leaf, "zs") and spec.q[-2] == "tp":
                groups = leaf.s.shape[-2]
                if groups % tp:
                    raise ValueError(
                        f"int4 projection {name!r} has {groups} groups of input rows, which "
                        f"tp={tp} does not divide: a row-parallel slice would cut a group "
                        "(ROADMAP queue 3 item 23); use a smaller tp or another group size")
    return tree_map(lambda x, spec: x if all(a is None for a in spec)
                    else shard_tensor(x, mesh, spec), params, specs)


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
    # draft-model speculation's per-request accounting: drafts proposed and
    # accepted, and the sticky fallback reason ("acceptance" | "deadline");
    # the n-gram paths count per engine and leave these 0 / None
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_fallback: str | None = None
    # host tier: prefix pages re-admitted by fault-in instead of recomputed
    faulted_pages: int = 0
    # times this request was parked to the host tier and resumed
    preempted: int = 0


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
    # host tier: chain hashes this admission promised to register (followers
    # with the same prefix may wait for them), and pages faulted in
    claimed_hashes: list[bytes] = field(default_factory=list)
    faulted_pages: int = 0
    # draft-model speculation controller: EMA of the per-dispatch acceptance
    # rate (drives the k ladder) and the sticky fallback reason
    spec_accept_ema: float | None = None
    spec_fallback: str | None = None
    spec_proposed_req: int = 0
    spec_accepted_req: int = 0
    # SLO class: headroom and preemption act for the protected one
    priority: str = "interactive"
    # preempt-to-host: after a park, ``prompt`` holds the whole stream
    # (prompt + output so far), so resuming is a prefix-cached admission;
    # the original split is kept for the result
    preempted: int = 0
    resume_pending: bool = False
    orig_prompt_len: int = 0
    prior_output: list[int] = field(default_factory=list)


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
        kv_tier: str = "auto",  # host-RAM KV page tier behind the block
        # tables: "on", "off", or "auto" (on iff kv_host_pool_pages > 0);
        # needs prefix_caching (tier residency is keyed by chain hashes)
        kv_host_pool_pages: int = 0,  # host tier capacity in pages (0 with
        # kv_tier="on": 4 x num_pages)
        kv_migrate_burst: int = 8,  # pages per migration dispatch
        prefill_priority: bool = False,  # no decode burst on a step whose
        # prefill chunk ran while prompts are still admitting
        mesh=None,  # parallel.mesh.Mesh: this rank's place in a tp / sp / ep
        # mesh (module docstring); None: one device, fused projections
        sp_prefill_threshold: int | None = None,  # prompts this long prefill
        # in one ring pass over the mesh's sp axis (serving/long_prefill.py)
        sp_ring_pack: bool = True,  # one ring pass carries every waiting long
        # prompt that fits (ring_prefill_packed); False: one prompt a pass
        sp_ring_buckets: int = 0,  # ring widths kept in the ladder, widest
        # down (0: every power of two from the threshold to max_seq_len)
        spec_ngram_k: int = 0,  # > 0: n-gram speculation with drafts of up
        # to k tokens instead of decode bursts
        spec_burst_iters: int = 0,  # > 0 (with spec_ngram_k): this many
        # draft -> verify -> accept iterations in one call while every
        # running row is plain greedy
        fused_step: bool = False,  # one call a step: the deferred packed
        # prefill wave and a mixed spec / sampled burst (needs spec_ngram_k,
        # spec_burst_iters and prefill_token_budget; not prefill_priority)
        preempt: str = "auto",  # preempt-to-host: "on" (needs the tier),
        # "off", or "auto" (on iff the tier is)
        draft_params: dict | None = None,  # draft-model speculation: a small
        # model drafts k tokens on its own pools, the target verifies k+1
        # (serving/draft_spec.py); exclusive with spec_ngram_k
        draft_cfg: Qwen2Config | None = None,
        spec_k: int = 4,  # the largest draft length; the controller picks each
        # dispatch's k from the power-of-two ladder [1, 2, ..., spec_k]
        spec_iters: int = 4,  # draft / verify / accept rounds a dispatch
        spec_accept_floor: float = 0.35,  # under this EMA acceptance a request
        # falls back to plain decode for the rest of its life
        spec_deadline_margin_s: float = 0.25,  # within this of its deadline a
        # request falls back too
        preempt_headroom_pages: int = 0,  # pages a non-protected admission
        # must leave allocatable; doubles while the protected class warns
        default_priority: str = "interactive",  # class stamped on
        # unlabeled add_request calls (PRIORITY_DEFAULT_CLASS)
        protected_priority: str = "interactive",  # the class headroom and
        # preemption act for; its requests are never victims
        device: str | torch.device | None = None,
    ) -> None:
        # the JAX engine's checks on mode combinations, with its errors
        if spec_burst_iters > 0 and spec_ngram_k <= 0:
            raise ValueError(
                "spec_burst_iters requires spec_ngram_k > 0 (SPEC_BURST_ITERS fuses the "
                "n-gram spec path; without SPEC_NGRAM_K it would silently do nothing)")
        if fused_step:
            if spec_ngram_k <= 0 or spec_burst_iters <= 0:
                raise ValueError(
                    "fused_step requires spec_ngram_k > 0 and spec_burst_iters > 0 "
                    "(FUSED_STEP fuses the n-gram spec burst with packed prefill)")
            if prefill_token_budget is None:
                raise ValueError(
                    "fused_step requires prefill_token_budget (the fused program's "
                    "prefill phase is the packed segment grid)")
            if draft_params is not None:
                raise ValueError(
                    "fused_step and draft-model speculation are mutually exclusive; "
                    "unset SPEC_DRAFT_MODEL or FUSED_STEP")
            if prefill_priority:
                raise ValueError(
                    "fused_step is incompatible with prefill_priority: a prefill-priority "
                    "step skips decode, which would orphan the deferred prefill wave")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg must be set together")
        if draft_params is not None and spec_ngram_k > 0:
            raise ValueError(
                "draft-model speculation and n-gram speculation are mutually exclusive; "
                "unset SPEC_NGRAM_K or SPEC_DRAFT_MODEL")
        if kv_tier not in ("auto", "on", "off"):
            raise ValueError(f"kv_tier must be 'auto'|'on'|'off', got {kv_tier!r}")
        if kv_tier == "on" and not prefix_caching:
            raise ValueError(
                "kv_tier='on' requires prefix_caching (host-tier residency is keyed by "
                "prefix chain hashes)")
        kv_tier_on = prefix_caching and (
            kv_tier == "on" or (kv_tier == "auto" and kv_host_pool_pages > 0))
        if preempt not in ("auto", "on", "off"):
            raise ValueError(f"preempt must be 'auto'|'on'|'off', got {preempt!r}")
        if preempt == "on" and not kv_tier_on:
            raise ValueError(
                "preempt='on' requires the KV host tier (kv_tier) — resume rides the "
                "claim/fault-in machinery, so parked victims need a tier to survive in")
        self.mesh = mesh
        spread = mesh is not None and any(n > 1 for n in mesh.shape.values())
        if spread:
            _check_mesh(mesh, cfg, {
                "n-gram speculation (spec_ngram_k)": spec_ngram_k > 0,
                "draft-model speculation (draft_params)": draft_params is not None,
                "the fused step (fused_step)": fused_step,
                "the host KV tier (kv_tier)": kv_tier_on,
                "preempt-to-host (preempt)": kv_tier_on and preempt != "off",
            })
        self.device = resolve_device(device)
        _check_params(params, self.device)
        if mesh is not None:
            # this rank's slices; projections stay unfused, as in JAX
            self.params = _local_slices(params, cfg, mesh)
            lonely = [a for a, n in mesh.shape.items() if n > 1 and mesh.group(a) is None]
            if lonely:
                raise ValueError(f"the mesh has no process group for {lonely}: build it "
                                 "with make_mesh inside a torch.distributed world")
        else:
            # single-chip serving layout: 4 projection matmuls per layer,
            # not 7 (quantized leaves fuse too)
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
        # An MoE tree dispatches JAX's [bucket(n), w] rows: its expert
        # capacity counts every dispatched token, padding rows included, so
        # padded rows would change which assignments drop.
        self.prefill_row_floor = 0 if cfg.num_experts else prefill_chunk
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
        self._page_obs = None  # an advisory page observatory, if attached

        # 0 off, 8 int8, 4 nibble-packed int4
        self.kv_quant = quant_bits(kv_quant)
        pools = make_page_pools(cfg, num_pages, page_size, dtype=kv_dtype, device=self.device,
                                quant=self.kv_quant, mesh=mesh)
        self._k_pages, self._v_pages = pools.k, pools.v
        self._k_scales, self._v_scales = pools.ks, pools.vs
        self.prefix_caching = prefix_caching
        self._kv_tier_on = kv_tier_on
        self.kv_migrate_burst = max(1, kv_migrate_burst)
        if kv_tier_on:
            self._allocator = TieredPageAllocator(
                num_pages,
                host_pool_pages=kv_host_pool_pages if kv_host_pool_pages > 0 else 4 * num_pages,
                migrate_burst=self.kv_migrate_burst)
        elif prefix_caching:
            self._allocator = PrefixCachingAllocator(num_pages)
        else:
            self._allocator = PageAllocator(num_pages)
        # writeback bursts in flight: (host buffers, copy event, hashes),
        # landed at the next step boundary; and fault-in staging buffers
        # kept alive until their host -> device copy's event completes
        self._wb_pending: list[tuple[tuple, torch.cuda.Event | None, list[bytes]]] = []
        self._fault_staging: list[tuple[torch.cuda.Event, tuple]] = []
        self.kv_migrations = 0  # stats: writeback bursts dispatched
        self.kv_fault_dispatches = 0  # stats: fault-in scatter bursts
        self.dedup_holds = 0  # stats: admissions held for a pending twin
        self.migration_seconds_total = 0.0
        self.fault_in_seconds_total = 0.0
        self.kv_pages_exported = 0
        self.kv_pages_imported = 0
        self.transfer_seconds_total = 0.0

        # sequence-parallel ring prefill over the mesh's sp axis
        self.sp_prefill_threshold = sp_prefill_threshold
        self._sp = mesh.shape["sp"] if mesh is not None else 1
        self.sp_prefills = 0  # stats: ring passes dispatched
        self.sp_ring_pack = sp_ring_pack
        self.sp_ring_bucket_count = max(0, sp_ring_buckets)
        # the packed ring pass's fixed segment-row count: every segment is at
        # least the threshold long, so the widest pass bounds how many pack
        thr = max(sp_prefill_threshold or 1, 1)
        sp1 = max(1, self._sp)
        cap = -(-_bucket(max_seq_len, max_seq_len, minimum=sp1) // sp1) * sp1
        self.sp_ring_segs = _bucket(max(1, min(max_num_seqs, cap // thr)), max_num_seqs,
                                    minimum=1)
        self.sp_ring_segments = 0  # stats: prompts packed into ring passes
        self.sp_ring_tokens = 0  # stats: real tokens through ring passes
        self.sp_ring_padding = 0  # stats: unused ring-buffer slots
        if self._sp > 1 and sp_prefill_threshold is not None:
            logger.info("sp prefill: threshold=%d tokens over sp=%d (%s, ladder %s)",
                        sp_prefill_threshold, self._sp,
                        "segment-packed" if sp_ring_pack else "one sequence per pass",
                        self.sp_ring_bucket_ladder())

        self.spec_ngram_k = spec_ngram_k
        self.spec_burst_iters = spec_burst_iters
        self.fused_step_on = bool(fused_step)
        # the fused call's prefill segment bucket: always the largest packed
        # bucket, so a deferred wave's shape never depends on its size
        self._fused_pf_segs = self.packed_prefill_buckets()[-1] if self.fused_step_on else 0
        self._fused_pf_wave: dict | None = None  # deferred packed wave
        self.fused_steps_total = 0

        # draft-model speculation (module docstring)
        self._draft_enabled = draft_params is not None
        self.draft_cfg = draft_cfg
        self.spec_k = spec_k
        self.spec_iters = spec_iters
        self.spec_accept_floor = spec_accept_floor
        self.spec_deadline_margin_s = spec_deadline_margin_s
        self.draft_params = None
        self._dk_pages = self._dv_pages = None
        self._force_plain = False  # warmup: route decode through _decode_step
        self._spec_k_ladder: list[int] = []
        if self._draft_enabled:
            if draft_cfg.vocab_size != cfg.vocab_size:
                # verify compares token ids across the two models
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}; draft and target must share a tokenizer")
            if spec_k < 1 or spec_iters < 1:
                raise ValueError("spec_k and spec_iters must be >= 1")
            _check_params(draft_params, self.device)
            self.draft_params = fuse_projections(draft_params)
            # the draft's own pools, indexed by the target's block tables
            # (one allocator, two pools), in kv_dtype, never quantized
            dpools = make_page_pools(draft_cfg, num_pages, page_size, dtype=kv_dtype,
                                     device=self.device, quant=0)
            self._dk_pages, self._dv_pages = dpools.k, dpools.v
            # power-of-two ladder up to spec_k: warmup runs every rung, and
            # the controller only dispatches at a rung
            rung = 1
            while rung < spec_k:
                self._spec_k_ladder.append(rung)
                rung *= 2
            self._spec_k_ladder = sorted(set(self._spec_k_ladder + [spec_k]))
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_fallbacks: dict[str, int] = {}  # draft-model fallbacks by reason

        self.requests_admitted = 0
        self.deadline_reaps = 0
        # every dispatch shape run so far, (path, rows, ...): the compile
        # watchdog counts the ones live traffic adds after warmup
        self.dispatch_shapes: set[tuple] = set()

        # priority classes and preempt-to-host
        self._preempt_on = kv_tier_on and preempt != "off"
        self.preempt_headroom_pages = max(0, preempt_headroom_pages)
        self.protected_priority = protected_priority
        # class-aware queue order only when the options give classes teeth
        self._priority_sched = self._preempt_on or self.preempt_headroom_pages > 0
        self._parked: list[_Request] = []
        self._park_events: list[str] = []  # request ids parked since the last drain
        self._class_pressure: dict[str, int] = {}  # class -> 0 ok / 1 warn / 2 critical
        self.preemptions = 0
        self.preempted_pages = 0
        self.preempt_resumes = 0
        self.resume_faulted_pages = 0
        self.resume_recomputed_tokens = 0  # parked KV tokens prefilled again
        self.resume_recomputed_prompt_tokens = 0  # of those, prompt tokens

        self.committed_tokens = 0
        self.prefill_tokens = 0
        self.reaped_tokens = 0  # output tokens dropped by deadline reaps
        self.admission_blocked_steps = 0  # steps with waiters left after admission
        self.step_dispatches_total = 0
        self.prefill_seconds_total = 0.0
        self.decode_seconds_total = 0.0
        self.spec_verify_seconds_total = 0.0

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
        self._deferred: list[tuple[int, list[int], str]] = []  # (row, pages, request id)
        self._pending_first: list[tuple[torch.Tensor, list[tuple[_Request, int]]]] = []

    # ------------------------------------------------- page observability --

    def attach_page_observer(self, obs) -> None:
        """Register a page observatory: the allocator reports claim deltas
        and tier events, the engine each request's hold and release.  Both
        are advisory, and every call is fenced."""
        self._page_obs = obs
        self._allocator.attach_observer(obs)

    def _obs_hold(self, req: _Request) -> None:
        if self._page_obs is not None:
            try:
                self._page_obs.on_request_hold(req.request_id, req.priority, len(req.pages))
            except Exception:  # noqa: BLE001 - advisory seam
                pass

    def _obs_release(self, rid: str) -> None:
        if self._page_obs is not None:
            try:
                self._page_obs.on_request_release(rid)
            except Exception:  # noqa: BLE001 - advisory seam
                pass

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
        req.orig_prompt_len = len(req.prompt)
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
        self._enqueue_waiting(req)
        return rid

    def _enqueue_waiting(self, req: _Request) -> None:
        """Queue an arrival.  With priority scheduling on, protected-class
        arrivals go ahead of every other class's waiters (first come, first
        served within the class); otherwise the queue is FCFS."""
        if self._priority_sched and req.priority == self.protected_priority:
            for i, other in enumerate(self._waiting):
                if other.priority != self.protected_priority:
                    self._waiting.insert(i, req)
                    return
        self._waiting.append(req)

    def cancel(self, request_id: str) -> None:
        req = self._requests.get(request_id)
        if req is not None:
            req.cancelled = True

    def has_work(self) -> bool:
        return bool(self._waiting or self._row_req or self._rejected or self._parked)

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

    @property
    def num_parked(self) -> int:
        return len(self._parked)

    # --------------------------------------------------------- scheduling --

    def step(self, now: float | None = None) -> list[GenerationResult]:
        """One engine iteration: admit + prefill one chunk AND decode every
        running row, both dispatched with no host sync in between.  Returns
        the requests finished this step.  ``now`` (``time.monotonic()``
        when None) is the clock the deadlines are read against: the ranks
        of a mesh step with rank 0's reading (``serving/spmd.py``)."""
        finished: list[GenerationResult] = []
        for req in self._rejected:
            res = self._result(req, "error")
            res.error = req.error
            finished.append(res)
        self._rejected.clear()
        self._reap_expired(time.monotonic() if now is None else now)
        self._reap_cancelled(finished)
        self._reap_parked(finished)
        if self._kv_tier_on:
            self._migrate_pages()
        if self._preempt_on:
            self._maybe_preempt(finished)
        self._unpark_ready()

        t_pf = time.monotonic()
        prefilled = self._try_prefill(finished)
        self.prefill_seconds_total += time.monotonic() - t_pf
        if self._waiting:
            # still queued after an admission attempt: blocked on rows,
            # pages or a dedup hold this step
            self.admission_blocked_steps += 1
        # prefill priority: a chunk ran and prompts remain, so the next step
        # goes to admission, not to a burst.  Nothing starves: once no chunk
        # can run, ``prefilled`` is False and decode runs.  The in-flight
        # burst and queued first-token waves stay on the device until then.
        skip_decode = self.prefill_priority and prefilled and self.is_admitting
        running = [r for r in self._row_req.values() if r.state == "running"]
        if running and not skip_decode:
            t_run = time.monotonic()
            if self._draft_enabled and not self._force_plain:
                # every row is asked (a demotion is marked where it happens)
                capable = [r for r in running if self._spec_capable(r)]
                if len(capable) == len(running):
                    self._draft_spec_step(finished)
                    self.spec_verify_seconds_total += time.monotonic() - t_run
                else:
                    # one sampled or fallen-back row demotes this step's whole
                    # dispatch to plain decode (per step, not sticky)
                    self._decode_step(finished)
                    self.decode_seconds_total += time.monotonic() - t_run
            elif self.spec_ngram_k > 0:
                if self.fused_step_on:
                    # one call: the deferred packed wave (if any) and a
                    # mixed spec / sampled burst
                    self._fused_step(finished)
                elif self.spec_burst_iters > 0 and all(
                        r.sampling.temperature <= 0.0 and r.sampling.repetition_penalty == 1.0
                        for r in running):
                    self._spec_burst_step(finished)
                else:
                    self._spec_decode_step(finished)
                self.spec_verify_seconds_total += time.monotonic() - t_run
            else:
                self._decode_step(finished)
                self.decode_seconds_total += time.monotonic() - t_run
        if not self._row_req:
            # nothing left running: land any in-flight burst and recycle
            self._drain_chain(finished)
        return finished

    def _reap_expired(self, now: float) -> None:
        """Mark past-deadline requests cancelled so the reap below frees
        their pages this step."""
        for req in itertools.chain(self._waiting, self._row_req.values(), self._parked):
            if req.deadline_ts is not None and not req.cancelled and now >= req.deadline_ts:
                req.cancelled = True
                req.deadline_expired = True
                self.deadline_reaps += 1

    def _reap_cancelled(self, finished: list[GenerationResult]) -> None:
        for req in [r for r in self._waiting if r.cancelled]:
            self._waiting.remove(req)
            req.state = "done"
            if req.deadline_expired:
                self.reaped_tokens += len(req.output)
            finished.append(self._result(req, "deadline" if req.deadline_expired else "cancelled"))
        for req in [r for r in self._row_req.values() if r.cancelled]:
            self._release(req)
            if req.deadline_expired:
                self.reaped_tokens += len(req.output) + len(req.prior_output)
            finished.append(self._result(req, "deadline" if req.deadline_expired else "cancelled"))

    def _reap_parked(self, finished: list[GenerationResult]) -> None:
        """Finish cancelled or expired parked requests.  Their device pages
        went back at park time and their host copies are plain cache
        entries, so both tiers are freed exactly once."""
        for req in [r for r in self._parked if r.cancelled]:
            self._parked.remove(req)
            req.state = "done"
            if req.deadline_expired:
                self.reaped_tokens += len(req.output) + len(req.prior_output)
            finished.append(self._result(req, "deadline" if req.deadline_expired else "cancelled"))

    # ------------------------------------------- preempt-to-host (parking) --

    def set_class_pressure(self, states: dict[str, int]) -> None:
        """Install per-class burn-rate states (0 ok / 1 warn / 2 critical).
        Without an SLO plane nothing calls this, and the engine preempts
        only on the direct trigger (a protected head of queue that cannot
        be admitted)."""
        self._class_pressure = dict(states)

    def drain_park_events(self) -> list[str]:
        """Return and clear the request ids parked since the last drain
        (AsyncEngine turns them into ``parked`` stream events)."""
        events, self._park_events = self._park_events, []
        return events

    def _class_headroom(self, req: _Request) -> int:
        """KV pages this request's admission must leave allocatable: none
        for the protected class; batch pays double while the protected
        class is in warn."""
        if req.priority == self.protected_priority:
            return 0
        hr = self.preempt_headroom_pages
        if hr and self._class_pressure.get(self.protected_priority, 0) >= 1:
            hr *= 2
        return hr

    def _maybe_preempt(self, finished: list[GenerationResult]) -> None:
        """Park batch-class victims to the host tier until the trigger is
        met: a protected request heads the queue but cannot be admitted, or
        the protected class burns critically (clear the headroom ahead of
        the next arrival).  Landing the chain can finish the would-be
        victim, so each round drains and re-checks before it picks one: a
        park always happens with no chain live, and the row teardown is
        ``_release``'s immediate path."""
        target: _Request | None = None
        if self._waiting and self._waiting[0].priority == self.protected_priority:
            target = self._waiting[0]
        critical = self._class_pressure.get(self.protected_priority, 0) >= 2
        if target is None and not critical:
            return
        guard = 2 * self.max_num_seqs + 8  # a bound that never binds
        while guard > 0:
            guard -= 1
            if target is not None:
                need, hashes = self._head_need_hashes(target)
                if self._free_rows and self._allocator.can_admit(hashes, need):
                    return
            elif self._allocator.can_admit([], max(1, self.preempt_headroom_pages)):
                return
            if self._chain is not None or self._deferred:
                # land the burst first: its commits may finish the victim,
                # and deferred pages may be enough
                self._drain_chain(finished)
                continue
            victim = self._pick_victim()
            if victim is None:
                return
            self._park_victim(victim)
            # dispatch the priority writebacks now, so the parked pages
            # unpin within this step
            while self._allocator.pending_park_writebacks and self._migrate_pages():
                pass

    def _pick_victim(self) -> _Request | None:
        """The running batch-class request to park: latest deadline (none
        sorts last, most preemptible), then most pages.  Only a victim
        whose committed KV covers its prompt qualifies: resuming any other
        would prefill prompt tokens again."""
        ps = self.page_size
        best: _Request | None = None
        best_key: tuple = ()
        for req in self._row_req.values():
            if req.state != "running" or req.cancelled:
                continue
            if req.priority == self.protected_priority:
                continue
            if (req.seq_len // ps) * ps < len(req.prompt):
                continue  # mid-prompt: resume would recompute prefill
            key = (req.deadline_ts is None, req.deadline_ts or 0.0, len(req.pages))
            if best is None or key > best_key:
                best, best_key = req, key
        return best

    def _park_victim(self, req: _Request) -> None:
        """Evict a running request's KV to the host tier and park it.  The
        stream so far (prompt + output) becomes its prompt; on resume the
        admission shares the full pages back (a device hit or a fault-in)
        and prefill recomputes only the partial tail page.  ``max_tokens``
        shrinks by the tokens already produced, so the budget and every
        stop condition are unchanged."""
        ps = self.page_size
        stream = req.prompt + req.output
        full = req.seq_len // ps  # pages whose KV is fully committed
        hashes = page_hashes(stream[: full * ps], ps)
        if req.claimed_hashes:
            self._allocator.unclaim(req.claimed_hashes)
            req.claimed_hashes = []
        for j in range(req.pages_registered, full):
            self._allocator.register(hashes[j], req.pages[j])  # first writer wins
        pages, req.pages = req.pages, []
        self.preempted_pages += len(pages)
        self._allocator.park(pages)
        self._obs_release(req.request_id)
        row = req.row
        self._free_rows.append(row)
        self._row_req.pop(row, None)
        self._clear_row(row)
        req.row = -1
        produced = len(req.output)
        req.prior_output.extend(req.output)
        req.prompt = stream
        req.output = []
        req.page_hashes = []  # recomputed from the folded prompt
        req.pages_registered = 0
        req.cached_tokens = 0
        req.prefill_pos = 0
        req.seq_len = 0
        if produced:
            req.sampling = replace(req.sampling,
                                   max_tokens=max(1, req.sampling.max_tokens - produced))
        req.state = "parked"
        req.preempted += 1
        req.resume_pending = False
        self._parked.append(req)
        self._park_events.append(req.request_id)
        self.preemptions += 1

    def _unpark_ready(self) -> None:
        """Move parked requests whose pages fit back to the queue, earliest
        deadline first; hold them all while the protected class is still
        critical (un-parking into that pressure only cycles pages)."""
        if not self._parked:
            return
        if self._class_pressure.get(self.protected_priority, 0) >= 2:
            return
        self._parked.sort(key=lambda r: (r.deadline_ts is None, r.deadline_ts or 0.0))
        while self._parked:
            req = self._parked[0]
            need, hashes = self._head_need_hashes(req)
            if not self._free_rows or not self._allocator.can_admit(
                    hashes, need, headroom=self._class_headroom(req)):
                break  # deadline order: later victims do not jump the head
            self._parked.pop(0)
            req.state = "waiting"
            req.resume_pending = True
            self._requeue_resumed(req)

    def _requeue_resumed(self, req: _Request) -> None:
        """Resumed victims queue behind the protected block, ahead of queued
        batch arrivals: they ran once and hold host-tier state."""
        for i, other in enumerate(self._waiting):
            if other.priority != self.protected_priority or req.priority == self.protected_priority:
                self._waiting.insert(i, req)
                return
        self._waiting.append(req)

    # ---------------------------------------------------- host KV tier --

    def _to_host(self, bufs: tuple) -> tuple[tuple, torch.cuda.Event | None]:
        """Start copying device buffers into pinned host memory without
        blocking; returns the host buffers and an event that completes with
        the copies (None on the CPU, where the gather is already host
        memory).  The host buffers are read only after the event."""
        if self.device.type == "cpu":
            return bufs, None
        host = tuple(None if b is None else torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                     for b in bufs)
        for h, b in zip(host, bufs):
            if b is not None:
                h.copy_(b, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _migrate_pages(self) -> bool:
        """Step-boundary device -> host page migration (tiered engines).

        1. LAND the previous boundary's writebacks: wait for each copy's
           event (normally long complete) and publish each page's payload
           to the allocator under its chain hash.
        2. PLAN + DISPATCH a new gather over the coldest parked pages not
           yet saved (``TieredPageAllocator.evict``: a residency change,
           not a release), and start its copy to pinned host memory; it
           lands at the next boundary.

        Returns True if any work happened (``flush_kv_migrations`` loops
        on it)."""
        t0 = time.monotonic()
        moved = False
        alloc = self._allocator
        for bufs, event, hashes in self._wb_pending:
            if event is not None:
                event.synchronize()
            for h, payload in zip(hashes, split_page_payloads(bufs, len(hashes))):
                alloc.complete_writeback(h, payload)
            moved = True
        self._wb_pending.clear()
        plan = alloc.evict(self.kv_migrate_burst)
        if plan:
            nb = _bucket(len(plan), self.kv_migrate_burst, minimum=1)
            idx = np.full((nb,), -1, dtype=np.int32)
            idx[: len(plan)] = [p for p, _ in plan]
            idx_d = self._tensor(idx)
            bufs = gather_pages(self._k_pages, self._v_pages, idx_d,
                                self._k_scales, self._v_scales)
            # (k, v, ks, vs, draft k, draft v): the payload format.  The
            # draft pools share page indices with the target's, so a page
            # saves both, or a faulted-in row would draft from another
            # request's KV (tokens stay right; acceptance would collapse)
            bufs = tuple(bufs) + self._draft_gather(idx_d)
            host, event = self._to_host(bufs)
            self._wb_pending.append((host, event, [h for _, h in plan]))
            self.kv_migrations += 1
            moved = True
        if moved:
            self.migration_seconds_total += time.monotonic() - t0
        return moved

    def _dispatch_fault_ins(self) -> None:
        """Scatter the staged host -> device page payloads into the pools.
        Runs right after admission, before any dispatch that could read the
        faulted pages: every copy and scatter is queued on the engine's
        stream ahead of them, so no host sync is needed.  A staging buffer
        in pinned memory stays referenced until its copy's event has
        completed."""
        staged = self._allocator.fault_in()
        if not staged:
            return
        t0 = time.monotonic()
        self._fault_staging = [(ev, bufs) for ev, bufs in self._fault_staging if not ev.query()]
        # stored head width from the pool: int4 pages hold head_dim // 2
        ps, hd = self.page_size, self._k_pages.shape[-1]
        lead = (self.cfg.num_layers, self.cfg.num_kv_heads)
        quant = self._k_scales is not None
        pin = self.device.type == "cuda"
        while staged:
            burst = staged[: self.kv_migrate_burst]
            staged = staged[self.kv_migrate_burst:]
            nb = _bucket(len(burst), self.kv_migrate_burst, minimum=1)
            idx = np.full((nb,), -1, dtype=np.int32)
            k_vals = torch.zeros((*lead, nb, ps, hd), dtype=self._k_pages.dtype, pin_memory=pin)
            v_vals = torch.zeros(k_vals.shape, dtype=k_vals.dtype, pin_memory=pin)
            ks_vals = vs_vals = dk_vals = dv_vals = None
            if quant:
                ks_vals = torch.zeros((*lead, nb), dtype=torch.float32, pin_memory=pin)
                vs_vals = torch.zeros(ks_vals.shape, dtype=torch.float32, pin_memory=pin)
            if self._draft_enabled:
                dshape = (*self._dk_pages.shape[:2], nb, ps, self._dk_pages.shape[-1])
                dk_vals = torch.zeros(dshape, dtype=self._dk_pages.dtype, pin_memory=pin)
                dv_vals = torch.zeros(dshape, dtype=self._dk_pages.dtype, pin_memory=pin)
            for i, (page, payload) in enumerate(burst):
                pk, pv, pks, pvs = payload[:4]
                pdk, pdv = tuple(payload[4:6]) or (None, None)
                idx[i] = page
                k_vals[:, :, i] = pk
                v_vals[:, :, i] = pv
                if quant:
                    ks_vals[:, :, i] = pks
                    vs_vals[:, :, i] = pvs
                if dk_vals is not None and pdk is not None:
                    dk_vals[:, :, i] = pdk
                    dv_vals[:, :, i] = pdv
            host = (k_vals, v_vals, ks_vals, vs_vals, dk_vals, dv_vals)
            dev = [None if x is None else x.to(self.device, non_blocking=True) for x in host]
            idx_d = self._tensor(idx)
            scatter_pages(self._k_pages, self._v_pages, idx_d, dev[0],
                          self._k_scales, self._v_scales, v_vals=dev[1], ks_vals=dev[2],
                          vs_vals=dev[3])
            if dk_vals is not None:
                # both pools: see _migrate_pages
                scatter_pages(self._dk_pages, self._dv_pages, idx_d, dev[4], v_vals=dev[5])
            if pin:
                event = torch.cuda.Event()
                event.record()
                self._fault_staging.append((event, host))
            self.kv_fault_dispatches += 1
        self.fault_in_seconds_total += time.monotonic() - t0

    def _draft_gather(self, idx: torch.Tensor) -> tuple:
        """The draft pools' half of a page payload: (draft k, draft v) of
        the pages ``idx``, or (None, None) without a draft model."""
        if not self._draft_enabled:
            return (None, None)
        dk, dv, _, _ = gather_pages(self._dk_pages, self._dv_pages, idx)
        return (dk, dv)

    def flush_kv_migrations(self) -> None:
        """Run migration boundaries until quiescent: every plannable
        writeback dispatched and landed (tests and measurements; serving
        makes progress step by step)."""
        if not self._kv_tier_on:
            return
        while self._migrate_pages():
            pass

    def export_kv_pages(self, hashes: list[bytes]) -> list[tuple[bytes, object]]:
        """Pack the KV payloads of ``hashes`` for a peer replica.  Host-tier
        copies serve directly; device-resident pages gather in migration
        bursts and are read back synchronously (the price of the handoff,
        charged to ``transfer_seconds_total``).  Hashes in neither tier are
        skipped: the importer recomputes that tail."""
        if not self._kv_tier_on or not hashes:
            return []
        t0 = time.monotonic()
        alloc = self._allocator
        out: list[tuple[bytes, object]] = []
        to_gather: list[tuple[bytes, int]] = []
        for h in hashes:
            payload = alloc.host_payload(h)
            if payload is not None:
                out.append((h, payload))
                continue
            page = alloc.device_page_of(h)
            if page is not None:
                to_gather.append((h, page))
        while to_gather:
            burst = to_gather[: self.kv_migrate_burst]
            to_gather = to_gather[self.kv_migrate_burst:]
            nb = _bucket(len(burst), self.kv_migrate_burst, minimum=1)
            idx = np.full((nb,), -1, dtype=np.int32)
            idx[: len(burst)] = [p for _, p in burst]
            idx_d = self._tensor(idx)
            bufs = gather_pages(self._k_pages, self._v_pages, idx_d,
                                self._k_scales, self._v_scales)
            # the draft pools too: the importer's draft KV must cover the prefix
            bufs = tuple(bufs) + self._draft_gather(idx_d)
            host = tuple(None if b is None else b.cpu() for b in bufs)
            out.extend((h, p) for (h, _), p in zip(burst, split_page_payloads(host, len(burst))))
        self.kv_pages_exported += len(out)
        self.transfer_seconds_total += time.monotonic() - t0
        return out

    def import_kv_pages(self, pages: list[tuple[bytes, object]]) -> int:
        """Admit transferred page payloads into the host tier (host-dict
        work: the device is untouched until an admission shares a hash and
        the fault-in scatter lands it).  Returns how many were stored."""
        if not self._kv_tier_on or not pages:
            return 0
        t0 = time.monotonic()
        stored = sum(bool(self._allocator.import_page(h, payload)) for h, payload in pages)
        self.kv_pages_imported += stored
        self.transfer_seconds_total += time.monotonic() - t0
        return stored

    def _register_full_pages(self, req: _Request) -> None:
        """Publish every prompt page prefill has completed so far: its KV is
        final, so identical prefixes admitted from now on skip it.  A page
        this admission claimed drops its claim once registered."""
        if not self.prefix_caching:
            return
        if not req.page_hashes:
            req.page_hashes = page_hashes(req.prompt, self.page_size)
        full = min(req.prefill_pos // self.page_size, len(req.page_hashes))
        while req.pages_registered < full:
            j = req.pages_registered
            self._allocator.register(req.page_hashes[j], req.pages[j])
            if req.claimed_hashes and req.claimed_hashes[0] == req.page_hashes[j]:
                req.claimed_hashes.pop(0)
                self._allocator.unclaim([req.page_hashes[j]])
            req.pages_registered = j + 1

    def _commit_first_now(self, others_running: bool) -> bool:
        """Whether a freshly prefilled row's first token commits with a host
        read now (best TTFT) instead of queueing on the device for the next
        burst: always in the n-gram spec modes (synchronous by design);
        under draft-model speculation whenever no plain-decode chain is live
        (its device state must not race a fresh commit); otherwise only with
        no chain live and no other row running."""
        if self.spec_ngram_k > 0:
            return True
        if self._draft_enabled:
            return self._chain is None
        return self._chain is None and not others_running

    def _head_need_hashes(self, req: _Request) -> tuple[int, list[bytes]]:
        """Total page need for ``req`` and the chain hashes of the prefix
        pages its admission may share (capped so at least one prompt token
        still runs through prefill).  A ring-bound prompt shares none: the
        ring runs from position 0 (it still registers its pages)."""
        need = pages_needed(
            min(len(req.prompt) + req.sampling.max_tokens, self.max_seq_len), self.page_size)
        hashes: list[bytes] = []
        if self.prefix_caching and not self._sp_eligible(req):
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
        req = self._waiting[0]
        need, hashes = self._head_need_hashes(req)
        rows_avail = bool(self._free_rows) or bool(self._deferred)
        extra = sum(self._allocator.releasable_count(pages) for _, pages, _ in self._deferred)
        return rows_avail and self._allocator.can_admit(
            hashes, need, extra_free=extra, headroom=self._class_headroom(req))

    def _try_prefill(self, finished: list[GenerationResult]) -> bool:
        """Admit every waiting request the pool can back, then run ONE
        batched prefill chunk over all prefilling rows.  Returns True if a
        chunk ran.  Free rows/pages are never referenced by an in-flight
        burst (finished rows wait in ``_deferred``), so the chain is drained
        only when the head of the queue needs those deferred resources."""
        if self._waiting:
            req0 = self._waiting[0]
            need0, hashes0 = self._head_need_hashes(req0)
            can_free = bool(self._free_rows) and self._allocator.can_admit(
                hashes0, need0, headroom=self._class_headroom(req0))
            if not can_free and self._admission_feasible():
                self._drain_chain(finished)
        cached_admits: list[_Request] = []
        while self._waiting and self._free_rows:
            req = self._waiting[0]
            need, hashes = self._head_need_hashes(req)
            if need > self.max_pages_per_seq:
                raise RuntimeError("intake clamp must bound the page need")
            if (req.priority != self.protected_priority and self._preempt_on
                    and self._class_pressure.get(self.protected_priority, 0) >= 2):
                # while the protected class burns critically, batch admission
                # pauses: every free page belongs to the class preempted for
                break
            if not self._allocator.can_admit(hashes, need, headroom=self._class_headroom(req)):
                break
            if self._kv_tier_on and hashes:
                pending = self._allocator.pending_claim_pages(hashes)
                if pending and self._allocator.plain_free_count < need:
                    # an identical prefix is mid-prefill on another row and
                    # pages are tight: wait for its registration instead of
                    # duplicating its footprint (its registration or release
                    # drops the claim)
                    self.dedup_holds += 1
                    break
            faults_before = self._allocator.fault_ins if self._kv_tier_on else 0
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
            self._obs_hold(req)
            if self._kv_tier_on:
                req.faulted_pages += self._allocator.fault_ins - faults_before
                claimed = hashes[len(shared):]
                if claimed:
                    # promise the pages this prefill will register, so
                    # identical-prefix followers can wait for one registration
                    self._allocator.claim(claimed)
                    req.claimed_hashes = list(claimed)
            # cache hit: prefill resumes after the shared pages' tokens
            req.cached_tokens = len(shared) * self.page_size
            req.prefill_pos = req.seq_len = req.cached_tokens
            req.pages_registered = len(shared)
            if shared:
                self._allocator.hit_tokens += req.cached_tokens
            if req.resume_pending:
                # a parked victim is back: its folded prompt shared the
                # full pages it parked (a device hit or a fault-in); prefill
                # recomputes only the partial tail page
                req.resume_pending = False
                self.preempt_resumes += 1
                if self._kv_tier_on:
                    self.resume_faulted_pages += self._allocator.fault_ins - faults_before
                kv_at_park = len(req.prompt) - 1  # KV the victim had parked
                self.resume_recomputed_tokens += max(0, kv_at_park - req.cached_tokens)
                self.resume_recomputed_prompt_tokens += max(
                    0, req.orig_prompt_len - req.cached_tokens)
            self._row_req[row] = req
            self._block_tables[row, : len(pages)] = pages
            self._seq_lens[row] = req.cached_tokens
            # a burst may never write past this row's pages nor the length cap
            self._row_limits[row] = min(len(pages) * self.page_size, self.max_seq_len - 1)
            self._set_row_sampling(row, req.sampling)
            if req.cached_tokens:
                cached_admits.append(req)
        if self._kv_tier_on:
            # scatter the fault-ins share() staged before any dispatch below
            # can read those pages
            self._dispatch_fault_ins()
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
        long_reqs = [r for r in prefilling if self._sp_eligible(r) and r.prefill_pos == 0]
        if long_reqs:
            if self.sp_ring_pack:
                # every waiting long prompt that fits shares one pass; the
                # rest keep their rows and ride the next step's pass
                self._sp_prefill_packed(long_reqs, finished)
            else:
                for req in long_reqs:
                    self._sp_prefill(req, finished)
            # served or not, a ring-bound row never takes a chunk: once a
            # chunk advanced it, it could not restart the ring from 0
            for req in long_reqs:
                prefilling.remove(req)
        if prefilling:
            self._prefill_batch(prefilling, finished)
        return True

    # ------------------------------------------------- sequence parallel --

    def is_longctx(self, prompt_len: int) -> bool:
        """Would a prompt of this length take the ring-prefill path?  The
        async driver puts such requests in the ``longctx`` SLO class by the
        same predicate the scheduler routes by."""
        return (self.sp_prefill_threshold is not None and not self._draft_enabled
                and self._sp > 1 and prompt_len >= self.sp_prefill_threshold)

    def _sp_eligible(self, req: _Request) -> bool:
        """Long prompts prefill in one ring pass; never under draft-model
        speculation, whose draft pools the ring would leave without the
        prompt."""
        return self.is_longctx(len(req.prompt))

    def sp_ring_bucket_ladder(self) -> list[int]:
        """The ring widths a pass can dispatch at: powers of two from the
        threshold's bucket up to bucketed ``max_seq_len``, each rounded up to
        a multiple of sp; ``sp_ring_buckets`` > 0 keeps that many from the
        widest down.  ``warmup`` runs every entry and ``_ring_width`` picks
        from the same list."""
        if self.sp_prefill_threshold is None or self._sp <= 1:
            return []
        floor = max(self.sp_prefill_threshold, self._sp, 1)
        w = 1
        while w < floor:
            w *= 2
        out: list[int] = []
        cap = _bucket(self.max_seq_len, self.max_seq_len, minimum=self._sp)
        while True:
            out.append(-(-min(w, cap) // self._sp) * self._sp)
            if w >= cap:
                break
            w *= 2
        out = list(dict.fromkeys(out))
        if self.sp_ring_pack and self.sp_ring_bucket_count > 0:
            out = out[-self.sp_ring_bucket_count:]
        return out

    def _ring_width(self, total: int) -> int:
        """The packed ring width for ``total`` real tokens: the smallest
        ladder entry covering it."""
        ladder = self.sp_ring_bucket_ladder()
        for w in ladder:
            if w >= total:
                return w
        return ladder[-1]

    def _ring_pass(self, fn, ids, pos, slots, *args) -> torch.Tensor:
        """Run ``ring_prefill`` or ``ring_prefill_packed`` over the engine's
        pools (updated in place) and return the logits."""
        self.step_dispatches_total += 1
        self.sp_prefills += 1
        self.dispatch_shapes.add(("ring", ids.shape[1]))
        t = self._tensor
        logits, *_ = fn(self.params, self.cfg, t(ids), t(pos), self._k_pages, self._v_pages,
                        t(slots[None]), *(t(a) for a in args), self.mesh,
                        k_scales=self._k_scales, v_scales=self._v_scales)
        return logits

    def _sp_prefill(self, req: _Request, finished: list[GenerationResult]) -> None:
        """One whole prompt in one ring pass (``long_prefill.ring_prefill``):
        every position's K/V goes to the row's pages, the first token
        samples from the last position's logits and joins the decode batch
        as a chunked completion's does."""
        others_running = any(r.state == "running" for r in self._row_req.values())
        n = len(req.prompt)
        width = _bucket(n, self.max_seq_len, minimum=self._sp)
        width = -(-width // self._sp) * self._sp
        ids = np.zeros((1, width), dtype=np.int32)
        ids[0, :n] = req.prompt
        pos = np.arange(width, dtype=np.int32)[None]
        slots = slot_mapping(self._block_tables[req.row], 0, n, self.page_size, width)
        logits = self._ring_pass(ring_prefill, ids, pos, slots,
                                 np.asarray([n - 1], dtype=np.int32))
        self._finish_ring([req], 1, logits, others_running, finished)

    def _sp_prefill_packed(self, reqs: list[_Request], finished: list[GenerationResult]) -> None:
        """Segment-packed ring pass: waiting long prompts back to back in a
        [1, width] buffer with per-token segment ids
        (``long_prefill.ring_prefill_packed``), front-packed in admission
        order up to the widest ladder width or the fixed segment-row count
        (first come, first served: packing stops at the first prompt that
        does not fit).  First tokens sample at each segment's last position
        in one call."""
        others_running = any(r.state == "running" for r in self._row_req.values())
        cap = self.sp_ring_bucket_ladder()[-1]
        rb = self.sp_ring_segs
        packed: list[_Request] = []
        total = 0
        for req in reqs:
            n = len(req.prompt)
            if packed and (len(packed) >= rb or total + n > cap):
                break
            packed.append(req)
            total += n
        width = self._ring_width(total)
        seg, pos, logits_at, starts = ring_segment_layout([len(r.prompt) for r in packed],
                                                          width, rb)
        ids = np.zeros((1, width), dtype=np.int32)
        slots = np.full((width,), -1, dtype=np.int32)
        for req, off in zip(packed, starts):
            n = len(req.prompt)
            ids[0, off: off + n] = req.prompt
            packed_slot_mapping(self._block_tables[req.row], 0, n, self.page_size, slots,
                                int(off))
        self.sp_ring_segments += len(packed)
        self.sp_ring_tokens += total
        self.sp_ring_padding += width - total
        logits = self._ring_pass(ring_prefill_packed, ids, pos[None], slots, seg[None],
                                 logits_at)
        self._finish_ring(packed, rb, logits, others_running, finished)

    def _finish_ring(self, reqs: list[_Request], rb: int, logits: torch.Tensor,
                     others_running: bool, finished: list[GenerationResult]) -> None:
        """A ring pass's bookkeeping, through the chunked path's: the whole
        prompts into the presence mask (one [rb, longest] call), each
        request's prefill complete and its full pages registered, first
        tokens sampled (committed now or queued for the next burst)."""
        longest = max(len(r.prompt) for r in reqs)
        ids = np.zeros((rb, longest), dtype=np.int32)
        lens = np.zeros((rb,), dtype=np.int32)
        row_idx = np.zeros((rb,), dtype=np.int32)
        for i, req in enumerate(reqs):
            ids[i, : len(req.prompt)] = req.prompt
            lens[i] = len(req.prompt)
            row_idx[i] = req.row
        self._finish_prefill_wave([(req, len(req.prompt)) for req in reqs], rb, row_idx,
                                  self._tensor(ids), self._tensor(lens), logits,
                                  others_running, finished)

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
        args = (ids_d, self._tensor(pos), self._tensor(slots), self._tensor(bt),
                self._tensor(cached), new_lens_d)
        last_d = self._tensor(last_idx)
        self.step_dispatches_total += 1
        self.dispatch_shapes.add(("prefill", rb, width))
        logits = self._run_prefill(forward_paged, *args, logits_at=last_d)
        self._draft_prefill(forward_paged, *args, logits_at=last_d)

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

    def _draft_prefill(self, fn, ids, pos, *args, **kwargs) -> None:
        """Under draft-model speculation, run the same chunk (same slots and
        block tables) through the draft into its pools, so drafting always
        has the whole prompt cached; the logits are not read."""
        if not self._draft_enabled:
            return
        self.step_dispatches_total += 1
        fn(self.draft_params, self.draft_cfg, ids, pos, self._dk_pages, self._dv_pages,
           *args, **kwargs)

    def _run_prefill(self, fn, ids, pos, *args, **kwargs) -> torch.Tensor:
        """Run ``forward_paged`` or ``forward_paged_packed`` over the
        engine's pools (and their scales when quantized), which update in
        place; returns the logits."""
        out = fn(self.params, self.cfg, ids, pos, self._k_pages, self._v_pages, *args,
                 k_scales=self._k_scales, v_scales=self._v_scales, mesh=self.mesh, **kwargs)
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
        if self._commit_first_now(others_running):
            # engine otherwise idle, or a spec mode: commit now (best TTFT)
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
        if self.fused_step_on and others_running:
            # decode rows are live: defer the wave into this step's fused
            # call (``_fused_step``), built at the fixed segment bucket; its
            # bookkeeping runs after that call
            self._fused_pf_wave = self._build_packed_wave(reqs, rb=self._fused_pf_segs)
            return
        meta = self._build_packed_wave(reqs)
        self.step_dispatches_total += 1
        self.dispatch_shapes.add(("packed", meta["rb"]))
        t = self._tensor
        args = (t(meta["ids"]), t(meta["pos"]), t(meta["slots"]), t(meta["bt"]),
                t(meta["cached"]), t(meta["new_lens"]), t(meta["seg"]), t(meta["last_idx"]),
                self.packed_chunk)
        logits = self._run_prefill(forward_paged_packed, *args)
        self._draft_prefill(forward_paged_packed, *args)
        self._finish_prefill_wave(meta["packed"], meta["rb"], meta["row_idx"],
                                  t(meta["seg_ids_2d"]), t(meta["new_lens"]), logits,
                                  others_running, finished)

    def _build_packed_wave(self, reqs: list[_Request], rb: int | None = None) -> dict:
        """Greedy-pack the prefilling rows' next chunks into the [budget]
        token buffer and build every host array the packed dispatch
        needs.  ``rb`` pins the segment-row bucket (the fused step's);
        None buckets the segment count."""
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
        if rb is None:
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
        filt = self._filter_sampling()
        self.dispatch_shapes.add(("decode", n_steps, filt))
        toks, _, self._k_pages, self._v_pages, self._presence, out_lens, *_ = decode_burst(
            self.params, self.cfg, last_d, lens_d, self._k_pages, self._v_pages,
            self._presence, self._tensor(active), self._tensor(self._row_limits),
            self._tensor(self._block_tables), self._gen,
            self._temp_d, self._top_p_d, self._top_k_d, self._rep_pen_d,
            n_steps=n_steps, filter_sampling=filt,
            k_scales=self._k_scales, v_scales=self._v_scales, mesh=self.mesh,
        )
        prev = self._chain
        self._chain = {"last": toks[:, -1], "lens": out_lens, "pending": toks,
                       "first": first_waves}
        if prev is not None:
            self._commit_burst(prev, finished)

    def _spec_window_rows(self, running: list[_Request]) -> dict:
        """The host arrays of a device-drafting call (spec burst, fused
        step) over the compacted running rows, padded to a row bucket:
        token histories [rb, max_seq_len], their lengths, cached lengths,
        block tables, row limits, activity, greedy-ness and engine rows."""
        rb = _bucket(len(running), self.max_num_seqs, minimum=1)
        h = self.max_seq_len
        out = {"rb": rb, "hist": np.zeros((rb, h), dtype=np.int32),
               "hlens": np.zeros((rb,), dtype=np.int32), "lens": np.zeros((rb,), dtype=np.int32),
               "bt": np.zeros((rb, self.max_pages_per_seq), dtype=np.int32),
               "limits": np.zeros((rb,), dtype=np.int32), "active": np.zeros((rb,), dtype=bool),
               "spec_ok": np.zeros((rb,), dtype=bool), "row_idx": np.zeros((rb,), dtype=np.int32)}
        for i, req in enumerate(running):
            toks = (req.prompt + req.output)[-h:]
            out["hist"][i, : len(toks)] = toks
            out["hlens"][i] = len(toks)
            out["lens"][i] = req.seq_len
            out["bt"][i] = self._block_tables[req.row]
            out["limits"][i] = self._row_limits[req.row]
            out["active"][i] = True
            out["spec_ok"][i] = (req.sampling.temperature <= 0.0
                                 and req.sampling.repetition_penalty == 1.0)
            out["row_idx"][i] = req.row
        return out

    def _commit_spec_block(self, running: list[_Request], toks_d: torch.Tensor,
                           prop_d: torch.Tensor, spec_ok: np.ndarray,
                           finished: list[GenerationResult]) -> None:
        """Read a device-drafting call's [rb, iters, k+1] token block and
        its [rb, iters] proposals in ONE transfer and commit them: per
        iteration a row commits its tokens up to the first -1; once a row
        stops, its later iterations (drafted past the stop) are discarded,
        proposals included."""
        rb, iters, width = toks_d.shape
        block = torch.cat([toks_d.reshape(rb, iters * width), prop_d], dim=1).cpu().numpy()
        toks = block[:, : iters * width].reshape(rb, iters, width)
        prop = block[:, iters * width:]
        for i, req in enumerate(running):
            for it in range(iters):
                if req.state != "running":
                    break
                self.spec_proposed += int(prop[i, it])
                committed = 0
                for t in toks[i, it]:
                    if t < 0 or req.state != "running":
                        break
                    req.seq_len += 1
                    self._seq_lens[req.row] = req.seq_len
                    self._commit_token(req, int(t), finished)
                    committed += 1
                if committed and spec_ok[i]:
                    # committed = agreed draft prefix + 1 correction token
                    self.spec_accepted += committed - 1

    def _spec_burst_step(self, finished: list[GenerationResult]) -> None:
        """``spec_burst_iters`` draft / verify / accept iterations in one
        call (serving/spec_burst.py), the device form of
        ``_spec_decode_step`` for all-plain-greedy batches; one read of the
        token block per call."""
        running = [r for r in self._row_req.values() if r.state == "running"]
        w = self._spec_window_rows(running)
        t = self._tensor
        self.step_dispatches_total += 1
        self.dispatch_shapes.add(("spec_burst", w["rb"]))
        toks_d, prop_d, *_ = spec_decode_burst(
            self.params, self.cfg, t(w["hist"]), t(w["hlens"]), t(w["lens"]),
            self._k_pages, self._v_pages, t(w["bt"]), t(w["limits"]), t(w["active"]),
            n_iters=self.spec_burst_iters, k=self.spec_ngram_k,
            k_scales=self._k_scales, v_scales=self._v_scales)
        self._commit_spec_block(running, toks_d, prop_d, w["spec_ok"], finished)

    def _fused_step(self, finished: list[GenerationResult]) -> None:
        """One call for the whole step (serving/fused_step.py): the packed
        prefill wave ``_prefill_batch_packed`` deferred (if any), then
        ``spec_burst_iters`` mixed iterations: greedy rows draft, verify and
        accept as ``_spec_burst_step`` does, sampled rows draw one token an
        iteration from the same forward.  The deferred wave's bookkeeping
        runs on the returned prefill logits, so rows that finish prefill
        join the next step's burst."""
        running = [r for r in self._row_req.values() if r.state == "running"]
        w = self._spec_window_rows(running)
        t = self._tensor
        pf_wave, self._fused_pf_wave = self._fused_pf_wave, None
        has_prefill = pf_wave is not None
        pf = ((t(pf_wave["ids"]), t(pf_wave["pos"]), t(pf_wave["slots"]), t(pf_wave["bt"]),
               t(pf_wave["cached"]), t(pf_wave["new_lens"]), t(pf_wave["seg"]),
               t(pf_wave["last_idx"])) if has_prefill else (None,) * 8)
        self._push_sampling()
        row_d = t(w["row_idx"])
        rows_l = row_d.long()
        self.fused_steps_total += 1
        self.step_dispatches_total += 1
        self.dispatch_shapes.add(("fused", w["rb"], has_prefill, self._filter_sampling()))
        toks_d, prop_d, pf_logits, *_ = fused_step_burst(
            self.params, self.cfg, t(w["hist"]), t(w["hlens"]), t(w["lens"]),
            self._k_pages, self._v_pages, t(w["bt"]), t(w["limits"]), t(w["active"]),
            t(w["spec_ok"]), row_d, self._presence, self._gen,
            self._temp_d[rows_l], self._top_p_d[rows_l], self._top_k_d[rows_l],
            self._rep_pen_d[rows_l], *pf,
            n_iters=self.spec_burst_iters, k=self.spec_ngram_k, tq=self.packed_chunk,
            filter_sampling=self._filter_sampling(), has_prefill=has_prefill,
            k_scales=self._k_scales, v_scales=self._v_scales)
        if has_prefill:
            # presence marks, advance, first tokens (committed now: spec
            # modes commit synchronously)
            self._finish_prefill_wave(pf_wave["packed"], pf_wave["rb"], pf_wave["row_idx"],
                                      t(pf_wave["seg_ids_2d"]), t(pf_wave["new_lens"]),
                                      pf_logits, True, finished)
        self._commit_spec_block(running, toks_d, prop_d, w["spec_ok"], finished)

    # ------------------------------------------- draft-model speculation --

    def _spec_capable(self, req: _Request) -> bool:
        """Whether this request may ride the draft burst this step.
        Sampling rows are ineligible (greedy only); acceptance collapse and
        deadline pressure demote the request for good, counted once."""
        if req.spec_fallback is not None:
            return False
        sp = req.sampling
        if sp.temperature > 0.0 or sp.repetition_penalty != 1.0:
            return False
        if req.spec_accept_ema is not None and req.spec_accept_ema < self.spec_accept_floor:
            self._mark_fallback(req, "acceptance")
            return False
        if req.deadline_ts is not None and (
                req.deadline_ts - time.monotonic() < self.spec_deadline_margin_s):
            # plain decode stops at a finer grain than a spec_iters x (k+1)
            # token dispatch: never spend the last of a deadline on tokens
            # the caller will throw away
            self._mark_fallback(req, "deadline")
            return False
        return True

    def _mark_fallback(self, req: _Request, reason: str) -> None:
        req.spec_fallback = reason
        self.spec_fallbacks[reason] = self.spec_fallbacks.get(reason, 0) + 1

    def _pick_spec_k(self, running: list[_Request]) -> int:
        """The draft length: spec_k scaled by the batch's mean EMA
        acceptance, snapped up to the ladder (a batch with no history starts
        at the top rung)."""
        emas = [r.spec_accept_ema for r in running if r.spec_accept_ema is not None]
        if not emas:
            return self._spec_k_ladder[-1]
        want = max(1, round((sum(emas) / len(emas)) * self.spec_k))
        for rung in self._spec_k_ladder:
            if rung >= want:
                return rung
        return self._spec_k_ladder[-1]

    def _draft_spec_step(self, finished: list[GenerationResult]) -> None:
        """One draft-model dispatch (serving/draft_spec.py): ``spec_iters``
        draft / verify / accept rounds at the controller's k, and ONE host
        read of the [rb, iters, k+1] token block and its proposals.
        Synchronous, like the n-gram burst."""
        if self._chain is not None or self._pending_first:
            # a plain-decode chain (a mixed or fallback step) is in flight:
            # land it so the snapshot below sees every committed token
            self._drain_chain(finished)
        running = [r for r in self._row_req.values() if r.state == "running"]
        if not running:
            return
        k = self._pick_spec_k(running)
        w = self._spec_window_rows(running)
        t = self._tensor
        self.step_dispatches_total += 1
        self.dispatch_shapes.add(("draft", w["rb"], k))
        toks_d, prop_d, *_ = draft_spec_burst(
            self.params, self.draft_params, self.cfg, self.draft_cfg,
            t(w["hist"]), t(w["hlens"]), t(w["lens"]), self._k_pages, self._v_pages,
            self._dk_pages, self._dv_pages, t(w["bt"]), t(w["limits"]), t(w["active"]),
            n_iters=self.spec_iters, k=k, k_scales=self._k_scales, v_scales=self._v_scales)
        rb, iters, width = toks_d.shape
        block = torch.cat([toks_d.reshape(rb, iters * width), prop_d], dim=1).cpu().numpy()
        toks = block[:, : iters * width].reshape(rb, iters, width)
        prop = block[:, iters * width:]
        for i, req in enumerate(running):
            proposed = accepted = 0
            for it in range(iters):
                if req.state != "running":
                    break  # the device drafted past this row's stop; discard
                p_it = int(prop[i, it])
                proposed += p_it
                req.spec_proposed_req += p_it
                committed = 0
                for tok in toks[i, it]:
                    if tok < 0 or req.state != "running":
                        break
                    if committed:
                        # tokens 2..n of an iteration are accepted drafts,
                        # counted before the commit that may finish the request
                        accepted += 1
                        req.spec_accepted_req += 1
                    req.seq_len += 1
                    self._seq_lens[req.row] = req.seq_len
                    self._commit_token(req, int(tok), finished)
                    committed += 1
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            if proposed:
                rate = accepted / proposed
                req.spec_accept_ema = (rate if req.spec_accept_ema is None
                                       else 0.3 * rate + 0.7 * req.spec_accept_ema)

    def _spec_decode_step(self, finished: list[GenerationResult]) -> None:
        """One speculative iteration drafted on the host
        (serving/spec_decode.py): plain-greedy rows (temperature 0, no
        repetition penalty) get an n-gram draft of up to ``spec_ngram_k``
        tokens; ONE paged forward over [last token, draft...] verifies every
        row, and each row commits its longest model-agreed prefix plus the
        model's correction token.  Rows with sampling or a penalty commit
        one token from the standard sampler.  Synchronous: the verify
        logits are read at once."""
        k = self.spec_ngram_k
        width = k + 1
        vocab = self.cfg.vocab_size
        running = [r for r in self._row_req.values() if r.state == "running"]
        rb = _bucket(len(running), self.max_num_seqs, minimum=1)
        ids = np.zeros((rb, width), dtype=np.int32)
        pos = np.zeros((rb, width), dtype=np.int32)
        slots = np.full((rb, width), -1, dtype=np.int32)
        bt = np.zeros((rb, self.max_pages_per_seq), dtype=np.int32)
        cached = np.zeros((rb,), dtype=np.int32)
        new_lens = np.zeros((rb,), dtype=np.int32)
        drafts: list[list[int]] = []
        plain_greedy: list[bool] = []
        for i, req in enumerate(running):
            sp = req.sampling
            eligible = sp.temperature <= 0.0 and sp.repetition_penalty == 1.0
            plain_greedy.append(eligible)
            draft: list[int] = []
            if eligible:
                cap = min(k, int(self._row_limits[req.row]) - req.seq_len - 1,
                          sp.max_tokens - len(req.output) - 1)
                if cap > 0:
                    draft = ngram_propose(req.prompt + req.output, cap)
            drafts.append(draft)
            self.spec_proposed += len(draft)
            n_new = 1 + len(draft)
            ids[i, 0] = req.output[-1] if req.output else req.prompt[-1]
            ids[i, 1:n_new] = draft
            pos[i] = np.arange(req.seq_len, req.seq_len + width)
            slots[i] = slot_mapping(self._block_tables[req.row], req.seq_len, n_new,
                                    self.page_size, width)
            bt[i] = self._block_tables[req.row]
            cached[i] = req.seq_len
            new_lens[i] = n_new

        t = self._tensor
        self.step_dispatches_total += 1
        self.dispatch_shapes.add(("spec", rb))
        # every position's logits, [rb, k+1, V]: verification reads them all
        logits = self._run_prefill(forward_paged, t(ids), t(pos), t(slots), t(bt), t(cached),
                                   t(new_lens))
        row_idx = np.zeros((rb,), dtype=np.int32)
        row_idx[: len(running)] = [r.row for r in running]
        row_d = t(row_idx)
        greedy_toks = torch.argmax(logits, dim=-1).cpu().numpy()  # [rb, width]
        sampled0 = None
        if not all(plain_greedy):
            self._push_sampling()
            rows_l = row_d.long()
            sampled0 = sample_tokens(
                logits, self._gen, self._temp_d[rows_l], self._top_p_d[rows_l],
                self._top_k_d[rows_l], self._rep_pen_d[rows_l], self._presence[rows_l, :vocab],
            ).cpu().numpy()

        # the committed tokens, padded with the drop column -> one presence mark
        committed = np.full((rb, width), vocab, dtype=np.int32)
        counts = np.zeros((rb,), dtype=np.int32)
        for i, req in enumerate(running):
            if plain_greedy[i]:
                draft = drafts[i]
                a = 0
                while a < len(draft) and greedy_toks[i, a] == draft[a]:
                    a += 1
                toks = [int(x) for x in greedy_toks[i, : a + 1]]
            else:
                a = 0
                toks = [int(sampled0[i])]
            for j, tok in enumerate(toks):
                req.seq_len += 1
                self._seq_lens[req.row] = req.seq_len
                committed[i, counts[i]] = tok
                counts[i] += 1
                if j < a:  # an accepted draft token that committed
                    self.spec_accepted += 1
                self._commit_token(req, tok, finished)
                if req.state != "running":
                    break
        self._mark_presence_chunks(row_d, t(committed), t(counts))

    def _filter_sampling(self) -> bool:
        """The sampler variant of a burst: sort-free whenever no sampling
        row filters (greedy rows take the exact argmax whatever their
        top_p / top_k; free rows are reset at release)."""
        return bool(np.any((self._temp > 0.0) & ((self._top_p < 1.0) | (self._top_k > 0))))

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
        for row, pages, rid in self._deferred:
            self._allocator.release(pages)
            self._obs_release(rid)
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
        if req.claimed_hashes:
            # an unfinished prefill abandons its registration promises, so
            # held followers are not stranded
            self._allocator.unclaim(req.claimed_hashes)
            req.claimed_hashes = []
        if req.row >= 0:
            if self._chain is not None:
                # an in-flight burst still reads this row's pages
                self._deferred.append((req.row, req.pages, req.request_id))
            else:
                self._allocator.release(req.pages)
                self._obs_release(req.request_id)
                self._free_rows.append(req.row)
            self._row_req.pop(req.row, None)
            self._clear_row(req.row)
            req.row = -1
        req.state = "done"

    def _clear_row(self, row: int) -> None:
        """Empty a row's host state.  The sampling mirrors go back to the
        no-filter defaults so a free row never pins bursts onto the filtered
        sampler (the device copy of a free row is never read; reassignment
        re-dirties)."""
        self._seq_lens[row] = 0
        self._block_tables[row] = 0
        self._row_limits[row] = 0
        self._temp[row] = 1.0
        self._top_p[row] = 1.0
        self._top_k[row] = 0
        self._rep_pen[row] = 1.0

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
        # a parked request folded its output into its prompt: report the
        # caller's prompt and the whole output stream
        output = req.prior_output + req.output if req.prior_output else req.output
        prompt = req.prompt
        if req.orig_prompt_len and req.orig_prompt_len < len(req.prompt):
            prompt = req.prompt[: req.orig_prompt_len]
        return GenerationResult(
            request_id=req.request_id,
            prompt_tokens=prompt,
            output_tokens=output,
            finish_reason=reason,
            ttft_s=ttft,
            decode_time_s=(done_t - req.first_token_t) if req.first_token_t else 0.0,
            timings={
                "submit_t": req.submit_t,
                "prefill_start_t": req.prefill_start_t,
                "first_token_t": req.first_token_t,
                "done_t": done_t,
            },
            spec_proposed=req.spec_proposed_req,
            spec_accepted=req.spec_accepted_req,
            spec_fallback=req.spec_fallback,
            faulted_pages=req.faulted_pages,
            preempted=req.preempted,
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
        """Build the kernels and touch every shape live traffic takes, through
        the public step loop, as the JAX engine's warmup does: prefill at
        each (row bucket x dispatch width) -- packed: each segment bucket --,
        a greedy and a sampled decode burst (in a spec mode, the spec paths
        instead); under draft-model speculation the plain-decode fallback
        and every (k rung x row bucket) of the draft burst; one prompt at each
        ring width of ``sp_ring_bucket_ladder`` on an sp mesh; then each
        fused-step variant and each migration burst size when those modes
        are on.  It leaves the engine state clean.  Each wave's prompt holds
        another token, so no wave resumes from an earlier one's cached
        pages.  What it runs is what the compile watchdog
        (obs/engine_profile.py) counts as warm: each kernel's launch plan
        at these shapes."""
        if self.device.type == "cuda":
            from githubrepostorag_tpu_torch import kernels

            kernels.build()
        buckets = self._row_buckets()
        sp = SamplingParams(max_tokens=2, temperature=0.0)
        wave = 0

        def tok() -> int:
            return 2 + wave % max(2, self.cfg.vocab_size - 2)

        ring = self.sp_prefill_threshold is not None and self._sp > 1

        def long_len(nb: int, cap: int) -> int:
            # one long prompt and nb - 1 short ones that fit the pool
            # together, below the ring's threshold: these waves warm the
            # chunked shapes, the ring's are warmed by width below
            short_pages = pages_needed(3 + sp.max_tokens, self.page_size)
            budget = (self._allocator.num_pages - (nb - 1) * short_pages) * self.page_size
            n = min(cap, self.max_seq_len - 3, budget - sp.max_tokens)
            return min(n, self.sp_prefill_threshold - 1) if ring else n

        if self.prefill_token_budget is not None:
            for nb in self.packed_prefill_buckets():
                plen = long_len(nb, self.prefill_chunk)
                if plen <= 0:
                    continue  # no live wave can hold nb rows either
                wave += 1
                self.generate([[tok()] * plen] + [[tok()] * 3] * (nb - 1), sp)
        seen: set[tuple[int, int]] = set()  # (row bucket, width) dispatched
        for nb in buckets if self.prefill_token_budget is None else []:
            for w in self.prefill_width_buckets:
                plen = long_len(nb, w)
                if plen <= 0:
                    continue
                dw = self._dispatch_width(min(plen, self.prefill_chunk))
                if (nb, dw) in seen:
                    continue
                seen.add((nb, dw))
                wave += 1
                self.generate([[tok()] * plen] + [[tok()] * 3] * (nb - 1), sp)
        wave += 1
        self.generate([[tok()] * 3], SamplingParams(max_tokens=2, temperature=0.7, top_p=0.9))
        # one prompt a ring width: the packed pass's per-segment arrays are
        # always sp_ring_segs rows, so one segment warms each width
        for width in self.sp_ring_bucket_ladder() if ring else []:
            n = min(width, self.max_seq_len - 2)
            if n >= self.sp_prefill_threshold:
                self.generate([[1] * n], sp)
        if self._draft_enabled:
            # the plain-decode fallback (the greedy waves above rode the
            # draft burst), then the whole ladder with an all-False active,
            # which writes only the drop pages
            wave += 1
            self._force_plain = True
            try:
                self.generate([[tok()] * 3], sp)
            finally:
                self._force_plain = False
            self._warm_draft_ladder(buckets)
        if self.fused_step_on:
            self._warm_fused_variants()
        if self._kv_tier_on:
            self._warm_migrations()
        logger.info("engine warmup complete (%d prefill row buckets)", len(buckets))

    def _warm_draft_ladder(self, buckets: list[int]) -> None:
        """Run the draft burst at every (k rung x row bucket): all-False
        ``active`` masks every commit, history write and real KV write."""
        dev, h, mp = self.device, self.max_seq_len, self.max_pages_per_seq
        for kk in self._spec_k_ladder:
            for nb in buckets:
                self.dispatch_shapes.add(("draft", nb, kk))
                zeros = [torch.zeros(shape, dtype=torch.int32, device=dev)
                         for shape in ((nb, h), (nb,), (nb,))]
                draft_spec_burst(
                    self.params, self.draft_params, self.cfg, self.draft_cfg, *zeros,
                    self._k_pages, self._v_pages, self._dk_pages, self._dv_pages,
                    torch.zeros((nb, mp), dtype=torch.int32, device=dev),
                    torch.zeros((nb,), dtype=torch.int32, device=dev),
                    torch.zeros((nb,), dtype=torch.bool, device=dev),
                    n_iters=self.spec_iters, k=kk,
                    k_scales=self._k_scales, v_scales=self._v_scales)

    def _row_buckets(self) -> list[int]:
        out, b = [], 1
        while True:
            out.append(min(b, self.max_num_seqs))
            if b >= self.max_num_seqs:
                return out
            b *= 2

    def _warm_fused_variants(self) -> None:
        """Run every fused-step variant live traffic can take once: (row
        bucket) x (has_prefill) x (filter_sampling).  An all-False
        ``active`` masks every KV write, history write and presence mark,
        and the prefill phase's all -1 slots write only the drop page, so
        each call leaves the pools' real pages as they were."""
        self._push_sampling()
        dev = self.device
        h, budget, pfseg = self.max_seq_len, self.prefill_token_budget, self._fused_pf_segs
        mp = self.max_pages_per_seq

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        pf_warm = (zeros(1, budget), zeros(1, budget),
                   torch.full((budget,), -1, dtype=torch.int32, device=dev), zeros(pfseg, mp),
                   zeros(pfseg), zeros(pfseg),
                   torch.full((budget,), pfseg, dtype=torch.int32, device=dev), zeros(pfseg))
        for nb in self._row_buckets():
            rows = zeros(nb).long()
            for has_pf in (False, True):
                for filt in (False, True):
                    self.dispatch_shapes.add(("fused", nb, has_pf, filt))
                    fused_step_burst(
                        self.params, self.cfg, zeros(nb, h), zeros(nb), zeros(nb),
                        self._k_pages, self._v_pages, zeros(nb, mp), zeros(nb),
                        zeros(nb, dtype=torch.bool), zeros(nb, dtype=torch.bool),
                        rows.to(torch.int32), self._presence, self._gen, self._temp_d[rows],
                        self._top_p_d[rows], self._top_k_d[rows], self._rep_pen_d[rows],
                        *(pf_warm if has_pf else (None,) * 8),
                        n_iters=self.spec_burst_iters, k=self.spec_ngram_k, tq=self.packed_chunk,
                        filter_sampling=filt, has_prefill=has_pf,
                        k_scales=self._k_scales, v_scales=self._v_scales)

    def _warm_migrations(self) -> None:
        """Run a gather and a scatter at every migration burst size, over the
        draft pools too.  All -1 indices make the scatters write only the
        drop page and the gathers read page 0."""
        ps, hd = self.page_size, self._k_pages.shape[-1]
        lead = (self.cfg.num_layers, self.cfg.num_kv_heads)
        quant = self._k_scales is not None
        for nb in migrate_buckets(self.kv_migrate_burst):
            idx = torch.full((nb,), -1, dtype=torch.int32, device=self.device)
            gather_pages(self._k_pages, self._v_pages, idx, self._k_scales, self._v_scales)
            zk = torch.zeros((*lead, nb, ps, hd), dtype=self._k_pages.dtype, device=self.device)
            zs = torch.zeros((*lead, nb), dtype=torch.float32, device=self.device) if quant else None
            scatter_pages(self._k_pages, self._v_pages, idx, zk, self._k_scales, self._v_scales,
                          v_vals=zk, ks_vals=zs, vs_vals=zs)
            if self._draft_enabled:
                self._draft_gather(idx)
                dk = self._dk_pages
                zd = torch.zeros((*dk.shape[:2], nb, ps, dk.shape[-1]), dtype=dk.dtype,
                                 device=self.device)
                scatter_pages(self._dk_pages, self._dv_pages, idx, zd, v_vals=zd)

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


def _check_mesh(mesh, cfg: Qwen2Config, modes: dict[str, bool]) -> None:
    """Refuse what a mesh engine does not serve yet, before anything is
    built: dp and pp axes, the modes of ROADMAP queue 1 item 8.6, a tp that
    splits a head (JAX's check and message)."""
    if mesh.shape["pp"] > 1:
        raise NotImplementedError("an engine mesh takes tp / sp / ep axes: pp is a training "
                                  "axis (ROADMAP queue 1 item 8.4)")
    if mesh.shape["dp"] > 1:
        raise NotImplementedError("dp x tp fleets are ROADMAP queue 1 item 8.6; dp alone is "
                                  "served as engine replicas (serving/multi_engine.py)")
    refused = [name for name, on in modes.items() if on]
    if refused:
        raise NotImplementedError(
            f"{', '.join(refused)} on a mesh: ROADMAP queue 1 item 8.6 brings the engine "
            "modes to tp / sp / ep meshes; a mesh engine serves the default mode, "
            "int8 / int4 pages and weights, and packed prefill")
    tp = mesh.shape["tp"]
    if tp > 1 and (cfg.num_kv_heads % tp or cfg.num_heads % tp):
        raise ValueError(
            f"tp={tp} must divide num_heads={cfg.num_heads} and "
            f"num_kv_heads={cfg.num_kv_heads}; use plan_for_devices("
            "..., num_heads=..., num_kv_heads=..., role='serve')")


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
