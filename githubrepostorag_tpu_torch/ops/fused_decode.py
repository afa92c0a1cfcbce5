"""Prefill-window paged attention (kernel A); port of
``githubrepostorag_tpu/ops/fused_decode.py::fused_window_attention`` (:171),
``fused_paged_attention`` (:246) and ``fused_packed_attention`` (:259),
over full-precision, int8 and int4 pools.

Every row scores an S-token query window based at ``cached_lens[b]``
against its block-table pages: causal mask ``kv_pos <= cached + t``,
validity ``kv_pos < cached + new``.  Masked scores are -1e30, a row with no
valid KV outputs 0, and scores and accumulators are float32.  Quantized
pools (int8 codes, or uint8 ``pack_int4`` nibble planes of half the head
width) carry one f32 scale per (kv head, page): a key's score is scaled by
its page's ``k_scales`` entry and a value row by its ``v_scales`` entry, in
float32, as the TPU kernel applies them.

``fused_window_attention`` launches the hand-written Hopper kernel
``csrc/fused_window_attention.cu`` for CUDA tensors and runs
``fused_window_attention_ref``, the plain PyTorch version, for CPU tensors.
On the card the route follows q's dtype (``_plan_window``): bf16 queries
run the tensor-core body (``csrc/prefill_attention.cuh``), f32 queries the
CUDA-core checking body (``csrc/window_attention.cuh``); a shape the plan
refuses raises before any launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from githubrepostorag_tpu_torch import kernels
from githubrepostorag_tpu_torch.device import sm_count
from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# pool element codes of the C entry points (csrc/common.cuh)
POOL_CODES = {"fp": 0, "int8": 1, "int4": 2}

# the two block bodies' geometry: csrc/prefill_attention.cuh (tensor cores,
# bf16 queries) and csrc/window_attention.cuh (CUDA cores, f32 queries)
WINDOW_TILE_KEYS = 64  # keys per ring stage of the tensor-core body
WINDOW_STAGES = {"fp": 4, "int8": 3, "int4": 3}  # its ring depth by pool branch
WINDOW_WIDE_STAGES = 4  # quantized pools: bf16 stages the loader warpgroup widens into
# two consumer warpgroups and two loader warpgroups at up to 128 registers a thread
_WGMMA_ROWS, _WGMMA_THREADS, _WGMMA_REGS = 128, 512, 128
_FMA_ROWS, _FMA_THREADS, _FMA_KEYS = 64, 256, 32
# an H100 SM's threads and registers, and a block's shared memory
_SM_THREADS, _SM_REGS, _SM_SMEM = 2048, 65536, 232448


class WindowPlan(NamedTuple):
    route: str  # "wgmma" (bf16 queries, tensor cores) or "fma" (f32 queries, CUDA cores)
    rows_per_block: int  # flat (window position, group member) rows of one kv head
    grid: tuple[int, int, int]  # (row tiles, n_kv, B or R)
    longest_first: bool  # grid.x runs the row tiles in reverse: longest causal walk first
    stages: int  # K/V ring depth (the CUDA-core body has none)
    smem_bytes: int  # dynamic shared memory a block
    blocks_per_sm: int
    waves: float  # blocks over what the card holds at once


@functools.lru_cache(maxsize=4096)
def _plan_window(b: int, s: int, n_q: int, n_kv: int, hd: int, page_size: int,
                 n_sm: int = 132, route: str = "wgmma", pool: str = "fp") -> WindowPlan:
    """Kernels A's and C's launch from static shapes only: ``b`` rows (A)
    or segments (C), ``s`` window positions (A's S, C's tq), heads, head
    dim, page size, SM count, the route (q's dtype) and the pool branch.
    No row length is read: a tile past a row's real tokens exits on the
    card.  Raises on what the kernels do not take: head dims other than 64
    and 128, n_q not a multiple of n_kv, page sizes that are neither a
    multiple of 64 nor a multiple of 8 dividing 64 (a ring stage holds 64
    keys of whole pages, as kernel B's), an unknown route or pool.

    wgmma: 128 rows a block (two consumer warpgroups of 64), one block an
    SM (512 threads at up to 128 registers fill its register file), a ring
    of ``WINDOW_STAGES[pool]`` stages of 64 K and 64 V rows as the pool holds them,
    the block's q rows, and for quantized pools ``WINDOW_WIDE_STAGES`` bf16
    stages that the loader warpgroup widens the codes into.  fma: 64 rows a block, f32 tiles of q, 32 keys and the
    probabilities; blocks an SM by shared memory."""
    t = WINDOW_TILE_KEYS
    _require_plan(route in ("wgmma", "fma"), f"route {route!r}")
    _require_plan(pool in POOL_CODES, f"pool {pool!r}")
    _require_plan(hd in _HEAD_DIMS, f"head_dim {hd} not in {_HEAD_DIMS}")
    _require_plan(n_kv >= 1 and n_q >= n_kv and n_q % n_kv == 0,
                  f"n_q {n_q} not a multiple of n_kv {n_kv}")
    _require_plan(page_size > 0 and (page_size % t == 0 or (t % page_size == 0
                                                            and page_size % 8 == 0)),
                  f"page size {page_size}: a multiple of {t}, or 8..{t} dividing {t}")
    _require_plan(b >= 0 and s >= 1, f"B {b}, S {s}")
    rows_total = (n_q // n_kv) * s
    if route == "wgmma":
        rows, stages = _WGMMA_ROWS, WINDOW_STAGES[pool]
        row_bytes = {"fp": 2 * hd, "int8": hd, "int4": hd // 2}[pool]
        widened = 0 if pool == "fp" else WINDOW_WIDE_STAGES * 2 * t * 2 * hd
        smem = 1024 + stages * 2 * t * row_bytes + rows * hd * 2 + widened
        per_sm = _SM_REGS // (_WGMMA_THREADS * _WGMMA_REGS)
    else:
        rows, stages = _FMA_ROWS, 0
        kt = _FMA_KEYS
        smem = 4 * (rows * (hd + 1) + kt * (hd + 1) + kt * hd + rows * (kt + 1) + kt)
        per_sm = min(_SM_THREADS // _FMA_THREADS, _SM_SMEM // smem)
    grid = (-(-rows_total // rows), n_kv, b)
    blocks = grid[0] * grid[1] * grid[2]
    return WindowPlan(route, rows, grid, route == "wgmma", stages, smem, per_sm,
                      blocks / (n_sm * per_sm))


def _require_plan(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"_plan_window: {msg}")


def fused_window_attention_ref(q_win, k_pages, v_pages, block_tables, cached_lens,
                               new_lens, k_scales=None, v_scales=None):
    """Plain PyTorch version of kernel A: gather the pages (quantized ones
    dequantized in float32), mask, softmax in float32, round only the
    output.  Same contract and output dtype as ``fused_window_attention``."""
    b, s, n_q, hd = q_win.shape
    k, v = gather_kv(k_pages, v_pages, block_tables, k_scales, v_scales,
                     dtype=torch.float32)  # [B, T, n_kv, hd]
    t, n_kv = k.shape[1], k.shape[2]
    group = n_q // n_kv
    dev = q_win.device

    qg = q_win.reshape(b, s, n_kv, group, hd).float()
    scores = torch.einsum("bsngh,btnh->bngst", qg, k.float()) * (1.0 / hd ** 0.5)
    cached = cached_lens.to(dev).long()
    total = cached + new_lens.to(dev).long()
    kv_pos = torch.arange(t, device=dev)
    q_pos = cached[:, None] + torch.arange(s, device=dev)  # [B, S]
    valid = (kv_pos[None, None, :] <= q_pos[:, :, None]) & (
        kv_pos[None, None, :] < total[:, None, None])  # [B, S, T]
    valid = valid[:, None, None]  # [B, 1, 1, S, T]
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.where(valid, torch.exp(scores - scores.amax(dim=-1, keepdim=True)), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bngst,btnh->bsngh", p / torch.where(denom == 0, 1.0, denom),
                       v.float())
    return out.reshape(b, s, n_q, hd).to(q_win.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_window_attention: {msg}")


def fused_window_attention(q_win, k_pages, v_pages, block_tables, cached_lens, new_lens,
                           k_scales=None, v_scales=None):
    """q_win [B, S, n_q, hd]; k_pages/v_pages [n_kv, P, page_size, hd] (one
    layer's pool; int8, or uint8 [.., hd // 2] nibble planes, when
    quantized); block_tables [B, max_pages] int32; cached_lens, new_lens
    [B] int32 (the new tokens are already committed); k_scales/v_scales
    [n_kv, P] f32 per-page scales of quantized pools, else None.  Returns
    [B, S, n_q, hd] in q_win.dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if q_win.device.type == "cpu":
        return fused_window_attention_ref(q_win, k_pages, v_pages, block_tables,
                                          cached_lens, new_lens, k_scales, v_scales)
    _require(q_win.device.type == "cuda", f"unsupported device {q_win.device}")
    kind = "fp" if k_scales is None else ("int4" if k_pages.dtype == torch.uint8 else "int8")
    tensors = [q_win, k_pages, v_pages, block_tables, cached_lens, new_lens]
    if kind != "fp":
        _require(v_scales is not None, "k_scales without v_scales")
        tensors += [k_scales, v_scales]
    _require(all(x.device == q_win.device for x in tensors),
             "all operands must be on one device")
    _require(all(x.is_contiguous() for x in tensors), "operands must be contiguous")
    _require(q_win.dim() == 4 and k_pages.dim() == 4, "q [B,S,n_q,hd], pools [n_kv,P,ps,hd]")
    b, s, n_q, hd = q_win.shape
    n_kv, num_pages, page_size, hd_pool = k_pages.shape
    _require(v_pages.shape == k_pages.shape and v_pages.dtype == k_pages.dtype,
             "k/v pools differ")
    _require(hd in _HEAD_DIMS and hd_pool == (hd // 2 if kind == "int4" else hd),
             f"head_dim {hd} (pool {hd_pool}, {kind}) not in {_HEAD_DIMS}")
    _require(n_q % n_kv == 0, f"n_q {n_q} not a multiple of n_kv {n_kv}")
    pool_dtype = {"fp": q_win.dtype, "int8": torch.int8, "int4": torch.uint8}[kind]
    _require(q_win.dtype in _DTYPES and k_pages.dtype == pool_dtype,
             f"q/pool dtypes {q_win.dtype}/{k_pages.dtype}; need q bf16 or f32 and "
             "pools of q's dtype, int8 or uint8 (int4)")
    if kind != "fp":
        _require(all(x.shape == (n_kv, num_pages) and x.dtype == torch.float32
                     for x in (k_scales, v_scales)), "scales must be [n_kv, P] f32")
    _require(block_tables.dim() == 2 and block_tables.shape[0] == b
             and block_tables.dtype == torch.int32, "block_tables must be [B, max_pages] int32")
    _require(cached_lens.shape == (b,) and new_lens.shape == (b,)
             and cached_lens.dtype == torch.int32 and new_lens.dtype == torch.int32,
             "cached_lens / new_lens must be [B] int32")
    _require(all(x.data_ptr() % 16 == 0 for x in (q_win, k_pages, v_pages)),
             "q and pools must be 16-byte aligned")
    _plan_window(b, s, n_q, n_kv, hd, page_size, sm_count(q_win.device),
                 route="wgmma" if q_win.dtype == torch.bfloat16 else "fma", pool=kind)
    out = torch.empty_like(q_win)
    stream = torch.cuda.current_stream(q_win.device).cuda_stream
    err = kernels.launcher("fused_window_attention")(
        q_win.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), cached_lens.data_ptr(), new_lens.data_ptr(),
        k_scales.data_ptr() if kind != "fp" else None,
        v_scales.data_ptr() if kind != "fp" else None,
        b, s, n_q, n_kv, num_pages, page_size, hd, block_tables.shape[1],
        _DTYPES[q_win.dtype], POOL_CODES[kind], 1.0 / hd ** 0.5, stream,
    )
    kernels.check_launch("fused_window_attention", err)
    fused_window_attention.launches += 1
    fused_window_attention.launches_by_pool[kind] += 1
    by_window = fused_window_attention.launches_by_window
    by_window[s] = by_window.get(s, 0) + 1
    by_hd = fused_window_attention.launches_by_head_dim
    by_hd[f"hd{hd}"] = by_hd.get(f"hd{hd}", 0) + 1
    return out


# kernel launches (CUDA path only), in all, per pool branch, per window S
# and per head dim (a draft model's 64 beside the target's 128)
fused_window_attention.launches = 0
fused_window_attention.launches_by_pool = dict.fromkeys(POOL_CODES, 0)
fused_window_attention.launches_by_window = {}
fused_window_attention.launches_by_head_dim = {}


def fused_paged_attention(q, k_pages, v_pages, block_tables, cached_lens, new_lens,
                          k_scales=None, v_scales=None):
    """Drop-in for ``paged_attention_ref`` at the ``forward_paged`` seam:
    prefill chunks (and any S-token window) over fp, int8 or int4 pools go
    through kernel A."""
    return fused_window_attention(q, k_pages, v_pages, block_tables, cached_lens,
                                  new_lens, k_scales, v_scales)


def fused_packed_attention(q, k_pages, v_pages, block_tables, cached_lens, new_lens,
                           seg_ids, positions, *, tq: int, k_scales=None, v_scales=None):
    """Packed prefill over quantized pools: the packed queries [T, n_q, hd]
    scatter into the segment-major [R, tq] window view (a segment's chunk
    is a window based at its cached length), kernel A runs every segment,
    and the outputs gather back to packed order.  Padding tokens read a
    clamped row: finite values that nothing reads (their K/V is dropped and
    their logits never projected)."""
    from githubrepostorag_tpu_torch.ops.packed_prefill import _segment_scatter_indices

    t, n_q, hd = q.shape
    r = block_tables.shape[0]
    dest = _segment_scatter_indices(seg_ids, positions, cached_lens, tq).long()
    # one row past the view takes the padding tokens' writes
    q_seg = torch.zeros((r * tq + 1, n_q, hd), dtype=q.dtype, device=q.device)
    q_seg.index_copy_(0, dest, q)
    out_seg = fused_window_attention(
        q_seg[: r * tq].reshape(r, tq, n_q, hd), k_pages, v_pages, block_tables,
        cached_lens, new_lens, k_scales, v_scales)
    return out_seg.reshape(r * tq, n_q, hd)[torch.clamp(dest, max=r * tq - 1)]
