"""Paged attention at decode: kernels F and B; port of
``githubrepostorag_tpu/ops/pallas_paged.py``.

Kernel F, ``paged_attention_decode`` (:103, ``pallas_call`` :150): one query
per row attends to the row's first ``cached_lens[b] + new_lens[b]`` keys of
one layer's full-precision ``[n_kv, P, ps, hd]`` pool through its block
table.  Its only caller is the dispatcher ``paged_attention`` (:408), which
sends decode steps (S = 1) to F and prefill chunks (S > 1) to
``paged_attention_ref``; no serving path of either package calls it.

Kernel B, ``paged_attention_decode_staged`` (:281), over full-precision
and int8 rank-5 pools: one decode query per row attends to the frozen pool
prefix (``pool_lens[b]`` tokens through its block table) and then to the
burst's staged K/V tail (entries ``< staged_len``).  Pools are the whole
``[L, n_kv, P, ps, hd]`` tensors plus an integer layer index, so no
per-layer copy is made.  int8 pools carry one f32 scale per (layer, kv
head, page), ``[L, n_kv, P]``, read with the same layer index; their pages
dequantize in float32 as they load, and the staged tail stays in the
activation dtype (the dtype of ``q``).  int4 (uint8) pools never reach this
kernel: the decode burst takes its gather path for them, as the JAX
package does.

Both: masked scores are -1e30, a row with no valid KV outputs 0, and scores
and accumulators are float32.  Each wrapper launches its hand-written
Hopper kernel (``csrc/paged_decode.cu``, ``csrc/paged_decode_staged.cu``:
one split-K kernel over pages whose last block per (row, kv head) merges
the splits) for CUDA tensors and runs its ``*_ref`` plain
PyTorch version for CPU tensors.  ``_plan_decode`` cuts each row's block
table into splits of whole pages from static shapes alone (batch, kv heads,
table width, page size, SM count), so no row length is read to the host;
the splits' partials go to a float32 workspace from the caching allocator,
and per-(row, kv head) arrival counters persist per device.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import torch

from githubrepostorag_tpu_torch import kernels
from githubrepostorag_tpu_torch.device import sm_count
from githubrepostorag_tpu_torch.ops.fused_decode import POOL_CODES
from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv, paged_attention_ref

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8

# the split-K kernel's geometry (csrc/decode_attention.cuh)
TILE_KEYS = 64  # keys per shared-memory stage
SPLIT_KEYS = 1024  # keys a split aims at: at most 128 pages, the kernel's page list


class DecodePlan(NamedTuple):
    pages_per_split: int
    n_splits: int
    blocks: int  # split blocks launched: B * n_kv * n_splits


@functools.lru_cache(maxsize=4096)
def _plan_decode(b: int, n_kv: int, max_pages: int, page_size: int,
                 n_sm: int = 132) -> DecodePlan:
    """The split of every (row, kv head)'s block table: ``n_splits`` blocks
    of ``pages_per_split`` whole pages each, covering the table's
    ``max_pages`` entries.  Static shapes only: a row's length is read on
    the card, where a split that starts past it writes an empty partial.

    A split aims at ``SPLIT_KEYS`` keys, fewer where that would leave
    fewer blocks than SMs (batch 1 takes 2-page splits of 128 keys); it
    holds whole tiles of ``TILE_KEYS`` keys (page sizes below 64 take
    several pages a tile, which must divide it).  The split sweep of
    ``chip_smoke.py`` times the alternatives on the card."""
    _require_plan(page_size > 0 and (page_size % TILE_KEYS == 0
                                     or (TILE_KEYS % page_size == 0 and page_size % 8 == 0)),
                  f"page size {page_size}: a multiple of {TILE_KEYS}, or 8..{TILE_KEYS} "
                  f"dividing {TILE_KEYS}")
    _require_plan(b >= 0 and n_kv >= 1 and max_pages >= 1, f"B {b}, n_kv {n_kv}, "
                  f"max_pages {max_pages}")
    unit = max(1, TILE_KEYS // page_size)  # pages of one tile
    pairs = max(1, b * n_kv)
    pps = max(1, SPLIT_KEYS // page_size)
    if pairs * -(-max_pages // pps) < n_sm:  # too few blocks: smaller splits
        pps = -(-max_pages // -(-n_sm // pairs))
    pps = max(unit, -(-pps // unit) * unit)
    n_splits = -(-max_pages // pps)
    return DecodePlan(pps, n_splits, b * n_kv * n_splits)


def _require_plan(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"_plan_decode: {msg}")


def _workspace(parts: int, hd: int, device: torch.device) -> torch.Tensor:
    """The partials of ``parts`` blocks (the splits, and kernel B's staged
    tail, one block a row): (m, l) and acc[hd] for each of the kernel's 8
    query rows, float32."""
    return torch.empty(parts * _MAX_GROUP * (hd + 2), dtype=torch.float32, device=device)


_COUNTERS: dict[torch.device, torch.Tensor] = {}
# the fleet's replicas launch from one driver thread each: the check and
# the grow below happen under this lock, so two threads never both grow
# the buffer or read it half-replaced
_COUNTERS_LOCK = threading.Lock()


def _counters(pairs: int, device: torch.device) -> torch.Tensor:
    """Per (row, kv head), the split blocks that have finished: int32 zeros
    kept per device (grown as needed) that every launch leaves at zero, its
    last block resetting them.  Launches on the device share them, so they
    must run on one stream at a time: every engine, and every replica of a
    fleet (``serving/multi_engine.py``), launches onto the device's
    default stream, which runs them in order."""
    with _COUNTERS_LOCK:
        buf = _COUNTERS.get(device)
        if buf is None or buf.numel() < pairs:
            buf = torch.zeros(max(pairs, 256), dtype=torch.int32, device=device)
            _COUNTERS[device] = buf
        return buf


def _split_buffers(b: int, n_kv: int, block_tables, page_size: int, hd: int, device,
                   tail_blocks: int = 0):
    """One launch's plan, workspace (the split blocks' partials and
    ``tail_blocks`` more: kernel B's staged tail, one block a row) and the
    address of its arrival counters."""
    plan = _plan_decode(b, n_kv, block_tables.shape[1], page_size, sm_count(device))
    ws = _workspace(plan.blocks + tail_blocks, hd, device)
    return plan, ws, _counters(b * n_kv, device).data_ptr()


def paged_attention_decode_ref(q, k_pages, v_pages, block_tables, cached_lens, new_lens):
    """Plain PyTorch version of kernel F: gather the row's pages, mask keys
    at positions >= cached + new, softmax in float32, round only the
    output.  A row with no key writes 0 (``paged_attention_ref`` would give
    the mean of V there)."""
    b, _, n_q, hd = q.shape
    dev = q.device
    k, v = gather_kv(k_pages, v_pages, block_tables)  # [B, T, n_kv, hd]
    t, n_kv = k.shape[1], k.shape[2]
    total = (cached_lens + new_lens).to(dev)
    valid = (torch.arange(t, device=dev)[None, :] < total[:, None])[:, None, None, :]
    qg = q.reshape(b, n_kv, n_q // n_kv, hd).float()
    scores = torch.einsum("bngh,btnh->bngt", qg, k.float()) * (1.0 / hd ** 0.5)
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.where(valid, torch.exp(scores - scores.amax(dim=-1, keepdim=True)), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bngt,btnh->bngh", p / torch.where(denom == 0, 1.0, denom), v.float())
    return out.reshape(b, 1, n_q, hd).to(q.dtype)


def _require_f(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_decode: {msg}")


def paged_attention_decode(q, k_pages, v_pages, block_tables, cached_lens, new_lens):
    """q [B, 1, n_q, hd]; k_pages/v_pages [n_kv, P, ps, hd] (one layer's
    pool) in q's dtype; block_tables [B, max_pages]; cached_lens [B] (tokens
    in the cache before this step) and new_lens [B] (1 for active rows, 0
    for padding rows), int32 on the card.  Returns [B, 1, n_q, hd] in
    q.dtype.  Raises for S != 1 and for quantized pools, whatever the
    device (the TPU kernel takes neither); CPU tensors then take the plain
    version, and CUDA tensors launch the kernel or raise."""
    _require_f(q.dim() == 4 and q.shape[1] == 1, f"q must be [B, 1, n_q, hd], got {tuple(q.shape)}")
    _require_f(k_pages.is_floating_point() and v_pages.dtype == k_pages.dtype,
               f"pools must be full precision (got {k_pages.dtype}); quantized pages carry "
               "scales this kernel does not take")
    _require_f(k_pages.dim() == 4 and v_pages.shape == k_pages.shape,
               "pools must be rank-4 [n_kv, P, ps, hd] and alike")
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, k_pages, v_pages, block_tables, cached_lens,
                                          new_lens)
    _require_f(q.device.type == "cuda", f"unsupported device {q.device}")
    tensors = [q, k_pages, v_pages, block_tables, cached_lens, new_lens]
    _require_f(all(x.device == q.device for x in tensors), "all operands must be on one device")
    _require_f(all(x.is_contiguous() for x in tensors), "operands must be contiguous")
    b, _, n_q, hd = q.shape
    n_kv, num_pages, page_size, hd_pool = k_pages.shape
    _require_f(hd_pool == hd and hd in _HEAD_DIMS,
               f"head_dim {hd} (pool {hd_pool}) not in {_HEAD_DIMS}")
    _require_f(n_q % n_kv == 0 and n_q // n_kv <= _MAX_GROUP,
               f"GQA group {n_q}/{n_kv} must divide evenly and be <= {_MAX_GROUP}")
    _require_f(q.dtype in _DTYPES and k_pages.dtype == q.dtype,
               "q and the pools must share one dtype: bf16 or f32")
    _require_f(block_tables.dim() == 2 and block_tables.shape[0] == b
               and block_tables.dtype == torch.int32, "block_tables must be [B, max_pages] int32")
    _require_f(all(x.shape == (b,) and x.dtype == torch.int32 for x in (cached_lens, new_lens)),
               "cached_lens and new_lens must be [B] int32")
    _require_f(all(x.data_ptr() % 16 == 0 for x in (q, k_pages, v_pages)),
               "q and pools must be 16-byte aligned")
    plan, ws, counters = _split_buffers(b, n_kv, block_tables, page_size, hd, q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = kernels.launcher("paged_decode")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), cached_lens.data_ptr(), new_lens.data_ptr(), ws.data_ptr(),
        counters, b, n_q, n_kv, num_pages, page_size, hd, block_tables.shape[1],
        _DTYPES[q.dtype], plan.pages_per_split, plan.n_splits, 1.0 / hd ** 0.5, stream,
    )
    kernels.check_launch("paged_attention_decode", err)
    paged_attention_decode.launches += 1
    return out


# kernel launches (CUDA path only)
paged_attention_decode.launches = 0


def paged_attention(q, k_pages, v_pages, block_tables, cached_lens, new_lens):
    """Dispatcher with the ``paged_attention_ref`` contract: kernel F for
    decode steps (S == 1), gather + dense attention for prefill chunks
    (S > 1)."""
    if q.shape[1] == 1:
        return paged_attention_decode(q, k_pages, v_pages, block_tables, cached_lens, new_lens)
    return paged_attention_ref(q, k_pages, v_pages, block_tables, cached_lens, new_lens)


def paged_attention_decode_staged_ref(q, k_pages, v_pages, block_tables, pool_lens,
                                      staged_k, staged_v, staged_len: int, layer: int,
                                      k_scales=None, v_scales=None):
    """Plain PyTorch version of kernel B: gather the layer's pages (int8
    ones dequantized in float32), append the staged tail, mask, softmax in
    float32, round only the output."""
    b, _, n_q, hd = q.shape
    dev = q.device
    ks, vs = (None, None) if k_scales is None else (k_scales[layer], v_scales[layer])
    pk, pv = gather_kv(k_pages[layer], v_pages[layer], block_tables, ks, vs,
                       dtype=torch.float32)  # [B, T, n_kv, hd]
    t, n_kv = pk.shape[1], pk.shape[2]
    n_steps = staged_k.shape[2]
    group = n_q // n_kv
    k_all = torch.cat([pk.float(), staged_k.transpose(1, 2).float()], dim=1)
    v_all = torch.cat([pv.float(), staged_v.transpose(1, 2).float()], dim=1)
    valid = torch.cat([
        torch.arange(t, device=dev)[None, :] < pool_lens.to(dev)[:, None],
        (torch.arange(n_steps, device=dev) < staged_len)[None, :].expand(b, n_steps),
    ], dim=1)[:, None, None, :]  # [B, 1, 1, T + n_steps]

    qg = q.reshape(b, n_kv, group, hd).float()
    scores = torch.einsum("bngh,btnh->bngt", qg, k_all) * (1.0 / hd ** 0.5)
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.where(valid, torch.exp(scores - scores.amax(dim=-1, keepdim=True)), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bngt,btnh->bngh", p / torch.where(denom == 0, 1.0, denom), v_all)
    return out.reshape(b, 1, n_q, hd).to(q.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_decode_staged: {msg}")


def paged_attention_decode_staged(q, k_pages, v_pages, block_tables, pool_lens,
                                  staged_k, staged_v, staged_len: int, layer: int,
                                  k_scales=None, v_scales=None):
    """q [B, 1, n_q, hd]; k_pages/v_pages [L, n_kv, P, ps, hd] in q's dtype,
    or int8 with k_scales/v_scales [L, n_kv, P] f32; block_tables
    [B, max_pages] int32; pool_lens [B] int32 (valid pool-prefix tokens);
    staged_k/v [B, n_kv, n_steps, hd] in q's dtype; ``staged_len`` staged
    entries valid this step; ``layer`` the pool's layer.  Returns
    [B, 1, n_q, hd] in q.dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return paged_attention_decode_staged_ref(q, k_pages, v_pages, block_tables,
                                                 pool_lens, staged_k, staged_v,
                                                 staged_len, layer, k_scales, v_scales)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    kind = "fp" if k_scales is None else "int8"
    tensors = [q, k_pages, v_pages, block_tables, pool_lens, staged_k, staged_v]
    if kind == "int8":
        _require(v_scales is not None, "k_scales without v_scales")
        tensors += [k_scales, v_scales]
    _require(all(x.device == q.device for x in tensors), "all operands must be on one device")
    _require(all(x.is_contiguous() for x in tensors), "operands must be contiguous")
    _require(q.dim() == 4 and q.shape[1] == 1, "q must be [B, 1, n_q, hd]")
    _require(k_pages.dim() == 5 and v_pages.shape == k_pages.shape
             and v_pages.dtype == k_pages.dtype,
             "pools must be rank-5 [L, n_kv, P, ps, hd] and alike")
    b, _, n_q, hd = q.shape
    n_layers, n_kv, num_pages, page_size, hd_pool = k_pages.shape
    _require(0 <= layer < n_layers, f"layer {layer} outside [0, {n_layers})")
    _require(hd_pool == hd and hd in _HEAD_DIMS, f"head_dim {hd} (pool {hd_pool}) not in {_HEAD_DIMS}")
    _require(n_q % n_kv == 0 and n_q // n_kv <= _MAX_GROUP,
             f"GQA group {n_q}/{n_kv} must divide evenly and be <= {_MAX_GROUP}")
    dtype = q.dtype
    _require(dtype in _DTYPES and staged_k.dtype == dtype and staged_v.dtype == dtype,
             "q and the staged tail must share one dtype: bf16 or f32")
    _require(k_pages.dtype == (torch.int8 if kind == "int8" else dtype),
             f"pools must be in q's dtype, or int8 with scales (got {k_pages.dtype}; "
             "int4 pools take the decode burst's gather path)")
    if kind == "int8":
        _require(all(x.shape == (n_layers, n_kv, num_pages) and x.dtype == torch.float32
                     for x in (k_scales, v_scales)), "scales must be [L, n_kv, P] f32")
    _require(staged_k.dim() == 4 and staged_k.shape[:2] == (b, n_kv) and staged_k.shape[3] == hd
             and staged_v.shape == staged_k.shape, "staged k/v must be [B, n_kv, n_steps, hd]")
    n_steps = staged_k.shape[2]
    _require(1 <= staged_len <= n_steps, f"staged_len {staged_len} outside [1, {n_steps}]")
    _require(block_tables.dim() == 2 and block_tables.shape[0] == b
             and block_tables.dtype == torch.int32, "block_tables must be [B, max_pages] int32")
    _require(pool_lens.shape == (b,) and pool_lens.dtype == torch.int32,
             "pool_lens must be [B] int32")
    _require(all(x.data_ptr() % 16 == 0 for x in (q, k_pages, v_pages, staged_k, staged_v)),
             "q, pools and staged tail must be 16-byte aligned")
    plan, ws, counters = _split_buffers(b, n_kv, block_tables, page_size, hd, q.device,
                                        tail_blocks=b * n_kv)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = kernels.launcher("paged_decode_staged")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), staged_k.data_ptr(),
        staged_v.data_ptr(), out.data_ptr(), block_tables.data_ptr(), pool_lens.data_ptr(),
        k_scales.data_ptr() if kind == "int8" else None,
        v_scales.data_ptr() if kind == "int8" else None, ws.data_ptr(), counters,
        b, n_q, n_kv, num_pages, page_size, hd, block_tables.shape[1], n_steps,
        int(staged_len), int(layer), _DTYPES[dtype], POOL_CODES[kind],
        plan.pages_per_split, plan.n_splits, 1.0 / hd ** 0.5, stream,
    )
    kernels.check_launch("paged_attention_decode_staged", err)
    paged_attention_decode_staged.launches += 1
    paged_attention_decode_staged.launches_by_pool[kind] += 1
    return out


# kernel launches (CUDA path only), in all and per pool branch
paged_attention_decode_staged.launches = 0
paged_attention_decode_staged.launches_by_pool = {"fp": 0, "int8": 0}
