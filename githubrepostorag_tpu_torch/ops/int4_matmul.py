"""int4 weight-only GEMMs (kernels D and E); port of
``githubrepostorag_tpu/ops/pallas_int4.py``.

Weights are the in-group plane-packed ``QuantizedLinear4`` layout
(``models/quant.py``): ``q`` uint8 [K/2, N], ``s`` and ``zs`` bf16
[K/gsz, N]; a nibble n of group g dequantizes as ``n * s[g] - zs[g]``.
Stacked [L, ...] leaves reach these functions as one layer's view
(``leaf[li]``), so no layer index is passed and no weight is copied.

``int4_matmul`` is the router and kernel D's wrapper:

- the W4A8 route, ``w4a8_matmul``, for decode-sized batches (rows <= 256)
  when ``w4a8`` is None and ``INT4_W4A8`` is not ``0``; on the card only
  for groups with ``(gsz // 2) % 32 == 0`` (64, 128, 256, ...), as the
  JAX package sends other groups to its bf16-dequant kernel on the chip
  (``takes_w4a8``).  Activations are
  quantized per row to symmetric int8 (f32 amax, ``x * 127 / amax`` rounded
  half to even, 0 for an all-zero row); the group-scaled int32 partials,
  the zero-point term and ``sxn * (acc - zs_term)`` follow.  On the card
  all of it is kernel E (``csrc/w4a8_matmul.cu``), one launcher call of
  two kernels: a prologue that quantizes, and a split-K int8 tensor-core
  GEMM with the epilogue inside (``_plan_w4a8`` plans it from shapes;
  ``w4a8_matmul.launches_by_kernel`` counts ``mma`` and ``dp4a``, the
  CUDA-core kernel for groups the route never sends).  Results differ
  from the bf16-dequant math by the activation quantization (about 1e-2
  relative).
- otherwise, or with ``w4a8=False`` (prefill pins it), the exact
  bf16-dequant route: kernel D (``csrc/int4_matmul.cu``), a warp-specialised
  ``wgmma`` GEMM.  ``_plan_int4`` picks its loader (TMA, or ``cp.async`` for
  shapes whose strides or group size TMA cannot take), its tile of x rows
  and its persistent grid; ``int4_matmul.launches_by_loader`` counts the
  launches of each (``f32`` for float32 activations, which take the CUDA
  cores).

For CUDA tensors the wrappers launch the kernels or raise; CPU tensors take
the plain versions ``int4_matmul_ref`` (D) and ``_w4a8(...,
w4a8_matmul_ref)`` (E's route).
``int4_matmul_plain`` takes the same route through the plain versions on
any device (the comparison path).  The TPU kernel's workarounds (the
``& 0xF0`` high nibble with ``s/16``, the pre-split activations, 32-row
scratch alignment, the Mosaic group-size limit on W4A8) are not carried
over.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch

from githubrepostorag_tpu_torch import kernels
from githubrepostorag_tpu_torch.device import sm_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
W4A8_MAX_ROWS = 256
# kernel E's int32 group partials stay exact in f32: 127 * 15 * gsz < 2**24
W4A8_MAX_GSZ = 8192


def dequant4(q: torch.Tensor, s: torch.Tensor, zs: torch.Tensor, dtype: torch.dtype):
    """[.., K/2, N] packed nibbles -> [.., K, N] weights in ``dtype``: the
    product ``n * s`` rounds to ``dtype``, then the difference does."""
    lead, out = q.shape[:-2], q.shape[-1]
    n_g = s.shape[-2]
    half = q.shape[-2] // n_g
    pg = q.reshape(*lead, n_g, half, out)
    grouped = torch.cat([pg & 0xF, pg >> 4], dim=-2).to(dtype)  # [.., n_g, gsz, N]
    w = grouped * s[..., :, None, :].to(dtype) - zs[..., :, None, :].to(dtype)
    return w.reshape(*lead, 2 * half * n_g, out)


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.shape[-1] else 0


def _gsz(x: torch.Tensor, s: torch.Tensor) -> int:
    return x.shape[-1] // s.shape[-2] if s.shape[-2] else 0


def takes_w4a8(rows: int, w4a8: bool | None, gsz: int = 64, on_card: bool = False) -> bool:
    """The route, as ``pallas_int4.int4_matmul`` takes it: W4A8 for
    decode-sized batches unless ``INT4_W4A8=0``, an explicit ``w4a8``
    winning; then, on the card (where JAX compiles its kernel, not in
    interpret mode), only for groups with ``(gsz // 2) % 32 == 0``: other
    groups take the exact bf16-dequant kernel, whatever ``w4a8`` said."""
    if w4a8 is None:
        w4a8 = rows <= W4A8_MAX_ROWS and os.environ.get("INT4_W4A8", "1") != "0"
    return bool(w4a8) and not (on_card and (gsz // 2) % 32)


# ------------------------------------------------------ kernel D (dequant) --


def int4_matmul_ref(x, q, s, zs, out_dtype=None):
    """Plain version of kernel D: dequantize in x's dtype (rounded where
    the kernel rounds), multiply in float32, round the output once."""
    w = dequant4(q, s, zs, x.dtype)
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def _require(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_weights(name, x, q, s, zs=None, align=16):
    """Device, layout, dtypes and shapes of the weights, and their bases
    ``align``-byte aligned; returns (K, N, group size)."""
    k, n = x.shape[-1], q.shape[-1]
    ws = (q, s) if zs is None else (q, s, zs)
    _require(name, x.device.type == "cuda", f"unsupported device {x.device}")
    _require(name, all(t.device == x.device for t in ws), "all operands must be on one device")
    _require(name, all(t.is_contiguous() for t in ws),
             "weights must be contiguous (one layer's view)")
    _require(name, q.dim() == 2 and q.dtype == torch.uint8 and q.shape[0] * 2 == k,
             f"q must be [K/2, N] uint8 for K = {k}, got {tuple(q.shape)} {q.dtype}")
    _require(name, all(t.dtype == torch.bfloat16 and t.shape == s.shape for t in ws[1:])
             and s.dim() == 2 and s.shape[1] == n and s.shape[0] > 0 and k % s.shape[0] == 0,
             "s/zs must be [K/gsz, N] bf16")
    gsz = k // s.shape[0]
    _require(name, gsz % 16 == 0, f"group size {gsz} must be a multiple of 16")
    _require(name, all(t.data_ptr() % align == 0 for t in ws),
             f"weights must be {align}-byte aligned")
    return k, n, gsz


# kernel D's loaders (the C entry point's codes) and its tiles
LOADERS = ("tma", "cp_async")
BLOCK_N = 128  # weight columns per tile: 64 per consumer warpgroup
BLOCK_MS = (256, 128, 64)  # rows of x per tile above 8 rows (wgmma n)


class Int4Plan(NamedTuple):
    loader: str  # "tma" or "cp_async"
    block_m: int  # rows of x per tile: 8, 64, 128 or 256
    tiles: int
    grid: int  # persistent blocks, one per SM at most


def _plan_int4(m: int, k: int, n: int, gsz: int, x_ptr: int, q_ptr: int, s_ptr: int,
               zs_ptr: int, n_sm: int = 132) -> Int4Plan:
    """Kernel D's launch for bf16 x [m, k] and weights q [k/2, n], s / zs
    [k/gsz, n] at these addresses, on a card with ``n_sm`` SMs.

    The loader is TMA where TMA can take every operand: a K step is one
    whole group (gsz 64 or 128), every row stride a multiple of 16 bytes
    (q rows are n bytes: n % 16 == 0) and every base 16-byte aligned.
    Otherwise the ``cp.async`` loader, which needs x 16-byte aligned and q,
    s, zs 4-byte aligned; anything less is refused.  The tile of x rows is
    8 for m <= 8 (wgmma n8: the prefill logits); above, the one of 256,
    128 and 64 rows with the fewest waves of tiles times a tile's step
    time, modelled as block_m + 64: the tensor cores' time grows with the
    rows, and the dequantization, the same for any block_m, adds what it
    does not overlap (about 64 rows' worth).  Cached by shape and
    alignment."""
    _require("int4_matmul", k % 64 == 0 and k > 0 and n % 2 == 0,
             f"K {k} must be a positive multiple of 64, N {n} even")
    _require("int4_matmul", gsz % 16 == 0 and k % gsz == 0,
             f"group size {gsz} must be a multiple of 16 dividing K {k}")
    _require("int4_matmul", x_ptr % 16 == 0, "x must be 16-byte aligned")
    _require("int4_matmul", all(p % 4 == 0 for p in (q_ptr, s_ptr, zs_ptr)),
             "weights must be 4-byte aligned")
    return _plan_int4_shape(m, k, n, gsz,
                            all(p % 16 == 0 for p in (x_ptr, q_ptr, s_ptr, zs_ptr)), n_sm)


@functools.lru_cache(maxsize=4096)
def _plan_int4_shape(m: int, k: int, n: int, gsz: int, aligned16: bool, n_sm: int) -> Int4Plan:
    """``_plan_int4`` by shape and alignment, cached (a new entry is a
    shape the card has not launched at in this process)."""
    tma = gsz in (64, 128) and n % 16 == 0 and aligned16
    n_tiles = -(-n // BLOCK_N)
    if m <= 8:
        block_m = 8
    else:
        def cost(bm):
            return -(-n_tiles * -(-m // bm) // n_sm) * (bm + 64)
        block_m = min(BLOCK_MS, key=cost)  # ties: the larger tile (listed first)
    tiles = n_tiles * -(-m // block_m)
    return Int4Plan("tma" if tma else "cp_async", block_m, tiles, min(tiles, n_sm))


def int4_matmul(x, q, s, zs, out_dtype=None, w4a8: bool | None = None):
    """``x @ dequant(q, s, zs)`` for x [..., K]; returns [..., N] in
    ``out_dtype`` (default x's dtype; float32 for logits).  Routes to
    ``w4a8_matmul`` (kernel E) or runs kernel D; see the module
    docstring."""
    if takes_w4a8(_rows(x), w4a8, _gsz(x, s), x.device.type == "cuda"):
        return w4a8_matmul(x, q, s, zs, out_dtype)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int4_matmul_ref(x, q, s, zs, out_dtype)
    k, n, gsz = _check_weights("int4_matmul", x, q, s, zs, align=4)
    _require("int4_matmul", x.dtype in _DTYPES and out_dtype in _DTYPES,
             f"x/out dtypes {x.dtype}/{out_dtype}; need bf16 or f32")
    lead, m = x.shape[:-1], _rows(x)
    x2 = x.reshape(m, k).contiguous()
    plan = _plan_int4(m, k, n, gsz, x2.data_ptr(), q.data_ptr(), s.data_ptr(), zs.data_ptr(),
                      sm_count(x.device))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = kernels.launcher("int4_matmul")(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), zs.data_ptr(), out.data_ptr(),
        m, k, n, gsz, _DTYPES[x.dtype], _DTYPES[out_dtype], LOADERS.index(plan.loader),
        plan.block_m, plan.grid, stream)
    kernels.check_launch("int4_matmul", err)
    int4_matmul.launches += 1
    int4_matmul.launches_by_loader["f32" if x.dtype == torch.float32 else plan.loader] += 1
    return out.reshape(*lead, n)


int4_matmul.launches = 0  # kernel D launches (CUDA path only)
int4_matmul.launches_by_loader = {"tma": 0, "cp_async": 0, "f32": 0}


# --------------------------------------------------------- kernel E (W4A8) --


def quantize_rows(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of [m, K] activations in f32 math (bf16
    rounding would quantize twice): ``xq`` int8 [m, K] and ``sxn`` f32
    [m, 1] = rowmax|x| / 127.  An all-zero row quantizes to 0.  Both
    divisions are IEEE divisions, as in the JAX route and kernel E's
    prologue: torch's ``127.0 / t`` is ``reciprocal(t) * 127`` (two
    roundings), and on CUDA ``t / 127.0`` multiplies by the reciprocal."""
    xf = x2.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    inv = torch.full_like(amax, 127.0) / torch.clamp_min(amax, 1e-30)
    xq = torch.where(amax > 0, torch.round(xf * inv), 0.0)
    return xq.to(torch.int8), amax / torch.full_like(amax, 127.0)


def w4a8_matmul_ref(xg: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel E's group partials: xg [n_g, M, gsz] int8, q
    [K/2, N], s [n_g, N] -> acc [M, N] f32 = sum_g s[g] * (xg[g] @ nib[g]).
    The group partials are an f32 product of integers, exact (|p| <=
    127*15*gsz < 2^24), so it runs on the card too, which has no integer
    matmul."""
    n_g, m, gsz = xg.shape
    pg = q.reshape(n_g, gsz // 2, -1)
    w_int = torch.cat([pg & 0xF, pg >> 4], dim=1).float()  # [n_g, gsz, N]
    p = torch.bmm(xg.float(), w_int)  # [n_g, M, N]
    return (p * s.float()[:, None, :]).sum(dim=0)


def _w4a8(x, q, s, zs, out_dtype, acc_fn):
    """The W4A8 route around ``acc_fn`` (w4a8_matmul_ref): the plain
    version of everything kernel E's launch computes,

        y[m, o] = sxn[m] * (acc[m, o] - sum_g R[m, g] * zs[g, o])

    with R the per-group sums of the quantized activations."""
    lead, k = x.shape[:-1], x.shape[-1]
    n_g, n = s.shape[-2], q.shape[-1]
    gsz = k // n_g
    m = _rows(x)
    xq, sxn = quantize_rows(x.reshape(m, k))
    xqg = xq.reshape(m, n_g, gsz)
    zs_term = xqg.sum(dim=-1, dtype=torch.int32).float() @ zs.float()  # [m, N]
    acc = acc_fn(xqg.transpose(0, 1).contiguous(), q, s)  # group-major [n_g, m, gsz]
    y = sxn * (acc - zs_term)
    return y.to(out_dtype or x.dtype).reshape(*lead, n)


# kernel E's kernels and loaders (the C entry point's codes), and its tiles
W4A8_KERNELS = ("mma", "dp4a")
W4A8_LOADERS = ("tma", "plain")
W4A8_BN = 128  # weight columns per tile
W4A8_MAX_STAGES = 16
W4A8_RING_BYTES = 48 * 1024  # ring a block aims to keep in flight
W4A8_GROUPS_PER_STAGE = 4  # group 64: whole groups a stage (one copy of each kind)
W4A8_RESIDENT = {8: 3, 32: 1}  # blocks an SM at once (the kernel's launch bounds)
W4A8_SPLIT_COST = 2  # an extra K split (its partials and the merge), in groups of work


class W4A8Plan(NamedTuple):
    kernel: str  # "mma" (int8 tensor cores) or "dp4a" (CUDA cores)
    loader: str  # mma: "tma" or "plain" (the producer warp's own loads); dp4a: ""
    block_m: int  # rows of x per block (rows past M are padding)
    row_blocks: int
    col_tiles: int  # 128-column tiles
    splits: int  # K splits: runs of whole groups, merged by each tile's last block
    groups_per_split: int
    groups_per_stage: int  # G: whole groups a ring stage holds (group 64; else 1)
    stages: int  # ring stages (mma)
    smem: int  # dynamic shared memory a block takes (mma)

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.row_blocks, self.splits, self.col_tiles)

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.splits * self.col_tiles


def w4a8_stage_bytes(block_m: int, groups: int = 1) -> int:
    """One ring stage of the tensor-core kernel holding ``groups`` groups
    of 32 packed rows: the q tile [32 groups][128], then per group the s
    and zs rows, the codes of both planes [2][block_m][32] and R [block_m]
    int32, rounded to the 128 bytes a TMA destination needs (``MmaCfg`` in
    ``csrc/w4a8_matmul.cu``)."""
    return groups * 32 * W4A8_BN + -(-groups * (4 * W4A8_BN + 68 * block_m) // 128) * 128


def w4a8_merge_bytes(block_m: int) -> int:
    """One group parity's acc and zacc, added through shared memory at the
    end of a block (``MmaCfg::MERGE``)."""
    return W4A8_BN * (block_m // 8) * 16 * 4


def _plan_w4a8(m: int, k: int, n: int, gsz: int, q_ptr: int, s_ptr: int, zs_ptr: int,
               n_sm: int = 132) -> W4A8Plan:
    """Kernel E's launch for x [m, k] against q [k/2, n] and s / zs [k/gsz,
    n] at these addresses, on a card with ``n_sm`` SMs.  Reads no tensor.

    Groups with (gsz // 2) % 32 == 0 (every group the card's route sends)
    take the tensor-core kernel; the rest (16, 48, ...) the CUDA-core one.
    Tensor cores: 8 rows of x a block up to 8 rows, else 32 (64 measured
    slower at every 7B shape); then K splits of whole groups (the last may
    hold fewer): at 8 rows (three blocks an SM at once), at least enough
    for a block on every SM, and among those, while every block fits on
    the card at once, the count whose busiest SM carries the fewest groups
    (blocks on one SM share its rate), each extra split costing
    ``W4A8_SPLIT_COST`` groups; at 32 rows (one block an SM) the most
    splits that give no SM two blocks (measured: a doubled SM costs more
    than idle ones).  A stage holds
    ``W4A8_GROUPS_PER_STAGE`` groups at group 64, and the ring about
    ``W4A8_RING_BYTES`` (at least the parities' merge buffer).  TMA where q
    rows and the s / zs rows are whole 16-byte units (n % 16 == 0) and
    every base is 16-byte aligned, else the producer warp's own loads.  A
    shape neither kernel takes raises.  Cached by shape and alignment."""
    _require("w4a8_matmul", all(p % 4 == 0 for p in (q_ptr, s_ptr, zs_ptr)),
             "weights must be 4-byte aligned")
    return _plan_w4a8_shape(m, k, n, gsz, all(p % 16 == 0 for p in (q_ptr, s_ptr, zs_ptr)), n_sm)


@functools.lru_cache(maxsize=4096)
def _plan_w4a8_shape(m: int, k: int, n: int, gsz: int, aligned16: bool, n_sm: int) -> W4A8Plan:
    _require("w4a8_matmul", gsz % 16 == 0 and 0 < gsz <= W4A8_MAX_GSZ and k % gsz == 0,
             f"group size {gsz} must be a multiple of 16 dividing K {k}, at most {W4A8_MAX_GSZ}")
    _require("w4a8_matmul", m >= 0 and n >= 1, f"M {m}, N {n}")
    n_g, col_tiles = k // gsz, -(-n // W4A8_BN)
    rows = max(m, 1)
    if (gsz // 2) % 32:
        return W4A8Plan("dp4a", "", 8, -(-rows // 8), col_tiles, 1, n_g, 1, 0, 0)
    block_m = 8 if rows <= 8 else 32
    tiles = -(-rows // block_m) * col_tiles
    gps = _split_groups(n_g, tiles, n_sm, W4A8_RESIDENT[block_m])
    return w4a8_mma_plan(rows, n_g, n, gsz, aligned16, block_m, gps)


def w4a8_mma_plan(m: int, n_g: int, n: int, gsz: int, aligned16: bool, block_m: int,
                  gps: int, groups: int | None = None) -> W4A8Plan:
    """The tensor-core kernel's plan at ``block_m`` rows a block and ``gps``
    groups a K split, sized: ``groups`` whole groups a stage (by default
    ``W4A8_GROUPS_PER_STAGE`` at group 64, else 1), the ring, its shared
    memory and the loader.  ``_plan_w4a8`` chooses the rows and the split;
    ``scripts/w4a8_plan_sweep.py`` times other choices through this sizing."""
    if groups is None:
        groups = min(W4A8_GROUPS_PER_STAGE, gps) if gsz == 64 else 1
    stage = w4a8_stage_bytes(block_m, groups)
    merge = w4a8_merge_bytes(block_m)
    stages = min(W4A8_MAX_STAGES, max(2, W4A8_RING_BYTES // stage, -(-merge // stage)))
    tma = n % 16 == 0 and aligned16
    return W4A8Plan("mma", "tma" if tma else "plain", block_m, -(-max(m, 1) // block_m),
                    -(-n // W4A8_BN), -(-n_g // gps), gps, groups, stages,
                    max(stages * stage, merge) + 1024)


def _split_groups(n_g: int, tiles: int, n_sm: int, resident: int) -> int:
    """Groups per K split of the tensor-core kernel (``_plan_w4a8``)."""
    if resident == 1:
        return -(-n_g // max(1, min(n_g, n_sm // tiles)))
    s_min = min(n_g, -(-n_sm // tiles))
    best = (None, -(-n_g // s_min))
    for s in range(s_min, n_g + 1):
        gps = -(-n_g // s)
        if -(-n_g // gps) != s:  # that split count would leave one empty
            continue
        per_sm = -(-tiles * s // n_sm)
        if per_sm > resident and s > s_min:
            break
        cost = per_sm * gps + W4A8_SPLIT_COST * (s - 1)
        if best[0] is None or cost < best[0]:
            best = (cost, gps)
    return best[1]


class W4A8Layout(NamedTuple):
    codes: int  # byte offsets in the workspace
    rsum: int
    sxn: int
    part: int
    size: int  # bytes


@functools.lru_cache(maxsize=4096)
def _w4a8_layout(plan: W4A8Plan, k: int, gsz: int) -> W4A8Layout:
    """Kernel E's workspace, 256-byte aligned sections: the prologue's codes
    (m_pad x K int8), R (K/gsz x m_pad int32) and sxn (m_pad f32), and with
    K splits every block's partial acc and zacc (f32)."""
    m_pad = plan.row_blocks * plan.block_m

    def up(v):
        return -(-v // 256) * 256

    rsum = up(m_pad * k)
    sxn = up(rsum + 4 * (k // gsz) * m_pad)
    part = up(sxn + 4 * m_pad)
    size = part + (plan.blocks * plan.block_m * 1024 if plan.splits > 1 else 0)
    return W4A8Layout(0, rsum, sxn, part, size)


# the tensor-core kernel's code layout: byte j of word i of a 32-byte run
# holds the k offset i + 8 j (a thread's mma B fragment is one 8-byte load)
W4A8_MMA_K_ORDER = tuple(i + 8 * j for i in range(8) for j in range(4))


def w4a8_prologue_views(ws: torch.Tensor, plan: W4A8Plan, m: int, k: int, gsz: int):
    """What kernel E's prologue wrote into the workspace ``ws``, in
    quantize_rows' layout: (xq [m, K] int8, sxn [m, 1] f32, R [m, K/gsz]
    int32)."""
    lay = _w4a8_layout(plan, k, gsz)
    n_g, bm = k // gsz, plan.block_m
    m_pad = plan.row_blocks * bm
    raw = ws[lay.codes:lay.codes + m_pad * k].view(torch.int8)
    if plan.kernel == "mma":  # [row block][group][chunk][plane][bm][32]
        runs = raw.view(plan.row_blocks, n_g, gsz // 64, 2, bm, 32)
        nat = torch.empty_like(runs)
        nat[..., list(W4A8_MMA_K_ORDER)] = runs
        xq = nat.permute(0, 4, 1, 3, 2, 5).reshape(m_pad, k)
        rows = bm
    else:  # [group][m_pad][gsz]
        xq = raw.view(n_g, m_pad, gsz).transpose(0, 1).reshape(m_pad, k)
        rows = m_pad
    rsum = ws[lay.rsum:lay.rsum + 4 * n_g * m_pad].view(torch.int32)
    rsum = rsum.view(-1, n_g, rows).permute(0, 2, 1).reshape(m_pad, n_g)
    sxn = ws[lay.sxn:lay.sxn + 4 * m_pad].view(torch.float32)[:, None]
    return xq[:m], sxn[:m], rsum[:m]


def _w4a8_launch(x, q, s, zs, out_dtype, plan: W4A8Plan | None = None):
    """Kernel E for CUDA tensors, one C call (prologue and main kernel):
    (out [..., N], workspace, plan).  ``plan`` defaults to ``_plan_w4a8``'s."""
    from githubrepostorag_tpu_torch.ops.paged_decode import _counters

    k, n, gsz = _check_weights("w4a8_matmul", x, q, s, zs, align=4)
    _require("w4a8_matmul", x.dtype in _DTYPES and out_dtype in _DTYPES,
             f"x/out dtypes {x.dtype}/{out_dtype}; need bf16 or f32")
    lead, m = x.shape[:-1], _rows(x)
    x2 = x.reshape(m, k).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    if plan is None:
        plan = _plan_w4a8(m, k, n, gsz, q.data_ptr(), s.data_ptr(), zs.data_ptr(),
                          sm_count(x.device))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n), None, plan
    lay = _w4a8_layout(plan, k, gsz)
    ws = torch.empty(lay.size, dtype=torch.uint8, device=x.device)
    base = ws.data_ptr()
    split = plan.splits > 1
    counters = _counters(plan.row_blocks * plan.col_tiles, x.device).data_ptr() if split else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = kernels.launcher("w4a8_matmul")(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), zs.data_ptr(), out.data_ptr(),
        base + lay.codes, base + lay.rsum, base + lay.sxn, base + lay.part if split else 0,
        counters, m, k, n, gsz, _DTYPES[x.dtype], _DTYPES[out_dtype],
        W4A8_KERNELS.index(plan.kernel), W4A8_LOADERS.index(plan.loader or "tma"),
        plan.block_m, plan.splits, plan.groups_per_split, plan.groups_per_stage, plan.stages,
        stream)
    kernels.check_launch("w4a8_matmul", err)
    w4a8_matmul.launches += 1
    w4a8_matmul.launches_by_kernel[plan.kernel] += 1
    return out.reshape(*lead, n), ws, plan


def w4a8_matmul(x, q, s, zs, out_dtype=None):
    """The W4A8 route of ``int4_matmul``: x [..., K] -> [..., N] in
    ``out_dtype``.  CUDA tensors: kernel E, one launcher call that
    quantizes the activations and computes the whole route; CPU tensors:
    its plain version ``_w4a8(..., w4a8_matmul_ref)``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return _w4a8(x, q, s, zs, out_dtype, w4a8_matmul_ref)
    return _w4a8_launch(x, q, s, zs, out_dtype)[0]


w4a8_matmul.launches = 0  # kernel E launches (CUDA path only)
w4a8_matmul.launches_by_kernel = {"mma": 0, "dp4a": 0}


def int4_matmul_plain(x, q, s, zs, out_dtype=None, w4a8: bool | None = None):
    """``int4_matmul``'s route through the plain versions, on any device."""
    if takes_w4a8(_rows(x), w4a8, _gsz(x, s), x.device.type == "cuda"):
        return _w4a8(x, q, s, zs, out_dtype, w4a8_matmul_ref)
    return int4_matmul_ref(x, q, s, zs, out_dtype)
