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
  half to even, 0 for an all-zero row); kernel E (``csrc/w4a8_matmul.cu``)
  computes the group-scaled int32 partials (``_plan_w4a8`` holds its
  preconditions), and the zero-point term and
  ``sxn * (acc - zs_term)`` are plain torch, as they are plain XLA around
  the Pallas call.  Results differ from the bf16-dequant math by the
  activation quantization (about 1e-2 relative).
- otherwise, or with ``w4a8=False`` (prefill pins it), the exact
  bf16-dequant route: kernel D (``csrc/int4_matmul.cu``), a warp-specialised
  ``wgmma`` GEMM.  ``_plan_int4`` picks its loader (TMA, or ``cp.async`` for
  shapes whose strides or group size TMA cannot take), its tile of x rows
  and its persistent grid; ``int4_matmul.launches_by_loader`` counts the
  launches of each (``f32`` for float32 activations, which take the CUDA
  cores).

For CUDA tensors the wrappers launch the kernels or raise; CPU tensors take
the plain versions ``int4_matmul_ref`` (D) and ``w4a8_matmul_ref`` (E).
``int4_matmul_plain`` takes the same route through the plain versions on
any device (the comparison path).  The TPU kernel's workarounds (the
``& 0xF0`` high nibble with ``s/16``, the pre-split activations, 32-row
scratch alignment, the Mosaic group-size limit on W4A8) are not carried
over.
"""

from __future__ import annotations

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
    does not overlap (about 64 rows' worth)."""
    _require("int4_matmul", k % 64 == 0 and k > 0 and n % 2 == 0,
             f"K {k} must be a positive multiple of 64, N {n} even")
    _require("int4_matmul", gsz % 16 == 0 and k % gsz == 0,
             f"group size {gsz} must be a multiple of 16 dividing K {k}")
    _require("int4_matmul", x_ptr % 16 == 0, "x must be 16-byte aligned")
    _require("int4_matmul", all(p % 4 == 0 for p in (q_ptr, s_ptr, zs_ptr)),
             "weights must be 4-byte aligned")
    tma = (gsz in (64, 128) and n % 16 == 0
           and all(p % 16 == 0 for p in (x_ptr, q_ptr, s_ptr, zs_ptr)))
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
    [m, 1] = rowmax|x| / 127.  An all-zero row quantizes to 0."""
    xf = x2.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xq = torch.where(amax > 0, torch.round(xf * (127.0 / torch.clamp_min(amax, 1e-30))), 0.0)
    return xq.to(torch.int8), amax / 127.0


def w4a8_matmul_ref(xg: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel E: xg [n_g, M, gsz] int8, q [K/2, N], s
    [n_g, N] -> acc [M, N] f32 = sum_g s[g] * (xg[g] @ nib[g]).  The group
    partials are an f32 product of integers, exact (|p| <= 127*15*gsz <
    2^24), so it runs on the card too, which has no integer matmul."""
    n_g, m, gsz = xg.shape
    pg = q.reshape(n_g, gsz // 2, -1)
    w_int = torch.cat([pg & 0xF, pg >> 4], dim=1).float()  # [n_g, gsz, N]
    p = torch.bmm(xg.float(), w_int)  # [n_g, M, N]
    return (p * s.float()[:, None, :]).sum(dim=0)


class W4A8Plan(NamedTuple):
    general: bool  # the general kernel (groups in pieces, byte loads for ragged N)


def _plan_w4a8(m: int, k: int, n: int, gsz: int, q_ptr: int, s_ptr: int) -> W4A8Plan:
    """Kernel E's launch for xg [k/gsz, m, gsz] int8 against q [k/2, n]
    and s [k/gsz, n] at these addresses.  E takes any group the route
    sends it and more: gsz % 16 == 0 up to ``W4A8_MAX_GSZ``, any n >= 1,
    weights 4-byte aligned as kernel D's wrapper takes them.  Groups up to
    128 with n % 4 == 0 and s 8-byte aligned take the kernel that stages a
    whole group with 16-byte copies; every other shape takes the general
    kernel, which stages a wider group (AutoAWQ's 256) in pieces and reads
    q and s byte by byte where n % 4 != 0 (a ragged last column tile)."""
    _require("w4a8_matmul", gsz % 16 == 0 and 0 < gsz <= W4A8_MAX_GSZ and k % gsz == 0,
             f"group size {gsz} must be a multiple of 16 dividing K {k}, at most {W4A8_MAX_GSZ}")
    _require("w4a8_matmul", m >= 0 and n >= 1, f"M {m}, N {n}")
    _require("w4a8_matmul", q_ptr % 4 == 0 and s_ptr % 4 == 0, "weights must be 4-byte aligned")
    return W4A8Plan(general=not (gsz <= 128 and n % 4 == 0 and s_ptr % 8 == 0))


def _w4a8_acc(xg, q, s):
    """Kernel E for CUDA tensors, its plain version for CPU tensors."""
    if xg.device.type == "cpu":
        return w4a8_matmul_ref(xg, q, s)
    n_g, m, gsz = xg.shape
    n = q.shape[-1]
    plan = _plan_w4a8(m, n_g * gsz, n, gsz, q.data_ptr(), s.data_ptr())
    acc = torch.empty((m, n), dtype=torch.float32, device=xg.device)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    err = kernels.launcher("w4a8_matmul")(
        xg.data_ptr(), q.data_ptr(), s.data_ptr(), acc.data_ptr(), m, n_g * gsz, n, gsz,
        int(plan.general), stream)
    kernels.check_launch("w4a8_matmul", err)
    w4a8_matmul.launches += 1
    return acc


def _w4a8(x, q, s, zs, out_dtype, acc_fn):
    """The W4A8 route around ``acc_fn`` (kernel E or its plain version):

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


def w4a8_matmul(x, q, s, zs, out_dtype=None):
    """The W4A8 route of ``int4_matmul``: int8 activations, kernel E for
    the group partials.  x [..., K] -> [..., N] in ``out_dtype``."""
    if x.device.type != "cpu":
        _check_weights("w4a8_matmul", x, q, s, zs, align=4)
    return _w4a8(x, q, s, zs, out_dtype, _w4a8_acc)


w4a8_matmul.launches = 0  # kernel E launches (CUDA path only)


def int4_matmul_plain(x, q, s, zs, out_dtype=None, w4a8: bool | None = None):
    """``int4_matmul``'s route through the plain versions, on any device."""
    if takes_w4a8(_rows(x), w4a8, _gsz(x, s), x.device.type == "cuda"):
        return _w4a8(x, q, s, zs, out_dtype, w4a8_matmul_ref)
    return int4_matmul_ref(x, q, s, zs, out_dtype)
