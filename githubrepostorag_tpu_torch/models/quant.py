"""Weight-only quantization for the decoder; port of
``githubrepostorag_tpu/models/quant.py``.

Two schemes, as in the JAX package:

- int8, per output channel (``QuantizedLinear``), and per vocab row for the
  embedding table (``QuantizedEmbedding``);
- AWQ-class group-wise asymmetric uint4 (``QuantizedLinear4``), the scheme
  the reference deployment serves (Qwen2.5-Coder-7B-Instruct-AWQ).  The
  embedding table stays per-row int8 under either scheme.

Quantized leaves are NamedTuples of tensors, stacked on a leading L axis
like every layer leaf; ``qwen2.layer_params`` slices each field to a view
of one layer, so the kernels read one layer's weights in place.  Matmuls
go through ``qmatmul``: plain and int8 weights dequantize in plain torch;
int4 routes through ``q4_dispatch`` to the hand-written kernels of
``ops/int4_matmul.py`` (kernel D, bf16-dequant, for prefill; kernel E,
W4A8, for decode-sized batches).

Quantizing computes on the tensor's own device, one layer at a time for
stacked leaves, so a 7B tree quantizes on the card without an f32 copy of
a whole stack (the JAX package quantizes in host numpy to spare a 16 GB
chip; the quantized values are the same bits).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.ops.int4_matmul import (
    dequant4,
    int4_matmul,
    int4_matmul_plain,
)


class QuantizedLinear(NamedTuple):
    """Weight-only int8 projection: ``q`` int8 [.., in, out], ``s`` bf16 per
    OUTPUT channel [.., out]."""

    q: torch.Tensor
    s: torch.Tensor


class QuantizedEmbedding(NamedTuple):
    """Weight-only int8 embedding table: ``q`` int8 [V, d], ``s`` bf16 per
    vocab ROW [V].  A type of its own because its scale axis differs from
    QuantizedLinear's."""

    q: torch.Tensor
    s: torch.Tensor


class QuantizedLinear4(NamedTuple):
    """Weight-only group-wise asymmetric uint4 projection:

        w[i, o] ~= q[i, o] * s[i // gsz, o] - zs[i // gsz, o]

    ``q`` uint8 [.., in/2, out] packs two nibbles per byte plane-wise WITHIN
    each group: byte row j of group g holds row g*gsz + j in its low nibble
    and row g*gsz + j + gsz/2 in its high nibble.  ``s`` and ``zs`` are
    bf16 [.., in/gsz, out] (zs = -group_min, so dequant is one
    multiply-subtract)."""

    q: torch.Tensor
    s: torch.Tensor
    zs: torch.Tensor


QUANTIZED_TYPES = (QuantizedLinear, QuantizedLinear4, QuantizedEmbedding)


def _per_layer(fn, w: torch.Tensor):
    """``fn`` over a [in, out] leaf, or over each layer of a stacked
    [L, .., in, out] leaf into preallocated stacked outputs (one layer's f32
    transient at a time; an MoE expert stack [L, E, in, out] passes its
    layer's [E, in, out] to ``fn``, which keeps leading axes)."""
    if w.dim() == 2:
        return fn(w)
    first = fn(w[0])
    out = type(first)(*(torch.empty((w.shape[0], *f.shape), dtype=f.dtype, device=f.device)
                        for f in first))
    for li in range(w.shape[0]):
        part = first if li == 0 else fn(w[li])
        for dst, src in zip(out, part):
            dst[li] = src
    return out


def _quantize_symmetric(w: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``dim``: scale = max|w| / 127 (floored at 1e-8),
    q = round-half-even(w / scale) clipped to +-127, bf16 scales."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=dim, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(dim).to(torch.bfloat16)


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Per-output-channel symmetric int8 of a [in, out] or stacked
    [L, .., in, out] weight; scales are [out] / [L, .., out] (per expert
    and output channel for an expert stack)."""
    return _per_layer(lambda x: QuantizedLinear(*_quantize_symmetric(x, dim=-2)), w)


def _quantize4(w: torch.Tensor, group_size: int) -> QuantizedLinear4:
    *lead, in_dim, out = w.shape
    n_g, half = in_dim // group_size, group_size // 2
    grouped = w.float().reshape(*lead, n_g, group_size, out)
    mx = grouped.amax(dim=-2, keepdim=True)
    mn = grouped.amin(dim=-2, keepdim=True)
    scale = torch.clamp_min((mx - mn) / 15.0, 1e-8)
    # zs is bf16, not a nibble, so no [0, 15] clamp on the zero point
    q = torch.clamp(torch.round((grouped - mn) / scale), 0, 15).to(torch.uint8)
    packed = (q[..., :half, :] | (q[..., half:, :] << 4)).reshape(*lead, in_dim // 2, out)
    return QuantizedLinear4(q=packed, s=scale.squeeze(-2).to(torch.bfloat16),
                            zs=(-mn).squeeze(-2).to(torch.bfloat16))


def quantize_weight4(w: torch.Tensor, group_size: int = 64) -> QuantizedLinear4:
    """Group-wise asymmetric uint4 (AWQ-class) of a [in, out] or stacked
    [L, .., in, out] weight; groups of ``group_size`` run along the input axis.
    64 is the default because every Qwen2 input dimension splits into whole
    64-row groups."""
    in_dim = w.shape[-2]
    if group_size % 2 or in_dim % group_size:
        raise ValueError(
            f"input dim {in_dim} must be divisible by the (even) group_size "
            f"{group_size} for in-group nibble plane packing")
    return _per_layer(lambda x: _quantize4(x, group_size), w)


def quantize_embedding(w: torch.Tensor) -> QuantizedEmbedding:
    """Per-ROW symmetric int8 of the embedding table [V, d]."""
    return QuantizedEmbedding(*_quantize_symmetric(w, dim=-1))


def dequant_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """Compute-dtype view of a maybe-quantized linear weight, rounded in
    ``dtype`` as the JAX package's ``dequant_weight`` rounds."""
    if isinstance(w, QuantizedLinear):
        return w.q.to(dtype) * w.s.to(dtype)[..., None, :]
    if isinstance(w, QuantizedLinear4):
        return dequant4(w.q, w.s, w.zs, dtype)
    return w


def dequantize(t, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Full-precision reconstruction (f32 math, then cast) for tests."""
    if isinstance(t, QuantizedLinear4):
        return dequant4(t.q, t.s.float(), t.zs.float(), torch.float32).to(dtype)
    return (t.q.float() * t.s.float()[..., None, :]).to(dtype)


def q4_matmul(x: torch.Tensor, w: QuantizedLinear4, preferred: torch.dtype | None = None):
    """``x @ dequant(w)`` as two dots plus a zero-point correction, never
    unpacking the weight into one matrix (the JAX package's XLA oracle):

        y = x_lo @ (lo(q)*s) + x_hi @ (hi(q)*s) - (sum_j x)[g] @ zs[g]

    ``w`` leaves are one layer's ([in/2, out]).  ``preferred``: the
    accumulation dtype (float32 for logits)."""
    lead, in_dim = x.shape[:-1], x.shape[-1]
    n_g, out = w.s.shape[-2], w.q.shape[-1]
    gsz = in_dim // n_g
    half = gsz // 2
    dt = x.dtype
    pg = w.q.reshape(n_g, half, out)
    s = w.s[:, None, :].to(dt)
    lo = (pg & 0xF).to(dt) * s
    hi = (pg >> 4).to(dt) * s
    xg = x.reshape(*lead, n_g, gsz)
    acc = preferred or dt
    x_lo, x_hi = xg[..., :half].to(acc), xg[..., half:].to(acc)
    return (torch.einsum("...gj,gjo->...o", x_lo, lo.to(acc))
            + torch.einsum("...gj,gjo->...o", x_hi, hi.to(acc))
            - torch.einsum("...g,go->...o", xg.sum(dim=-1).to(acc), w.zs.to(dt).to(acc)))


def q4_dispatch(x: torch.Tensor, w: QuantizedLinear4, out_dtype: torch.dtype | None = None,
                kernel: bool = True, w4a8: bool | None = None) -> torch.Tensor:
    """THE int4 matmul router (``qmatmul`` and ``_logits`` go through here).
    ``w4a8`` None sends decode-sized batches (rows <= 256, unless
    ``INT4_W4A8=0``) to kernel E and the rest to kernel D; False forces D.
    ``kernel=False`` takes the same route through the plain versions (the
    comparison path of ``forward_paged(use_kernels=False)``)."""
    fn = int4_matmul if kernel else int4_matmul_plain
    return fn(x, w.q, w.s, w.zs, out_dtype=out_dtype, w4a8=w4a8)


def qmatmul(x: torch.Tensor, w, w4a8: bool | None = None, kernel: bool = True) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain tensor, QuantizedLinear (int8) or
    QuantizedLinear4 (int4, through ``q4_dispatch``)."""
    if isinstance(w, QuantizedLinear4):
        return q4_dispatch(x, w, kernel=kernel, w4a8=w4a8)
    if isinstance(w, QuantizedLinear):
        return x @ dequant_weight(w, x.dtype)
    return x @ w


def embedding_lookup(embed, ids: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Token embedding gather for plain or int8 tables.  An int8 table's
    rows are scaled in ``dtype`` (the activation dtype, from the caller);
    a plain table returns its own dtype."""
    idx = ids.long()
    if isinstance(embed, QuantizedEmbedding):
        return embed.q[idx].to(dtype) * embed.s[idx][..., None].to(dtype)
    return embed[idx]


def _concat_linears(ws: list):
    """Concatenate same-input linear leaves on the OUTPUT axis: every
    per-output quantity (int8 columns and per-channel scales; int4 packed
    columns and per-group s/zs) concatenates on its last axis while the
    input-axis structure stays as it was."""
    w0 = ws[0]
    if isinstance(w0, (QuantizedLinear, QuantizedLinear4)):
        return type(w0)(*(torch.cat(fields, dim=-1) for fields in zip(*ws)))
    return torch.cat(ws, dim=-1)


def fuse_projections(params: dict, in_place: bool = False) -> dict:
    """Single-chip serving layout: fuse wq|wk|wv -> wqkv (and their biases)
    and wg|wu -> wgu along the output axis, so each layer runs 4 projection
    matmuls instead of 7; the model block splits activations after the
    matmul.  Plain and quantized leaves alike; MoE leaves pass through
    untouched.  ``in_place=True`` pops each
    per-projection leaf from ``params["layers"]`` so a solely-owned tree
    never holds both layouts once the old leaves are released; the default
    copies the dicts and leaves a caller-shared tree as it was.
    Already-fused trees pass through."""
    if not in_place:
        params = dict(params, layers=dict(params["layers"]))
    layers = params["layers"]
    if "wq" in layers:
        layers["wqkv"] = _concat_linears([layers.pop("wq"), layers.pop("wk"), layers.pop("wv")])
        layers["bqkv"] = torch.cat([layers.pop("bq"), layers.pop("bk"), layers.pop("bv")], dim=-1)
    if "wg" in layers:
        layers["wgu"] = _concat_linears([layers.pop("wg"), layers.pop("wu")])
    return params


# the MoE expert and shared-expert stacks too; the router and the [d, 1]
# shared gate stay full precision (routing is the precision-sensitive part)
_PROJECTIONS = ("wq", "wk", "wv", "wqkv", "wo", "wg", "wu", "wgu", "wd",
                "e_wg", "e_wu", "e_wd", "s_wg", "s_wu", "s_wd")


def quantize_qwen2_params(params: dict, embeddings: bool = True, bits: int = 8,
                          group_size: int = 64) -> dict:
    """Quantize every linear projection of a Qwen2(-MoE) tree (fused or
    unfused; expert stacks with per-expert scales), the lm_head when
    present and, by default, the embedding table; norms, biases, the MoE
    router and the shared-expert gate stay as they are.  ``bits=4`` takes
    the group-wise uint4 scheme for projections; the embedding table is
    per-row int8 either way.  Stacked leaves quantize one layer at a time
    on their own device."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qw = quantize_weight if bits == 8 else (lambda w: quantize_weight4(w, group_size))
    layers = dict(params["layers"])
    names = [n for n in _PROJECTIONS if n in layers]
    if not names:
        # a renamed tree would otherwise serve full precision silently
        raise ValueError(
            "quantize_qwen2_params: no known projection leaf found in "
            f"params['layers'] (keys: {sorted(layers)})")
    for name in names:
        layers[name] = qw(layers[name])
    out = dict(params, layers=layers)
    if "lm_head" in params:
        out["lm_head"] = qw(params["lm_head"])
    if embeddings:
        out["embed"] = quantize_embedding(params["embed"])
    return out


def init_params_quantized(cfg, generator: torch.Generator, device=None, bits: int = 8,
                          group_size: int = 64, fuse: bool = False) -> dict:
    """Random quantized Qwen2 params (int8 or int4) drawn leaf by leaf on
    ``device`` from ``generator`` (which must live there), with bf16 norms
    and biases.  Scales are constant per leaf (dequantized std about 0.02):
    for benches, whose speed does not depend on weight values, not for
    checking a kernel's scale indexing.  MoE configs raise, as in JAX: a
    real MoE checkpoint quantizes through ``load_qwen2(..., quantize=...)``."""
    if getattr(cfg, "num_experts", 0):
        raise NotImplementedError(
            "random quantized MoE init is not implemented (this helper exists "
            "for dense-geometry benches); real MoE checkpoints quantize "
            "through load_qwen2(..., quantize=True)")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    dev = resolve_device(device)
    d, nq, nkv, hd = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    inter, L, v = cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    bf16 = torch.bfloat16

    def randint(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=generator, device=dev, dtype=dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=bf16, device=dev)

    def qlin8(*shape):
        # uniform int8 in +-127 has std ~73
        return QuantizedLinear(q=randint(-127, 128, shape, torch.int8),
                               s=full(shape[:-2] + shape[-1:], 0.02 / 73.0))

    def qlin4(*shape):
        in_dim, out = shape[-2], shape[-1]
        if group_size % 2 or in_dim % group_size:
            raise ValueError(f"input dim {in_dim} must be divisible by the (even) "
                             f"group_size {group_size}")
        sshape = shape[:-2] + (in_dim // group_size, out)
        # uniform uint4 has std ~4.6; zs = 7.5 * s centres it
        return QuantizedLinear4(q=randint(0, 256, shape[:-2] + (in_dim // 2, out), torch.uint8),
                                s=full(sshape, 0.02 / 4.6), zs=full(sshape, 7.5 * 0.02 / 4.6))

    qlin = qlin8 if bits == 8 else qlin4
    layers = {"ln1": full((L, d), 1.0), "ln2": full((L, d), 1.0),
              "wo": qlin(L, nq * hd, d), "wd": qlin(L, inter, d)}
    if fuse:
        layers.update({"wqkv": qlin(L, d, (nq + 2 * nkv) * hd),
                       "bqkv": full((L, (nq + 2 * nkv) * hd), 0.0),
                       "wgu": qlin(L, d, 2 * inter)})
    else:
        layers.update({"wq": qlin(L, d, nq * hd), "bq": full((L, nq * hd), 0.0),
                       "wk": qlin(L, d, nkv * hd), "bk": full((L, nkv * hd), 0.0),
                       "wv": qlin(L, d, nkv * hd), "bv": full((L, nkv * hd), 0.0),
                       "wg": qlin(L, d, inter), "wu": qlin(L, d, inter)})
    params = {"embed": QuantizedEmbedding(q=randint(-127, 128, (v, d), torch.int8),
                                          s=full((v,), 0.02 / 73.0)),
              "layers": layers, "norm": full((d,), 1.0)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = qlin(d, v)
    return params


def params_nbytes(params: dict) -> int:
    """Bytes of every tensor of a param tree, quantized leaves' fields
    included."""
    total = 0
    for node in params.values():
        if isinstance(node, dict):
            total += params_nbytes(node)
        else:
            total += sum(t.numel() * t.element_size()
                         for t in (node if isinstance(node, tuple) else (node,)))
    return total
