"""Qwen2-family decoder in PyTorch; port of ``githubrepostorag_tpu/models/qwen2.py``.

Architecture (HF ``Qwen2ForCausalLM``): token embedding, N blocks of
[RMSNorm -> GQA attention with QKV bias + RoPE -> residual, RMSNorm ->
SwiGLU MLP -> residual], final RMSNorm, (optionally tied) LM head.  A
config with ``num_experts`` > 0 (HF ``Qwen2MoeForCausalLM``) swaps every
layer's MLP for the sparse expert block of ``models/moe.py``.

Parameters are a plain dict with the JAX package's layout: per-layer leaves
stacked on a leading L axis (``params["layers"]["wq"]`` is [L, d, n_q*hd]),
linear weights stored [in, out] so the forward is ``x @ w``.  The fused
single-chip serving layout (``wqkv``/``bqkv``/``wgu``, models/quant.py) is
accepted wherever the unfused one is, and so are quantized leaves (int8
``QuantizedLinear``, int4 ``QuantizedLinear4``, an int8
``QuantizedEmbedding`` table): every projection goes through
``quant.qmatmul``, and the activation dtype is the final norm's.

Where the JAX functions return fresh caches and donate the old ones, these
update the KV caches and page pools IN PLACE and return the same tensors.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.models.moe import init_moe_layer_params, moe_mlp
from githubrepostorag_tpu_torch.models.quant import (
    QuantizedEmbedding,
    QuantizedLinear,
    QuantizedLinear4,
    dequant_weight,
    embedding_lookup,
    q4_dispatch,
    qmatmul,
)
from githubrepostorag_tpu_torch.ops.attention import dense_attention
from githubrepostorag_tpu_torch.ops.fused_decode import fused_paged_attention
from githubrepostorag_tpu_torch.ops.norms import rms_norm
from githubrepostorag_tpu_torch.ops.packed_prefill import packed_prefill_attention
from githubrepostorag_tpu_torch.ops.paged_attention import paged_attention_ref
from githubrepostorag_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from githubrepostorag_tpu_torch.parallel.collectives import (
    copy_to_axis,
    gather_from_axis,
    reduce_from_axis,
)
from githubrepostorag_tpu_torch.parallel.ring_attention import kv_group


@dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 32768
    # ---- MoE (Qwen2-MoE family: Qwen1.5-MoE-A2.7B / Qwen2-57B-A14B) ----
    # num_experts 0 = dense; > 0 switches every layer's MLP to the sparse
    # block (router top-k experts + always-on shared expert, models/moe.py)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = False
    # expert capacity = ceil(K*T/E * factor); 0.0 = exact no-drop dispatch
    capacity_factor: float = 0.0

    # ---- presets (HF config.json values) ----

    @classmethod
    def tiny(cls) -> "Qwen2Config":
        """Test-scale config (CI / parity tests)."""
        return cls(
            vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10_000.0,
            tie_word_embeddings=True, max_position_embeddings=512,
        )

    @classmethod
    def tiny_moe(cls) -> "Qwen2Config":
        """Test-scale MoE: 4 experts top-2 + shared expert."""
        return cls(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            rope_theta=10_000.0, tie_word_embeddings=True,
            max_position_embeddings=512,
            num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
            shared_expert_intermediate_size=96, norm_topk_prob=True,
        )

    @classmethod
    def qwen1_5_moe_a2_7b(cls) -> "Qwen2Config":
        """Qwen/Qwen1.5-MoE-A2.7B geometry (60 experts top-4 + shared)."""
        return cls(
            vocab_size=151936, hidden_size=2048, intermediate_size=5632,
            num_layers=24, num_heads=16, num_kv_heads=16, head_dim=128,
            tie_word_embeddings=False,
            num_experts=60, num_experts_per_tok=4, moe_intermediate_size=1408,
            shared_expert_intermediate_size=5632, norm_topk_prob=False,
            capacity_factor=2.0,
        )

    @classmethod
    def qwen2_0_5b(cls) -> "Qwen2Config":
        return cls(
            hidden_size=896, intermediate_size=4864, num_layers=24,
            num_heads=14, num_kv_heads=2, head_dim=64, tie_word_embeddings=True,
        )

    @classmethod
    def qwen2_1_5b(cls) -> "Qwen2Config":
        return cls(
            hidden_size=1536, intermediate_size=8960, num_layers=28,
            num_heads=12, num_kv_heads=2, head_dim=128, tie_word_embeddings=True,
        )

    @classmethod
    def qwen2_7b(cls) -> "Qwen2Config":
        return cls(
            hidden_size=3584, intermediate_size=18944, num_layers=28,
            num_heads=28, num_kv_heads=4, head_dim=128, tie_word_embeddings=False,
            vocab_size=152064,
        )


def init_params(cfg: Qwen2Config, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random init (normal 0.02, the HF default) with stacked layer leaves,
    drawn on ``device`` from ``generator`` (which must live there)."""
    dev = resolve_device(device)
    d, nq, nkv, hd = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    inter, L = cfg.intermediate_size, cfg.num_layers

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=dtype).mul_(0.02)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    params = {
        "embed": norm(cfg.vocab_size, d),
        "layers": {
            "ln1": ones(L, d), "ln2": ones(L, d),
            "wq": norm(L, d, nq * hd), "bq": zeros(L, nq * hd),
            "wk": norm(L, d, nkv * hd), "bk": zeros(L, nkv * hd),
            "wv": norm(L, d, nkv * hd), "bv": zeros(L, nkv * hd),
            "wo": norm(L, nq * hd, d),
        },
        "norm": ones(d),
    }
    if cfg.num_experts > 0:
        params["layers"].update(init_moe_layer_params(cfg, generator, dev, dtype))
    else:
        params["layers"].update({"wg": norm(L, d, inter), "wu": norm(L, d, inter),
                                 "wd": norm(L, inter, d)})
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm(d, cfg.vocab_size)
    return params


def layer_params(layers: dict, li: int) -> dict:
    """One layer's leaves: views into the stacked tensors, field by field
    for quantized NamedTuple leaves."""
    return {name: (type(leaf)(*(f[li] for f in leaf)) if isinstance(leaf, tuple) else leaf[li])
            for name, leaf in layers.items()}


def _block(cfg: Qwen2Config, h, p, cos, sin, attend, mm=qmatmul, mesh=None):
    """One transformer block.  ``attend(q, k, v) -> attn_out`` commits this
    step's K/V into whatever cache the caller uses and returns the
    attention output, so the dense and paged paths share this body.
    ``mm(x, w)`` runs every projection (``qmatmul`` with the caller's int4
    route).

    ``mesh``: the leaves are this rank's Megatron slices over its tp axis
    (``parallel/sharding.py``; the head counts come from the sliced
    weights).  The input of a column-parallel projection is copied into the
    axis and the output of a row-parallel one summed over it, the
    collectives GSPMD inserts for JAX; replicated K/V under a query shard
    give this rank its queries' K/V heads (``kv_group``).  An MoE layer's
    experts split over ep (``moe_mlp``)."""
    b, s, _ = h.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = _tp_group(mesh)

    hn = rms_norm(h, p["ln1"], cfg.rms_norm_eps)
    q_col = False
    if "wqkv" in p:  # fused single-chip serving layout
        q, k, v = torch.split(mm(hn, p["wqkv"]) + p["bqkv"],
                              [nq * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q_col = _tp_split(mesh, _out_features(p["wq"]), nq * hd)
        kv_col = _tp_split(mesh, _out_features(p["wk"]), nkv * hd)
        hq = copy_to_axis(hn, tp) if q_col else hn
        hk = hq if kv_col else hn
        q = mm(hq, p["wq"]) + p["bq"]
        k = mm(hk, p["wk"]) + p["bk"]
        v = mm(hk, p["wv"]) + p["bv"]
    nq_loc, nkv_loc = q.shape[-1] // hd, k.shape[-1] // hd
    q = q.reshape(b, s, nq_loc, hd)
    k = k.reshape(b, s, nkv_loc, hd)
    v = v.reshape(b, s, nkv_loc, hd)
    q, k = apply_rope(q, k, cos, sin)
    if tp is not None and nq_loc < nq and nkv_loc == nkv:
        # replicated K/V read by a query shard: the copy makes backward sum
        # the ranks' gradients of the heads each one kept
        k = kv_group(copy_to_axis(k, tp), mesh, nq, nkv)
        v = kv_group(copy_to_axis(v, tp), mesh, nq, nkv)

    attn = attend(q, k, v)
    o = mm(attn.reshape(b, s, nq_loc * hd), p["wo"])
    h = h + (reduce_from_axis(o, tp) if q_col else o)

    hn = rms_norm(h, p["ln2"], cfg.rms_norm_eps)
    if "router" in p:  # sparse MoE MLP (Qwen2-MoE family, models/moe.py)
        return h + moe_mlp(cfg, p, hn, mm, mesh=mesh)
    if "wgu" in p:
        g, u = torch.chunk(mm(hn, p["wgu"]), 2, dim=-1)
        return h + mm(F.silu(g) * u, p["wd"])
    mlp_col = _tp_split(mesh, _out_features(p["wg"]), cfg.intermediate_size)
    hm = copy_to_axis(hn, tp) if mlp_col else hn
    g, u = mm(hm, p["wg"]), mm(hm, p["wu"])
    o = mm(F.silu(g) * u, p["wd"])
    return h + (reduce_from_axis(o, tp) if mlp_col else o)


def _out_features(w) -> int:
    """Output width of a plain or quantized [.., in, out] projection."""
    return (w.q if isinstance(w, tuple) else w).shape[-1]


def _tp_group(mesh):
    """The tp process group when ``mesh`` splits the model over tp > 1: at
    tp 1 no collective is issued, as JAX's GSPMD inserts none there (a
    size-1 NCCL all-reduce still costs host time on every layer)."""
    return mesh.group("tp") if mesh is not None and mesh.shape["tp"] > 1 else None


def _tp_split(mesh, local: int, full: int) -> bool:
    """Whether a leaf ``local`` wide of ``full`` is this rank's tp slice,
    so its matmul takes Megatron's collectives (the one rule of ``_block``,
    ``_embed`` and ``_mesh_logits``)."""
    return _tp_group(mesh) is not None and local < full


def _embed(params: dict, cfg: Qwen2Config, input_ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """The embedding of ``input_ids``.  On a mesh whose tp splits the table
    it is vocab-parallel: a rank looks up its rows (ids outside them give
    zero rows) and the ranks' rows are summed over tp."""
    tp = _tp_group(mesh)
    embed = params["embed"]
    rows = (embed.q if isinstance(embed, QuantizedEmbedding) else embed).shape[0]
    if not _tp_split(mesh, rows, cfg.vocab_size):
        return embedding_lookup(embed, input_ids, _embed_dtype(params))
    local = input_ids.long() - mesh.coords["tp"] * rows
    inside = (local >= 0) & (local < rows)
    h = embedding_lookup(embed, local.clamp(0, rows - 1), _embed_dtype(params))
    return reduce_from_axis(h.masked_fill(~inside[..., None], 0), tp)


def _mesh_logits(params: dict, cfg: Qwen2Config, h: torch.Tensor, mesh=None,
                 w4a8: bool | None = None, kernel: bool = True) -> torch.Tensor:
    """``_logits`` on a mesh: when tp splits the head (the untied lm_head's
    columns, or the tied table's rows) a rank projects its vocab slice and
    the slices are gathered, so the logits come back whole on every tp
    rank."""
    tp = _tp_group(mesh)
    head = params.get("lm_head", params["embed"])
    if "lm_head" in params:
        width = _out_features(head)
    else:
        width = (head.q if isinstance(head, QuantizedEmbedding) else head).shape[0]
    if not _tp_split(mesh, width, cfg.vocab_size):
        return _logits(params, h, w4a8=w4a8, kernel=kernel)
    return gather_from_axis(_logits(params, copy_to_axis(h, tp), w4a8=w4a8, kernel=kernel),
                            tp, dim=-1)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a float32 result from operands in their stored dtype
    (the JAX ``preferred_element_type=float32`` contraction): a bf16 result
    would flip the argmax of near-tied logits, and upcasting the weight
    would copy the whole matrix every call."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def _embed_dtype(params: dict) -> torch.dtype:
    """Activation dtype of a param tree: the final norm's, a plain tensor
    in every layout (the embedding table may be int8)."""
    return params["norm"].dtype


def _logits(params: dict, h: torch.Tensor, w4a8: bool | None = None,
            kernel: bool = True) -> torch.Tensor:
    """Final projection -> float32 logits: tied embedding (plain or int8,
    whose per-row scales apply to the logits), or lm_head (plain, int8 as
    the AWQ repacker leaves it, or int4 through ``q4_dispatch``, which
    writes float32 directly)."""
    lm_head = params.get("lm_head")
    if lm_head is None:
        embed = params["embed"]
        if isinstance(embed, QuantizedEmbedding):
            return matmul_f32(h, embed.q.to(h.dtype).t()) * embed.s.float()
        return matmul_f32(h, embed.t())
    if isinstance(lm_head, QuantizedLinear4):
        return q4_dispatch(h, lm_head, out_dtype=torch.float32, kernel=kernel, w4a8=w4a8)
    if isinstance(lm_head, QuantizedLinear):
        return matmul_f32(h, dequant_weight(lm_head, h.dtype))
    return matmul_f32(h, lm_head)


def forward(params: dict, cfg: Qwen2Config, input_ids, positions, cache_k=None,
            cache_v=None, kv_lengths=None, use_kernels: bool = True):
    """Full forward -> (logits [B, S, V] float32, (cache_k, cache_v) or None).

    int4 projections and logits take the automatic route (kernel E for at
    most 256 rows, else kernel D); ``use_kernels=False`` takes the same
    route through the plain versions.

    Without a cache: causal attention over the input.  With a dense cache
    ([L, B, S_cache, n_kv, hd]): new K/V are written in place at each row's
    ``kv_lengths`` offset and attention covers the cache.  The JAX version's
    ``dynamic_update_slice`` clamps out-of-range starts; here
    ``kv_lengths + S`` beyond the cache raises instead."""
    h = embedding_lookup(params["embed"], input_ids, _embed_dtype(params))
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    b, s = input_ids.shape
    mm = functools.partial(qmatmul, kernel=use_kernels)
    use_cache = cache_k is not None
    if use_cache:
        if int((kv_lengths + s).max()) > cache_k.shape[2]:
            raise ValueError("kv_lengths + S exceeds the cache length")
        rows = torch.arange(b, device=h.device)[:, None]
        slots = kv_lengths.long()[:, None] + torch.arange(s, device=h.device)

    for li in range(cfg.num_layers):
        p = layer_params(params["layers"], li)
        if use_cache:
            ck, cv = cache_k[li], cache_v[li]

            def attend(q, k, v):
                ck[rows, slots] = k.to(ck.dtype)
                cv[rows, slots] = v.to(cv.dtype)
                return dense_attention(q, ck, cv, causal=True, q_offset=kv_lengths,
                                       kv_lengths=kv_lengths + s)
        else:
            def attend(q, k, v):
                return dense_attention(q, k, v, causal=True, q_offset=0)
        h = _block(cfg, h, p, cos, sin, attend, mm)

    h = rms_norm(h, params["norm"], cfg.rms_norm_eps)
    logits = _logits(params, h, kernel=use_kernels)
    return logits, ((cache_k, cache_v) if use_cache else None)


def forward_with_attend(params: dict, cfg: Qwen2Config, input_ids: torch.Tensor,
                        positions: torch.Tensor, attend_fn=None, remat: bool = False,
                        mesh=None):
    """Cache-free forward with a pluggable attention implementation ->
    logits [B, S, V] float32.

    ``attend_fn(q, k, v) -> out`` defaults to causal dense attention; the
    training path passes ``parallel.make_ring_attend(...)`` so the sequence
    axis can live sharded over ``sp``.  ``remat`` recomputes each layer in
    backward (``torch.utils.checkpoint``) instead of keeping its
    activations, so training holds one layer's at a time; it acts only
    while autograd records, and the recompute runs the layer's
    collectives again, on every rank in the same order.

    ``mesh`` (``parallel.mesh.Mesh``): ``params`` are this rank's slices
    (``parallel.sharding.shard_params``); over tp the embedding and the
    logits are vocab-parallel (a rank's rows, then a sum; its logit
    columns, then a gather) and every block runs Megatron's pair of
    collectives; an MoE tree's experts split over ep (``moe_mlp``).  The
    returned logits are whole on every tp rank."""
    if attend_fn is None:
        def attend_fn(q, k, v):
            return dense_attention(q, k, v, causal=True, q_offset=0)

    h = _embed(params, cfg, input_ids, mesh)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    def body(h, p):
        return _block(cfg, h, p, cos, sin, attend_fn, mesh=mesh)

    for li in range(cfg.num_layers):
        p = layer_params(params["layers"], li)
        if remat and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(body, h, p, use_reentrant=False)
        else:
            h = body(h, p)
    h = rms_norm(h, params["norm"], cfg.rms_norm_eps)
    return _mesh_logits(params, cfg, h, mesh)


def forward_paged(
    params: dict,
    cfg: Qwen2Config,
    input_ids: torch.Tensor,  # [B, S] int, right-padded per row
    positions: torch.Tensor,  # [B, S] int absolute positions
    k_pages: torch.Tensor,  # [L, n_kv, P, page_size, hd], updated in place
    v_pages: torch.Tensor,
    slot_mapping: torch.Tensor,  # [B, S] int flat pool slots, -1 for padding
    block_tables: torch.Tensor,  # [B, max_pages] int32
    cached_lens: torch.Tensor,  # [B] int32 tokens in cache before this step
    new_lens: torch.Tensor,  # [B] int32 valid new tokens this step
    use_kernels: bool = True,
    logits_at: torch.Tensor | None = None,  # [B] per-row chunk index
    k_scales: torch.Tensor | None = None,  # [L, n_kv, P] f32 per-page scales
    v_scales: torch.Tensor | None = None,  # of int8 / int4 pools, in place
    mesh=None,
):
    """Prefill-chunk step over the paged KV cache (the JAX
    ``forward_paged`` and its unjitted body ``forward_paged_impl`` in one:
    nothing here is traced).

    Each layer's new K/V are committed into the pools at ``slot_mapping``
    (padding slots are dropped), then attention runs over each row's block
    table: through kernel A (``ops/fused_decode.py``) with ``use_kernels``,
    else through the plain ``paged_attention_ref``.  ``k_scales``/
    ``v_scales`` mark quantized pools (int8, or uint8 int4 nibble planes):
    the commit quantizes per page with first-write scales
    (``kv_cache.quantize_kv_paged``) and attention dequantizes.  int4
    projections and the logits pin the exact bf16-dequant route
    (``w4a8=False``): kernel D with ``use_kernels``, else its plain version,
    so prompt processing never takes the W4A8 contract even at a
    decode-sized chunk.  ``logits_at`` projects logits at one chunk
    position per row ([B, 1, V]) instead of every position.  Returns
    (logits float32, k_pages, v_pages), and k_scales, v_scales after them
    when quantized, as the JAX function does.

    ``mesh``: ``params`` are this rank's slices and the pools hold its
    ``n_kv / tp`` heads (``kv_cache.make_page_pools(mesh=)``); the embedding
    and the logits are vocab-parallel, every block runs Megatron's pair of
    collectives, and attention runs on this rank's heads with no collective
    (the JAX ``shard_map`` island).  The logits come back whole on every tp
    rank."""
    attn_fn = fused_paged_attention if use_kernels else paged_attention_ref

    def attend_layer(q, kp, vp, ks, vs):
        return attn_fn(q, kp, vp, block_tables, cached_lens, new_lens, ks, vs)

    h = _paged_layers(params, cfg, input_ids, positions, k_pages, v_pages, slot_mapping,
                      k_scales, v_scales, attend_layer, use_kernels, mesh)
    if logits_at is not None:
        h = h[torch.arange(h.shape[0], device=h.device), logits_at.long()][:, None, :]
    logits = _mesh_logits(params, cfg, h, mesh, w4a8=False, kernel=use_kernels)
    if k_scales is not None:
        return logits, k_pages, v_pages, k_scales, v_scales
    return logits, k_pages, v_pages


def forward_paged_packed(
    params: dict,
    cfg: Qwen2Config,
    input_ids: torch.Tensor,  # [1, T] int packed token buffer (T = budget)
    positions: torch.Tensor,  # [1, T] int absolute position per token
    k_pages: torch.Tensor,  # [L, n_kv, P, page_size, hd], updated in place
    v_pages: torch.Tensor,
    slot_mapping: torch.Tensor,  # [T] int flat pool slots, -1 for padding
    block_tables: torch.Tensor,  # [R, max_pages] int32 per segment
    cached_lens: torch.Tensor,  # [R] int32 tokens in cache before this chunk
    new_lens: torch.Tensor,  # [R] int32 new tokens this chunk
    seg_ids: torch.Tensor,  # [T] int32 owning segment; >= R marks padding
    logits_at: torch.Tensor,  # [R] packed index of each segment's last token
    tq: int,  # per-segment chunk cap, min(prefill_chunk, budget)
    use_kernels: bool = True,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    mesh=None,
):
    """Token-budget packed prefill step over the paged KV cache: one flat
    [1, budget] buffer holds every prefilling row's next chunk back to
    back, so the dense layers scale with real tokens.  K/V commit as in
    ``forward_paged``; attention is per segment through
    ``ops/packed_prefill.packed_prefill_attention`` (kernel C over
    full-precision pools, kernel A over quantized ones, with
    ``use_kernels``).  int4 projections pin ``w4a8=False`` as
    ``forward_paged`` does; ``mesh`` as there.  Returns (logits [R, 1, V]
    float32 at each segment's ``logits_at``, k_pages, v_pages[, k_scales,
    v_scales])."""
    seg_flat = seg_ids.reshape(-1).to(torch.int32)
    pos_flat = positions.reshape(-1).to(torch.int32)

    def attend_layer(q, kp, vp, ks, vs):
        return packed_prefill_attention(
            q[0], kp, vp, block_tables, cached_lens, new_lens, seg_flat, pos_flat, tq=tq,
            use_kernels=use_kernels, k_scales=ks, v_scales=vs)[None]

    h = _paged_layers(params, cfg, input_ids, positions, k_pages, v_pages, slot_mapping,
                      k_scales, v_scales, attend_layer, use_kernels, mesh)
    h = h[0, logits_at.long()][:, None, :]  # [R, 1, d]
    logits = _mesh_logits(params, cfg, h, mesh, w4a8=False, kernel=use_kernels)
    if k_scales is not None:
        return logits, k_pages, v_pages, k_scales, v_scales
    return logits, k_pages, v_pages


def _paged_layers(params, cfg, input_ids, positions, k_pages, v_pages, slot_mapping,
                  k_scales, v_scales, attend_layer, use_kernels, mesh=None):
    """The layer loop shared by ``forward_paged`` and ``forward_paged_packed``:
    each layer commits its new K/V (and, for quantized pools, their page
    scales) in place with ``commit_paged``, then ``attend_layer(q, kp, vp,
    ks, vs)`` runs attention over the layer's pools.  On a mesh the K/V
    heads are this rank's, as are its pools'.  Returns the final normed
    hidden states."""
    from githubrepostorag_tpu_torch.serving.kv_cache import commit_paged

    mm = functools.partial(qmatmul, w4a8=False, kernel=use_kernels)
    hd = cfg.head_dim
    page_size = k_pages.shape[3]
    quant = k_scales is not None

    h = _embed(params, cfg, input_ids, mesh)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    flat_slots = slot_mapping.reshape(-1)

    for li in range(cfg.num_layers):
        p = layer_params(params["layers"], li)
        kp, vp = k_pages[li], v_pages[li]
        ks, vs = (k_scales[li], v_scales[li]) if quant else (None, None)

        def attend(q, k, v):
            nkv = k.shape[2]
            commit_paged(kp, k.reshape(-1, nkv, hd).transpose(0, 1), flat_slots, page_size, ks)
            commit_paged(vp, v.reshape(-1, nkv, hd).transpose(0, 1), flat_slots, page_size, vs)
            return attend_layer(q, kp, vp, ks, vs)

        h = _block(cfg, h, p, cos, sin, attend, mm, mesh=mesh)

    return rms_norm(h, params["norm"], cfg.rms_norm_eps)
