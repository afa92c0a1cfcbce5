"""BERT-class text encoder in PyTorch (e5-small-v2 geometry: 12 layers,
hidden 384, 12 heads, GELU FFN 1536, learned positions, post-layer-norm
blocks, mean pooling + L2 normalization); port of
``githubrepostorag_tpu/models/encoder.py``.

The parameter tree is the JAX package's: a dict with the embedding
tables, the embedding layer norm, and ``layers``, a dict of tensors
stacked over the layer axis (``wq`` is ``[L, d, d]``, input-major as in
``h @ wq``).  ``models/convert.encoder_params_from_jax`` turns the JAX
tree into this one.

The arithmetic follows the JAX module step by step: an additive mask of
-1e30 (not -inf: a row with no real token gets a uniform softmax, not
NaN), a float32 softmax, exact GELU, layer norms computed in float32 with
``rsqrt``, position ids ``arange(S)``, token type 0, and the pooling
floors 1e-9 and 1e-12.  Weights are float32.  On the card every matmul of
``forward`` runs in IEEE float32 whatever ``allow_tf32`` says
(``ieee_float32``): TF32's 10-bit mantissa would move embeddings by
~1e-3.  A float64 tree computes in float64 throughout (the checking path).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from githubrepostorag_tpu_torch.device import ieee_float32, resolve_device


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    intermediate_size: int = 1536
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def e5_small(cls) -> "BertConfig":
        """intfloat/e5-small-v2 geometry (also BAAI/bge-small-en-v1.5's)."""
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(
            vocab_size=256, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_position_embeddings=64,
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


_LAYER_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ln_attn_w", "ln_attn_b",
               "w1", "b1", "w2", "b2", "ln_ffn_w", "ln_ffn_b")


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for a float64 tree (JAX's ``astype(float32)``
    steps, which never lower precision)."""
    return torch.promote_types(dtype, torch.float32)


def _layer_norm(x, weight, bias, eps):
    xf = x.to(_compute_dtype(x.dtype))
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def init_params(cfg: BertConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random weights: normal(0, 0.02) matrices and tables, unit layer-norm
    scales, zero biases, drawn from ``generator`` on its own device and
    placed on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    d, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def norm(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device) * 0.02
        return w.to(device=dev, dtype=dtype)

    def const(value, *shape):
        return torch.full(shape, value, device=dev, dtype=dtype)

    layers = {
        "wq": norm(L, d, d), "bq": const(0.0, L, d),
        "wk": norm(L, d, d), "bk": const(0.0, L, d),
        "wv": norm(L, d, d), "bv": const(0.0, L, d),
        "wo": norm(L, d, d), "bo": const(0.0, L, d),
        "ln_attn_w": const(1.0, L, d), "ln_attn_b": const(0.0, L, d),
        "w1": norm(L, d, inter), "b1": const(0.0, L, inter),
        "w2": norm(L, inter, d), "b2": const(0.0, L, d),
        "ln_ffn_w": const(1.0, L, d), "ln_ffn_b": const(0.0, L, d),
    }
    return {
        "word_embeddings": norm(cfg.vocab_size, d),
        "position_embeddings": norm(cfg.max_position_embeddings, d),
        "token_type_embeddings": norm(cfg.type_vocab_size, d),
        "ln_embed_w": const(1.0, d),
        "ln_embed_b": const(0.0, d),
        "layers": layers,
    }


def forward(params: dict, cfg: BertConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor) -> torch.Tensor:
    """Token-level hidden states [B, S, D] of ``input_ids`` [B, S] (1 in
    ``attention_mask`` marks a real token)."""
    b, s = input_ids.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    emb = params["word_embeddings"]
    dev = emb.device
    with ieee_float32(dev):
        h = (emb[input_ids.long()]
             + params["position_embeddings"][torch.arange(s, device=dev)][None]
             + params["token_type_embeddings"][0][None, None, :])
        h = _layer_norm(h, params["ln_embed_w"], params["ln_embed_b"], cfg.layer_norm_eps)
        sdt = _compute_dtype(h.dtype)
        # additive mask [B, 1, 1, S]
        attn_bias = torch.where(attention_mask[:, None, None, :] > 0,
                                torch.zeros((), dtype=sdt, device=dev),
                                torch.full((), -1e30, dtype=sdt, device=dev))
        lp = params["layers"]
        for i in range(cfg.num_layers):
            p = {k: lp[k][i] for k in _LAYER_KEYS}
            q = (h @ p["wq"] + p["bq"]).reshape(b, s, nh, hd)
            k = (h @ p["wk"] + p["bk"]).reshape(b, s, nh, hd)
            v = (h @ p["wv"] + p["bv"]).reshape(b, s, nh, hd)
            scores = torch.einsum("bsnh,btnh->bnst", q, k).to(sdt)
            scores = scores / (hd ** 0.5) + attn_bias
            probs = torch.softmax(scores, dim=-1).to(h.dtype)
            ctx = torch.einsum("bnst,btnh->bsnh", probs, v).reshape(b, s, nh * hd)
            attn_out = ctx @ p["wo"] + p["bo"]
            h = _layer_norm(h + attn_out, p["ln_attn_w"], p["ln_attn_b"], cfg.layer_norm_eps)
            ffn = F.gelu(h @ p["w1"] + p["b1"], approximate="none") @ p["w2"] + p["b2"]
            h = _layer_norm(h + ffn, p["ln_ffn_w"], p["ln_ffn_b"], cfg.layer_norm_eps)
    return h


def embed(params: dict, cfg: BertConfig, input_ids: torch.Tensor,
          attention_mask: torch.Tensor) -> torch.Tensor:
    """Sentence embeddings: masked mean pooling + L2 norm -> [B, D] in
    float32 (float64 for a float64 tree)."""
    h = forward(params, cfg, input_ids, attention_mask)
    h = h.to(_compute_dtype(h.dtype))
    mask = attention_mask[..., None].to(h.dtype)
    pooled = (h * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1e-9)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)


def params_from_hf_state_dict(state_dict: dict, cfg: BertConfig, dtype=torch.float32,
                              device=None) -> dict:
    """A HF BertModel state dict (``bert.*`` or bare keys; tensors or numpy
    arrays) -> the encoder's tree on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    sd = {k.removeprefix("bert."): v for k, v in state_dict.items()}
    L = cfg.num_layers

    def get(name) -> torch.Tensor:
        t = sd[name]
        t = torch.from_numpy(np.asarray(t)) if not isinstance(t, torch.Tensor) else t.detach()
        return t.to(device=dev, dtype=dtype)

    def lin(fmt):  # HF [out, in] -> [in, out], stacked
        return torch.stack([get(fmt.format(i)).T for i in range(L)]).contiguous()

    def vec(fmt):
        return torch.stack([get(fmt.format(i)) for i in range(L)])

    pre = "encoder.layer.{}."
    layers = {
        "wq": lin(pre + "attention.self.query.weight"), "bq": vec(pre + "attention.self.query.bias"),
        "wk": lin(pre + "attention.self.key.weight"), "bk": vec(pre + "attention.self.key.bias"),
        "wv": lin(pre + "attention.self.value.weight"), "bv": vec(pre + "attention.self.value.bias"),
        "wo": lin(pre + "attention.output.dense.weight"),
        "bo": vec(pre + "attention.output.dense.bias"),
        "ln_attn_w": vec(pre + "attention.output.LayerNorm.weight"),
        "ln_attn_b": vec(pre + "attention.output.LayerNorm.bias"),
        "w1": lin(pre + "intermediate.dense.weight"), "b1": vec(pre + "intermediate.dense.bias"),
        "w2": lin(pre + "output.dense.weight"), "b2": vec(pre + "output.dense.bias"),
        "ln_ffn_w": vec(pre + "output.LayerNorm.weight"),
        "ln_ffn_b": vec(pre + "output.LayerNorm.bias"),
    }
    return {
        "word_embeddings": get("embeddings.word_embeddings.weight"),
        "position_embeddings": get("embeddings.position_embeddings.weight"),
        "token_type_embeddings": get("embeddings.token_type_embeddings.weight"),
        "ln_embed_w": get("embeddings.LayerNorm.weight"),
        "ln_embed_b": get("embeddings.LayerNorm.bias"),
        "layers": layers,
    }
