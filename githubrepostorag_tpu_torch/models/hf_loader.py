"""HuggingFace Qwen2 state dicts -> the stacked-params dict; port of
``githubrepostorag_tpu/models/hf_loader.py`` (``config_from_hf``,
``params_from_state_dict``) for dense checkpoints.

HF stores linear weights [out, in]; the port stores [in, out] so the
forward is ``x @ w``.  Per-layer tensors stack on a leading L axis.
"""

from __future__ import annotations

import numpy as np
import torch

from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config


def config_from_hf(hf_cfg: dict) -> Qwen2Config:
    """HF config dict -> Qwen2Config.  Qwen2-MoE checkpoints raise: the
    sparse MLP is not ported yet."""
    if hf_cfg.get("num_experts", 0):
        raise NotImplementedError("Qwen2-MoE checkpoints are not supported by the torch port yet")
    num_heads = hf_cfg["num_attention_heads"]
    return Qwen2Config(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        intermediate_size=hf_cfg["intermediate_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf_cfg.get("num_key_value_heads", num_heads),
        head_dim=hf_cfg.get("head_dim") or hf_cfg["hidden_size"] // num_heads,
        rope_theta=hf_cfg.get("rope_theta", 1_000_000.0),
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=hf_cfg.get("tie_word_embeddings", False),
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 32768),
    )


def _tensor(t) -> torch.Tensor:
    if isinstance(t, np.ndarray):
        return torch.from_numpy(t)
    return t.detach()


def params_from_state_dict(state_dict: dict, cfg: Qwen2Config, dtype=torch.float32,
                           device=None) -> dict:
    """HF ``Qwen2ForCausalLM`` state dict (torch tensors or numpy arrays) ->
    params on ``device`` in ``dtype``."""
    dev = resolve_device(device)
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    L = cfg.num_layers

    def get(name: str) -> torch.Tensor:
        return _tensor(sd[name]).to(torch.float32)

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=dtype).contiguous()

    def stack_linear(fmt: str) -> torch.Tensor:
        return put(torch.stack([get(fmt.format(i)).t() for i in range(L)]))

    def stack_vec(fmt: str) -> torch.Tensor:
        return put(torch.stack([get(fmt.format(i)) for i in range(L)]))

    params = {
        "embed": put(get("embed_tokens.weight")),
        "layers": {
            "ln1": stack_vec("layers.{}.input_layernorm.weight"),
            "ln2": stack_vec("layers.{}.post_attention_layernorm.weight"),
            "wq": stack_linear("layers.{}.self_attn.q_proj.weight"),
            "bq": stack_vec("layers.{}.self_attn.q_proj.bias"),
            "wk": stack_linear("layers.{}.self_attn.k_proj.weight"),
            "bk": stack_vec("layers.{}.self_attn.k_proj.bias"),
            "wv": stack_linear("layers.{}.self_attn.v_proj.weight"),
            "bv": stack_vec("layers.{}.self_attn.v_proj.bias"),
            "wo": stack_linear("layers.{}.self_attn.o_proj.weight"),
            "wg": stack_linear("layers.{}.mlp.gate_proj.weight"),
            "wu": stack_linear("layers.{}.mlp.up_proj.weight"),
            "wd": stack_linear("layers.{}.mlp.down_proj.weight"),
        },
        "norm": put(get("norm.weight")),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(_tensor(sd["lm_head.weight"]).to(torch.float32).t())
    return params
