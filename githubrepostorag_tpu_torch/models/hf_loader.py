"""HuggingFace Qwen2 checkpoints -> the stacked-params dict; port of
``githubrepostorag_tpu/models/hf_loader.py`` (``config_from_hf``,
``params_from_state_dict`` with its ``quantize`` option, the AutoAWQ
repacker ``awq_params_from_state_dict``, and ``load_qwen2`` for a local
checkpoint directory) for dense and Qwen2-MoE checkpoints (expert weights
stack [L, E, in, out]; AWQ repacking is dense only, as in JAX).  Shards
are read by the port's own safetensors reader (``models/safetensors_io.py``).

HF stores linear weights [out, in]; the port stores [in, out] so the
forward is ``x @ w``.  Per-layer tensors stack on a leading L axis.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.models.quant import (
    QuantizedLinear4,
    fuse_projections,
    quantize_embedding,
    quantize_qwen2_params,
    quantize_weight,
)
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.models.safetensors_io import load_file

logger = logging.getLogger(__name__)


def config_from_hf(hf_cfg: dict, moe_capacity_factor: float = 2.0) -> Qwen2Config:
    """HF config dict -> Qwen2Config.  A Qwen2-MoE config (``num_experts``
    > 0) brings the MoE fields; ``moe_capacity_factor`` is the caller's
    (``MOE_CAPACITY_FACTOR`` through ``load_qwen2``), so parsing never
    reads the environment.  Only uniformly sparse MoE checkpoints load."""
    num_heads = hf_cfg["num_attention_heads"]
    moe: dict = {}
    if hf_cfg.get("num_experts", 0):  # Qwen2MoeConfig (model_type qwen2_moe)
        if hf_cfg.get("decoder_sparse_step", 1) != 1 or hf_cfg.get("mlp_only_layers"):
            # stacked layer leaves need one block structure for every layer
            raise ValueError(
                "only uniformly-sparse Qwen2-MoE checkpoints are supported "
                "(decoder_sparse_step=1, no mlp_only_layers)")
        moe = dict(
            num_experts=hf_cfg["num_experts"],
            num_experts_per_tok=hf_cfg["num_experts_per_tok"],
            moe_intermediate_size=hf_cfg["moe_intermediate_size"],
            shared_expert_intermediate_size=hf_cfg["shared_expert_intermediate_size"],
            norm_topk_prob=hf_cfg.get("norm_topk_prob", False),
            capacity_factor=moe_capacity_factor,
        )
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
        **moe,
    )


def _tensor(t) -> torch.Tensor:
    if isinstance(t, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(t))
    return t.detach()


def params_from_state_dict(state_dict: dict, cfg: Qwen2Config, dtype=torch.float32,
                           device=None, quantize: bool | int = False) -> dict:
    """HF ``Qwen2ForCausalLM`` state dict (torch tensors or numpy arrays) ->
    params on ``device`` in ``dtype``.  ``quantize`` True/8 converts every
    projection to per-channel int8, 4 to group-wise int4 (group 64); the
    embedding table goes per-row int8 either way (``quantize_qwen2_params``,
    computed on ``device``)."""
    if quantize not in (False, True, 4, 8):
        raise ValueError(f"quantize must be False/True/8/4, got {quantize!r}")
    dev = resolve_device(device)
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    L = cfg.num_layers

    # Each leaf is allocated once in ``dtype`` and filled by one converting
    # copy per source tensor (bf16, f16 and f32 sources round as through
    # f32, as the JAX loader converts them), so a load holds the checkpoint
    # and the tree and no full-precision temporary beside them.
    def put(t) -> torch.Tensor:
        t = _tensor(t)
        return torch.empty(t.shape, dtype=dtype, device=dev).copy_(t)

    def stack(fmt: str, transpose: bool = False, experts: int = 0) -> torch.Tensor:
        # [L, ...], or [L, E, ...] from per-expert names "{layer}...{expert}"
        keys = ([[fmt.format(i, e) for e in range(experts)] for i in range(L)] if experts
                else [[fmt.format(i)] for i in range(L)])
        first = _tensor(sd[keys[0][0]])
        shape = first.t().shape if transpose else first.shape
        out = torch.empty((L, *([experts] if experts else []), *shape), dtype=dtype, device=dev)
        flat = out.view(-1, *shape)
        for j, key in enumerate(k for row in keys for k in row):
            r = _tensor(sd[key])
            flat[j].copy_(r.t() if transpose else r)
        return out

    layers = {
        "ln1": stack("layers.{}.input_layernorm.weight"),
        "ln2": stack("layers.{}.post_attention_layernorm.weight"),
        "wq": stack("layers.{}.self_attn.q_proj.weight", transpose=True),
        "bq": stack("layers.{}.self_attn.q_proj.bias"),
        "wk": stack("layers.{}.self_attn.k_proj.weight", transpose=True),
        "bk": stack("layers.{}.self_attn.k_proj.bias"),
        "wv": stack("layers.{}.self_attn.v_proj.weight", transpose=True),
        "bv": stack("layers.{}.self_attn.v_proj.bias"),
        "wo": stack("layers.{}.self_attn.o_proj.weight", transpose=True),
    }
    if cfg.num_experts > 0:  # Qwen2-MoE sparse MLP (models/moe.py keys)
        E, mlp = cfg.num_experts, "layers.{}.mlp."
        layers.update({
            "router": stack(mlp + "gate.weight", transpose=True),
            "e_wg": stack(mlp + "experts.{}.gate_proj.weight", transpose=True, experts=E),
            "e_wu": stack(mlp + "experts.{}.up_proj.weight", transpose=True, experts=E),
            "e_wd": stack(mlp + "experts.{}.down_proj.weight", transpose=True, experts=E),
            "s_wg": stack(mlp + "shared_expert.gate_proj.weight", transpose=True),
            "s_wu": stack(mlp + "shared_expert.up_proj.weight", transpose=True),
            "s_wd": stack(mlp + "shared_expert.down_proj.weight", transpose=True),
            "s_gate": stack(mlp + "shared_expert_gate.weight", transpose=True),
        })
    else:
        layers.update({
            "wg": stack("layers.{}.mlp.gate_proj.weight", transpose=True),
            "wu": stack("layers.{}.mlp.up_proj.weight", transpose=True),
            "wd": stack("layers.{}.mlp.down_proj.weight", transpose=True),
        })
    params = {"embed": put(sd["embed_tokens.weight"]), "layers": layers,
              "norm": put(sd["norm.weight"])}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(_tensor(sd["lm_head.weight"]).t())
    if quantize:
        params = quantize_qwen2_params(params, bits=4 if quantize == 4 else 8)
    return params


def load_qwen2(checkpoint_dir: str | Path, dtype=torch.float32, quantize: bool | int = False,
               fuse: bool = False, device=None,
               moe_capacity_factor: float = 2.0) -> tuple[dict, Qwen2Config]:
    """Load ``config.json`` and every ``*.safetensors`` shard of a local
    checkpoint directory onto ``device``, one tensor at a time.

    ``quantize`` True/8 converts every projection to per-channel int8 and
    4 to group-wise int4 (the embedding table goes per-row int8 either
    way).  A checkpoint that is already AutoAWQ 4-bit
    (``quantization_config.quant_method == "awq"``) is repacked by
    ``awq_params_from_state_dict``, its codes unchanged; an int8 request
    is then ignored with a warning.  ``fuse`` returns the single-chip
    serving layout (``fuse_projections``), fused while the tree is the only
    thing on the device.  ``moe_capacity_factor`` sets a Qwen2-MoE
    checkpoint's expert capacity (``config_from_hf``)."""
    if quantize not in (False, True, 4, 8):
        raise ValueError(f"quantize must be False/True/8/4, got {quantize!r}")
    dev = resolve_device(device)
    root = Path(checkpoint_dir)
    hf_cfg = json.loads((root / "config.json").read_text())
    cfg = config_from_hf(hf_cfg, moe_capacity_factor=moe_capacity_factor)
    shards = sorted(root.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors shard in {root}")
    state: dict[str, torch.Tensor] = {}
    for shard in shards:
        state.update(load_file(shard, device=dev))
    awq = (hf_cfg.get("quantization_config") or {}).get("quant_method") == "awq"
    if awq:
        if quantize in (True, 8):
            logger.warning(
                "checkpoint %s is natively 4-bit AWQ; ignoring the int8 quantize request "
                "and repacking the AWQ codes", checkpoint_dir)
        params = awq_params_from_state_dict(state, cfg, hf_cfg, dtype=dtype, device=dev)
    else:
        params = params_from_state_dict(state, cfg, dtype=dtype, device=dev)
    # the checkpoint's tensors are freed before the quantizer's f32
    # temporaries are made, which then sit beside the tree alone
    del state
    if quantize and not awq:
        params = quantize_qwen2_params(params, bits=4 if quantize == 4 else 8)
    if fuse:
        params = fuse_projections(params, in_place=True)  # solely owned here
    return params, cfg


# ---- AWQ checkpoint repacking -------------------------------------------

AWQ_NIBBLE_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)  # AutoAWQ's GEMM packing order


def _awq_unpack(packed) -> torch.Tensor:
    """Unpack AutoAWQ int32 nibble-packed tensors along the LAST axis:
    [r, c/8] int32 -> [r, c] uint8 (values 0..15).  AWQ packs 8 columns
    per int32 in the interleaved order ``AWQ_NIBBLE_ORDER``: nibble ``pos``
    (bits 4*pos..4*pos+3) of word w holds column 8*w + AWQ_NIBBLE_ORDER[pos].
    The arithmetic shift of a negative int32 only sets bits above the
    nibble, which the mask drops."""
    u = _tensor(packed).to(torch.int32)
    r, c8 = u.shape
    out = torch.empty((r, c8, 8), dtype=torch.uint8, device=u.device)
    for pos, col in enumerate(AWQ_NIBBLE_ORDER):
        out[:, :, col] = ((u >> (4 * pos)) & 0xF).to(torch.uint8)
    return out.reshape(r, c8 * 8)


def awq_linear_to_quantized4(qweight, qzeros, scales) -> QuantizedLinear4:
    """Repack one AutoAWQ GEMM-format linear (qweight int32 [in, out/8],
    qzeros int32 [in/group, out/8], scales f16/f32 [in/group, out]) into
    ``QuantizedLinear4``.  AWQ dequantizes ``(q - z) * s``; the port's
    layout is ``q * s - zs`` with ``zs = z * s``, and its nibbles are
    plane-packed within each group (low nibble: the group's first half of
    rows, high nibble: its second half).  The uint4 codes transfer exactly;
    s and zs are stored bf16, so dequant matches AWQ's to the bf16
    rounding of the scales."""
    q = _awq_unpack(qweight)  # [in, out]
    z = _awq_unpack(qzeros).float()  # [in/group, out]
    s = _tensor(scales).float()
    in_dim, out = q.shape
    n_g = s.shape[0]
    group = in_dim // n_g
    if group % 2 or in_dim % group:
        raise ValueError(f"AWQ group size {group} not even over in dim {in_dim}")
    qg = q.reshape(n_g, group, out)
    packed = (qg[:, : group // 2] | (qg[:, group // 2 :] << 4)).reshape(in_dim // 2, out)
    return QuantizedLinear4(q=packed, s=s.to(torch.bfloat16), zs=(z * s).to(torch.bfloat16))


def awq_params_from_state_dict(state_dict: dict, cfg: Qwen2Config, hf_cfg: dict,
                               dtype=torch.float32, device=None) -> dict:
    """The stacked-params dict from an AutoAWQ checkpoint's qweight /
    qzeros / scales tensors (projections) and full-precision embedding and
    norm tensors.  The embedding table re-quantizes to per-row int8; an
    fp16 lm_head to per-channel int8, a quantized one repacks like the
    projections.  ``dtype`` sets the norms and biases, and with them the
    activation dtype: bf16 for serving."""
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "AWQ repacking covers dense Qwen2 checkpoints; AWQ MoE exports "
            "are not supported (quantize a bf16 MoE checkpoint instead)")
    dev = resolve_device(device)
    qc = hf_cfg.get("quantization_config") or {}
    if qc.get("bits", 4) != 4 or str(qc.get("version", "gemm")).lower() != "gemm":
        raise ValueError(
            f"only 4-bit GEMM-format AWQ checkpoints are supported, got "
            f"bits={qc.get('bits')} version={qc.get('version')}")
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    L = cfg.num_layers

    def awq(prefix: str) -> QuantizedLinear4:
        return awq_linear_to_quantized4(sd[prefix + ".qweight"], sd[prefix + ".qzeros"],
                                        sd[prefix + ".scales"])

    def stack_awq(fmt: str) -> QuantizedLinear4:
        per_layer = [awq(fmt.format(i)) for i in range(L)]
        return QuantizedLinear4(*(torch.stack(f).to(dev) for f in zip(*per_layer)))

    def stack_vec(fmt: str) -> torch.Tensor:
        return torch.stack([_tensor(sd[fmt.format(i)]).float() for i in range(L)]).to(dev, dtype)

    attn, mlp = "layers.{}.self_attn.", "layers.{}.mlp."
    layers = {
        "ln1": stack_vec("layers.{}.input_layernorm.weight"),
        "ln2": stack_vec("layers.{}.post_attention_layernorm.weight"),
        "wq": stack_awq(attn + "q_proj"), "bq": stack_vec(attn + "q_proj.bias"),
        "wk": stack_awq(attn + "k_proj"), "bk": stack_vec(attn + "k_proj.bias"),
        "wv": stack_awq(attn + "v_proj"), "bv": stack_vec(attn + "v_proj.bias"),
        "wo": stack_awq(attn + "o_proj"),
        "wg": stack_awq(mlp + "gate_proj"), "wu": stack_awq(mlp + "up_proj"),
        "wd": stack_awq(mlp + "down_proj"),
    }
    params = {
        "embed": quantize_embedding(_tensor(sd["embed_tokens.weight"]).to(dev)),
        "layers": layers,
        "norm": _tensor(sd["norm.weight"]).to(dev, dtype),
    }
    if not cfg.tie_word_embeddings:
        lm = sd.get("lm_head.weight")
        if lm is not None:  # AWQ keeps lm_head fp16
            params["lm_head"] = quantize_weight(_tensor(lm).to(dev).t())
        else:  # some AWQ exports quantize lm_head too
            params["lm_head"] = QuantizedLinear4(*(f.to(dev) for f in awq("lm_head")))
    return params
