"""The JAX package's parameter trees -> the port's tensors.

``params_from_jax`` takes the nested dict the JAX package's
``init_params`` / ``params_from_state_dict`` / ``fuse_projections`` build,
with leaves as numpy arrays or anything ``numpy.asarray`` accepts (this
module imports neither JAX nor the JAX package), and returns the same
dict of torch tensors, so both packages compute on identical weights.

Quantized leaves (the JAX ``QuantizedLinear``, ``QuantizedLinear4`` and
``QuantizedEmbedding`` NamedTuples) become the port's NamedTuples of the
same name: uint8 and int8 fields stay integer, and bf16 scales keep their
bits.  A Qwen2-MoE tree carries over the same way (the router, the
[L, E, in, out] expert stacks with their per-expert scales, the shared
expert); its MLP must match the config's ``num_experts``.

``encoder_params_from_jax`` does the same for the BERT encoder's tree
(``models/encoder.py`` in both packages).
"""

from __future__ import annotations

import numpy as np
import torch

from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.models import quant
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config

_QUANTIZED = {cls.__name__: cls for cls in quant.QUANTIZED_TYPES}


def _tensor(x, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(dev)


def _leaf(x, dev: torch.device, dtype):
    if isinstance(x, tuple):
        cls = _QUANTIZED.get(type(x).__name__)
        if cls is None or len(x) != len(cls._fields):
            raise NotImplementedError(f"unsupported parameter leaf type {type(x).__name__}")
        return cls(*(_tensor(f, dev) for f in x))
    t = _tensor(x, dev)
    if not t.is_floating_point():
        raise NotImplementedError(f"integer parameter leaf of dtype {t.dtype} outside a "
                                  "quantized leaf")
    return t.to(dtype=dtype or t.dtype)


def params_from_jax(tree: dict, cfg: Qwen2Config, device=None, dtype=None) -> dict:
    """Convert every leaf, keeping the tree's keys (fused or unfused layout).
    ``dtype`` sets the plain float leaves (None keeps each leaf's own);
    quantized leaves keep their fields' dtypes."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev, dtype)

    params = conv(tree)
    embed = params["embed"]
    embed_shape = tuple((embed.q if isinstance(embed, tuple) else embed).shape)
    if embed_shape != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(
            f"embed shape {embed_shape} does not match the config "
            f"({cfg.vocab_size}, {cfg.hidden_size})"
        )
    layers = params["layers"]
    if layers["ln1"].shape[0] != cfg.num_layers:
        raise ValueError("layer count does not match the config")
    if ("router" in layers) != (cfg.num_experts > 0):
        raise ValueError(f"the tree's MLP ({'MoE' if 'router' in layers else 'dense'}) does "
                         f"not match the config (num_experts={cfg.num_experts})")
    if "router" in layers and tuple(layers["router"].shape[1:]) != (cfg.hidden_size,
                                                                     cfg.num_experts):
        raise ValueError(f"router shape {tuple(layers['router'].shape)} does not match the "
                         f"config ({cfg.hidden_size}, {cfg.num_experts})")
    return params


def encoder_params_from_jax(tree: dict, cfg, device=None, dtype=torch.float32) -> dict:
    """The JAX encoder's tree (``models/encoder.init_params`` /
    ``params_from_hf_state_dict``; numpy leaves) -> the port's encoder tree
    on ``device``, same keys, each leaf as ``dtype``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev).to(dtype)

    params = conv(tree)
    if tuple(params["word_embeddings"].shape) != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(
            f"word_embeddings shape {tuple(params['word_embeddings'].shape)} does not match "
            f"the config ({cfg.vocab_size}, {cfg.hidden_size})")
    if params["layers"]["wq"].shape[0] != cfg.num_layers:
        raise ValueError("layer count does not match the config")
    return params
