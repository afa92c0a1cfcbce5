"""The JAX package's parameter tree -> the port's tensors.

``params_from_jax`` takes the nested dict the JAX package's
``init_params`` / ``params_from_state_dict`` / ``fuse_projections`` build,
with leaves as numpy arrays or anything ``numpy.asarray`` accepts (this
module imports neither JAX nor the JAX package), and returns the same
dict of torch tensors, so both packages compute on identical weights.
"""

from __future__ import annotations

import numpy as np
import torch

from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config


def _leaf(x, dev: torch.device, dtype) -> torch.Tensor:
    if isinstance(x, tuple):  # QuantizedLinear / QuantizedEmbedding NamedTuples
        raise NotImplementedError("quantized weights are not supported by the torch port yet")
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if not t.is_floating_point():
        raise NotImplementedError(f"non-float parameter leaf of dtype {arr.dtype}")
    return t.to(device=dev, dtype=dtype or t.dtype)


def params_from_jax(tree: dict, cfg: Qwen2Config, device=None, dtype=None) -> dict:
    """Convert every leaf, keeping the tree's keys (fused or unfused layout).
    ``dtype`` None keeps each leaf's own dtype."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev, dtype)

    params = conv(tree)
    if params["embed"].shape != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(
            f"embed shape {tuple(params['embed'].shape)} does not match the config "
            f"({cfg.vocab_size}, {cfg.hidden_size})"
        )
    if params["layers"]["ln1"].shape[0] != cfg.num_layers:
        raise ValueError("layer count does not match the config")
    return params
