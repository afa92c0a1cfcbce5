"""Serving-layout weight helpers; the plain-weight half of
``githubrepostorag_tpu/models/quant.py`` (``fuse_projections``,
``embedding_lookup``).  Quantized weights are not ported yet."""

from __future__ import annotations

import torch


def embedding_lookup(embed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Token embedding gather for a plain [V, d] table."""
    return embed[ids.long()]


def fuse_projections(params: dict, in_place: bool = False) -> dict:
    """Single-chip serving layout: fuse wq|wk|wv -> wqkv (and their biases)
    and wg|wu -> wgu along the output axis, so each layer runs 4 projection
    matmuls instead of 7; the model block splits activations after the
    matmul.  ``in_place=True`` pops each per-projection leaf from
    ``params["layers"]`` so a solely-owned tree never holds both layouts
    once the old leaves are released; the default copies the dicts and
    leaves a caller-shared tree as it was.  Already-fused trees pass
    through."""
    if not in_place:
        params = dict(params, layers=dict(params["layers"]))
    layers = params["layers"]
    if "wq" in layers:
        layers["wqkv"] = torch.cat([layers.pop("wq"), layers.pop("wk"), layers.pop("wv")], dim=-1)
        layers["bqkv"] = torch.cat([layers.pop("bq"), layers.pop("bk"), layers.pop("bv")], dim=-1)
    if "wg" in layers:
        layers["wgu"] = torch.cat([layers.pop("wg"), layers.pop("wu")], dim=-1)
    return params
