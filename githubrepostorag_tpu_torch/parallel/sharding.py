"""Partition rules: how each parameter of the Qwen2 decoder / BERT encoder
lays out over the mesh, and the cut of a rank's slices; port of
``githubrepostorag_tpu/parallel/sharding.py``.

A spec is JAX's ``PartitionSpec`` as a plain tuple: one entry a dimension,
the mesh axis it is split over or None.  The rules are JAX's (Megatron
tensor parallelism):

  - attention: wq/bq column-parallel over heads, wo row-parallel; wk/wv
    shard only when tp divides the KV-head count, else they stay
    replicated (Qwen2's GQA has 2-4 KV heads).
  - MLP: wg/wu column-parallel over the intermediate dim, wd row-parallel;
    an MoE tree's experts over ``ep``, its router and shared expert
    replicated.
  - embedding vocab-parallel; untied lm_head vocab-parallel on its output.
  - norms and other vectors replicated.

A dimension a mesh axis does not divide stays replicated.  JAX places the
whole tree with ``jax.device_put`` and lets GSPMD insert the collectives;
here ``shard_params`` cuts each full tensor down to this rank's slice and
the forward calls the collectives itself (``models/qwen2.py`` over
``parallel/collectives.py``).  JAX's ``named`` (a ``NamedSharding``
constructor) has no counterpart: a rank holds its slice, not a sharding.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from githubrepostorag_tpu_torch.models.quant import (
    QuantizedEmbedding,
    QuantizedLinear,
    QuantizedLinear4,
)

if TYPE_CHECKING:  # models/qwen2.py imports this package's collectives
    from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config


def _axis(mesh, name: str, dim: int) -> str | None:
    """Use mesh axis ``name`` for a dimension of size ``dim`` iff it divides."""
    size = mesh.shape.get(name, 1)
    return name if size > 1 and dim % size == 0 else None


def qwen2_param_specs(cfg: Qwen2Config, mesh, params: dict | None = None) -> dict:
    """Spec tree matching ``models.qwen2.init_params`` structure (``mesh``:
    anything with a ``shape`` dict, ``parallel.mesh.Mesh`` included).

    When ``params`` is given and carries quantized leaves, each
    projection's spec becomes the matching NamedTuple of specs: int8 ``q``
    sharded like the weight and ``s`` (per output channel) like its output
    axis; int4 ``q``, ``s`` and ``zs`` all like the weight; an int8
    embedding's per-row ``s`` like its vocab axis."""
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    inter, v = cfg.intermediate_size, cfg.vocab_size

    # shard the fused head dim only when tp divides the head *count*
    q_tp = _axis(mesh, "tp", nq) and _axis(mesh, "tp", nq * hd)
    kv_tp = _axis(mesh, "tp", nkv) and _axis(mesh, "tp", nkv * hd)
    mlp_tp = _axis(mesh, "tp", inter)
    vocab_tp = _axis(mesh, "tp", v)

    layers = {
        "ln1": (None, None),
        "ln2": (None, None),
        "wq": (None, None, q_tp),
        "bq": (None, q_tp),
        "wk": (None, None, kv_tp),
        "bk": (None, kv_tp),
        "wv": (None, None, kv_tp),
        "bv": (None, kv_tp),
        "wo": (None, q_tp, None),
    }
    if cfg.num_experts > 0:
        ep = _axis(mesh, "ep", cfg.num_experts)
        layers.update({
            "router": (None, None, None),
            "e_wg": (None, ep, None, None),
            "e_wu": (None, ep, None, None),
            "e_wd": (None, ep, None, None),
            "s_wg": (None, None, None),
            "s_wu": (None, None, None),
            "s_wd": (None, None, None),
            "s_gate": (None, None, None),
        })
    else:
        layers.update({
            "wg": (None, None, mlp_tp),
            "wu": (None, None, mlp_tp),
            "wd": (None, mlp_tp, None),
        })
    specs = {"embed": (vocab_tp, None), "layers": layers, "norm": (None,)}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, vocab_tp)

    if params is not None:
        def adapt(specs: dict, name: str, leaf) -> None:
            if isinstance(leaf, QuantizedLinear):
                spec = specs[name]
                specs[name] = QuantizedLinear(q=spec, s=(*spec[:-2], spec[-1]))
            elif isinstance(leaf, QuantizedLinear4):
                specs[name] = QuantizedLinear4(q=specs[name], s=specs[name], zs=specs[name])

        for name, leaf in params["layers"].items():
            adapt(specs["layers"], name, leaf)
        if "lm_head" in params:
            adapt(specs, "lm_head", params["lm_head"])
        if isinstance(params["embed"], QuantizedEmbedding):
            specs["embed"] = QuantizedEmbedding(q=specs["embed"], s=(specs["embed"][0],))
    return specs


def encoder_param_specs(params, mesh) -> dict:
    """The e5-small-class encoder is ~33M params: replicated everywhere;
    its batch shards over dp instead (``batch_spec``)."""
    del mesh
    return tree_map(lambda _: (), params)


def batch_spec(*, seq_parallel: bool = False) -> tuple:
    """Spec of a [B, S] token batch: batch over dp, sequence over sp when
    ring attention is in play."""
    return ("dp", "sp" if seq_parallel else None)


def shard_params(params, mesh, specs):
    """This rank's slices of a tree of full tensors (``specs`` of the same
    structure; ``mesh.coords`` say which slice), each a tensor of its own."""
    return tree_map(lambda x, spec: shard_tensor(x, mesh, spec), params, specs)


def shard_tensor(x: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """The slice of ``x`` at this rank's coordinates: each dimension split
    into equal contiguous parts over the axis ``spec`` names for it."""
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.shape[name]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                             f"{name}={n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[name] * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts whose leaves are tensors or
    quantized NamedTuples of tensors (mapped field by field); ``rest`` are
    trees of the same structure (spec trees: their leaves are tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(fn(*fields) for fields in zip(tree, *rest)))
    return fn(tree, *rest)
