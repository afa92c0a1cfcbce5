"""Causal-LM train step over the mesh; port of
``githubrepostorag_tpu/training/step.py``.

JAX jits one program over the whole mesh and lets GSPMD insert every
collective.  Here every rank runs the step on its own slices: the batch
[B, S] is cut over dp (and over sp under sequence parallelism, with RoPE
at the global positions), the forward calls the Megatron collectives over
tp and the ring over sp (``models/qwen2.forward_with_attend``), the loss
is the global masked mean (each rank's masked sum over the mask count of
the whole batch), and the gradients are summed over the data axes before
the update.  Parameters replicated over tp need no reduction over it:
each tp rank's backward already holds their whole gradient.

Remat: each layer runs under ``torch.utils.checkpoint`` (non-reentrant),
so backward recomputes its activations instead of keeping S x L of them.

The optimizer is optax's ``adamw(1e-4)`` (b1 0.9, b2 0.999, eps 1e-8,
weight decay 1e-4 on every leaf, norms and biases included), which
``torch.optim.AdamW`` computes with these settings; torch's own default
weight decay (0.01) is not optax's.  The optimizer object is the step's
``opt_state``: it holds the moments of the leaves it was built over.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from githubrepostorag_tpu_torch.models.qwen2 import (
    Qwen2Config,
    forward_with_attend,
    init_params,
)
from githubrepostorag_tpu_torch.parallel.collectives import all_reduce_sum
from githubrepostorag_tpu_torch.parallel.mesh import Mesh, MeshPlan
from githubrepostorag_tpu_torch.parallel.ring_attention import make_ring_attend
from githubrepostorag_tpu_torch.parallel.sharding import (
    batch_spec,
    qwen2_param_specs,
    shard_params,
    tree_map,
)


@dataclass
class TrainState:
    params: dict
    opt_state: Any
    step: int = 0


def adamw(learning_rate: float = 1e-4, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Callable[[list], torch.optim.Optimizer]:
    """optax.adamw's defaults, as a factory of torch optimizers over a list
    of leaves."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def causal_lm_loss(
    logits: torch.Tensor,  # [B, S, V] float32
    targets: torch.Tensor,  # [B, S] int (already shifted by the caller)
    mask: torch.Tensor,  # [B, S] 0/1: padding and prompt masking
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean masked next-token cross-entropy (float32), optax's
    integer-label softmax cross-entropy.  ``count``: the mask count to
    divide by (the whole batch's, when this is a slice of it), floored at
    1; by default this mask's."""
    losses = F.cross_entropy(logits.float().flatten(0, 1), targets.long().flatten(),
                             reduction="none").view_as(targets)
    mask = mask.float()
    count = mask.sum() if count is None else count
    return (losses * mask).sum() / torch.clamp(count, min=1.0)


def leaves(tree) -> list[torch.Tensor]:
    """A tree's tensors in a fixed order (the optimizer's leaf order)."""
    out = []
    tree_map(out.append, tree)
    return out


def value_and_grad(params: dict, cfg: Qwen2Config, mesh: Mesh | None, batch: dict, *,
                   seq_parallel: bool | None = None,
                   remat: bool = True) -> tuple[torch.Tensor, dict]:
    """The global loss of ``batch`` (the whole [B, S] batch, on every rank)
    and the gradient tree of this rank's ``params`` slices, summed over the
    data axes.  ``seq_parallel`` defaults to sp > 1."""
    mesh = mesh if mesh is not None else Mesh(MeshPlan())
    if seq_parallel is None:
        seq_parallel = mesh.shape["sp"] > 1
    attend = None
    if seq_parallel and mesh.shape["sp"] > 1:
        attend = make_ring_attend(mesh, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
    spec = batch_spec(seq_parallel=seq_parallel)
    local = shard_params(batch, mesh, {k: spec for k in batch})
    b, s = local["input_ids"].shape
    start = mesh.coords["sp"] * s if seq_parallel else 0
    positions = (start + torch.arange(s, device=local["input_ids"].device)).expand(b, s)
    groups = [mesh.group("dp")] + ([mesh.group("sp")] if seq_parallel else [])

    count = local["mask"].float().sum()
    all_reduce_sum([count], groups)
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        logits = forward_with_attend(tracked, cfg, local["input_ids"], positions, attend,
                                     remat=remat, mesh=mesh)
        loss = causal_lm_loss(logits, local["targets"], local["mask"], count)
        grads = list(torch.autograd.grad(loss, leaves(tracked)))
    loss = loss.detach()
    all_reduce_sum(grads + [loss], groups)
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), params)


def make_train_step(
    cfg: Qwen2Config,
    mesh: Mesh | None,
    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
    *,
    seq_parallel: bool | None = None,
    remat: bool = True,
) -> tuple[Callable, Callable]:
    """Build ``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``batch`` is a dict of int [B, S] ``input_ids`` / ``targets`` / ``mask``,
    the whole batch on every rank; B must divide by dp and S by sp.
    ``seq_parallel`` defaults to sp > 1.  ``opt_state`` is the optimizer
    ``optimizer(leaves(params))`` built (``init_train_state``); the step
    updates ``params`` in place and returns them.  Returns (step, the
    optimizer factory used)."""
    optimizer = optimizer or adamw(1e-4)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(params, cfg, mesh, batch, seq_parallel=seq_parallel,
                                     remat=remat)
        for p, g in zip(leaves(params), leaves(grads)):
            p.grad = g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return step, optimizer


def init_train_state(
    cfg: Qwen2Config,
    mesh: Mesh | None,
    generator: torch.Generator,
    optimizer: Callable[[list], torch.optim.Optimizer],
    dtype=torch.float32,
    device=None,
) -> TrainState:
    """Random-init params (``models.qwen2.init_params`` from ``generator``,
    which must live on ``device``), cut to this rank's TP slices, and the
    optimizer over them."""
    mesh = mesh if mesh is not None else Mesh(MeshPlan())
    params = shard_params(init_params(cfg, generator, device, dtype), mesh,
                          qwen2_param_specs(cfg, mesh))
    return TrainState(params=params, opt_state=optimizer(leaves(params)))
