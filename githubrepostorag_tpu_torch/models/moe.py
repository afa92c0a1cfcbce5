"""Sparse Mixture-of-Experts MLP (Qwen2-MoE family); port of
``githubrepostorag_tpu/models/moe.py``.

The math is HF ``Qwen2MoeSparseMoeBlock``'s and the JAX package's: a
float32 softmax router, top-k experts (ties to the lower index), an
optional top-k renorm, and an always-on shared expert scaled by a sigmoid
gate.  Each expert takes at most ``C`` tokens: ``C = ceil(K*T/E *
capacity_factor)``, or ``T`` (no drop) at factor 0.  An assignment's place
in its expert's queue is its arrival order, token-major then k, over all
``T = B*S`` rows of the dispatched tensor, padding rows included; the ones
at place ``C`` or later lose that expert's contribution.

The JAX package builds dense one-hot ``[T, E, C]`` dispatch and combine
tensors and contracts them with einsums.  Here the expert batch is built
by index: the kept rows are scattered into an ``[E, C, d]`` buffer (one
spare row takes the dropped ones, so every shape is static), each
projection is one ``torch.bmm`` over the stacked expert weights, and the
outputs are gathered back and weighted by the router probabilities
rounded to the compute dtype (the JAX ``combine.astype(cdt)``).  No host
sync happens unless ``MOE_DROP_STATS`` is on, so the decode burst runs a
whole burst without one.

Experts over ``ep`` (``moe_mlp(mesh=)``): a rank holds ``E / ep`` experts
(``parallel/sharding.py``), the router is replicated.  Routing and the
queue places run over every token and every expert, so capacity drops are
those of one device; the rank runs only its experts' ``[E / ep, C, d]``
slots, and the float32 combine is summed over ep before its one rounding,
then the shared expert is added once.  In backward the input's and the
router's gradients are summed over ep (``copy_to_axis``), so a train step
over ep holds whole gradients of every replicated leaf.  JAX gets the same
exchange from GSPMD over its one-hot dispatch einsums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from githubrepostorag_tpu_torch.config import _env_bool
from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.models.quant import dequant_weight, qmatmul
from githubrepostorag_tpu_torch.parallel.collectives import copy_to_axis, reduce_from_axis

# Host-side routing-drop accumulator: MOE_DROP_STATS=1 adds (assignments,
# dropped) of every MoE layer call here and to the Prometheus counters.
# Off by default, because reading the drop count back is a host sync per
# layer.
DROP_STATS = {"assignments": 0, "dropped": 0}


def _drop_stats_enabled() -> bool:
    return _env_bool("MOE_DROP_STATS", False)


def _record_drops(assignments, dropped) -> None:
    from githubrepostorag_tpu_torch.metrics import MOE_ASSIGNMENTS, MOE_DROPPED

    DROP_STATS["assignments"] += int(assignments)
    DROP_STATS["dropped"] += int(dropped)
    MOE_ASSIGNMENTS.inc(int(assignments))
    MOE_DROPPED.inc(int(dropped))


def capacity(cfg, tokens: int) -> int:
    """Per-expert capacity for ``tokens`` dispatched rows, in the JAX
    package's float arithmetic."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    if cfg.capacity_factor > 0:
        return max(1, int(-(-K * tokens * cfg.capacity_factor // E)))
    return tokens  # no drop: an expert can at most receive every token once


def route(cfg, xf: torch.Tensor, router) -> tuple[torch.Tensor, torch.Tensor]:
    """Router probabilities of the top-k experts of each row of ``xf``
    [T, d] -> (top_p [T, K] float32, top_i [T, K] int64).  A stable
    descending sort puts tied experts in index order, as ``lax.top_k``."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.num_experts_per_tok
    top_p, top_i = top_p[:, :K], top_i[:, :K]
    if cfg.norm_topk_prob:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return top_p, top_i


def queue_slots(cfg, top_i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's place in its expert's queue, in arrival order
    (token-major, then k), and whether it fits under the capacity:
    (slot [T*K] int32, keep [T*K] bool).  The running count runs along
    the last axis of an [E, T*K] one-hot (a scan down T*K rows is a
    sequential kernel on the card)."""
    T = top_i.shape[0]
    e_flat = top_i.reshape(-1)
    oh = (torch.arange(cfg.num_experts, device=top_i.device)[:, None] == e_flat).to(torch.int32)
    slot = (torch.cumsum(oh, dim=1, dtype=torch.int32) - oh).gather(0, e_flat[None])[0]
    return slot, slot < capacity(cfg, T)


def moe_mlp(cfg, p: dict, x: torch.Tensor, mm=qmatmul, mesh=None) -> torch.Tensor:
    """Sparse MoE MLP over normed hidden states ``x`` [B, S, d].

    ``p`` keys (one layer's): ``router`` [d, E]; ``e_wg`` / ``e_wu`` [E, d,
    ff_e], ``e_wd`` [E, ff_e, d] (plain, or int8 / int4 with per-expert
    scales); ``s_wg`` / ``s_wu`` [d, ff_s], ``s_wd`` [ff_s, d]; ``s_gate``
    [d, 1].  ``mm(x, w)`` runs the shared expert's projections (``qmatmul``
    with the caller's int4 route).  ``mesh``: the expert stacks hold this
    rank's ``E / ep`` experts (module docstring)."""
    b, s, d = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = b * s
    xf = x.reshape(T, d)
    # this rank's experts [e0, e0 + E_loc): all of them off a mesh
    w_gate = p["e_wg"]
    E_loc = (w_gate.q if isinstance(w_gate, tuple) else w_gate).shape[0]
    ep = mesh.group("ep") if mesh is not None and E_loc < E else None
    e0 = mesh.coords["ep"] * E_loc if ep is not None else 0
    # every rank routes every token; backward sums over ep the input's and
    # the router's gradients, each rank's from its own experts
    xe, router = copy_to_axis(xf, ep), copy_to_axis(p["router"], ep)
    top_p, top_i = route(cfg, xe, router)

    C = capacity(cfg, T)
    e_flat = top_i.reshape(T * K)
    slot, keep = queue_slots(cfg, top_i)
    if cfg.capacity_factor > 0 and _drop_stats_enabled():
        _record_drops(T * K, (~keep).sum().item())

    keep = keep & (e_flat >= e0) & (e_flat < e0 + E_loc)

    # the expert batch [E_loc, C, d]: kept rows at e * C + slot, dropped
    # ones (and other ranks' assignments) in the spare row E_loc * C
    cdt = x.dtype
    dest = torch.where(keep, (e_flat - e0) * C + slot.long(), E_loc * C)
    xs = torch.zeros((E_loc * C + 1, d), dtype=cdt, device=x.device)
    xs.index_copy_(0, dest, xe.repeat_interleave(K, dim=0))
    xs = xs[:-1].view(E_loc, C, d)
    h1 = torch.bmm(xs, dequant_weight(p["e_wg"], cdt))
    h2 = torch.bmm(xs, dequant_weight(p["e_wu"], cdt))
    ys = torch.bmm(F.silu(h1) * h2, dequant_weight(p["e_wd"], cdt)).view(E_loc * C, d)

    # combine: each kept assignment's output times its probability rounded
    # to the compute dtype, products and sum in float32 (over ep too),
    # rounded once; a dropped one reads row 0 at weight 0
    w = torch.where(keep, top_p.reshape(T * K), 0.0).to(cdt).float()
    y = (ys[torch.where(keep, dest, 0)].float() * w[:, None]).view(T, K, d).sum(dim=1)
    y = reduce_from_axis(y, ep).to(cdt)

    # the always-on shared expert under its sigmoid gate
    sh = F.silu(mm(xf, p["s_wg"])) * mm(xf, p["s_wu"])
    sh = mm(sh, p["s_wd"]) * torch.sigmoid(mm(xf, p["s_gate"]))
    return (y + sh).reshape(b, s, d)


def init_moe_layer_params(cfg, generator: torch.Generator, device=None,
                          dtype=torch.float32) -> dict:
    """Random init (normal 0.02) of the MoE MLP's stacked [L, ...] leaves,
    drawn on ``device`` from ``generator``; ``qwen2.init_params`` merges
    them into the attention leaves."""
    dev = resolve_device(device)
    L, d = cfg.num_layers, cfg.hidden_size
    E, ffe, ffs = cfg.num_experts, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=dtype).mul_(0.02)

    return {
        "router": norm(L, d, E),
        "e_wg": norm(L, E, d, ffe),
        "e_wu": norm(L, E, d, ffe),
        "e_wd": norm(L, E, ffe, d),
        "s_wg": norm(L, d, ffs),
        "s_wu": norm(L, d, ffs),
        "s_wd": norm(L, ffs, d),
        "s_gate": norm(L, d, 1),
    }
